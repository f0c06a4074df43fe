"""The convolution block (counterpart of
``blind_image_denoising_tpu/layers/conv.py`` ``ConvBlock``):
conv → optional bias → optional BatchNorm (flax's, or bias-free) →
optional LayerNorm → activation.

Plain, grouped and depthwise convs (``depth_multiplier`` m: a kernel
[C·m, 1, kh, kw] with C groups, so output channel o reads input o // m,
as in lax), SAME or VALID padding. Tensors are NCHW (``channels_last``),
kernels OIHW. Every such conv goes through ``ops/quant.py``'s ``conv2d``
with the site name ``"in"``, as in JAX: in the compute dtype (``dtype``,
or the input's) with no quantization mode, or its calibrate / int8
paths. SAME padding follows XLA: an odd total pads one more on the high
side.

``transpose=True`` is ``lax.conv_transpose`` with the kernel as stored
(no flip): the input dilated by the strides, padded by lax's transposed
SAME / VALID rule, then a stride-1 conv; the flax kernel ``[kh, kw, in,
out]`` is held as ``[out, in, kh, kw]``. ``separable=True`` is a
depthwise conv (``depthwise_kernel`` [in, 1, kh, kw]) then a 1×1 conv
(``pointwise_kernel`` [out, in, 1, 1]). Both keep the float path, as the
JAX block does. ``dropout_rate`` drops elements and
``spatial_dropout_rate`` whole channels per sample after the
activation, in training only, with masks from the generator the caller
passes (flax ``nn.Dropout``: kept values scaled by 1/(1 − rate)).

``kernel_regularizer`` (a config spec for ``ops/regularizers.builder``)
gives the block a ``penalty()`` of its float32 kernel: the term the JAX
block sows into its ``losses`` collection during training.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..constants import (DEFAULT_BN_EPSILON, DEFAULT_BN_MOMENTUM,
                         DEFAULT_LN_EPSILON)
from ..ops import quant as quant_ops
from ..ops.noise import truncated_normal
from ..ops.regularizers import builder as regularizer_builder
from ..ops.resize import nchw, nhwc
from ..parallel.spatial import map_rows
from .activations import Activation, activation_fn
from .norm import BatchNorm, BiasFreeBatchNorm, FastLayerNorm
from .stochastic import drop_mask


# std of the standard normal truncated to ±2
_TRUNC_STD = 0.87962566103423978


def _variance_scaling(scale: float, mode: str, distribution: str):
    """flax ``variance_scaling``: variance ``scale / fan`` (``fan_in``, or
    the mean of both fans), from a ±2 truncated normal rescaled to that
    std or from the uniform of that variance."""

    def init(shape, fan_in, fan_out, generator):
        var = (scale / fan_in if mode == "fan_in"
               else 2.0 * scale / (fan_in + fan_out))
        if distribution == "truncated_normal":
            return (math.sqrt(var) / _TRUNC_STD) * truncated_normal(
                tuple(shape), generator)
        limit = math.sqrt(3.0 * var)
        return limit * (2.0 * torch.rand(shape, generator=generator) - 1.0)
    return init


_INITIALIZERS = {
    "glorot_normal": _variance_scaling(1.0, "fan_avg", "truncated_normal"),
    "glorot_uniform": _variance_scaling(1.0, "fan_avg", "uniform"),
    "he_normal": _variance_scaling(2.0, "fan_in", "truncated_normal"),
    "he_uniform": _variance_scaling(2.0, "fan_in", "uniform"),
    # ConvNeXt-style: 0.02 times the ±2 truncated normal (not rescaled)
    "trunc_normal": lambda shape, fi, fo, g: 0.02 * truncated_normal(
        tuple(shape), g),
    "truncated_normal": lambda shape, fi, fo, g: 0.02 * truncated_normal(
        tuple(shape), g),
    "zeros": lambda shape, fi, fo, g: torch.zeros(shape),
    "ones": lambda shape, fi, fo, g: torch.ones(shape),
}


def resolve_initializer(name):
    """A ``kernel_initializer`` name (JAX ``layers/conv.py``'s: glorot and
    he, normal and uniform; ``trunc_normal`` 0.02; zeros; ones) →
    ``init(shape, fan_in, fan_out, generator)`` returning a float32
    tensor on the CPU. A callable passes through."""
    if callable(name):
        return name
    key = (name or "glorot_normal").strip().lower()
    if key not in _INITIALIZERS:
        raise ValueError(f"unknown kernel initializer [{name}]")
    return _INITIALIZERS[key]


def default_bn_args(use_bias: bool) -> dict:
    """The BatchNorm arguments the backbones share (flax's names)."""
    return dict(use_scale=True, use_bias=use_bias,
                momentum=DEFAULT_BN_MOMENTUM, epsilon=DEFAULT_BN_EPSILON)


def default_ln_args(use_bias: bool) -> dict:
    return dict(use_scale=True, use_bias=use_bias, epsilon=DEFAULT_LN_EPSILON)


def _pair(v):
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def transpose_pads(k: int, s: int, padding: str):
    """(low, high) padding of ``lax.conv_transpose`` along one axis."""
    if padding == "SAME":
        total = k + s - 2
        low = k - 1 if s > k - 1 else -(-total // 2)
    elif padding == "VALID":
        total, low = k + s - 2 + max(k - s, 0), k - 1
    else:
        raise ValueError(f"unknown padding [{padding}]")
    return low, total - low


def conv_transpose(x: torch.Tensor, kernel: torch.Tensor, strides,
                   padding: str) -> torch.Tensor:
    """``lax.conv_transpose`` of NCHW x with an OIHW kernel taken as
    stored: x dilated by the strides, padded, then a stride-1 conv."""
    (sh, sw), (kh, kw) = strides, kernel.shape[2:]
    b, c, h, w = x.shape
    if (sh, sw) != (1, 1):
        xd = x.new_zeros((b, c, (h - 1) * sh + 1, (w - 1) * sw + 1))
        xd[:, :, ::sh, ::sw] = x
        x = xd
    ph, pw = transpose_pads(kh, sh, padding), transpose_pads(kw, sw, padding)
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), kernel)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
            channels: bool = False) -> torch.Tensor:
    """flax ``nn.Dropout`` in training on NCHW x: elements, or whole
    channels per sample (``channels``, its ``broadcast_dims=(1, 2)`` on
    NHWC), kept with probability 1 − rate and scaled by 1/(1 − rate).
    Under a spatially sharded train step an element mask is drawn for
    the whole map, so each slab keeps the unsharded step's rows."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    shape = tuple(x.shape[:2]) + (1, 1) if channels else x.shape
    shard, rows = (None, None) if channels else map_rows(x)
    if shard is None:
        keep = drop_mask(shape, rate, generator, x.device)
    else:
        # a spatially sharded step: the whole map's mask, the slab's rows
        keep = drop_mask(shape[:2] + (rows.height,) + shape[3:], rate,
                         generator, x.device).narrow(
            2, rows.slab_start, rows.slab_rows)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class ConvBlock(nn.Module):
    """conv → bias → BN → LN → activation. ``depth_multiplier`` not None
    selects a depthwise conv over ``in_features``. ``bn_center`` gives
    the BatchNorm (and LayerNorm) a bias; ``bn_bias_free`` selects
    :class:`BiasFreeBatchNorm`."""

    def __init__(self, in_features: int, features: int = 0, kernel_size=3,
                 strides=(1, 1), depth_multiplier: Optional[int] = None,
                 activation: str = "linear", use_ln: bool = False,
                 use_bn: bool = False, use_bias: bool = False,
                 groups: int = 1, transpose: bool = False,
                 separable: bool = False, kernel_regularizer=None,
                 dtype=None, padding: str = "SAME", bn_center: bool = False,
                 bn_bias_free: bool = False, dropout_rate: float = 0.0,
                 spatial_dropout_rate: float = 0.0, kernel_initializer=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        # None: the model's (``training/train_state.init_params``)
        self.kernel_initializer = kernel_initializer
        self.activation = str(activation or "linear").strip().lower()
        self.strides = _pair(strides)
        self.padding = str(padding).upper()
        self.dtype = dtype
        self.transpose, self.separable = bool(transpose), bool(separable)
        self.dropout_rate = float(dropout_rate or 0.0)
        self.spatial_dropout_rate = float(spatial_dropout_rate or 0.0)
        self.depth_multiplier = (None if depth_multiplier is None
                                 or self.transpose or self.separable
                                 else int(depth_multiplier))
        if self.transpose:
            out = int(features)
            self.kernel = nn.Parameter(torch.zeros(out, in_features, kh, kw))
        elif self.separable:
            out = int(features)
            self.depthwise_kernel = nn.Parameter(
                torch.zeros(in_features, 1, kh, kw))
            self.pointwise_kernel = nn.Parameter(
                torch.zeros(out, in_features, 1, 1))
        elif depth_multiplier is not None:
            out = in_features * int(depth_multiplier)
            self.groups = in_features
            self.kernel = nn.Parameter(torch.zeros(out, 1, kh, kw))
        else:
            out = int(features)
            self.groups = max(1, int(groups))
            self.kernel = nn.Parameter(torch.zeros(
                out, in_features // self.groups, kh, kw))
        self.out_features = out
        self.bias = nn.Parameter(torch.zeros(out)) if use_bias else None
        self.bn = None
        if use_bn:
            self.bn = (BiasFreeBatchNorm(out) if bn_bias_free
                       else BatchNorm(out, use_bias=bn_center))
        self.ln = (FastLayerNorm(out, epsilon=DEFAULT_LN_EPSILON,
                                 use_bias=bn_center, dtype=dtype)
                   if use_ln else None)
        self.act = (Activation("prelu", out) if self.activation == "prelu"
                    else activation_fn(activation))
        self.regularizer = (None if kernel_regularizer is None
                            else regularizer_builder(kernel_regularizer))

    def penalty(self):
        """The kernels' regularization term (float32), or None."""
        if self.regularizer is None:
            return None
        if self.separable:
            return (self.regularizer(self.depthwise_kernel.float())
                    + self.regularizer(self.pointwise_kernel.float()))
        return self.regularizer(self.kernel.float())

    def _conv(self, x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
        if self.transpose:
            return conv_transpose(x.to(cdt), self.kernel.to(cdt),
                                  self.strides, self.padding)
        if self.separable:
            y = quant_ops.conv_nchw(x.to(cdt), self.depthwise_kernel.to(cdt),
                                    self.strides, self.padding, x.shape[1])
            return quant_ops.conv_nchw(y, self.pointwise_kernel.to(cdt),
                                       (1, 1), "SAME", 1)
        groups = self.groups
        m = self.depth_multiplier
        if m is not None and m > 1:
            # output channel o reads input o // m: with each input channel
            # repeated m times the conv is a plain depthwise one (C·m
            # groups of one), which cuDNN runs far faster than C groups of
            # m outputs; the same products, and the same input amax
            b, c, h, w = x.shape
            x = nchw(nhwc(x).unsqueeze(-1).expand(b, h, w, c, m).reshape(
                b, h, w, c * m))
            groups = c * m
        return quant_ops.conv2d(self, "in", x, self.kernel, self.strides,
                                self.padding, groups, compute_dtype=cdt)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator = None) -> torch.Tensor:
        cdt = self.dtype or x.dtype
        y = self._conv(x, cdt)
        if self.bias is not None:
            y = y + self.bias.to(cdt).view(1, -1, 1, 1)
        if self.bn is not None:
            # the resolved compute dtype, as the JAX block passes it
            y = self.bn(y, train=train, dtype=cdt)
        if self.ln is not None:
            y = self.ln(y)
        y = self.act(y)
        if train:
            y = dropout(y, self.dropout_rate, generator)
            y = dropout(y, self.spatial_dropout_rate, generator,
                        channels=True)
        return y


def conv_block_from_params(in_features: int, params: dict, dtype=None,
                           use_ln: bool = False, use_bn: bool = False,
                           bn_center: bool = False,
                           bn_bias_free: bool = False,
                           **overrides) -> ConvBlock:
    """A ConvBlock from a reference-schema conv-params dict (kernel_size /
    filters / depth_multiplier / groups / strides / padding / use_bias /
    activation / kernel_regularizer …)."""
    p = dict(params or {})
    p.update(overrides)
    return ConvBlock(
        in_features, features=p.get("filters", 0),
        kernel_size=p.get("kernel_size", 3),
        strides=p.get("strides", (1, 1)),
        depth_multiplier=p.get("depth_multiplier", None),
        activation=p.get("activation", "linear"),
        use_ln=use_ln, use_bn=use_bn, use_bias=p.get("use_bias", False),
        groups=p.get("groups", 1), transpose=p.get("transpose", False),
        separable=p.get("separable", False),
        kernel_regularizer=p.get("kernel_regularizer",
                                 p.get("depthwise_regularizer", None)),
        dtype=dtype, padding=p.get("padding", "SAME"), bn_center=bn_center,
        bn_bias_free=bn_bias_free, dropout_rate=p.get("dropout_rate", 0.0),
        spatial_dropout_rate=p.get("spatial_dropout_rate", 0.0),
        kernel_initializer=p.get("kernel_initializer",
                                 p.get("depthwise_initializer", None)))


class DenseBlock(nn.Module):
    """dense → optional bias → optional BatchNorm (no bias) → activation
    (flax ``DenseBlock``), on [B, in] inputs. The kernel is ``[in, out]``
    as flax stores it, so ``params_from_flax`` loads it as is; the
    product runs in the compute dtype (``dtype``, or the input's)."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = False, activation: str = "linear",
                 kernel_initializer="glorot_normal", kernel_regularizer=None,
                 use_bn: bool = False, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.kernel_initializer = kernel_initializer
        self.activation = str(activation or "linear").strip().lower()
        self.kernel = nn.Parameter(torch.zeros(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.bn = BatchNorm(features, use_bias=False, dtype=dtype) \
            if use_bn else None
        if self.activation != "linear":
            self.act = Activation(self.activation, features)
        self.regularizer = (None if kernel_regularizer is None
                            else regularizer_builder(kernel_regularizer))
        self.out_features = int(features)

    def penalty(self):
        if self.regularizer is None:
            return None
        return self.regularizer(self.kernel.float())

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        cdt = self.dtype or x.dtype
        y = x.to(cdt) @ self.kernel.to(cdt)
        if self.bias is not None:
            y = y + self.bias.to(cdt)
        if self.bn is not None:
            y = self.bn(y[:, :, None, None], train=train)[:, :, 0, 0]
        if self.activation != "linear":
            y = self.act(y)
        return y
