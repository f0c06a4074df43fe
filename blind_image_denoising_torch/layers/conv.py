"""The convolution block (counterpart of
``blind_image_denoising_tpu/layers/conv.py`` ``ConvBlock``):
conv → optional bias → optional BatchNorm (flax's, or bias-free) →
optional LayerNorm → activation.

Plain, grouped and depthwise convs (``depth_multiplier`` m: a kernel
[C·m, 1, kh, kw] with C groups, so output channel o reads input o // m,
as in lax), SAME or VALID padding. Tensors are NCHW (``channels_last``),
kernels OIHW. Every conv goes through ``ops/quant.py``'s ``conv2d`` with
the site name ``"in"``, as in JAX: in the compute dtype (``dtype``, or
the input's) with no quantization mode, or its calibrate / int8 paths.
SAME padding follows XLA: an odd total pads one more on the high side.

Not ported yet, and raising: transposed and separable convs (ROADMAP
Queue 1 item 11), and dropout inside the block.

``kernel_regularizer`` (a config spec for ``ops/regularizers.builder``)
gives the block a ``penalty()`` of its float32 kernel: the term the JAX
block sows into its ``losses`` collection during training.
"""

from typing import Optional

import torch
from torch import nn

from ..constants import DEFAULT_LN_EPSILON
from ..ops import quant as quant_ops
from ..ops.regularizers import builder as regularizer_builder
from ..ops.resize import nchw, nhwc
from .activations import activation_fn
from .norm import BatchNorm, BiasFreeBatchNorm, FastLayerNorm


def _pair(v):
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


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
                 bn_bias_free: bool = False):
        super().__init__()
        if transpose or separable:
            raise NotImplementedError(
                "transposed and separable convs are not ported yet "
                "(ROADMAP Queue 1 item 11)")
        kh, kw = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = str(padding).upper()
        self.dtype = dtype
        self.depth_multiplier = (None if depth_multiplier is None
                                 else int(depth_multiplier))
        if depth_multiplier is not None:
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
        self.act = activation_fn(activation)
        self.regularizer = (None if kernel_regularizer is None
                            else regularizer_builder(kernel_regularizer))

    def penalty(self):
        """The kernel's regularization term (float32), or None."""
        if self.regularizer is None:
            return None
        return self.regularizer(self.kernel.float())

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        cdt = self.dtype or x.dtype
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
        y = quant_ops.conv2d(self, "in", x, self.kernel, self.strides,
                             self.padding, groups, compute_dtype=cdt)
        if self.bias is not None:
            y = y + self.bias.to(cdt).view(1, -1, 1, 1)
        if self.bn is not None:
            # the resolved compute dtype, as the JAX block passes it
            y = self.bn(y, train=train, dtype=cdt)
        if self.ln is not None:
            y = self.ln(y)
        return self.act(y)


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
    if (p.get("dropout_rate", 0.0) or 0.0) > 0.0 or \
            (p.get("spatial_dropout_rate", 0.0) or 0.0) > 0.0:
        raise NotImplementedError(
            "dropout inside a conv block is not ported yet (ROADMAP Queue 1 "
            "item 9)")
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
        bn_bias_free=bn_bias_free)
