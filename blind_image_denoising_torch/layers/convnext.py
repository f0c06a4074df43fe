"""ConvNext residual unit (counterpart of
``blind_image_denoising_tpu/layers/convnext.py`` ``ConvNextBlock`` plus
the skip add of ``models/unet_laplacian.py`` ``residual_stage``).

Two paths compute the same unit — depthwise K×K → LayerNorm → 1×1
expand ×4 + leaky ReLU 0.1 → 1×1 project → gain:

* :meth:`ConvNextBlock.branch`, from PyTorch ops with autograd
  (``F.conv2d`` with groups = C, :class:`FastLayerNorm`, two 1×1
  products): the training path, as the JAX train step runs the flax unit
  in XLA. It returns the branch alone, so the stage can drop it per
  sample before the skip add.
* the fused inference kernel ``ops/pallas_convnext.convnext_block``
  (K1), which has no backward, fed from a detached weight cache.
  :meth:`ConvNextBlock.forward` takes it only when no derivative is
  wanted (serving); for a gradient, or an input that carries a
  forward-mode tangent (``torch.autograd.forward_ad``, as the analysis's
  net-bias map), it returns ``x + branch(x)``, so neither is silently
  dropped.

Which units K1 serves is decided when the unit is built, from the
kernel's own shapes and options alone (``kernel_route``): every shape
JAX's kernel takes, any C, odd K and E
(``pallas_convnext.kernel_supports``; off C <= 1024 at K = 1, 3, 5, 7 with
E = 4C on the kernel's general route),
as many output as input channels, LayerNorm without BatchNorm or biases,
the gain, the ``leaky_relu_01`` expansion and no dropout. So every
ConvNext unit of the packaged unet_laplacian configs launches K1 — the
flagship's and ``unet_laplacian_v6``'s levels 0 and 1, and all three
levels of ``unet_laplacian_v3`` / ``_v4`` (level 2 at C = 128: the
encoders' (128, 5), the decoders' (128, 1)) and ``_v5`` — and so do
levels 2 to 5 of a depth-4 to depth-6 ``unet_laplacian_v6`` (C = 128,
256, and 512 and 1024 where levels 4 and 5 are no attention levels), the
levels of one whose ``filters_level_multiplier`` gives widths that are
no power of two (48, 72, 108), those of one whose kernel sizes are 7,
and, on the general route, level 6 (C = 2048) of a no-attention depth-7
one and units at K = 9 or with E other than 4C. Every other
unit — a concatenated
decoder input, BatchNorm, biases, another activation, an even kernel —
computes ``x + branch(x)`` (or the
branch alone when the channels change) on every device, as JAX runs
every unit in XLA; each such forward adds one to
``pallas_convnext.branch_units``. A unit routed to
K1 launches it for a CUDA tensor or raises. While ``torch.export``
traces the unit (``inference/export.serialize_torch_export``) it calls K1
as the custom operator ``bidt::convnext_block`` (``ops/export_ops.py``).

The options follow the flax unit: ``use_bias`` (a bias on each conv,
and on the LayerNorm and BatchNorm), ``use_bn`` (BatchNorm on
``conv_1`` before its LayerNorm, batch statistics in training),
``use_ln``, ``use_gamma``, and ``dropout_rate`` /
``spatial_dropout_rate`` on ``conv_2``'s activated output in training,
masks from the caller's generator.

The branch runs its three convs through ``ops/quant.conv2d`` as the JAX
unit runs its three ``ConvBlock``s: the sites are ``conv_1`` (the
depthwise conv, before the LayerNorm), ``conv_2`` and ``conv_3``, each
named ``"in"`` under its module path. Under ``quant_mode("calibrate")``
or ``quant_mode("int8")`` the forward takes the branch, not K1: each site
records its input's amax or runs its int8 conv with JAX's rounding
points, as JAX's int8 hydra runs the unit per site (its Pallas unit
kernel serves only ``inference/fused.py``). With no mode the branch's
convs are the plain float ones.

Parameter names mirror the flax tree (``conv_1.kernel`` [C, 1, K, K],
``conv_1.ln.scale`` [C], ``conv_2.kernel`` [E, C], ``conv_3.kernel``
[C, E], ``gamma.w_multiplier`` [C]), so ``weights.params_from_flax``
output loads directly. ``depthwise_regularizer`` and
``pointwise_regularizer`` give the kernels their ``penalty()``.
"""

import torch
from torch import nn

from ..constants import DEFAULT_LN_EPSILON
from ..ops import pallas_convnext
from ..ops.pallas_convnext import convnext_block
from ..ops import quant as quant_ops
from ..ops.precision import has_tangent
from ..ops.regularizers import builder as regularizer_builder
from ..ops.resize import nchw, nhwc
from .activations import activation_fn
from .conv import dropout
from .multipliers import ChannelLearnableMultiplier
from .norm import BatchNorm, FastLayerNorm

_LEAKY_SLOPES = {"leaky_relu_01": 0.1, "leakyrelu_01": 0.1}


class _Regularized(nn.Module):
    def __init__(self, shape, regularizer, use_bias: bool):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(shape))
        self.bias = nn.Parameter(torch.zeros(shape[0])) if use_bias else None
        self.regularizer = (None if regularizer is None
                            else regularizer_builder(regularizer))

    def penalty(self):
        if self.regularizer is None:
            return None
        return self.regularizer(self.kernel.float())

    def add_bias(self, y: torch.Tensor) -> torch.Tensor:
        if self.bias is None:
            return y
        return y + self.bias.to(y.dtype).view(1, -1, 1, 1)


class _Depthwise(_Regularized):
    def __init__(self, features: int, kernel_size: int, regularizer=None,
                 use_bias: bool = False, use_bn: bool = False,
                 use_ln: bool = True):
        super().__init__((features, 1, kernel_size, kernel_size),
                         regularizer, use_bias)
        self.bn = BatchNorm(features, use_bias=use_bias) if use_bn else None
        self.ln = (FastLayerNorm(features, epsilon=DEFAULT_LN_EPSILON,
                                 use_bias=use_bias) if use_ln else None)


class _Pointwise(_Regularized):
    def __init__(self, out_features: int, in_features: int,
                 regularizer=None, use_bias: bool = False):
        super().__init__((out_features, in_features), regularizer, use_bias)


class ConvNextBlock(nn.Module):
    """One residual unit: ``features`` in, ``out_features`` (default
    ``features``) out, depthwise ``kernel_size``, ``expansion`` hidden
    channels."""

    def __init__(self, features: int, kernel_size: int, expansion: int,
                 activation: str = "leaky_relu_01",
                 depthwise_regularizer=None, pointwise_regularizer=None,
                 out_features: int = None, use_bias: bool = False,
                 use_bn: bool = False, use_ln: bool = True,
                 use_gamma: bool = True, dropout_rate: float = 0.0,
                 spatial_dropout_rate: float = 0.0):
        super().__init__()
        out = features if out_features is None else int(out_features)
        key = activation.strip().lower()
        self.slope = _LEAKY_SLOPES.get(key)
        self.act = activation_fn(activation)
        self.residual = out == features
        self.dropout_rate = max(0.0, float(dropout_rate or 0.0))
        self.spatial_dropout_rate = max(0.0,
                                        float(spatial_dropout_rate or 0.0))
        self.conv_1 = _Depthwise(features, kernel_size, depthwise_regularizer,
                                 use_bias, use_bn, use_ln)
        self.conv_2 = _Pointwise(expansion, features, pointwise_regularizer,
                                 use_bias)
        self.conv_3 = _Pointwise(out, expansion, pointwise_regularizer,
                                 use_bias)
        self.gamma = ChannelLearnableMultiplier(out) if use_gamma else None
        # the kernel's own shapes and options decide, once
        self.kernel_route = (
            self.residual
            and pallas_convnext.kernel_supports(features, kernel_size,
                                                expansion)
            and use_ln and not use_bn and not use_bias and use_gamma
            and self.slope is not None and self.dropout_rate == 0.0
            and self.spatial_dropout_rate == 0.0)
        self._cache = None

    def kernel_weights(self, dtype: torch.dtype):
        """The fused kernel's weights; the 1×1 matrices in the activation
        dtype. Cached per dtype/device until a parameter changes."""
        params = (self.conv_1.kernel, self.conv_1.ln.scale,
                  self.conv_2.kernel, self.conv_3.kernel,
                  self.gamma.w_multiplier)
        key = (dtype, params[0].device,
               tuple(p._version for p in params),
               tuple(p.data_ptr() for p in params))
        if self._cache is None or self._cache[0] != key:
            with torch.no_grad():
                w = dict(dw=self.conv_1.kernel.detach().float(),
                         ln_scale=self.conv_1.ln.scale.detach().float(),
                         w2=self.conv_2.kernel.detach().to(dtype),
                         w3=self.conv_3.kernel.detach().to(dtype),
                         gain=self.gamma.gain().detach().float())
            # the kernel's operands of these weights by the I/O dtype of
            # the x they run on, made at first use
            self._cache = [key, w, {}]
        return self._cache[1]

    def kernel_operands(self, dtype: torch.dtype, io_dtype=None):
        """:meth:`kernel_weights` in ``dtype`` as the kernel takes them
        (``pallas_convnext.kernel_operands``: cast, padded to the width of
        the layout that runs the unit, on 16 bytes; a streamed layout's
        chunks), for an x of ``io_dtype`` (default ``dtype``; int8 codes
        take ``dtype`` ``torch.bfloat16``, ``io_dtype`` ``torch.int8``,
        whose layout may take other chunks than bf16's). Cached with the
        weights, so a launch with them runs no cast, pad or copy until a
        parameter changes."""
        w = self.kernel_weights(dtype)
        io_dtype = dtype if io_dtype is None else io_dtype
        ops = self._cache[2]
        if io_dtype not in ops:
            with torch.no_grad():
                ops[io_dtype] = pallas_convnext.kernel_operands(io_dtype,
                                                                **w)
        return ops[io_dtype]

    def _quant_sites_active(self) -> bool:
        return any(quant_ops.current_quant_mode(
            getattr(m, "_quant_path", "")) is not None
            for m in (self.conv_1, self.conv_2, self.conv_3))

    def branch(self, x: torch.Tensor, train: bool = False,
               generator: torch.Generator = None) -> torch.Tensor:
        """The unit without its skip, in x's dtype, differentiable. x: NCHW
        (channels_last). ``train``: batch statistics and dropout, whose
        masks come from ``generator``."""
        c = x.shape[1]
        e = self.conv_2.kernel.shape[0]
        t = self.conv_1.add_bias(quant_ops.conv2d(
            self.conv_1, "in", x, self.conv_1.kernel, (1, 1), "SAME", c))
        if self.conv_1.bn is not None:
            t = self.conv_1.bn(t, train=train, dtype=t.dtype)
        if self.conv_1.ln is not None:
            t = self.conv_1.ln(t)
        h = self.act(self.conv_2.add_bias(quant_ops.conv2d(
            self.conv_2, "in", t, self.conv_2.kernel.view(e, c, 1, 1))))
        if train:
            h = dropout(h, self.dropout_rate, generator)
            h = dropout(h, self.spatial_dropout_rate, generator,
                        channels=True)
        out = self.conv_3.kernel.shape[0]
        p = self.conv_3.add_bias(quant_ops.conv2d(
            self.conv_3, "in", h, self.conv_3.kernel.view(out, e, 1, 1)))
        return p if self.gamma is None else self.gamma(p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NCHW (channels_last) → x + block(x) (the block alone when
        the channels change), same dtype."""
        if not self.kernel_route:
            pallas_convnext.branch_units += 1
            y = self.branch(x)
            return x + y if self.residual else y
        if torch.compiler.is_exporting():
            # the kernel as a custom operator the exported graph holds
            # (ops/export_ops.py), fed from the params themselves
            from ..ops import export_ops
            return nchw(export_ops.convnext_block(
                nhwc(x), self.conv_1.kernel.float(),
                self.conv_1.ln.scale.float(), self.conv_2.kernel.to(x.dtype),
                self.conv_3.kernel.to(x.dtype),
                self.gamma.gain().float(), self.slope))
        # a derivative, reverse or forward mode, goes through the branch:
        # the kernel carries neither
        if self._quant_sites_active() or has_tangent(x) or (
                torch.is_grad_enabled() and (
                    x.requires_grad or any(p.requires_grad
                                           for p in self.parameters()))):
            return x + self.branch(x)
        w = self.kernel_weights(x.dtype)
        ops = self.kernel_operands(x.dtype) if x.is_cuda else None
        return nchw(convnext_block(nhwc(x), slope=self.slope, operands=ops,
                                   **w))
