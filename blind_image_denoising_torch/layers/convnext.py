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
  :meth:`ConvNextBlock.forward` takes it only when no gradient is
  wanted (serving); otherwise it returns ``x + branch(x)``, so a
  gradient is never silently dropped.

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
import torch.nn.functional as F
from torch import nn

from ..constants import DEFAULT_LN_EPSILON
from ..ops.pallas_convnext import convnext_block
from ..ops import quant as quant_ops
from ..ops.regularizers import builder as regularizer_builder
from ..ops.resize import nchw, nhwc
from .multipliers import ChannelLearnableMultiplier
from .norm import FastLayerNorm

_LEAKY_SLOPES = {"leaky_relu_01": 0.1, "leakyrelu_01": 0.1}


class _Regularized(nn.Module):
    def __init__(self, shape, regularizer):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(shape))
        self.regularizer = (None if regularizer is None
                            else regularizer_builder(regularizer))

    def penalty(self):
        if self.regularizer is None:
            return None
        return self.regularizer(self.kernel.float())


class _Depthwise(_Regularized):
    def __init__(self, features: int, kernel_size: int, regularizer=None):
        super().__init__((features, 1, kernel_size, kernel_size), regularizer)
        self.ln = FastLayerNorm(features, epsilon=DEFAULT_LN_EPSILON)


class _Pointwise(_Regularized):
    def __init__(self, out_features: int, in_features: int,
                 regularizer=None):
        super().__init__((out_features, in_features), regularizer)


class ConvNextBlock(nn.Module):
    """One residual unit with the flagship's options (LayerNorm, gamma,
    no bias, linear depthwise, ``leaky_relu_01`` expansion)."""

    def __init__(self, features: int, kernel_size: int, expansion: int,
                 activation: str = "leaky_relu_01",
                 depthwise_regularizer=None, pointwise_regularizer=None):
        super().__init__()
        key = activation.strip().lower()
        if key not in _LEAKY_SLOPES:
            raise NotImplementedError(
                f"ConvNext expansion activation [{activation}] is not "
                f"ported yet (ROADMAP Queue 1 item 9)")
        if kernel_size % 2 != 1:
            raise NotImplementedError(
                "even depthwise kernels are not ported yet (ROADMAP Queue "
                "1 item 9)")
        self.slope = _LEAKY_SLOPES[key]
        self.conv_1 = _Depthwise(features, kernel_size, depthwise_regularizer)
        self.conv_2 = _Pointwise(expansion, features, pointwise_regularizer)
        self.conv_3 = _Pointwise(features, expansion, pointwise_regularizer)
        self.gamma = ChannelLearnableMultiplier(features)
        self._cache = None

    def kernel_weights(self, dtype: torch.dtype):
        """The fused kernel's operands; the 1×1 matrices in the activation
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
            self._cache = (key, w)
        return self._cache[1]

    def _quant_sites_active(self) -> bool:
        return any(quant_ops.current_quant_mode(
            getattr(m, "_quant_path", "")) is not None
            for m in (self.conv_1, self.conv_2, self.conv_3))

    def branch(self, x: torch.Tensor) -> torch.Tensor:
        """The unit without its skip, in x's dtype, differentiable. x: NCHW
        (channels_last)."""
        c = x.shape[1]
        e = self.conv_2.kernel.shape[0]
        t = self.conv_1.ln(quant_ops.conv2d(
            self.conv_1, "in", x, self.conv_1.kernel, (1, 1), "SAME", c))
        h = F.leaky_relu(quant_ops.conv2d(
            self.conv_2, "in", t, self.conv_2.kernel.view(e, c, 1, 1)),
            self.slope)
        p = quant_ops.conv2d(self.conv_3, "in", h,
                             self.conv_3.kernel.view(c, e, 1, 1))
        return self.gamma(p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NCHW (channels_last) → x + block(x), same dtype."""
        if self._quant_sites_active() or (torch.is_grad_enabled() and (
                x.requires_grad or any(p.requires_grad
                                       for p in self.parameters()))):
            return x + self.branch(x)
        w = self.kernel_weights(x.dtype)
        return nchw(convnext_block(nhwc(x), slope=self.slope, **w))
