"""ConvNext residual unit (counterpart of
``blind_image_denoising_tpu/layers/convnext.py`` ``ConvNextBlock`` plus
the skip add of ``models/unet_laplacian.py`` ``residual_stage``).

At inference the whole unit — depthwise K×K → LayerNorm → 1×1 expand
×4 + leaky ReLU 0.1 → 1×1 project → gain → + skip — is one call of the
fused kernel ``ops/pallas_convnext.convnext_block``. Unlike the JAX
module, :meth:`ConvNextBlock.forward` therefore returns ``x + block(x)``;
stochastic depth and dropout are the identity at inference.

Parameter names mirror the flax tree (``conv_1.kernel`` [C, 1, K, K],
``conv_1.ln.scale`` [C], ``conv_2.kernel`` [E, C], ``conv_3.kernel``
[C, E], ``gamma.w_multiplier`` [C]), so ``weights.params_from_flax``
output loads directly.
"""

import torch
from torch import nn

from ..constants import DEFAULT_LN_EPSILON
from ..ops.pallas_convnext import convnext_block
from ..ops.resize import nchw, nhwc
from .multipliers import ChannelLearnableMultiplier
from .norm import FastLayerNorm

_LEAKY_SLOPES = {"leaky_relu_01": 0.1, "leakyrelu_01": 0.1}


class _Depthwise(nn.Module):
    def __init__(self, features: int, kernel_size: int):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.zeros(features, 1, kernel_size, kernel_size))
        self.ln = FastLayerNorm(features, epsilon=DEFAULT_LN_EPSILON)


class _Pointwise(nn.Module):
    def __init__(self, out_features: int, in_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(out_features, in_features))


class ConvNextBlock(nn.Module):
    """One residual unit with the flagship's options (LayerNorm, gamma,
    no bias, linear depthwise, ``leaky_relu_01`` expansion)."""

    def __init__(self, features: int, kernel_size: int, expansion: int,
                 activation: str = "leaky_relu_01"):
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
        self.conv_1 = _Depthwise(features, kernel_size)
        self.conv_2 = _Pointwise(expansion, features)
        self.conv_3 = _Pointwise(features, expansion)
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NCHW (channels_last) → x + block(x), same dtype."""
        w = self.kernel_weights(x.dtype)
        return nchw(convnext_block(nhwc(x), slope=self.slope, **w))
