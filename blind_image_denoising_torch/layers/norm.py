"""LayerNorm over channels with float32 statistics (counterpart of
``blind_image_denoising_tpu/layers/norm.py`` ``FastLayerNorm``, forward
only).

The mean and reciprocal std are computed in float32; the full-resolution
normalize-and-scale runs in the compute dtype, as the JAX module does so
that bf16 serving moves bf16 bytes. No bias (the port's configs are
bias-free).
"""

import torch
from torch import nn


class FastLayerNorm(nn.Module):
    """Normalizes NCHW tensors over C. ``dtype`` is the compute dtype of
    the normalize/scale step (``None``: the input's)."""

    def __init__(self, features: int, epsilon: float = 1e-6,
                 use_bias: bool = False, dtype=None):
        super().__init__()
        if use_bias:
            raise NotImplementedError(
                "LayerNorm bias is not ported yet (ROADMAP Queue 1 item 9)")
        self.epsilon = float(epsilon)
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.dtype or x.dtype
        xf = x.float()
        mean = xf.mean(dim=1, keepdim=True)
        var = (xf - mean).square().mean(dim=1, keepdim=True)
        rsig = torch.rsqrt(var + self.epsilon)
        xhat = (x.to(cdt) - mean.to(cdt)) * rsig.to(cdt)
        return xhat * self.scale.to(cdt).view(1, -1, 1, 1)
