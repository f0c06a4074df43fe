"""Multiscale ground truth for deep supervision (counterpart of
``blind_image_denoising_tpu/ops/multiscale.py``): repeated 2×2 VALID
average pooling, each level clipped to [0, 255] and rounded. NHWC.

``torch.round`` rounds half to even, as ``jnp.round`` does, so the
targets agree to the bit with the JAX package's.
"""

from typing import List

import torch

from .resize import avg_pool_valid


def multiscale_targets(x: torch.Tensor, no_scales: int,
                       clip_values: bool = False,
                       round_values: bool = False) -> List[torch.Tensor]:
    """x: [B, H, W, C] → [x, x/2, …], ``no_scales + 1`` tensors, finest
    first."""
    scales = [x]
    for _ in range(no_scales):
        x = avg_pool_valid(x, (2, 2), (2, 2))
        if clip_values:
            x = torch.clamp(x, 0.0, 255.0)
        if round_values:
            x = torch.round(x)
        scales.append(x)
    return scales
