"""Value-range normalization (counterpart of
``blind_image_denoising_tpu/ops/normalize.py``). Elementwise, so the
functions take any layout and keep the input's dtype."""

import torch


def normalize(x: torch.Tensor, v_min: float = 0.0,
              v_max: float = 255.0) -> torch.Tensor:
    """[v_min, v_max] -> [-0.5, +0.5] with clipping."""
    y = torch.clamp(x, v_min, v_max)
    return (y - v_min) / (v_max - v_min) - 0.5


def denormalize(x: torch.Tensor, v_min: float = 0.0,
                v_max: float = 255.0) -> torch.Tensor:
    """[-0.5, +0.5] -> [v_min, v_max] with clipping."""
    y = torch.clamp(x, -0.5, 0.5)
    return (y + 0.5) * (v_max - v_min) + v_min
