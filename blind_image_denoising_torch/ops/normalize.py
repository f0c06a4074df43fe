"""Value-range and local normalization (counterpart of
``blind_image_denoising_tpu/ops/normalize.py``). The value-range
functions are elementwise, so they take any layout and keep the input's
dtype; ``local_normalization`` takes NHWC, as in JAX."""

import torch

from ..constants import DEFAULT_EPSILON
from .resize import avg_pool_same


def _clip_input(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip`` of an input that requires grad (``Denoiser.
    float_forward``): jnp.clip is a max then a min, so a pixel at exactly
    a bound (0 or 255, common in images) passes half its gradient, where
    ``torch.clamp`` passes all of it. Every other caller takes
    ``torch.clamp``: the values are the same."""
    if not x.requires_grad:
        return torch.clamp(x, lo, hi)
    return torch.minimum(torch.maximum(x, torch.tensor(lo, dtype=x.dtype)),
                         torch.tensor(hi, dtype=x.dtype))


def normalize(x: torch.Tensor, v_min: float = 0.0,
              v_max: float = 255.0) -> torch.Tensor:
    """[v_min, v_max] -> [-0.5, +0.5] with clipping."""
    y = _clip_input(x, v_min, v_max)
    return (y - v_min) / (v_max - v_min) - 0.5


def denormalize(x: torch.Tensor, v_min: float = 0.0,
                v_max: float = 255.0) -> torch.Tensor:
    """[-0.5, +0.5] -> [v_min, v_max] with clipping."""
    y = torch.clamp(x, -0.5, 0.5)
    return (y + 0.5) * (v_max - v_min) + v_min


def local_normalization(x: torch.Tensor, pool_size=(16, 16)) -> torch.Tensor:
    """Local mean/sigma normalization of NHWC x by SAME average pooling
    (count-aware at the borders)."""
    mean = avg_pool_same(x, pool_size, (1, 1))
    var = avg_pool_same(torch.square(x - mean), pool_size, (1, 1))
    return (x - mean) / torch.sqrt(var + DEFAULT_EPSILON)
