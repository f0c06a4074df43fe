"""Value-range normalization and local/global contrast ops (counterpart
of ``blind_image_denoising_tpu/ops/normalize.py``). The elementwise
functions take any layout and keep the input's dtype;
``global_normalization``, ``local_normalization`` and ``details`` take
NHWC, as in JAX."""

import torch

from ..constants import DEFAULT_EPSILON
from .precision import has_tangent
from .resize import avg_pool_same


def clip_normalized(x: torch.Tensor) -> torch.Tensor:
    """Clip to [-0.5, +0.5]."""
    return torch.clamp(x, -0.5, 0.5)


def clip_unnormalized(x: torch.Tensor) -> torch.Tensor:
    """Clip to [0, 255]."""
    return torch.clamp(x, 0.0, 255.0)


def _clip_input(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip`` of an input that requires grad or carries a
    forward-mode tangent (``Denoiser.float_forward``, ``analysis``):
    jnp.clip is a max then a min, so a pixel at exactly a bound (0 or
    255, common in images) passes half its derivative, where
    ``torch.clamp`` passes all of it. Every other caller takes
    ``torch.clamp``: the values are the same."""
    if not (x.requires_grad or has_tangent(x)):
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


def global_normalization(x: torch.Tensor) -> torch.Tensor:
    """Zero-mean unit-sigma per (sample, channel) of NHWC x over H and W."""
    mean = torch.mean(x, dim=(1, 2), keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=(1, 2), keepdim=True)
    return (x - mean) / torch.sqrt(var + DEFAULT_EPSILON)


def highpass_filter(x: torch.Tensor, a: float = 8.0,
                    b: float = 4.0) -> torch.Tensor:
    """``tanh(a·x)^b · x``: keeps the large magnitudes."""
    return torch.pow(torch.tanh(a * x), b) * x


def lowpass_filter(x: torch.Tensor, a: float = 8.0,
                   b: float = 4.0) -> torch.Tensor:
    """``(1 − tanh(a·x)^b) · x``: keeps the small magnitudes."""
    return (1.0 - torch.pow(torch.tanh(a * x), b)) * x


def details(x: torch.Tensor) -> torch.Tensor:
    """The contrast / details extractor: the high-pass of the globally
    normalized NHWC x."""
    x = global_normalization(x)
    return torch.pow(torch.tanh(8.0 * x), 4.0) * x
