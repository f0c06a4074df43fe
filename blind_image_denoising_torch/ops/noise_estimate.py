"""Blind per-image noise-level estimation (counterpart of
``blind_image_denoising_tpu/ops/noise_estimate.py``).

Immerkaer's biharmonic stencil made robust with a median:
``sigma_hat = median(|x * N|) / (6 * 0.674490)``. The median is the
NumPy/JAX one — for an even count it averages the two middle values —
which ``torch.median`` is not (it returns the lower one), so it is
computed from a sort here.
"""

import torch

# median(|N(0,1)|): the 0.75 quantile of the standard normal
_MAD_TO_STD = 0.6744897501960817
# L2 norm of the 3x3 biharmonic stencil
_STENCIL_NORM = 6.0


def laplacian_response(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H-2, W-2, C] response of the biharmonic
    stencil, computed as shifted adds."""
    c = x[:, 1:-1, 1:-1, :]
    up, dn = x[:, :-2, 1:-1, :], x[:, 2:, 1:-1, :]
    lf, rt = x[:, 1:-1, :-2, :], x[:, 1:-1, 2:, :]
    ul, ur = x[:, :-2, :-2, :], x[:, :-2, 2:, :]
    dl, dr = x[:, 2:, :-2, :], x[:, 2:, 2:, :]
    return 4.0 * c - 2.0 * (up + dn + lf + rt) + (ul + ur + dl + dr)


def median_last(v: torch.Tensor) -> torch.Tensor:
    """Median over the last axis with NumPy's convention: the mean of the
    two middle values for an even count."""
    n = v.shape[-1]
    s = torch.sort(v, dim=-1).values
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def estimate_sigma(x: torch.Tensor) -> torch.Tensor:
    """x: [B, H, W, C] (or [H, W, C]) float in [0, 255] → [B] (or scalar)
    float32 sigma_hat in gray levels."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    if x.shape[1] < 3 or x.shape[2] < 3:
        raise ValueError(
            f"estimate_sigma needs H, W >= 3 for the 3x3 stencil, got "
            f"spatial dims {x.shape[1]}x{x.shape[2]}")
    r = laplacian_response(x.float())
    mad = median_last(r.abs().reshape(r.shape[0], -1))
    sigma = mad / (_STENCIL_NORM * _MAD_TO_STD)
    return sigma[0] if squeeze else sigma
