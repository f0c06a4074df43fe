"""SSIM as ``tf.image.ssim`` computes it (counterpart of
``blind_image_denoising_tpu/ops/ssim.py``): Gaussian-windowed local
statistics per channel, VALID, sigma 1.5, (k1, k2) = (0.01, 0.03).

The separable window runs as explicit shifted multiply-adds in float32:
the variance term ``mu11 − mu1²`` cancels catastrophically at the 0–255
scale, so the window sums must stay in full float32 (the JAX module
forces ``precision=HIGHEST`` for the same reason), and shifted adds are
exact float32 on every device, where a cuDNN convolution may run in
TF32. The five statistics of a pair are reduced together, stacked on the
channel axis.
"""

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


@lru_cache(maxsize=None)
def _gaussian_window(size: int, sigma: float) -> Tuple[float, ...]:
    """1-D Gaussian window identical to tf.image's ``_fspecial_gauss``."""
    coords = np.arange(size, dtype=np.float64) - (size - 1.0) / 2.0
    g = np.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    g /= g.sum()
    return tuple(float(v) for v in g.astype(np.float32))


def _window_reduce(x: torch.Tensor, window: Tuple[float, ...]) -> torch.Tensor:
    """Separable VALID Gaussian reduction of [B, H, W, C] over H, then W."""
    n = len(window)
    h, w = x.shape[1] - n + 1, x.shape[2] - n + 1
    acc = None
    for i, g in enumerate(window):
        tap = x[:, i:i + h] * g
        acc = tap if acc is None else acc + tap
    out = None
    for i, g in enumerate(window):
        tap = acc[:, :, i:i + w] * g
        out = tap if out is None else out + tap
    return out


def ssim(img1: torch.Tensor, img2: torch.Tensor, max_val: float = 255.0,
         filter_size: int = 11, filter_sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Per-image SSIM of two [B, H, W, C] float32 batches, shape [B] (the
    mean over positions and channels)."""
    return torch.mean(ssim_map(img1, img2, max_val, filter_size,
                               filter_sigma, k1, k2), dim=(1, 2, 3))


def ssim_map(img1: torch.Tensor, img2: torch.Tensor, max_val: float = 255.0,
             filter_size: int = 11, filter_sigma: float = 1.5,
             k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """The SSIM of every VALID window position and channel,
    [B, H − filter_size + 1, W − filter_size + 1, C]."""
    window = _gaussian_window(int(filter_size), float(filter_sigma))
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    c = img1.shape[-1]
    stats = _window_reduce(torch.cat(
        [img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=-1), window)
    mu1, mu2, mu11, mu22, mu12 = torch.split(stats, c, dim=-1)

    num0 = mu1 * mu2 * 2.0
    den0 = torch.square(mu1) + torch.square(mu2)
    luminance = (num0 + c1) / (den0 + c1)

    num1 = (mu12 - mu1 * mu2) * 2.0
    den1 = (mu11 + mu22) - (torch.square(mu1) + torch.square(mu2))
    cs = (num1 + c2) / (den1 + c2)
    return luminance * cs


def ssim_loss(img1: torch.Tensor, img2: torch.Tensor, max_val: float = 255.0,
              filter_size: int = 7) -> torch.Tensor:
    """1 − the batch's mean SSIM."""
    return 1.0 - torch.mean(ssim(img1, img2, max_val=max_val,
                                 filter_size=filter_size))
