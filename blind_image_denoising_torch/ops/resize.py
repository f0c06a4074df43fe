"""Pooling and resampling on NHWC tensors (counterpart of
``blind_image_denoising_tpu/ops/resize.py``).

The functions take and return NHWC tensors like their JAX counterparts.
The model holds NCHW tensors in ``torch.channels_last`` memory format,
whose ``permute(0, 2, 3, 1)`` view is exactly such an NHWC tensor, so
the model passes views and nothing is copied.
"""

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels_last) → NHWC view."""
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC → NCHW view (channels_last when the NHWC tensor is
    contiguous)."""
    return x.permute(0, 3, 1, 2)


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA/TF SAME padding along one axis: the odd extra element goes on
    the HIGH side."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _window_sum(x: torch.Tensor, window: Sequence[int],
                strides: Sequence[int]) -> torch.Tensor:
    (kh, kw), (sh, sw) = window, strides
    _, h, w, _ = x.shape
    ph, pw = same_pads(h, kh, sh), same_pads(w, kw, sw)
    xp = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    oh, ow = -(-h // sh), -(-w // sw)
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            tap = xp[:, dy:dy + (oh - 1) * sh + 1:sh,
                     dx:dx + (ow - 1) * sw + 1:sw, :]
            acc = tap if acc is None else acc + tap
    return acc


def avg_pool_same(x: torch.Tensor, window, strides) -> torch.Tensor:
    """TF AveragePooling2D(padding='same') on NHWC: the mean over the
    in-image taps only (count-aware divide)."""
    window = tuple(int(v) for v in window)
    strides = tuple(int(v) for v in strides)
    summed = _window_sum(x, window, strides)
    ones = torch.ones((1, x.shape[1], x.shape[2], 1), dtype=x.dtype,
                      device=x.device)
    return summed / _window_sum(ones, window, strides)


def upsample_2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2× upsample (Keras UpSampling2D 'nearest')."""
    b, h, w, c = x.shape
    y = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return y.reshape(b, 2 * h, 2 * w, c)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize to a static (H, W), as ``jax.image.resize(...,
    "bilinear")``: half-pixel centres and, when it downscales, a
    triangle kernel widened by the scale (antialiasing) with weights
    renormalised over in-image taps — ``F.interpolate``'s
    ``antialias=True`` computes the same. Computed in float32 and cast
    back to the input dtype."""
    y = F.interpolate(nchw(x).float(), size=(int(size[0]), int(size[1])),
                      mode="bilinear", align_corners=False, antialias=True)
    return nhwc(y).to(x.dtype)
