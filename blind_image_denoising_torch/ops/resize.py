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


# windows of up to this many taps are summed tap by tap, in the order the
# band split's plain versions use
_LOOP_TAPS = 25


def _window_sum(x: torch.Tensor, window: Sequence[int],
                strides: Sequence[int]) -> torch.Tensor:
    (kh, kw), (sh, sw) = window, strides
    _, h, w, _ = x.shape
    ph, pw = same_pads(h, kh, sh), same_pads(w, kw, sw)
    xp = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    if kh * kw > _LOOP_TAPS:
        # a wide window (the selector's 32² and 64² pools, local
        # normalization's 11² and 16²): one pooling kernel, summing in
        # float32, where the tap loop would launch kh·kw eager adds
        return nhwc(F.avg_pool2d(nchw(xp), (kh, kw), (sh, sw),
                                 divisor_override=1))
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


def avg_pool_valid(x: torch.Tensor, window, strides) -> torch.Tensor:
    """TF AveragePooling2D(padding='valid') on NHWC: the window sum over
    whole windows only, divided by the window size."""
    (kh, kw), (sh, sw) = (tuple(int(v) for v in window),
                          tuple(int(v) for v in strides))
    _, h, w, _ = x.shape
    oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            tap = x[:, dy:dy + (oh - 1) * sh + 1:sh,
                    dx:dx + (ow - 1) * sw + 1:sw, :]
            acc = tap if acc is None else acc + tap
    return acc / float(kh * kw)


def max_pool_same(x: torch.Tensor, window=(2, 2),
                  strides=(2, 2)) -> torch.Tensor:
    """TF MaxPooling2D(padding='same') on NHWC: the max over the in-image
    taps (XLA pads with -inf, the odd extra on the high side)."""
    (kh, kw), (sh, sw) = (tuple(int(v) for v in window),
                          tuple(int(v) for v in strides))
    _, h, w, _ = x.shape
    ph, pw = same_pads(h, kh, sh), same_pads(w, kw, sw)
    xp = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    oh, ow = -(-h // sh), -(-w // sw)
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            tap = xp[:, dy:dy + (oh - 1) * sh + 1:sh,
                     dx:dx + (ow - 1) * sw + 1:sw, :]
            acc = tap if acc is None else torch.maximum(acc, tap)
    return acc


def global_avg_pool(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """The mean of NHWC x over H and W."""
    return x.mean(dim=(1, 2), keepdim=keepdims)


def downsample_2x_stride(x: torch.Tensor) -> torch.Tensor:
    """Strided-slice 2× downsample of NHWC x: the even rows and columns."""
    return x[:, ::2, ::2, :]


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """[B, H, W, C] → [B, H/r, W/r, C·r²] (pixel-unshuffle); channel
    blocks in (row offset, column offset, channel) order, as the JAX
    function, so :func:`depth_to_space` is its exact inverse."""
    b, h, w, c = x.shape
    if h % r or w % r:
        raise ValueError(f"space_to_depth: H×W {h}×{w} not divisible by {r}")
    x = x.reshape(b, h // r, r, w // r, r, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // r, w // r, r * r * c)


def depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    """[B, H, W, C] → [B, H·r, W·r, C/r²] (pixel-shuffle), the inverse of
    :func:`space_to_depth`."""
    b, h, w, c = x.shape
    if c % (r * r):
        raise ValueError(f"depth_to_space: C={c} not divisible by {r * r}")
    x = x.reshape(b, h, w, r, r, c // (r * r))
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h * r, w * r, c // (r * r))


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
    back to the input dtype. A size that is symbolic (a shape under
    ``torch.export``) stays so."""
    size = tuple(s if isinstance(s, torch.SymInt) else int(s)
                 for s in size[:2])
    y = F.interpolate(nchw(x).float(), size=size,
                      mode="bilinear", align_corners=False, antialias=True)
    return nhwc(y).to(x.dtype)


def upsample_2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2× upsample of NHWC x with half-pixel centres, as
    ``jax.image.resize(..., "bilinear")``: output 2i takes
    ``0.25·x[i−1] + 0.75·x[i]`` and 2i+1 ``0.75·x[i] + 0.25·x[i+1]``, and
    at the borders the weights renormalize over the in-image tap, which
    repeats the edge row (and column). Rows then columns, in float32,
    cast back to the input dtype."""

    def along(y: torch.Tensor, dim: int) -> torch.Tensor:
        n = y.shape[dim]
        prev = torch.cat([y.narrow(dim, 0, 1), y.narrow(dim, 0, n - 1)], dim)
        nxt = torch.cat([y.narrow(dim, 1, n - 1), y.narrow(dim, n - 1, 1)],
                        dim)
        even, odd = 0.25 * prev + 0.75 * y, 0.75 * y + 0.25 * nxt
        out = torch.stack([even, odd], dim + 1)
        shape = list(y.shape)
        shape[dim] = 2 * n
        return out.reshape(shape)

    return along(along(x.float(), 1), 2).to(x.dtype)
