"""Power-of-two spatial padding for any-size inference (counterpart of
``blind_image_denoising_tpu/ops/padding.py``). NHWC tensors; the pad
amounts are Python ints.
"""

from typing import Tuple

import torch
import torch.nn.functional as F


def next_power_of_2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (int(n) - 1).bit_length()


def pad_to_power_of_2(x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """Zero-pad H and W of NHWC ``x`` on the high side up to the next
    power of two. Returns (padded, pad_h, pad_w)."""
    _, h, w, _ = x.shape
    pad_h = next_power_of_2(h) - h
    pad_w = next_power_of_2(w) - w
    return F.pad(x, (0, 0, 0, pad_w, 0, pad_h)), pad_h, pad_w


def remove_padding(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Undo :func:`pad_to_power_of_2`."""
    _, h, w, _ = x.shape
    return x[:, : h - pad_h, : w - pad_w, :]
