"""2× up/down sampling (counterpart of
``blind_image_denoising_tpu/layers/sampling.py``): the flagship's
``upsample_nearest_conv2d`` (nearest 2× then a 3×3 conv) and ``conv2d``
downsample (2×2 stride-2 conv). The other types raise."""

from typing import Dict

import torch
from torch import nn

from ..ops.resize import nchw, nhwc, upsample_2x_nearest
from .conv import conv_block_from_params


def _not_ported(kind: str, what: str):
    return NotImplementedError(
        f"{what} [{kind}] is not ported yet (ROADMAP Queue 1 item 11)")


class Upsample(nn.Module):
    def __init__(self, upsample_type: str, in_features: int,
                 conv_params: Dict, dtype=None):
        super().__init__()
        kind = upsample_type.strip().lower()
        if kind != "upsample_nearest_conv2d":
            raise _not_ported(kind, "upsample_type")
        self.conv = conv_block_from_params(
            in_features, conv_params, dtype=dtype, kernel_size=3,
            strides=(1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(nchw(upsample_2x_nearest(nhwc(x))))


class Downsample(nn.Module):
    def __init__(self, downsample_type: str, in_features: int,
                 conv_params: Dict, dtype=None):
        super().__init__()
        kind = downsample_type.strip().lower()
        if kind != "conv2d":
            raise _not_ported(kind, "downsample_type")
        self.conv = conv_block_from_params(
            in_features, conv_params, dtype=dtype, kernel_size=2,
            strides=(2, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)
