"""2× up/down sampling (counterpart of
``blind_image_denoising_tpu/layers/sampling.py``), on NCHW tensors.

``Upsample`` types: ``conv2d_transpose`` (a stride-2 transposed conv with
the conv params' kernel), ``upsample_bilinear_conv2d`` and
``upsample_nearest_conv2d`` (2× resize, then a 3×3 conv),
``upsample_laplacian_conv2d`` (a 1×1 conv and a bilinear 2× resize:
with a linear activation the conv runs first, on the coarse map, which
commutes with the resize; otherwise the resize runs first, as JAX
orders them), and ``nn`` / ``nearest`` / ``bilinear`` (the resize
alone). ``Downsample`` types: ``conv2d`` (a 2×2 stride-2 conv),
``maxpool`` (SAME 2×2 max pool) and ``strides`` (the even rows and
columns), the last two followed by a 1×1 conv when conv params are
given. An unknown type raises ``ValueError``, as in JAX. The convs are
``conv`` submodules, as in the flax tree."""

from typing import Dict, Optional

import torch
from torch import nn

from ..ops.resize import (downsample_2x_stride, max_pool_same, nchw, nhwc,
                          upsample_2x_bilinear, upsample_2x_nearest)
from .conv import conv_block_from_params


def _resize(fn, x: torch.Tensor) -> torch.Tensor:
    return nchw(fn(nhwc(x))).contiguous(memory_format=torch.channels_last)


class Upsample(nn.Module):
    def __init__(self, upsample_type: str, in_features: int,
                 conv_params: Optional[Dict] = None, dtype=None):
        super().__init__()
        kind = upsample_type.strip().lower()
        self.kind = kind
        self.conv = None
        self.conv_first = False
        if kind == "conv2d_transpose":
            over = dict(transpose=True, strides=(2, 2))
        elif kind in ("upsample_bilinear_conv2d", "upsample_nearest_conv2d"):
            over = dict(kernel_size=3, strides=(1, 1))
        elif kind == "upsample_laplacian_conv2d":
            over = dict(kernel_size=1, strides=(1, 1))
            self.conv_first = (conv_params or {}).get(
                "activation", "linear") == "linear"
        elif kind in ("nn", "nearest", "bilinear"):
            return
        else:
            raise ValueError(f"unknown upsample_type [{upsample_type}]")
        self.conv = conv_block_from_params(in_features, conv_params,
                                           dtype=dtype, **over)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator = None) -> torch.Tensor:
        kind = self.kind
        if kind == "conv2d_transpose":
            return self.conv(x, train=train, generator=generator)
        resize = (upsample_2x_nearest
                  if kind in ("nn", "nearest", "upsample_nearest_conv2d")
                  else upsample_2x_bilinear)
        if self.conv is None:
            return _resize(resize, x)
        if self.conv_first:
            return _resize(resize, self.conv(x, train=train,
                                             generator=generator))
        return self.conv(_resize(resize, x), train=train, generator=generator)


class Downsample(nn.Module):
    def __init__(self, downsample_type: str, in_features: int,
                 conv_params: Optional[Dict] = None, dtype=None):
        super().__init__()
        kind = downsample_type.strip().lower()
        self.kind = kind
        if kind == "conv2d":
            over = dict(kernel_size=2, strides=(2, 2))
        elif kind in ("maxpool", "strides"):
            over = dict(kernel_size=1, strides=(1, 1))
        else:
            raise ValueError(f"unknown downsample_type [{downsample_type}]")
        self.conv = (None if conv_params is None and kind != "conv2d"
                     else conv_block_from_params(in_features, conv_params,
                                                 dtype=dtype, **over))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator = None) -> torch.Tensor:
        if self.kind == "maxpool":
            x = _resize(lambda v: max_pool_same(v, (2, 2), (2, 2)), x)
        elif self.kind == "strides":
            x = _resize(downsample_2x_stride, x)
        if self.conv is None:
            return x
        return self.conv(x, train=train, generator=generator)
