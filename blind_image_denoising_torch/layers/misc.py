"""Fixed layers (counterpart of ``blind_image_denoising_tpu/layers/misc.py``
``GaussianFilter``), on NCHW tensors."""

from typing import Tuple

import torch
from torch import nn

from ..ops.gaussian import gaussian_blur
from ..ops.resize import nchw, nhwc


class GaussianFilter(nn.Module):
    """Fixed (non-learnable) depthwise Gaussian blur: ``ops/gaussian.py``
    ``gaussian_blur`` with its default sigma, XLA SAME zero padding."""

    def __init__(self, kernel_size: Tuple[int, int] = (5, 5),
                 strides: Tuple[int, int] = (1, 1)):
        super().__init__()
        self.kernel_size = tuple(int(v) for v in kernel_size)
        self.strides = tuple(int(v) for v in strides)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = gaussian_blur(nhwc(x), kernel_size=self.kernel_size,
                          strides=self.strides)
        return nchw(y).contiguous(memory_format=torch.channels_last)
