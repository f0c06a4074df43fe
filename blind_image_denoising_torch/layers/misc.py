"""Layers of ``blind_image_denoising_tpu/layers/misc.py``, on NCHW
tensors: the fixed ``GaussianFilter``, ``ValueCompressor``, ``GatedMLP``
and ``SparseBlock``."""

from typing import Tuple

import torch
from torch import nn

from ..ops.gaussian import gaussian_blur
from ..ops.resize import nchw, nhwc
from .conv import ConvBlock
from .norm import BatchNorm


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


class ValueCompressor(nn.Module):
    """``tanh(α·x)·β`` squash."""

    def __init__(self, alpha: float = 4.0, beta: float = 0.5):
        super().__init__()
        self.alpha, self.beta = float(alpha), float(beta)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(x * self.alpha) * self.beta


class GatedMLP(nn.Module):
    """Gated 1×1-conv MLP: ``project(value(x) · gate(x))``, two parallel
    1×1 expansions to ``filters`` (``value`` with ``activation``,
    ``gate`` with ``gate_activation``) and a linear 1×1 back to the
    input's channels."""

    def __init__(self, in_features: int, filters: int,
                 use_bias: bool = False, activation: str = "linear",
                 gate_activation: str = "sigmoid", kernel_regularizer=None,
                 kernel_initializer="glorot_normal", dtype=None):
        super().__init__()
        common = dict(kernel_size=1, use_bias=use_bias,
                      kernel_regularizer=kernel_regularizer,
                      kernel_initializer=kernel_initializer, dtype=dtype)
        self.value = ConvBlock(in_features, filters, activation=activation,
                               **common)
        self.gate = ConvBlock(in_features, filters,
                              activation=gate_activation, **common)
        self.project = ConvBlock(filters, in_features, activation="linear",
                                 **common)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.project(self.value(x, train=train)
                            * self.gate(x, train=train), train=train)


class SparseBlock(nn.Module):
    """BatchNorm (scale, no bias; batch statistics in train mode, float32
    out as flax promotes it) then a mask of the values above
    ``threshold_sigma`` (of their magnitude when ``symmetrical``; a
    sigmoid ramp when ``soft_sparse``; inverted when ``reverse``) times
    the input."""

    def __init__(self, features: int, threshold_sigma: float = 1.0,
                 symmetrical: bool = False, reverse: bool = False,
                 soft_sparse: bool = False):
        super().__init__()
        if threshold_sigma < 0:
            raise ValueError("threshold_sigma must be >= 0")
        self.threshold_sigma = float(threshold_sigma)
        self.symmetrical, self.reverse = bool(symmetrical), bool(reverse)
        self.soft_sparse = bool(soft_sparse)
        self.bn = BatchNorm(features, use_bias=False)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x_bn = self.bn(x, train=train)
        if self.symmetrical:
            x_bn = torch.abs(x_bn)
        if self.soft_sparse:
            mask = torch.sigmoid(x_bn - self.threshold_sigma)
        else:
            mask = (x_bn > self.threshold_sigma).to(x.dtype)
        if self.reverse:
            mask = 1.0 - mask
        return x * mask
