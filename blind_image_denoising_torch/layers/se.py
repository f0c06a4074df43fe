"""Squeeze-and-Excitation (counterpart of
``blind_image_denoising_tpu/layers/se.py`` ``SqueezeExcite``), on NCHW
tensors: the spatial mean → 1×1 ``squeeze`` to ``round(C·r_ratio)``
channels → leaky ReLU (0.1) → 1×1 ``excite`` back to C → a sigmoid gate
(or the hard sigmoid, of ``2.5 − relu(y)`` with ``learn_to_turn_off`` so
the channels start on) → an optional per-channel ``gamma`` → times the
input. The two 1×1s carry the soft-orthonormal regularizer when asked,
else ``kernel_regularizer``."""

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.regularizers import soft_ortho_spec
from .activations import hard_sigmoid
from .conv import ConvBlock
from .multipliers import ChannelLearnableMultiplier


class SqueezeExcite(nn.Module):
    def __init__(self, features: int, r_ratio: float = 0.25,
                 use_bias: bool = True, hard_sigmoid_version: bool = False,
                 learn_to_turn_off: bool = False,
                 use_soft_orthonormal_regularization: bool = False,
                 kernel_regularizer="l2",
                 kernel_initializer="glorot_normal",
                 use_scale_gamma: bool = False, dtype=None):
        super().__init__()
        if r_ratio <= 0.0:
            raise ValueError("r_ratio should be > 0.0")
        squeezed = max(1, int(round(features * r_ratio)))
        reg = (soft_ortho_spec(True) if use_soft_orthonormal_regularization
               else kernel_regularizer)
        common = dict(kernel_size=1, use_bias=use_bias,
                      kernel_regularizer=reg,
                      kernel_initializer=kernel_initializer, dtype=dtype)
        self.squeeze = ConvBlock(features, squeezed, **common)
        self.excite = ConvBlock(squeezed, features, **common)
        self.hard_sigmoid_version = bool(hard_sigmoid_version)
        self.learn_to_turn_off = bool(learn_to_turn_off)
        self.gamma = (ChannelLearnableMultiplier(features)
                      if use_scale_gamma else None)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = torch.mean(x, dim=(2, 3), keepdim=True)
        y = F.leaky_relu(self.squeeze(y, train=train), 0.1)
        y = self.excite(y, train=train)
        if self.hard_sigmoid_version:
            if self.learn_to_turn_off:
                y = 2.5 - torch.relu(y)
            y = hard_sigmoid(y)
        else:
            y = torch.sigmoid(y)
        if self.gamma is not None:
            y = self.gamma(y)
        return x * y
