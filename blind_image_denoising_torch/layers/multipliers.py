"""Learnable per-channel gain (counterpart of
``blind_image_denoising_tpu/layers/multipliers.py``
``ChannelLearnableMultiplier``)."""

import torch
from torch import nn

from ..ops.regularizers import l1


class ChannelLearnableMultiplier(nn.Module):
    """Per-channel scale ``tanh(relu(1 + w)) · x`` on NCHW tensors, with
    an L1 penalty of ``l1_coefficient`` on ``w``."""

    def __init__(self, features: int, l1_coefficient: float = 1e-6):
        super().__init__()
        self.w_multiplier = nn.Parameter(torch.zeros(features))
        self.l1_coefficient = float(l1_coefficient)

    def penalty(self) -> torch.Tensor:
        return l1(self.w_multiplier.float(), self.l1_coefficient)

    def gain(self) -> torch.Tensor:
        """The activated float32 gain, [C]."""
        return torch.tanh(torch.relu(1.0 + self.w_multiplier))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gain().to(x.dtype).view(1, -1, 1, 1)
