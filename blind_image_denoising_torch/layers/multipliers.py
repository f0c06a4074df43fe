"""Learnable per-channel gain (counterpart of
``blind_image_denoising_tpu/layers/multipliers.py``
``ChannelLearnableMultiplier``)."""

import torch
from torch import nn


class ChannelLearnableMultiplier(nn.Module):
    """Per-channel scale ``tanh(relu(1 + w)) · x`` on NCHW tensors."""

    def __init__(self, features: int):
        super().__init__()
        self.w_multiplier = nn.Parameter(torch.zeros(features))

    def gain(self) -> torch.Tensor:
        """The activated float32 gain, [C]."""
        return torch.tanh(torch.relu(1.0 + self.w_multiplier))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gain().to(x.dtype).view(1, -1, 1, 1)
