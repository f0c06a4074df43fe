"""Learnable gains (counterpart of
``blind_image_denoising_tpu/layers/multipliers.py``), on NCHW
tensors."""

import torch
from torch import nn

from ..ops.regularizers import l1
from .activations import activation_fn


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


class SmoothChannelLearnableMultiplier(ChannelLearnableMultiplier):
    """Per-channel scale ``sigmoid(2.5 + w) · x`` in (0, 1)."""

    def gain(self) -> torch.Tensor:
        return torch.sigmoid(2.5 + self.w_multiplier)


class GlobalLearnableMultiplier(ChannelLearnableMultiplier):
    """The scalar ``tanh(relu(1 + w)) · x`` (``w`` [1])."""

    def __init__(self, l1_coefficient: float = 1e-6):
        super().__init__(1, l1_coefficient)


class Multiplier(nn.Module):
    """Legacy learnable scalar gain ``act(w0 + multiplier) · x`` (``w0``
    [1], zero-initialised), L1 on ``w0`` when ``l1_coefficient`` > 0."""

    def __init__(self, multiplier: float = 1.0, activation: str = "linear",
                 l1_coefficient: float = 0.0, features: int = 1):
        super().__init__()
        self.w0 = nn.Parameter(torch.zeros(features))
        self.multiplier = float(multiplier)
        self.act = activation_fn(activation)
        self.l1_coefficient = float(l1_coefficient)

    def penalty(self):
        if self.l1_coefficient <= 0.0:
            return None
        return l1(self.w0.float(), self.l1_coefficient)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gain = self.act(self.w0 + self.multiplier).to(x.dtype)
        return x * gain.view(1, -1, 1, 1)


class ChannelwiseMultiplier(Multiplier):
    """Legacy per-channel gain ``act(w0 + multiplier) · x`` (``w0``
    [C])."""

    def __init__(self, features: int, multiplier: float = 1.0,
                 activation: str = "linear", l1_coefficient: float = 0.0):
        super().__init__(multiplier, activation, l1_coefficient, features)
