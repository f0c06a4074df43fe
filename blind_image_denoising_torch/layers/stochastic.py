"""Stochastic depth (counterpart of
``blind_image_denoising_tpu/layers/stochastic.py`` ``StochasticDepth``
and ``RandomOnOff``, the same per-sample drop with its rate named
``rate``):
a per-sample Bernoulli mask broadcast over C, H and W, the kept samples
scaled by 1/(1 − rate) — Keras/flax Dropout with noise shape
(B, 1, 1, 1). The mask comes from the generator the caller passes,
through ``ops/noise.batch_rand``: under a data-parallel step each rank
keeps its rows of the global batch's mask."""

import torch
from torch import nn

from ..ops.noise import batch_rand


def drop_mask(shape, rate: float, generator: torch.Generator,
              device) -> torch.Tensor:
    """Boolean keep mask: True with probability 1 − rate."""
    if generator is None:
        raise ValueError("a training-mode random mask needs an explicit "
                         "torch.Generator")
    return batch_rand(tuple(shape), generator, device) < 1.0 - rate


class StochasticDepth(nn.Module):
    """Per-sample residual-branch drop; the identity unless training."""

    def __init__(self, drop_path_rate: float = 0.5):
        super().__init__()
        if not 0.0 <= drop_path_rate <= 1.0:
            raise ValueError("drop_path_rate must be within [0, 1]")
        self.rate = float(drop_path_rate)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator = None) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = drop_mask((x.shape[0],) + (1,) * (x.ndim - 1), self.rate,
                         generator, x.device)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class RandomOnOff(StochasticDepth):
    """Drops the whole tensor per sample with probability ``rate``."""

    def __init__(self, rate: float = 0.5):
        super().__init__(rate)
