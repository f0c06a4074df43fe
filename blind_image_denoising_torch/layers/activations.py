"""String-dispatched activations (counterpart of
``blind_image_denoising_tpu/layers/activations.py``).

The names and slopes follow the JAX table exactly: ``"leaky_relu"`` is
slope **0.3** (Keras' default), ``"leaky_relu_01"`` is 0.1 and
``"leaky_relu_001"`` 0.01; ``"gelu"`` is the tanh approximation, which
is ``jax.nn.gelu``'s default. The parametric ``prelu`` lives in the
:class:`Activation` module, which holds its slopes.
"""

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Keras hard_sigmoid: 0 below -2.5, 1 above 2.5, linear in
    between."""
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def _leaky(slope: float) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda x: F.leaky_relu(x, slope)


_ACTIVATIONS = {
    "linear": lambda x: x,
    "relu": F.relu,
    "relu6": F.relu6,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "elu": F.elu,
    "selu": F.selu,
    "silu": F.silu,
    "swish": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "hard_sigmoid": hard_sigmoid,
    "softplus": F.softplus,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
    "leakyrelu": _leaky(0.3),
    "leaky_relu": _leaky(0.3),
    "leakyrelu_01": _leaky(0.1),
    "leaky_relu_01": _leaky(0.1),
    "leakyrelu_001": _leaky(0.01),
    "leaky_relu_001": _leaky(0.01),
}


def activation_fn(name) -> Callable[[torch.Tensor], torch.Tensor]:
    """Resolve an activation name to a function. Raises on unknown names
    and on ``prelu``, which has parameters (:class:`Activation`)."""
    if name is None:
        return _ACTIVATIONS["linear"]
    if callable(name):
        return name
    key = name.strip().lower()
    if key in _ACTIVATIONS:
        return _ACTIVATIONS[key]
    if key == "prelu":
        raise ValueError("prelu has parameters: use the Activation module")
    raise ValueError(f"unknown activation [{name}]")


class Activation(nn.Module):
    """An activation as a module (flax ``Activation``). ``prelu``: a
    per-channel slope ``prelu_alpha`` [C] (channels on dim 1 of NCHW, or
    the last dim of a 2-D input), initialized at 0.1 and clipped to
    [0, 1] where it is used, cast to the input's dtype; ``x ≥ 0 ? x :
    α·x``. Every other name is the parameter-free function of
    :func:`activation_fn`."""

    def __init__(self, activation: str = "linear",
                 features: int = 0):
        super().__init__()
        self.key = (activation or "linear").strip().lower()
        if self.key == "prelu":
            self.prelu_alpha = nn.Parameter(torch.full((int(features),), 0.1))
            self.fn = None
        else:
            self.fn = activation_fn(self.key)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fn is not None:
            return self.fn(x)
        alpha = torch.clamp(self.prelu_alpha, 0.0, 1.0).to(x.dtype)
        alpha = alpha.view(1, -1, 1, 1) if x.ndim == 4 else alpha
        return torch.where(x >= 0.0, x, alpha * x)
