"""String-dispatched activations (counterpart of
``blind_image_denoising_tpu/layers/activations.py``).

The names and slopes follow the JAX table exactly: ``"leaky_relu"`` is
slope **0.3** (Keras' default), ``"leaky_relu_01"`` is 0.1 and
``"leaky_relu_001"`` 0.01; ``"gelu"`` is the tanh approximation, which
is ``jax.nn.gelu``'s default.
"""

from typing import Callable

import torch
import torch.nn.functional as F


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
    "hard_sigmoid": lambda x: torch.clamp(0.2 * x + 0.5, 0.0, 1.0),
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
    """Resolve an activation name to a function. Raises on unknown names;
    the parametric ``prelu`` is not ported yet."""
    if name is None:
        return _ACTIVATIONS["linear"]
    if callable(name):
        return name
    key = name.strip().lower()
    if key in _ACTIVATIONS:
        return _ACTIVATIONS[key]
    if key == "prelu":
        raise NotImplementedError(
            "prelu is not ported yet (ROADMAP Queue 1 item 11)")
    raise ValueError(f"unknown activation [{name}]")
