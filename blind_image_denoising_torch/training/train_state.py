"""Training state (counterpart of
``blind_image_denoising_tpu/training/train_state.py``).

The state holds the model (whose parameters are the params and whose
buffers are the batch statistics), the optimizer state, the number of
applied steps and of finished epochs, the exponential moving average of
the params (``ema_params``, None when the EMA is off), and two
generators: one on the device for the train step's masks and flips, and
one on the host that draws the noise kernel's int32 seed per
micro-batch (the JAX step folds its noise key into an int32 the same
way).

:func:`create_train_state` loads params — a flat state dict such as
``weights.params_from_flax`` of a packaged artifact — or, without them,
initializes the model from the seed as the JAX modules do: every conv,
1×1 and dense kernel from its ``kernel_initializer``
(``layers/conv.resolve_initializer``: the module's own, else the
backbone config's, glorot-normal by default), the biases of relu convs
at 0.1, ones for the LayerNorm scales, ``0.01 · truncated normal`` for
the gains. The draws are the port's own, so a seeded init matches the
JAX one in its statistics, not its values.
"""

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from ..inference.export import resolve_device
from ..layers.conv import ConvBlock, DenseBlock, resolve_initializer
from ..layers.multipliers import ChannelLearnableMultiplier
from ..layers.norm import FastLayerNorm
from ..ops.noise import truncated_normal
from .optimizer import OptState, Optimizer

# the bias of a relu-family conv starts slightly positive
_RELU_BIAS = 0.1


@dataclass
class TrainState:
    model: nn.Module
    opt_state: OptState
    generator: torch.Generator           # on the model's device
    host_generator: torch.Generator      # on the CPU: noise-kernel seeds
    step: int = 0                        # applied optimizer steps
    epoch: int = 0
    # name -> tensor like ``params``, on the model's device
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def param_count(state: TrainState) -> int:
    return sum(p.numel() for p in state.model.parameters())


def _fans(kernel: torch.Tensor):
    """(fan_in, fan_out) of an OIHW kernel or an [out, in] matrix."""
    receptive = math.prod(kernel.shape[2:]) if kernel.ndim == 4 else 1
    return kernel.shape[1] * receptive, kernel.shape[0] * receptive


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialization of every parameter of the hydra, in place."""
    default = getattr(getattr(model, "backbone", model),
                      "kernel_initializer", "glorot_normal")
    resolve_initializer(default)            # an unknown name raises here
    for module in model.modules():
        init = resolve_initializer(
            getattr(module, "kernel_initializer", None) or default)
        if isinstance(module, FastLayerNorm):
            module.scale.fill_(1.0)
        elif isinstance(module, ChannelLearnableMultiplier):
            w = module.w_multiplier
            w.copy_(0.01 * truncated_normal(w.shape, generator))
        elif isinstance(module, DenseBlock):
            k = module.kernel                      # [in, out]
            k.copy_(init(k.shape, k.shape[0], k.shape[1], generator))
        else:
            # a conv's kernel, or a separable conv's two
            for name in ("kernel", "depthwise_kernel", "pointwise_kernel"):
                k = getattr(module, name, None)
                if isinstance(k, nn.Parameter):
                    k.copy_(init(k.shape, *_fans(k), generator))
            if (isinstance(module, ConvBlock) and module.bias is not None
                    and module.activation in ("relu", "relu6")):
                module.bias.fill_(_RELU_BIAS)


def create_train_state(model: nn.Module, tx: Optimizer, seed: int = 0,
                       params: Optional[Dict[str, torch.Tensor]] = None,
                       device=None) -> TrainState:
    """Move ``model`` to ``device`` (default: the card; ``"cpu"`` must be
    asked for), load ``params`` or initialize from ``seed``, and create
    the optimizer state and the generators (no EMA: the caller seeds
    ``ema_params``)."""
    dev = resolve_device(device)
    if params is not None:
        model.load_state_dict(params, strict=True)
    else:
        init_params(model, torch.Generator().manual_seed(int(seed)))
    model.to(dev)
    model.requires_grad_(True)
    return TrainState(
        model=model,
        opt_state=tx.init(list(model.parameters())),
        generator=torch.Generator(device=dev).manual_seed(int(seed)),
        host_generator=torch.Generator().manual_seed(int(seed) + 1))
