"""Learning-rate schedules, gradient clipping and Adam (counterpart of
``blind_image_denoising_tpu/training/optimizer.py``), written to match
the optax chain the JAX package builds, not ``torch.optim``:

* the schedule is evaluated at the number of updates already applied
  (optax's ``scale_by_schedule`` count), on the host in float32;
* clipping runs in the chain's order — per tensor
  (``clip_by_per_tensor_norm``, TF ``clipnorm``), then by the global
  norm;
* Adam is optax's ``scale_by_adam``: bias-corrected moments and
  ``m̂ / (√v̂ + eps)`` with ``eps`` defaulting to 1e-7 (the Keras
  default the configs assume), not ``torch.optim.Adam``'s 1e-8.

The optimizer works on a list of tensors and updates them in place with
``torch._foreach_*`` operations; nothing in a step reads a value back to
the host.
"""

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

Schedule = Callable[[int], float]

_F32 = np.float32


def _cosine_decay_restarts(learning_rate: float, first_decay_steps: int,
                           t_mul: float = 2.0, m_mul: float = 0.9,
                           alpha: float = 0.001) -> Schedule:
    """SGDR with geometrically growing periods — the closed form of
    ``tf.keras.optimizers.schedules.CosineDecayRestarts``."""
    first = _F32(first_decay_steps)

    def schedule(step: int) -> float:
        completed = _F32(step) / first
        if t_mul == 1.0:
            i_restart = np.floor(completed)
            fraction = completed - i_restart
        else:
            i_restart = np.floor(
                np.log(np.maximum(_F32(1.0) - completed * _F32(1.0 - t_mul),
                                  _F32(1e-12))) / _F32(math.log(t_mul)))
            sum_r = (_F32(1.0) - _F32(t_mul) ** i_restart) / _F32(1.0 - t_mul)
            fraction = (completed - sum_r) / (_F32(t_mul) ** i_restart)
        m_fac = _F32(m_mul) ** i_restart
        cosine = _F32(0.5) * m_fac * (_F32(1.0) + np.cos(_F32(np.pi) * fraction))
        return float(_F32(learning_rate) * ((_F32(1.0 - alpha)) * cosine
                                            + _F32(alpha)))

    return schedule


def schedule_builder(config: Dict) -> Schedule:
    """``train.optimizer.schedule`` → ``step -> learning rate``."""
    schedule_type = (config.get("type") or "").strip().lower()
    params = config.get("config", {})
    if not schedule_type:
        raise ValueError("schedule type cannot be empty")
    if schedule_type == "exponential_decay":
        lr, rate = params["learning_rate"], params["decay_rate"]
        steps = params["decay_steps"]
        return lambda step: float(_F32(lr) * _F32(rate) ** (_F32(step)
                                                           / _F32(steps)))
    if schedule_type == "cosine_decay_restarts":
        return _cosine_decay_restarts(
            learning_rate=params["learning_rate"],
            first_decay_steps=params["decay_steps"],
            t_mul=params.get("t_mul", 2.0), m_mul=params.get("m_mul", 0.9),
            alpha=params.get("alpha", 0.001))
    if schedule_type == "cosine_decay":
        lr, steps = params["learning_rate"], params["decay_steps"]
        alpha = params.get("alpha", 0.0001)

        def cosine(step: int) -> float:
            frac = _F32(min(step, steps)) / _F32(steps)
            decay = _F32(0.5) * (_F32(1.0) + np.cos(_F32(np.pi) * frac))
            return float(_F32(lr) * ((_F32(1.0 - alpha)) * decay
                                     + _F32(alpha)))
        return cosine
    raise ValueError(f"unknown LR schedule type [{schedule_type}]")


def clip_by_per_tensor_norm(grads: List[torch.Tensor],
                            max_norm: float) -> None:
    """Scale each tensor in place to an L2 norm of at most ``max_norm``
    (``g · min(1, max_norm / max(‖g‖, 1e-12))``)."""
    norms = torch.stack(torch._foreach_norm(grads))
    scale = torch.clamp(max_norm / torch.clamp(norms, min=1e-12), max=1.0)
    torch._foreach_mul_(grads, list(scale.unbind()))


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)


@dataclass
class AdamState:
    count: int = 0                      # updates applied
    mu: List[torch.Tensor] = field(default_factory=list)
    nu: List[torch.Tensor] = field(default_factory=list)


class Adam:
    """Clipping chain + Adam with a learning-rate schedule, in place."""

    def __init__(self, schedule: Schedule, clips: List[Callable] = (),
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-7):
        self.schedule, self.clips = schedule, list(clips)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)

    def init(self, params: List[torch.Tensor]) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def apply(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              state: AdamState) -> None:
        """Clip ``grads`` in place, update the moments and ``params``."""
        for clip in self.clips:
            clip(grads)
        lr = self.schedule(state.count)
        state.count += 1
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(state.nu, 1.0 - b2 ** state.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(state.mu, 1.0 - b1 ** state.count)
        torch._foreach_div_(step, denom)
        torch._foreach_add_(params, step, alpha=-lr)


def optimizer_builder(config: Dict) -> Tuple[Adam, Schedule]:
    """``train.optimizer`` config → (optimizer, learning-rate schedule)."""
    lr_schedule = schedule_builder(config["schedule"])
    clips = []
    if config.get("gradient_clipping_by_value", None) is not None:
        raise NotImplementedError(
            "gradient_clipping_by_value is not ported yet (ROADMAP Queue 1 "
            "item 8)")
    clip_local = config.get("gradient_clipping_by_norm_local", None)
    clip_global = config.get("gradient_clipping_by_norm", None)
    if clip_local is not None:
        clips.append(lambda g, v=float(clip_local):
                     clip_by_per_tensor_norm(g, v))
    if clip_global is not None:
        clips.append(lambda g, v=float(clip_global):
                     clip_by_global_norm(g, v))
    optimizer_type = config.get("type", "RMSprop").strip().upper()
    if optimizer_type != "ADAM" or config.get("amsgrad", False):
        raise NotImplementedError(
            f"optimizer [{optimizer_type}"
            f"{', amsgrad' if config.get('amsgrad', False) else ''}] is not "
            f"ported yet (ROADMAP Queue 1 item 8); only ADAM is")
    return Adam(lr_schedule, clips, b1=config.get("beta_1", 0.9),
                b2=config.get("beta_2", 0.999),
                eps=config.get("epsilon", 1e-07)), lr_schedule
