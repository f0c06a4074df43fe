"""Deep-supervision weight schedules, learning-rate schedules, gradient
clipping and the update rules (counterpart of
``blind_image_denoising_tpu/training/optimizer.py``), written to match
the optax chain the JAX package builds, not ``torch.optim``:

* the schedule is evaluated at the number of updates already applied
  (optax's ``scale_by_schedule`` count), on the host in float32;
* clipping runs in the chain's order — by value (``optax.clip``), per
  tensor (``clip_by_per_tensor_norm``, TF ``clipnorm``), then by the
  global norm;
* Adam is optax's ``scale_by_adam``: bias-corrected moments and
  ``m̂ / (√v̂ + eps)`` with ``eps`` defaulting to 1e-7 (the Keras
  default the configs assume), not ``torch.optim.Adam``'s 1e-8; amsgrad,
  RMSprop (``eps`` inside the root, optionally centered, momentum as
  ``optax.trace`` after the learning rate) and Adadelta are optax's too.

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


def deep_supervision_schedule_builder(
        config: Dict, no_outputs: int) -> Callable[[float], np.ndarray]:
    """Per-output loss weights as a function of the share of training done,
    in [0, 1]. Index 0 is the full-resolution output; "low_to_high" starts
    on the small scales (high indices) and moves to full resolution.
    Types: constant_equal, constant_low_to_high, constant_high_to_low,
    linear_low_to_high, non_linear_low_to_high (a tanh(2.5·p) ramp)."""
    if no_outputs <= 0:
        raise ValueError("no_outputs must be a positive integer")
    schedule_type = (config.get("type") or "").strip().lower()
    if not schedule_type:
        raise ValueError("schedule type cannot be empty")
    ramp = np.arange(1, no_outputs + 1, dtype=np.float32)
    ramp = ramp / ramp.sum()
    favor_small, favor_full = ramp, ramp[::-1].copy()
    if schedule_type == "constant_equal":
        w = np.full((no_outputs,), 1.0 / no_outputs, np.float32)
        return lambda percentage_done=0.0: w
    if schedule_type == "constant_low_to_high":
        return lambda percentage_done=0.0: favor_small
    if schedule_type == "constant_high_to_low":
        return lambda percentage_done=0.0: favor_full
    if schedule_type == "linear_low_to_high":
        return lambda percentage_done=0.0: (
            favor_small * (1.0 - percentage_done)
            + favor_full * percentage_done)
    if schedule_type == "non_linear_low_to_high":
        def schedule(percentage_done: float = 0.0):
            t = float(np.clip(np.tanh(2.5 * percentage_done), 0.0, 1.0))
            return favor_small * (1.0 - t) + favor_full * t
        return schedule
    raise ValueError(
        f"unknown deep supervision schedule type [{schedule_type}]")


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


def clip_by_value(grads: List[torch.Tensor], max_delta: float) -> None:
    """Clamp every element to [−max_delta, max_delta] (``optax.clip``)."""
    torch._foreach_clamp_min_(grads, -max_delta)
    torch._foreach_clamp_max_(grads, max_delta)


@dataclass
class OptState:
    count: int = 0                      # updates applied
    # the update rule's state, one list of tensors per slot (adam: mu,
    # nu; amsgrad: + nu_max; rmsprop: nu, + mu when centered, + trace
    # with momentum; adadelta: e_g, e_x), aligned with the params
    slots: Dict[str, List[torch.Tensor]] = field(default_factory=dict)


class Optimizer:
    """Clipping chain + an optax update rule with a learning-rate schedule,
    applied in place. ``rule``: "adam" (``optax.adam``), "amsgrad",
    "rmsprop" (``centered``, ``momentum``) or "adadelta"; the schedule is
    evaluated at the number of updates already applied."""

    def __init__(self, rule: str, schedule: Schedule,
                 clips: List[Callable] = (), **hyper):
        self.rule, self.schedule, self.clips = rule, schedule, list(clips)
        self.hyper = {k: (float(v) if isinstance(v, (int, float))
                          and not isinstance(v, bool) else v)
                      for k, v in hyper.items()}

    def slot_names(self) -> List[str]:
        h = self.hyper
        return {"adam": ["mu", "nu"], "amsgrad": ["mu", "nu", "nu_max"],
                "adadelta": ["e_g", "e_x"],
                "rmsprop": ["nu"] + (["mu"] if h.get("centered") else [])
                + (["trace"] if h.get("momentum") else [])}[self.rule]

    def init(self, params: List[torch.Tensor]) -> OptState:
        return OptState(0, {name: [torch.zeros_like(p) for p in params]
                            for name in self.slot_names()})

    @torch.no_grad()
    def apply(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              state: OptState) -> None:
        """Clip ``grads`` in place, update the state and ``params``."""
        for clip in self.clips:
            clip(grads)
        lr = self.schedule(state.count)
        state.count += 1
        getattr(self, f"_{self.rule}")(params, grads, state.slots, lr,
                                       state.count, **self.hyper)

    @staticmethod
    def _moments(slots, grads, b1, b2):
        torch._foreach_mul_(slots["mu"], b1)
        torch._foreach_add_(slots["mu"], grads, alpha=1.0 - b1)
        torch._foreach_mul_(slots["nu"], b2)
        torch._foreach_addcmul_(slots["nu"], grads, grads, value=1.0 - b2)

    def _adam(self, params, grads, slots, lr, count, b1, b2, eps):
        self._moments(slots, grads, b1, b2)
        denom = torch._foreach_div(slots["nu"], 1.0 - b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        step = torch._foreach_div(slots["mu"], 1.0 - b1 ** count)
        torch._foreach_div_(step, denom)
        torch._foreach_add_(params, step, alpha=-lr)

    def _amsgrad(self, params, grads, slots, lr, count, b1, b2, eps):
        self._moments(slots, grads, b1, b2)
        nu_hat = torch._foreach_div(slots["nu"], 1.0 - b2 ** count)
        torch._foreach_maximum_(slots["nu_max"], nu_hat)
        denom = torch._foreach_sqrt(slots["nu_max"])
        torch._foreach_add_(denom, eps)
        step = torch._foreach_div(slots["mu"], 1.0 - b1 ** count)
        torch._foreach_div_(step, denom)
        torch._foreach_add_(params, step, alpha=-lr)

    def _rmsprop(self, params, grads, slots, lr, count, decay, eps,
                 centered, momentum):
        torch._foreach_mul_(slots["nu"], decay)
        torch._foreach_addcmul_(slots["nu"], grads, grads, value=1.0 - decay)
        if centered:
            torch._foreach_mul_(slots["mu"], decay)
            torch._foreach_add_(slots["mu"], grads, alpha=1.0 - decay)
            denom = torch._foreach_addcmul(slots["nu"], slots["mu"],
                                           slots["mu"], value=-1.0)
            torch._foreach_add_(denom, eps)
        else:
            denom = torch._foreach_add(slots["nu"], eps)
        torch._foreach_rsqrt_(denom)
        step = torch._foreach_mul(grads, denom)
        torch._foreach_mul_(step, -lr)
        if momentum:
            torch._foreach_mul_(slots["trace"], momentum)
            torch._foreach_add_(slots["trace"], step)
            step = slots["trace"]
        torch._foreach_add_(params, step)

    def _adadelta(self, params, grads, slots, lr, count, rho, eps):
        torch._foreach_mul_(slots["e_g"], rho)
        torch._foreach_addcmul_(slots["e_g"], grads, grads, value=1.0 - rho)
        num = torch._foreach_add(slots["e_x"], eps)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(slots["e_g"], eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(num, den)
        step = torch._foreach_mul(num, grads)
        torch._foreach_mul_(slots["e_x"], rho)
        torch._foreach_addcmul_(slots["e_x"], step, step, value=1.0 - rho)
        torch._foreach_add_(params, step, alpha=-lr)


def optimizer_builder(config: Dict) -> Tuple[Optimizer, Schedule]:
    """``train.optimizer`` config → (optimizer, learning-rate schedule):
    clipping by value, per tensor by norm, then by the global norm, then
    ADAM (``amsgrad``), RMSPROP or ADADELTA, with the JAX package's keys
    and defaults."""
    lr_schedule = schedule_builder(config["schedule"])
    clips = []
    clip_value = config.get("gradient_clipping_by_value", None)
    clip_local = config.get("gradient_clipping_by_norm_local", None)
    clip_global = config.get("gradient_clipping_by_norm", None)
    if clip_value is not None:
        clips.append(lambda g, v=float(clip_value): clip_by_value(g, v))
    if clip_local is not None:
        clips.append(lambda g, v=float(clip_local):
                     clip_by_per_tensor_norm(g, v))
    if clip_global is not None:
        clips.append(lambda g, v=float(clip_global):
                     clip_by_global_norm(g, v))
    optimizer_type = config.get("type", "RMSprop").strip().upper()
    eps = config.get("epsilon", 1e-07)
    if optimizer_type == "ADAM":
        rule = "amsgrad" if config.get("amsgrad", False) else "adam"
        tx = Optimizer(rule, lr_schedule, clips,
                       b1=config.get("beta_1", 0.9),
                       b2=config.get("beta_2", 0.999), eps=eps)
    elif optimizer_type == "RMSPROP":
        tx = Optimizer("rmsprop", lr_schedule, clips,
                       decay=config.get("rho", 0.9), eps=eps,
                       centered=bool(config.get("centered", False)),
                       momentum=float(config.get("momentum", 0.0) or 0.0))
    elif optimizer_type == "ADADELTA":
        tx = Optimizer("adadelta", lr_schedule, clips,
                       rho=config.get("rho", 0.9), eps=eps)
    else:
        raise ValueError(f"unknown optimizer type [{optimizer_type}]")
    return tx, lr_schedule
