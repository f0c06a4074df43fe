"""Checkpoints of the whole train state, keep-N (counterpart of
``blind_image_denoising_tpu/training/checkpoint.py``, which uses Orbax).

The port writes its own ``torch.save`` files. A checkpoint
``ckpt_<step>.pt`` holds the model's state dict (params and batch
statistics), the optimizer's count and slots, ``step``, ``epoch`` and
``ema_params`` (None when the run had no EMA), all on the CPU. It is
written to a temporary file in the directory and renamed into place, so
a reader never sees half a checkpoint; a second save at the same step
is a no-op unless it asks to replace the first (the loop's save after a
prune). Under several processes the primary rank alone writes, and every
rank then waits at a barrier, so a rank that restores next reads what
was written; every rank restores from the same directory.

The manager also reads a JAX run's Orbax steps (``<step>/default/``,
``training/orbax.py``; ``tensorstore`` is imported only to read one), so
the port resumes, exports and fine-tunes from a JAX run as from its own.
The latest step is the highest of either kind; where both kinds hold
one step the port's file wins. The port's saves go beside a JAX run as
``ckpt_<step>.pt``, and ``max_to_keep`` prunes only those files: a JAX
step directory is never deleted or rewritten.
"""

import logging
import os
import re
import tempfile
from typing import List, Optional

import torch

from ..parallel import multihost
from .orbax import orbax_steps, read_orbax_checkpoint
from .train_state import TrainState

logger = logging.getLogger("blind_image_denoising_torch")

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _cpu(tensors):
    return {k: v.detach().cpu() for k, v in tensors.items()}


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1):
        self._directory = os.path.abspath(str(directory))
        os.makedirs(self._directory, exist_ok=True)
        self._keep = max(1, int(max_to_keep))
        self._interval = max(1, int(save_interval_steps))

    @property
    def directory(self) -> str:
        return self._directory

    def _path(self, step: int) -> str:
        return os.path.join(self._directory, f"ckpt_{step:010d}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self._directory)) if m)

    def latest_step(self) -> Optional[int]:
        """The highest step of the port's files and the JAX run's Orbax
        steps."""
        steps = self.all_steps() + orbax_steps(self._directory)
        return max(steps) if steps else None

    def save(self, state: TrainState, force: bool = False,
             replace: bool = False) -> bool:
        """Write the state at ``state.step``; False when a checkpoint of
        that step exists (unless ``replace``) or (without ``force``) the
        step is off the save interval, and on every rank but the primary.
        Keeps the newest ``max_to_keep``."""
        if multihost.process_count() == 1:
            return self._save(state, force, replace)
        wrote = (self._save(state, force, replace) if multihost.is_primary()
                 else False)
        multihost.sync("checkpoint")
        return wrote

    def _save(self, state: TrainState, force: bool, replace: bool) -> bool:
        step = int(state.step)
        if step in self.all_steps() and not replace:
            return False
        if not force and step % self._interval:
            return False
        payload = {
            "step": step, "epoch": int(state.epoch),
            "model": _cpu(state.model.state_dict()),
            "opt_state": {"count": int(state.opt_state.count),
                          "slots": {k: [t.detach().cpu() for t in v]
                                    for k, v in
                                    state.opt_state.slots.items()}},
            "ema_params": (None if state.ema_params is None
                           else _cpu(state.ema_params)),
        }
        fd, tmp = tempfile.mkstemp(dir=self._directory, prefix=".ckpt-",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save(payload, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(step))
        except BaseException:
            os.unlink(tmp)
            raise
        for old in self.all_steps()[:-self._keep]:
            os.unlink(self._path(old))
        logger.info(f"saved checkpoint at step {step} in {self._directory}")
        return True

    def read(self, step: int) -> dict:
        """The checkpoint at ``step`` as saved: a dict of CPU tensors and
        counters (``model``, ``opt_state``, ``step``, ``epoch``,
        ``ema_params``). A step that only a JAX run holds is read from
        its Orbax directory, with the optimizer's slots keyed by
        parameter name (``training/orbax.checkpoint_from_orbax``)."""
        if step in self.all_steps():
            if step in orbax_steps(self._directory):
                logger.info(f"step {step} is both a port checkpoint and a "
                            f"JAX Orbax step; reading the port's file")
            return torch.load(self._path(step), map_location="cpu",
                              weights_only=True)
        if step not in orbax_steps(self._directory):
            raise FileNotFoundError(
                f"no checkpoint of step {step} in {self._directory}")
        logger.info(f"reading JAX Orbax step {step} of {self._directory}")
        return read_orbax_checkpoint(self._directory, step)

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Load the checkpoint at ``step`` (default: the latest, of either
        kind) into ``state`` in place and return it; without one, return
        ``state`` as it is. ``ema_params`` takes the checkpoint's layout
        in either direction: a checkpoint without an EMA leaves None (the
        loop seeds it when it wants one), one with an EMA restores it
        even into a state that had none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            logger.info("no checkpoint found; starting from scratch")
            return state
        apply_checkpoint(state, self.read(step))
        logger.info(f"restored checkpoint step {step} from {self._directory}")
        return state

    def wait(self):
        """Saves are synchronous; nothing to wait for."""

    def close(self):
        """No resources are held between calls."""


def apply_checkpoint(state: TrainState, ckpt: dict) -> TrainState:
    """Load a checkpoint payload (:meth:`CheckpointManager.read`) into
    ``state`` in place and return it. The optimizer's slots are lists
    aligned with the model's parameters (the port's files) or dicts keyed
    by parameter name (a JAX run's)."""
    state.model.load_state_dict(ckpt["model"], strict=True)
    opt = ckpt["opt_state"]
    if set(opt["slots"]) != set(state.opt_state.slots):
        raise ValueError(
            f"checkpoint optimizer slots {sorted(opt['slots'])} do not "
            f"match this optimizer's {sorted(state.opt_state.slots)}")
    names = [n for n, _ in state.model.named_parameters()]
    with torch.no_grad():
        for name, saved in opt["slots"].items():
            if isinstance(saved, dict):
                if set(saved) != set(names):
                    raise ValueError(f"checkpoint optimizer slot [{name}] "
                                     f"does not name the model's params")
                saved = [saved[n] for n in names]
            for dst, src in zip(state.opt_state.slots[name], saved):
                dst.copy_(src)
    state.opt_state.count = int(opt["count"])
    state.step, state.epoch = int(ckpt["step"]), int(ckpt["epoch"])
    if (ckpt["ema_params"] is None) != (state.ema_params is None):
        logger.info("checkpoint ema_params presence differs from the "
                    "state; restored the checkpoint's layout")
    ema = ckpt["ema_params"]
    if ema is not None and set(ema) != set(names):
        raise ValueError("checkpoint ema_params do not name the model's "
                         "params")
    # in the order of the model's params, which the train step zips with
    device = next(state.model.parameters()).device
    state.ema_params = None if ema is None else {
        n: ema[n].to(device) for n in names}
    return state
