"""Reading the JAX package's Orbax checkpoints (counterpart of the reading
half of ``blind_image_denoising_tpu/training/checkpoint.py``, which
restores through ``orbax.checkpoint``).

A JAX run saves its whole ``TrainState`` with Orbax's ``StandardSave``:
step ``N`` is the directory ``<run>/N/default/``, which holds
``_METADATA`` (JSON: every leaf of the tree by its key path) and an
OCDBT key-value store of zarr arrays, one array per leaf under its key
path joined by ``.`` (``params.backbone.stem_conv.kernel``,
``opt_state.1.0.mu.backbone...``). Its B-tree nodes and chunks are
zstd-compressed, so the arrays are read through ``tensorstore``'s
``ocdbt`` and ``zarr`` drivers, the library Orbax itself writes with;
neither ``jax`` nor ``orbax`` is imported. ``tensorstore`` is imported
on this path only, and a missing one raises ``ImportError``.

:func:`read_orbax_step` rebuilds the nested tree of numpy arrays (a
leaf saved as ``None``, such as ``ema_params`` without an EMA or an
optax ``EmptyState``, stays ``None``; an empty dict stays ``{}``).
:func:`checkpoint_from_orbax` turns it into the port's checkpoint
payload (``training/checkpoint.py``): the params and ``batch_stats``
through ``weights.params_from_flax``, the EMA, the step and the epoch,
and the optax chain's state as the port's optimizer count and slots.
:func:`train_state_from_orbax` loads it into a ``TrainState``.
"""

import json
import os
from typing import Dict, List, Tuple

import numpy as np

from ..weights import params_from_flax

ITEM = "default"
METADATA_FILE = "_METADATA"
# the optax states' slot fields, named as the port's Optimizer names its
# slots (training/optimizer.py): ScaleByAdamState / ScaleByAmsgradState
# (mu, nu, nu_max), ScaleByRmsState / ScaleByRStdDevState (nu, mu),
# TraceState (trace), ScaleByAdaDeltaState (e_g, e_x)
SLOT_FIELDS = ("mu", "nu", "nu_max", "trace", "e_g", "e_x")


def _step_directory(directory, step: int) -> str:
    return os.path.join(str(directory), str(int(step)), ITEM)


def orbax_steps(directory) -> List[int]:
    """The steps of a JAX run: the integer subdirectories of
    ``directory`` that hold ``default/_METADATA`` (Orbax's unfinished
    saves carry a suffix and are not integers)."""
    if not os.path.isdir(str(directory)):
        return []
    return sorted(int(name) for name in os.listdir(str(directory))
                  if name.isdigit() and os.path.isfile(os.path.join(
                      _step_directory(directory, int(name)), METADATA_FILE)))


def _import_tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "reading a JAX Orbax checkpoint needs the 'tensorstore' "
            "package (the OCDBT / zarr format Orbax writes)") from e
    return tensorstore


def _set(tree: dict, keys: List[str], value) -> None:
    for key in keys[:-1]:
        tree = tree.setdefault(key, {})
    tree[keys[-1]] = value


def read_orbax_step(directory, step: int) -> Tuple[dict, bool]:
    """(tree, has_ema): the step's saved tree as nested dicts of numpy
    arrays — every key a string, a sequence index too, as Orbax names
    them — and whether it carries ``ema_params``."""
    ts = _import_tensorstore()
    root = os.path.abspath(_step_directory(directory, step))
    with open(os.path.join(root, METADATA_FILE)) as f:
        meta = json.load(f)
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    context = ts.Context()
    base = "file://" + root
    tree: dict = {}
    pending = []
    for entry in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        value = entry["value_metadata"]
        kind = value["value_type"]
        if value.get("skip_deserialize"):
            # None (an EmptyState, a missing EMA) or an empty container
            _set(tree, keys, {"None": None, "Dict": {}, "List": [],
                              "Tuple": ()}.get(kind))
            continue
        pending.append((keys, ts.open({
            "driver": driver,
            "kvstore": {"driver": "ocdbt", "base": base,
                        "path": ".".join(keys)}}, context=context,
            open=True, read=True)))
    reads = [(keys, fut.result().read()) for keys, fut in pending]
    for keys, fut in reads:
        _set(tree, keys, np.asarray(fut.result()))
    has_ema = tree.get("ema_params") is not None
    return tree, has_ema


def _slots_and_counts(node, slots: Dict[str, dict], counts: List[int]):
    """Walk an optax state tree: the slot fields' subtrees (each mirrors
    the params) and every ``count`` leaf."""
    if not isinstance(node, dict):
        return
    for key, val in node.items():
        if key in SLOT_FIELDS and isinstance(val, dict):
            if key in slots:
                raise ValueError(f"optimizer state holds slot [{key}] "
                                 f"twice")
            slots[key] = val
        elif key == "count" and isinstance(val, np.ndarray):
            counts.append(int(val))
        else:
            _slots_and_counts(val, slots, counts)


def checkpoint_from_orbax(tree: dict) -> dict:
    """The port's checkpoint payload of a JAX ``TrainState`` tree: the
    model's state dict (params + batch statistics), ``ema_params`` (a
    name → tensor dict, or None), ``step``, ``epoch`` and ``opt_state``
    = {``count``, ``slots``: slot → {param name → tensor}}. The optax
    chain's states map by their field names (``SLOT_FIELDS``); its
    ``count`` leaves (the rule's and the schedule's) must agree, and a
    chain with none (a constant rate without Adam) counts ``step``."""
    variables = {"params": tree["params"]}
    if tree.get("batch_stats"):
        variables["batch_stats"] = tree["batch_stats"]
    step, epoch = int(tree["step"]), int(tree["epoch"])
    slots: Dict[str, dict] = {}
    counts: List[int] = []
    _slots_and_counts(tree.get("opt_state"), slots, counts)
    if len(set(counts)) > 1:
        raise ValueError(f"optimizer state counts disagree: {counts}")
    ema = tree.get("ema_params")
    return {
        "step": step, "epoch": epoch,
        "model": params_from_flax(variables),
        "opt_state": {"count": counts[0] if counts else step,
                      "slots": {name: params_from_flax({"params": sub})
                                for name, sub in slots.items()}},
        "ema_params": None if ema is None else params_from_flax(
            {"params": ema}),
    }


def train_state_from_orbax(tree: dict, state):
    """Load a JAX ``TrainState`` tree (:func:`read_orbax_step`) into the
    port's ``state`` in place and return it: params and batch statistics,
    the optimizer's count and slots (for every rule the port's
    ``Optimizer`` runs: adam, amsgrad, rmsprop centered or with momentum,
    adadelta; the clipping transforms' states are empty), the step, the
    epoch, and ``ema_params`` as the checkpoint has it (present or
    absent, whatever ``state`` had). JAX's state carries no generators:
    ``generator`` and ``host_generator`` are seeded with ``step + 1``, as
    the port's loop seeds them when it resumes at that step."""
    from .checkpoint import apply_checkpoint
    state = apply_checkpoint(state, checkpoint_from_orbax(tree))
    state.generator.manual_seed(state.step + 1)
    state.host_generator.manual_seed(state.step + 1)
    return state


def read_orbax_checkpoint(directory, step: int) -> dict:
    """:func:`checkpoint_from_orbax` of :func:`read_orbax_step`."""
    return checkpoint_from_orbax(read_orbax_step(directory, step)[0])

