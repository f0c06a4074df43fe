"""The port's reading of JAX's Orbax checkpoints
(``training/orbax.py`` and ``training/checkpoint.py``), against the JAX
package, on the CPU.

* Full width: JAX's ``CheckpointManager.save`` writes the
  ``unet_laplacian_v6_tpu`` ``TrainState`` built from the packaged
  flagship params, every optimizer slot and the EMA filled with seeded
  arrays (no training), once with ``ema_params`` and once without. The
  port's ``CheckpointManager.restore`` equals JAX's ``restore`` leaf for
  leaf, bit for bit: params, every slot, the count, step and epoch, the
  EMA (present or absent, whatever the restoring state had).
* Every update rule the port's optimizer runs (adam with the three
  clips, amsgrad, rmsprop plain / centered with momentum, adadelta) on
  a narrow flagship (depth 2, filters 8, widths [1, 1]), and a
  BatchNorm resnet's ``batch_stats``: the same bar.
* A JAX ``train_loop`` run (the narrowed flagship, 3 steps, EMA 0.5):
  the port's ``export_model`` writes the ``params.msgpack`` JAX's
  ``export_model`` writes, byte for byte; the port's loop resumes it at
  step 4 from JAX's restored params and EMA, writes ``ckpt_*.pt`` beside
  it and leaves JAX's step directories byte-identical; the port's
  ``--weights-directory`` of that run starts from JAX's restored EMA.
* Import hygiene: the Orbax restore in a subprocess imports
  ``tensorstore`` and neither ``jax`` nor ``orbax``.
"""

import copy
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blind_image_denoising_tpu as bid
import blind_image_denoising_torch as bidt
from blind_image_denoising_tpu.inference.export import (
    export_model as jax_export_model)
from blind_image_denoising_tpu.training import train_loop as jax_loop_module
from blind_image_denoising_tpu.training.checkpoint import (
    CheckpointManager as JaxManager)
from blind_image_denoising_tpu.training.optimizer import (
    optimizer_builder as jax_optimizer_builder)
from blind_image_denoising_tpu.training.train_state import (
    TrainState as JaxState)
from blind_image_denoising_torch.inference.export import export_model
from blind_image_denoising_torch.models.hydra import model_builder
from blind_image_denoising_torch.training import (create_train_state,
                                                  optimizer_builder)
from blind_image_denoising_torch.training import train_loop as loop_module
from blind_image_denoising_torch.training.checkpoint import CheckpointManager
from blind_image_denoising_torch.training.orbax import (
    SLOT_FIELDS, orbax_steps, read_orbax_step, train_state_from_orbax)
from blind_image_denoising_torch.weights import flax_from_params

CONFIG = "unet_laplacian_v6_tpu"
FLAGSHIP = "unet_laplacian_v6_tpu_scratch"
RESNET = "resnet_color_1x6_bn_32x128x32_1x3x1_128x128_depthwise_l1_relu"
ROOT = Path(__file__).resolve().parent.parent


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_trees_equal(got, ref):
    got, ref = _flat(got), _flat(ref)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def _jax_slots(node, out):
    """The slot subtrees of an optax state, by field name."""
    if hasattr(node, "_fields"):
        for f in node._fields:
            if f in SLOT_FIELDS:
                out[f] = getattr(node, f)
            else:
                _jax_slots(getattr(node, f), out)
    elif isinstance(node, (tuple, list)):
        for v in node:
            _jax_slots(v, out)
    return out


def _jax_count(opt_state):
    counts = {int(leaf) for path, leaf in
              jax.tree_util.tree_leaves_with_path(opt_state)
              if getattr(path[-1], "name", None) == "count"}
    assert len(counts) == 1
    return counts.pop()


def _assert_restored_equal(port, ref):
    """The port's restored TrainState against JAX's, bit for bit."""
    variables = flax_from_params(port.model)
    _assert_trees_equal(variables["params"], jax.device_get(ref.params))
    _assert_trees_equal(variables.get("batch_stats", {}),
                        jax.device_get(ref.batch_stats))
    names = [n for n, _ in port.model.named_parameters()]
    slots = _jax_slots(ref.opt_state, {})
    assert set(slots) == set(port.opt_state.slots)
    for name, tree in slots.items():
        got = flax_from_params(dict(zip(names, port.opt_state.slots[name])))
        _assert_trees_equal(got["params"], jax.device_get(tree))
    assert port.opt_state.count == _jax_count(ref.opt_state)
    assert (port.step, port.epoch) == (int(ref.step), int(ref.epoch))
    assert (port.ema_params is None) == (ref.ema_params is None)
    if ref.ema_params is not None:
        got = flax_from_params(port.ema_params)
        _assert_trees_equal(got["params"], jax.device_get(ref.ema_params))


def _seeded_state(params, batch_stats, optimizer_config, ema, seed=0):
    """A JAX TrainState at step 7 / epoch 2 whose optimizer slots (and
    EMA) are seeded arrays and whose counts are 7."""
    rng = np.random.default_rng(seed)
    tx, _ = jax_optimizer_builder(optimizer_config)

    def fill(a):
        a = np.asarray(a)
        if a.dtype == np.int32:
            return jnp.asarray(7, jnp.int32)
        return jnp.asarray(rng.standard_normal(a.shape).astype(a.dtype))

    params = jax.tree_util.tree_map(jnp.asarray, params)
    return JaxState(
        step=jnp.asarray(7, jnp.int32), epoch=jnp.asarray(2, jnp.int32),
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, batch_stats),
        opt_state=jax.tree_util.tree_map(fill, tx.init(params)),
        ema_params=(jax.tree_util.tree_map(fill, params) if ema else None))


def _save_jax(state, directory):
    manager = JaxManager(str(directory))
    assert manager.save(state)
    manager.wait()
    manager.close()


def _restore_jax(state, directory):
    manager = JaxManager(str(directory))
    try:
        return manager.restore(state)
    finally:
        manager.close()


def _port_state(model_config, optimizer_config, ema=False, seed=3):
    tx, _ = optimizer_builder(optimizer_config)
    state = create_train_state(model_builder(model_config).hydra, tx,
                               seed=seed, device="cpu")
    if ema:
        state.ema_params = {k: torch.zeros_like(v)
                            for k, v in state.params.items()}
    return state


# ------------------------------------------------------------ full width

@pytest.fixture(scope="module")
def flagship_runs(tmp_path_factory):
    """JAX runs of the full-width flagship state, with and without EMA."""
    root = tmp_path_factory.mktemp("orbax_flagship")
    cfg = bidt.CONFIGS_DICT[CONFIG]
    packaged = fser.msgpack_restore(
        (Path(bid.models[FLAGSHIP]["directory"]) / "params.msgpack")
        .read_bytes())
    runs = {}
    for ema in (True, False):
        state = _seeded_state(packaged["params"], {},
                              cfg["train"]["optimizer"], ema, seed=int(ema))
        _save_jax(state, root / f"ema_{ema}")
        runs[ema] = (root / f"ema_{ema}", state)
    return cfg, runs


@pytest.mark.parametrize("ckpt_ema", [True, False])
@pytest.mark.parametrize("state_ema", [True, False])
def test_full_width_restore_equals_jax(flagship_runs, ckpt_ema, state_ema):
    cfg, runs = flagship_runs
    directory, written = runs[ckpt_ema]
    ref = _restore_jax(written.replace(
        ema_params=written.params if state_ema else None), directory)
    assert (ref.ema_params is not None) == ckpt_ema
    port = _port_state(cfg["model"], cfg["train"]["optimizer"],
                       ema=state_ema)
    manager = CheckpointManager(str(directory))
    assert manager.latest_step() == 7 and manager.all_steps() == []
    port = manager.restore(port)
    assert (port.ema_params is not None) == ckpt_ema
    _assert_restored_equal(port, ref)


def test_read_orbax_step_keeps_none_leaves(flagship_runs):
    _, runs = flagship_runs
    tree, has_ema = read_orbax_step(runs[False][0], 7)
    assert not has_ema and tree["ema_params"] is None
    assert tree["opt_state"]["0"] is None          # the clip's EmptyState
    assert tree["batch_stats"] == {}
    assert orbax_steps(runs[True][0]) == [7]


# ---------------------------------------------------------- every rule

def _narrow_model():
    mc = copy.deepcopy(bidt.CONFIGS_DICT[CONFIG]["model"])
    mc["backbone"].update(depth=2, filters=8, width=[1, 1],
                          encoder_kernel_size=[3, 5],
                          decoder_kernel_size=[3, 5])
    return mc


def _resnet_model():
    mc = copy.deepcopy(bidt.CONFIGS_DICT[RESNET]["model"])
    mc["backbone"].update(filters=8, no_layers=2, block_filters=[8, 32, 8])
    return mc


_SCHEDULE = {"type": "exponential_decay",
             "config": {"learning_rate": 1e-3, "decay_rate": 0.9,
                        "decay_steps": 100}}
RULES = {
    "adam_clipped": dict(type="ADAM", gradient_clipping_by_value=0.5,
                         gradient_clipping_by_norm_local=1.0,
                         gradient_clipping_by_norm=2.0),
    "amsgrad": dict(type="ADAM", amsgrad=True),
    "rmsprop": dict(type="RMSPROP"),
    "rmsprop_centered_momentum": dict(type="RMSPROP", centered=True,
                                      momentum=0.9),
    "adadelta": dict(type="ADADELTA", rho=0.95),
}


@pytest.mark.parametrize("rule", sorted(RULES) + ["resnet_batchnorm"])
def test_every_rule_restores_equal_to_jax(tmp_path, rule):
    resnet = rule == "resnet_batchnorm"
    mc = _resnet_model() if resnet else _narrow_model()
    opt = dict(RULES.get(rule, dict(type="ADAM")), schedule=_SCHEDULE)
    model = model_builder(mc).hydra
    torch.manual_seed(0)
    with torch.no_grad():
        for t in model.state_dict().values():
            t.copy_(torch.randn_like(t).abs() if t.dim() == 1 else
                    torch.randn_like(t))
    variables = flax_from_params(model)
    assert ("batch_stats" in variables) == resnet
    written = _seeded_state(variables["params"],
                            variables.get("batch_stats", {}), opt, ema=True)
    _save_jax(written, tmp_path)
    ref = _restore_jax(written, tmp_path)
    port = CheckpointManager(str(tmp_path)).restore(_port_state(mc, opt))
    _assert_restored_equal(port, ref)
    # the module function restores the same and seeds the generators as
    # the loop does at a resume
    tree, has_ema = read_orbax_step(tmp_path, 7)
    again = train_state_from_orbax(tree, _port_state(mc, opt, seed=9))
    assert has_ema
    _assert_restored_equal(again, ref)
    assert torch.equal(again.host_generator.get_state(),
                       torch.Generator().manual_seed(8).get_state())


def test_a_rule_mismatch_raises(tmp_path):
    mc = _narrow_model()
    model = model_builder(mc).hydra
    written = _seeded_state(flax_from_params(model)["params"], {},
                            dict(RULES["adadelta"], schedule=_SCHEDULE),
                            ema=False)
    _save_jax(written, tmp_path)
    with pytest.raises(ValueError, match="optimizer slots"):
        CheckpointManager(str(tmp_path)).restore(
            _port_state(mc, dict(type="ADAM", schedule=_SCHEDULE)))


# ------------------------------------------------- a JAX train_loop run

def _loop_pipeline(**train):
    cfg = copy.deepcopy(bidt.CONFIGS_DICT[CONFIG])
    cfg["model"] = _narrow_model()
    cfg["train"].update(dict(
        dict(total_steps=3, checkpoint_every=-1, visualization_every=-1,
             log_every=1, gpu_batches_per_step=1, use_test_images=False,
             ema=0.5), **train))
    cfg["dataset"].update(inputs=[], input_shape=[32, 32, 3], batch_size=2,
                          no_crops_per_image=1)
    cfg["tpu"] = {"compute_dtype": "float32"}
    return cfg


def _digest(directory):
    h = {}
    for root, _, files in os.walk(directory):
        for name in files:
            path = Path(root) / name
            h[str(path.relative_to(directory))] = hashlib.sha256(
                path.read_bytes()).hexdigest()
    return h


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("orbax_loop")
    cfg = _loop_pipeline()
    state = jax_loop_module.train_loop(cfg, root / "run")
    assert int(state.step) == 3
    return cfg, root, state


def test_export_of_a_jax_run_equals_jax_export(jax_run, tmp_path):
    cfg, root, _ = jax_run
    jax_export_model(cfg, root / "run", tmp_path / "jax",
                     to_stablehlo=False)
    export_model(cfg, root / "run", tmp_path / "port", device="cpu")
    assert ((tmp_path / "port" / "params.msgpack").read_bytes()
            == (tmp_path / "jax" / "params.msgpack").read_bytes())


def _first_step_state(monkeypatch):
    """Records the params and EMA the port's loop hands its first step."""
    seen = {}
    real = loop_module.build_train_step

    def build(*args, **kw):
        step = real(*args, **kw)

        def wrapped(state, batch, **kws):
            seen.setdefault("step", state.step)
            seen.setdefault("params", {k: v.detach().clone()
                                       for k, v in state.params.items()})
            seen.setdefault("ema", None if state.ema_params is None else
                            {k: v.clone() for k, v in
                             state.ema_params.items()})
            return step(state, batch, **kws)
        return wrapped

    monkeypatch.setattr(loop_module, "build_train_step", build)
    return seen


def _assert_named_equal(got, flax_tree):
    _assert_trees_equal(flax_from_params(got)["params"],
                        jax.device_get(flax_tree))


def test_port_loop_resumes_a_jax_run(jax_run, tmp_path, monkeypatch):
    import shutil
    cfg, root, state = jax_run
    run = tmp_path / "run"
    shutil.copytree(root / "run", run)
    before = _digest(run / "3")
    seen = _first_step_state(monkeypatch)
    resumed = loop_module.train_loop(cfg, run, total_steps_override=4,
                                     device="cpu")
    assert seen["step"] == 3 and resumed.step == 4
    _assert_named_equal(seen["params"], state.params)
    _assert_named_equal(seen["ema"], state.ema_params)
    assert sorted(p.name for p in run.glob("ckpt_*.pt")) == [
        "ckpt_0000000004.pt"]
    assert _digest(run / "3") == before
    manager = CheckpointManager(str(run), max_to_keep=1)
    assert manager.latest_step() == 4 and orbax_steps(run) == [3]


def test_weights_directory_of_a_jax_run(jax_run, tmp_path, monkeypatch):
    _, root, state = jax_run
    seen = _first_step_state(monkeypatch)
    loop_module.train_loop(_loop_pipeline(total_steps=1, ema=0.0),
                           tmp_path / "ft", weights_directory=root / "run",
                           device="cpu")
    assert seen["step"] == 0 and seen["ema"] is None
    _assert_named_equal(seen["params"], state.ema_params)


def test_orbax_restore_imports_neither_jax_nor_orbax(jax_run):
    _, root, _ = jax_run
    code = f"""
import sys
from blind_image_denoising_torch.training.orbax import read_orbax_step
tree, has_ema = read_orbax_step({str(root / 'run')!r}, 3)
assert has_ema and int(tree["step"]) == 3
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "orbax", "flax", "blind_image_denoising_tpu"))
assert not bad, bad
assert "tensorstore" in sys.modules
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
