"""The port's ``parallel/`` against the JAX package's, on the CPU.

Cohorts are 2–4 ranks of a gloo process group, each rank a process of
its own (``tests/torch_parallel_workers.py``, started with ``spawn``),
joined with a timeout: a rank that hangs fails the test.

* ``create_mesh``: the shape, the rank grid and the errors of JAX's
  ``create_mesh`` for the same device counts, exactly;
  ``receptive_field_margin`` equal to JAX's over a grid of (depth, k,
  width); ``Sharding.shard`` takes each micro-batch's rows.
* K3's plain version: ``sample_offset`` r·b gives rows r·b … r·b + b − 1
  of the global draw (the batch and the per-sample params) exactly, and
  offset 0 is the call without it, bit for bit.
* The data-parallel step, 2 ranks of b4 on JAX's tiny resnet (with and
  without BatchNorm): without noise and flips, the loss within 1e-6
  relative and every param (BatchNorm's running statistics too) within
  1e-5 of its tensor's largest entry of the port's single-process step
  on the global b8, and within the train-step tests' 1e-4 (relative,
  of the largest entry) of JAX's ``shard_train_step(step,
  create_mesh(data=2))`` on the 8-virtual-CPU mesh; with flips and
  noise (the exact noise, and K3's plain version at two micro-batches),
  the same bars against the port's single step, each rank's noisy rows
  and K3 rows those of the single step bit for bit, and the params equal
  across ranks bit for bit. The same on a dcn 2 × data 2 cohort of 4
  ranks (JAX's multislice test's model and ``create_mesh(dcn=2, data=2,
  spatial=2)``).
* The spatially sharded step, one cohort of 4 ranks (data 2 × spatial
  2) running every case: JAX's two backbones (the resnet, the
  ``unet_laplacian`` with self-attention), a resnet with BatchNorm, the
  selector and dense gates, and a ``unet_laplacian`` with attention
  gates, the global pool, attention dropout, element dropout and
  drop-path; each plain, with noise and flips, with K3's plain version
  at two micro-batches, and with ``remat``; on JAX's batch (2×32×32) and
  on a taller one whose slabs are shorter than the crop (2×128×32).
  Against the port's single-process step: the loss within 1e-6
  relative, every metric within 1e-5, every param within 1e-5 of its
  tensor's largest entry, the ranks bit-equal, each rank's noisy batch
  and K3 rows the single step's bit for bit. The plain resnet against
  JAX's ``shard_train_step(spatial=True)`` on ``create_mesh(data=2,
  spatial=2)``, the attention ``unet_laplacian`` against JAX's
  single-device step, at 1e-4. Each family's training margin: the slab
  of a middle rank gives the unsharded forward's loss rows within 1e-5.
  ``row_bounds``; a one-rank ``spatial=True`` step is the plain step.
* Spatial serving, spatial 2 and 4, on JAX's two test models (two 3×3
  convs; a depth-2 ``unet_laplacian``) against JAX's
  ``denoise_spatially_sharded`` at JAX's atols (1e-5; rtol 1e-4 + atol
  1e-3) and against the port's unsharded forward; ``Denoiser(mesh=…)``
  against the unsharded ``Denoiser`` (1e-3), and its input gradient and
  tangent through ``float_forward`` within 1e-5 of the largest entry;
  the packaged flagship (f32, 384×128, margin 88) against JAX's
  ``denoise_spatially_sharded`` of it (rtol 1e-4, atol 1e-3);
  ``margin > local_h`` and ``tta`` under a spatial mesh raise JAX's
  errors.
* The train CLI as 2 ranks (``--coordinator-address``) on a narrowed
  flagship config and image files sharded by file: 3 steps, then a
  resume to 5; only rank 0 writes checkpoints and ``metrics.jsonl`` (one
  record a step), both ranks end bit-equal, and each rank's restored
  state is the step-3 checkpoint bit for bit; then a spatially sharded
  leg (``{spatial: 2, spatial_training: true}``), JAX's log lines and
  step 3 in its ``metrics.jsonl``. The CLI's flag errors. ``train_loop``
  as 2 ranks with ``{spatial: 2, spatial_training: true}`` and with
  ``{spatial: 2}``: 2 steps from image files and a resume to 3, the
  ranks' batches and final states bit-equal, rank 0 alone writing, the
  restore bit for bit.
"""

import copy
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import blind_image_denoising_tpu as bid
import blind_image_denoising_torch as bidt
import torch_parallel_workers as workers
from blind_image_denoising_tpu.config import load_config as jax_load_config
from blind_image_denoising_tpu.images import load_evaluation_images
from blind_image_denoising_tpu.inference.denoiser import (
    Denoiser as JaxDenoiser)
from blind_image_denoising_tpu.layers.conv import ConvBlock as JaxConvBlock
from blind_image_denoising_tpu.models.hydra import (
    model_builder as jax_model_builder)
from blind_image_denoising_tpu.parallel.mesh import (
    create_mesh as jax_create_mesh, data_sharding as jax_data_sharding,
    replicate_sharding as jax_replicate, shard_batch as jax_shard_batch,
    shard_train_step as jax_shard_train_step)
from blind_image_denoising_tpu.parallel.spatial import (
    denoise_spatially_sharded as jax_denoise_spatially_sharded,
    receptive_field_margin as jax_receptive_field_margin,
    spatial_shard_image as jax_spatial_shard_image)
from blind_image_denoising_tpu.training import (
    build_train_step as jax_build_train_step,
    loss_function_builder as jax_loss_function_builder,
    optimizer_builder as jax_optimizer_builder)
from blind_image_denoising_tpu.training.train_state import (
    create_train_state as jax_create_train_state)
from blind_image_denoising_torch import train as train_cli
from blind_image_denoising_torch.data.dataset import dataset_builder
from blind_image_denoising_torch.inference.denoiser import Denoiser
from blind_image_denoising_torch.models.hydra import model_builder
from blind_image_denoising_torch.ops import pallas_noise
from blind_image_denoising_torch.parallel import (
    create_mesh, data_sharding, multihost, shard_train_step)
from blind_image_denoising_torch.parallel.mesh import row_bounds
from blind_image_denoising_torch.parallel.spatial import (
    LOSS_ROWS, downsample_factor, receptive_field_margin, training_margin)
from blind_image_denoising_torch.training.train_state import init_params
from blind_image_denoising_torch.training.checkpoint import CheckpointManager
from blind_image_denoising_torch.weights import load_msgpack, params_from_flax

COHORT_TIMEOUT = 300.0

LOSS = {"hinge": 0.0, "mae_multiplier": 1.0, "ssim_multiplier": -1.0,
        "regularization": 0.01}
OPTIMIZER = {"type": "ADAM", "schedule": {"type": "cosine_decay", "config": {
    "learning_rate": 0.01, "decay_steps": 1000}}}
# the deterministic step (no flips, no noise): the one JAX can be held to
PLAIN = dict(additive_noise=None, multiplicative_noise=None,
             random_left_right=False, random_up_down=False)


def _resnet(use_bn, blocks=(3, 3)):
    """JAX's DP tests' tiny resnet (``tests/test_parallel.py``)."""
    return {"backbone": {
        "type": "resnet", "input_shape": ["?", "?", 3], "filters": 4,
        "no_layers": 1, "kernel_size": 3, "block_kernels": list(blocks),
        "block_filters": [4] * len(blocks), "activation": "relu",
        "batchnorm": use_bn, "value_range": [0, 255],
        "kernel_regularizer": "l1", "kernel_initializer": "glorot_normal"},
        "denoiser": {"use_bias": False, "output_channels": 3}}


def _rel_max(got, ref):
    """max |got − ref| over the largest |ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


# ---------------------------------------------------------------- the mesh

@pytest.mark.parametrize("kw", [
    dict(data=-1), dict(data=4, spatial=2), dict(data=2, spatial=2, dcn=2),
    dict(data=2), dict(data=-1, spatial=2, dcn=2), dict(data=9),
    dict(data=-1, spatial=3), dict(data=3, spatial=2, dcn=2)])
def test_create_mesh_matches_jax(kw):
    ranks = list(range(8))
    try:
        ref = jax_create_mesh(**kw, devices=jax.devices()[:8])
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            create_mesh(**kw, devices=ranks)
        assert str(got.value) == str(e)
        return
    mesh = create_mesh(**kw, devices=ranks)
    assert mesh.shape == dict(ref.shape)
    assert mesh.axis_names == tuple(ref.axis_names)
    np.testing.assert_array_equal(
        mesh.devices, np.vectorize(lambda d: d.id)(ref.devices))
    assert mesh.coords == {a: 0 for a in mesh.axis_names}
    assert not mesh.distributed


def test_one_process_mesh_is_one_rank():
    mesh = create_mesh()
    assert mesh.shape == {"data": 1, "spatial": 1} and mesh.size == 1
    with pytest.raises(ValueError, match="needs more than 1 devices"):
        create_mesh(data=2)
    # the step is the single-process one, unwrapped
    step = object()
    assert shard_train_step(step, mesh) is step


def test_receptive_field_margin_matches_jax():
    for depth in range(1, 6):
        for k in (3, 5, 7):
            for width in (1, 2, 3):
                assert receptive_field_margin(depth, k, width) == \
                    jax_receptive_field_margin(depth, k, width)
    assert receptive_field_margin(3, 5, 3) == 88


def test_sharding_takes_each_micro_batch_rows():
    mesh = create_mesh(data=2, spatial=2, devices=[0, 1, 2, 3])
    x = np.arange(8 * 4).reshape(8, 4, 1, 1)
    local = data_sharding(mesh).shard(x, micro_batches=2)
    np.testing.assert_array_equal(local[:, 0, 0, 0] // 4, [0, 1, 4, 5])
    both = data_sharding(mesh, spatial=True).shard(torch.from_numpy(x))
    assert tuple(both.shape) == (4, 2, 1, 1)
    with pytest.raises(ValueError, match="does not split"):
        data_sharding(mesh).shard(x[:6], micro_batches=2)


def test_shard_train_step_refusals():
    with pytest.raises(ValueError, match="no process group"):
        shard_train_step(lambda *a: a, create_mesh(devices=[0, 1]))
    with pytest.raises(ValueError, match="no process group"):
        shard_train_step(lambda *a: a, create_mesh(
            data=1, spatial=2, devices=[0, 1]), spatial=True)
    # one rank: the spatially sharded step is the plain step
    batch = np.random.default_rng(2).uniform(
        0, 255, (2, 32, 32, 3)).astype(np.float32)
    case = dict(model=SPATIAL_RESNET, loss=SPATIAL_LOSS, optimizer=OPTIMIZER,
                params=_seeded_params(SPATIAL_RESNET), step=PLAIN)
    results = []
    for wrap in (False, True):
        state, step = workers.build_step(case["model"], case["loss"],
                                         case["optimizer"], case["params"],
                                         **PLAIN)
        if wrap:
            sharded = shard_train_step(step, create_mesh(), spatial=True)
            assert sharded is step
        results.append(step(state, torch.from_numpy(batch))[0])
    for (name, a), b in zip(results[0].model.state_dict().items(),
                            results[1].model.state_dict().values()):
        assert torch.equal(a, b), name


def test_row_bounds_are_multiples_of_the_factor():
    assert [row_bounds(128, i, 2, 4) for i in range(2)] == [(0, 64),
                                                            (64, 128)]
    # uneven: equal runs of a multiple of the factor, the last the rest
    assert [row_bounds(32, i, 3, 8) for i in range(3)] == [(0, 8), (8, 16),
                                                           (16, 32)]
    assert [row_bounds(40, i, 3, 4) for i in range(3)] == [(0, 12), (12, 24),
                                                           (24, 40)]
    with pytest.raises(ValueError, match="does not split"):
        row_bounds(16, 0, 4, 8)


def test_dataset_shards_files_by_the_process_group(tmp_path, monkeypatch):
    for i in range(6):
        Image.fromarray(np.full((20, 20, 3), 40 * i, np.uint8)).save(
            tmp_path / f"{i}.png")
    cfg = {"batch_size": 1, "input_shape": [8, 8, 3],
           "inputs": [{"directory": str(tmp_path)}]}
    seen = []
    for rank in range(2):
        monkeypatch.setattr(multihost, "process_count", lambda: 2)
        monkeypatch.setattr(multihost, "process_index", lambda r=rank: r)
        vals = set()
        for b in dataset_builder(dict(cfg)).training:
            vals.update(np.unique(b).astype(int).tolist())
        seen.append(vals)
    assert seen[0] and seen[1] and not seen[0] & seen[1]
    assert seen[0] | seen[1] == {0, 40, 80, 120, 160, 200}


# ---------------------------------------------------------------- K3 rows

def test_noise_sample_offset_gives_the_global_rows():
    x = torch.round(255 * torch.rand((8, 6, 5, 3),
                                     generator=torch.Generator()
                                     .manual_seed(0)))
    kw = dict(additive_noise=[5, 40], multiplicative_noise=[0.1, 0.3])
    full, params = pallas_noise.corrupt_noise(11, x, return_params=True,
                                              **kw)
    same, same_params = pallas_noise.corrupt_noise(
        11, x, return_params=True, sample_offset=0, **kw)
    assert torch.equal(full, same) and torch.equal(params, same_params)
    for r in range(4):
        rows = slice(2 * r, 2 * r + 2)
        part, p = pallas_noise.corrupt_noise(11, x[rows], return_params=True,
                                             sample_offset=2 * r, **kw)
        assert torch.equal(part, full[rows]) and torch.equal(p, params[rows])
    with pytest.raises(ValueError, match="sample_offset"):
        pallas_noise.corrupt_noise(11, x, sample_offset=-1, **kw)


# ---------------------------------------------------------------- DP step

def _jax_state_and_params(model_cfg, shape):
    hydra = jax_model_builder(copy.deepcopy(model_cfg)).hydra
    tx, _ = jax_optimizer_builder(OPTIMIZER)
    state = jax_create_train_state(hydra, tx, jax.random.PRNGKey(0),
                                   jnp.zeros(shape))
    tree = {"params": jax.tree_util.tree_map(np.asarray, state.params)}
    if state.batch_stats:
        tree["batch_stats"] = jax.tree_util.tree_map(np.asarray,
                                                     state.batch_stats)
    return hydra, tx, state, params_from_flax(tree)


def _jax_sharded_step(hydra, tx, state, batch, mesh):
    step = jax_build_train_step(hydra, tx, jax_loss_function_builder(LOSS),
                                no_outputs=1, **PLAIN)
    repl = jax_replicate(mesh)
    new, metrics = jax_shard_train_step(step, mesh)(
        jax.device_put(state, repl), jax_shard_batch(mesh, batch),
        jax.device_put(jax.random.PRNGKey(7), repl),
        jax.device_put(jnp.ones((1,), jnp.float32), repl))
    tree = {"params": jax.tree_util.tree_map(np.asarray, new.params)}
    if new.batch_stats:
        tree["batch_stats"] = jax.tree_util.tree_map(np.asarray,
                                                     new.batch_stats)
    return params_from_flax(tree), float(metrics["total_loss"])


def _check_dp(tmp_path, model_cfg, n, mesh_kw, jax_mesh_kw, batch):
    """The cohort's step against the port's single step and JAX's."""
    hydra, tx, jstate, params = _jax_state_and_params(model_cfg,
                                                      batch.shape)
    base = dict(model=model_cfg, loss=LOSS, optimizer=OPTIMIZER,
                params=params)
    cases = [dict(base, step=PLAIN),
             dict(base, step=dict(additive_noise=[5, 10],
                                  multiplicative_noise=[0.1, 0.2])),
             dict(base, step=dict(additive_noise=[5, 10],
                                  use_pallas_noise=True, grad_accum=2))]
    workers.run_cohort(n, "dp_steps", tmp_path, COHORT_TIMEOUT, cases=cases,
                       batch=batch, mesh_kw=mesh_kw)
    ranks = [workers.load_result(tmp_path / f"rank{r}.pt") for r in range(n)]
    single = workers.run_steps(cases, batch)
    for c, ref in enumerate(single):
        for rank in ranks:
            got = rank["results"][c]
            index = (rank["coords"].get("dcn", 0) * rank["shape"]["data"]
                     + rank["coords"]["data"])
            assert got["metrics"]["total_loss"] == pytest.approx(
                ref["metrics"]["total_loss"], rel=1e-6), c
            for name, v in ref["params"].items():
                assert _rel_max(got["params"][name], v) <= 1e-5, (c, name)
            for key in ("noisy", "k3"):
                assert len(got[key]) == len(ref[key])
                for a, b in zip(ref[key], got[key]):
                    m = b.shape[0]
                    assert torch.equal(a[index * m:(index + 1) * m], b), key
            for name, v in got["params"].items():
                assert torch.equal(v, ranks[0]["results"][c]["params"][name])
    assert [len(r["k3"]) for r in single] == [0, 0, 2]
    jax_params, jax_loss = _jax_sharded_step(
        hydra, tx, jstate, jnp.asarray(batch), jax_create_mesh(
            **jax_mesh_kw))
    got = ranks[0]["results"][0]
    assert got["metrics"]["total_loss"] == pytest.approx(jax_loss, rel=1e-4)
    assert set(jax_params) == set(got["params"])
    for name, v in jax_params.items():
        assert _rel_max(got["params"][name], v) <= 1e-4, name


@pytest.mark.parametrize("use_bn", [False, True])
def test_dp_step_matches_single_process_and_jax(tmp_path, use_bn):
    batch = np.random.default_rng(1).uniform(
        0, 255, (8, 16, 16, 3)).astype(np.float32)
    _check_dp(tmp_path, _resnet(use_bn), 2, dict(data=2), dict(data=2),
              batch)


def test_dcn_mesh_step_matches_single_process_and_jax(tmp_path):
    batch = np.random.default_rng(2).uniform(
        0, 255, (8, 16, 16, 3)).astype(np.float32)
    _check_dp(tmp_path, _resnet(False, blocks=(3,)), 4, dict(dcn=2, data=2),
              dict(dcn=2, data=2, spatial=2), batch)


# ---------------------------------------------------------------- spatial step

# every loss term on: the hinged MAE, the RMSE and SSIM, the regularizer
SPATIAL_LOSS = {"hinge": 0.5, "mae_multiplier": 1.0, "mse_multiplier": 0.5,
                "ssim_multiplier": 1.0, "regularization": 0.01}
SPATIAL_DENOISER = {"use_bias": False, "filters": 4, "output_channels": 3}
# JAX's two backbones (tests/test_parallel.py::
# test_spatial_training_matches_single_device)
SPATIAL_RESNET = {"backbone": {
    "type": "resnet", "input_shape": ["?", "?", 3], "filters": 4,
    "no_layers": 1, "kernel_size": 3, "block_kernels": [3, 3],
    "block_filters": [4, 4], "activation": "relu", "batchnorm": False,
    "value_range": [0, 255], "kernel_regularizer": "l1"},
    "denoiser": SPATIAL_DENOISER}
SPATIAL_ATTENTION = {"backbone": {
    "type": "unet_laplacian", "input_shape": ["?", "?", 3], "depth": 2,
    "width": 1, "filters": 4, "use_self_attention": True,
    "multiple_scale_outputs": True, "value_range": [0, 255]},
    "denoiser": SPATIAL_DENOISER}
# every op of the builders that sees the whole map: BatchNorm, the
# selector (pool, global mean, global normalization, resize back) and the
# dense gates' means
SPATIAL_GATED_RESNET = {"backbone": {
    "type": "resnet", "input_shape": ["?", "?", 3], "filters": 4,
    "no_layers": 2, "kernel_size": 3, "block_kernels": [3, 3],
    "block_filters": [4, 4], "activation": "relu", "batchnorm": True,
    "add_gates": True, "selector_params": {
        "scale_type": "MIXED", "pool_size": [8, 8],
        "use_global_normalization": True},
    "value_range": [0, 255], "kernel_regularizer": "l1"},
    "denoiser": SPATIAL_DENOISER}
# attention gates, the global pool with its LayerNorm, the self-attention
# with its dropout, element dropout and drop-path. LayerNorm, as the
# family's configs: with BatchNorm the gates' statistics are means of a
# zero-mean band (largest entry ~1e-6), whose float32 summation order
# alone moves them by ~1e-5 of it, in the data-parallel step as well
SPATIAL_GATED_UNET = {"backbone": {
    "type": "unet_laplacian", "input_shape": ["?", "?", 3], "depth": 2,
    "width": [1, 2], "filters": 4, "use_attention_gates": True,
    "use_global_pool_information": True, "use_self_attention": True,
    "convolutional_self_attention_dropout_rate": 0.25,
    "use_output_normalization": True,
    "dropout_rate": 0.1, "depth_drop_rate": 0.5,
    "multiple_scale_outputs": True, "value_range": [0, 255]},
    "denoiser": SPATIAL_DENOISER}
SPATIAL_MODELS = {"resnet": SPATIAL_RESNET, "attention": SPATIAL_ATTENTION,
                  "gated_resnet": SPATIAL_GATED_RESNET,
                  "gated_unet": SPATIAL_GATED_UNET}
NOISE = dict(additive_noise=[5, 10], multiplicative_noise=[0.1, 0.2])
SPATIAL_MODES = {"plain": PLAIN, "noise": NOISE,
                 "k3": dict(additive_noise=[5, 10], use_pallas_noise=True,
                            grad_accum=2),
                 "remat": dict(NOISE, remat=True)}
# JAX's batch, and a taller one whose slabs are shorter than the crop
SPATIAL_HEIGHTS = (32, 128)


def _seeded_params(model_cfg, seed=0):
    hydra = model_builder(copy.deepcopy(model_cfg)).hydra
    init_params(hydra, torch.Generator().manual_seed(seed))
    return {k: v.clone() for k, v in hydra.state_dict().items()}


def _spatial_batch(height, mode):
    batch = np.random.default_rng(2).uniform(
        0, 255, (2, height, 32, 3)).astype(np.float32)
    if SPATIAL_MODES[mode].get("grad_accum", 1) > 1:
        # two micro-batches: the batch and its mirror image
        batch = np.concatenate([batch, batch[:, ::-1]])
    return np.ascontiguousarray(batch)


@pytest.fixture(scope="module")
def jax_params():
    """JAX's initial params of its two backbones (PRNGKey 0), as state
    dicts, with JAX's hydra, optimizer and state."""
    out = {}
    for name in ("resnet", "attention"):
        out[name] = _jax_state_and_params(SPATIAL_MODELS[name],
                                          (2, 32, 32, 3))
    return out


@pytest.fixture(scope="module")
def spatial_cohort(tmp_path_factory, jax_params):
    """One cohort of 4 gloo ranks (data 2 × spatial 2) runs every case:
    each model × mode × height through ``shard_train_step(spatial=True)``,
    and the ranks share the single-process steps."""
    keys, cases = [], []
    for name, cfg in SPATIAL_MODELS.items():
        params = (jax_params[name][3] if name in jax_params
                  else _seeded_params(cfg))
        for mode, step in SPATIAL_MODES.items():
            for height in SPATIAL_HEIGHTS:
                keys.append((name, mode, height))
                cases.append(dict(model=cfg, loss=SPATIAL_LOSS,
                                  optimizer=OPTIMIZER, params=params,
                                  step=step,
                                  batch=_spatial_batch(height, mode)))
    out = tmp_path_factory.mktemp("spatial_cohort")
    workers.run_cohort(4, "spatial_steps", out, COHORT_TIMEOUT, cases=cases,
                       mesh_kw=dict(data=2, spatial=2))
    ranks = [workers.load_result(out / f"rank{r}.pt") for r in range(4)]
    single = {}
    for rank in ranks:
        single.update(rank["single"])
    return {key: dict(ranks=[r["results"][c] for r in ranks],
                      coords=[r["coords"] for r in ranks],
                      single=single[c])
            for c, key in enumerate(keys)}


@pytest.mark.parametrize("height", SPATIAL_HEIGHTS)
@pytest.mark.parametrize("mode", list(SPATIAL_MODES))
@pytest.mark.parametrize("model", list(SPATIAL_MODELS))
def test_spatial_step_matches_single_process(spatial_cohort, model, mode,
                                             height):
    """The spatially sharded step on data 2 × spatial 2 against the port's
    single-process step on the global batch: the f32 loss within 1e-6
    relative, every param (and BatchNorm statistic) within 1e-5 of its
    tensor's largest entry, the ranks bit-equal, and each rank's noisy
    batch and K3 rows bit-equal to the single step's rows."""
    got = spatial_cohort[(model, mode, height)]
    ref = got["single"]
    cfg = SPATIAL_MODELS[model]
    margin = training_margin(cfg)
    slab = [min(height, r1 + margin) - max(0, r0 - margin)
            for r0, r1 in (row_bounds(height, i, 2, downsample_factor(cfg))
                           for i in range(2))]
    if height == 128:
        assert max(slab) < height, slab
    for rank, coords in zip(got["ranks"], got["coords"]):
        assert rank["metrics"]["total_loss"] == pytest.approx(
            ref["metrics"]["total_loss"], rel=1e-6)
        for k, v in ref["metrics"].items():
            assert rank["metrics"][k] == pytest.approx(v, rel=1e-5,
                                                       abs=1e-6), k
        for name, v in ref["params"].items():
            assert _rel_max(rank["params"][name], v) <= 1e-5, name
        for name, v in rank["params"].items():
            assert torch.equal(v, got["ranks"][0]["params"][name]), name
        for key in ("noisy", "k3"):
            assert len(rank[key]) == len(ref[key])
            for a, b in zip(ref[key], rank[key]):
                m = b.shape[0]
                index = coords["data"]
                assert torch.equal(a[index * m:(index + 1) * m], b), key
    assert len(ref["k3"]) == (2 if mode == "k3" else 0)


def test_spatial_step_matches_jax(spatial_cohort, jax_params):
    """The PLAIN step against JAX: the resnet against JAX's
    ``shard_train_step(spatial=True)`` on ``create_mesh(data=2,
    spatial=2)``, the attention ``unet_laplacian`` against JAX's
    single-device step (JAX marks its own sharded version slow and holds
    it equal); loss within 1e-4 relative, params within 1e-4 of each
    tensor's largest entry."""
    batch = jnp.asarray(_spatial_batch(32, "plain"))
    for name in ("resnet", "attention"):
        hydra, tx, state, _ = jax_params[name]
        no_outputs = 1 if name == "resnet" else 2
        step = jax_build_train_step(
            hydra, tx, jax_loss_function_builder(SPATIAL_LOSS),
            no_outputs=no_outputs, **PLAIN)
        dw = jnp.full((no_outputs,), 1.0 / no_outputs, jnp.float32)
        rng = jax.random.PRNGKey(7)
        if name == "resnet":
            mesh = jax_create_mesh(data=2, spatial=2)
            repl = jax_replicate(mesh)
            new, metrics = jax_shard_train_step(step, mesh, spatial=True)(
                jax.device_put(state, repl),
                jax.device_put(batch, jax_data_sharding(mesh, spatial=True)),
                jax.device_put(rng, repl), jax.device_put(dw, repl))
        else:
            new, metrics = jax.jit(step)(state, batch, rng, dw)
        ref = params_from_flax({"params": jax.tree_util.tree_map(
            np.asarray, new.params)})
        got = spatial_cohort[(name, "plain", 32)]["ranks"][0]
        assert got["metrics"]["total_loss"] == pytest.approx(
            float(metrics["total_loss"]), rel=1e-4)
        assert set(ref) <= set(got["params"])
        for k, v in ref.items():
            assert _rel_max(got["params"][k], v) <= 1e-4, (name, k)


MARGIN_MODELS = {
    "resnet": {"type": "resnet", "input_shape": ["?", "?", 3],
               "filters": 4, "no_layers": 2, "kernel_size": 5,
               "block_kernels": [3, 5], "block_filters": [4, 4],
               "batchnorm": False, "add_mean_sigma_normalization": True},
    "convnext": {"type": "convnext", "input_shape": ["?", "?", 3],
                 "filters": 4, "no_layers": 2, "block_filters": [4, 8, 4]},
    "unet": {"type": "unet", "input_shape": ["?", "?", 3], "filters": 4,
             "no_layers": 1, "no_levels": 3, "block_kernels": [3, 3],
             "block_filters": [4, 4], "batchnorm": False},
    "unet_laplacian": {
        "type": "unet_laplacian", "input_shape": ["?", "?", 3], "depth": 3,
        "width": [2, 1, 2], "filters": 4, "encoder_kernel_size": [3, 5, 5],
        "decoder_kernel_size": [3, 5, 3], "downsample_type": "conv2d",
        "upsample_type": "upsample_nearest_conv2d",
        "use_self_attention": False, "multiple_scale_outputs": True},
}


@pytest.mark.parametrize("family", list(MARGIN_MODELS))
def test_training_margin_suffices(family):
    """Each family's training margin: an attention-free model in f32 on
    the slab of the middle rank of 4 gives, at every output scale, the
    unsharded forward's rows from its first owned row to the loss's
    ``LOSS_ROWS`` past its last, within 1e-5 of the output's largest
    entry."""
    cfg = {"backbone": MARGIN_MODELS[family],
           "denoiser": {"filters": 4, "output_channels": 3}}
    model = model_builder(copy.deepcopy(cfg)).hydra
    init_params(model, torch.Generator().manual_seed(5))
    model.eval()
    height = 512
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 255, (1, 3, height, 40)).astype(np.float32))
    margin, factor = training_margin(cfg), downsample_factor(cfg)
    assert margin % factor == 0 and margin >= LOSS_ROWS
    r0, r1 = row_bounds(height, 1, 4, factor)
    s0, s1 = r0 - margin, r1 + margin
    assert 0 < s0 and s1 < height, (s0, s1)
    with torch.no_grad():
        whole, slab = model(x), model(x[:, :, s0:s1])
    for i, (a, b) in enumerate(zip(whole, slab)):
        f = 2 ** i
        rows = slice(r0 // f, r1 // f + LOSS_ROWS)
        got = b[:, :, (r0 - s0) // f:(r1 - s0) // f + LOSS_ROWS]
        assert _rel_max(got, a[:, :, rows]) <= 1e-5, i


# ---------------------------------------------------------------- spatial

TINY_UNET = {"backbone": {
    "type": "unet_laplacian", "input_shape": ["?", "?", 3],
    "depth": 2, "width": 1, "filters": 4,
    "encoder_kernel_size": 3, "decoder_kernel_size": 3,
    "gaussian_kernel_size": 2, "activation": "leaky_relu_01",
    "upsample_type": "upsample_nearest_conv2d", "downsample_type": "strides",
    "use_bn": False, "use_ln": True, "use_bias": False,
    "use_concat": False, "use_gamma": True,
    "use_laplacian_averaging": True, "use_mix_project": False,
    "use_self_attention": False, "use_attention_gates": False,
    "use_output_normalization": False,
    "multiple_scale_outputs": False, "depth_drop_rate": 0.0,
    "kernel_regularizer": "l2", "kernel_initializer": "glorot_normal"},
    "denoiser": {"filters": 4, "use_bias": False, "output_channels": 3}}


class _JaxTinyCNN(nn.Module):
    """JAX's spatial test model: two ConvBlocks (relu, then linear)."""

    @nn.compact
    def __call__(self, x):
        x = JaxConvBlock(features=8, kernel_size=3, activation="relu",
                         name="c1")(x)
        return JaxConvBlock(features=3, kernel_size=3, name="c2")(x)


FLAGSHIP = "unet_laplacian_v6_tpu_scratch"


@pytest.fixture(scope="module")
def flagship():
    """The packaged flagship in float32: (JAX hydra, JAX variables, the
    port's state dict, a noisy 384×128 frame, its margin 88)."""
    tree = load_msgpack(f"{bid.models[FLAGSHIP]['directory']}/params.msgpack")
    variables = tree if "params" in tree else {"params": tree}
    cfg = jax_load_config(bid.models[FLAGSHIP]["configuration"])
    hydra = jax_model_builder(cfg["model"]).hydra
    clean = load_evaluation_images(384)[0, :, :128]
    rng = np.random.default_rng(0)
    frame = np.clip(np.round(clean + rng.normal(0, 15, clean.shape)), 0,
                    255).astype(np.float32)[None]
    bb = cfg["model"]["backbone"]
    margin = jax_receptive_field_margin(
        bb["depth"], max(bb["encoder_kernel_size"]), max(bb["width"]))
    return dict(hydra=hydra, variables=variables, config=cfg["model"],
                params=params_from_flax(variables), frame=frame,
                margin=margin)


@pytest.mark.parametrize("spatial", [2, 4])
def test_spatial_serving_matches_jax(tmp_path, spatial, flagship):
    # JAX's two models and inputs (tests/test_parallel.py)
    tiny = _JaxTinyCNN()
    x_cnn = np.random.default_rng(0).normal(
        size=(1, 64, 32, 3)).astype(np.float32)
    vs_cnn = tiny.init(jax.random.PRNGKey(0), jnp.asarray(x_cnn))
    hydra = jax_model_builder(copy.deepcopy(TINY_UNET)).hydra
    x_unet = np.random.default_rng(0).uniform(
        0, 255, (1, 64, 32, 3)).astype(np.float32)
    vs_unet = hydra.init({"params": jax.random.PRNGKey(0)},
                         jnp.asarray(x_unet), train=False)
    vs_unet = {k: v for k, v in vs_unet.items()
               if k in ("params", "batch_stats")}
    margin = jax_receptive_field_margin(2, 3, 1)
    mesh = jax_create_mesh(data=8 // spatial, spatial=spatial)
    cnn_ref = np.asarray(jax_denoise_spatially_sharded(
        lambda v, im: tiny.apply(v, im), vs_cnn, mesh, margin=2)(
            jax_spatial_shard_image(mesh, jnp.asarray(x_cnn))))
    unet_ref = np.asarray(jax_denoise_spatially_sharded(
        lambda v, im: hydra.apply(v, im, train=False)[0], vs_unet, mesh,
        margin=margin)(jax_spatial_shard_image(mesh, jnp.asarray(x_unet))))
    small = np.zeros((1, 8 * spatial, 32, 3), np.float32)
    with pytest.raises(ValueError) as jax_error:
        jax_denoise_spatially_sharded(
            lambda v, im: hydra.apply(v, im, train=False)[0], vs_unet, mesh,
            margin=margin)(jax_spatial_shard_image(mesh, jnp.asarray(small)))
    big = flagship["hydra"]
    one = jax_create_mesh(data=1, spatial=spatial,
                          devices=jax.devices()[:spatial])
    flagship_ref = np.asarray(jax_denoise_spatially_sharded(
        lambda v, im: big.apply(v, im, train=False)[0],
        flagship["variables"], one, margin=flagship["margin"])(
            jax_spatial_shard_image(one, jnp.asarray(flagship["frame"]))))

    k = {n: torch.from_numpy(np.array(vs_cnn["params"][n]["kernel"])
                             ).permute(3, 2, 0, 1).contiguous()
         for n in ("c1", "c2")}
    params = params_from_flax(jax.tree_util.tree_map(np.asarray, vs_unet))
    rng = np.random.default_rng(1)
    weight = rng.normal(size=x_unet.shape).astype(np.float32)
    tangent = rng.normal(size=x_unet.shape).astype(np.float32)
    workers.run_cohort(spatial, "spatial_cases", tmp_path, COHORT_TIMEOUT,
                       conv=dict(weights=k, image=x_cnn, margin=2),
                       unet=dict(model_config=TINY_UNET, params=params,
                                 image=x_unet, margin=margin,
                                 small_image=small, weight=weight,
                                 tangent=tangent),
                       flagship=dict(model_config=flagship["config"],
                                     params=flagship["params"],
                                     image=flagship["frame"],
                                     margin=flagship["margin"]),
                       spatial=spatial)
    ranks = [workers.load_result(tmp_path / f"rank{r}.pt")
             for r in range(spatial)]

    port = model_builder(copy.deepcopy(TINY_UNET)).hydra
    port.load_state_dict(params)
    port.eval()
    with torch.no_grad():
        forward = port(torch.from_numpy(x_unet).permute(0, 3, 1, 2))[0]
    forward = forward.permute(0, 2, 3, 1).numpy()
    den = Denoiser(port, cast_to_uint8=False, pad_multiple=1, device="cpu")
    served = den(x_unet)
    x = torch.from_numpy(x_unet).requires_grad_(True)
    (den.float_forward(x) * torch.from_numpy(weight)).sum().backward()
    import torch.autograd.forward_ad as fwad
    with fwad.dual_level():
        tangent_ref = fwad.unpack_dual(den.float_forward(fwad.make_dual(
            torch.from_numpy(x_unet), torch.from_numpy(tangent)))).tangent
    for r in ranks:
        np.testing.assert_allclose(r["conv"].numpy(), cnn_ref, atol=1e-5)
        np.testing.assert_allclose(r["unet"].numpy(), unet_ref, rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_allclose(r["unet"].numpy(), forward, rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_allclose(r["served"], served, atol=1e-3)
        assert r["error"] == str(jax_error.value)
        # a derivative through the sharded forward, both modes
        assert _rel_max(r["gradient"], x.grad) <= 1e-5
        assert _rel_max(r["tangent"], tangent_ref) <= 1e-5
        # the packaged flagship, sharded, against JAX's sharding of it
        np.testing.assert_allclose(r["flagship"].numpy(), flagship_ref,
                                   rtol=1e-4, atol=1e-3)


def test_tta_under_a_spatial_mesh_raises_jaxs_error():
    hydra = jax_model_builder(copy.deepcopy(TINY_UNET)).hydra
    vs = hydra.init({"params": jax.random.PRNGKey(0)},
                    jnp.zeros((1, 32, 32, 3)), train=False)
    with pytest.raises(ValueError) as ref:
        JaxDenoiser(hydra, vs, tta=True,
                    mesh=jax_create_mesh(data=1, spatial=2))
    with pytest.raises(ValueError) as got:
        Denoiser(model_builder(copy.deepcopy(TINY_UNET)).hydra, tta=True,
                 mesh=create_mesh(data=1, spatial=2, devices=[0, 1]),
                 device="cpu")
    assert str(got.value) == str(ref.value)


def test_a_one_rank_mesh_serves_as_without():
    model = model_builder(copy.deepcopy(TINY_UNET)).hydra
    x = np.random.default_rng(3).integers(0, 256, (40, 24, 3), np.uint8)
    np.testing.assert_array_equal(
        Denoiser(model, mesh=create_mesh(), spatial_margin=16,
                 pad_multiple=16, device="cpu")(x),
        Denoiser(model, pad_multiple=16, device="cpu")(x))


# ---------------------------------------------------------------- loop

def _loop_config(image_dir, total_steps):
    cfg = copy.deepcopy(bidt.CONFIGS_DICT["unet_laplacian_v6_tpu"])
    mc = cfg["model"]
    mc["backbone"].update(depth=2, filters=8, width=[1, 1],
                          encoder_kernel_size=[3, 5],
                          decoder_kernel_size=[3, 5])
    mc["denoiser"]["filters"] = 8
    cfg["train"].update(total_steps=total_steps, checkpoint_every=3,
                        visualization_every=-1, log_every=1,
                        gpu_batches_per_step=2, use_test_images=False,
                        epochs=-1, ema=0.9)
    cfg["dataset"].update(inputs=[{"directory": str(image_dir)}],
                          input_shape=[32, 32, 3], batch_size=4,
                          no_crops_per_image=2, repeat=True)
    cfg["tpu"] = {"compute_dtype": "float32", "pallas_noise": True}
    return cfg


def _image_dir(tmp_path):
    image_dir = tmp_path / "images"
    image_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(6):
        Image.fromarray(rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
                        ).save(image_dir / f"{i}.png")
    return image_dir


def _check_restore(restored, ckpt):
    """A rank's restored state is the checkpoint, bit for bit."""
    for name, v in ckpt["model"].items():
        assert torch.equal(restored["model"][name], v), name
    for name, v in ckpt["ema_params"].items():
        assert torch.equal(restored["ema"][name], v), name
    for name, v in ckpt["opt_state"]["slots"].items():
        assert all(torch.equal(a, b)
                   for a, b in zip(restored["slots"][name], v)), name


def test_two_rank_train_cli_writes_once_and_resumes(tmp_path):
    """The data-parallel legs (3 steps, a resume to 5) and, as JAX's
    ``test_two_process_spatial_training``, a spatially sharded leg of 3
    steps into a directory of its own."""
    image_dir = _image_dir(tmp_path)
    ckpt, spatial_ckpt = tmp_path / "ckpt", tmp_path / "spatial_ckpt"
    paths = []
    for steps in (3, 5):
        path = tmp_path / f"config{steps}.json"
        path.write_text(json.dumps(_loop_config(image_dir, steps)))
        paths.append((path, ckpt))
    cfg = _loop_config(image_dir, 3)
    cfg["tpu"]["mesh"] = {"spatial": 2, "spatial_training": True}
    path = tmp_path / "spatial.json"
    path.write_text(json.dumps(cfg))
    paths.append((path, spatial_ckpt))
    legs = []
    for path, directory in paths:
        port = workers.free_port()
        legs.append([["--pipeline-config", str(path),
                      "--checkpoint-directory", str(directory),
                      "--device", "cpu",
                      "--backend", "gloo", "--coordinator-address",
                      f"localhost:{port}", "--num-processes", "2",
                      "--process-id", str(r)] for r in range(2)])
    workers.run_cohort(2, "train_cli", tmp_path / "out", COHORT_TIMEOUT,
                       join=False, legs=legs)
    ranks = [workers.load_result(tmp_path / "out" / f"rank{r}.pt")
             for r in range(2)]
    assert ranks[0]["saved"] and not any(w for _, w in ranks[1]["saved"])
    assert ranks[1]["metrics_enabled"] == [False] * 3
    steps = [json.loads(line)["step"] for line in
             (ckpt / "metrics.jsonl").read_text().splitlines()
             if "total_loss" in line]
    assert steps == [1, 2, 3, 4, 5]
    manager = CheckpointManager(str(ckpt))
    assert manager.latest_step() == 5
    for leg in range(3):
        for name, v in ranks[0]["finals"][leg].items():
            assert torch.equal(v, ranks[1]["finals"][leg][name]), name
    for rank in ranks:
        restored = rank["restored"][1]
        assert restored["step"] == 3
        _check_restore(restored, manager.read(3))
    final = manager.read(5)["model"]
    for name, v in final.items():
        assert torch.equal(ranks[0]["finals"][1][name], v), name
    # the spatial leg: JAX's log lines and step 3 in metrics.jsonl
    logs = "\n".join(ranks[0]["logs"])
    assert "(spatially-sharded training)" in logs
    assert "'spatial': 2" in logs
    steps = [json.loads(line)["step"] for line in
             (spatial_ckpt / "metrics.jsonl").read_text().splitlines()]
    assert 3 in steps


def test_two_rank_loop_refuses_a_spatial_mesh(tmp_path):
    """A spatial axis across two processes trains (the loop refused it
    before spatially sharded training was ported; the name stays): with
    ``{spatial: 2, spatial_training: true}`` and with ``{spatial: 2}``
    two ranks train 2 steps from image files and resume to 3. Both read
    the same rows at every step, end bit-equal, rank 0 alone writes, and
    each rank's restored state is the step-2 checkpoint bit for bit."""
    image_dir = _image_dir(tmp_path)
    runs = []
    for extra in ({"spatial_training": True}, {}):
        legs = []
        for steps in (2, 3):
            cfg = _loop_config(image_dir, steps)
            cfg["tpu"]["mesh"] = dict({"data": -1, "spatial": 2}, **extra)
            legs.append(cfg)
        runs.append(legs)
    workers.run_cohort(2, "spatial_loops", tmp_path / "out", COHORT_TIMEOUT,
                       runs=runs)
    ranks = [workers.load_result(tmp_path / "out" / f"rank{r}.pt")
             for r in range(2)]
    for i, sharded in enumerate((True, False)):
        first, second = ranks[0][i], ranks[1][i]
        logs = "\n".join(first["logs"])
        assert f"[{image_dir}]: 6 images" in logs
        assert ("(spatially-sharded training)" in logs) == sharded
        assert len(first["batches"]) == 3
        assert first["batches"] == second["batches"]
        assert any(w for _, w in first["saved"])
        assert not any(w for _, w in second["saved"])
        assert first["metrics_enabled"] == [True, True]
        assert second["metrics_enabled"] == [False, False]
        for leg in range(2):
            for name, v in first["finals"][leg].items():
                assert torch.equal(v, second["finals"][leg][name]), name
        manager = CheckpointManager(str(tmp_path / "out" / f"ckpt_{i}"))
        assert manager.latest_step() == 3
        for rank in (first, second):
            assert rank["restored"][-1]["step"] == 2
            _check_restore(rank["restored"][-1], manager.read(2))
        for name, v in manager.read(3)["model"].items():
            assert torch.equal(first["finals"][1][name], v), name


def test_train_cli_multihost_flag_errors(tmp_path):
    path = tmp_path / "c.json"
    path.write_text("{}")
    assert train_cli.main(["--pipeline-config", str(path),
                           "--checkpoint-directory", str(tmp_path),
                           "--coordinator-address", "localhost:1"]) == 1
    with pytest.raises(ValueError, match="one device per process"):
        train_cli.main(["--pipeline-config", str(path),
                        "--checkpoint-directory", str(tmp_path),
                        "--coordinator-address", "localhost:1",
                        "--num-processes", "2", "--process-id", "0",
                        "--local-device-count", "4", "--device", "cpu"])
    with pytest.raises(SystemExit):
        train_cli.main(["--pipeline-config", str(path),
                        "--checkpoint-directory", str(tmp_path),
                        "--backend", "mpi"])
