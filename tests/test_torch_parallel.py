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
* Spatial serving, spatial 2 and 4, on JAX's two test models (two 3×3
  convs; a depth-2 ``unet_laplacian``) against JAX's
  ``denoise_spatially_sharded`` at JAX's atols (1e-5; rtol 1e-4 + atol
  1e-3) and against the port's unsharded forward; ``Denoiser(mesh=…)``
  against the unsharded ``Denoiser`` (1e-3); ``margin > local_h`` and
  ``tta`` under a spatial mesh raise JAX's errors.
* The train CLI as 2 ranks (``--coordinator-address``) on a narrowed
  flagship config and image files sharded by file: 3 steps, then a
  resume to 5; only rank 0 writes checkpoints and ``metrics.jsonl`` (one
  record a step), both ranks end bit-equal, and each rank's restored
  state is the step-3 checkpoint bit for bit. The CLI's flag errors. A
  spatial axis across 2 ranks, with or without ``spatial_training``,
  raises on both ranks before a step.
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

import blind_image_denoising_torch as bidt
import torch_parallel_workers as workers
from blind_image_denoising_tpu.inference.denoiser import (
    Denoiser as JaxDenoiser)
from blind_image_denoising_tpu.layers.conv import ConvBlock as JaxConvBlock
from blind_image_denoising_tpu.models.hydra import (
    model_builder as jax_model_builder)
from blind_image_denoising_tpu.parallel.mesh import (
    create_mesh as jax_create_mesh, replicate_sharding as jax_replicate,
    shard_batch as jax_shard_batch, shard_train_step as jax_shard_train_step)
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
from blind_image_denoising_torch.parallel.spatial import (
    receptive_field_margin)
from blind_image_denoising_torch.training.checkpoint import CheckpointManager
from blind_image_denoising_torch.weights import params_from_flax

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
    with pytest.raises(NotImplementedError, match="spatial training"):
        shard_train_step(lambda *a: a, create_mesh(), spatial=True)
    with pytest.raises(ValueError, match="no process group"):
        shard_train_step(lambda *a: a, create_mesh(devices=[0, 1]))


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


@pytest.mark.parametrize("spatial", [2, 4])
def test_spatial_serving_matches_jax(tmp_path, spatial):
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

    k = {n: torch.from_numpy(np.array(vs_cnn["params"][n]["kernel"])
                             ).permute(3, 2, 0, 1).contiguous()
         for n in ("c1", "c2")}
    params = params_from_flax(jax.tree_util.tree_map(np.asarray, vs_unet))
    workers.run_cohort(spatial, "spatial_cases", tmp_path, COHORT_TIMEOUT,
                       conv=dict(weights=k, image=x_cnn, margin=2),
                       unet=dict(model_config=TINY_UNET, params=params,
                                 image=x_unet, margin=margin,
                                 small_image=small),
                       spatial=spatial)
    ranks = [workers.load_result(tmp_path / f"rank{r}.pt") for r in range(spatial)]

    port = model_builder(copy.deepcopy(TINY_UNET)).hydra
    port.load_state_dict(params)
    port.eval()
    with torch.no_grad():
        forward = port(torch.from_numpy(x_unet).permute(0, 3, 1, 2))[0]
    forward = forward.permute(0, 2, 3, 1).numpy()
    served = Denoiser(port, cast_to_uint8=False, pad_multiple=1,
                      device="cpu")(x_unet)
    for r in ranks:
        np.testing.assert_allclose(r["conv"].numpy(), cnn_ref, atol=1e-5)
        np.testing.assert_allclose(r["unet"].numpy(), unet_ref, rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_allclose(r["unet"].numpy(), forward, rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_allclose(r["served"], served, atol=1e-3)
        assert r["error"] == str(jax_error.value)


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


def test_two_rank_train_cli_writes_once_and_resumes(tmp_path):
    image_dir = tmp_path / "images"
    image_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(6):
        Image.fromarray(rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
                        ).save(image_dir / f"{i}.png")
    ckpt = tmp_path / "ckpt"
    paths = []
    for steps in (3, 5):
        path = tmp_path / f"config{steps}.json"
        path.write_text(json.dumps(_loop_config(image_dir, steps)))
        paths.append(path)
    legs = []
    for path in paths:
        port = workers.free_port()
        legs.append([["--pipeline-config", str(path),
                      "--checkpoint-directory", str(ckpt), "--device", "cpu",
                      "--backend", "gloo", "--coordinator-address",
                      f"localhost:{port}", "--num-processes", "2",
                      "--process-id", str(r)] for r in range(2)])
    workers.run_cohort(2, "train_cli", tmp_path / "out", COHORT_TIMEOUT,
                       join=False, legs=legs)
    ranks = [workers.load_result(tmp_path / "out" / f"rank{r}.pt") for r in range(2)]
    assert ranks[0]["saved"] and not ranks[1]["saved"]
    assert ranks[1]["metrics_enabled"] == [False, False]
    steps = [json.loads(line)["step"] for line in
             (ckpt / "metrics.jsonl").read_text().splitlines()
             if "total_loss" in line]
    assert steps == [1, 2, 3, 4, 5]
    manager = CheckpointManager(str(ckpt))
    assert manager.latest_step() == 5
    ckpt3 = manager.read(3)
    for leg in range(2):
        for name, v in ranks[0]["finals"][leg].items():
            assert torch.equal(v, ranks[1]["finals"][leg][name]), name
    for rank in ranks:
        restored = rank["restored"][-1]
        assert restored["step"] == 3
        for name, v in ckpt3["model"].items():
            assert torch.equal(restored["model"][name], v), name
        for name, v in ckpt3["ema_params"].items():
            assert torch.equal(restored["ema"][name], v), name
        for name, v in ckpt3["opt_state"]["slots"].items():
            assert all(torch.equal(a, b)
                       for a, b in zip(restored["slots"][name], v)), name
    final = manager.read(5)["model"]
    for name, v in final.items():
        assert torch.equal(ranks[0]["finals"][1][name], v), name


def test_two_rank_loop_refuses_a_spatial_mesh(tmp_path):
    """Each rank reads its own rows, so a spatial axis across processes
    (with or without spatial_training) raises on every rank before a step
    rather than letting spatial peers train apart."""
    configs = []
    for extra in ({}, {"spatial_training": True}):
        cfg = _loop_config(tmp_path / "images", 2)
        cfg["tpu"]["mesh"] = dict({"data": -1, "spatial": 2}, **extra)
        configs.append(cfg)
    workers.run_cohort(2, "loop_refusals", tmp_path / "out", COHORT_TIMEOUT,
                       configs=configs)
    for r in range(2):
        res = workers.load_result(tmp_path / "out" / f"rank{r}.pt")
        (kind0, msg0), (kind1, msg1) = res["errors"]
        assert kind0 == kind1 == "NotImplementedError"
        assert "tpu.mesh.spatial=2 across 2 processes" in msg0
        assert "spatially sharded training" in msg1
        assert all("the next slice" in m for m in (msg0, msg1))
        assert res["steps"] == [None, None]


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
