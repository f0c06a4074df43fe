"""The port's training loop and the pieces under it against the JAX
package, on the CPU, on a tiny ``unet_laplacian`` (the flagship config
narrowed to depth 2, filters 8, widths [1, 1], kernels [3, 5]; K2
splits the level-0 bands, attention runs at level 1) and image files
the tests write.

* The loop: ``train_loop`` for 3 steps, then resumed to 5, on the same
  config and directory as JAX's ``train_loop``: every metrics record's
  ``step``, ``epoch`` and ``learning_rate`` equal (the rate within 1e-9)
  and the same deep-supervision weights logged per epoch (within 1e-6).
  SIGTERM mid-epoch checkpoints without advancing the epoch; fine-tuning
  starts from an artifact written from a JAX init (params bit-equal to
  ``params_from_flax`` of it) or from a donor checkpoint's EMA; the CLI
  trains with ``--device cpu``; without ``device`` the loop raises on a
  box without CUDA; what is not ported raises naming its item.
* The step: the five deep-supervision schedules equal JAX's (1e-7); the
  EMA equals the host-side fold of ``tests/test_ema.py`` (rtol 1e-5);
  ``grad_stats``' five numbers equal ``jnp.percentile`` (1e-6 of the
  range) and name the JAX gradients' 2-D / 4-D paths; remat gives the
  loss and every gradient of the step without it, bit for bit, with
  drop-path and dropout on; log-uniform stds lie in [lo, hi] with
  log σ uniform (mean within 0.03 of the range's middle, relative to
  its width; half below √(lo·hi) within 0.03); ``build_eval_step``
  matches JAX's ``eval_step`` on converted params (f32, 1e-4 of the
  output's range); the σ = 0 noise sweep's MAE and PSNR match JAX's
  within 1e-4; the weight statistics match JAX's (1e-6 relative).
* Checkpoints: save → restore is bit-exact (params, buffers, optimizer
  slots and count, step, epoch, EMA); keep-N and an idempotent save; an
  EMA presence mismatch restores the checkpoint's layout in both
  directions.
* BatchNorm runs, on the resnet config narrowed (filters 8, 2 layers,
  ``batchnorm`` true and ``"bias_free"``, 2 micro-batches, noise and
  flips off so both packages see the same batches): three ``train_loop``
  steps from the same JAX-init artifact equal JAX's ``train_loop`` —
  losses within 1e-4 relative, params and running statistics within
  1e-4 of each tensor's largest magnitude (the train step's gradient
  bar); a ``remat`` step leaves the buffers (and loss and params) of a
  plain step bit for bit; a resume restores the running statistics bit
  for bit.
"""

import copy
import json
import logging
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import blind_image_denoising_torch as bidt
from blind_image_denoising_tpu.inference.export import save_params_artifact
from blind_image_denoising_tpu.models.hydra import (
    model_builder as jax_model_builder)
from blind_image_denoising_tpu.training import train_loop as jax_loop_module
from blind_image_denoising_tpu.training.optimizer import (
    deep_supervision_schedule_builder as jax_ds_builder)
from blind_image_denoising_tpu.training.train_state import (
    create_train_state as jax_create_train_state)
from blind_image_denoising_tpu.training.train_step import (
    build_eval_step as jax_build_eval_step)
from blind_image_denoising_torch import train as train_cli
from blind_image_denoising_torch.data import prefetch
from blind_image_denoising_torch.models.hydra import model_builder
from blind_image_denoising_torch.ops.multiscale import multiscale_targets
from blind_image_denoising_torch.ops.noise import corrupt_batch, draw_stds
from blind_image_denoising_torch.training import (
    build_eval_step, build_train_step, create_train_state, forward_loss,
    loss_function_builder, optimizer_builder)
from blind_image_denoising_torch.training import train_loop as loop_module
from blind_image_denoising_torch.training.checkpoint import CheckpointManager
from blind_image_denoising_torch.training.metrics import MetricsWriter
from blind_image_denoising_torch.training.optimizer import (
    deep_supervision_schedule_builder)
from blind_image_denoising_torch.training.train_step import five_numbers
from blind_image_denoising_torch.weights import load_msgpack, params_from_flax

CONFIG = "unet_laplacian_v6_tpu"


def _model_config(**backbone):
    mc = copy.deepcopy(bidt.CONFIGS_DICT[CONFIG]["model"])
    mc["backbone"].update(depth=2, filters=8, width=[1, 1],
                          encoder_kernel_size=[3, 5],
                          decoder_kernel_size=[3, 5], **backbone)
    return mc


def _pipeline(image_dir, **train):
    """The flagship pipeline narrowed: 4 files × 2 crops of 32² in batches
    of 2, 2 micro-batches a step → 2 steps an epoch."""
    cfg = copy.deepcopy(bidt.CONFIGS_DICT[CONFIG])
    cfg["model"] = _model_config()
    cfg["train"].update(dict(
        dict(total_steps=3, checkpoint_every=-1, visualization_every=-1,
             log_every=1, gpu_batches_per_step=2, use_test_images=False),
        **train))
    cfg["dataset"].update(
        inputs=[{"directory": str(image_dir)}] if image_dir else [],
        input_shape=[32, 32, 3], batch_size=2, no_crops_per_image=2)
    cfg["tpu"] = {"compute_dtype": "float32"}
    return cfg


def _write_images(directory, n=4, seed=0):
    directory.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
                        ).save(directory / f"{i}.png")
    return directory


def _records(ckpt_dir):
    rows = [json.loads(line) for line in
            (ckpt_dir / "metrics.jsonl").read_text().splitlines()]
    return [(r["step"], r["epoch"], r["learning_rate"]) for r in rows
            if "total_loss" in r]


def _ds_logs(caplog):
    return [json.loads(r.getMessage().split("weights ", 1)[1])
            for r in caplog.records
            if "deep-supervision weights" in r.getMessage()]


def _run_two_legs(loop, image_dir, ckpt_dir, caplog, **kw):
    cfg = _pipeline(image_dir)
    caplog.clear()
    with caplog.at_level(logging.INFO):
        first = loop(cfg, ckpt_dir, **kw)
        steps_first = (int(first.step), int(first.epoch))
        second = loop(cfg, ckpt_dir, total_steps_override=5, **kw)
    return (steps_first, (int(second.step), int(second.epoch)),
            _records(ckpt_dir), _ds_logs(caplog))


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    return _write_images(tmp_path_factory.mktemp("loop_images"))


def test_loop_records_match_jax(image_dir, tmp_path, caplog):
    ref = _run_two_legs(jax_loop_module.train_loop, image_dir,
                        tmp_path / "jax", caplog)
    got = _run_two_legs(loop_module.train_loop, image_dir,
                        tmp_path / "port", caplog, device="cpu")
    assert got[0] == ref[0] == (3, 2)
    assert got[1] == ref[1] == (5, 3)
    assert [r[:2] for r in got[2]] == [r[:2] for r in ref[2]] == [
        (1, 0), (2, 0), (3, 1), (4, 2), (5, 2)]
    for g, r in zip(got[2], ref[2]):
        assert abs(g[2] - r[2]) <= 1e-9
    assert len(got[3]) == len(ref[3]) == 3
    np.testing.assert_allclose(got[3], ref[3], atol=1e-6)


def test_resume_restores_the_checkpoint_bit_exact(image_dir, tmp_path):
    cfg = _pipeline(image_dir, ema=0.5)
    state = loop_module.train_loop(cfg, tmp_path, device="cpu")
    manager = CheckpointManager(str(tmp_path))
    ckpt = manager.read(manager.latest_step())
    hydra = model_builder(cfg["model"]).hydra
    tx, _ = optimizer_builder(cfg["train"]["optimizer"])
    fresh = manager.restore(create_train_state(hydra, tx, seed=1,
                                               device="cpu"))
    assert (fresh.step, fresh.epoch) == (ckpt["step"], ckpt["epoch"]) == (3, 2)
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    for k, v in state.ema_params.items():
        assert torch.equal(fresh.ema_params[k], v), k
    for k, v in state.opt_state.slots.items():
        assert all(torch.equal(a, b) for a, b in
                   zip(fresh.opt_state.slots[k], v)), k
    assert fresh.opt_state.count == state.opt_state.count == 3


def test_preemption_midepoch_resumes_inside_epoch(tmp_path, monkeypatch):
    """A SIGTERM mid-epoch checkpoints and stops without advancing the
    epoch; the resume finishes that epoch (JAX's
    ``test_preemption_midepoch_resumes_inside_epoch``, on the port)."""
    cfg = _pipeline(None, epochs=1, total_steps=-1)
    cfg["dataset"]["batch_size"] = 1          # 16 synthetic batches: 8 steps
    fired = {"done": False}
    real = prefetch.device_prefetch

    def preempting(iterable, **kw):
        inner = real(iterable, **kw)

        class Wrap:
            def __iter__(self):
                for i, b in enumerate(inner):
                    if i == 1 and not fired["done"]:
                        fired["done"] = True
                        signal.raise_signal(signal.SIGTERM)
                    yield b

            def close(self):
                inner.close()
        return Wrap()

    monkeypatch.setattr(prefetch, "device_prefetch", preempting)
    state = loop_module.train_loop(cfg, tmp_path, device="cpu")
    assert fired["done"] and state.epoch == 0
    steps_before = state.step
    assert steps_before < 8
    assert CheckpointManager(str(tmp_path)).latest_step() == steps_before
    monkeypatch.setattr(prefetch, "device_prefetch", real)
    state = loop_module.train_loop(cfg, tmp_path, device="cpu")
    assert state.epoch == 1 and state.step == steps_before + 8


def _first_step_state(monkeypatch):
    """Records the params and EMA the loop hands to its first step."""
    seen = {}
    real = loop_module.build_train_step

    def build(*args, **kw):
        step = real(*args, **kw)

        def wrapped(state, batch, **kws):
            seen.setdefault("params", {k: v.detach().clone()
                                       for k, v in state.params.items()})
            seen.setdefault("ema", None if state.ema_params is None else
                            {k: v.clone() for k, v in
                             state.ema_params.items()})
            return step(state, batch, **kws)
        return wrapped

    monkeypatch.setattr(loop_module, "build_train_step", build)
    return seen


def test_finetune_from_a_jax_artifact(tmp_path, monkeypatch, converted):
    cfg = _pipeline(None, total_steps=1, ema=0.9)
    artifact = save_params_artifact(converted[1].params, cfg,
                                    tmp_path / "artifact")
    seen = _first_step_state(monkeypatch)
    loop_module.train_loop(cfg, tmp_path / "run", weights_directory=artifact,
                           device="cpu")
    ref = params_from_flax(load_msgpack(tmp_path / "artifact"
                                        / "params.msgpack"))
    assert set(seen["params"]) == set(ref)
    for k, v in ref.items():
        assert torch.equal(seen["params"][k], v), k
        assert torch.equal(seen["ema"][k], v), k     # EMA seeded from them


def test_finetune_from_a_donor_checkpoint_prefers_its_ema(tmp_path,
                                                         monkeypatch):
    donor = loop_module.train_loop(_pipeline(None, total_steps=2, ema=0.5),
                                   tmp_path / "donor", device="cpu")
    assert any(not torch.equal(donor.ema_params[k], p)
               for k, p in donor.params.items())
    seen = _first_step_state(monkeypatch)
    loop_module.train_loop(_pipeline(None, total_steps=1), tmp_path / "run",
                           weights_directory=tmp_path / "donor",
                           device="cpu")
    for k, v in donor.ema_params.items():
        assert torch.equal(seen["params"][k], v), k
    assert seen["ema"] is None


def test_train_cli_on_cpu(tmp_path):
    cfg = _pipeline(None, total_steps=-1)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    rc = train_cli.main(["--pipeline-config", str(path),
                         "--checkpoint-directory", str(tmp_path / "ckpt"),
                         "--total-steps", "1", "--device", "cpu"])
    assert rc == 0
    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 1
    assert json.loads((tmp_path / "ckpt" / "config.json").read_text()) == cfg
    assert train_cli.main(["--pipeline-config", str(tmp_path / "none.json"),
                           "--checkpoint-directory", str(tmp_path)]) == 1
    # JAX's CLI: --coordinator-address needs --num-processes and
    # --process-id (logged, exit code 1)
    assert train_cli.main(["--pipeline-config", str(path),
                           "--checkpoint-directory", str(tmp_path / "c2"),
                           "--coordinator-address", "localhost:1",
                           "--num-processes", "2", "--device", "cpu"]) == 1


def test_train_loop_needs_the_card_or_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card is the default")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bidt.train_loop(_pipeline(None), tmp_path)


# one process is a one-device mesh: a mesh over more devices raises JAX's
# ValueError, spatially sharded training included; several processes run
# in tests/test_torch_parallel.py
@pytest.mark.parametrize("change,error,match", [
    (lambda c: c["tpu"].update(mesh={"data": 2}), ValueError,
     "mesh 1x2x1 needs more than 1 devices"),
    (lambda c: c["tpu"].update(mesh={"data": -1, "spatial": 2}), ValueError,
     "mesh 1x2x2 needs more than 1 devices"),
    (lambda c: c["tpu"].update(mesh={"data": -1, "spatial": 2,
                                     "spatial_training": True}),
     ValueError, "mesh 1x2x2 needs more than 1 devices"),
    (lambda c: c["tpu"].update(mesh={"data": -1, "dcn": 3}), ValueError,
     "batch_size 2 not divisible by dcn=3 slices"),
    (lambda c: c["tpu"].update(mesh={"data": 4}), ValueError,
     "mesh 1x2x1 needs more than 1 devices"),
    (lambda c: c["tpu"].update(mesh={"data": -1, "dcn": 2}), ValueError,
     "mesh 2x1x1 needs more than 1 devices")])
def test_unported_loop_options_raise(tmp_path, change, error, match):
    cfg = _pipeline(None)
    change(cfg)
    with pytest.raises(error, match=match):
        loop_module.train_loop(cfg, tmp_path, device="cpu")


# ---------------------------------------------------------- BatchNorm runs

RESNET = "resnet_color_1x6_bn_32x128x32_1x3x1_128x128_depthwise_l1_relu"


def _resnet_pipeline(batchnorm, **train):
    """The resnet config narrowed (filters 8, 2 layers, blocks 8/32/8) on
    the synthetic stream: 32² crops, batches of 2 in 2 micro-batches,
    float32; noise and flips off, so a step's batch is the same in JAX
    and here."""
    cfg = copy.deepcopy(bidt.CONFIGS_DICT[RESNET])
    cfg["model"]["backbone"].update(filters=8, no_layers=2,
                                    block_filters=[8, 32, 8],
                                    batchnorm=batchnorm)
    cfg["train"].update(dict(
        dict(total_steps=3, checkpoint_every=-1, visualization_every=-1,
             log_every=1, gpu_batches_per_step=2, use_test_images=False),
        **train))
    cfg["dataset"].update(inputs=[], input_shape=[32, 32, 3], batch_size=2,
                          no_crops_per_image=1, additional_noise=[],
                          multiplicative_noise=[], random_left_right=False,
                          random_up_down=False)
    cfg["tpu"] = {"compute_dtype": "float32"}
    return cfg


def _rel(got, ref):
    return float((got - ref).abs().max() / max(float(ref.abs().max()),
                                               1e-30))


def _losses(ckpt_dir):
    return [json.loads(line)["total_loss"] for line in
            (ckpt_dir / "metrics.jsonl").read_text().splitlines()
            if "total_loss" in line]


@pytest.mark.parametrize("batchnorm", [True, "bias_free"])
def test_resnet_loop_matches_jax(tmp_path, batchnorm):
    """Three steps of 2 micro-batches from the same JAX-init artifact
    (params only, so the running statistics start at their initial
    values in both): every step's loss within 1e-4 relative, and every
    param and running statistic within 1e-4 of its tensor's largest
    magnitude (the train step's gradient bar; Adam's first steps
    normalize tiny gradients, so a param can move by a few ulps of the
    rate more or less)."""
    cfg = _resnet_pipeline(batchnorm)
    jhydra = jax_model_builder(copy.deepcopy(cfg["model"])).hydra
    params = jax.tree_util.tree_map(np.asarray, jhydra.init(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 32, 32, 3)),
        train=False)["params"])
    artifact = save_params_artifact(params, cfg, tmp_path / "artifact")
    jstate = jax_loop_module.train_loop(cfg, tmp_path / "jax",
                                        weights_directory=artifact)
    state = loop_module.train_loop(cfg, tmp_path / "port",
                                   weights_directory=artifact, device="cpu")
    ref_losses, losses = _losses(tmp_path / "jax"), _losses(tmp_path / "port")
    assert len(losses) == len(ref_losses) == 3
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, {
        "params": jstate.params, "batch_stats": jstate.batch_stats}))
    got = state.model.state_dict()
    assert set(got) == set(ref)
    stats = [k for k in ref if k.rsplit(".", 1)[-1] in
             ("mean", "var", "mean_sq")]
    assert stats and all(not torch.equal(ref[k], torch.zeros_like(ref[k]))
                         and not torch.equal(ref[k], torch.ones_like(ref[k]))
                         for k in stats)
    for k, v in ref.items():
        assert _rel(got[k], v) <= 1e-4, (k, _rel(got[k], v))


def test_remat_step_leaves_the_buffers_of_a_plain_step():
    """One step with ``remat`` updates the running statistics once per
    micro-batch, as the plain step does: the recompute in the backward
    leaves them alone. Loss, params and buffers equal bit for bit."""
    cfg = _resnet_pipeline(True)
    out = {}
    for remat in (False, True):
        hydra = model_builder(cfg["model"]).hydra
        tx, _ = optimizer_builder(cfg["train"]["optimizer"])
        state = create_train_state(hydra, tx, seed=3, device="cpu")
        initial = {k: v.clone() for k, v in hydra.named_buffers()}
        step = build_train_step(hydra, tx, loss_function_builder(cfg["loss"]),
                                hydra.no_outputs, grad_accum=2, remat=remat)
        state, metrics = step(state, _batch(4, 32, seed=6))
        out[remat] = (float(metrics["total_loss"]), hydra.state_dict())
    assert out[True][0] == out[False][0]
    for k, v in out[False][1].items():
        assert torch.equal(out[True][1][k], v), k
    moved = [k for k, v in out[False][1].items()
             if k in initial and not torch.equal(v, initial[k])]
    assert moved


def test_resume_restores_the_running_statistics_bit_exact(tmp_path):
    cfg = _resnet_pipeline("bias_free", total_steps=2)
    state = loop_module.train_loop(cfg, tmp_path, device="cpu")
    fresh = CheckpointManager(str(tmp_path)).restore(create_train_state(
        model_builder(cfg["model"]).hydra,
        optimizer_builder(cfg["train"]["optimizer"])[0], seed=1,
        device="cpu"))
    buffers = dict(state.model.named_buffers())
    assert any(k.endswith("mean_sq") for k in buffers)
    for k, v in fresh.model.named_buffers():
        assert torch.equal(v, buffers[k]), k


# ---------------------------------------------------------------- the step

@pytest.mark.parametrize("kind", ["constant_equal", "constant_low_to_high",
                                  "constant_high_to_low",
                                  "linear_low_to_high",
                                  "non_linear_low_to_high"])
@pytest.mark.parametrize("no_outputs", [1, 3, 4])
def test_deep_supervision_schedules_match_jax(kind, no_outputs):
    got = deep_supervision_schedule_builder({"type": kind}, no_outputs)
    ref = jax_ds_builder({"type": kind}, no_outputs)
    for pct in (0.0, 0.1, 0.37, 0.5, 0.9, 1.0):
        np.testing.assert_allclose(np.asarray(got(pct), np.float32),
                                   np.asarray(ref(pct), np.float32),
                                   rtol=0, atol=1e-7)
    with pytest.raises(ValueError):
        deep_supervision_schedule_builder({"type": "nope"}, 3)


def _tiny_state(seed=0, **backbone):
    cfg = _pipeline(None)
    cfg["model"] = _model_config(**backbone)
    hydra = model_builder(cfg["model"]).hydra
    tx, _ = optimizer_builder(cfg["train"]["optimizer"])
    return cfg, hydra, tx, create_train_state(hydra, tx, seed=seed,
                                              device="cpu")


def _batch(n=2, size=32, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.round(rng.uniform(0, 255, (n, size, size, 3))
                                     ).astype(np.float32))


def test_ema_matches_manual_fold():
    decay = 0.9
    cfg, hydra, tx, state = _tiny_state()
    state.ema_params = {k: v.detach().clone()
                        for k, v in state.params.items()}
    step = build_train_step(hydra, tx, loss_function_builder(cfg["loss"]),
                            hydra.no_outputs, additive_noise=[1, 5],
                            ema_decay=decay)
    manual = {k: v.detach().clone().numpy() for k, v in state.params.items()}
    for t in range(3):
        state, _ = step(state, _batch(seed=t))
        d = min(decay, (1.0 + t) / (10.0 + t))
        manual = {k: d * manual[k] + (1.0 - d) * v.detach().numpy()
                  for k, v in state.params.items()}
    for k, v in state.ema_params.items():
        np.testing.assert_allclose(v.numpy(), manual[k], rtol=1e-5,
                                   atol=1e-7)
    assert max(float((v - state.params[k].detach()).abs().max())
               for k, v in state.ema_params.items()) > 0.0
    state.ema_params = None
    with pytest.raises(ValueError, match="ema_params"):
        step(state, _batch())


@pytest.mark.parametrize("n", [1, 2, 5, 1000, 4099])
def test_five_numbers_match_jnp_percentile(n):
    x = np.random.default_rng(n).normal(0, 1, (n,)).astype(np.float32)
    got = five_numbers(torch.from_numpy(x)).numpy()
    ref = np.asarray(jnp.percentile(jnp.asarray(x), jnp.asarray(
        [0.0, 25.0, 50.0, 75.0, 100.0], jnp.float32)))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-6 * max(float(np.ptp(x)), 1.0))


def test_grad_stats_name_the_jax_gradients(converted):
    cfg, hydra, tx, state = _tiny_state()
    step = build_train_step(hydra, tx, loss_function_builder(cfg["loss"]),
                            hydra.no_outputs, additive_noise=[1, 5],
                            grad_stats=True)
    state, metrics = step(state, _batch())
    flat = jax.tree_util.tree_flatten_with_path(converted[1].params)[0]
    ref = {"/".join(k.key for k in path) for path, g in flat
           if g.ndim in (2, 4)}
    assert set(metrics["grad_stats"]) == ref
    for name, q in metrics["grad_stats"].items():
        g = dict(hydra.named_parameters())[name.replace("/", ".")]
        assert q.shape == (5,) and bool((q[1:] >= q[:-1]).all()), name
        assert g.grad is not None


def test_remat_equals_no_remat_with_dropout():
    cfg, hydra, _, _ = _tiny_state(
        depth_drop_rate=0.5, convolutional_self_attention_dropout_rate=0.5)
    fns = loss_function_builder(cfg["loss"])
    clean = _batch(seed=4)
    n = hydra.no_outputs
    gt = multiscale_targets(clean, n - 1, clip_values=True, round_values=True)
    noisy = torch.round(clean + 10 * torch.randn(
        clean.shape, generator=torch.Generator().manual_seed(5)))
    dw = torch.full((n,), 1.0 / n)
    out = {}
    for remat in (False, True):
        hydra.zero_grad(set_to_none=True)
        gen = torch.Generator().manual_seed(11)
        total, _ = forward_loss(hydra, fns, n, noisy, gt, dw, gen,
                                remat=remat)
        total.backward()
        out[remat] = (float(total.detach()), {n: p.grad.clone()
                                     for n, p in hydra.named_parameters()},
                      gen.get_state())
    assert out[True][0] == out[False][0]
    for name, g in out[False][1].items():
        assert torch.equal(out[True][1][name], g), name
    assert torch.equal(out[True][2], out[False][2])   # same draws consumed
    # the masks did drop something: another seed gives another loss
    other, _ = forward_loss(hydra, fns, n, noisy, gt, dw,
                            torch.Generator().manual_seed(12))
    assert float(other.detach()) != out[False][0]


def test_log_uniform_noise_statistics():
    lo, hi = 1.0, 80.0
    gen = torch.Generator().manual_seed(0)
    s = draw_stds(gen, 20000, lo, hi, "log_uniform").flatten()
    assert float(s.min()) >= lo and float(s.max()) <= hi
    u = (torch.log(s) - np.log(lo)) / (np.log(hi) - np.log(lo))
    assert abs(float(u.mean()) - 0.5) <= 0.03
    assert abs(float((s < np.sqrt(lo * hi)).float().mean()) - 0.5) <= 0.03
    uni = draw_stds(gen, 20000, lo, hi, "uniform").flatten()
    assert float((uni < 10).float().mean()) < 0.15      # uniform: ~11%
    with pytest.raises(ValueError):
        draw_stds(gen, 2, lo, hi, "gaussian")
    x = torch.full((64, 8, 8, 3), 128.0)
    y = corrupt_batch(gen, x, additive_noise=[lo, hi],
                      noise_sampling="log_uniform")
    assert bool(torch.isfinite(y).all()) and bool(torch.equal(y, y.round()))


@pytest.fixture(scope="module")
def converted():
    cfg = _pipeline(None)
    jhydra = jax_model_builder(cfg["model"]).hydra
    params = jax.tree_util.tree_map(np.asarray, jhydra.init(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 32, 32, 3)),
        train=False)["params"])
    hydra = model_builder(cfg["model"]).hydra
    tx, _ = optimizer_builder(cfg["train"]["optimizer"])
    state = create_train_state(hydra, tx, params=params_from_flax(params),
                               device="cpu")
    jstate = jax_create_train_state(jhydra, optax_identity(),
                                    jax.random.PRNGKey(1),
                                    jnp.zeros((1, 32, 32, 3)))
    return jhydra, jstate.replace(params=params), hydra, state


def optax_identity():
    import optax
    return optax.identity()


def test_eval_step_matches_jax(converted):
    jhydra, jstate, hydra, state = converted
    x = np.asarray(_batch(2, 64, seed=8))
    ref = np.asarray(jax.jit(jax_build_eval_step(jhydra))(jstate,
                                                          jnp.asarray(x)))
    got = build_eval_step(hydra)(state, torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 64, 64, 3)
    assert float(np.abs(got - ref).max()) <= 1e-4 * float(np.ptp(ref))


class _Recorder:
    def __init__(self):
        self.values = {}

    def scalars(self, step, values):
        self.values.update(values)

    def histogram(self, *args, **kw):
        pass

    def images(self, *args, **kw):
        pass


def test_noise_sweep_at_zero_matches_jax(converted):
    jhydra, jstate, hydra, state = converted
    clean = np.asarray(_batch(2, 64, seed=9))
    ref, got = _Recorder(), _Recorder()
    jax_loop_module._noise_sweep_eval(jax.jit(jax_build_eval_step(jhydra)),
                                      jstate, jnp.asarray(clean), ref, 1)
    loop_module._noise_sweep_eval(build_eval_step(hydra), state,
                                  torch.from_numpy(clean), got, 1)
    assert set(got.values) == set(ref.values)
    for key in ("eval/mae_noise_0", "eval/psnr_noise_0"):
        assert abs(got.values[key] - ref.values[key]) <= 1e-4, key
    for key, v in got.values.items():
        assert np.isfinite(v), key


def test_weight_stats_match_jax(converted, tmp_path):
    _, jstate, _, state = converted
    ref, got = _Recorder(), _Recorder()
    jax_loop_module._weight_stats(jstate, ref, 1)
    loop_module._weight_stats(state, got, 1)
    assert set(got.values) == set(ref.values)
    for k, v in ref.values.items():
        assert abs(got.values[k] - v) <= 1e-6 * abs(v), k


# ---------------------------------------------------------------- checkpoints

def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    cfg, hydra, tx, state = _tiny_state()
    step = build_train_step(hydra, tx, loss_function_builder(cfg["loss"]),
                            hydra.no_outputs, additive_noise=[1, 5],
                            ema_decay=0.5)
    state.ema_params = {k: v.detach().clone()
                        for k, v in state.params.items()}
    for t in range(2):
        state, _ = step(state, _batch(seed=t))
    state.epoch = 7
    manager = CheckpointManager(str(tmp_path))
    assert manager.save(state)
    _, _, _, fresh = _tiny_state(seed=5)
    fresh = manager.restore(fresh)
    assert (fresh.step, fresh.epoch, fresh.opt_state.count) == (2, 7, 2)
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    for k, v in state.ema_params.items():
        assert torch.equal(fresh.ema_params[k], v), k
    for k, v in state.opt_state.slots.items():
        assert all(torch.equal(a, b)
                   for a, b in zip(fresh.opt_state.slots[k], v)), k
    assert not list(tmp_path.glob(".ckpt-*"))        # no temporary left


def test_checkpoint_keeps_n_and_saves_once_per_step(tmp_path):
    _, _, _, state = _tiny_state()
    manager = CheckpointManager(str(tmp_path), max_to_keep=2,
                                save_interval_steps=2)
    assert manager.latest_step() is None
    for step in range(1, 6):
        state.step = step
        manager.save(state)
    assert manager.all_steps() == [2, 4]           # off-interval skipped
    state.step = 5
    assert manager.save(state, force=True)
    assert manager.all_steps() == [4, 5]
    assert not manager.save(state, force=True)     # idempotent
    assert manager.latest_step() == 5


def test_checkpoint_tolerates_ema_presence_mismatch(tmp_path):
    _, _, _, state = _tiny_state()
    state.ema_params = {k: v.detach().clone() + 1.0
                        for k, v in state.params.items()}
    with_ema = CheckpointManager(str(tmp_path / "ema"))
    with_ema.save(state)
    _, _, _, no_ema = _tiny_state()
    restored = with_ema.restore(no_ema)             # EMA into a state without
    for k, v in state.ema_params.items():
        assert torch.equal(restored.ema_params[k], v), k
    state.ema_params = None
    plain = CheckpointManager(str(tmp_path / "plain"))
    plain.save(state)
    _, _, _, target = _tiny_state()
    target.ema_params = {k: v.detach().clone()
                         for k, v in target.params.items()}
    assert plain.restore(target).ema_params is None  # and the other way


def test_metrics_writer_jsonl(tmp_path):
    writer = MetricsWriter(str(tmp_path))
    writer.scalars(3, {"a": 1.5, "b": np.float32(2.0)})
    writer.histogram(3, "h", np.arange(101, dtype=np.float32))
    writer.close()
    rows = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert rows[0]["step"] == 3 and rows[0]["a"] == 1.5
    assert rows[1]["h/p50"] == 50.0 and rows[1]["h/p1"] == 1.0
    MetricsWriter(str(tmp_path / "off"), enabled=False).scalars(1, {"a": 1})
    assert not (tmp_path / "off").exists()
