"""The port's tools against the JAX package, on the CPU: pruning,
distillation and the bias-free analysis, plus forward mode through the
kernel wrappers.

* Pruning: every strategy on the same seeded arrays equals JAX's
  ``pruning`` bit for bit; ``prune_params`` on the packaged flagship's
  port tensors equals JAX's ``prune_params`` of its flax tree, converted,
  bit for bit; ``get_conv_weights`` lists the same kernels.
* ``train.prune``: the narrowed resnet loop (noise and flips off, so
  both packages see the same batches) from one JAX-init artifact whose
  kernels keep clear of the threshold: zeros in the same places as
  JAX's loop in the params and the EMA, every tensor within 1e-3 of its
  largest magnitude (Adam's first steps normalize the gradients that are
  near zero, where the two packages' float32 sums differ, so such an
  entry moves by a few percent of the rate more or less: 2.5e-4 read),
  and the epoch's checkpoint holds the pruned state.
* Distillation: a narrowed flagship step with a teacher output against
  ``jax.grad`` of the JAX step's ``forward_loss`` (built with the same
  ``distill_weight`` / ``distill_gt_weight``): the loss and every metric
  within 1e-4 relative, every gradient within 1e-4 of its tensor's
  largest entry, at ``gt_weight`` 0.5 and 0. ``build_teacher``: JAX's
  ``ValueError`` messages; a float32 teacher's output against JAX's
  (1e-3 gray levels); a bf16 teacher's parameters, output dtype and
  shape; JAX's ``test_train_loop_distillation_end_to_end`` on the port's
  loop.
* Analysis on a narrowed flagship in float32: ``adaptive_filters`` rows
  and ``net_bias_map`` within 1e-4 of each row's (map's) largest entry of
  JAX's. JAX takes its double-vjp fallback there (its FastLayerNorm has
  a custom VJP) and the port forward mode, so the two modes agree.
  ``scale_equivariance`` and the report's keys and numbers against
  JAX's ``analyze``; the CLI; the fallback on a ``torch.autograd.
  Function`` without ``jvp``, and a user's ``TypeError`` surfacing;
  JAX's out-of-range pixel and channel errors.
* Neither the port nor ``chip_smoke.py`` has an import of JAX, flax or
  the JAX package (by grep), and the tools run with those blocked.
* Forward mode: K2's ``jvp`` against a central difference (float64,
  1e-6) and against reverse mode (exact); a ConvNext unit on a dual
  input runs its branch and its tangent equals the reverse-mode product
  (1e-5); ``convnext_block`` and ``band_split`` refuse a dual tensor.
"""

import copy
import json
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad

import blind_image_denoising_torch as bidt
from blind_image_denoising_tpu import analysis as janalysis
from blind_image_denoising_tpu import pruning as jpruning
from blind_image_denoising_tpu.inference.denoiser import (
    Denoiser as JaxDenoiser)
from blind_image_denoising_tpu.inference.export import save_params_artifact
from blind_image_denoising_tpu.models.hydra import (
    model_builder as jax_model_builder)
from blind_image_denoising_tpu.ops.multiscale import (
    multiscale_targets as jax_multiscale_targets)
from blind_image_denoising_tpu.training import (
    build_train_step as jax_build_train_step,
    loss_function_builder as jax_loss_function_builder,
    optimizer_builder as jax_optimizer_builder)
from blind_image_denoising_tpu.training import distill as jdistill
from blind_image_denoising_tpu.training import train_loop as jax_loop_module
from blind_image_denoising_torch import analysis, pruning
from blind_image_denoising_torch import analyze as analyze_cli
from blind_image_denoising_torch.inference.denoiser import Denoiser
from blind_image_denoising_torch.layers.convnext import ConvNextBlock
from blind_image_denoising_torch.models.hydra import model_builder
from blind_image_denoising_torch.ops import pallas_convnext, pallas_pyramid
from blind_image_denoising_torch.ops.multiscale import multiscale_targets
from blind_image_denoising_torch.ops.regularizers import regularization_loss
from blind_image_denoising_torch.training import (
    build_train_step, create_train_state, forward_loss,
    loss_function_builder, optimizer_builder)
from blind_image_denoising_torch.training import distill
from blind_image_denoising_torch.training import train_loop as loop_module
from blind_image_denoising_torch.training.checkpoint import CheckpointManager
from blind_image_denoising_torch.weights import load_msgpack, params_from_flax

FLAGSHIP = "unet_laplacian_v6_tpu_scratch"
CONFIG = "unet_laplacian_v6_tpu"
RESNET = "resnet_color_1x6_bn_32x128x32_1x3x1_128x128_depthwise_l1_relu"
REPO = str(pathlib.Path(__file__).resolve().parent.parent)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)),
                                                 1e-30))


def _images(n, h, w, seed):
    """Smooth fields with an edge, [n, h, w, 3] float32 in [0, 255]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((n, h, w, 3), np.float32)
    for i in range(n):
        a = rng.uniform(0.5, 3.0, 3)
        out[i] = 127.5 + 90 * np.stack(
            [np.sin(a[c] * yy / h * 6 + a[(c + 1) % 3] * xx / w * 4)
             for c in range(3)], -1)
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        out[i, y0:y0 + h // 3, x0:x0 + w // 3] = rng.uniform(20, 235, 3)
    return np.clip(out, 0, 255)


def _narrow_flagship():
    """The flagship config narrowed: depth 3 (three output scales, K2 at
    levels 0 and 1), filters 8, widths [1, 1, 1], kernels [3, 5, 5],
    drop-path and attention dropout off."""
    cfg = copy.deepcopy(bidt.CONFIGS_DICT[CONFIG])
    cfg["model"]["backbone"].update(
        depth=3, filters=8, width=[1, 1, 1], encoder_kernel_size=[3, 5, 5],
        decoder_kernel_size=[3, 5, 5], depth_drop_rate=0.0,
        convolutional_self_attention_dropout_rate=0.0)
    cfg["model"]["denoiser"]["filters"] = 8
    cfg["tpu"] = {"compute_dtype": "float32"}
    return cfg


def _draw(shapes, seed):
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if len(leaf.shape) == 4:
            fan_in = int(np.prod(leaf.shape[:3]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape)
        if str(path[-1].key) == "scale":
            return rng.uniform(0.8, 1.2, leaf.shape)
        return rng.normal(0, 0.05, leaf.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, l: draw(p, l).astype(np.float32), shapes)


@pytest.fixture(scope="module")
def narrow():
    """The narrowed flagship's config, its seeded flax params and the
    JAX hydra."""
    cfg = _narrow_flagship()
    jhydra = jax_model_builder(copy.deepcopy(cfg["model"])).hydra
    shapes = jax.eval_shape(lambda: jhydra.init(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, 32, 32, 3), jnp.float32), train=False))["params"]
    return cfg, _draw(shapes, 5), jhydra


# ----------------------------------------------------------------- pruning

_STRATEGIES = [
    {"strategy": "NONE"},
    {"strategy": "MINIMUM_THRESHOLD", "config": {"minimum_threshold": 0.05}},
    {"strategy": "MINIMUM_THRESHOLD_BIFURCATE",
     "config": {"minimum_threshold": 0.05, "seed": 3}},
    {"strategy": "MINIMUM_THRESHOLD_SHRINKAGE",
     "config": {"minimum_threshold": 0.02, "shrinkage": 0.5,
                "shrinkage_threshold": 0.08}},
    {"strategy": "PCA_PROJECTION", "config": {"variance": 0.9}},
    {"strategy": "PCA_PROJECTION", "config": {"variance": 0.7,
                                              "scale": False}},
    {"strategy": "DROP_BOTTOM", "config": {"percentage": 0.3}},
]


@pytest.mark.parametrize("spec", _STRATEGIES,
                         ids=lambda s: json.dumps(s.get("config", {}))
                         + s["strategy"])
def test_prune_strategies_match_jax_bit_for_bit(spec):
    rng = np.random.default_rng(7)
    for shape in ((3, 3, 8, 16), (1, 1, 32, 8), (5, 5, 1, 12), (16,)):
        w = rng.normal(0, 0.08, shape).astype(np.float32)
        ref = jpruning.prune_function_builder(spec)(w.copy())
        got = pruning.prune_function_builder(spec)(w.copy())
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    assert pruning.PruneStrategy.from_string(" pca_projection ") is \
        pruning.PruneStrategy.PCA_PROJECTION
    assert [s.name for s in pruning.PruneStrategy] == [
        s.name for s in jpruning.PruneStrategy]
    for bad in (None, "", 3):
        with pytest.raises(ValueError):
            pruning.PruneStrategy.from_string(bad)


@pytest.mark.parametrize("spec", _STRATEGIES[1:],
                         ids=lambda s: json.dumps(s.get("config", {}))
                         + s["strategy"])
def test_prune_params_on_the_flagship_matches_jax(spec):
    tree = load_msgpack(bidt.models[FLAGSHIP]["directory"]
                        + "/params.msgpack")
    tree = tree.get("params", tree)
    ref = params_from_flax(jpruning.prune_params(
        tree, jpruning.prune_function_builder(spec)))
    ref = {k: torch.from_numpy(np.asarray(v)) for k, v in ref.items()}
    port = params_from_flax(tree)
    got = pruning.prune_params(port, pruning.prune_function_builder(spec))
    assert set(got) == set(ref) == set(port)
    changed = 0
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
        changed += not torch.equal(v, port[k])
    assert changed > 0
    # a flax tree in: the flax tree out, as JAX's
    flax_out = pruning.prune_params(tree, pruning.prune_function_builder(
        spec))
    assert params_from_flax(flax_out).keys() == got.keys()
    kernels = pruning.get_conv_weights(port)
    jkernels = jpruning.get_conv_weights(tree)
    assert len(kernels) == len(jkernels) > 0
    for a, b in zip(kernels, jkernels):
        np.testing.assert_array_equal(a, b)


_THRESHOLD = 0.02


def _prune_pipeline():
    cfg = copy.deepcopy(bidt.CONFIGS_DICT[RESNET])
    cfg["model"]["backbone"].update(filters=8, no_layers=2,
                                    block_filters=[8, 32, 8])
    cfg["train"].update(
        total_steps=3, checkpoint_every=3, visualization_every=-1,
        log_every=1, gpu_batches_per_step=2, use_test_images=False,
        ema=0.5, prune={"strategy": "MINIMUM_THRESHOLD",
                        "config": {"minimum_threshold": _THRESHOLD},
                        "every_epochs": 1})
    cfg["dataset"].update(inputs=[], input_shape=[32, 32, 3], batch_size=2,
                          no_crops_per_image=1, additional_noise=[],
                          multiplicative_noise=[], random_left_right=False,
                          random_up_down=False)
    cfg["tpu"] = {"compute_dtype": "float32"}
    return cfg


def test_loop_prune_matches_jax(tmp_path):
    """Three steps of the narrowed resnet with ``train.prune`` from one
    JAX-init artifact whose kernels keep out of [t/2, 2t] (three Adam
    steps move a weight by a few times the rate, far less), so both
    loops zero the same entries."""
    cfg = _prune_pipeline()
    jhydra = jax_model_builder(copy.deepcopy(cfg["model"])).hydra
    params = jax.tree_util.tree_map(np.asarray, jhydra.init(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 32, 32, 3)),
        train=False)["params"])

    def clear(path, w):
        if w.ndim != 4:
            return w
        band = (np.abs(w) >= _THRESHOLD / 2) & (np.abs(w) < _THRESHOLD * 2)
        return np.where(band, np.sign(w) * _THRESHOLD * 2.5, w).astype(
            np.float32)

    params = jax.tree_util.tree_map_with_path(clear, params)
    artifact = save_params_artifact(params, cfg, tmp_path / "artifact")
    jstate = jax_loop_module.train_loop(cfg, tmp_path / "jax",
                                        weights_directory=artifact)
    state = loop_module.train_loop(cfg, tmp_path / "port",
                                   weights_directory=artifact, device="cpu")
    assert int(jstate.epoch) == state.epoch == 1
    for ref_tree, got in ((jstate.params, state.params),
                          (jstate.ema_params, state.ema_params)):
        ref = params_from_flax(jax.tree_util.tree_map(np.asarray, ref_tree))
        assert set(ref) == set(got)
        zeros = 0
        for k, v in ref.items():
            g = got[k].detach()
            if v.ndim == 4 or (v.ndim == 2 and ".conv_" in k):
                assert torch.equal(g == 0, v == 0), k
                zeros += int((v == 0).sum())
            assert _rel(g.numpy(), v.numpy()) <= 1e-3, k
        assert zeros > 0
    # the epoch's checkpoint (step 3, also a checkpoint_every step) holds
    # the pruned params and EMA
    manager = CheckpointManager(str(tmp_path / "port"))
    ckpt = manager.read(manager.latest_step())
    for k, v in state.params.items():
        assert torch.equal(ckpt["model"][k], v.detach()), k
        assert torch.equal(ckpt["ema_params"][k], state.ema_params[k]), k


# ------------------------------------------------------------ distillation

def _jax_grad_fn(jhydra, cfg, n_outputs, **kw):
    """``jax.grad(forward_loss)`` of the JAX train step, from its
    closure (``tests/test_torch_training.py``)."""
    tx, _ = jax_optimizer_builder(cfg["train"]["optimizer"])
    step = jax_build_train_step(jhydra, tx,
                                jax_loss_function_builder(cfg["loss"]),
                                n_outputs, **kw)
    cells = dict(zip(step.__code__.co_freevars,
                     (c.cell_contents for c in step.__closure__)))
    return jax.jit(cells["grad_fn"])


@pytest.mark.parametrize("gt_weight", [0.5, 0.0])
def test_distilled_step_matches_jax(narrow, gt_weight):
    cfg, params, jhydra = narrow
    rng = np.random.default_rng(2)
    clean = np.round(_images(2, 64, 64, 2))
    noisy = np.clip(np.round(clean + rng.normal(0, 20, clean.shape)),
                    0, 255).astype(np.float32)
    teacher = np.clip(clean + rng.normal(0, 3, clean.shape), 0,
                      255).astype(np.float32)
    dw = np.asarray([0.5, 0.3, 0.2], np.float32)
    jgt = jax_multiscale_targets(jnp.asarray(clean), 2, clip_values=True,
                                 round_values=True)
    jgrads, (_, jmetrics) = _jax_grad_fn(
        jhydra, cfg, 3, teacher_fn=lambda n: n, distill_weight=1.5,
        distill_gt_weight=gt_weight)(
        params, {}, jnp.asarray(noisy), jgt, jnp.asarray(dw),
        jax.random.PRNGKey(1), jnp.asarray(teacher))

    hydra = model_builder(copy.deepcopy(cfg["model"])).hydra
    hydra.load_state_dict(params_from_flax(params))
    gt = multiscale_targets(torch.from_numpy(clean), 2, clip_values=True,
                            round_values=True)
    total, metrics = forward_loss(
        hydra, loss_function_builder(cfg["loss"]), 3,
        torch.from_numpy(noisy), gt, torch.from_numpy(dw),
        torch.Generator().manual_seed(0),
        teacher_out=torch.from_numpy(teacher), distill_weight=1.5,
        gt_weight=gt_weight)
    total.backward()
    assert "distill/mae_loss" in metrics and "distill/total_loss" in metrics
    assert set(jmetrics) == set(metrics)
    for k, v in jmetrics.items():
        assert _rel(metrics[k].detach().numpy(), v) <= 1e-4, k
    if gt_weight == 0.0:
        # pure distillation: the total is the distill term and the
        # regularization; the hard-GT losses are still reported
        model_loss = loss_function_builder(cfg["loss"])["model"](
            regularization_loss(hydra))["total_loss"]
        expect = float(metrics["distill/total_loss"] * dw[0] * 1.5
                       + model_loss)
        assert float(metrics["total_loss"]) == pytest.approx(expect,
                                                             rel=1e-5)
        assert float(metrics["scale_0/mae_loss"]) > 0.0
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    named = dict(hydra.named_parameters())
    assert set(ref) == set(named)
    for name, p in named.items():
        assert p.grad is not None, name
        assert _rel(p.grad.numpy(), ref[name].numpy()) <= 1e-4, name


def test_train_step_with_a_teacher_builds_and_runs():
    """``build_train_step(teacher_fn=...)`` on the CPU: the teacher sees
    the corrupted micro-batches, and pure distillation towards a
    constant pulls the student's MAE to it down (JAX's
    ``test_pure_distillation_moves_student_toward_teacher``)."""
    cfg = copy.deepcopy(bidt.CONFIGS_DICT[RESNET])
    cfg["model"]["backbone"].update(filters=4, no_layers=1,
                                    block_filters=[4, 8, 4])
    hydra = model_builder(cfg["model"]).hydra
    tx, _ = optimizer_builder({"type": "adam", "schedule": {
        "type": "cosine_decay",
        "config": {"learning_rate": 0.003, "decay_steps": 1000}}})
    state = create_train_state(hydra, tx, seed=0, device="cpu")
    seen = []

    def teacher_fn(noisy):
        seen.append(tuple(noisy.shape))
        return torch.full_like(noisy, 128.0)

    step = build_train_step(
        hydra, tx, loss_function_builder(
            {"hinge": 0.0, "mae_multiplier": 1.0, "ssim_multiplier": -1.0}),
        hydra.no_outputs, additive_noise=[5, 10], grad_accum=2,
        teacher_fn=teacher_fn, distill_weight=1.0, distill_gt_weight=0.0)
    batch = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 255, (4, 16, 16, 3)).astype(np.float32))
    first = None
    for _ in range(30):
        state, metrics = step(state, batch)
        if first is None:
            first = float(metrics["distill/mae_loss"])
    assert seen[:2] == [(2, 16, 16, 3), (2, 16, 16, 3)]
    assert "distill/total_loss" in metrics
    assert float(metrics["distill/mae_loss"]) < 0.7 * first


_TINY_BACKBONE = {
    "type": "resnet", "input_shape": ["?", "?", 3], "filters": 4,
    "no_layers": 1, "kernel_size": 3, "block_kernels": [3],
    "block_filters": [4], "activation": "relu", "batchnorm": False,
    "value_range": [0, 255], "kernel_regularizer": "l1",
    "kernel_initializer": "glorot_normal"}


def _tiny_teacher_artifact(directory, seed=7):
    model = {"backbone": dict(_TINY_BACKBONE),
             "denoiser": {"use_bias": False, "output_channels": 3}}
    hydra = jax_model_builder(model).hydra
    variables = hydra.init({"params": jax.random.PRNGKey(seed)},
                           jnp.zeros((1, 16, 16, 3)), train=False)
    cfg = {"model": model, "dataset": {"input_shape": [16, 16, 3]}}
    return save_params_artifact(variables["params"], cfg, directory), cfg


@pytest.mark.parametrize("spec", [
    {}, {"teacher": ""}, {"teacher": "x", "dtype": "float16"},
    {"teacher": "x", "weight": -1.0}, {"teacher": "x", "gt_weight": -0.5},
    {"teacher": "x", "weight": 0, "gt_weight": 0}])
def test_build_teacher_errors_match_jax(spec):
    with pytest.raises(ValueError) as ref:
        jdistill.build_teacher(spec)
    with pytest.raises(ValueError) as got:
        distill.build_teacher(spec, device="cpu")
    assert str(got.value) == str(ref.value)


def test_teacher_outputs_match_jax(tmp_path):
    d, _ = _tiny_teacher_artifact(tmp_path / "t")
    noisy = np.random.default_rng(3).uniform(0, 255, (2, 16, 16, 3)).astype(
        np.float32)
    jfn, jopts = jdistill.build_teacher({"teacher": str(d), "weight": 0.5})
    fn, opts = distill.build_teacher({"teacher": str(d), "weight": 0.5},
                                     device="cpu")
    assert opts == jopts == {"weight": 0.5, "gt_weight": 1.0}
    got = fn(torch.from_numpy(noisy))
    assert got.dtype == torch.float32 and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(jfn(
        jnp.asarray(noisy))), atol=1e-3)
    # bf16: every floating parameter cast, a float32 output of the shape
    fn16, _ = distill.build_teacher({"teacher": str(d), "dtype": "bfloat16"},
                                    device="cpu")
    jfn16, _ = jdistill.build_teacher({"teacher": str(d),
                                       "dtype": "bfloat16"})
    y16 = fn16(torch.zeros((1, 16, 16, 3)))
    jy16 = jfn16(jnp.zeros((1, 16, 16, 3), jnp.float32))
    assert y16.dtype == torch.float32 and jy16.dtype == jnp.float32
    assert tuple(y16.shape) == jy16.shape == (1, 16, 16, 3)
    model = fn16.__closure__[[c for c in fn16.__code__.co_freevars].index(
        "model")].cell_contents
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad
               for p in model.parameters())


def test_train_loop_distillation_end_to_end(tmp_path):
    """JAX's ``test_train_loop_distillation_end_to_end`` on the port's
    loop: a teacher artifact directory, two steps, the distill metrics
    in ``metrics.jsonl``."""
    teacher_dir, _ = _tiny_teacher_artifact(tmp_path / "teacher")
    cfg = {
        "model": {"backbone": dict(_TINY_BACKBONE),
                  "denoiser": {"use_bias": False, "output_channels": 3}},
        "train": {"epochs": 1, "total_steps": 2, "checkpoint_every": -1,
                  "visualization_every": -1, "use_test_images": False,
                  "optimizer": {"type": "adam", "schedule": {
                      "type": "cosine_decay", "config": {
                          "learning_rate": 0.001, "decay_steps": 100}}},
                  "distillation": {"teacher": str(teacher_dir),
                                   "weight": 1.0, "gt_weight": 0.5}},
        "loss": {"hinge": 0.0, "mae_multiplier": 1.0,
                 "ssim_multiplier": -1.0},
        "dataset": {"batch_size": 2, "input_shape": [16, 16, 3],
                    "additional_noise": [1, 10], "inputs": []},
    }
    state = loop_module.train_loop(cfg, tmp_path / "ckpt", device="cpu")
    assert state.step == 2
    lines = [json.loads(line) for line in
             (tmp_path / "ckpt" / "metrics.jsonl").read_text().splitlines()]
    vals = [rec["distill/mae_loss"] for rec in lines
            if "distill/mae_loss" in rec]
    assert len(vals) == 2 and all(np.isfinite(v) and v > 0 for v in vals)


# ---------------------------------------------------------------- analysis

@pytest.fixture(scope="module")
def analyzed(narrow):
    """JAX's and the port's Denoiser on the narrowed flagship (f32, pad
    multiple 16), a noisy 32² image, and JAX's filters and bias map."""
    cfg, params, jhydra = narrow
    image = np.clip(np.round(_images(1, 32, 32, 9)[0] + np.random.default_rng(
        9).normal(0, 25, (32, 32, 3))), 0, 255).astype(np.float32)
    jden = JaxDenoiser(jhydra, {"params": params}, pad_multiple=16)
    model = model_builder(copy.deepcopy(cfg["model"])).hydra
    den = Denoiser(model, {"params": params}, pad_multiple=16, device="cpu")
    pixels = [(5, 7), (16, 16), (28, 3)]
    jfwd = janalysis.forward_from_denoiser(jden)
    ref_filters = janalysis.adaptive_filters(jfwd, image, pixels)
    ref_bias = janalysis.net_bias_map(jfwd, image)
    return dict(image=image, jden=jden, den=den, pixels=pixels,
                filters=ref_filters, bias=ref_bias)


@pytest.mark.parametrize("channel", [None, 1])
def test_adaptive_filters_match_jax(analyzed, channel):
    fwd = analysis.forward_from_denoiser(analyzed["den"])
    res = analysis.adaptive_filters(fwd, analyzed["image"],
                                    analyzed["pixels"], channel=channel)
    if channel is None:
        ref = analyzed["filters"]
    else:
        ref = janalysis.adaptive_filters(
            janalysis.forward_from_denoiser(analyzed["jden"]),
            analyzed["image"], analyzed["pixels"], channel=channel)
    assert res.filters.shape == ref.filters.shape == (3, 32, 32, 3)
    for got_row, ref_row in zip(res.filters, ref.filters):
        assert _rel(got_row, ref_row) <= 1e-4
    for key in ("outputs", "bias", "weight_sum"):
        np.testing.assert_allclose(getattr(res, key), getattr(ref, key),
                                   atol=1e-3, err_msg=key)
    np.testing.assert_allclose(res.denoised, ref.denoised, atol=1e-3)
    assert res.pixels == analyzed["pixels"]


def test_net_bias_map_matches_jax(analyzed):
    fwd = analysis.forward_from_denoiser(analyzed["den"])
    y, bias = analysis.net_bias_map(fwd, analyzed["image"])
    ref_y, ref_bias = analyzed["bias"]
    assert y.shape == bias.shape == (32, 32, 3)
    np.testing.assert_allclose(y, ref_y, atol=1e-3)
    assert _rel(bias, ref_bias) <= 1e-4
    # the filters' own decomposition agrees: b_p = y_p − c − <a_p, x − c>
    res = analyzed["filters"]
    for (r, c), b in zip(res.pixels, res.bias):
        assert abs(float(bias[r, c].mean()) - float(b)) <= 1e-2


def test_net_bias_map_takes_forward_mode_through_k2(analyzed, monkeypatch):
    """The port's flagship takes forward mode, not the fallback: K2's
    ``jvp`` runs once per split level on the tangent."""
    calls = {"forward": 0, "jvp": 0}
    for name in calls:
        real = getattr(pallas_pyramid._BandSmooth, name)

        def counting(ctx, *a, _real=real, _name=name):
            calls[_name] += 1
            return _real(ctx, *a)

        monkeypatch.setattr(pallas_pyramid._BandSmooth, name,
                            staticmethod(counting))
    monkeypatch.setattr(analysis, "_reverse_over_reverse", None)
    analysis.net_bias_map(analysis.forward_from_denoiser(analyzed["den"]),
                          analyzed["image"])
    assert calls["jvp"] == calls["forward"] == 2


def test_scale_equivariance_and_report_match_jax(analyzed):
    alphas = (0.5, 0.75)
    report, res, denoised, bias_map = analysis.analyze(
        analyzed["den"], analyzed["image"], pixels=analyzed["pixels"],
        alphas=alphas, mass_radius=6)
    jreport, jres, _, _ = janalysis.analyze(
        analyzed["jden"], analyzed["image"], pixels=analyzed["pixels"],
        alphas=alphas, mass_radius=6)
    json.dumps(report)
    assert set(report) == set(jreport) == {"net_bias", "scale_equivariance",
                                           "filters"}
    assert set(report["net_bias"]) == set(jreport["net_bias"])
    for k, v in jreport["net_bias"].items():
        assert report["net_bias"][k] == pytest.approx(v, rel=1e-3, abs=1e-4)
    assert len(report["scale_equivariance"]) == len(alphas)
    for got, ref in zip(report["scale_equivariance"],
                        jreport["scale_equivariance"]):
        assert set(got) == set(ref) and got["alpha"] == ref["alpha"]
        assert got["rel_error"] == pytest.approx(ref["rel_error"], abs=1e-4)
    for got, ref in zip(report["filters"], jreport["filters"]):
        assert set(got) == set(ref) and got["pixel"] == ref["pixel"]
        for k in ("output", "bias", "weight_sum", "mass_within_6px"):
            assert got[k] == pytest.approx(ref[k], abs=1e-3), k
    assert denoised.shape == bias_map.shape == (32, 32, 3)
    assert analysis.grid_pixels((128, 96), n=3) == janalysis.grid_pixels(
        (128, 96), n=3)
    np.testing.assert_allclose(
        analysis.filter_mass_within(res.filters, res.pixels, 3),
        janalysis.filter_mass_within(jres.filters, jres.pixels, 3),
        atol=1e-4)
    assert analysis.__all__ == janalysis.__all__
    assert analysis.DEFAULT_CENTER == janalysis.DEFAULT_CENTER


def test_analysis_errors_match_jax(analyzed):
    fwd = analysis.forward_from_denoiser(analyzed["den"])
    x = analyzed["image"]
    with pytest.raises(ValueError, match="outside image"):
        analysis.adaptive_filters(fwd, x, [(32, 3)])
    with pytest.raises(ValueError, match="channel"):
        analysis.adaptive_filters(fwd, x, [(8, 8)], channel=3)
    with pytest.raises(ValueError, match="channel"):
        analysis.adaptive_filters(fwd, x, [(8, 8)], channel=-4)
    r_neg = analysis.adaptive_filters(fwd, x, [(8, 8)], channel=-1)
    r_pos = analysis.adaptive_filters(fwd, x, [(8, 8)], channel=2)
    np.testing.assert_array_equal(r_neg.filters, r_pos.filters)
    with pytest.raises(TypeError):
        analysis.forward_from_denoiser(lambda v: v)
    with pytest.raises(TypeError):
        analysis.forward_from_denoiser(analyzed["jden"])


def test_net_bias_map_fallback_on_a_function_without_jvp():
    """A ``torch.autograd.Function`` with no ``jvp`` has no forward mode:
    the reverse-over-reverse fallback gives the exact affine map's zero
    bias; a user's own ``TypeError`` surfaces (JAX's
    ``test_net_bias_map_fallback_engages_on_custom_vjp``)."""
    c = analysis.DEFAULT_CENTER

    class ScaleOnly(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return (x - c) * 0.25 + c

        @staticmethod
        def backward(ctx, g):
            return g * 0.25

    x = np.random.default_rng(23).uniform(60, 200, (8, 8, 3)).astype(
        np.float32)
    y, bias = analysis.net_bias_map(ScaleOnly.apply, x)
    np.testing.assert_allclose(bias, 0.0, atol=1e-4)
    np.testing.assert_allclose(y, (x - c) * 0.25 + c, atol=1e-4)

    def broken(v):
        raise TypeError("user bug, not a custom-VJP limitation")

    with pytest.raises(TypeError, match="user bug"):
        analysis.net_bias_map(broken, x)


def test_analyze_cli(tmp_path, capsys):
    rc = analyze_cli.main(["--model", FLAGSHIP, "--device", "cpu", "--size",
                           "32", "--grid", "2", "--noise-std", "10",
                           "--mass-radius", "6", "--output-dir",
                           str(tmp_path / "figs")])
    assert rc == 0
    report = json.loads(capsys.readouterr().out)
    assert set(report) == {"net_bias", "scale_equivariance", "filters",
                           "model", "noise_std"}
    assert len(report["filters"]) == 4 and report["noise_std"] == 10.0
    assert all(np.isfinite(f["weight_sum"]) for f in report["filters"])
    assert set(report["filters"][0]) == {"pixel", "output", "bias",
                                         "weight_sum", "mass_within_6px"}
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return
    assert (tmp_path / "figs" / "filters.png").is_file()
    assert (tmp_path / "figs" / "bias_map.png").is_file()


# ------------------------------------------------------------ forward mode

def test_band_smooth_jvp_matches_difference_and_reverse_mode():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 9, 7, 4)))
    v = torch.from_numpy(rng.normal(size=(2, 9, 7, 4)))
    for k in (2, 3):
        with forward_ad.dual_level():
            band, smooth = pallas_pyramid.band_smooth(
                forward_ad.make_dual(x, v), k)
            tb = forward_ad.unpack_dual(band).tangent
            ts = forward_ad.unpack_dual(smooth).tangent
        eps = 1e-6
        plus = pallas_pyramid.band_smooth_plain(x + eps * v, k)
        minus = pallas_pyramid.band_smooth_plain(x - eps * v, k)
        for t, p, m in ((tb, plus[0], minus[0]), (ts, plus[1], minus[1])):
            np.testing.assert_allclose(t.numpy(), ((p - m) / (2 * eps))
                                       .numpy(), atol=1e-6)
        # reverse mode: <g, J v> == <J^T g, v>
        gb, gs = torch.randn_like(x), torch.randn_like(x)
        xr = x.clone().requires_grad_(True)
        b2, s2 = pallas_pyramid.band_smooth(xr, k)
        (jt,) = torch.autograd.grad((b2 * gb).sum() + (s2 * gs).sum(), xr)
        assert float((tb * gb).sum() + (ts * gs).sum()) == pytest.approx(
            float((jt * v).sum()), rel=1e-10)


def test_convnext_unit_on_a_dual_tensor_runs_its_branch():
    torch.manual_seed(0)
    unit = ConvNextBlock(32, kernel_size=3, expansion=128)
    assert unit.kernel_route
    with torch.no_grad():
        for p in unit.parameters():
            p.normal_(0, 0.2)
    unit.requires_grad_(False)
    x, v = torch.randn(2, 32, 8, 8), torch.randn(2, 32, 8, 8)
    with torch.no_grad(), forward_ad.dual_level():
        y = unit(forward_ad.make_dual(x, v))
        tangent = forward_ad.unpack_dual(y).tangent
    assert tangent is not None
    xr = x.clone().requires_grad_(True)
    g = torch.randn_like(x)
    (jt,) = torch.autograd.grad((unit(xr) * g).sum(), xr)
    assert float((tangent * g).sum()) == pytest.approx(float((jt * v).sum()),
                                                       rel=1e-5)
    w = unit.kernel_weights(torch.float32)
    with forward_ad.dual_level():
        dual = forward_ad.make_dual(x.permute(0, 2, 3, 1).contiguous(),
                                    v.permute(0, 2, 3, 1).contiguous())
        with pytest.raises(RuntimeError, match="forward-mode"):
            pallas_convnext.convnext_block(dual, slope=unit.slope, **w)
        with pytest.raises(RuntimeError, match="tangent"):
            pallas_pyramid.band_split(dual)


# ------------------------------------------------------------ no JAX inside

_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|blind_image_denoising_tpu)\b")


def test_port_and_chip_smoke_import_no_jax_by_grep():
    files = sorted(pathlib.Path(REPO, "blind_image_denoising_torch").rglob(
        "*.py")) + [pathlib.Path(REPO, "chip_smoke.py")]
    assert len(files) > 50
    bad = [f"{f}:{i}" for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if _IMPORT.match(line)]
    assert not bad, bad


def test_tools_run_with_jax_blocked():
    code = (
        "import sys\n"
        "BLOCKED = ('jax', 'jaxlib', 'flax', 'msgpack',\n"
        "           'blind_image_denoising_tpu')\n"
        "class _Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, _Block())\n"
        "import numpy as np\n"
        "import blind_image_denoising_torch as bidt\n"
        "from blind_image_denoising_torch import analysis, analyze, pruning\n"
        "from blind_image_denoising_torch import layers, ops, models\n"
        "from blind_image_denoising_torch.training import distill\n"
        "den = bidt.load_model('unet_laplacian_v6_tpu_scratch',\n"
        "                      device='cpu', dtype='float32')\n"
        "img = np.full((32, 32, 3), 120.0, np.float32)\n"
        "img[8:20, 4:30] = 40.0\n"
        "report = analysis.analyze(den, img, alphas=(0.5,))[0]\n"
        "assert set(report) == {'net_bias', 'scale_equivariance',\n"
        "                       'filters'}\n"
        "fn, _ = distill.build_teacher(\n"
        "    {'teacher': 'unet_laplacian_v56_highnoise'}, device='cpu')\n"
        "import torch\n"
        "assert fn(torch.zeros(1, 32, 32, 3)).shape == (1, 32, 32, 3)\n"
        "pruned = pruning.prune_params(dict(den.model.named_parameters()),\n"
        "    pruning.prune_function_builder({'strategy': 'DROP_BOTTOM',\n"
        "        'config': {'percentage': 0.5}}))\n"
        "assert len(pruned) == len(list(den.model.parameters()))\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in BLOCKED]\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
