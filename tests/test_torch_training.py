"""The port's train step against the JAX package, on the CPU, float32.

* Ops: ``multiscale_targets`` bit-equal; ``mae``/``rmse`` with the 1.5
  hinge and ``ssim`` (filter 7) within 1e-5 relative.
* Regularization: ``regularization_loss`` on the packaged flagship
  against ``sum_losses_collection`` of JAX ``hydra.apply(...,
  mutable=["losses"])`` on the same weights, 1e-5 relative.
* Stochastic depth and attention dropout: the mask shape (per sample /
  per element), the keep rate within ±0.03 of 1 − rate on thousands of
  draws, the 1/(1 − rate) scale, and the identity when not training.
* Optimizer: one and three steps of the port's clip + Adam chain against
  optax's chain from JAX ``optimizer_builder`` on the flagship's
  ``train.optimizer`` with fixed gradients, and three steps of amsgrad,
  RMSprop (plain; centered with momentum), Adadelta (at rate 1) and
  clipping by value with a global-norm clip: params within 1e-6
  relative, the updates within 1e-4 of their largest entry (the other
  rules: plus two float32 spacings of the param, since the applied step
  is read back as a difference of params); per-tensor clipping engages
  above norm 1. The schedules match JAX within 1e-6 relative.
* The slice as a whole: a narrow config with every flagship option on
  (depth 3, filters 8, widths [1, 2, 2], kernels [3, 5, 5], attention,
  output norm, soft-orthonormal), drop-path and dropout at 0, one
  injected noisy batch at 64²: the total loss and every per-scale metric
  within 1e-4 relative, and every gradient within 1e-4 of its tensor's
  largest entry, against ``jax.grad`` of the JAX step's own
  ``forward_loss`` (taken from the ``build_train_step`` closure); every
  parameter receives a nonzero gradient.
* JAX's own bf16-vs-f32 gradient cosine on the packaged flagship, beside
  the port's on the same batch (measured; bar 0.99 for both).
* The packaged flagship at full width through ``build_train_step`` for
  one step at b1 @ 64² with the noise kernel's plain path: the loss is
  finite, every parameter moves, and the fused inference unit K1 is never
  called. Drop-path is off there: at batch 1 a dropped unit's LayerNorm
  scale gets no gradient and could not move.
* Fine-tuning the packaged flagship at the config's peak rate: one Adam
  step at 1e-3 on one injected b2 @ 64² batch, JAX and the port, the
  loss before (1e-4 relative) and after the step (1e-3) held together.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import blind_image_denoising_torch as bidt
from blind_image_denoising_tpu.models.hydra import (
    model_builder as jax_model_builder)
from blind_image_denoising_tpu.ops.losses import mae as jax_mae
from blind_image_denoising_tpu.ops.losses import rmse as jax_rmse
from blind_image_denoising_tpu.ops.multiscale import (
    multiscale_targets as jax_multiscale_targets)
from blind_image_denoising_tpu.ops.ssim import ssim as jax_ssim
from blind_image_denoising_tpu.training import (
    build_train_step as jax_build_train_step,
    loss_function_builder as jax_loss_function_builder,
    optimizer_builder as jax_optimizer_builder)
from blind_image_denoising_tpu.training.losses import sum_losses_collection
from blind_image_denoising_tpu.training.optimizer import (
    clip_by_per_tensor_norm as jax_clip_by_per_tensor_norm,
    schedule_builder as jax_schedule_builder)
from blind_image_denoising_torch.config import load_config
from blind_image_denoising_torch.layers import attention as attention_mod
from blind_image_denoising_torch.layers import convnext as convnext_mod
from blind_image_denoising_torch.layers.attention import (
    ConvolutionalSelfAttention)
from blind_image_denoising_torch.layers.stochastic import StochasticDepth
from blind_image_denoising_torch.models.hydra import model_builder
from blind_image_denoising_torch.ops.losses import mae, rmse
from blind_image_denoising_torch.ops.multiscale import multiscale_targets
from blind_image_denoising_torch.ops.regularizers import regularization_loss
from blind_image_denoising_torch.ops.ssim import ssim
from blind_image_denoising_torch.training import (
    build_train_step, create_train_state, forward_loss,
    loss_function_builder, optimizer_builder, schedule_builder)
from blind_image_denoising_torch.training.optimizer import (
    clip_by_global_norm, clip_by_per_tensor_norm)
from blind_image_denoising_torch.training.train_state import init_params
from blind_image_denoising_torch.weights import load_msgpack, params_from_flax

FLAGSHIP = "unet_laplacian_v6_tpu_scratch"
CONFIG = "unet_laplacian_v6_tpu"


def _config():
    return copy.deepcopy(load_config(bidt.CONFIGS_DICT[CONFIG]))


def _images(n, h, w, seed):
    """Smooth fields with edges in [0, 255], [n, h, w, 3] float32."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((n, h, w, 3), np.float32)
    for i in range(n):
        a = rng.uniform(0.5, 3.0, 3)
        out[i] = 127.5 + 100 * np.stack(
            [np.sin(a[c] * yy / h * 6 + a[(c + 1) % 3] * xx / w * 4)
             for c in range(3)], -1)
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        out[i, y0:y0 + h // 3, x0:x0 + w // 3] = rng.uniform(0, 255, 3)
    return np.clip(out, 0, 255)


def _rel(got, ref):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(ref)))
                 / max(float(np.max(np.abs(np.asarray(ref)))), 1e-30))


# ---------------------------------------------------------------- ops

def test_multiscale_targets_match_jax():
    x = _images(2, 64, 48, 0) + 0.25
    got = multiscale_targets(torch.from_numpy(x), 3, clip_values=True,
                             round_values=True)
    ref = jax_multiscale_targets(jnp.asarray(x), 3, clip_values=True,
                                 round_values=True)
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_losses_and_ssim_match_jax():
    rng = np.random.default_rng(1)
    gt = np.round(_images(3, 40, 36, 1))
    pred = np.clip(gt + rng.normal(0, 8, gt.shape), 0, 255).astype(
        np.float32)
    g, p = torch.from_numpy(gt), torch.from_numpy(pred)
    jg, jp = jnp.asarray(gt), jnp.asarray(pred)
    for hinge, cutoff in ((0.0, 255.0), (1.5, 255.0), (1.5, 10.0)):
        assert _rel(mae(g, p, hinge=hinge, cutoff=cutoff),
                    jax_mae(jg, jp, hinge=hinge, cutoff=cutoff)) <= 1e-5
        assert _rel(rmse(g, p, hinge=hinge, cutoff=cutoff ** 2),
                    jax_rmse(jg, jp, hinge=hinge, cutoff=cutoff ** 2)) <= 1e-5
    got = ssim(g, p, max_val=255.0, filter_size=7).numpy()
    ref = np.asarray(jax_ssim(jg, jp, max_val=255.0, filter_size=7))
    assert got.shape == (3,)
    assert _rel(got, ref) <= 1e-5


# ---------------------------------------------------------------- regularization

def test_regularization_sum_matches_jax_losses_collection():
    cfg = load_config(bidt.models[FLAGSHIP]["configuration"])
    tree = load_msgpack(f"{bidt.models[FLAGSHIP]['directory']}/params.msgpack")
    hydra = model_builder(cfg["model"]).hydra
    hydra.load_state_dict(params_from_flax(tree))
    got = float(regularization_loss(hydra).detach())
    jhydra = jax_model_builder(cfg["model"]).hydra
    _, mutated = jhydra.apply(
        {"params": tree["params"] if "params" in tree else tree},
        jnp.zeros((1, 32, 32, 3), jnp.float32), train=True,
        mutable=["losses"], rngs={"dropout": jax.random.PRNGKey(0)})
    ref = float(sum_losses_collection(mutated["losses"]))
    assert ref > 0
    assert abs(got - ref) / ref <= 1e-5


# ---------------------------------------------------------------- dropout

def test_stochastic_depth_mask_per_sample():
    drop = StochasticDepth(0.5)
    x = torch.ones((4000, 2, 3, 3))
    g = torch.Generator().manual_seed(0)
    y = drop(x, train=True, generator=g)
    flat = y.reshape(4000, -1)
    assert bool((flat == flat[:, :1]).all())            # one draw per sample
    assert set(torch.unique(flat).tolist()) <= {0.0, 2.0}   # 1 / (1 - rate)
    assert abs(float((flat[:, 0] > 0).float().mean()) - 0.5) <= 0.03
    assert torch.equal(drop(x, train=False), x)
    assert torch.equal(StochasticDepth(0.0)(x, train=True, generator=g), x)
    with pytest.raises(ValueError):
        drop(x, train=True)                             # no generator


def test_attention_dropout_per_element(monkeypatch):
    torch.manual_seed(0)
    attn = ConvolutionalSelfAttention(8, 8, dropout_rate=0.25)
    for p in attn.parameters():
        torch.nn.init.normal_(p, 0.0, 0.3)
    x = torch.randn((2, 8, 20, 12))
    with torch.no_grad():
        ref = attn(x)
        assert torch.equal(attn(x, train=False,
                                generator=torch.Generator()), ref)
        seen = []
        real = attention_mod.drop_mask

        def spy(shape, rate, generator, device):
            seen.append(real(shape, rate, generator, device))
            return seen[-1]
        monkeypatch.setattr(attention_mod, "drop_mask", spy)
        out = attn(x, train=True, generator=torch.Generator().manual_seed(1))
        assert not torch.allclose(out, ref)
        (mask,) = seen
        assert tuple(mask.shape) == (2, 256, 256)       # one per weight
        assert abs(float(mask.float().mean()) - 0.75) <= 0.03
        # every weight kept: the branch is the eval branch / (1 - rate)
        monkeypatch.setattr(attention_mod, "drop_mask",
                            lambda s, r, g, d: torch.ones(s, dtype=torch.bool))
        out = attn(x, train=True, generator=torch.Generator())
        torch.testing.assert_close(out, ref / 0.75, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- optimizer

def _opt_case(seed):
    rng = np.random.default_rng(seed)
    params = {"a": rng.normal(0, 1, (6, 4)).astype(np.float32),
              "b": rng.normal(0, 0.1, (5,)).astype(np.float32)}
    grads = [{"a": rng.normal(0, s, (6, 4)).astype(np.float32),
              "b": rng.normal(0, 0.01, (5,)).astype(np.float32)}
             for s in (2.0, 0.05, 1.0)]
    return params, grads


# the flagship's optimizer (ADAM, per-tensor clipping) at 1 and 3 steps,
# then the other update rules and clipping by value the JAX builder takes
_OPTIMIZERS = {
    "adam": {}, "amsgrad": dict(amsgrad=True),
    "rmsprop": dict(type="RMSprop", gradient_clipping_by_norm_local=None),
    "rmsprop_centered_momentum": dict(type="RMSprop", centered=True,
                                      momentum=0.9, rho=0.8),
    # Adadelta at its usual rate of 1: at 1e-3 its steps (~3e-6) would
    # vanish under the float32 spacing of the params
    "adadelta": dict(type="ADADELTA", epsilon=1e-6, schedule={
        "type": "exponential_decay", "config": {
            "learning_rate": 1.0, "decay_steps": 1000, "decay_rate": 0.9}}),
    "clip_by_value": dict(gradient_clipping_by_value=0.5,
                          gradient_clipping_by_norm=2.0)}


@pytest.mark.parametrize("n_steps,rule", [
    pytest.param(1, "adam", id="1"), pytest.param(3, "adam", id="3")] + [
    pytest.param(3, rule, id=f"3-{rule}") for rule in _OPTIMIZERS
    if rule != "adam"])
def test_optimizer_matches_optax(n_steps, rule):
    opt_cfg = dict(_config()["train"]["optimizer"], **_OPTIMIZERS[rule])
    opt_cfg = {k: v for k, v in opt_cfg.items() if v is not None}
    params, grads = _opt_case(n_steps)
    tx, _ = jax_optimizer_builder(opt_cfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    port, _ = optimizer_builder(opt_cfg)
    tp = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    tstate = port.init(tp)
    for i in range(n_steps):
        before = [t.clone() for t in tp]
        updates, state = tx.update({k: jnp.asarray(v) for k, v in
                                    grads[i].items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        port.apply(tp, [torch.from_numpy(grads[i][k].copy())
                        for k in ("a", "b")], tstate)
        for j, k in enumerate(("a", "b")):
            delta = tp[j].numpy() - before[j].numpy()
            ref = np.asarray(updates[k])
            if rule == "adam":
                assert _rel(delta, ref) <= 1e-4
            else:
                # the applied step is read back as a difference of float32
                # params, which rounds it by up to 2 spacings of |p|
                spacing = np.spacing(np.abs(before[j].numpy()))
                assert np.all(np.abs(delta - ref) <= 1e-4 * np.abs(
                    ref).max() + 2 * spacing), rule
    assert tstate.count == n_steps
    for j, k in enumerate(("a", "b")):
        np.testing.assert_allclose(tp[j].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)


def test_per_tensor_clip_engages_above_norm_one():
    big = np.full((4, 4), 1.25, np.float32)           # norm 5
    small = np.full((3,), 0.1, np.float32)            # norm 0.17
    grads = [torch.from_numpy(big.copy()), torch.from_numpy(small.copy())]
    clip_by_per_tensor_norm(grads, 1.0)
    assert abs(float(grads[0].norm()) - 1.0) < 1e-6
    assert torch.equal(grads[1], torch.from_numpy(small))
    ref, _ = jax_clip_by_per_tensor_norm(1.0).update(
        {"a": jnp.asarray(big), "b": jnp.asarray(small)}, None)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(ref["a"]),
                               rtol=1e-6)


def test_global_norm_clip_matches_optax():
    rng = np.random.default_rng(7)
    tree = {"a": rng.normal(0, 2, (4, 4)).astype(np.float32),
            "b": rng.normal(0, 1, (3,)).astype(np.float32)}
    for max_norm in (1.0, 100.0):                 # engaged, then not
        grads = [torch.from_numpy(tree[k].copy()) for k in ("a", "b")]
        clip_by_global_norm(grads, max_norm)
        ref, _ = optax.clip_by_global_norm(max_norm).update(
            {k: jnp.asarray(v) for k, v in tree.items()}, None)
        for g, k in zip(grads, ("a", "b")):
            np.testing.assert_allclose(g.numpy(), np.asarray(ref[k]),
                                       rtol=1e-6)


@pytest.mark.parametrize("schedule", [
    {"type": "cosine_decay_restarts",
     "config": {"learning_rate": 0.001, "decay_steps": 40000, "t_mul": 1.1}},
    {"type": "cosine_decay",
     "config": {"learning_rate": 0.001, "decay_steps": 20000, "alpha": 0.02}},
    {"type": "exponential_decay",
     "config": {"learning_rate": 0.01, "decay_steps": 1000,
                "decay_rate": 0.9}},
])
def test_schedules_match_jax(schedule):
    port, ref = schedule_builder(schedule), jax_schedule_builder(schedule)
    for step in (0, 1, 2, 1000, 39999, 40000, 45000, 90000, 200000):
        assert abs(port(step) - float(ref(step))) <= 1e-6 * float(ref(0))


def test_not_ported_options_raise():
    cfg = _config()
    hydra = model_builder(cfg["model"]).hydra
    tx, _ = optimizer_builder(cfg["train"]["optimizer"])
    fns = loss_function_builder(cfg["loss"])
    # rotation and the degradation chain build since slice 12
    for kw in (dict(random_rotate=1.57), dict(use_random_blur=True),
               dict(inpaint_drop_rate=0.5)):
        assert callable(build_train_step(hydra, tx, fns, 3, **kw))
    # a teacher (once item 12) builds and runs since slice 13
    teacher_step = build_train_step(hydra, tx, fns, 3,
                                    teacher_fn=lambda v: v + 1.0,
                                    distill_gt_weight=0.5)
    state = create_train_state(hydra, tx, seed=0, device="cpu")
    _, metrics = teacher_step(state, torch.zeros((1, 64, 64, 3)))
    assert np.isfinite(float(metrics["distill/total_loss"]))
    with pytest.raises(ValueError):
        build_train_step(hydra, tx, fns, 3, use_pallas_noise=True,
                         use_random_blur=True)
    with pytest.raises(ValueError):
        build_train_step(hydra, tx, fns, 3, use_pallas_noise=True,
                         noise_sampling="log_uniform")
    with pytest.raises(ValueError, match="optimizer type"):
        optimizer_builder(dict(cfg["train"]["optimizer"], type="SGD"))


def test_create_train_state_needs_the_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card is the default")
    cfg = _config()
    hydra = model_builder(cfg["model"]).hydra
    tx, _ = optimizer_builder(cfg["train"]["optimizer"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(hydra, tx, seed=0)


def test_seeded_init_statistics():
    hydra = model_builder(_config()["model"]).hydra
    init_params(hydra, torch.Generator().manual_seed(0))
    unit = hydra.backbone.encoder_1_0
    w = unit.conv_2.kernel.detach()              # [256, 64]
    std = np.sqrt(2.0 / (64 + 256))              # glorot: 2 / (fan_in + out)
    assert abs(float(w.std()) / std - 1.0) < 0.05
    assert float(w.abs().max()) <= 2.0 * std / 0.8796 + 1e-6
    assert abs(float(w.mean())) < 0.05 * std
    assert torch.equal(unit.conv_1.ln.scale, torch.ones(64))
    assert float(unit.gamma.w_multiplier.detach().abs().max()) <= 0.02
    stem = hydra.backbone.stem_conv.kernel.detach()   # [32, 3, 5, 5]
    std = np.sqrt(2.0 / (3 * 25 + 32 * 25))
    assert abs(float(stem.std()) / std - 1.0) < 0.1


# ---------------------------------------------------------------- whole slice

def _narrow_model_config():
    mc = copy.deepcopy(_config()["model"])
    mc["backbone"].update(filters=8, width=[1, 2, 2], depth_drop_rate=0.0,
                          convolutional_self_attention_dropout_rate=0.0)
    return mc


def _jax_grad_fn(jhydra, cfg, n_outputs=3):
    """``jax.grad(forward_loss)`` of the JAX train step, from its closure."""
    tx, _ = jax_optimizer_builder(cfg["train"]["optimizer"])
    step = jax_build_train_step(jhydra, tx,
                                jax_loss_function_builder(cfg["loss"]),
                                n_outputs)
    cells = dict(zip(step.__code__.co_freevars,
                     (c.cell_contents for c in step.__closure__)))
    return jax.jit(cells["grad_fn"])


def test_train_loss_and_every_gradient_match_jax():
    cfg = _config()
    mc = _narrow_model_config()
    jhydra = jax_model_builder(mc).hydra
    variables = jhydra.init({"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, 32, 32, 3), jnp.float32),
                            train=False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    rng = np.random.default_rng(2)
    clean = np.round(_images(2, 64, 64, 2))
    noisy = np.clip(np.round(clean + rng.normal(0, 20, clean.shape)),
                    0, 255).astype(np.float32)
    dw = np.asarray([0.5, 0.3, 0.2], np.float32)

    jgt = jax_multiscale_targets(jnp.asarray(clean), 2, clip_values=True,
                                 round_values=True)
    jgrads, (_, jmetrics) = _jax_grad_fn(jhydra, cfg)(
        params, {}, jnp.asarray(noisy), jgt, jnp.asarray(dw),
        jax.random.PRNGKey(1))

    hydra = model_builder(mc).hydra
    hydra.load_state_dict(params_from_flax(params))
    gt = multiscale_targets(torch.from_numpy(clean), 2, clip_values=True,
                            round_values=True)
    total, metrics = forward_loss(hydra, loss_function_builder(cfg["loss"]),
                                  3, torch.from_numpy(noisy), gt,
                                  torch.from_numpy(dw),
                                  torch.Generator().manual_seed(0))
    total.backward()

    assert set(jmetrics) == set(metrics)
    for k, v in jmetrics.items():
        assert _rel(metrics[k].detach().numpy(), v) <= 1e-4, k
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    named = dict(hydra.named_parameters())
    assert set(ref) == set(named)
    for name, p in named.items():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
        assert _rel(p.grad.numpy(), ref[name].numpy()) <= 1e-4, name


def test_narrow_v4_train_step_matches_jax():
    """One train step of ``unet_laplacian_v4`` (attention gates, strided
    downsample, Laplacian upsample, decoder K = 1; four scales) narrowed
    to filters 8 and width 1, drop-path and dropout off, on one injected
    2 × 64² batch: the loss and every per-scale metric within 1e-4
    relative of the JAX step's ``forward_loss``, every gradient within
    1e-4 of its tensor's largest entry of ``jax.grad``, and the params
    after one Adam step of the config's optimizer within 1e-4 of
    optax's."""
    cfg = copy.deepcopy(bidt.CONFIGS_DICT["unet_laplacian_v4"])
    mc = cfg["model"]
    mc["backbone"].update(filters=8, width=1, depth_drop_rate=0.0,
                          convolutional_self_attention_dropout_rate=0.0)
    mc["denoiser"]["filters"] = 8
    jhydra = jax_model_builder(mc).hydra
    # the params' shapes without running the init; values from numpy
    shapes = jax.eval_shape(lambda: jhydra.init(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, 64, 64, 3), jnp.float32), train=False))["params"]
    rng = np.random.default_rng(4)

    def draw(path, leaf):
        if len(leaf.shape) == 4:
            fan_in = int(np.prod(leaf.shape[:3]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape)
        if str(path[-1].key) == "scale":
            return rng.uniform(0.8, 1.2, leaf.shape)
        return rng.normal(0, 0.01, leaf.shape)

    params = jax.tree_util.tree_map_with_path(
        lambda p, l: draw(p, l).astype(np.float32), shapes)
    clean = np.round(_images(2, 64, 64, 4))
    noisy = np.clip(np.round(clean + rng.normal(0, 20, clean.shape)),
                    0, 255).astype(np.float32)
    dw = np.full((4,), 0.25, np.float32)
    jgt = jax_multiscale_targets(jnp.asarray(clean), 3, clip_values=True,
                                 round_values=True)
    jgrads, (_, jmetrics) = _jax_grad_fn(jhydra, cfg, 4)(
        params, {}, jnp.asarray(noisy), jgt, jnp.asarray(dw),
        jax.random.PRNGKey(1))

    hydra = model_builder(mc).hydra
    hydra.load_state_dict(params_from_flax(params))
    gt = multiscale_targets(torch.from_numpy(clean), 3, clip_values=True,
                            round_values=True)
    total, metrics = forward_loss(hydra, loss_function_builder(cfg["loss"]),
                                  4, torch.from_numpy(noisy), gt,
                                  torch.from_numpy(dw),
                                  torch.Generator().manual_seed(0))
    total.backward()
    assert set(jmetrics) == set(metrics)
    for k, v in jmetrics.items():
        assert _rel(metrics[k].detach().numpy(), v) <= 1e-4, k
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    named = dict(hydra.named_parameters())
    assert set(ref) == set(named)
    for name, p in named.items():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
        assert _rel(p.grad.numpy(), ref[name].numpy()) <= 1e-4, name

    # one optimizer step on these gradients, port against optax
    tx, _ = optimizer_builder(cfg["train"]["optimizer"])
    jtx, _ = jax_optimizer_builder(cfg["train"]["optimizer"])
    plist = list(named.values())
    tx.apply(plist, [p.grad for p in plist], tx.init(plist))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    updates, _ = jtx.update(jgrads, jtx.init(jp), jp)
    stepped = params_from_flax(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(jp, updates)))
    for name, p in named.items():
        assert _rel(p.detach().numpy(), stepped[name].numpy()) <= 1e-4, name


def test_multiplier_v6_train_step_matches_jax():
    """One train step of a depth-5 ``unet_laplacian_v6`` whose
    ``filters_level_multiplier`` is 1.5, narrowed to filters 8 and width 1
    (levels of C = 8, 12, 18, 27 and 40, the last its attention level;
    levels 1-3 split their bands at C of no whole 16-byte bf16 vectors),
    drop-path and dropout off, on one injected 128² image (its 1/16
    scale's SSIM needs 8²): the loss and every per-scale metric within
    1e-4 relative of the JAX step's ``forward_loss``, and the gradients,
    all tensors together, at cosine >= 0.9999 to ``jax.grad``'s. Its band
    splits differentiate through K2's backward (the plain version here;
    on the card the kernel, which the full-width model, C = 32 / 48 / 72 /
    108, trains through at C = 108 with 4 bf16 channels a thread:
    ``chip_smoke.py``'s ``wider_shapes`` phase)."""
    cfg = copy.deepcopy(bidt.CONFIGS_DICT["unet_laplacian_v6"])
    mc = cfg["model"]
    mc["backbone"].update(depth=5, filters_level_multiplier=1.5, width=1,
                          filters=8, depth_drop_rate=0.0,
                          convolutional_self_attention_dropout_rate=0.0)
    jhydra = jax_model_builder(mc).hydra
    shapes = jax.eval_shape(lambda: jhydra.init(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, 64, 64, 3), jnp.float32), train=False))["params"]
    rng = np.random.default_rng(12)

    def draw(path, leaf):
        if len(leaf.shape) == 4:
            fan_in = int(np.prod(leaf.shape[:3]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape)
        if str(path[-1].key) == "scale":
            return rng.uniform(0.8, 1.2, leaf.shape)
        return rng.normal(0, 0.01, leaf.shape)

    params = jax.tree_util.tree_map_with_path(
        lambda p, l: draw(p, l).astype(np.float32), shapes)
    clean = np.round(_images(1, 128, 128, 12))
    noisy = np.clip(np.round(clean + rng.normal(0, 20, clean.shape)),
                    0, 255).astype(np.float32)
    dw = np.full((5,), 0.2, np.float32)
    jgt = jax_multiscale_targets(jnp.asarray(clean), 4, clip_values=True,
                                 round_values=True)
    jgrads, (_, jmetrics) = _jax_grad_fn(jhydra, cfg, 5)(
        params, {}, jnp.asarray(noisy), jgt, jnp.asarray(dw),
        jax.random.PRNGKey(1))

    hydra = model_builder(mc).hydra
    assert [getattr(hydra.backbone, f"encoder_{d}_0").conv_1.kernel.shape[0]
            for d in range(4)] == [8, 12, 18, 27]
    hydra.load_state_dict(params_from_flax(params))
    gt = multiscale_targets(torch.from_numpy(clean), 4, clip_values=True,
                            round_values=True)
    total, metrics = forward_loss(
        hydra, loss_function_builder(cfg["loss"]), 5,
        torch.from_numpy(noisy), gt, torch.from_numpy(dw),
        torch.Generator().manual_seed(0))
    total.backward()
    for k, v in jmetrics.items():
        assert _rel(metrics[k].detach().numpy(), v) <= 1e-4, k
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    named = dict(hydra.named_parameters())
    assert set(ref) == set(named)
    got = torch.cat([named[n].grad.flatten().double() for n in sorted(ref)])
    want = torch.cat([ref[n].flatten().double() for n in sorted(ref)])
    assert float(torch.nn.functional.cosine_similarity(got, want, dim=0)) \
        >= 0.9999


def test_jax_bf16_gradient_cosine_of_the_flagship():
    """JAX's own bf16-vs-f32 gradient cosine, to set beside the port's
    (0.9936 on the card against the f32 CPU step, ``chip_smoke.py``
    ``train_check``): ``jax.grad`` of the JAX step's ``forward_loss`` on
    the packaged flagship at full width, drop-path and dropout off, one
    injected noisy batch of the whole-slice test's size (2 × 64²), in
    bfloat16 and in float32, and the port's bf16 and f32 CPU gradients
    on the same batch. It measures; it asserts no more than the port's
    bar (cosine >= 0.99) of each package against its own f32."""
    cfg = _config()
    mc = copy.deepcopy(cfg["model"])
    mc["backbone"].update(depth_drop_rate=0.0,
                          convolutional_self_attention_dropout_rate=0.0)
    tree = load_msgpack(f"{bidt.models[FLAGSHIP]['directory']}/params.msgpack")
    rng = np.random.default_rng(2)
    clean = np.round(_images(2, 64, 64, 2))
    noisy = np.clip(np.round(clean + rng.normal(0, 20, clean.shape)),
                    0, 255).astype(np.float32)
    dw = np.full((3,), 1.0 / 3, np.float32)
    jgt = jax_multiscale_targets(jnp.asarray(clean), 2, clip_values=True,
                                 round_values=True)
    gt = multiscale_targets(torch.from_numpy(clean), 2, clip_values=True,
                            round_values=True)

    def flat_jax(dtype):
        grads, _ = _jax_grad_fn(jax_model_builder(mc, dtype=dtype).hydra,
                                cfg)(tree["params"], {}, jnp.asarray(noisy),
                                     jgt, jnp.asarray(dw),
                                     jax.random.PRNGKey(1))
        return np.concatenate([np.asarray(g, np.float64).ravel() for g in
                               jax.tree_util.tree_leaves(grads)])

    def flat_port(dtype):
        hydra = model_builder(mc, dtype=dtype).hydra
        hydra.load_state_dict(params_from_flax(tree))
        total, _ = forward_loss(hydra, loss_function_builder(cfg["loss"]),
                                3, torch.from_numpy(noisy), gt,
                                torch.from_numpy(dw),
                                torch.Generator().manual_seed(0))
        total.backward()
        return np.concatenate([p.grad.double().numpy().ravel()
                               for _, p in sorted(hydra.named_parameters())])

    def cosine(a, b):
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))

    jax_cos = cosine(flat_jax(jnp.bfloat16), flat_jax(jnp.float32))
    port_cos = cosine(flat_port(torch.bfloat16), flat_port(None))
    print(f"bf16-vs-f32 gradient cosine: JAX {jax_cos:.5f}, "
          f"port (CPU) {port_cos:.5f}")
    assert jax_cos >= 0.99 and port_cos >= 0.99, (jax_cos, port_cos)


def test_bf16_hydra_epilogue_runs_in_float32():
    """Under ``jit`` XLA keeps the JAX heads' tanh·0.51 and the denormalize
    in float32; so does the port, or bf16 training would round every
    output to the bf16 grid (a step of one gray level above 128) and flip
    the hinge and SSIM terms pixel by pixel. So the packaged flagship's
    bf16 outputs are float32, and at most 1% of them lie on the bf16
    grid (all would if the epilogue ran in bf16)."""
    hydra = model_builder(_config()["model"], dtype=torch.bfloat16).hydra
    tree = load_msgpack(f"{bidt.models[FLAGSHIP]['directory']}/params.msgpack")
    hydra.load_state_dict(params_from_flax(tree))
    x = torch.from_numpy(_images(2, 32, 32, 5)).permute(0, 3, 1, 2)
    with torch.no_grad():
        outs = hydra(x)
    for o in outs:
        assert o.dtype == torch.float32
        on_grid = float((o == o.to(torch.bfloat16).float()).float().mean())
        assert on_grid <= 0.01, on_grid


def test_flagship_full_width_train_step_on_cpu(monkeypatch):
    def no_k1(*args, **kwargs):
        raise AssertionError("the fused inference unit ran in training")
    monkeypatch.setattr(convnext_mod, "convnext_block", no_k1)

    cfg = _config()
    mc = copy.deepcopy(cfg["model"])
    mc["backbone"]["depth_drop_rate"] = 0.0
    hydra = model_builder(mc).hydra
    tree = load_msgpack(f"{bidt.models[FLAGSHIP]['directory']}/params.msgpack")
    tx, _ = optimizer_builder(cfg["train"]["optimizer"])
    state = create_train_state(hydra, tx, seed=0,
                               params=params_from_flax(tree), device="cpu")
    before = {k: v.detach().clone() for k, v in state.params.items()}
    ds = cfg["dataset"]
    step = build_train_step(
        hydra, tx, loss_function_builder(cfg["loss"]), hydra.no_outputs,
        additive_noise=ds["additional_noise"],
        multiplicative_noise=ds["multiplicative_noise"],
        use_pallas_noise=True)
    batch = torch.from_numpy(_images(1, 64, 64, 3).astype(np.uint8))
    state, metrics = step(state, batch)
    assert state.step == 1 and state.opt_state.count == 1
    assert np.isfinite(float(metrics["total_loss"]))
    assert float(metrics["grad_norm"]) > 0
    for k in ("scale_0/total_loss", "scale_2/ssim_loss",
              "regularization_loss"):
        assert np.isfinite(float(metrics[k])), k
    for name, p in state.params.items():
        assert not torch.equal(p.detach(), before[name]), name


def test_finetune_step_at_the_peak_rate_matches_jax():
    """One Adam step of the config's optimizer at its peak rate (1e-3)
    from the packaged flagship, in JAX and in the port, float32, drop-path
    and dropout off, on one injected b2 @ 64² batch at σ 20: the loss on
    that batch before the step within 1e-4 relative of JAX's, and after
    it within 1e-3 (the step moves every weight by up to the rate, so the
    loss after it sums the gradient bar's differences over every
    param)."""
    cfg = _config()
    mc = copy.deepcopy(cfg["model"])
    mc["backbone"].update(depth_drop_rate=0.0,
                          convolutional_self_attention_dropout_rate=0.0)
    tree = load_msgpack(f"{bidt.models[FLAGSHIP]['directory']}/params.msgpack")
    rng = np.random.default_rng(7)
    clean = np.round(_images(2, 64, 64, 7))
    noisy = np.clip(np.round(clean + rng.normal(0, 20, clean.shape)),
                    0, 255).astype(np.float32)
    dw = np.full((3,), 1.0 / 3, np.float32)

    grad_fn = _jax_grad_fn(jax_model_builder(mc).hydra, cfg)
    jgt = jax_multiscale_targets(jnp.asarray(clean), 2, clip_values=True,
                                 round_values=True)

    def jax_loss(params):
        grads, (_, metrics) = grad_fn(params, {}, jnp.asarray(noisy), jgt,
                                      jnp.asarray(dw), jax.random.PRNGKey(1))
        return grads, float(metrics["total_loss"])

    jtx, _ = jax_optimizer_builder(cfg["train"]["optimizer"])
    grads, ref_before = jax_loss(tree["params"])
    updates, _ = jtx.update(grads, jtx.init(tree["params"]), tree["params"])
    _, ref_after = jax_loss(optax.apply_updates(tree["params"], updates))

    hydra = model_builder(mc).hydra
    tx, _ = optimizer_builder(cfg["train"]["optimizer"])
    state = create_train_state(hydra, tx, params=params_from_flax(tree),
                               device="cpu")
    gt = multiscale_targets(torch.from_numpy(clean), 2, clip_values=True,
                            round_values=True)
    fns = loss_function_builder(cfg["loss"])

    def port_loss():
        return forward_loss(hydra, fns, 3, torch.from_numpy(noisy), gt,
                            torch.from_numpy(dw),
                            torch.Generator().manual_seed(0))[0]

    total = port_loss()
    total.backward()
    params = list(hydra.parameters())
    tx.apply(params, [p.grad for p in params], state.opt_state)
    with torch.no_grad():
        after = float(port_loss())
    before = float(total.detach())
    print(f"fine-tune step at 1e-3 on b2 @ 64^2: JAX {ref_before:.4f} -> "
          f"{ref_after:.4f}, port {before:.4f} -> {after:.4f}")
    assert before == pytest.approx(ref_before, rel=1e-4)
    assert after == pytest.approx(ref_after, rel=1e-3)
