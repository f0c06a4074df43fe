"""The classic ``unet`` backbone and its layers against the JAX package,
float32 on the CPU.

* ``Activation("prelu")`` (slopes outside [0, 1] included, so the clip
  is held), ``DenseBlock`` (bias, BatchNorm, each activation; eval and
  train), ``DenseGate`` and ``SparseBlock`` (each option, eval from
  perturbed running statistics and train with the running update)
  against their flax modules with the same weights: within 1e-5 of the
  output's largest magnitude (1e-6 for the elementwise prelu).
* ``UnetBackbone`` against the JAX module's ``apply`` on seeded weights
  converted by ``weights.params_from_flax``, with each option on alone
  and all together, in eval and in train (batch statistics, and the
  running update of every buffer): within 1e-5 of the output's largest
  magnitude, or 1.5 times the sum of the two float32 errors where that
  is larger (each against the port in float64; JAX's reaches 1.9e-5
  with train-mode batch norms behind a depthwise conv and gates); the
  port within 3e-5 of its float64 forward always.
* Each ``kernel_initializer``: the std of a large draw within three
  standard errors of its formula (flax's ``variance_scaling``), its
  range, and zeros and ones exact; through ``init_params`` on a unet
  config with ``he_normal``, each kernel follows its module's
  initializer (the heads and gates keep glorot-normal, as in JAX) and
  relu biases start at 0.1.
* One train step of a narrowed unet config (gates, sparse features,
  BatchNorm) against the JAX step's ``forward_loss`` and optax: the loss
  within 1e-4 relative, every gradient and every param after one Adam
  step within 1e-4 of its tensor's largest entry (a param whose gradient
  is below 1e-3 of its tensor's largest, where Adam's ``g / (|g| +
  eps)`` turns rounding into a step, within the step's size, the rate),
  the batch statistics after the step within 1e-5.
"""

import copy
import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import blind_image_denoising_torch as bidt
from blind_image_denoising_tpu.layers.activations import (
    Activation as JaxActivation)
from blind_image_denoising_tpu.layers.blocks import DenseGate as JaxDenseGate
from blind_image_denoising_tpu.layers.conv import DenseBlock as JaxDenseBlock
from blind_image_denoising_tpu.layers.misc import (
    SparseBlock as JaxSparseBlock)
from blind_image_denoising_tpu.models.hydra import (
    model_builder as jax_model_builder)
from blind_image_denoising_tpu.models.unet import (
    KNOWN_KEYS as JAX_KNOWN_KEYS, UnetBackbone as JaxUnetBackbone)
from blind_image_denoising_tpu.ops.multiscale import (
    multiscale_targets as jax_multiscale_targets)
from blind_image_denoising_tpu.training import (
    build_train_step as jax_build_train_step,
    loss_function_builder as jax_loss_function_builder,
    optimizer_builder as jax_optimizer_builder)
from blind_image_denoising_torch.layers.activations import Activation
from blind_image_denoising_torch.layers.blocks import DenseGate
from blind_image_denoising_torch.layers.conv import (DenseBlock,
                                                     resolve_initializer)
from blind_image_denoising_torch.layers.misc import SparseBlock
from blind_image_denoising_torch.models.hydra import model_builder
from blind_image_denoising_torch.models.unet import KNOWN_KEYS, UnetBackbone
from blind_image_denoising_torch.ops.multiscale import multiscale_targets
from blind_image_denoising_torch.training import (forward_loss,
                                                  loss_function_builder,
                                                  optimizer_builder)
from blind_image_denoising_torch.training.train_state import init_params
from blind_image_denoising_torch.weights import params_from_flax

RESNET = "resnet_color_1x6_bn_32x128x32_1x3x1_128x128_depthwise_l1_relu"


def _x(shape, seed=1, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).normal(shift, scale, shape)
            .astype(np.float32))


def _rel(got, ref):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(ref)))
                 / max(float(np.max(np.abs(np.asarray(ref)))), 1e-30))


def _variables(module, *args, seed=0, **kw):
    """params and batch_stats of ``module`` from numpy draws (shapes by
    ``jax.eval_shape``): kernels ~ N(0, 1/fan_in), scales near 1,
    variances positive, everything else N(0, 0.3)."""
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0)}, *map(jnp.asarray, args), **kw))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        if name == "kernel" and len(leaf.shape) in (2, 4):
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape)
        if name == "scale":
            return rng.uniform(0.7, 1.3, leaf.shape)
        if name in ("var", "mean_sq"):
            return rng.uniform(0.5, 2.0, leaf.shape)
        if name == "prelu_alpha":
            return rng.uniform(-0.5, 1.5, leaf.shape)
        return rng.normal(0, 0.3, leaf.shape)

    return {k: jax.tree_util.tree_map_with_path(
        lambda p, l: draw(p, l).astype(np.float32), v)
        for k, v in shapes.items() if k in ("params", "batch_stats")}


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _stats(tree):
    return params_from_flax({"params": {}, "batch_stats": jax.tree_util
                             .tree_map(np.asarray, tree)})


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("rank", [2, 4])
def test_prelu_matches_flax(rank):
    x = _x((3, 5, 6, 7) if rank == 4 else (5, 7), scale=2.0)
    jm = JaxActivation("prelu")
    variables = _variables(jm, x)
    assert set(variables["params"]) == {"prelu_alpha"}
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    tm = Activation("prelu", 7)
    assert torch.equal(tm.prelu_alpha.detach(), torch.full((7,), 0.1))
    tm.load_state_dict(params_from_flax(variables), strict=True)
    with torch.no_grad():
        got = (_nhwc(tm(_nchw(x))) if rank == 4
               else tm(torch.from_numpy(x)).numpy())
    assert _rel(got, ref) <= 1e-6


@pytest.mark.parametrize("opts", [
    dict(), dict(use_bias=True), dict(activation="relu"),
    dict(activation="hard_sigmoid", use_bias=True),
    dict(activation="prelu"), dict(use_bn=True, activation="relu")],
    ids=lambda o: "+".join(f"{k}={v}" for k, v in o.items()) or "plain")
@pytest.mark.parametrize("train", [False, True])
def test_dense_block_matches_flax(opts, train):
    x = _x((6, 12), scale=2.0, shift=0.5)
    jm = JaxDenseBlock(features=9, kernel_regularizer="l2", **opts)
    variables = _variables(jm, x)
    tm = DenseBlock(12, 9, kernel_regularizer="l2", **opts)
    tm.load_state_dict(params_from_flax(variables), strict=True)
    assert tuple(tm.kernel.shape) == (12, 9)
    ref, mutated = jm.apply(variables, jnp.asarray(x), train=train,
                            mutable=["batch_stats", "losses"])
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=train).numpy()
    assert _rel(got, ref) <= 1e-5
    penalty = float(jax.tree_util.tree_leaves(mutated["losses"])[0])
    assert float(tm.penalty().detach()) == pytest.approx(penalty, rel=1e-5)
    if opts.get("use_bn") and train:
        for name, v in _stats(mutated["batch_stats"]).items():
            assert _rel(dict(tm.named_buffers())[name], v) <= 1e-6, name


@pytest.mark.parametrize("train", [False, True])
def test_dense_gate_matches_flax(train):
    signal, x = _x((2, 6, 5, 16), seed=2), _x((2, 6, 5, 16), seed=3)
    jm = JaxDenseGate(gate_filters=16)
    variables = _variables(jm, signal, x)
    ref = np.asarray(jm.apply(variables, jnp.asarray(signal), jnp.asarray(x),
                              train=train))
    tm = DenseGate(16, 16)
    tm.load_state_dict(params_from_flax(variables), strict=True)
    with torch.no_grad():
        got = _nhwc(tm(_nchw(signal), _nchw(x), train=train))
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("opts", [
    dict(), dict(symmetrical=True), dict(reverse=True),
    dict(soft_sparse=True), dict(threshold_sigma=0.5, symmetrical=True)],
    ids=lambda o: "+".join(f"{k}={v}" for k, v in o.items()) or "plain")
@pytest.mark.parametrize("train", [False, True])
def test_sparse_block_matches_flax(opts, train):
    x = _x((3, 6, 7, 8), scale=2.0, shift=0.3)
    jm = JaxSparseBlock(**opts)
    variables = _variables(jm, x)
    ref, mutated = jm.apply(variables, jnp.asarray(x), train=train,
                            mutable=["batch_stats"])
    tm = SparseBlock(8, **opts)
    tm.load_state_dict(params_from_flax(variables), strict=True)
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x), train=train))
    assert _rel(got, ref) <= 1e-5
    if train:
        for name, v in _stats(mutated["batch_stats"]).items():
            assert _rel(dict(tm.named_buffers())[name], v) <= 1e-6, name


# ---------------------------------------------------------------- backbone

_BASE = dict(type="unet", filters=8, block_filters=[8, 8],
             input_shape=["?", "?", 3], value_range=[0, 255])


@pytest.mark.parametrize("option", [
    dict(), dict(add_gates=True), dict(add_sparse_features=True),
    dict(add_initial_bn=True), dict(add_final_bn=True),
    dict(add_concat_input=True), dict(add_channelwise_scaling=True),
    dict(add_learnable_multiplier=True), dict(add_clip=True),
    dict(batchnorm="bias_free", add_initial_bn=True), dict(use_bias=True),
    dict(use_bn=False), dict(add_mean_sigma_normalization=True),
    dict(no_levels=2, no_layers=2),
    dict(block_kernels=[1, 3, 1], block_filters=[8, 16, 8],
         block_depthwise=[-1, 2, -1], add_gates=True),
    dict(block_kernels=[3, 1, 3], block_filters=[8, 16, 8],
         block_activation=["prelu", "relu", "linear"]),
    dict(add_gates=True, add_sparse_features=True, add_initial_bn=True,
         add_final_bn=True, add_concat_input=True,
         add_channelwise_scaling=True, add_learnable_multiplier=True,
         add_clip=True, use_bias=True)],
    ids=lambda o: "+".join(f"{k}={v}" for k, v in o.items()) or "defaults")
@pytest.mark.parametrize("train", [False, True])
def test_unet_backbone_matches_jax(option, train):
    cfg = dict(_BASE, **option)
    x = _x((2, 20, 24, 3), scale=0.4)
    jm = JaxUnetBackbone(config=cfg)
    variables = _variables(jm, x, train=False)
    ref, mutated = jm.apply(variables, jnp.asarray(x), train=train,
                            mutable=["batch_stats"])
    tm = UnetBackbone(cfg, in_channels=3)
    tm.load_state_dict(params_from_flax(variables), strict=True)
    exact = copy.deepcopy(tm).double()
    with torch.no_grad():
        got = tm(_nchw(x), train=train)
        truth = _nhwc(exact(_nchw(x).double(), train=train)[0])
    assert len(got) == len(ref) == 1
    assert tm.out_features == [ref[0].shape[-1]]
    # float32 rounding, the port's and JAX's, against the port in float64:
    # in train mode a batch norm over few pixels can spread JAX's past
    # 1e-5, and then the bar is their sum, with half of it to spare
    port_err, jax_err = _rel(_nhwc(got[0]), truth), _rel(ref[0], truth)
    assert port_err <= 3e-5
    assert _rel(_nhwc(got[0]), ref[0]) <= max(1e-5,
                                              1.5 * (port_err + jax_err))
    if train and variables.get("batch_stats"):
        stats = _stats(mutated["batch_stats"])
        buffers = dict(tm.named_buffers())
        assert set(stats) == set(buffers)
        for name, v in stats.items():
            assert _rel(buffers[name], v) <= 1e-5, name


def test_unet_is_a_registered_backbone():
    assert KNOWN_KEYS == JAX_KNOWN_KEYS
    cfg = {"backbone": dict(_BASE, add_gates=True), "denoiser": {}}
    hydra = model_builder(copy.deepcopy(cfg)).hydra
    assert isinstance(hydra.backbone, UnetBackbone)
    assert hydra.no_outputs == 1


# ------------------------------------------------------------ initializers

@pytest.mark.parametrize("name,fan_in,fan_out", [
    ("glorot_normal", 72, 144), ("glorot_uniform", 72, 144),
    ("he_normal", 200, 50), ("he_uniform", 200, 50),
    ("trunc_normal", 30, 30), ("truncated_normal", 30, 30)])
def test_initializer_statistics(name, fan_in, fan_out):
    n = 200_000
    w = resolve_initializer(name)((n,), fan_in, fan_out,
                                  torch.Generator().manual_seed(0))
    std = {"glorot": math.sqrt(2.0 / (fan_in + fan_out)),
           "he": math.sqrt(2.0 / fan_in),
           "trunc": 0.02 * 0.87962566103423978,
           "truncated": 0.02 * 0.87962566103423978}[name.split("_")[0]]
    # the std's standard error, with kurtosis at most 3
    se = std / math.sqrt(2 * n)
    assert abs(float(w.std()) - std) <= 3 * se, (float(w.std()), std)
    assert abs(float(w.mean())) <= 3 * std / math.sqrt(n)
    if name.endswith("uniform"):
        assert float(w.abs().max()) <= math.sqrt(3) * std * (1 + 1e-6)
    elif name.startswith("trunc"):
        assert float(w.abs().max()) <= 0.04 * (1 + 1e-6)
    else:
        assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 * (
            1 + 1e-6)


def test_constant_initializers_and_unknown_name():
    g = torch.Generator().manual_seed(0)
    assert torch.equal(resolve_initializer("zeros")((3, 4), 4, 3, g),
                       torch.zeros(3, 4))
    assert torch.equal(resolve_initializer("ones")((3, 4), 4, 3, g),
                       torch.ones(3, 4))
    with pytest.raises(ValueError, match="initializer"):
        resolve_initializer("lecun_normal")


def test_init_params_follows_each_modules_initializer():
    cfg = {"backbone": dict(_BASE, filters=32, block_filters=[32, 32],
                            add_gates=True, add_sparse_features=True,
                            use_bias=True,
                            kernel_initializer="he_normal"),
           "denoiser": {"filters": 64}}
    hydra = model_builder(copy.deepcopy(cfg)).hydra
    init_params(hydra, torch.Generator().manual_seed(0))
    bb = hydra.backbone
    checks = [
        (bb.enc_1_blocks.block_0_conv_2.kernel, math.sqrt(2.0 / (32 * 9))),
        (bb.dec_0_proj.kernel, math.sqrt(2.0 / (64 * 9))),
        (hydra.denoiser_head_0.conv_0.kernel,
         math.sqrt(2.0 / (32 + 64))),
        (bb.enc_0_blocks.block_0_gate.gate_dense_0.kernel,
         math.sqrt(2.0 / (32 + 4)))]
    for w, std in checks:
        n = w.numel()
        assert abs(float(w.std()) - std) <= 4 * std / math.sqrt(2 * n), (
            tuple(w.shape), float(w.std()), std)
    # a relu conv's bias starts at 0.1, a linear one's at 0, as in JAX
    assert torch.equal(bb.enc_0_blocks.block_0_conv_1.bias,
                       torch.full((32,), 0.1))
    assert torch.equal(bb.base_conv.bias, torch.zeros(32))


# ------------------------------------------------------------- train step

def test_narrow_unet_train_step_matches_jax():
    """One step of a narrowed unet (filters 8, gates, sparse features,
    BatchNorm) on one injected 2 × 32² batch: loss and metrics, every
    gradient, the batch statistics the step leaves and the params after
    one Adam step of the resnet config's optimizer, against JAX."""
    cfg = copy.deepcopy(bidt.CONFIGS_DICT[RESNET])
    mc = {"backbone": dict(_BASE, add_gates=True, add_sparse_features=True,
                           kernel_initializer="he_normal"),
          "denoiser": dict(cfg["model"]["denoiser"], filters=8)}
    cfg["model"] = mc
    jhydra = jax_model_builder(copy.deepcopy(mc)).hydra
    x0 = np.zeros((1, 32, 32, 3), np.float32)
    variables = _variables(jhydra, x0, seed=5, train=False)
    params, stats = variables["params"], variables["batch_stats"]
    rng = np.random.default_rng(6)
    clean = np.round(rng.uniform(0, 255, (2, 32, 32, 3))).astype(np.float32)
    noisy = np.clip(np.round(clean + rng.normal(0, 20, clean.shape)),
                    0, 255).astype(np.float32)
    dw = np.ones((1,), np.float32)

    tx_j, _ = jax_optimizer_builder(cfg["train"]["optimizer"])
    step = jax_build_train_step(jhydra, tx_j,
                                jax_loss_function_builder(cfg["loss"]), 1)
    cells = dict(zip(step.__code__.co_freevars,
                     (c.cell_contents for c in step.__closure__)))
    jgt = jax_multiscale_targets(jnp.asarray(clean), 0, clip_values=True,
                                 round_values=True)
    jgrads, (jstats, jmetrics) = jax.jit(cells["grad_fn"])(
        params, stats, jnp.asarray(noisy), jgt, jnp.asarray(dw),
        jax.random.PRNGKey(1))

    hydra = model_builder(copy.deepcopy(mc)).hydra
    hydra.load_state_dict(params_from_flax(variables), strict=True)
    gt = multiscale_targets(torch.from_numpy(clean), 0, clip_values=True,
                            round_values=True)
    total, metrics = forward_loss(hydra, loss_function_builder(cfg["loss"]),
                                  1, torch.from_numpy(noisy), gt,
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
        # the sparse features' BatchNorm scale reaches the loss only
        # through a comparison: no gradient, as JAX's zeros
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        assert _rel(grad.numpy(), ref[name].numpy()) <= 1e-4, name
    buffers = dict(hydra.named_buffers())
    for name, v in _stats(jstats).items():
        assert _rel(buffers[name], v) <= 1e-5, name

    tx, _ = optimizer_builder(cfg["train"]["optimizer"])
    plist = list(named.values())
    tx.apply(plist, [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in plist], tx.init(plist))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    updates, _ = tx_j.update(jgrads, tx_j.init(jp), jp)
    stepped = params_from_flax(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(jp, updates)))
    lr = 1e-3              # the resnet config's rate: Adam's largest step
    for name, p in named.items():
        got, want = p.detach().numpy(), stepped[name].numpy()
        g = np.abs(ref[name].numpy())
        # where the gradient is at its tensor's rounding level, Adam's
        # g / (|g| + eps) turns rounding into up to a whole step
        steady = g > 1e-3 * g.max()
        if steady.any():
            assert _rel(got[steady], want[steady]) <= 1e-4, name
        assert float(np.abs(got - want).max()) <= lr, name
