"""The last layers of the port against their flax counterparts, float32
on the CPU, with the same parameters (numpy draws of the flax variables
carried across by ``weights.params_from_flax``):

* ``SelectorBlock``: the four scale types × both activations, and each
  selector filter (1×1, global and local normalization, low- and
  high-pass), atol 1e-5 of the output; its L1 penalties' sum against
  the losses the flax block sows, rtol 1e-5.
* a narrowed resnet hydra with ``selector_params`` (``{}`` and GLOBAL /
  SOFT) against ``hydra.apply``, within 0.05 gray levels, and its
  regularization sum, rtol 1e-5.
* ``SqueezeExcite`` (sigmoid; hard sigmoid with and without
  ``learn_to_turn_off``; soft-orthonormal regularization; the ``gamma``
  scale), ``GatedMLP``, ``ValueCompressor``, ``NonLocalAttention`` (with
  and without ``logit_norm``), the smooth and global multipliers,
  ``logit_norm``, ``hard_sigmoid``, the six normalize ops and the loss
  helpers, atol 1e-5 (losses rtol 1e-5).
"""

import copy
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blind_image_denoising_tpu as bid
from blind_image_denoising_tpu.layers import activations as jact
from blind_image_denoising_tpu.layers import attention as jatt
from blind_image_denoising_tpu.layers import misc as jmisc
from blind_image_denoising_tpu.layers import multipliers as jmult
from blind_image_denoising_tpu.layers import se as jse
from blind_image_denoising_tpu.layers import selector as jsel
from blind_image_denoising_tpu.models.hydra import (
    model_builder as jax_model_builder)
from blind_image_denoising_tpu.ops import losses as jlosses
from blind_image_denoising_tpu.training.losses import sum_losses_collection
from blind_image_denoising_torch.layers import activations as tact
from blind_image_denoising_torch.layers import attention as tatt
from blind_image_denoising_torch.layers import misc as tmisc
from blind_image_denoising_torch.layers import multipliers as tmult
from blind_image_denoising_torch.layers import se as tse
from blind_image_denoising_torch.layers import selector as tsel
from blind_image_denoising_torch.layers.stochastic import RandomOnOff
from blind_image_denoising_torch.models.hydra import model_builder
from blind_image_denoising_torch.ops import losses as tlosses
from blind_image_denoising_torch.ops.regularizers import regularization_loss
from blind_image_denoising_torch.weights import params_from_flax

# the ops packages export the functions normalize and ssim, which shadow
# their modules' names as attributes
jnorm = importlib.import_module("blind_image_denoising_tpu.ops.normalize")
jssim = importlib.import_module("blind_image_denoising_tpu.ops.ssim")
tnorm = importlib.import_module("blind_image_denoising_torch.ops.normalize")
tssim = importlib.import_module("blind_image_denoising_torch.ops.ssim")

ATOL = 1e-5


def _x(shape, seed=1, scale=1.0, loc=0.0):
    return (np.random.default_rng(seed).normal(loc, scale, shape)
            .astype(np.float32))


def _draw_params(module, *inputs, seed=3):
    """Numpy draws for every flax param of ``module`` (kernels at a
    1/sqrt(fan_in) scale, the rest around 0.2), so nothing sits at an
    initializer's special value."""
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0)},
        *[jnp.asarray(a) for a in inputs]))["params"]
    rng = np.random.default_rng(seed)

    def draw(leaf):
        if len(leaf.shape) >= 2:
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape)
        return rng.normal(0, 0.2, leaf.shape)

    return jax.tree_util.tree_map(
        lambda leaf: draw(leaf).astype(np.float32), shapes)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _jax_with_losses(module, params, *inputs, **kw):
    out, sown = module.apply({"params": params},
                             *[jnp.asarray(a) for a in inputs],
                             mutable=["losses"], **kw)
    return np.asarray(out), float(sum_losses_collection(sown))


# ------------------------------------------------------------------ selector

_SELECTOR_CASES = (
    [dict(scale_type=s, activation_type=a)
     for s in ("LOCAL", "MULTISCALE", "MIXED", "GLOBAL")
     for a in ("HARD", "SOFT")]
    + [dict(use_conv1x1_selector=True),
       dict(use_global_normalization=True),
       dict(use_local_normalization=True, pool_size=(8, 8)),
       dict(use_lowpass=True, scale_type="MIXED"),
       dict(use_highpass=True, scale_type="MULTISCALE"),
       dict(use_conv1x1_selector=True, use_global_normalization=True,
            use_lowpass=True, use_highpass=True, scale_type="GLOBAL",
            activation_type="SOFT", filters_compress_ratio=0.5)])


@pytest.mark.parametrize("opts", _SELECTOR_CASES,
                         ids=lambda o: "-".join(f"{k}={v}"
                                                for k, v in o.items()))
def test_selector_block_matches_flax(opts):
    # a 40x36 map: the pools of 16 and 32 at stride 8 (and 64 in
    # MULTISCALE) see the SAME padding on both axes
    a, b = _x((2, 40, 36, 8), seed=1), _x((2, 40, 36, 8), seed=2)
    sel = _x((2, 40, 36, 6), seed=4, scale=2.0)
    opts = dict(opts)
    opts.setdefault("pool_size", (16, 16))
    jm = jsel.SelectorBlock(**opts)
    params = _draw_params(jm, a, b, sel)
    ref, ref_reg = _jax_with_losses(jm, params, a, b, sel, train=True)
    tm = tsel.SelectorBlock(8, 6, **opts)
    tm.load_state_dict(params_from_flax(params), strict=True)
    with torch.no_grad():
        got = tm(_nchw(a), _nchw(b), _nchw(sel))
    np.testing.assert_allclose(_nhwc(got), ref, atol=ATOL)
    assert ref_reg > 0.0
    assert float(regularization_loss(tm).detach()) == pytest.approx(
        ref_reg, rel=1e-5)


def test_selector_enums_and_errors():
    assert tsel.ScaleType.from_string(" global ") is tsel.ScaleType.GLOBAL
    assert tsel.ActivationType.from_string("soft") is \
        tsel.ActivationType.SOFT
    assert [e.name for e in tsel.ScaleType] == [
        e.name for e in jsel.ScaleType]
    assert [e.value for e in tsel.ActivationType] == [
        e.value for e in jsel.ActivationType]
    with pytest.raises(KeyError):
        tsel.ScaleType.from_string("nowhere")
    from blind_image_denoising_torch.layers.blocks import ResnetBlocks
    with pytest.raises(ValueError, match="first conv"):
        ResnetBlocks(8, 1, second_conv_params=dict(filters=8),
                     selector_params={})


_RESNET = "resnet_color_1x6_bn_32x128x32_1x3x1_128x128_depthwise_l1_relu"


@pytest.mark.parametrize("selector", [
    {}, {"scale_type": "GLOBAL", "activation_type": "SOFT"},
    {"scale_type": "MULTISCALE", "use_conv1x1_selector": True,
     "pool_size": [8, 8]}], ids=["defaults", "global-soft", "multiscale"])
def test_resnet_with_selector_matches_jax(selector):
    backbone = copy.deepcopy(bid.CONFIGS_DICT[_RESNET]["model"]["backbone"])
    backbone.update(filters=8, no_layers=2, block_filters=[8, 32, 8],
                    selector_params=selector)
    mc = {"backbone": backbone,
          "denoiser": {"output_channels": 3, "kernel_regularizer": "l2"}}
    jhydra = jax_model_builder(copy.deepcopy(mc)).hydra
    x = np.random.default_rng(1).uniform(0, 255, (2, 40, 48, 3)).astype(
        np.float32)
    shapes = jax.eval_shape(lambda: jhydra.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x), train=False))
    rng = np.random.default_rng(3)

    def draw(path, leaf):
        name = str(path[-1].key)
        if len(leaf.shape) >= 2:
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape)
        if name in ("var", "mean_sq"):
            return rng.uniform(0.5, 2.0, leaf.shape)
        if name == "scale":
            return rng.uniform(0.7, 1.3, leaf.shape)
        return rng.normal(0, 0.2, leaf.shape)

    variables = {k: jax.tree_util.tree_map_with_path(
        lambda p, l: draw(p, l).astype(np.float32), shapes[k])
        for k in ("params", "batch_stats") if k in shapes}
    assert any("selector" in k for k in variables["params"]["backbone"][
        "skeleton"]["blocks"])
    refs, sown = jhydra.apply(variables, jnp.asarray(x), train=False,
                              mutable=["losses"])
    port = model_builder(copy.deepcopy(mc)).hydra
    port.load_state_dict(params_from_flax(variables), strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(),
                               np.asarray(refs[0]), atol=0.05)
    assert float(regularization_loss(port).detach()) == pytest.approx(
        float(sum_losses_collection(sown)), rel=1e-5)


# ------------------------------------------------------------ other layers

@pytest.mark.parametrize("opts", [
    {}, dict(hard_sigmoid_version=True),
    dict(hard_sigmoid_version=True, learn_to_turn_off=True),
    dict(use_soft_orthonormal_regularization=True, use_bias=False),
    dict(use_scale_gamma=True, r_ratio=0.5)],
    ids=["sigmoid", "hard", "turn-off", "orthonormal", "gamma"])
def test_squeeze_excite_matches_flax(opts):
    x = _x((2, 9, 11, 16), scale=2.0)
    jm = jse.SqueezeExcite(**opts)
    params = _draw_params(jm, x)
    ref, ref_reg = _jax_with_losses(jm, params, x, train=True)
    tm = tse.SqueezeExcite(16, **opts)
    tm.load_state_dict(params_from_flax(params), strict=True)
    with torch.no_grad():
        got = tm(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), ref, atol=ATOL)
    assert float(regularization_loss(tm).detach()) == pytest.approx(
        ref_reg, rel=1e-5)
    with pytest.raises(ValueError, match="r_ratio"):
        tse.SqueezeExcite(16, r_ratio=0.0)


@pytest.mark.parametrize("opts", [
    {}, dict(use_bias=True, activation="relu", gate_activation="tanh",
             kernel_regularizer="l2")], ids=["default", "options"])
def test_gated_mlp_matches_flax(opts):
    x = _x((2, 7, 5, 8))
    jm = jmisc.GatedMLP(filters=24, **opts)
    params = _draw_params(jm, x)
    ref, ref_reg = _jax_with_losses(jm, params, x, train=True)
    tm = tmisc.GatedMLP(8, 24, **opts)
    tm.load_state_dict(params_from_flax(params), strict=True)
    with torch.no_grad():
        got = tm(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), ref, atol=ATOL)
    assert float(regularization_loss(tm).detach()) == pytest.approx(
        ref_reg, rel=1e-5)


def test_value_compressor_matches_flax():
    x = _x((2, 5, 6, 3), scale=0.5)
    for kw in ({}, dict(alpha=2.0, beta=1.5)):
        ref = np.asarray(jmisc.ValueCompressor(**kw).apply(
            {}, jnp.asarray(x)))
        got = tmisc.ValueCompressor(**kw)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("opts", [
    {}, dict(use_logit_norm=True, use_bias=True, activation="relu")],
    ids=["plain", "logit-norm"])
def test_non_local_attention_matches_flax(opts):
    # a 16 x 16 map: 256 positions attend to each other
    x = _x((2, 16, 16, 12))
    jm = jatt.NonLocalAttention(attention_channels=8, **opts)
    params = _draw_params(jm, x)
    ref, ref_reg = _jax_with_losses(jm, params, x, train=True)
    tm = tatt.NonLocalAttention(12, 8, **opts)
    tm.load_state_dict(params_from_flax(params), strict=True)
    with torch.no_grad():
        got = tm(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), ref, atol=ATOL)
    assert float(regularization_loss(tm).detach()) == pytest.approx(
        ref_reg, rel=1e-5)


@pytest.mark.parametrize("name", ["SmoothChannelLearnableMultiplier",
                                  "GlobalLearnableMultiplier"])
def test_smooth_and_global_multipliers_match_flax(name):
    x = _x((2, 4, 5, 6))
    jm = getattr(jmult, name)()
    params = _draw_params(jm, x)
    ref, ref_reg = _jax_with_losses(jm, params, x)
    tm = (getattr(tmult, name)(6) if name.startswith("Smooth")
          else getattr(tmult, name)())
    tm.load_state_dict(params_from_flax(params), strict=True)
    with torch.no_grad():
        got = tm(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), ref, atol=ATOL)
    assert float(regularization_loss(tm).detach()) == pytest.approx(
        ref_reg, rel=1e-5)


def test_random_on_off_is_per_sample_drop():
    x = torch.ones(64, 3, 4, 4)
    m = RandomOnOff(rate=0.5)
    assert torch.equal(m(x), x)
    y = m(x, train=True, generator=torch.Generator().manual_seed(0))
    per_sample = y.flatten(1)
    assert set(per_sample.min(1).values.tolist()) <= {0.0, 2.0}
    assert torch.equal(per_sample.min(1).values, per_sample.max(1).values)
    assert 0 < int((per_sample[:, 0] == 0).sum()) < 64


def test_logit_norm_and_hard_sigmoid_match_jax():
    x = _x((3, 5, 7), scale=4.0)
    for kw in ({}, dict(t=0.5, axis=1)):
        np.testing.assert_allclose(
            tatt.logit_norm(torch.from_numpy(x), **kw).numpy(),
            np.asarray(jatt.logit_norm(jnp.asarray(x), **kw)), atol=ATOL)
    np.testing.assert_allclose(
        tact.hard_sigmoid(torch.from_numpy(x)).numpy(),
        np.asarray(jact.hard_sigmoid(jnp.asarray(x))), atol=0.0)
    assert tact.activation_fn("hard_sigmoid") is tact.hard_sigmoid


@pytest.mark.parametrize("name,kw", [
    ("clip_normalized", {}), ("clip_unnormalized", {}),
    ("global_normalization", {}), ("highpass_filter", {}),
    ("highpass_filter", dict(a=4.0, b=3.0)), ("lowpass_filter", {}),
    ("lowpass_filter", dict(a=4.0, b=4.0)), ("details", {}),
    ("local_normalization", dict(pool_size=(5, 7)))])
def test_normalize_ops_match_jax(name, kw):
    scale = 300.0 if name == "clip_unnormalized" else 0.4
    x = _x((2, 9, 8, 3), scale=scale, loc=0.05)
    ref = np.asarray(getattr(jnorm, name)(jnp.asarray(x), **kw))
    got = getattr(tnorm, name)(torch.from_numpy(x), **kw).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_loss_helpers_match_jax():
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 255, (2, 16, 16, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 20, a.shape), 0, 255).astype(np.float32)
    c = np.clip(a + rng.normal(0, 5, a.shape), 0, 255).astype(np.float32)
    ta, tb, tc = map(torch.from_numpy, (a, b, c))
    ja, jb, jc = map(jnp.asarray, (a, b, c))
    pairs = [
        (tlosses.mae_diff(ta - tb, hinge=2.0), jlosses.mae_diff(
            ja - jb, hinge=2.0)),
        (tlosses.rmse_diff(ta - tb, hinge=1.0), jlosses.rmse_diff(
            ja - jb, hinge=1.0)),
        (tlosses.gar_loss(ta - tb, alpha=0.5, c=3.0), jlosses.gar_loss(
            ja - jb, alpha=0.5, c=3.0)),
        (tlosses.improvement(ta, tb, tc), jlosses.improvement(ja, jb, jc)),
        (tssim.ssim_loss(ta, tb), jssim.ssim_loss(ja, jb)),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)


def test_default_norm_args_match_jax():
    from blind_image_denoising_tpu.layers import conv as jconv
    from blind_image_denoising_torch.layers import conv as tconv
    for use_bias in (False, True):
        assert tconv.default_bn_args(use_bias) == jconv.default_bn_args(
            use_bias)
        assert tconv.default_ln_args(use_bias) == jconv.default_ln_args(
            use_bias)
