"""The port's layers against their flax counterparts with the same
parameters (carried across by ``params_from_flax``), float32 on the
CPU, atol 1e-4; the batch norms (flax ``nn.BatchNorm`` and
``BiasFreeBatchNorm``, from perturbed running statistics), conv blocks
with BatchNorm, bias, groups, depth multipliers and VALID padding, the
LayerNorm bias, the normalized heads and the legacy multipliers within
rtol 1e-5. The batch norms in train mode (batch statistics, and the
running update of their buffers, twice in a row) within 1e-6 of the
output's and of each statistic's largest magnitude (1e-5 behind a conv
block's conv)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blind_image_denoising_tpu.layers.attention import (
    ConvolutionalSelfAttention as JaxAttention)
import flax.linen as fnn

from blind_image_denoising_tpu.layers.conv import ConvBlock as JaxConvBlock
from blind_image_denoising_tpu.layers import multipliers as jmult
from blind_image_denoising_tpu.layers.multipliers import (
    ChannelLearnableMultiplier as JaxMultiplier)
from blind_image_denoising_tpu.layers.norm import (
    BiasFreeBatchNorm as JaxBiasFreeBatchNorm, FastLayerNorm as JaxLayerNorm)
from blind_image_denoising_tpu.models.hydra import (
    DenoiserHead as JaxDenoiserHead)
from blind_image_denoising_torch.layers.attention import (
    ConvolutionalSelfAttention)
from blind_image_denoising_torch.layers import multipliers as tmult
from blind_image_denoising_torch.layers.conv import ConvBlock
from blind_image_denoising_torch.layers.multipliers import (
    ChannelLearnableMultiplier)
from blind_image_denoising_torch.layers.norm import (
    BatchNorm, BiasFreeBatchNorm, FastLayerNorm, frozen_statistics,
    parse_bn_flag)
from blind_image_denoising_torch.models.hydra import DenoiserHead
from blind_image_denoising_torch.weights import params_from_flax


def _init(module, x, seed=0, perturb=0.0):
    variables = module.init({"params": jax.random.PRNGKey(seed)},
                            jnp.asarray(x))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    if perturb:
        rng = np.random.default_rng(seed)
        params = jax.tree_util.tree_map(
            lambda a: (a + rng.normal(0, perturb, a.shape)).astype(
                np.float32), params)
    return params


def _run_torch(module, params, x):
    module.load_state_dict(params_from_flax(params), strict=True)
    with torch.no_grad():
        y = module(torch.from_numpy(x).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).numpy()


def _x(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).normal(0, scale, shape)
            .astype(np.float32))


def test_fast_layer_norm_matches_flax():
    x = _x((2, 5, 7, 16), scale=3.0)
    jm = JaxLayerNorm(epsilon=1e-3)
    params = _init(jm, x, perturb=0.3)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = _run_torch(FastLayerNorm(16, epsilon=1e-3), params, x)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_channel_multiplier_matches_flax():
    x = _x((1, 3, 4, 8))
    jm = JaxMultiplier()
    params = _init(jm, x, perturb=0.5)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = _run_torch(ChannelLearnableMultiplier(8), params, x)
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("kernel,strides,hw", [(5, 1, (9, 14)),
                                               (2, 2, (10, 14)),
                                               (2, 2, (9, 13)),
                                               (3, 1, (8, 8)),
                                               (1, 1, (6, 5))])
def test_conv_block_matches_flax(kernel, strides, hw):
    x = _x((2,) + hw + (6,))
    jm = JaxConvBlock(features=10, kernel_size=kernel,
                      strides=(strides, strides),
                      activation="leaky_relu_01")
    params = _init(jm, x)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = _run_torch(ConvBlock(6, 10, kernel_size=kernel,
                               strides=(strides, strides),
                               activation="leaky_relu_01"), params, x)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("hw", [(64, 64), (24, 40)])
def test_self_attention_matches_flax(hw):
    C = 32
    x = _x((2,) + hw + (C,))
    jm = JaxAttention(attention_channels=8, use_ln=True,
                      attention_activation="leaky_relu",
                      use_soft_orthonormal_regularization=True)
    params = _init(jm, x, perturb=0.05)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = _run_torch(ConvolutionalSelfAttention(C, 8, use_ln=True), params,
                     x)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_denoiser_head_matches_flax():
    cfg = {"filters": 12, "use_bn": False, "use_ln": False,
           "use_bias": False, "activation": "leaky_relu_01",
           "output_channels": 3}
    x = _x((2, 6, 5, 16))
    jm = JaxDenoiserHead(cfg)
    params = _init(jm, x)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = _run_torch(DenoiserHead(cfg, 16), params, x)
    np.testing.assert_allclose(got, ref, atol=1e-5)


# ------------------------------------------------- batch norms and options

def _init_all(module, x, seed=0, perturb=0.3):
    """params and batch_stats of a flax init, perturbed from numpy; the
    variances and second moments stay positive."""
    variables = module.init({"params": jax.random.PRNGKey(seed)},
                            jnp.asarray(x))
    rng = np.random.default_rng(seed)

    def draw(path, a):
        a = np.asarray(a)
        if str(path[-1].key) in ("var", "mean_sq"):
            return rng.uniform(0.3, 3.0, a.shape).astype(np.float32)
        return (a + rng.normal(0, perturb, a.shape)).astype(np.float32)

    return {k: jax.tree_util.tree_map_with_path(draw, v)
            for k, v in variables.items() if k in ("params", "batch_stats")}


def _check(jm, tm, x, rtol=1e-5, atol=1e-6, seed=0, **kw):
    variables = _init_all(jm, x, seed=seed)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), **kw))
    tm.load_state_dict(params_from_flax(variables), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("use_bias", [False, True])
def test_batch_norm_inference_matches_flax(use_bias):
    x = _x((2, 5, 6, 12), scale=2.0)
    jm = fnn.BatchNorm(use_running_average=True, momentum=0.995,
                       epsilon=1e-3, use_bias=use_bias, use_scale=True)
    _check(jm, BatchNorm(12, use_bias=use_bias), x)


def test_bias_free_batch_norm_matches_flax():
    x = _x((2, 5, 6, 12), scale=2.0)
    _check(JaxBiasFreeBatchNorm(), BiasFreeBatchNorm(12), x)


def _rel(got, ref):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(ref)))
                 / max(float(np.max(np.abs(np.asarray(ref)))), 1e-30))


@pytest.mark.parametrize("which", ["bn", "bn_bias", "bias_free",
                                   "conv_block", "conv_block_bias_free"])
def test_batch_norm_train_mode_matches_flax(which):
    """Train mode against flax with ``mutable=["batch_stats"]``: the
    output normalized by the batch's statistics (biased fast variance)
    and the running update with flax's momentum, twice in a row; inside
    ``frozen_statistics`` the output is the same and the buffers stay."""
    x = _x((3, 5, 6, 12), scale=2.0) + 0.7
    kw = {}
    if which.startswith("conv_block"):
        x = _x((3, 7, 6, 8), scale=2.0)
        opts = dict(kernel_size=3, use_bn=True,
                    bn_bias_free=which.endswith("bias_free"))
        jm = JaxConvBlock(features=12, activation="relu", **opts)
        tm = ConvBlock(8, 12, activation="relu", **opts)
        kw = dict(train=True)
    elif which == "bias_free":
        jm, tm = (JaxBiasFreeBatchNorm(use_running_average=False),
                  BiasFreeBatchNorm(12))
    else:
        use_bias = which == "bn_bias"
        jm = fnn.BatchNorm(use_running_average=False, momentum=0.995,
                           epsilon=1e-3, use_bias=use_bias, use_scale=True)
        tm = BatchNorm(12, use_bias=use_bias)
    variables = _init_all(jm, x)
    tm.load_state_dict(params_from_flax(variables), strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    bar = 1e-5 if which.startswith("conv_block") else 1e-6
    for call in range(2):
        ref, mutated = jm.apply(variables, jnp.asarray(x), **kw,
                                mutable=["batch_stats"])
        variables = dict(variables, batch_stats=mutated["batch_stats"])
        with torch.no_grad():
            got = tm(xt, train=True).permute(0, 2, 3, 1).numpy()
        assert _rel(got, ref) <= bar, (call, _rel(got, ref))
        stats = params_from_flax({"params": {}, "batch_stats": jax.tree_util
                                  .tree_map(np.asarray,
                                            mutated["batch_stats"])})
        buffers = dict(tm.named_buffers())
        assert set(stats) == set(buffers)
        for name, v in stats.items():
            assert _rel(buffers[name], v) <= bar, (call, name)
        x = x * 1.5 - 0.3
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    before = {n: b.clone() for n, b in tm.named_buffers()}
    with torch.no_grad(), frozen_statistics():
        frozen = tm(xt, train=True)
    for n, b in tm.named_buffers():
        assert torch.equal(b, before[n]), n
    with torch.no_grad():
        assert torch.equal(tm(xt, train=True), frozen)


def test_parse_bn_flag():
    assert parse_bn_flag("bias_free") == (True, True)
    assert parse_bn_flag(True) == (True, False)
    with pytest.raises(ValueError):
        parse_bn_flag("other")


def test_layer_norm_bias_matches_flax():
    x = _x((2, 5, 7, 16), scale=3.0)
    jm = JaxLayerNorm(epsilon=1e-3, use_bias=True)
    _check(jm, FastLayerNorm(16, epsilon=1e-3, use_bias=True), x, rtol=1e-4,
           atol=1e-5)


@pytest.mark.parametrize("opts", [
    dict(kernel_size=3, use_bn=True),
    dict(kernel_size=3, use_bn=True, bn_center=True, use_bias=True),
    dict(kernel_size=3, use_bn=True, bn_bias_free=True),
    dict(kernel_size=1, groups=2, use_bn=True),
    dict(kernel_size=3, depth_multiplier=4, use_bn=True),
    dict(kernel_size=5, depth_multiplier=1, padding="VALID"),
    dict(kernel_size=3, strides=2, padding="VALID", use_bias=True),
    dict(kernel_size=1, use_ln=True, bn_center=True),
])
def test_conv_block_options_match_flax(opts):
    x = _x((2, 11, 9, 8))
    jopts = dict(opts)
    topts = dict(opts)
    if "strides" in opts:
        jopts["strides"] = topts["strides"] = (opts["strides"],) * 2
    features = 0 if "depth_multiplier" in opts else 12
    jm = JaxConvBlock(features=features, activation="relu", **jopts)
    tm = ConvBlock(8, features, activation="relu", **topts)
    _check(jm, tm, x, rtol=1e-5, atol=1e-5)


def test_depth_multiplier_reads_input_o_div_m():
    """Output channel o of a depthwise conv with multiplier m reads input
    channel o // m, as in lax."""
    tm = ConvBlock(2, kernel_size=1, depth_multiplier=3)
    with torch.no_grad():
        tm.kernel.copy_(torch.arange(1.0, 7.0).view(6, 1, 1, 1))
        y = tm(torch.tensor([1.0, 10.0]).view(1, 2, 1, 1)).flatten()
    assert y.tolist() == [1.0, 2.0, 3.0, 40.0, 50.0, 60.0]


@pytest.mark.parametrize("head", [dict(use_bn=True), dict(use_ln=True),
                                  dict(use_bn="bias_free", use_bias=True)])
def test_normalized_denoiser_heads_match_flax(head):
    cfg = dict({"filters": 12, "activation": "relu", "output_channels": 3},
               **head)
    x = _x((2, 6, 5, 16))
    _check(JaxDenoiserHead(cfg), DenoiserHead(cfg, 16), x, rtol=1e-5,
           atol=1e-5)


@pytest.mark.parametrize("name", ["Multiplier", "ChannelwiseMultiplier"])
def test_legacy_multipliers_match_flax(name):
    x = _x((2, 4, 3, 6))
    jm = getattr(jmult, name)(multiplier=1.0, activation="relu",
                              l1_coefficient=0.1)
    tm = (tmult.Multiplier(1.0, "relu", 0.1) if name == "Multiplier"
          else tmult.ChannelwiseMultiplier(6, 1.0, "relu", 0.1))
    _check(jm, tm, x)


# ------------------------------------- sampling, gates and the new conv forms

from blind_image_denoising_tpu.layers.attention import (  # noqa: E402
    AdditiveAttentionGate as JaxGate)
from blind_image_denoising_tpu.layers.misc import (  # noqa: E402
    GaussianFilter as JaxGaussianFilter)
from blind_image_denoising_tpu.layers.sampling import (  # noqa: E402
    Downsample as JaxDownsample, Upsample as JaxUpsample)
from blind_image_denoising_tpu.ops import resize as jresize  # noqa: E402
from blind_image_denoising_torch.layers.attention import (  # noqa: E402
    AdditiveAttentionGate)
from blind_image_denoising_torch.layers.conv import dropout  # noqa: E402
from blind_image_denoising_torch.layers.misc import (  # noqa: E402
    GaussianFilter)
from blind_image_denoising_torch.layers.sampling import (  # noqa: E402
    Downsample, Upsample)
from blind_image_denoising_torch.ops import resize as tresize  # noqa: E402

_SAMPLING_PARAMS = dict(kernel_size=5, filters=6, activation="leaky_relu_01",
                        strides=(1, 1), padding="same", use_bias=False)


@pytest.mark.parametrize("kind,activation", [
    ("conv2d_transpose", "leaky_relu_01"),
    ("upsample_bilinear_conv2d", "leaky_relu_01"),
    ("upsample_nearest_conv2d", "leaky_relu_01"),
    ("upsample_laplacian_conv2d", "leaky_relu_01"),
    ("upsample_laplacian_conv2d", "linear"),
    ("nn", None), ("nearest", None), ("bilinear", None)])
def test_upsample_types_match_flax(kind, activation):
    """Every JAX ``Upsample`` type, both orders of the Laplacian one
    (conv first with a linear activation)."""
    x = _x((2, 7, 9, 8))
    params = (None if activation is None
              else dict(_SAMPLING_PARAMS, activation=activation))
    jm = JaxUpsample(kind, params)
    _check(jm, Upsample(kind, 8, params), x, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind,with_conv", [
    ("conv2d", True), ("maxpool", True), ("maxpool", False),
    ("strides", True), ("strides", False)])
@pytest.mark.parametrize("hw", [(8, 10), (7, 9)])
def test_downsample_types_match_flax(kind, with_conv, hw):
    x = _x((2,) + hw + (8,))
    params = _SAMPLING_PARAMS if with_conv else None
    jm = JaxDownsample(kind, params)
    _check(jm, Downsample(kind, 8, params), x, rtol=0, atol=1e-5)


def test_unknown_sampling_types_raise_value_error():
    with pytest.raises(ValueError, match="upsample_type"):
        Upsample("cubic", 8, _SAMPLING_PARAMS)
    with pytest.raises(ValueError, match="downsample_type"):
        Downsample("avgpool", 8, _SAMPLING_PARAMS)


@pytest.mark.parametrize("opts", [
    dict(transpose=True, kernel_size=5, strides=2),
    dict(transpose=True, kernel_size=2, strides=2, use_bias=True),
    dict(transpose=True, kernel_size=3, strides=1),
    dict(transpose=True, kernel_size=4, strides=2, padding="VALID"),
    dict(separable=True, kernel_size=3, strides=1),
    dict(separable=True, kernel_size=5, strides=2, use_bias=True),
])
def test_transposed_and_separable_conv_blocks_match_flax(opts):
    x = _x((2, 7, 6, 8))
    jopts = dict(opts, strides=(opts["strides"],) * 2)
    jm = JaxConvBlock(features=10, activation="relu", **jopts)
    tm = ConvBlock(8, 10, activation="relu", **jopts)
    _check(jm, tm, x, rtol=0, atol=1e-5)
    # the regularizer sums every kernel, as the sown losses do
    jm_reg = JaxConvBlock(features=10, kernel_regularizer="l2", **jopts)
    variables = _init_all(jm_reg, x)
    _, sown = jm_reg.apply(variables, jnp.asarray(x), mutable=["losses"])
    ref = sum(float(v) for v in jax.tree_util.tree_leaves(sown))
    tm_reg = ConvBlock(8, 10, kernel_regularizer="l2", **jopts)
    tm_reg.load_state_dict(params_from_flax(variables), strict=True)
    assert abs(float(tm_reg.penalty().detach()) - ref) <= 1e-5 * ref


@pytest.mark.parametrize("norm", ["ln", "bn"])
@pytest.mark.parametrize("train", [False, True])
def test_additive_attention_gate_matches_flax(norm, train):
    """The gate with LayerNorm or BatchNorm before its 1×1 convs, in eval
    and in train mode (batch statistics and the running update of each
    BatchNorm within 1e-5 of its largest magnitude)."""
    enc, up = _x((3, 6, 5, 8), scale=2.0), _x((3, 6, 5, 12), seed=2) + 0.4
    opts = dict(use_bn=norm == "bn", use_ln=norm == "ln", use_bias=True,
                use_soft_orthonormal_regularization=True)
    jm = JaxGate(attention_channels=6, **opts)
    variables = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(enc),
                        jnp.asarray(up))
    rng = np.random.default_rng(4)

    def draw(path, a):
        a = np.asarray(a)
        if str(path[-1].key) == "var":
            return rng.uniform(0.3, 3.0, a.shape).astype(np.float32)
        return (a + rng.normal(0, 0.3, a.shape)).astype(np.float32)

    variables = {k: jax.tree_util.tree_map_with_path(draw, v)
                 for k, v in variables.items()
                 if k in ("params", "batch_stats")}
    tm = AdditiveAttentionGate(8, 12, 6, **opts)
    tm.load_state_dict(params_from_flax(variables), strict=True)
    args = (jnp.asarray(enc), jnp.asarray(up))
    if train:
        ref, mutated = jm.apply(variables, *args, train=True,
                                mutable=["batch_stats"])
    else:
        ref = jm.apply(variables, *args)
    with torch.no_grad():
        got = tm(torch.from_numpy(enc).permute(0, 3, 1, 2),
                 torch.from_numpy(up).permute(0, 3, 1, 2), train=train)
    got = got.permute(0, 2, 3, 1).numpy()
    assert _rel(got, ref) <= 1e-5
    if train and norm == "bn":
        stats = params_from_flax({"params": {}, "batch_stats": jax.tree_util
                                  .tree_map(np.asarray,
                                            mutated["batch_stats"])})
        buffers = dict(tm.named_buffers())
        assert set(stats) == set(buffers) and stats
        for name, v in stats.items():
            assert _rel(buffers[name], v) <= 1e-5, name


def test_attention_gate_refuses_bn_with_ln():
    with pytest.raises(ValueError, match="mutually exclusive"):
        AdditiveAttentionGate(8, 8, 4, use_bn=True, use_ln=True)


def test_self_attention_with_batch_norm_matches_flax():
    x = _x((2, 20, 24, 16))
    jm = JaxAttention(attention_channels=8, use_bn=True, use_ln=True,
                      bn_center=True, attention_activation="leaky_relu",
                      use_soft_orthonormal_regularization=True)
    tm = ConvolutionalSelfAttention(16, 8, use_ln=True, use_bn=True,
                                    bn_center=True)
    _check(jm, tm, x, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kernel,strides", [((3, 3), (1, 1)),
                                            ((5, 5), (1, 1)),
                                            ((2, 2), (2, 2))])
def test_gaussian_filter_matches_flax(kernel, strides):
    x = _x((2, 9, 11, 5), scale=3.0)
    jm = JaxGaussianFilter(kernel_size=kernel, strides=strides)
    ref = np.asarray(jm.apply({}, jnp.asarray(x)))
    with torch.no_grad():
        got = GaussianFilter(kernel, strides)(
            torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("op", ["max_pool_same", "global_avg_pool",
                                "downsample_2x_stride", "space_to_depth",
                                "depth_to_space"])
def test_new_resize_ops_match_jax_exactly(op):
    x = _x((2, 6, 10, 8), scale=5.0)
    if op == "max_pool_same":
        for window, strides, hw in (((2, 2), (2, 2), (6, 10)),
                                    ((3, 3), (2, 2), (5, 7)),
                                    ((2, 2), (1, 1), (5, 7))):
            xi = np.ascontiguousarray(x[:, :hw[0], :hw[1]])
            ref = np.asarray(jresize.max_pool_same(jnp.asarray(xi), window,
                                                   strides))
            got = tresize.max_pool_same(torch.from_numpy(xi), window, strides)
            np.testing.assert_array_equal(got.numpy(), ref)
        return
    if op == "global_avg_pool":
        ref = np.asarray(jresize.global_avg_pool(jnp.asarray(x)))
        got = tresize.global_avg_pool(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        return
    args = (2,) if op in ("space_to_depth", "depth_to_space") else ()
    ref = np.asarray(getattr(jresize, op)(jnp.asarray(x), *args))
    got = getattr(tresize, op)(torch.from_numpy(x), *args)
    np.testing.assert_array_equal(got.numpy(), ref)
    if op == "space_to_depth":
        assert torch.equal(tresize.depth_to_space(got, 2),
                           torch.from_numpy(x))


@pytest.mark.parametrize("channels", [False, True])
def test_dropout_masks(channels):
    """Rate 0 and eval are the identity; in training the kept share is
    within 3σ of 1 − rate, kept values are scaled by 1/(1 − rate), and a
    spatial mask drops whole channels per sample."""
    x = torch.ones((64, 32, 8, 8))
    g = torch.Generator().manual_seed(0)
    assert torch.equal(dropout(x, 0.0, g, channels), x)
    block = ConvBlock(4, 4, kernel_size=1, dropout_rate=0.0 if channels
                      else 0.3, spatial_dropout_rate=0.3 if channels
                      else 0.0)
    with torch.no_grad():
        block.kernel.copy_(torch.eye(4).view(4, 4, 1, 1))
    xb = torch.rand((2, 4, 5, 5))
    with torch.no_grad():
        assert torch.equal(block(xb), xb)
    rate = 0.3
    y = dropout(x, rate, g, channels)
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / (1 - rate)))
    if channels:
        per = kept.float().mean(dim=(2, 3))
        assert bool(((per == 0) | (per == 1)).all())
        n = per.numel()
        share = float(per.mean())
    else:
        n = kept.numel()
        share = float(kept.float().mean())
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(share - (1 - rate)) <= 3 * sigma, share
