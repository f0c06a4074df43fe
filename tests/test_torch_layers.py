"""The port's layers against their flax counterparts with the same
parameters (carried across by ``params_from_flax``), float32 on the
CPU, atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blind_image_denoising_tpu.layers.attention import (
    ConvolutionalSelfAttention as JaxAttention)
from blind_image_denoising_tpu.layers.conv import ConvBlock as JaxConvBlock
from blind_image_denoising_tpu.layers.multipliers import (
    ChannelLearnableMultiplier as JaxMultiplier)
from blind_image_denoising_tpu.layers.norm import (
    FastLayerNorm as JaxLayerNorm)
from blind_image_denoising_tpu.models.hydra import (
    DenoiserHead as JaxDenoiserHead)
from blind_image_denoising_torch.layers.attention import (
    ConvolutionalSelfAttention)
from blind_image_denoising_torch.layers.conv import ConvBlock
from blind_image_denoising_torch.layers.multipliers import (
    ChannelLearnableMultiplier)
from blind_image_denoising_torch.layers.norm import FastLayerNorm
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
