"""The port's plain ops against their JAX counterparts on the same
numpy-seeded inputs, float32 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blind_image_denoising_tpu.layers import activations as jact
from blind_image_denoising_tpu.ops import noise_estimate as jnoise
from blind_image_denoising_tpu.ops.normalize import (denormalize as jdenormalize,
                                                     normalize as jnormalize)
from blind_image_denoising_tpu.ops import resize as jresize
from blind_image_denoising_torch.inference.blend import interp
from blind_image_denoising_torch.layers.activations import activation_fn
from blind_image_denoising_torch.ops import noise_estimate as tnoise
from blind_image_denoising_torch.ops import normalize as tnorm
from blind_image_denoising_torch.ops import resize as tresize


def _rand(shape, seed=0, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


@pytest.mark.parametrize("k", [2, 3, 5])
@pytest.mark.parametrize("stride", [1, 2])
def test_avg_pool_same_matches_jax(k, stride):
    x = _rand((2, 13, 10, 4), seed=k)
    ref = jresize.avg_pool_same(jnp.asarray(x), (k, k), (stride, stride))
    got = tresize.avg_pool_same(torch.from_numpy(x), (k, k),
                                (stride, stride))
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_upsample_2x_nearest_matches_jax():
    x = _rand((2, 5, 7, 3))
    np.testing.assert_array_equal(
        tresize.upsample_2x_nearest(torch.from_numpy(x)).numpy(),
        np.asarray(jresize.upsample_2x_nearest(jnp.asarray(x))))


@pytest.mark.parametrize("src,dst", [((64, 64), (16, 16)),
                                     ((40, 40), (16, 16)),
                                     ((16, 16), (64, 64)),
                                     ((48, 24), (16, 16))])
def test_resize_bilinear_matches_jax(src, dst):
    x = _rand((2,) + src + (5,), seed=sum(src))
    ref = jresize.resize_bilinear(jnp.asarray(x), dst)
    got = tresize.resize_bilinear(torch.from_numpy(x), dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("n", [10, 11, 4096])
def test_median_matches_numpy_convention(n):
    v = _rand((3, n), seed=n)
    np.testing.assert_allclose(
        tnoise.median_last(torch.from_numpy(v)).numpy(),
        np.asarray(jnp.median(jnp.asarray(v), axis=1)), rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(2, 34, 18, 3), (1, 66, 66, 3)])
def test_estimate_sigma_matches_jax(shape):
    # (H-2)(W-2)C is even for both shapes: the two-middle-value average
    rng = np.random.default_rng(3)
    clean = np.repeat(np.linspace(0, 200, shape[2], dtype=np.float32)[None],
                      shape[1], 0)[None, :, :, None] * np.ones(shape,
                                                               np.float32)
    x = np.clip(clean + rng.normal(0, 12, shape), 0, 255).astype(np.float32)
    ref = jnoise.estimate_sigma(jnp.asarray(x))
    got = tnoise.estimate_sigma(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    got3 = tnoise.estimate_sigma(torch.from_numpy(x[0]))
    assert got3.ndim == 0
    with pytest.raises(ValueError):
        tnoise.estimate_sigma(torch.zeros((1, 2, 9, 3)))


def test_normalize_round_trip_matches_jax():
    x = _rand((2, 4, 4, 3), lo=-20, hi=280)
    np.testing.assert_allclose(
        tnorm.normalize(torch.from_numpy(x)).numpy(),
        np.asarray(jnormalize(jnp.asarray(x))), atol=1e-7)
    y = _rand((2, 4, 4, 3), lo=-0.7, hi=0.7)
    np.testing.assert_allclose(
        tnorm.denormalize(torch.from_numpy(y)).numpy(),
        np.asarray(jdenormalize(jnp.asarray(y))), atol=1e-5)


@pytest.mark.parametrize("name", ["leaky_relu", "leaky_relu_01", "gelu",
                                  "relu", "hard_sigmoid", "mish", "linear"])
def test_activations_match_jax(name):
    x = _rand((64,), lo=-4, hi=4)
    np.testing.assert_allclose(
        activation_fn(name)(torch.from_numpy(x)).numpy(),
        np.asarray(jact.activation_fn(name)(jnp.asarray(x))), atol=1e-6)


def test_interp_matches_jnp_interp():
    xp = np.array([0.8, 1.3, 2.2, 2.2, 7.0, 20.0], np.float32)
    fp = np.array([0.0, 0.1, 0.5, 0.7, 0.9, 1.0], np.float32)
    x = np.array([-1.0, 0.8, 1.0, 2.2, 5.0, 19.9, 20.0, 50.0], np.float32)
    np.testing.assert_allclose(
        interp(torch.from_numpy(x), torch.from_numpy(xp),
               torch.from_numpy(fp)).numpy(),
        np.asarray(jnp.interp(x, xp, fp)), atol=1e-7)
