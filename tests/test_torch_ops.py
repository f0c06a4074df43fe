"""The port's plain ops against their JAX counterparts on the same
numpy-seeded inputs, float32 on the CPU: pooling and resizing, the
Gaussian blur and the bilinear 2× upsample (border rows included, atol
1e-5), the ``l1l2`` and ``erf`` regularizers (rtol 1e-5), and the int8
primitives: ``quantize`` and ``weight_scales`` codes equal, ``int8_conv``
and its int64 plain version ``int8_conv_reference`` equal to lax's int8 ×
int8 → int32 convolution, and a conv
site's int8 output bit-equal to JAX's rescale of the same accumulator."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blind_image_denoising_tpu.layers import activations as jact
from blind_image_denoising_tpu.ops import noise_estimate as jnoise
from blind_image_denoising_tpu.ops.normalize import (denormalize as jdenormalize,
                                                     normalize as jnormalize)
from blind_image_denoising_tpu.ops.normalize import (
    local_normalization as jlocal_normalization)
from blind_image_denoising_tpu.ops import gaussian as jgauss
from blind_image_denoising_tpu.ops import quant as jquant
from blind_image_denoising_tpu.ops import regularizers as jreg
from blind_image_denoising_tpu.ops import resize as jresize
from blind_image_denoising_torch.inference.blend import interp
from blind_image_denoising_torch.layers.activations import activation_fn
from blind_image_denoising_torch.ops import noise_estimate as tnoise
from blind_image_denoising_torch.ops import gaussian as tgauss
from blind_image_denoising_torch.ops import quant as tquant
from blind_image_denoising_torch.ops import regularizers as treg
from blind_image_denoising_torch.ops import resize as tresize

# the ops package exports the function normalize, as JAX's does, which
# shadows its module's name as an attribute
tnorm = importlib.import_module("blind_image_denoising_torch.ops.normalize")


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


def _oihw(hwio):
    return torch.from_numpy(np.ascontiguousarray(hwio.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("spec", [
    "l1l2", {"type": "l1l2", "config": {"l1": 0.02, "l2": 0.5}}, "erf",
    {"type": "erf", "config": {"l1_coefficient": 0.025,
                               "l2_coefficient": 0.3}},
    ["l1", {"type": "erf", "config": {"l1_coefficient": 0.1}}]])
@pytest.mark.parametrize("shape", [(3, 3, 1, 8), (5, 5, 4, 6), (1, 1, 8, 4),
                                   (7, 3, 2, 5)])
def test_l1l2_and_erf_regularizers_match_jax(spec, shape):
    w = _rand(shape, seed=len(shape))
    ref = float(jreg.builder(spec)(jnp.asarray(w)))
    got = float(treg.builder(spec)(_oihw(w)))
    assert got == pytest.approx(ref, rel=1e-5)


def test_erf_of_a_matrix_is_l1l2():
    w = _rand((6, 4), seed=3)
    ref = float(jreg.erf(jnp.asarray(w), 0.1, 0.2))
    assert float(treg.erf(torch.from_numpy(w), 0.1, 0.2)) == pytest.approx(
        ref, rel=1e-5)


@pytest.mark.parametrize("k,nsig", [((3, 3), None), ((5, 5), None),
                                    ((5, 3), (2.0, 1.0))])
@pytest.mark.parametrize("shape", [(2, 9, 12, 4), (1, 16, 16, 32)])
def test_gaussian_blur_matches_jax(k, nsig, shape):
    x = _rand(shape, seed=shape[-1], lo=0.0, hi=4.0)
    np.testing.assert_array_equal(
        tgauss.depthwise_gaussian_kernel(shape[-1], k, nsig or (1.0, 1.0)),
        jgauss.depthwise_gaussian_kernel(shape[-1], k, nsig or (1.0, 1.0)))
    ref = np.asarray(jgauss.gaussian_blur(jnp.asarray(x), k, nsig))
    got = tgauss.gaussian_blur(torch.from_numpy(x), k, nsig).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 16, 16, 32),
                                   (1, 1, 4, 2)])
def test_upsample_2x_bilinear_matches_jax(shape):
    x = _rand(shape, seed=7, lo=-3.0, hi=3.0)
    ref = np.asarray(jresize.upsample_2x_bilinear(jnp.asarray(x)))
    got = tresize.upsample_2x_bilinear(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    for rows in (slice(0, 1), slice(-1, None), slice(None)):
        np.testing.assert_allclose(got[:, rows], ref[:, rows], atol=1e-5)
        np.testing.assert_allclose(got[:, :, rows], ref[:, :, rows],
                                   atol=1e-5)


def test_local_normalization_matches_jax():
    x = _rand((2, 13, 11, 4), seed=4, lo=0.0, hi=5.0)
    ref = np.asarray(jlocal_normalization(jnp.asarray(x), (5, 5)))
    got = tnorm.local_normalization(torch.from_numpy(x), (5, 5)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_quantize_and_weight_scales_codes_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(0, 2, (2, 9, 7, 16)).astype(np.float32)
    # values on the rounding boundaries: half to even, and the clip
    x.flat[:6] = np.array([0.5, 1.5, -2.5, 300.0, -300.0, 0.0]) * 0.03
    s = np.float32(0.03)
    np.testing.assert_array_equal(
        tquant.quantize(torch.from_numpy(x), torch.tensor(s)).numpy(),
        np.asarray(jquant.quantize(jnp.asarray(x), jnp.asarray(s))))
    k = rng.normal(0, 0.3, (3, 3, 4, 8)).astype(np.float32)
    k[..., 5] = 0.0                            # an all-zero channel: eps
    js = np.asarray(jquant.weight_scales(jnp.asarray(k)))
    ts = tquant.weight_scales(_oihw(k)).numpy()
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(
        tquant.quantize(_oihw(k), torch.from_numpy(ts).view(-1, 1, 1, 1))
        .numpy().transpose(2, 3, 1, 0),
        np.asarray(jquant.quantize(jnp.asarray(k), jnp.asarray(js))))


@pytest.mark.parametrize("case", [
    dict(k=(5, 5, 3, 8), groups=1, strides=(1, 1), padding="SAME"),
    dict(k=(3, 3, 1, 32), groups=8, strides=(1, 1), padding="SAME"),
    dict(k=(1, 1, 4, 6), groups=2, strides=(1, 1), padding="SAME"),
    dict(k=(2, 2, 8, 4), groups=1, strides=(2, 2), padding="SAME"),
    dict(k=(3, 3, 8, 4), groups=1, strides=(2, 2), padding="VALID"),
    dict(k=(1, 1, 512, 128), groups=1, strides=(1, 1), padding="SAME")])
def test_int8_conv_accumulators_match_lax(case):
    rng = np.random.default_rng(6)
    cin = case["k"][2] * case["groups"]
    x8 = rng.integers(-127, 128, (2, 9, 11, cin)).astype(np.int8)
    k8 = rng.integers(-127, 128, case["k"]).astype(np.int8)
    ref = np.asarray(jquant.int8_conv(jnp.asarray(x8), jnp.asarray(k8),
                                      case["strides"], case["padding"],
                                      feature_group_count=case["groups"]))
    got = tquant.int8_conv(torch.from_numpy(x8).permute(0, 3, 1, 2),
                           _oihw(k8), case["strides"], case["padding"],
                           case["groups"])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)
    plain = tquant.int8_conv_reference(
        torch.from_numpy(x8).permute(0, 3, 1, 2), _oihw(k8),
        case["strides"], case["padding"], case["groups"])
    np.testing.assert_array_equal(plain.permute(0, 2, 3, 1).numpy(), ref)


def test_int8_conv_site_matches_jax_rescale():
    """One conv site in int8 mode: quantize, exact accumulator and the
    float32 rescale, bit-equal to JAX's chain on the same input."""
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (1, 12, 10, 16)).astype(np.float32)
    k = rng.normal(0, 0.2, (3, 3, 16, 8)).astype(np.float32)
    s_in = np.float32(np.abs(x).max() / 127.0)
    x8 = jquant.quantize(jnp.asarray(x), jnp.asarray(s_in))
    s_w = jquant.weight_scales(jnp.asarray(k))
    y32 = jquant.int8_conv(x8, jquant.quantize(jnp.asarray(k), s_w),
                           (1, 1), "SAME")
    ref = np.asarray(y32.astype(jnp.float32) * (s_in * s_w))

    site = torch.nn.Module()
    site.register_buffer("in_scale", torch.tensor(s_in))
    with tquant.quant_mode("int8"):
        got = tquant.conv2d(site, "in", torch.from_numpy(x).permute(
            0, 3, 1, 2), _oihw(k))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)
    # no scale, or an excluded path: the float path
    with tquant.quant_mode("int8", exclude=("^$",)):
        flt = tquant.conv2d(site, "in", torch.from_numpy(x).permute(
            0, 3, 1, 2), _oihw(k))
    assert not torch.equal(flt, got)
    with pytest.raises(ValueError, match="unknown quant mode"):
        with tquant.quant_mode("int4"):
            pass
