"""The plain PyTorch versions of the port's ConvNext-unit and band-split
kernels against the JAX functions they replace, on the CPU, and the
wrappers' CPU dispatch (the noise kernel K3 has its own file,
``test_torch_noise.py``).

* K2 (band split): ``band_smooth_plain`` vs ``laplacian_band_smooth_pallas``
  in Pallas interpret mode and vs ``laplacian_band_smooth_reference``,
  atol 1e-4 (the JAX kernel tests' bar).
* K2 backward: ``band_smooth_bwd_plain`` and the gradient of the
  ``band_smooth`` autograd function vs JAX ``_band_smooth_bwd`` and
  ``jax.vjp`` of ``laplacian_band_smooth_reference``, rtol = atol = 1e-5
  (the JAX VJP test's bar), and ``torch.autograd.gradcheck`` in float64.
* K1 (ConvNext unit): ``convnext_block_plain`` vs
  ``convnext_block_reference`` at atol 1e-4 in float32; vs
  ``fused_convnext_block(..., interpret=True)`` float mode at atol 0.05
  (that kernel's bf16 matmuls); and the port's ``ConvNextBlock`` module
  vs the linen ``ConvNextBlock`` + skip with the same parameters.
* K1's int8 mode: ``quantize`` vs ``quantize_cf`` exactly (the same f32
  multiply by the reciprocal, round half to even, clip to ±127); the
  plain int8 unit vs ``fused_convnext_block(xq, …, interpret=True)``
  with |Δcode| ≤ 1 and ≥ 99.9% of codes equal (the two sum the products
  in another order, which moves a code whose pre-rounding value sits
  near x.5), and within JAX's own ``3·max(s_in, s_out)`` of the float
  oracle.
* K1's float32 mode: a test-local emulation of its 3xTF32 products (big
  rounded to nearest or truncated) within 1e-5 of the plain output's
  largest entry, on the packaged flagship's units and seeded weights at
  every kernel shape; one TF32 pass misses 1e-3 on the flagship's units.
  Every K1 plan (``kernel_plan``) fits shared memory, with the bytes the
  source's header note states.
* K4's tile plan (``split_tile_plan``, the mirror of the kernel's) fits
  shared memory and gives every thread whole vectors of whole quads.
* K4 (band split with decimation): ``band_split_plain`` vs
  ``laplacian_band_split_pallas`` in Pallas interpret mode and vs
  ``laplacian_band_split_reference``, atol 1e-4 in float32. In
  bfloat16 the JAX kernel sums the taps in bf16 and the port in float32,
  so the two differ by the JAX kernel's own error (up to 2.2 on its
  bf16 test's case, past that test's 2.0 bar against its reference): the
  port is held to one bf16 ulp of the float32 reference on the same bf16
  inputs, and to no more error against it than the JAX kernel has.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from blind_image_denoising_tpu.layers.convnext import (
    ConvNextBlock as JaxConvNextBlock)
from blind_image_denoising_tpu.ops.pallas_convnext import (
    convnext_block_reference, from_cf_padded, fused_convnext_block,
    quantize_cf, to_cf_padded)
from blind_image_denoising_tpu.ops.pallas_pyramid import (
    _band_smooth_bwd, laplacian_band_smooth_pallas,
    laplacian_band_smooth_reference, laplacian_band_split_pallas,
    laplacian_band_split_reference)
from blind_image_denoising_torch.layers import convnext as convnext_mod
from blind_image_denoising_torch.layers.convnext import ConvNextBlock
from blind_image_denoising_torch.ops import pallas_convnext, pallas_pyramid
from blind_image_denoising_torch.weights import params_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("k", [2, 3, 5])
def test_band_smooth_plain_matches_jax(k):
    x = np.random.default_rng(1).uniform(0, 255, (2, 32, 16, 3)).astype(
        np.float32)
    band, smooth = pallas_pyramid.band_smooth_plain(torch.from_numpy(x), k)
    for fn in (lambda v: laplacian_band_smooth_pallas(v, k, interpret=True),
               lambda v: laplacian_band_smooth_reference(v, k)):
        band_j, smooth_j = fn(jnp.asarray(x))
        np.testing.assert_allclose(band.numpy(), np.asarray(band_j),
                                   atol=1e-4)
        np.testing.assert_allclose(smooth.numpy(), np.asarray(smooth_j),
                                   atol=1e-4)


@pytest.mark.parametrize("k", [2, 3, 5])
def test_band_split_plain_matches_jax(k):
    x = np.random.default_rng(0).uniform(0, 255, (2, 32, 16, 3)).astype(
        np.float32)
    band, down = pallas_pyramid.band_split_plain(torch.from_numpy(x), k)
    assert down.shape == (2, 16, 8, 3)
    for fn in (lambda v: laplacian_band_split_pallas(v, k, interpret=True),
               lambda v: laplacian_band_split_reference(v, k)):
        band_j, down_j = fn(jnp.asarray(x))
        np.testing.assert_allclose(band.numpy(), np.asarray(band_j),
                                   atol=1e-4)
        np.testing.assert_allclose(down.numpy(), np.asarray(down_j),
                                   atol=1e-4)


@pytest.mark.parametrize("k", [2, 3, 5])
def test_band_split_plain_bf16(k):
    x = np.random.default_rng(2).uniform(0, 255, (1, 32, 16, 3))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xf = xt.float().numpy()
    outs = pallas_pyramid.band_split_plain(xt, k)
    refs = laplacian_band_split_reference(jnp.asarray(xf), k)
    jax_outs = laplacian_band_split_pallas(
        jnp.asarray(xf).astype(jnp.bfloat16), k, interpret=True)
    for got, ref, jax_got in zip(outs, refs, jax_outs):
        assert got.dtype == torch.bfloat16
        ref = torch.from_numpy(np.array(ref))
        ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(
            2.0 ** -126))) - 7)
        err = (got.float() - ref).abs()
        assert bool((err <= ulp).all())
        jax_err = (torch.from_numpy(np.array(jax_got, np.float32))
                   - ref).abs()
        assert float(err.max()) <= float(jax_err.max())


def test_band_split_wrapper_contract():
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (1, 6, 8, 8)).astype(np.float32))
    n = pallas_pyramid.split_launches
    band, down = pallas_pyramid.band_split(x, 2)
    band_p, down_p = pallas_pyramid.band_split_plain(x, 2)
    assert torch.equal(band, band_p) and torch.equal(down, down_p)
    assert pallas_pyramid.split_launches == n
    smooth = pallas_pyramid.band_smooth_plain(x, 2)[1]
    assert torch.equal(down, smooth[:, ::2, ::2])
    with pytest.raises(ValueError, match="even"):
        pallas_pyramid.band_split(x[:, :5], 2)
    with pytest.raises(RuntimeError, match="backward"):
        pallas_pyramid.band_split(x.clone().requires_grad_(True), 2)
    with torch.no_grad():
        pallas_pyramid.band_split(x.clone().requires_grad_(True), 2)


def _vjp_case(k, seed=2, c=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (2, 16, 8, c)).astype(np.float32)
    g_band = rng.normal(size=x.shape).astype(np.float32)
    g_smooth = rng.normal(size=x.shape).astype(np.float32)
    _, vjp_fn = jax.vjp(lambda v: laplacian_band_smooth_reference(v, k),
                        jnp.asarray(x))
    (dx_vjp,) = vjp_fn((jnp.asarray(g_band), jnp.asarray(g_smooth)))
    (dx_custom,) = _band_smooth_bwd(k, None, (jnp.asarray(g_band),
                                              jnp.asarray(g_smooth)))
    return x, g_band, g_smooth, (np.asarray(dx_vjp), np.asarray(dx_custom))


@pytest.mark.parametrize("k", [2, 3, 5])
def test_band_smooth_bwd_plain_matches_jax(k):
    _, g_band, g_smooth, refs = _vjp_case(k)
    got = pallas_pyramid.band_smooth_bwd_plain(
        torch.from_numpy(g_band), torch.from_numpy(g_smooth), k).numpy()
    for ref in refs:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


# C of no whole 16-byte vectors, which K2's backward and K4 take on the
# card since slice 20: 108 (a filters_level_multiplier 1.5 v6's level 3),
# 36, 6 and 3
RAGGED_C = [108, 36, 6, 3]


@pytest.mark.parametrize("c", RAGGED_C)
def test_band_smooth_bwd_plain_matches_jax_at_ragged_c(c):
    """K2's backward's plain version at a ragged C against JAX's
    ``_band_smooth_bwd`` and ``jax.vjp`` of its reference, rtol = atol =
    1e-5 (the JAX VJP test's bar)."""
    _, g_band, g_smooth, refs = _vjp_case(2, seed=8, c=c)
    got = pallas_pyramid.band_smooth_bwd_plain(
        torch.from_numpy(g_band), torch.from_numpy(g_smooth), 2).numpy()
    for ref in refs:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c", RAGGED_C)
def test_band_split_plain_matches_jax_at_ragged_c(c):
    """K4's plain version at a ragged C against JAX's
    ``laplacian_band_split_pallas`` in interpret mode, atol 1e-4."""
    x = np.random.default_rng(9).uniform(0, 255, (2, 16, 16, c)).astype(
        np.float32)
    band, down = pallas_pyramid.band_split_plain(torch.from_numpy(x), 2)
    band_j, down_j = laplacian_band_split_pallas(jnp.asarray(x), 2,
                                                 interpret=True)
    np.testing.assert_allclose(band.numpy(), np.asarray(band_j), atol=1e-4)
    np.testing.assert_allclose(down.numpy(), np.asarray(down_j), atol=1e-4)


@pytest.mark.parametrize("k", [2, 3, 5])
def test_band_smooth_autograd_matches_jax_vjp(k):
    x, g_band, g_smooth, refs = _vjp_case(k, seed=3)
    xt = torch.from_numpy(x).requires_grad_(True)
    band, smooth = pallas_pyramid.band_smooth(xt, k)
    (dx,) = torch.autograd.grad((band, smooth), xt,
                                (torch.from_numpy(g_band),
                                 torch.from_numpy(g_smooth)))
    for ref in refs:
        np.testing.assert_allclose(dx.numpy(), ref, rtol=1e-5, atol=1e-5)
    # the grads as the model hands them over: permuted, not NHWC-contiguous
    gb = torch.from_numpy(g_band).permute(0, 3, 1, 2).contiguous()
    gs = torch.from_numpy(g_smooth).permute(0, 3, 1, 2).contiguous()
    got = pallas_pyramid.band_smooth_bwd(gb.permute(0, 2, 3, 1),
                                         gs.permute(0, 2, 3, 1), k)
    np.testing.assert_allclose(got.numpy(), refs[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [2, 3])
def test_band_smooth_gradcheck_float64(k):
    x = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (1, 5, 6, 2))).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda v: pallas_pyramid.band_smooth(v, k), (x,), eps=1e-6,
        atol=1e-7)


def test_band_smooth_without_grad_is_the_forward_only():
    x = torch.ones((1, 4, 4, 8), requires_grad=True)
    with torch.no_grad():
        band, smooth = pallas_pyramid.band_smooth(x, 2)
    assert band.grad_fn is None and smooth.grad_fn is None
    with torch.inference_mode():
        band, smooth = pallas_pyramid.band_smooth(x, 2)
    assert band.grad_fn is None and smooth.grad_fn is None
    band, smooth = pallas_pyramid.band_smooth(x.detach(), 2)
    assert band.grad_fn is None and smooth.grad_fn is None
    band, smooth = pallas_pyramid.band_smooth(x, 2)
    assert band.grad_fn is not None


def _jax_weights(C, K, seed=0, e=None):
    rng = np.random.default_rng(seed)
    E = 4 * C if e is None else e
    return dict(
        dw_w=rng.normal(0, 0.3, (C, K * K)).astype(np.float32),
        ln_scale=rng.uniform(0.5, 1.5, (C, 1)).astype(np.float32),
        w2=rng.normal(0, 0.2, (E, C)).astype(np.float32),
        w3=rng.normal(0, 0.2, (C, E)).astype(np.float32),
        gamma_gain=rng.uniform(0.3, 0.9, (C, 1)).astype(np.float32))


def _torch_args(w, C, K):
    t = torch.from_numpy
    return dict(dw=t(w["dw_w"]).reshape(C, 1, K, K),
                ln_scale=t(w["ln_scale"]).reshape(C),
                w2=t(w["w2"]), w3=t(w["w3"]),
                gain=t(w["gamma_gain"]).reshape(C))


@pytest.mark.parametrize("ck", [(32, 3), (64, 5), (32, 5), (128, 5),
                                (256, 5), (108, 5), (48, 5), (64, 3),
                                (128, 3), (32, 7), (64, 7), (108, 7),
                                (256, 7), (384, 5), (512, 5), (640, 5),
                                (640, 7), (1024, 5), (1024, 7), (72, 5),
                                (88, 3), (1040, 5), (2048, 3), (32, 9),
                                (48, 5, 96)])
def test_convnext_plain_matches_jax_reference_and_pallas(ck):
    """The plain version against JAX's reference (atol 1e-4) and JAX's
    Pallas kernel in interpret mode, which rounds t and h to bf16: no
    farther from it, element by element, than JAX's own reference is
    (+1e-4), and within its bar of 0.05 at C <= 64. From C = 108 these
    weights (std 0.2 at every C) give outputs up to 27 (C = 128) and more,
    and JAX's kernel misses that bar against its own reference (0.070 on
    0.03% of the elements at C = 128, about 2.6e-3 of max |out|, as at
    C <= 64). Above C = 512 (the cluster classes' widths) the outputs reach
    160 (C = 640) and 233 (C = 1024), where float32's summation order
    alone moves an output by up to 1.6e-4 (ten float32 ulps of 233): there
    the atol is 1e-6 of max |out| (2.3e-4 at C = 1024), and the images
    are 2 rows high, which keeps the two references cheap. The general
    route's shapes are held the same way: C above 1024 ((1040, 5), (2048,
    3); (2048, 1) is held to the reference alone below, as JAX's kernel
    cannot run K = 1 in interpret mode: its zero-row pad copy), K = 9, and
    E = 2C at (48, 5) (a third entry: E)."""
    C, K, E = ck if len(ck) == 3 else (*ck, 4 * ck[0])
    H, W = (8, 128) if C <= 512 else (2, 128)  # Pallas tiles 128 lanes
    w = _jax_weights(C, K, e=E)
    x = np.random.default_rng(2).normal(0, 1, (2, H, W, C)).astype(
        np.float32)
    got = pallas_convnext.convnext_block_plain(torch.from_numpy(x),
                                               **_torch_args(w, C, K))
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    ref = np.asarray(convnext_block_reference(jnp.asarray(x), jw))
    atol = 1e-4 if C <= 512 else 1e-6 * float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, atol=atol)
    pad = K // 2
    fused = np.asarray(from_cf_padded(fused_convnext_block(
        to_cf_padded(jnp.asarray(x), pad=pad), **jw, H=H, W=W, pad=pad,
        rows=H // 2, interpret=True), H=H, W=W, pad=pad))
    assert bool((np.abs(got.numpy() - fused)
                 <= np.abs(ref - fused) + atol).all())
    if C <= 64:
        np.testing.assert_allclose(got.numpy(), fused, atol=0.05)


@pytest.mark.parametrize("ck", [(32, 1), (64, 1), (128, 1), (256, 1),
                                (72, 1), (2048, 1)])
def test_convnext_plain_at_k1_matches_jax_reference(ck):
    """K1's plain version at K = 1 (the decoders of unet_laplacian_v3,
    _v4 and _v5: one depthwise tap, no halo; the classes' widths; and the
    general route at C = 2048) against JAX's ``convnext_block_reference``,
    float32, atol 1e-4 (above C = 512, where these weights give outputs in
    the hundreds, 1e-6 of max |out|, as the Pallas test above)."""
    C, K = ck
    w = _jax_weights(C, K, seed=5)
    x = np.random.default_rng(6).normal(0, 1, (2, 9, 13, C)).astype(
        np.float32)
    got = pallas_convnext.convnext_block_plain(torch.from_numpy(x),
                                               **_torch_args(w, C, K))
    ref = np.asarray(convnext_block_reference(jnp.asarray(x), {
        k: jnp.asarray(v) for k, v in w.items()}))
    atol = 1e-4 if C <= 512 else 1e-6 * float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, atol=atol)
    assert pallas_convnext.kernel_supports(C, K, 4 * C)


@pytest.mark.parametrize("ck", [(32, 3), (64, 5), (32, 1), (64, 1)])
def test_convnext_module_matches_linen_block_plus_skip(ck):
    C, K = ck
    E = 4 * C
    same = dict(strides=(1, 1), padding="same", use_bias=False)
    block = JaxConvNextBlock(
        conv_params_1=dict(kernel_size=K, depth_multiplier=1,
                           activation="linear", **same),
        conv_params_2=dict(kernel_size=1, filters=E,
                           activation="leaky_relu_01", **same),
        conv_params_3=dict(kernel_size=1, filters=C, activation="linear",
                           **same),
        use_bn=False, use_ln=True, use_gamma=True)
    x = np.random.default_rng(3).normal(0, 1, (2, 12, 20, C)).astype(
        np.float32)
    variables = block.init({"params": jax.random.PRNGKey(0)},
                           jnp.asarray(x), train=False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    # perturb the gain off its init so the test sees it
    params["gamma"]["w_multiplier"] = np.linspace(
        -0.5, 0.5, C).astype(np.float32)
    ref = x + np.asarray(block.apply({"params": params}, jnp.asarray(x),
                                     train=False))
    unit = ConvNextBlock(C, K, E)
    unit.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        got = unit(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               atol=1e-4)


def test_quantize_matches_quantize_cf():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (2, 8, 8, 32)).astype(np.float32)
    scale = 0.013
    # exact ties of x / scale and values far past ±127 codes
    x[0, 0, 0, :4] = np.float32(np.array([0.5, 1.5, -2.5, 3.5]) * scale)
    x[0, 0, 1, :2] = [5.0, -5.0]
    got = pallas_convnext.quantize(torch.from_numpy(x), scale)
    ref = np.asarray(quantize_cf(jnp.asarray(x), scale))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.min() == -127 and got.max() == 127


@pytest.mark.parametrize("ck", [(32, 5), (64, 5), (32, 3), (128, 5),
                                (256, 5), (108, 5)])
def test_int8_unit_plain_matches_pallas_interpret(ck):
    C, K = ck
    H, W, pad = 8, 128, K // 2        # the Pallas kernel tiles 128 lanes
    w = _jax_weights(C, K, seed=3)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    x = np.random.default_rng(4).normal(0, 1, (2, H, W, C)).astype(
        np.float32)
    ref = np.asarray(convnext_block_reference(jnp.asarray(x), jw))
    s_in = float(np.abs(x).max() / 127.0)
    s_out = float(np.abs(ref).max() / 127.0)
    xq = pallas_convnext.quantize(torch.from_numpy(x), s_in)
    got = pallas_convnext.convnext_block_plain(
        xq, **_torch_args(w, C, K), scale_in=s_in, scale_out=s_out)
    assert got.dtype == torch.int8
    jq = fused_convnext_block(
        quantize_cf(to_cf_padded(jnp.asarray(x), pad=pad), s_in), **jw,
        H=H, W=W, pad=pad, scale_in=s_in, scale_out=s_out, rows=H // 2,
        interpret=True)
    jcodes = np.asarray(from_cf_padded(jq, H=H, W=W, pad=pad)).astype(int)
    dcode = np.abs(got.numpy().astype(int) - jcodes)
    assert dcode.max() <= 1
    assert (dcode == 0).mean() >= 0.999, (dcode == 0).mean()
    deq = got.float().numpy() * s_out
    assert float(np.abs(deq - ref).max()) < 3.0 * max(s_in, s_out)


def test_int8_wrapper_takes_plain_path_on_cpu_and_checks_scales():
    C, K = 32, 5
    w = _torch_args(_jax_weights(C, K, seed=5), C, K)
    xq = pallas_convnext.quantize(torch.from_numpy(
        np.random.default_rng(6).normal(0, 1, (1, 6, 7, C)).astype(
            np.float32)), 0.03)
    n, n8 = pallas_convnext.launches, pallas_convnext.int8_launches
    got = pallas_convnext.convnext_block(xq, scale_in=0.03, scale_out=0.05,
                                         **w)
    assert torch.equal(got, pallas_convnext.convnext_block_plain(
        xq, scale_in=0.03, scale_out=0.05, **w))
    assert (pallas_convnext.launches, pallas_convnext.int8_launches) == (
        n, n8)
    with pytest.raises(ValueError, match="scale"):
        pallas_convnext.convnext_block(xq, **w)
    with pytest.raises(ValueError, match="scale"):
        pallas_convnext.convnext_block(xq.float(), scale_in=0.03,
                                       scale_out=0.05, **w)


def test_convnext_plain_bf16_tracks_f32():
    C, K = 32, 3
    w = _torch_args(_jax_weights(C, K, seed=4), C, K)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (1, 9, 11, C)).astype(np.float32))
    f32 = pallas_convnext.convnext_block_plain(x, **w)
    bf16 = pallas_convnext.convnext_block_plain(x.bfloat16(), **w)
    assert bf16.dtype == torch.bfloat16
    assert float((bf16.float() - f32).abs().max()) < 0.1


def test_wrappers_take_plain_path_on_cpu_and_count_nothing():
    C, K = 32, 3
    w = _torch_args(_jax_weights(C, K), C, K)
    x = torch.from_numpy(np.random.default_rng(6).normal(
        0, 1, (1, 6, 7, C)).astype(np.float32))
    k1, k2 = pallas_convnext.launches, pallas_pyramid.launches
    torch.testing.assert_close(pallas_convnext.convnext_block(x, **w),
                               pallas_convnext.convnext_block_plain(x, **w),
                               rtol=0, atol=0)
    band, smooth = pallas_pyramid.band_smooth(x, 2)
    band_p, smooth_p = pallas_pyramid.band_smooth_plain(x, 2)
    assert torch.equal(band, band_p) and torch.equal(smooth, smooth_p)
    assert (pallas_convnext.launches, pallas_pyramid.launches) == (k1, k2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("ck", pallas_convnext.SAMPLE_SHAPES)
def test_convnext_kernel_plan_fits_shared_memory(ck, dtype):
    """The planned shared memory of the kernel that runs each (C, K) of
    ``SAMPLE_SHAPES`` (the twelve of their own, and classes at widths that
    are and are not multiples of 16) fits one block, and the numbers the
    sources' notes state are the plan's."""
    plan = pallas_convnext.kernel_plan(*ck, dtype)
    assert 0 < plan["smem_bytes"] <= pallas_convnext.SHARED_MEMORY_LIMIT
    assert plan["smem_bytes"] % 16 == 0
    assert plan["threads_per_block"] % 32 == 0
    assert plan["threads_per_block"] <= 1024
    # a cluster of ceil(C / 128) blocks above 256; a layout that streams
    # W2 and W3 through its ring of three or more stages on a cluster of
    # RING_CLUSTER blocks; else one block
    stages = plan.get("ring_stages", 0)
    assert plan["cluster_size"] == (
        -(-ck[0] // 128) if pallas_convnext.runs_cluster(ck[0])
        else pallas_convnext.RING_CLUSTER if stages else 1)
    assert stages == 0 or stages >= 3
    stated = {((32, 5), torch.bfloat16): (256, 112_000),
              ((64, 5), torch.bfloat16): (512, 225_024),
              # float32: a warp per row of an 8 x 16 tile; two tile buffers
              # but at (64, 5), whose f32 W2 and W3 leave room for one
              ((32, 1), torch.float32): (256, 74_112),
              ((32, 3), torch.float32): (256, 91_776),
              ((32, 5), torch.float32): (256, 113_024),
              ((64, 1), torch.float32): (256, 205_568),
              ((64, 5), torch.float32): (256, 207_104),
              # C = 128: 8 x 16 tiles in every mode, W2 and W3 streamed
              # through a ring of bulk copies (chunks of 32 E channels:
              # 18,944 B in bf16, 32,768 in f32; 16 where three of 32 do
              # not fit) and its 64 B of mbarriers. bf16 (128, 5): 13,824
              # B small weights + 2 x 61,440 tiles + 3 x 18,944 + t 34,816;
              # int8 one tile, 30,720 of codes, 4 stages; f32 (128, 5) one
              # 130,560 B tile and 4 stages of 16,384; (128, 1) one 69,632
              # B tile and 4 of 32,768
              ((128, 5), torch.bfloat16): (256, 228_416),
              ((128, 5), torch.int8): (256, 216_640),
              ((128, 5), torch.float32): (256, 209_984),
              ((128, 1), torch.float32): (256, 202_304),
              # 128 < C <= 256: 8 x 8 tiles, 256 threads, chunks of 16 E
              # channels (bf16 8,448 + 12,288 B), two sets of h blocks
              # (6,144 B); bf16 (256, 5): 27,648 small weights + one
              # 73,728 tile + 4 stages + t 33,792 (int8 36,864, its codes'
              # room); f32 grouped: LN scale and gain 2,048, t 66,560, h
              # 10,240, then the ring's 4 stages of 37,120 in a region
              # the group slots share
              ((256, 5), torch.bfloat16): (256, 224_320),
              ((256, 5), torch.int8): (256, 227_392),
              ((256, 5), torch.float32): (256, 227_392),
              ((144, 3), torch.float32): (256, 227_392),
              # above 256 (bf16, int8) a cluster of ceil(C / 128) blocks
              # of 8 warps, tiles of 64 pixels (csrc/convnext_cluster.cuh)
              ((384, 5), torch.bfloat16): (256, 188_960),
              ((512, 5), torch.int8): (256, 189_984),
              ((1024, 5), torch.bfloat16): (256, 206_368),
              ((640, 7), torch.bfloat16): (256, 157_216),
              # float32: tiles of 32 pixels and two ring slots; at
              # n <= 4 and K = 7 its halo [10 x 14][128] f32 sets the
              # region
              ((512, 5), torch.float32): (256, 165_152),
              ((384, 7), torch.float32): (256, 170_272),
              ((640, 7), torch.float32): (256, 181_536),
              ((1024, 5), torch.float32): (256, 230_688)}
    # the layouts of widths that are multiples of 16 (C rounded up to 16),
    # counted by hand: (threads, bytes, blocks an SM its registers are
    # capped for). bf16 (48, 5): 8 x 16 tiles (12 x 20 with the halo), rows
    # padded to 56 channels: depthwise weights 4,800 + LN scale and gain
    # 384 + two tiles 2 x 26,880 + W2 192 x 56 x 2 = 21,504 + W3 48 x 200 x
    # 2 = 19,200 + t 128 x 56 x 2 = 14,336 = 113,984, two blocks in the
    # SM's 233,472 B with their 1 KB each; int8 one tile and its rows
    # staged as in device memory, 12 x align16(20 x 48 + 15) = 11,712;
    # f32 two tiles of 53,760 and W2 + W3 73,728 (one block). (80, 5): W2
    # 320 x 88 x 2 = 56,320 and W3 80 x 328 x 2 = 52,480 resident (at most
    # half of 232,448), two tiles of 42,240, t 22,528. From 96 W2 and W3
    # stream in chunks of 32 E channels through a ring of up to four
    # stages and its 64 B of mbarriers: (96, 5) four stages of 32 x 104 x
    # 2 + 96 x 40 x 2 = 14,336, two tiles of 49,920, t 26,624; (112, 5)
    # 16,640 a stage, tiles of 57,600, t 30,720; int8 (108, 5) runs the
    # width-112 layout with one tile and 12 x 2,256 B of staged rows
    hand = {((16, 5), torch.bfloat16): (256, 60_864, 2),
            ((48, 5), torch.bfloat16): (256, 113_984, 2),
            ((40, 5), torch.bfloat16): (256, 113_984, 2),
            ((48, 5), torch.int8): (256, 98_816, 2),
            ((48, 5), torch.float32): (256, 186_432, 1),
            # (48, 7): two blocks of 8 x 16 tiles do not fit, so one of
            # 512 threads on 8 x 32 (14 x 38 with the halo): weights 9,792,
            # two tiles of 59,584, W2 + W3 40,704, t 256 x 56 x 2 = 28,672
            ((48, 7), torch.bfloat16): (512, 198_336, 1),
            ((72, 5), torch.bfloat16): (256, 224_448, 1),
            ((80, 5), torch.bfloat16): (256, 224_448, 1),
            ((96, 5), torch.bfloat16): (256, 194_240, 1),
            ((88, 1), torch.int8): (256, 124_224, 1),
            ((108, 5), torch.bfloat16): (256, 224_640, 1),
            ((112, 5), torch.bfloat16): (256, 224_640, 1),
            ((108, 5), torch.int8): (256, 194_112, 1),
            # float32 from C = 97 to 112 keeps the width-128 layout
            ((108, 5), torch.float32): (256, 209_984, 1),
            ((120, 5), torch.bfloat16): (256, 228_416, 1),
            # K = 7 of their own, 8 x 32 tiles (14 x 38 with the halo).
            # (32, 7): depthwise weights 4 x 49 x 32 = 6,272 + LN scale and
            # gain 256 + one tile 14 x 38 x 40 x 2 = 42,560 (rows padded
            # to 40 channels) + W2 128 x 40 x 2 = 10,240 + W3 32 x 136 x 2
            # = 8,704 + t 256 x 40 x 2 = 20,480 = 88,512, two blocks an SM
            # (two tiles, 131,072 B, held one); int8 adds the staged codes
            # 14 x 38 x 32 = 17,024: 105,536, two blocks. (64, 7), one
            # block of 512 threads: 12,544 + 512 + one swizzled tile
            # 14 x 38 x 64 x 2 = 68,096 + W2 256 x 72 x 2 = 36,864 + W3
            # 64 x 264 x 2 = 33,792 + t 256 x 72 x 2 = 36,864 = 188,672;
            # int8 + 34,048 of codes = 222,720
            ((32, 7), torch.bfloat16): (256, 88_512, 2),
            ((32, 7), torch.int8): (256, 105_536, 2),
            ((64, 7), torch.bfloat16): (512, 188_672, 1),
            ((64, 7), torch.int8): (512, 222_720, 1)}
    if (ck, dtype) in stated:
        assert (plan["threads_per_block"],
                plan["smem_bytes"]) == stated[ck, dtype]
    if (ck, dtype) in hand:
        assert (plan["threads_per_block"], plan["smem_bytes"],
                plan["min_blocks_per_sm"]) == hand[ck, dtype]
    if (ck[0] <= 32 and ck[1] < 7) or (ck == (32, 7)
                                       and dtype != torch.float32):
        # two blocks per SM: twice the block and its 1 KB reserve fit the
        # SM's 228 KB (a K = 7 tile and its 3-wide halo leave room for one
        # but at (32, 7) of its own, whose bf16 layout keeps one tile
        # buffer for it)
        assert 2 * (plan["smem_bytes"] + 1024) <= 233_472
        assert plan["min_blocks_per_sm"] == 2
    if ck[0] <= 128:
        # the layout is C rounded up to 16 wide: what the wrapper pads to
        assert pallas_convnext.class_width(ck[0]) == -(-ck[0] // 16) * 16


# The cluster kernel's shared memory counted by hand
# (csrc/convnext_cluster.cuh CLayout), for the n it runs (3 to 8: C = 257
# to 1024): 32 B of mbarriers and 8 x M B of the LayerNorm's partial sums
# (M pixels a tile), the ring's slots of the larger of a W2 item
# 512 x (KC + 8) and a W3 item 128 x (KC3 + 8), and one region for the
# halo of a block's 128 channels (M / 8 + K - 1) x (8 + K - 1), t
# M x (C' + 8) and h M x 512. bf16 and int8 (which stages bf16): M = 64,
# three slots, KC, KC3 = 32, 128 for n <= 4 and 16, 64 above, 2 bytes an
# element; n = 8 (C' = 1024): 544 + 3 x 512 x 24 x 2 + 64 x 1032 x 2 =
# 206,368; the halo never sets the region. float32: M = 32, two slots,
# KC, KC3 = 16, 64, 4 bytes an element; n = 8: 288 + 2 x 512 x 24 x 4 +
# 32 x 1032 x 4 = 230,688; at n <= 4 and K = 7 the halo, 10 x 14 x 128 x
# 4 = 71,680, sets the region.
CLUSTER_HAND_COUNTS = [
    # (dtypes, n, threads, bytes at K <= 5, bytes at K = 7)
    ("bf16 int8", 3, 256, 544 + 3 * 40_960 + 65_536, None),
    ("bf16 int8", 4, 256, 544 + 3 * 40_960 + 66_560, None),
    ("bf16 int8", 5, 256, 544 + 3 * 24_576 + 82_944, None),
    ("bf16 int8", 6, 256, 544 + 3 * 24_576 + 99_328, None),
    ("bf16 int8", 7, 256, 544 + 3 * 24_576 + 115_712, None),
    ("bf16 int8", 8, 256, 544 + 3 * 24_576 + 132_096, None),
    ("f32", 3, 256, 288 + 2 * 49_152 + 65_536, 288 + 2 * 49_152 + 71_680),
    ("f32", 4, 256, 288 + 2 * 49_152 + 66_560, 288 + 2 * 49_152 + 71_680),
    ("f32", 5, 256, 288 + 2 * 49_152 + 82_944, None),
    ("f32", 6, 256, 288 + 2 * 49_152 + 99_328, None),
    ("f32", 7, 256, 288 + 2 * 49_152 + 115_712, None),
    ("f32", 8, 256, 288 + 2 * 49_152 + 132_096, None)]
_DTYPE_NAMES = {"bf16": torch.bfloat16, "int8": torch.int8,
                "f32": torch.float32}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("ck", [(112, 5), (128, 5), (128, 7), (192, 5),
                                (256, 7)])
def test_chunk_images_put_back_are_the_padded_weights(ck, dtype):
    """The streamed layouts' W2 and W3 from ``kernel_operands`` are one
    tensor, a row a chunk of ECH E channels (``chunk_channels``: its W2
    part, then its W3 part); put back in their original order they are the
    weights padded to the layout's width exactly, and every padding
    element is zero: bf16 and int8 (and f32 above 128) as rows, W2's ECH
    rows padded to C' + pad and W3's ECH columns of each row padded to
    ECH + pad; f32 up to 128 in fragment order, 16-byte vector (n, i) of
    W2 lane (g, q) holding channels
    16i + 4q .. + 3 of the chunk's E row pair(n, g) and vector (m, o) of W3
    the chunk's E 16m + 4q .. + 3 of output channel pair(o, g), pair(t, j)
    = 16 (t / 2) + 4 (j / 2) + 2 (t % 2) + j % 2."""
    c, k = ck
    rng = np.random.default_rng(c + k)
    w = dict(dw=torch.from_numpy(rng.normal(size=(c, 1, k, k))).float(),
             ln_scale=torch.ones(c), gain=torch.ones(c),
             w2=torch.from_numpy(rng.normal(size=(4 * c, c))).float(),
             w3=torch.from_numpy(rng.normal(size=(c, 4 * c))).float())
    plan = pallas_convnext.kernel_plan(c, k, dtype)
    ech, width = plan["chunk_channels"], pallas_convnext.class_width(c,
                                                                     dtype)
    assert plan["ring_stages"] >= 3 and ech in (16, 32)
    w_dtype = torch.bfloat16 if dtype == torch.int8 else dtype
    pad = width - c
    w2p = F.pad(w["w2"].to(w_dtype), (0, pad, 0, 4 * pad))
    w3p = F.pad(w["w3"].to(w_dtype), (0, 4 * pad, 0, pad))
    _, _, img, img_w3, _ = pallas_convnext.kernel_operands(dtype, **w)
    nch = 4 * width // ech
    assert img_w3 is img and img.dtype == w_dtype and img.shape[0] == nch
    # the W2 part: ECH rows of C' + pad (rows) or ECH C' values
    fragments = dtype == torch.float32 and width <= 128
    n2 = ech * width if fragments else ech * (width + (
        8 if w_dtype == torch.bfloat16 else 4))
    img2, img3 = img[:, :n2], img[:, n2:]
    if fragments:
        def pair(t, j):
            return 16 * (t // 2) + 4 * (j // 2) + 2 * (t % 2) + j % 2

        assert img2.shape[1] == img3.shape[1] == ech * width
        got2, got3 = torch.zeros_like(w2p), torch.zeros_like(w3p)
        seen2, seen3 = torch.zeros_like(w2p), torch.zeros_like(w3p)
        for i in range(ech * width // 4):
            lane, rest = i % 32, i // 32
            g, q = lane // 4, lane % 4
            n, ii = rest // (width // 16), rest % (width // 16)
            m, o = rest // (width // 8), rest % (width // 8)
            for ch in range(nch):
                e2 = ch * ech + pair(n, g)
                got2[e2, 16 * ii + 4 * q:16 * ii + 4 * q + 4] = \
                    img2[ch, 4 * i:4 * i + 4]
                seen2[e2, 16 * ii + 4 * q:16 * ii + 4 * q + 4] += 1
                e3 = ch * ech + 16 * m + 4 * q
                got3[pair(o, g), e3:e3 + 4] = img3[ch, 4 * i:4 * i + 4]
                seen3[pair(o, g), e3:e3 + 4] += 1
        assert bool((seen2 == 1).all()) and bool((seen3 == 1).all())
    else:
        row2 = img2.shape[1] // ech
        row3 = img3.shape[1] // width
        assert img2.shape[1] == ech * row2 and row2 > width
        assert img3.shape[1] == width * row3 and row3 > ech
        i2 = img2.reshape(nch, ech, row2)
        i3 = img3.reshape(nch, width, row3)
        assert not bool(i2[..., width:].float().any())
        assert not bool(i3[..., ech:].float().any())
        got2 = i2[..., :width].reshape(4 * width, width)
        got3 = i3[..., :ech].permute(1, 0, 2).reshape(width, 4 * width)
    assert torch.equal(got2, w2p) and torch.equal(got3, w3p)


@pytest.mark.parametrize("dtypes,n,threads,smem,smem_k7", CLUSTER_HAND_COUNTS)
def test_convnext_cluster_plan_matches_hand_count(dtypes, n, threads, smem,
                                                  smem_k7):
    """Each cluster layout's plan is the hand count above (the same at
    every K where the halo fits the region), fits one block's 232,448 B and
    names its cluster of n blocks; from ``CLUSTER_FROM`` (257) on
    ``kernel_plan`` is that plan in every mode, and the widths there are
    the multiples of 128."""
    for dtype in map(_DTYPE_NAMES.get, dtypes.split()):
        for c in (128 * n - 127, 128 * n - 1, 128 * n):
            assert pallas_convnext.runs_cluster(c)
            assert pallas_convnext.class_width(c) == 128 * n
            for k in pallas_convnext.KERNEL_KS:
                want = dict(threads_per_block=threads,
                            smem_bytes=smem_k7 if k == 7 and smem_k7
                            else smem, cluster_size=n)
                assert pallas_convnext.cluster_plan(c, k, dtype) == want
                assert pallas_convnext.kernel_plan(c, k, dtype) == want
    assert not pallas_convnext.runs_cluster(256)
    assert max(smem, smem_k7 or 0) <= pallas_convnext.SHARED_MEMORY_LIMIT


def _tf32(v: torch.Tensor, rounding: str) -> torch.Tensor:
    """float32 v rounded to TF32 (10 mantissa bits): to nearest with ties
    away from zero, or truncated."""
    bits = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if rounding == "nearest":
        bits = bits + 0x1000
    bits = bits & 0xFFFFE000
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(
        torch.int32).view(torch.float32)


def _product_tf32(a, b, passes, rounding):
    """a @ b.T as the tensor cores compute it on TF32 operands with float32
    sums: one pass on big = tf32(v), or three (3xTF32): small.big and
    big.small, then big.big, with small = v - big truncated as the tensor
    core reads it."""
    a_big, b_big = _tf32(a, rounding), _tf32(b, rounding)
    if passes == 1:
        return a_big @ b_big.T
    a_small = _tf32(a - a_big, "truncate")
    b_small = _tf32(b - b_big, "truncate")
    return (a_small @ b_big.T + a_big @ b_small.T) + a_big @ b_big.T


def _unit_tf32(x, dw, ln_scale, w2, w3, gain, slope, passes, rounding):
    """The float32 unit of ``convnext_block_plain`` with its two products
    emulated in TF32 (``_product_tf32``)."""
    b, h, w, c = x.shape
    k = dw.shape[-1]
    xp = torch.nn.functional.pad(x, (0, 0, k // 2, k // 2, k // 2, k // 2))
    dwf = dw.reshape(c, k, k)
    acc = torch.zeros_like(x)
    for dy in range(k):
        for dx in range(k):
            acc = acc + xp[:, dy:dy + h, dx:dx + w, :] * dwf[:, dy, dx]
    cent = acc - acc.mean(dim=-1, keepdim=True)
    var = (cent * cent).mean(dim=-1, keepdim=True)
    t = (cent * torch.rsqrt(var + 1e-3) * ln_scale).reshape(-1, c)
    hid = torch.nn.functional.leaky_relu(
        _product_tf32(t, w2, passes, rounding), slope)
    p = _product_tf32(hid, w3, passes, rounding).reshape(x.shape)
    return x + gain * p


@pytest.fixture(scope="module")
def flagship_units():
    """The packaged flagship's two float32 unit shapes, (32, 3) and
    (64, 5), as the serving path gives them to K1."""
    import blind_image_denoising_torch as bidt
    den = bidt.load_model("unet_laplacian_v6_tpu_scratch", device="cpu",
                          dtype="float32")
    units = {}
    for name in ("encoder_0_0", "encoder_1_0"):
        unit = getattr(den.model.backbone, name)
        units[name] = (dict(unit.kernel_weights(torch.float32)), unit.slope)
    return units


def _seeded_unit(c, k, seed=0):
    """tests/test_torch_cuda.py's ``_unit_weights``, on the CPU."""
    rng = np.random.default_rng(seed)
    e = 4 * c
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa
    return dict(dw=t(rng.normal(0, 0.3, (c, 1, k, k))),
                ln_scale=t(rng.uniform(0.5, 1.5, (c,))),
                w2=t(rng.normal(0, 1.0 / np.sqrt(c), (e, c))),
                w3=t(rng.normal(0, 1.0 / np.sqrt(e), (c, e))),
                gain=t(rng.uniform(0.3, 0.9, (c,))))


@pytest.mark.parametrize("rounding", ["nearest", "truncate"])
@pytest.mark.parametrize("unit", [
    "encoder_0_0", "encoder_1_0",
    *(pytest.param(ck, id=f"C{ck[0]}K{ck[1]}")
      for ck in sorted(pallas_convnext.OWN_SHAPES) if ck[1] < 7)])
def test_convnext_f32_3xtf32_keeps_float32_accuracy(flagship_units, unit,
                                                    rounding):
    """Why K1's float32 mode runs its products as three TF32 passes: an
    emulation of 3xTF32 (either rounding of big) stays within 1e-5 of the
    plain output's largest entry (about 1e-6 in fact), the bar the card
    holds the kernel to, on the flagship's units (seeded 2 x 64 x 64
    inputs) and the card tests' seeded weights at every kernel shape of
    its own up to K = 5 (a 3 x 100 x 300 input; K = 7's own shapes run the
    same products on the same C); one TF32 pass misses the card's 1e-3
    bar on the flagship's units."""
    if isinstance(unit, str):
        wts, slope = flagship_units[unit]
        c = wts["w2"].shape[1]
        shape = (2, 64, 64, c)
    else:
        wts, slope = _seeded_unit(*unit), 0.1
        shape = (3, 100, 300, unit[0])
    x = torch.from_numpy(np.random.default_rng(7).normal(
        0, 1, shape).astype(np.float32))
    ref = pallas_convnext.convnext_block_plain(x, slope=slope, **wts)
    bar = 1e-5 * float(ref.abs().max())
    three = _unit_tf32(x, slope=slope, passes=3, rounding=rounding, **wts)
    assert float((three - ref).abs().max()) <= bar
    if isinstance(unit, str):
        one = _unit_tf32(x, slope=slope, passes=1, rounding=rounding, **wts)
        assert float((one - ref).abs().max()) > 1e-3


def test_kernel_modules_import_without_nvcc_or_triton():
    """No nvcc on PATH, no CUDA_HOME, triton blocked: the kernel modules
    import and the CPU path runs without ever building the library."""
    code = (
        "import sys\n"
        "class _Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'triton':\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, _Block())\n"
        "import torch\n"
        "from blind_image_denoising_torch.ops import (cuda_build,\n"
        "    pallas_convnext, pallas_noise, pallas_pyramid)\n"
        "x = torch.ones((1, 4, 4, 8))\n"
        "pallas_pyramid.band_smooth(x, 2)\n"
        "pallas_pyramid.band_smooth_bwd(x, x, 2)\n"
        "pallas_noise.corrupt_noise(1, x[..., :3], [5, 10], [0.05, 0.1])\n"
        "w = dict(dw=torch.ones(8, 1, 3, 3), ln_scale=torch.ones(8),\n"
        "         w2=torch.ones(32, 8), w3=torch.ones(8, 32),\n"
        "         gain=torch.ones(8))\n"
        "pallas_convnext.convnext_block(x, **w)\n"
        "pallas_convnext.convnext_block(pallas_convnext.quantize(x, 0.1),\n"
        "                               scale_in=0.1, scale_out=0.1, **w)\n"
        "pallas_pyramid.band_split(x, 2)\n"
        "assert cuda_build._lib is None\n"
        "assert 'triton' not in sys.modules\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = os.path.dirname(sys.executable)
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# every shape the port's paths give K2's backward: the train step's two
# levels at b16 @ 128², and the f32 `float_forward` gradients at 128² and
# 256² (chip_smoke.py's inference phase), in both dtypes
BWD_PATH_SHAPES = [(16, 128, 128, 32), (16, 64, 64, 64), (1, 128, 128, 32),
                   (1, 64, 64, 64), (1, 256, 256, 32), (1, 128, 128, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BWD_PATH_SHAPES)
def test_bwd_tile_plan_fits_shared_memory(shape, dtype):
    """The backward's tile at every shape the paths launch: it fits one
    block's shared memory with room for four blocks per SM, its threads
    cover a tile row of 16-byte vectors and its rows, and the tiles cover
    the image."""
    b, h, w, c = shape
    plan = pallas_pyramid.bwd_tile_plan(b, h, w, c, 2, dtype)
    vec = 16 // torch.tensor([], dtype=dtype).element_size()
    assert plan["smem_bytes"] == 4 * (plan["tile_h"] + 1) * (
        plan["tile_w"] + 1) * c + 16 // vec * plan["tile_h"] * (
            plan["tile_w"]) * c
    assert 4 * (plan["smem_bytes"] + 1024) <= 233_472
    assert plan["threads_x"] == plan["tile_w"] * c // vec
    threads = plan["threads_x"] * plan["threads_y"]
    assert threads <= pallas_pyramid.BWD_THREADS and threads % 32 == 0
    assert plan["tile_h"] <= (pallas_pyramid.BWD_ROWS_PER_THREAD
                              * plan["threads_y"])
    gx, gy, gz = plan["tiles"]
    assert gx * plan["tile_w"] >= w and gy * plan["tile_h"] >= h
    assert gz == b
    if (shape, dtype) == ((16, 128, 128, 32), torch.bfloat16):
        assert (plan["tile_w"], plan["tile_h"], plan["smem_bytes"]) == (
            32, 4, 29_312)


@pytest.mark.parametrize("hwck", [(1, 1, 8, 5), (1, 37, 64, 3),
                                  (29, 1, 128, 4), (300, 2, 16, 9)])
def test_bwd_tile_plan_edges_and_limits(hwck):
    """Edge shapes stay within the limit; a window too large for any tile
    raises; a C beyond one block's threads runs as channel slices, planned
    at the first slice's width."""
    h, w, c, k = hwck
    for dtype in (torch.float32, torch.bfloat16):
        plan = pallas_pyramid.bwd_tile_plan(1, h, w, c, k, dtype)
        assert plan["smem_bytes"] <= pallas_pyramid.SHARED_MEMORY_LIMIT
        assert plan["tile_w"] <= w and plan["tile_h"] <= h
    with pytest.raises(ValueError):
        pallas_pyramid.bwd_tile_plan(1, 64, 64, 64, 61, torch.float32)
    assert pallas_pyramid.bwd_tile_plan(1, 8, 8, 2048, 2, torch.float32) \
        == pallas_pyramid.bwd_tile_plan(1, 8, 8, 1024, 2, torch.float32)


# K4's checked shapes (chip_smoke.py's band_split phase) and edges of the
# card test
SPLIT_PLAN_SHAPES = [(8, 256, 256, 32), (8, 128, 128, 64), (1, 2, 2, 8),
                     (1, 100, 300, 16), (2, 18, 30, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("shape", SPLIT_PLAN_SHAPES)
def test_split_tile_plan_fits_shared_memory(shape, k, dtype):
    """The split's tile: its stages fit one block's shared memory, every
    thread owns whole 16-byte vectors of whole 2×2 quads, and the tiles
    cover the image."""
    b, h, w, c = shape
    plan = pallas_pyramid.split_tile_plan(b, h, w, c, k, dtype)
    elt = torch.tensor([], dtype=dtype).element_size()
    vec = 16 // elt
    tw, th = plan["tile_w"], plan["tile_h"]
    assert tw % 2 == 0 and th % 2 == 0 and tw <= w and th <= h
    assert plan["smem_bytes"] == pallas_pyramid.SPLIT_STAGES * 2 * (
        th + k - 1) * ((tw + k) // 2) * c * elt
    assert plan["smem_bytes"] <= pallas_pyramid.SHARED_MEMORY_LIMIT
    assert c % vec == 0 and plan["threads_x"] == tw // 2 * (c // vec)
    assert plan["threads_x"] * plan["threads_y"] <= \
        pallas_pyramid.SPLIT_THREADS
    assert th <= 2 * pallas_pyramid.SPLIT_QUAD_ROWS * plan["threads_y"]
    gx, gy, gz = plan["tiles"]
    assert gx * tw >= w and gy * th >= h and gz == b
    assert (gx - 1) * tw < w and (gy - 1) * th < h
    if (shape, k, dtype) == ((8, 256, 256, 32), 2, torch.bfloat16):
        assert (tw, th, plan["smem_bytes"]) == (32, 4, 21_760)


def test_split_tile_plan_limits():
    """Odd or empty images and a window no tile can stage raise; a C of no
    whole 16-byte vectors moves fewer channels a thread, and a C beyond one
    block's threads runs as channel slices, planned at the first slice's
    width."""
    for h, w, c, k in [(3, 4, 32, 2), (4, 5, 32, 2), (0, 4, 32, 2),
                       (64, 64, 128, 200)]:
        with pytest.raises(ValueError):
            pallas_pyramid.split_tile_plan(1, h, w, c, k, torch.float32)
    assert pallas_pyramid.split_tile_plan(1, 4, 4, 4096, 2, torch.float32) \
        == pallas_pyramid.split_tile_plan(1, 4, 4, 512, 2, torch.float32)
    assert pallas_pyramid.split_tile_plan(
        1, 4, 4, 10, 2, torch.float32)["threads_x"] == 2 * 5


def _chip_smoke():
    import importlib
    sys.path.insert(0, REPO)
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(REPO)


def test_noise_bound_counts_the_work():
    """K3's bound from its work, on hand-computed values. The train
    step's 16 × 128² × 3 with 3 samples without noise, 9 with one and 4
    with both: 6,291,456 bytes over 3.35 TB/s; 40 multiplies × 49,152 ×
    13 samples over 64 per SM and clock × 132 SMs × 1.98 GHz; 4 special
    functions × 49,152 × 17 noises over 16 per SM and clock."""
    cs = _chip_smoke()
    flags = [0] * 3 + [1] * 9 + [2] * 4
    ms, by, parts = cs.noise_bound_ms(49_152, flags)
    assert parts["bytes"] == pytest.approx(6_291_456 / 3.35e12 * 1e3)
    assert parts["integer"] == pytest.approx(
        25_559_040 / (64 * 132 * 1.98e9) * 1e3)
    assert parts["mufu"] == pytest.approx(
        3_342_336 / (16 * 132 * 1.98e9) * 1e3)
    assert (ms, by) == (parts["bytes"], "bytes")
    assert ms == pytest.approx(0.0018780, rel=1e-4)
    # every sample with a noise on: the multiplies just pass the bytes
    ms, by, parts = cs.noise_bound_ms(1000, [1, 2])
    assert by == "operations" and ms == parts["integer"]
    assert ms == pytest.approx(80_000 / (64 * 132 * 1.98e9) * 1e3)
    # no noise at all: bytes only
    ms, by, parts = cs.noise_bound_ms(1000, [0, 0])
    assert by == "bytes" and parts["integer"] == parts["mufu"] == 0


@pytest.mark.parametrize("row", [
    (8, 256, 32, 3, 0.13572), (8, 128, 64, 5, 0.13597),
    (8, 256, 32, 1, 0.13171), (8, 128, 64, 1, 0.12996)])
def test_convnext_f32_bound_counts_three_tf32_passes(row):
    """K1's float32 bound: three TF32 passes of the products (4·C·E
    operations a pixel) over 495 TFLOP/s, which sets it at the four f32
    rows (0.0521 ms: the same products at 8×256²×32 and 8×128²×64); with
    ``cuda_cores`` every operation over 67 TFLOP/s, the bound the rows
    had before the products moved to the tensor cores."""
    cs = _chip_smoke()
    b, hw, c, k, cuda_cores_ms = row
    ms, by = cs.convnext_bound_ms(b, hw, hw, c, k, torch.float32)
    assert by == "operations"
    assert ms == pytest.approx(3 * b * hw * hw * 16 * c * c / 495e12 * 1e3)
    assert ms == pytest.approx(0.052060, rel=1e-4)
    old, _ = cs.convnext_bound_ms(b, hw, hw, c, k, torch.float32,
                                  cuda_cores=True)
    assert old == pytest.approx(cuda_cores_ms, rel=1e-4)
    # the bf16 and int8 bounds do not take the float32 branch
    assert cs.convnext_bound_ms(b, hw, hw, c, k, torch.bfloat16) == \
        cs.convnext_bound_ms(b, hw, hw, c, k, torch.bfloat16, cuda_cores=True)


def test_cold_copies_move_twice_the_l2():
    cs = _chip_smoke()
    a, b = torch.zeros(1_000_000), torch.zeros(250_000, dtype=torch.bfloat16)
    sets = cs.cold_copies(a, b)
    set_bytes = 4_000_000 + 500_000
    assert (len(sets) - 1) * set_bytes >= 2 * cs.L2_BYTES
    assert all(s[0].shape == a.shape and s[1].dtype == b.dtype
               and s[0].data_ptr() != a.data_ptr() for s in sets)


# ------------------------------------ unit options and the routing to K1

_UNIT_OPTIONS = [
    dict(), dict(use_bias=True), dict(use_bn=True),
    dict(use_bn=True, use_bias=True), dict(use_ln=False),
    dict(use_gamma=False), dict(activation="relu"), dict(kernel=2),
    dict(in_features=16), dict(features=128, kernel=1)]


def _unit_case(opts):
    c = opts.get("features", 8)
    c_in = opts.get("in_features", c)
    k = opts.get("kernel", 3)
    use_bias = opts.get("use_bias", False)
    same = dict(strides=(1, 1), padding="same", use_bias=use_bias)
    act = opts.get("activation", "leaky_relu_01")
    block = JaxConvNextBlock(
        conv_params_1=dict(kernel_size=k, depth_multiplier=1,
                           activation="linear", **same),
        conv_params_2=dict(kernel_size=1, filters=4 * c, activation=act,
                           **same),
        conv_params_3=dict(kernel_size=1, filters=c, activation="linear",
                           **same),
        use_bn=opts.get("use_bn", False), use_ln=opts.get("use_ln", True),
        bn_center=use_bias, use_gamma=opts.get("use_gamma", True))
    unit = ConvNextBlock(c_in, k, 4 * c, act, out_features=c,
                         use_bias=use_bias, use_bn=opts.get("use_bn", False),
                         use_ln=opts.get("use_ln", True),
                         use_gamma=opts.get("use_gamma", True))
    return block, unit, c_in, c


@pytest.mark.parametrize("opts", _UNIT_OPTIONS, ids=lambda o: "+".join(
    f"{k}={v}" for k, v in o.items()) or "flagship")
@pytest.mark.parametrize("train", [False, True])
def test_convnext_unit_options_match_linen_block(opts, train):
    """The unit with each option of the flax ``ConvNextBlock`` (biases,
    BatchNorm before the LayerNorm, no LayerNorm, no gain, another
    expansion activation, an even kernel, more input than output
    channels, C = 128), eval and train mode (batch statistics), against
    the linen block (+ the skip where the channels keep), float32."""
    block, unit, c_in, c = _unit_case(opts)
    x = np.random.default_rng(7).normal(0.3, 1, (2, 9, 11, c_in)).astype(
        np.float32)
    variables = block.init({"params": jax.random.PRNGKey(0)},
                           jnp.asarray(x), train=False)
    rng = np.random.default_rng(8)
    variables = {
        col: jax.tree_util.tree_map(lambda a: (np.asarray(a) + rng.normal(
            0, 0.2, a.shape)).astype(np.float32) if col == "params" else
            np.asarray(a), v)
        for col, v in variables.items() if col in ("params", "batch_stats")}
    if train:
        ref, _ = block.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    else:
        ref = block.apply(variables, jnp.asarray(x), train=False)
    ref = np.asarray(ref) + (x if c_in == c else 0)
    unit.load_state_dict(params_from_flax(variables), strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        if train:
            got = unit.branch(xt, train=True) + (xt if c_in == c else 0)
        else:
            got = unit(xt)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=1e-5, atol=1e-4)


def test_unit_caches_the_kernels_operands():
    """``ConvNextBlock.kernel_operands`` holds ``kernel_operands``' output
    for its weights bit for bit (cast, padded to the layout's width: C =
    40 runs the width-48 layout), hands the same tensors back while the
    parameters stay, rebuilds them when a parameter changes, and keeps
    them by the I/O dtype of the x they run on."""
    def same_bits(a, b):
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.contiguous().view(torch.uint8),
                                b.contiguous().view(torch.uint8)))

    torch.manual_seed(0)
    unit = ConvNextBlock(40, 5, 160)
    with torch.no_grad():
        for prm in unit.parameters():
            prm.copy_(torch.randn_like(prm))
    for dtype in (torch.float32, torch.bfloat16):
        ops = unit.kernel_operands(dtype)
        want = pallas_convnext.kernel_operands(
            dtype, **unit.kernel_weights(dtype))
        assert all(same_bits(a, b) for a, b in zip(ops, want))
        assert tuple(ops[2].shape) == (192, 48)
        assert unit.kernel_operands(dtype) is ops
    ops = unit.kernel_operands(torch.bfloat16)
    with torch.no_grad():
        unit.conv_2.kernel.add_(0.5)
    fresh = unit.kernel_operands(torch.bfloat16)
    assert fresh is not ops
    assert same_bits(fresh[2][:160, :40],
                     unit.conv_2.kernel.detach().to(torch.bfloat16))
    assert not bool(fresh[2][160:].any()) and not bool(fresh[2][:, 40:].any())
    assert all(same_bits(a, b) for a, b in zip(
        fresh, pallas_convnext.kernel_operands(
            torch.bfloat16, **unit.kernel_weights(torch.bfloat16))))
    # by the I/O dtype: at (120, 7) int8 codes (bf16 weights) run the
    # width-128 layout on chunks of 16 E channels, bf16 on chunks of 32
    unit = ConvNextBlock(120, 7, 480)
    bf16 = unit.kernel_operands(torch.bfloat16)
    codes = unit.kernel_operands(torch.bfloat16, io_dtype=torch.int8)
    assert codes[2].shape != bf16[2].shape
    assert unit.kernel_operands(torch.bfloat16, io_dtype=torch.int8) is codes
    assert unit.kernel_operands(torch.bfloat16) is bf16
    w = unit.kernel_weights(torch.bfloat16)
    for ops, io in ((bf16, torch.bfloat16), (codes, torch.int8)):
        assert all(same_bits(a, b) for a, b in zip(
            ops, pallas_convnext.kernel_operands(io, **w)))


def test_convnext_routing_is_decided_by_the_kernels_shapes_and_options():
    """K1 takes a unit at every shape JAX's kernel takes (any C, odd K and
    E: off C <= 1024 at K = 1, 3, 5, 7 with E = 4C on its general route)
    with its options; every other unit (an option, an even K) runs its
    branch, counted once per forward in ``pallas_convnext.branch_units``,
    and never calls the kernel."""
    for (c, k) in pallas_convnext.SAMPLE_SHAPES:
        assert ConvNextBlock(c, k, 4 * c).kernel_route
    for args in ((1025, 5, 4100), (32, 9, 128), (1040, 1, 4160),
                 (16, 5, 48), (32, 3, 64), (64, 3, 128)):
        assert ConvNextBlock(*args).kernel_route, args
        assert pallas_convnext.runs_general(*args), args
    for args, kw in (((32, 4, 128), {}),
                     ((32, 3, 128), dict(use_bias=True)),
                     ((32, 3, 128), dict(use_bn=True)),
                     ((32, 3, 128), dict(use_gamma=False)),
                     ((32, 3, 128), dict(use_ln=False)),
                     ((32, 3, 128), dict(dropout_rate=0.1)),
                     ((32, 3, 128), dict(spatial_dropout_rate=0.1)),
                     ((32, 3, 128), dict(out_features=16)),
                     ((32, 3, 128, "relu"), {})):
        assert not ConvNextBlock(*args, **kw).kernel_route, (args, kw)
    routed, branch = ConvNextBlock(32, 1, 128), ConvNextBlock(
        32, 1, 128, use_bias=True)
    general = ConvNextBlock(32, 1, 64)
    for u in (routed, branch, general):
        for p in u.parameters():
            torch.nn.init.normal_(p, 0, 0.1)
    x = torch.randn(1, 32, 6, 7)
    calls = []
    real = convnext_mod.convnext_block
    convnext_mod.convnext_block = lambda *a, **kw: calls.append(1) or real(
        *a, **kw)
    try:
        b0 = pallas_convnext.branch_units
        with torch.no_grad():
            routed(x)
            assert calls and pallas_convnext.branch_units == b0
            calls.clear()
            yg = general(x)
            assert calls and pallas_convnext.branch_units == b0
            calls.clear()
            y = branch(x)
            assert torch.allclose(yg, x + general.branch(x), atol=1e-5)
        assert not calls and pallas_convnext.branch_units == b0 + 1
        assert torch.allclose(y, x + branch.branch(x))
    finally:
        convnext_mod.convnext_block = real


def test_convnext_general_route_plan_operands_and_refusals():
    """The general route's side in Python: every (C, K) of SAMPLE_SHAPES at
    E = 4C keeps its one-pass layout (its plan is not ``general_plan``'s),
    every shape of GENERAL_SAMPLE_SHAPES runs the general route (its plan
    is ``general_plan``: 256 threads, no cluster, within a block's default
    48 KB of dynamic shared memory; its width C), whose operands are the
    weights as they lie (dw [K², C] transposed, W2 [E, C], W3 [C, E]); an
    even K raises ``ValueError`` in ``kernel_plan`` and in the wrapper on
    the CPU."""
    dtypes = (torch.float32, torch.bfloat16, torch.int8)
    for c, k in pallas_convnext.SAMPLE_SHAPES:
        assert not pallas_convnext.runs_general(c, k, 4 * c)
        for dtype in dtypes:
            assert pallas_convnext.kernel_plan(c, k, dtype) != \
                pallas_convnext.general_plan(c)
    for c, k, e in pallas_convnext.GENERAL_SAMPLE_SHAPES:
        assert pallas_convnext.kernel_supports(c, k, e)
        assert pallas_convnext.runs_general(c, k, e)
        assert pallas_convnext.class_width(c, torch.bfloat16, k, e) == c
        for dtype in dtypes:
            plan = pallas_convnext.kernel_plan(c, k, dtype, e)
            assert plan == pallas_convnext.general_plan(c)
            assert plan["threads_per_block"] == 256
            assert plan["cluster_size"] == 1
            assert plan["smem_bytes"] <= 48 * 1024
    # the depthwise pass's raw sums: 8 pixels of a warp each up to C = 1024
    # (at 1024 more than the products' 30,720 B), then a block a pixel
    # with 32 B of reduction, none past 48 KB (recomputed)
    assert pallas_convnext.general_plan(1024)["smem_bytes"] == 8 * 1024 * 4
    assert pallas_convnext.general_plan(2048)["smem_bytes"] == 30720
    assert pallas_convnext._dwln_smem(1025) == 32 + 4 * 1025
    assert pallas_convnext._dwln_smem(12280) == 32 + 4 * 12280
    assert pallas_convnext._dwln_smem(12281) == 32
    c, k, e = 48, 5, 96
    w = dict(dw=torch.randn(c, 1, k, k), ln_scale=torch.rand(c) + 0.5,
             w2=torch.randn(e, c), w3=torch.randn(c, e), gain=torch.rand(c))
    dw, ln, w2, w3, gain = pallas_convnext.kernel_operands(torch.int8, **w)
    assert torch.equal(dw, w["dw"].reshape(c, k * k).t())
    assert w2.dtype == w3.dtype == torch.bfloat16 and dw.dtype == torch.float32
    assert (w2.shape, w3.shape, ln.shape, gain.shape) == (
        (e, c), (c, e), (c,), (c,))
    assert not pallas_convnext.kernel_supports(32, 4)
    with pytest.raises(ValueError):
        pallas_convnext.kernel_plan(32, 4, torch.bfloat16)
    x = torch.randn(1, 6, 6, 8)
    with pytest.raises(ValueError):
        pallas_convnext.convnext_block(
            x, torch.randn(8, 1, 4, 4), torch.ones(8), torch.randn(32, 8),
            torch.randn(8, 32), torch.ones(8))
