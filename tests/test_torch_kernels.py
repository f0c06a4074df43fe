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
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blind_image_denoising_tpu.layers.convnext import (
    ConvNextBlock as JaxConvNextBlock)
from blind_image_denoising_tpu.ops.pallas_convnext import (
    convnext_block_reference, from_cf_padded, fused_convnext_block,
    to_cf_padded)
from blind_image_denoising_tpu.ops.pallas_pyramid import (
    _band_smooth_bwd, laplacian_band_smooth_pallas,
    laplacian_band_smooth_reference)
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


def _vjp_case(k, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (2, 16, 8, 3)).astype(np.float32)
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


def _jax_weights(C, K, seed=0):
    rng = np.random.default_rng(seed)
    E = 4 * C
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


@pytest.mark.parametrize("ck", [(32, 3), (64, 5)])
def test_convnext_plain_matches_jax_reference_and_pallas(ck):
    C, K = ck
    H, W = 8, 128        # the Pallas kernel tiles rows of 128 lanes
    w = _jax_weights(C, K)
    x = np.random.default_rng(2).normal(0, 1, (2, H, W, C)).astype(
        np.float32)
    got = pallas_convnext.convnext_block_plain(torch.from_numpy(x),
                                               **_torch_args(w, C, K))
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    ref = convnext_block_reference(jnp.asarray(x), jw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    pad = K // 2
    fused = from_cf_padded(fused_convnext_block(
        to_cf_padded(jnp.asarray(x), pad=pad), **jw, H=H, W=W, pad=pad,
        rows=H // 2, interpret=True), H=H, W=W, pad=pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(fused), atol=0.05)


@pytest.mark.parametrize("ck", [(32, 3), (64, 5)])
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
