"""The port's blend (``blind_image_denoising_torch/inference/blend.py``)
against the JAX package's, on the CPU.

* ``BlendTable.apply`` — global, two-band (default and table-given
  ``band_kernel`` / ``band_nsig``) and adaptive tables — within 1e-4 of
  JAX's on the same seeded inputs; two-band collapses to the global
  blend when the curves are equal.
* ``_optimal_alpha`` / ``_optimal_alpha2`` return JAX's answers on the
  same numpy inputs, including the box-edge and the walk cases of
  ``tests/test_blend.py``.
* ``calibrate_blend`` on identity-like, fixed-offset and perfect
  denoisers, in the global, ``bands=2`` and ``adaptive=True`` modes, with
  ``tests/test_blend.py``'s bars (its noise is the port's own stream).
* ``blend.json`` written by either package loads in the other and blends
  the same; the port's ``Denoiser`` serves a two-band table (identity at
  clean) and composes it with TTA and ``float_forward``.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blind_image_denoising_tpu.inference import blend as jblend
from blind_image_denoising_torch.inference import blend as tblend
from blind_image_denoising_torch.inference.denoiser import Denoiser
from blind_image_denoising_torch.models.hydra import model_builder
from conftest import TINY_RESNET_MODEL, tiny_resnet_hydra


def _smooth_image(h=96, w=96, c=3):
    """tests/test_blend.py's piecewise-smooth synthetic scene."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 96 + 48 * np.sin(xx / 37.0) + 32 * np.cos(yy / 29.0)
    img = np.stack([base + 8 * k for k in range(c)], axis=-1)
    return np.clip(img, 0, 255).astype(np.float32)


TABLES = {
    "global": dict(sigma_knots=[0.0, 10.0, 40.0], alpha_knots=[0.1, 0.5,
                                                               0.9]),
    "two_band": dict(sigma_knots=[0.0, 10.0, 40.0],
                     alpha_knots=[0.2, 0.6, 1.0],
                     alpha_low_knots=[0.0, 0.3, 0.8]),
    "two_band_meta": dict(sigma_knots=[1.0, 20.0], alpha_knots=[0.3, 1.0],
                          alpha_low_knots=[0.0, 0.8],
                          meta={"band_kernel": 3, "band_nsig": 1.5}),
    "adaptive": dict(sigma_knots=[2.0, 40.0], alpha_knots=[0.5, 1.0],
                     coef_knots=[0.8, 1.2]),
}


def _pair(seed, shape=(2, 32, 40, 3)):
    rng = np.random.default_rng(seed)
    x = np.round(rng.uniform(0, 255, shape)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 20, shape), 0, 255).astype(np.float32)
    return x, y


@pytest.mark.parametrize("kind", sorted(TABLES))
def test_apply_matches_jax(kind):
    x, y = _pair(len(kind))
    ref = jblend.BlendTable(**TABLES[kind]).apply(jnp.asarray(x),
                                                  jnp.asarray(y))
    got = tblend.BlendTable(**TABLES[kind]).apply(torch.from_numpy(x),
                                                  torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_two_band_equal_curves_recover_global_blend():
    x, y = (torch.from_numpy(v) for v in _pair(7))
    knots, a = [0.0, 10.0, 40.0], [0.1, 0.5, 0.9]
    one = tblend.BlendTable(knots, a).apply(x, y)
    two = tblend.BlendTable(knots, a, alpha_low_knots=a).apply(x, y)
    np.testing.assert_allclose(two.numpy(), one.numpy(), atol=1e-3)
    with pytest.raises(ValueError):
        tblend.BlendTable([1.0, 2.0], [0.0, 1.0], alpha_low_knots=[0.5])
    with pytest.raises(ValueError):
        tblend.BlendTable([1.0, 2.0], [0.0, 1.0], alpha_low_knots=[0.0, 1.5])


# ------------------------------------------------------------ the searches

def _errors(seed, shape=(2, 16, 16, 3)):
    rng = np.random.default_rng(seed)
    err_in = rng.normal(0, 10, shape).astype(np.float32)
    err_out = (0.4 * err_in + rng.normal(0, 4, shape)).astype(np.float32)
    return err_in, err_out


@pytest.mark.parametrize("grid", [11, 101])
def test_optimal_alpha_matches_jax(grid):
    err_in, err_out = _errors(grid)
    assert tblend._optimal_alpha(err_in, err_out, grid) == \
        jblend._optimal_alpha(err_in, err_out, grid)


def _alpha2_cases():
    err_in, err_out = _errors(3)
    d = err_out - err_in
    d_low = 0.5 * d + np.float32(0.1) * err_in
    ones = np.ones((4, 8, 8, 3), np.float32)
    e = np.random.default_rng(0).normal(0, 1, (2, 16, 16, 3)).astype(
        np.float32)
    return {"random": (err_in, d_low, d - d_low),
            "box_edge": (ones, -0.5 * ones, -0.4 * ones),
            "walk": ((0.37 * e) + (0.61 * e), -e, -e)}


@pytest.mark.parametrize("case", ["random", "box_edge", "walk"])
def test_optimal_alpha2_matches_jax(case):
    args = _alpha2_cases()[case]
    got = tblend._optimal_alpha2(*args, grid=101)
    ref = jblend._optimal_alpha2(*args, grid=101)
    assert got[:2] == ref[:2]
    assert got[2] == pytest.approx(ref[2], rel=1e-6)
    assert 0.0 <= got[0] <= 1.0 and 0.0 <= got[1] <= 1.0


# ------------------------------------------------------------- calibration

def test_calibrate_identity_at_zero_model_wins_at_high():
    """A fixed, mildly wrong output: alpha 0 at std 0 (the input wins),
    above 0.8 at std 60, knots increasing with the measured sigma."""
    clean = np.stack([_smooth_image(64, 64)] * 2)
    clean[1] = clean[1][::-1]
    fixed = np.clip(clean + 6.0, 0, 255)
    table = tblend.calibrate_blend(lambda x: fixed, clean,
                                   stds=(0, 4, 30, 60), alpha_grid=21)
    alphas = dict(zip([lv["std"] for lv in table.meta["levels"]],
                      table.alpha_knots.tolist()))
    assert alphas[0.0] == 0.0
    assert alphas[60.0] > 0.8
    assert np.all(np.diff(table.sigma_knots) > 0)
    for lv, a in zip(table.meta["levels"], table.alpha_knots.tolist()):
        assert 0.0 <= a <= 1.0 and lv["alpha"] == a


def test_calibrate_two_band_beats_both_endpoints():
    """An output whose error is purely low-frequency (a DC shift) under
    white noise: the two-band blend takes the output's highs and the
    input's lows and beats both endpoints."""
    clean = np.stack([_smooth_image(64, 64), _smooth_image(64, 64)[::-1]])
    shifted = np.clip(clean + 12.0, 12, 243)
    table = tblend.calibrate_blend(lambda x: torch.from_numpy(shifted),
                                   clean, stds=(0, 20), alpha_grid=51,
                                   bands=2, seed=11)
    assert table.alpha_low_knots is not None
    assert table.meta["band_kernel"] == tblend.BAND_KERNEL
    lv = table.meta["levels"][1]
    assert lv["mae_blend"] < 0.6 * min(lv["mae_noisy"], lv["mae_model"]), lv
    assert lv["alpha_low"] < 0.5 < lv["alpha"], lv
    lv0 = table.meta["levels"][0]
    assert lv0["alpha"] == 0.0 and lv0["alpha_low"] == 0.0


def test_calibrate_adaptive_recovers_identity_regime():
    """A perfect denoiser: the fitted per-image weights realize blend
    MAE below a fifth of the noisy input's."""
    rng = np.random.default_rng(2)
    clean = rng.uniform(40, 210, (4, 32, 32, 3)).astype(np.float32)
    table = tblend.calibrate_blend(lambda noisy: clean, clean,
                                   stds=(10.0, 20.0), adaptive=True)
    assert table.coef_knots is not None
    assert all(r["mae_blend"] < r["mae_noisy"] * 0.2
               for r in table.meta["levels"])


def test_calibrate_rejects_bad_modes():
    with pytest.raises(ValueError, match="single-band"):
        tblend.calibrate_blend(lambda v: v, np.zeros((1, 8, 8, 3)),
                               stds=(5.0,), adaptive=True, bands=2)
    with pytest.raises(ValueError, match="bands must be"):
        tblend.calibrate_blend(lambda v: v, np.zeros((1, 8, 8, 3)),
                               stds=(5.0,), bands=3)


def test_calibrate_over_a_denoiser_float_forward():
    """calibrate_blend takes the port's float_forward (a torch tensor
    out) and its table serves through the same Denoiser."""
    _, variables = tiny_resnet_hydra()
    model = model_builder(copy.deepcopy(TINY_RESNET_MODEL)).hydra
    den = Denoiser(model, jax.tree_util.tree_map(np.asarray, variables),
                   pad_multiple=8, device="cpu")
    clean = np.stack([_smooth_image(32, 32)] * 2)
    table = tblend.calibrate_blend(den.float_forward, clean,
                                   stds=(0, 10, 40), alpha_grid=21)
    assert table.meta["n_images"] == 2 and len(table.alpha_knots) == 3
    served = Denoiser(model, pad_multiple=8, blend=table, device="cpu")
    out = served(clean[0].astype(np.uint8))
    assert out.shape == (32, 32, 3) and out.dtype == np.uint8


# ---------------------------------------------------- blend.json both ways

@pytest.mark.parametrize("kind", sorted(TABLES))
def test_blend_json_cross_loads(kind, tmp_path):
    x, y = _pair(20 + len(kind))
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    tblend.BlendTable(**TABLES[kind]).save(str(port_dir))
    jblend.BlendTable(**TABLES[kind]).save(str(jax_dir))
    assert json.loads((port_dir / "blend.json").read_text()) == \
        json.loads((jax_dir / "blend.json").read_text())
    in_jax = jblend.BlendTable.from_any(str(port_dir))
    in_port = tblend.BlendTable.from_any(str(jax_dir))
    ref = np.asarray(in_jax.apply(jnp.asarray(x), jnp.asarray(y)))
    got = in_port.apply(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)


# ------------------------------------------------- served by the Denoiser

def _tiny_denoiser(**kw):
    _, variables = tiny_resnet_hydra()
    model = model_builder(copy.deepcopy(TINY_RESNET_MODEL)).hydra
    return Denoiser(model, jax.tree_util.tree_map(np.asarray, variables),
                    pad_multiple=8, device="cpu", **kw)


def test_denoiser_serves_two_band_identity_at_clean():
    table = tblend.BlendTable([8.0, 12.0], [0.0, 1.0],
                              alpha_low_knots=[0.0, 1.0])
    d = _tiny_denoiser(blend=table)
    clean = _smooth_image(32, 32).astype(np.uint8)
    np.testing.assert_array_equal(d(clean), clean)
    img = np.random.default_rng(10).integers(0, 256, (2, 24, 40, 3),
                                             dtype=np.uint8)
    out = d(img)
    assert out.shape == img.shape and out.dtype == np.uint8
    tta = _tiny_denoiser(blend=table, tta=4)(img)
    assert tta.shape == img.shape and tta.dtype == np.uint8


def test_float_forward_blends_differentiably():
    table = tblend.BlendTable([0.0, 40.0], [0.5, 0.5])
    d, d_raw = _tiny_denoiser(blend=table), _tiny_denoiser()
    x = torch.from_numpy(_smooth_image(16, 16))
    np.testing.assert_allclose(
        d.float_forward(x).numpy(),
        0.5 * d_raw.float_forward(x).numpy() + 0.5 * x.numpy(), atol=1e-3)
    xg = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(d.float_forward(xg).sum(), xg)
    assert torch.isfinite(g).all()
