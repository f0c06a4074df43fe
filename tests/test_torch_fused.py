"""The port's fused int8 serving path (``inference/fused.py``) against
the JAX package, on the CPU, at a narrow width
(``unet_laplacian_v6`` with filters 8 and width 2, K = 5, 64²; the JAX
params carried across by ``params_from_flax``). JAX runs its Pallas
kernel in interpret mode. The images are smooth colour fields with
sharp-edged shapes, clean and at σ = 25, made from a seed: on uniform
noise, a code that one package's summation order moves by one at an
early unit moves its neighbours through every later 5×5 depthwise, and
the two int8 forwards drift apart, though each stays as close to the
float model as the other. Two width-1 copies without self-attention take
the deeper levels K1's wider shapes serve: filters 32 (level 2 at
C = 128) and filters 36 tripling to ``max_filters`` 256 (levels of
C = 108, no multiple of 16, and 256).

Tolerances, each with its reason:
* the float fused forward in f32 vs JAX's ``hydra.apply``: mean ≤ 0.05
  and max ≤ 1 gray level on every scale (the port's f32 K1 is f32
  throughout); vs JAX's fused forward in f32: JAX's own bar, mean < 1
  and max < 25 gray levels (JAX's kernel rounds ``t`` and ``h`` to bf16
  even in float mode).
* the two fused forwards in int8 with one scales dict: mean ≤ 1 gray
  level on every scale; the port's int8 forward vs JAX's ``hydra.apply``:
  mean < 4 gray levels (JAX's own bar).
* ``calibrate_fused`` vs JAX's: the same sites; in bf16 (both
  packages' ``calibrate_fused``) scales within rtol 2e-2, and in f32
  (each package's recorder through its f32 fused forward) within 1e-2.
  Each scale is one
  activation's amax, and in bf16 that activation differs between the
  packages by a bf16 ulp or two (2⁻⁸–2⁻⁷ relative) where the summation
  orders round it to neighbouring bf16 values; in f32 JAX's float-mode
  kernel still rounds ``t`` and ``h`` to bf16 and the port's does not.
* the bf16 fused forward vs the port's f32 one: per scale within 0.25
  gray levels (mean) of JAX's own jitted bf16 hydra's gap to its f32
  one on the same image.
"""

import copy
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import blind_image_denoising_torch as bidt
from blind_image_denoising_tpu.inference import fused as jax_fused
from blind_image_denoising_tpu.models.hydra import (
    model_builder as jax_model_builder)
from blind_image_denoising_torch.inference import fused
from blind_image_denoising_torch.models import unet_laplacian
from blind_image_denoising_torch.models.hydra import model_builder
from blind_image_denoising_torch.ops import pallas_pyramid
from blind_image_denoising_torch.weights import params_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_v6():
    """``unet_laplacian_v6`` cut to filters 8 and width 2 (tests/
    test_fused.py's TINY_FLAGSHIP)."""
    cfg = copy.deepcopy(bidt.load_config(
        bidt.CONFIGS_DICT["unet_laplacian_v6"])["model"])
    cfg["backbone"].update(filters=8, width=2)
    cfg["denoiser"]["filters"] = 8
    return cfg


def _synthetic(n, h, w, rng):
    """Smooth colour fields with sharp-edged shapes, [n, h, w, 3] float32
    in [0, 255]."""
    out = np.empty((n, h, w, 3), np.float32)
    for i in range(n):
        low = torch.from_numpy(rng.uniform(30, 220, (1, 3, 6, 6)).astype(
            np.float32))
        img = F.interpolate(low, size=(h, w), mode="bicubic",
                            align_corners=False)[0].permute(1, 2, 0).numpy()
        for _ in range(12):
            y0, x0 = rng.integers(0, h), rng.integers(0, w)
            y1 = min(h, y0 + rng.integers(h // 16, h // 3))
            x1 = min(w, x0 + rng.integers(w // 16, w // 3))
            img[y0:y1, x0:x1] = rng.uniform(0, 255, 3)
        out[i] = np.clip(img, 0, 255)
    return out


@pytest.fixture(scope="module")
def tiny():
    cfg = _tiny_v6()
    hydra = jax_model_builder(cfg).hydra
    # under jit: the same params as an eager init, in a third of its time
    variables = jax.jit(lambda key: hydra.init(
        {"params": key}, jnp.zeros((1, 64, 64, 3)), train=False))(
            jax.random.PRNGKey(0))
    variables = {"params": variables["params"]}
    port = model_builder(cfg).hydra
    port.load_state_dict(params_from_flax(jax.tree_util.tree_map(
        np.asarray, variables["params"])), strict=True)
    port.eval().requires_grad_(False)
    rng = np.random.default_rng(1)
    clean = _synthetic(2, 64, 64, rng)
    noisy = np.clip(np.round(clean + rng.normal(0, 25, clean.shape)), 0,
                    255).astype(np.float32)
    return dict(cfg=cfg, hydra=hydra, variables=variables, port=port,
                images=np.concatenate([noisy, clean]))


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _gray_diffs(got, ref):
    """Per scale (mean, max) |Δ| in gray levels; got NCHW torch, ref NHWC
    JAX."""
    assert len(got) == len(ref) == 3
    out = []
    for g, r in zip(got, ref):
        g = g.permute(0, 2, 3, 1).float().numpy()
        assert g.shape == r.shape
        d = np.abs(g - np.asarray(r, np.float32))
        out.append((float(d.mean()), float(d.max())))
    return out


def test_supports_fused_verdicts_match_jax():
    cfg = _tiny_v6()
    bb, head = cfg["backbone"], cfg["denoiser"]
    cases = [bb, dict(bb, use_concat=True), dict(bb, type="resnet"),
             dict(bb, depth=1), dict(bb, use_bn=True),
             dict(bb, use_output_normalization=False),
             dict(bb, encoder_kernel_size=3), dict(bb, activation="relu"),
             dict(bb, upsample_type="bilinear")]
    for c in cases:
        assert fused.supports_fused(c) == jax_fused.supports_fused(c), c
    for h in (head, dict(head, activation="relu"), dict(head, use_ln=True),
              dict(head, use_bias=True), dict(head, activation="linear")):
        assert fused.supports_fused_head(h) == jax_fused.supports_fused_head(
            h), h
    # JAX raises TypeError on a per-level kernel list; the port declines
    tpu = bidt.load_config(bidt.CONFIGS_DICT["unet_laplacian_v6_tpu"])["model"]
    with pytest.raises(TypeError):
        jax_fused.supports_fused(tpu["backbone"])
    assert not fused.supports_fused(tpu["backbone"])
    with pytest.raises(ValueError, match="supported"):
        fused.build_fused_forward(tpu, model_builder(tpu).hydra)
    with pytest.raises(ValueError, match="denoiser-head"):
        fused.build_fused_forward(
            dict(cfg, denoiser=dict(head, use_bias=True)), None)


def test_fused_float_f32_matches_jax_hydra_and_jax_fused(tiny):
    x = tiny["images"][:1]
    ref = tiny["hydra"].apply(tiny["variables"], jnp.asarray(x), train=False)
    fwd, sites = fused.build_fused_forward(tiny["cfg"], tiny["port"],
                                           dtype=torch.float32)
    got = fwd(_nchw(x))
    for mean, mx in _gray_diffs(got, ref):
        assert mean <= 0.05 and mx <= 1.0, (mean, mx)
    jfwd, jsites = jax_fused.build_fused_forward(
        tiny["cfg"], tiny["variables"], dtype=jnp.float32, interpret=True)
    assert sites == jsites
    for mean, mx in _gray_diffs(got, jfwd(jnp.asarray(x))):
        assert mean < 1.0 and mx < 25.0, (mean, mx)


def test_fused_levels_leave_unfused_units_to_plain_pytorch(tiny):
    """With only level 0 fused, level 1's ConvNext units run as plain
    PyTorch (JAX's ``xla_stage``): still the hydra's function."""
    x = tiny["images"][:1]
    ref = tiny["hydra"].apply(tiny["variables"], jnp.asarray(x), train=False)
    fwd, sites = fused.build_fused_forward(tiny["cfg"], tiny["port"],
                                           dtype=torch.float32,
                                           fused_levels=(0,))
    assert sites == jax_fused._stage_sites((0,), 2)
    for mean, mx in _gray_diffs(fwd(_nchw(x)), ref):
        assert mean <= 0.05 and mx <= 1.0, (mean, mx)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_calibrate_fused_matches_jax(tiny, dtype):
    images = tiny["images"]
    _, jsites = jax_fused.build_fused_forward(tiny["cfg"],
                                              tiny["variables"])
    if dtype == "bfloat16":       # both calibrate_fused run in bf16
        scales = fused.calibrate_fused(tiny["cfg"], tiny["port"],
                                       _nchw(images))
        ref = jax_fused.calibrate_fused(tiny["cfg"], tiny["variables"],
                                        images, interpret=True)
        rtol = 2e-2
    else:       # each recorder through its f32 fused forward, image by image
        rec, jrec = fused._AmaxRecorder(), jax_fused._AmaxRecorder()
        fwd, _ = fused.build_fused_forward(
            tiny["cfg"], tiny["port"], dtype=torch.float32, _recorder=rec)
        jfwd, _ = jax_fused.build_fused_forward(
            tiny["cfg"], tiny["variables"], dtype=jnp.float32,
            interpret=True, _recorder=jrec)
        for i in range(images.shape[0]):
            fwd(_nchw(images[i:i + 1]))
            jfwd(jnp.asarray(images[i:i + 1]))
        scales, ref = ({k: max(a, 1e-6) / 127.0 for k, a in r.amax.items()}
                       for r in (rec, jrec))
        rtol = 1e-2
    assert set(scales) == set(ref) == set(jsites)
    for k in ref:
        np.testing.assert_allclose(scales[k], ref[k], rtol=rtol, err_msg=k)


def test_fused_int8_matches_jax_fused_int8_and_hydra(tiny):
    scales = jax_fused.calibrate_fused(tiny["cfg"], tiny["variables"],
                                       tiny["images"], interpret=True)
    x = tiny["images"][:1]
    jfwd, _ = jax_fused.build_fused_forward(
        tiny["cfg"], tiny["variables"], scales=scales, dtype=jnp.float32,
        interpret=True)
    fwd, _ = fused.build_fused_forward(tiny["cfg"], tiny["port"], scales,
                                       dtype=torch.float32)
    got = fwd(_nchw(x))
    for mean, _ in _gray_diffs(got, jfwd(jnp.asarray(x))):
        assert mean <= 1.0, mean
    ref = tiny["hydra"].apply(tiny["variables"], jnp.asarray(x), train=False)
    mean, _ = _gray_diffs(got, ref)[0]
    assert mean < 4.0, mean


def test_fused_bf16_tracks_f32_and_launches_no_band_kernel(tiny,
                                                           monkeypatch):
    """bf16 (the serving dtype) against the f32 fused forward: per scale
    no further (mean gray levels) than JAX's own jitted bf16 hydra from
    its f32 one, plus 0.25. The fused stages call K1 once per unit (12
    units at the full config's width 3, 8 here) and the path calls no
    K2."""
    calls = []
    real = fused.convnext_block
    monkeypatch.setattr(fused, "convnext_block",
                        lambda *a, **k: calls.append(a[0].dtype) or real(
                            *a, **k))
    def no_k2(*args, **kwargs):
        raise AssertionError("the fused path called the band-split kernel")

    monkeypatch.setattr(pallas_pyramid, "band_smooth", no_k2)
    monkeypatch.setattr(unet_laplacian, "band_smooth", no_k2)
    x = _nchw(tiny["images"][2:3])
    f32, _ = fused.build_fused_forward(tiny["cfg"], tiny["port"],
                                       dtype=torch.float32)
    bf16, _ = fused.build_fused_forward(tiny["cfg"], tiny["port"])
    ref, got = f32(x), bf16(x)
    assert calls == [torch.float32] * 8 + [torch.bfloat16] * 8
    xj = jnp.asarray(tiny["images"][2:3])
    jax_bf16 = jax_model_builder(tiny["cfg"], dtype=jnp.bfloat16).hydra
    jax_got = jax.jit(lambda v, a: jax_bf16.apply(v, a, train=False))(
        tiny["variables"], xj)
    jax_ref = tiny["hydra"].apply(tiny["variables"], xj, train=False)
    for g, r, jg, jr in zip(got, ref, jax_got, jax_ref):
        assert g.dtype == torch.float32
        jax_gap = float(jnp.abs(jg.astype(jnp.float32) - jr).mean())
        assert float((g - r).abs().mean()) <= jax_gap + 0.25


def _wide_level2_v6():
    """``unet_laplacian_v6`` at its own filters 32 (level 2 is 128 wide)
    with width 1 and no self-attention, so that level 2 holds a ConvNext
    unit (K = 5) the fused forward can take."""
    cfg = copy.deepcopy(bidt.load_config(
        bidt.CONFIGS_DICT["unet_laplacian_v6"])["model"])
    cfg["backbone"].update(width=1, use_self_attention=False)
    return cfg


def _seeded_pair(cfg):
    """JAX's hydra of ``cfg`` initialised as the ``tiny`` fixture is (flax,
    key 0), under ``jit`` (an eager flax init of these widths takes ~20 s
    on the CPU, ~7 jitted), the port's with the same params, and one
    noisy and one clean 64² image."""
    hydra = jax_model_builder(cfg).hydra
    variables = jax.jit(lambda key: hydra.init(
        {"params": key}, jnp.zeros((1, 64, 64, 3)), train=False))(
            jax.random.PRNGKey(0))
    variables = {"params": variables["params"]}
    port = model_builder(cfg).hydra
    port.load_state_dict(params_from_flax(jax.tree_util.tree_map(
        np.asarray, variables["params"])), strict=True)
    port.eval().requires_grad_(False)
    rng = np.random.default_rng(3)
    clean = _synthetic(1, 64, 64, rng)
    noisy = np.clip(np.round(clean + rng.normal(0, 25, clean.shape)), 0,
                    255).astype(np.float32)
    return dict(cfg=cfg, hydra=hydra, variables=variables, port=port,
                images=np.concatenate([noisy, clean]))


@pytest.fixture(scope="module")
def wide():
    return _seeded_pair(_wide_level2_v6())


def _ragged_c256_v6():
    """``unet_laplacian_v6`` with width 1, no self-attention and filters
    36 tripling per level up to ``max_filters`` 256: levels of C = 36, 108
    (no multiple of 16) and 256, each holding a ConvNext unit (K = 5) the
    fused forward can take."""
    cfg = _wide_level2_v6()
    cfg["backbone"].update(filters=36, filters_level_multiplier=3.0,
                           max_filters=256)
    cfg["denoiser"]["filters"] = 36
    return cfg


@pytest.fixture(scope="module")
def ragged():
    return _seeded_pair(_ragged_c256_v6())


LEVELS_TO_2 = (0, 1, 2)


def _fused_matches_jax(pair, monkeypatch, levels, widths):
    """The checks of the fused tests with ``levels`` fused (of these
    ``widths``):
    the port's f32 float fused forward on the CPU against JAX's hydra
    (mean <= 0.05, max <= 1) and JAX's fused forward in interpret mode
    (mean < 1, max < 25), the existing fused tests' bars; the same sites
    as JAX's; one K1 call a unit, at the levels' widths;
    ``calibrate_fused(..., fused_levels=)`` records the sites JAX's
    recorder does; and the int8 forward with JAX's scales (its f32
    recorder through its fused forward at the same levels) within a mean
    of 1 gray level of JAX's int8 fused forward and 4 of JAX's hydra."""
    x = pair["images"][:1]
    calls = []
    real = fused.convnext_block
    monkeypatch.setattr(fused, "convnext_block",
                        lambda *a, **k: calls.append(a[0].shape[-1]) or real(
                            *a, **k))
    fwd, sites = fused.build_fused_forward(
        pair["cfg"], pair["port"], dtype=torch.float32, fused_levels=levels)
    got = fwd(_nchw(x))
    assert calls == [*widths, *widths[-2::-1]]
    ref = pair["hydra"].apply(pair["variables"], jnp.asarray(x), train=False)
    for mean, mx in _gray_diffs(got, ref):
        assert mean <= 0.05 and mx <= 1.0, (mean, mx)
    jrec = jax_fused._AmaxRecorder()
    jfwd, jsites = jax_fused.build_fused_forward(
        pair["cfg"], pair["variables"], dtype=jnp.float32, interpret=True,
        fused_levels=levels, _recorder=jrec)
    assert sites == jsites == jax_fused._stage_sites(levels, 1)
    for mean, mx in _gray_diffs(got, jfwd(jnp.asarray(x))):
        assert mean < 1.0 and mx < 25.0, (mean, mx)
    jfwd(jnp.asarray(pair["images"][1:]))
    scales = {k: max(a, 1e-6) / 127.0 for k, a in jrec.amax.items()}
    # the deepest level (2) has no decoder stage; the port's calibration
    # at the same levels records the same sites
    assert set(scales) == set(fused.calibrate_fused(
        pair["cfg"], pair["port"], _nchw(x), fused_levels=levels)) == {
            s for s in sites if not s.startswith("decoder_2")}
    jq, _ = jax_fused.build_fused_forward(
        pair["cfg"], pair["variables"], scales=scales, dtype=jnp.float32,
        interpret=True, fused_levels=levels)
    q, _ = fused.build_fused_forward(pair["cfg"], pair["port"], scales,
                                     dtype=torch.float32, fused_levels=levels)
    got_q = q(_nchw(x))
    for mean, _ in _gray_diffs(got_q, jq(jnp.asarray(x))):
        assert mean <= 1.0, mean
    mean, _ = _gray_diffs(got_q, ref)[0]
    assert mean < 4.0, mean


def test_fused_level2_at_c128_matches_jax(wide, monkeypatch):
    """Levels 0-2 fused, level 2 at C = 128 (K1's (128, 5)), against JAX
    at the bars of ``_fused_matches_jax``."""
    _fused_matches_jax(wide, monkeypatch, LEVELS_TO_2, [32, 64, 128])


def test_fused_ragged_and_c256_levels_match_jax(ragged, monkeypatch):
    """Levels 1 and 2 fused, at C = 108 (no multiple of 16: K1's C = 128
    class, its channels padded) and 256 (its wide class), against JAX at
    the bars of ``_fused_matches_jax``. Only the levels that need the new
    shapes are fused: with level 0 fused too, each package's int8 forward
    stays as close to the float model as the other's (4.34 and 4.31 mean
    gray levels on the finest scale), but the codes their summation orders
    move by one at full resolution spread through every later 5 x 5
    depthwise and the two drift 2.4 apart; fused from level 1 they are
    0.6 apart."""
    _fused_matches_jax(ragged, monkeypatch, (1, 2), [108, 256])


def _c512_v6():
    """``unet_laplacian_v6`` with width 1, no self-attention and filters
    32 growing 4x a level: levels of C = 32, 128 and 512, the last a
    ConvNext unit (K = 5) the fused forward can take at K1's widest class."""
    cfg = _wide_level2_v6()
    cfg["backbone"].update(filters_level_multiplier=4.0)
    return cfg


def test_fused_c512_level_matches_jax(monkeypatch):
    """Level 2 fused at C = 512 (K1's class of width 512), at 16² (a band
    JAX's ``_pick_rows`` tiles), against JAX at the bars of
    ``_fused_matches_jax``."""
    _fused_matches_jax(_seeded_pair(_c512_v6()), monkeypatch, (2,), [512])


def _c1024_v6():
    """``unet_laplacian_v6`` with width 1, no self-attention and filters
    64 growing 4x a level: levels of C = 64, 256 and 1024, the last a
    ConvNext unit (K = 5) that K1's widest cluster (8 blocks) runs."""
    cfg = _c512_v6()
    cfg["backbone"].update(filters=64)
    cfg["denoiser"]["filters"] = 64
    return cfg


def test_fused_c1024_level_matches_jax(monkeypatch):
    """Level 2 fused at C = 1024, at 16², against JAX at the bars of
    ``_fused_matches_jax``."""
    _fused_matches_jax(_seeded_pair(_c1024_v6()), monkeypatch, (2,), [1024])


def _k1_calls(model, x):
    """The (C, K) of every K1 call of one forward of ``model`` on the CPU
    (K1's plain version), and the units that ran their branch instead."""
    from blind_image_denoising_torch.layers import convnext as convnext_mod
    from blind_image_denoising_torch.ops import pallas_convnext
    calls = []
    real = convnext_mod.convnext_block
    convnext_mod.convnext_block = lambda *a, **k: calls.append(
        (a[0].shape[-1], k["dw"].shape[-1])) or real(*a, **k)
    try:
        b0 = pallas_convnext.branch_units
        with torch.no_grad():
            model(x)
        return calls, pallas_convnext.branch_units - b0
    finally:
        convnext_mod.convnext_block = real


@pytest.mark.parametrize("case", ["k7", "depth5_no_attention",
                                  "depth6_no_attention",
                                  "depth7_no_attention"])
def test_k7_and_c512_v6_units_route_to_k1(case):
    """The K = 7, depth-5, depth-6 and depth-7 paths' hydras, at width 1: a
    ``unet_laplacian_v6`` whose encoder and decoder kernel sizes are 7
    sends its (32, 7) and (64, 7) units to K1 (level 2 is its attention
    level), a depth-5 one without self-attention its (512, 5) level 4 too,
    a depth-6 one its (1024, 5) level 5, and a depth-7 one its (2048, 5)
    level 6 (K1's general route): no unit adds to ``branch_units``."""
    cfg = copy.deepcopy(bidt.load_config(
        bidt.CONFIGS_DICT["unet_laplacian_v6"])["model"])
    if case == "k7":
        cfg["backbone"].update(width=1, encoder_kernel_size=7,
                               decoder_kernel_size=7)
        want, hw = {(32, 7): 2, (64, 7): 2}, 32
    elif case == "depth5_no_attention":
        cfg["backbone"].update(width=1, depth=5, use_self_attention=False)
        want, hw = {(32, 5): 2, (64, 5): 2, (128, 5): 2, (256, 5): 2,
                    (512, 5): 1}, 64
    elif case == "depth6_no_attention":
        cfg["backbone"].update(width=1, depth=6, use_self_attention=False)
        want, hw = {(32, 5): 2, (64, 5): 2, (128, 5): 2, (256, 5): 2,
                    (512, 5): 2, (1024, 5): 1}, 64
    else:
        cfg["backbone"].update(width=1, depth=7, use_self_attention=False)
        want, hw = {(32, 5): 2, (64, 5): 2, (128, 5): 2, (256, 5): 2,
                    (512, 5): 2, (1024, 5): 2, (2048, 5): 1}, 128
    model = model_builder(cfg).hydra.eval().requires_grad_(False)
    calls, branch = _k1_calls(model, torch.rand(
        (1, 3, hw, hw), generator=torch.Generator().manual_seed(0)) * 255)
    assert branch == 0
    assert {ck: calls.count(ck) for ck in set(calls)} == want


def test_depth4_level2_units_route_to_k1():
    """A depth-4 filters-32 unit stack (``unet_laplacian_v4``, narrowed to
    width 1 and 64²) sends its level-2 units (C = 128: the encoder's
    (128, 5), the decoder's (128, 1)) to K1, whose plain version runs
    them on the CPU: no unit adds to ``branch_units``."""
    from blind_image_denoising_torch.layers import convnext as convnext_mod
    from blind_image_denoising_torch.ops import pallas_convnext
    cfg = copy.deepcopy(bidt.load_config(
        bidt.CONFIGS_DICT["unet_laplacian_v4"])["model"])
    cfg["backbone"].update(width=1)
    assert cfg["backbone"]["filters"] == 32 and cfg["backbone"]["depth"] == 4
    model = model_builder(cfg).hydra.eval().requires_grad_(False)
    calls = []
    real = convnext_mod.convnext_block
    convnext_mod.convnext_block = lambda *a, **k: calls.append(
        (a[0].shape[-1], k["dw"].shape[-1])) or real(*a, **k)
    try:
        b0 = pallas_convnext.branch_units
        with torch.no_grad():
            model(torch.rand((1, 3, 64, 64),
                             generator=torch.Generator().manual_seed(0)) * 255)
        assert pallas_convnext.branch_units == b0
    finally:
        convnext_mod.convnext_block = real
    assert sorted(c for c in calls if c[0] == 128) == [(128, 1), (128, 5)]


def test_fused_module_imports_no_jax():
    code = (
        "import sys\n"
        "BLOCKED = ('jax', 'jaxlib', 'flax', 'msgpack',\n"
        "           'blind_image_denoising_tpu')\n"
        "class _Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, _Block())\n"
        "import copy, torch\n"
        "import blind_image_denoising_torch as bidt\n"
        "from blind_image_denoising_torch.inference.fused import (\n"
        "    build_fused_forward, calibrate_fused)\n"
        "from blind_image_denoising_torch.models.hydra import model_builder\n"
        "from blind_image_denoising_torch.training.train_state import (\n"
        "    init_params)\n"
        "cfg = copy.deepcopy(bidt.load_config(\n"
        "    bidt.CONFIGS_DICT['unet_laplacian_v6'])['model'])\n"
        "cfg['backbone'].update(filters=8, width=1)\n"
        "cfg['denoiser']['filters'] = 8\n"
        "m = model_builder(cfg).hydra\n"
        "init_params(m, torch.Generator().manual_seed(0))\n"
        "x = torch.rand((1, 3, 32, 32)) * 255\n"
        "s = calibrate_fused(cfg, m, x)\n"
        "outs = build_fused_forward(cfg, m, s)[0](x)\n"
        "assert [tuple(o.shape) for o in outs] == [(1, 3, 32, 32),\n"
        "    (1, 3, 16, 16), (1, 3, 8, 8)]\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in BLOCKED]\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
