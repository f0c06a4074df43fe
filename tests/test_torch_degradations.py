"""The blind-restoration path of the port against the JAX package, on the
CPU: ``ops/degradations.py``, ``ops/pyramid.py``, the restoration parts
of ``evaluate.py``, and the degradation chain in the train step and the
loop.

* Deterministic ops against JAX on seeded numpy batches: ``rotate_batch``
  at 0, ±0.3, ±π/2 and 1 rad on odd and even sizes with 1 and 3 channels
  within 1e-3 gray levels (float32 rounding of the inverse map);
  ``separable_blur_batch`` within 1e-4; ``_quality_scaled_table`` at Q
  1, 25, 50, 75 and 100 exact; ``jpeg_artifacts`` on 1 and 3 channels
  with H and W not multiples of 8: mean |Δ| ≤ 1e-3 and ≥ 99.9% of pixels
  within 1e-2 (a coefficient on a .5 tie may round the other way);
  ``quantize_batch`` and ``inpaint_dropout`` on JAX's own mask exact.
* The random wrappers in distribution: each gate's rate within 4σ of its
  probability on 2000 samples, the drawn σ, quality and angle inside
  their ranges (the output equals the op at the redrawn values), the
  hole rate and its channel coherence; ``degrade_batch``'s master gate
  rate, and its noise-only samples equal to the chain's own noise draw
  (a run with the extended ops gated off gives the same output at
  ``chain_prob`` 0.5 as at 1.0).
* ``evaluate``: ``parse_degradation_spec`` equal to JAX on valid specs,
  and raising the same error with the same message on each invalid one;
  ``apply_degradations`` on the deterministic specs equal to JAX's after
  rounding on ≥ 99.9% of pixels (within 1 gray level everywhere); noise
  and holes reproducible per seed, at their rate; ``degradation_sweep``'s
  record keys JAX's; the CLI's ``--degradations --device cpu``.
* The Gaussian and Laplacian pyramids and their builders against JAX
  within 1e-5 of the input's scale, and each forward/inverse pair
  reconstructs.
* The train step with rotation and the whole chain on (the restoration
  recipe's options): no host read of a device value inside a step
  (``Tensor.item`` and the conversions raise), finite losses; the
  ground-truth pyramid is built from the rotated clean batch;
  ``pallas_noise`` with any extended op raises ``ValueError`` as in JAX.
  The loop with ``dataset.apply_degradations``: the resolved options
  reach ``build_train_step``, and the state restored from its checkpoint
  equals the run's bit for bit.
"""

import copy
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blind_image_denoising_torch as bidt
from blind_image_denoising_tpu import evaluate as jevaluate
from blind_image_denoising_tpu.ops import degradations as jdeg
from blind_image_denoising_tpu.ops import pyramid as jpyr
from blind_image_denoising_tpu.training import (
    build_train_step as jax_build_train_step)
from blind_image_denoising_torch import evaluate
from blind_image_denoising_torch.models.hydra import model_builder
from blind_image_denoising_torch.ops import degradations as deg
from blind_image_denoising_torch.ops import pyramid as pyr
from blind_image_denoising_torch.ops.noise import corrupt_batch
from blind_image_denoising_torch.training import (
    build_train_step, create_train_state, loss_function_builder,
    optimizer_builder)
from blind_image_denoising_torch.training import train_loop as loop_module
from blind_image_denoising_torch.training import train_step as step_module
from blind_image_denoising_torch.training.checkpoint import CheckpointManager

CONFIG = "unet_laplacian_v6_tpu"


def _batch(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(
        np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _within(count, n, p, sigmas=4.0):
    return abs(count / n - p) <= sigmas * math.sqrt(p * (1 - p) / n)


# ------------------------------------------------------ deterministic ops

@pytest.mark.parametrize("angle", [0.0, 0.3, -0.3, math.pi / 2,
                                   -math.pi / 2, 1.0])
@pytest.mark.parametrize("shape", [(2, 9, 11, 1), (2, 10, 12, 3)])
def test_rotate_batch_matches_jax(angle, shape):
    x = _batch(shape)
    a = np.asarray([angle, -0.5 * angle], np.float32)
    ref = np.asarray(jdeg.rotate_batch(jnp.asarray(x), jnp.asarray(a)))
    got = deg.rotate_batch(_t(x), _t(a)).numpy()
    assert np.abs(got - ref).max() <= 1e-3


def test_rotate_batch_reflects_half_sample():
    """scipy's ``reflect`` (= ``grid-mirror``): ``arange(5)`` read at
    −1.5, −0.5, −0.25, 4.25, 4.5, 5.5 gives 0.5, 0, 0, 4, 4, 3.5."""
    coords = torch.tensor([-1.5, -0.5, -0.25, 4.25, 4.5, 5.5])
    lower = torch.floor(coords)
    w = coords - lower
    row = torch.arange(5.0)
    i0 = deg._reflect_index(lower.long(), 5)
    i1 = deg._reflect_index(lower.long() + 1, 5)
    got = (1 - w) * row[i0] + w * row[i1]
    assert got.tolist() == [0.5, 0.0, 0.0, 4.0, 4.0, 3.5]


@pytest.mark.parametrize("shape", [(3, 9, 13, 1), (3, 16, 10, 3)])
def test_separable_blur_matches_jax(shape):
    x = _batch(shape, seed=1)
    s = np.asarray([1e-4, 0.7, 2.0], np.float32)
    ref = np.asarray(jdeg.separable_blur_batch(jnp.asarray(x),
                                               jnp.asarray(s)))
    got = deg.separable_blur_batch(_t(x), _t(s)).numpy()
    assert np.abs(got - ref).max() <= 1e-4


@pytest.mark.parametrize("quality", [1, 25, 50, 75, 100])
def test_quality_scaled_table_is_exact(quality):
    q = np.asarray([quality, quality + 0.5], np.float32)
    for base in (jdeg._JPEG_LUMA_Q, jdeg._JPEG_CHROMA_Q):
        ref = np.asarray(jdeg._quality_scaled_table(base, jnp.asarray(q)))
        got = deg._quality_scaled_table(base, _t(q)).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", [(3, 13, 19, 1), (3, 21, 14, 3)])
def test_jpeg_artifacts_match_jax(shape):
    x = _batch(shape, seed=2)
    q = np.asarray([10.0, 50.0, 90.0], np.float32)
    ref = np.asarray(jdeg.jpeg_artifacts(jnp.asarray(x), jnp.asarray(q)))
    got = deg.jpeg_artifacts(_t(x), _t(q)).numpy()
    d = np.abs(got - ref)
    assert got.shape == ref.shape
    assert d.mean() <= 1e-3 and (d <= 1e-2).mean() >= 0.999


def test_quantize_and_inpaint_on_a_given_mask_are_exact():
    x = _batch((2, 7, 9, 3), seed=3)
    np.testing.assert_array_equal(
        deg.quantize_batch(_t(x), 8.0).numpy(),
        np.asarray(jdeg.quantize_batch(jnp.asarray(x), 8.0)))
    key = jax.random.PRNGKey(4)
    ref = np.asarray(jdeg.inpaint_dropout(key, jnp.asarray(x), 0.3))
    # JAX's own mask: the second half of the split key
    _, k_mask = jax.random.split(key)
    keep = np.asarray(jax.random.uniform(k_mask, (2, 7, 9, 1)) >= 0.3)
    got = deg.inpaint_dropout(None, _t(x), 0.3, keep=_t(keep)).numpy()
    np.testing.assert_array_equal(got, ref)


# ------------------------------------------------------- random wrappers

N = 2000


def _images(n=N, h=6, w=6, c=1, seed=5):
    return _t(_batch((n, h, w, c), seed=seed))


def _changed(a, b):
    return (a != b).flatten(1).any(dim=1)


def test_random_blur_gate_and_sigma():
    x = _images()
    out = deg.random_blur(torch.Generator().manual_seed(0), x,
                          sigma_range=(0.5, 2.0), prob=0.3)
    g = torch.Generator().manual_seed(0)
    flags = torch.rand((N, 1, 1, 1), generator=g) < 0.3
    sig = 0.5 + 1.5 * torch.rand((N,), generator=g)
    assert torch.equal(out, torch.where(
        flags, deg.separable_blur_batch(x, sig), x))
    assert _within(int(_changed(out, x).sum()), N, 0.3)
    assert 0.5 <= float(sig.min()) and float(sig.max()) <= 2.0


def test_random_jpeg_gate_and_quality():
    x = _images(h=8, w=8, c=3)
    out = deg.random_jpeg(torch.Generator().manual_seed(1), x, prob=0.5)
    g = torch.Generator().manual_seed(1)
    flags = torch.rand((N, 1, 1, 1), generator=g) < 0.5
    quality = 25.0 + 50.0 * torch.rand((N,), generator=g)
    assert torch.equal(out, torch.where(flags, deg.jpeg_artifacts(x, quality),
                                        x))
    assert 25.0 <= float(quality.min()) and float(quality.max()) <= 75.0
    assert _within(int(_changed(out, x).sum()), N, 0.5)


def test_random_quantize_gate():
    x = _images()
    out = deg.random_quantize(torch.Generator().manual_seed(2), x, 8,
                              prob=0.4)
    changed = _changed(out, x)
    assert _within(int(changed.sum()), N, 0.4)
    assert torch.equal(out[changed], torch.round(out[changed] / 8) * 8)


def test_inpaint_gate_rate_and_channel_coherence():
    x = _images(c=3) + 1.0                       # no zero pixel before
    out = deg.inpaint_dropout(torch.Generator().manual_seed(3), x, 0.25,
                              prob=0.5)
    holes = out == 0
    assert torch.equal(holes.all(dim=-1), holes.any(dim=-1))
    gated = holes.flatten(1).any(dim=1)
    assert _within(int(gated.sum()), N, 0.5, sigmas=5)
    pixels = holes[gated].all(dim=-1)
    assert _within(int(pixels.sum()), pixels.numel(), 0.25)


def test_random_rotate_angles_in_range():
    x = _images(n=64, h=7, w=9)
    out = deg.random_rotate_batch(torch.Generator().manual_seed(4), x, 0.8)
    a = -0.8 + 1.6 * torch.rand((64,), generator=torch.Generator()
                                .manual_seed(4))
    assert torch.equal(out, deg.rotate_batch(x, a))
    assert float(a.abs().max()) <= 0.8


_CHAIN = dict(additive_noise=[1, 80], multiplicative_noise=[0.05, 0.1],
              noise_sampling="log_uniform", use_random_blur=True,
              use_jpeg_noise=True, quantization=64, inpaint_drop_rate=0.05,
              round_values=False)


def test_chain_noise_only_samples_are_the_chains_noise_draw():
    """With every extended op gated off, a sample that passes the master
    gate gets the chain's noise and one that fails gets the noise-only
    path: both must be the same draw, so the output cannot depend on
    ``chain_prob``."""
    x = _images(n=64, h=8, w=8, c=3)
    outs = [deg.degrade_batch(torch.Generator().manual_seed(6), x,
                              degradation_prob=0.0, chain_prob=c, **_CHAIN)
            for c in (1.0, 0.5, 0.0)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    noise = corrupt_batch(torch.Generator().manual_seed(6), x,
                          additive_noise=[1, 80],
                          multiplicative_noise=[0.05, 0.1],
                          round_values=False, noise_sampling="log_uniform")
    # the noise follows the blur's two draws, so it is another stream
    # than a bare corrupt_batch from the same seed
    assert not torch.equal(outs[0], noise)


def test_chain_master_gate_rate():
    x = _images(c=3)
    degraded = deg.degrade_batch(torch.Generator().manual_seed(7), x,
                                 degradation_prob=1.0, chain_prob=0.3,
                                 **_CHAIN)
    noise_only = deg.degrade_batch(torch.Generator().manual_seed(7), x,
                                   degradation_prob=0.0, chain_prob=0.3,
                                   **_CHAIN)
    # the same master flags in both runs: a sample that failed the gate is
    # the noise-only sample in both, one that passed is posterized (q = 64)
    chained = _changed(degraded, noise_only)
    assert _within(int(chained.sum()), N, 0.3)
    posterized = degraded[chained]
    kept = posterized != 0                       # the holes
    assert torch.equal(posterized[kept],
                       torch.round(posterized[kept] / 64) * 64)


def test_chain_rounds_last():
    x = _images(n=16, h=8, w=8, c=3)
    out = deg.degrade_batch(torch.Generator().manual_seed(8), x,
                            **dict(_CHAIN, round_values=True))
    assert torch.equal(out, torch.round(out))


# --------------------------------------------------------------- evaluate

@pytest.mark.parametrize("spec", [
    "blur:1.5+noise:25", "jpeg:50", "JPEG : 30 + posterize:8",
    "holes:0.1", "noise:0", "jpeg:1", "jpeg:100", "posterize:1",
    "blur:0.25+jpeg:75+posterize:4+holes:0.05+noise:10"])
def test_parse_degradation_spec_matches_jax(spec):
    assert evaluate.parse_degradation_spec(spec) == \
        jevaluate.parse_degradation_spec(spec)
    assert evaluate.DEGRADATION_STEPS == jevaluate.DEGRADATION_STEPS


@pytest.mark.parametrize("spec", [
    "", "blur:1.5+", "sharpen:2", "jpeg", "jpeg:0", "jpeg:101", "blur:0",
    "noise:-1", "posterize:0.5", "holes:1", "holes:-0.1", "blur:nan",
    "noise:inf", "jpeg:abc"])
def test_invalid_degradation_specs_raise_as_in_jax(spec):
    with pytest.raises(Exception) as ref:
        jevaluate.parse_degradation_spec(spec)
    with pytest.raises(Exception) as got:
        evaluate.parse_degradation_spec(spec)
    assert type(got.value) is type(ref.value)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("spec", ["jpeg:50", "blur:1.5", "posterize:8",
                                  "blur:1.0+jpeg:30+posterize:4",
                                  "jpeg:90+blur:0.6"])
def test_apply_degradations_matches_jax_on_deterministic_specs(spec):
    images = np.round(_batch((2, 20, 28, 3), seed=9))
    ref = jevaluate.apply_degradations(images, spec)
    got = evaluate.apply_degradations(images, spec, device="cpu")
    assert got.dtype == np.float32 and got.shape == ref.shape
    d = np.abs(got - ref)
    assert (d == 0).mean() >= 0.999 and d.max() <= 1.0


def test_apply_degradations_noise_and_holes():
    images = np.round(_batch((4, 32, 32, 3), seed=10))
    a = evaluate.apply_degradations(images, "noise:20", seed=3, device="cpu")
    b = evaluate.apply_degradations(images, "noise:20", seed=3, device="cpu")
    c = evaluate.apply_degradations(images, "noise:20", seed=4, device="cpu")
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    ref = jevaluate.apply_degradations(images, "noise:20", seed=3)
    # the same distribution: JAX's and the port's MAE within 5%
    assert abs(np.abs(a - images).mean() / np.abs(ref - images).mean()
               - 1.0) <= 0.05
    holes = evaluate.apply_degradations(images + 1, "holes:0.2",
                                        device="cpu") == 0
    assert np.array_equal(holes.all(-1), holes.any(-1))
    assert _within(int(holes[..., 0].sum()), holes[..., 0].size, 0.2)


def test_degradation_sweep_records_match_jax_keys():
    images = np.round(_batch((2, 16, 16, 3), seed=11))
    ref = jevaluate.degradation_sweep(lambda x: x, images, ["jpeg:50"])
    got = evaluate.degradation_sweep(lambda x: x, images, ["jpeg:50"],
                                     device="cpu")
    assert list(got[0]) == list(ref[0])
    assert got[0]["mae_corrupt"] == got[0]["mae_restored"] > 0
    assert got[0]["mae_corrupt"] == pytest.approx(ref[0]["mae_corrupt"],
                                                  rel=1e-3)


def test_evaluate_cli_degradations_on_cpu(tmp_path, capsys):
    from blind_image_denoising_tpu.inference.export import (
        save_params_artifact)
    from conftest import TINY_RESNET_MODEL, tiny_resnet_hydra

    _, variables = tiny_resnet_hydra()
    artifact = save_params_artifact(
        jax.tree_util.tree_map(np.asarray, variables["params"]),
        {"model": copy.deepcopy(TINY_RESNET_MODEL)}, tmp_path / "artifact")
    rc = evaluate.main(["--model", str(artifact), "--device", "cpu",
                        "--size", "32", "--limit", "2", "--degradations",
                        "blur:1.5+noise:25, jpeg:50"])
    assert rc == 0
    records = json.loads(capsys.readouterr().out)
    assert [r["degradation"] for r in records] == ["blur:1.5+noise:25",
                                                   "jpeg:50"]
    assert all(r["mae_corrupt"] > 0 for r in records)


# --------------------------------------------------------------- pyramids

@pytest.mark.parametrize("config", [
    None, {"type": "NONE", "levels": 2}, {"type": "gaussian", "levels": 3},
    {"type": "Laplacian", "levels": 3},
    {"type": "LAPLACIAN", "levels": 4, "kernel_size": [3, 3]},
    {"type": "gaussian", "levels": 2, "kernel_size": [2, 2]}])
def test_pyramids_match_jax(config):
    x = _batch((2, 32, 24, 3), seed=12)
    ref = jpyr.build_pyramid_fn(config)(jnp.asarray(x))
    got = bidt.build_pyramid_model(config)(_t(x))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert np.abs(g.numpy() - np.asarray(r)).max() <= 1e-5 * 255
    back = bidt.build_inverse_pyramid_model(config)(got)
    ref_back = jpyr.build_inverse_pyramid_fn(config)(ref)
    assert np.abs(back.numpy() - np.asarray(ref_back)).max() <= 1e-5 * 255
    assert np.abs(back.numpy() - x).max() <= 1e-4 * 255


def test_pyramid_types():
    assert pyr.PyramidType.from_string(" laplacian ") == \
        pyr.PyramidType.LAPLACIAN
    for bad in (None, "", "  ", "wavelet"):
        with pytest.raises((ValueError, KeyError)):
            pyr.build_pyramid_fn({"type": bad})


# ------------------------------------------------------ train step, loop

def _narrow_model():
    mc = copy.deepcopy(bidt.CONFIGS_DICT[CONFIG]["model"])
    mc["backbone"].update(depth=2, filters=8, width=[1, 1],
                          encoder_kernel_size=[3, 5],
                          decoder_kernel_size=[3, 5])
    return mc


_RECIPE = dict(additive_noise=[1, 80], multiplicative_noise=None,
               noise_sampling="log_uniform", random_rotate=1.57,
               use_random_blur=True, use_jpeg_noise=True, quantization=8,
               inpaint_drop_rate=0.05, degradation_prob=0.5,
               degradation_chain_prob=0.5)


class _NoHostReads:
    """Within the block, reading a tensor's value on the host raises."""
    NAMES = ("item", "tolist", "__bool__", "__float__", "__int__",
             "numpy")

    def __enter__(self):
        self.saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}

        def refuse(*_, **__):
            raise AssertionError("a host read inside the step")
        for n in self.NAMES:
            setattr(torch.Tensor, n, refuse)
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(torch.Tensor, n, f)


def test_train_step_with_the_chain_reads_nothing_on_the_host():
    cfg = copy.deepcopy(bidt.CONFIGS_DICT[CONFIG])
    hydra = model_builder(_narrow_model()).hydra
    tx, _ = optimizer_builder(cfg["train"]["optimizer"])
    state = create_train_state(hydra, tx, seed=0, device="cpu")
    step = build_train_step(hydra, tx, loss_function_builder(cfg["loss"]),
                            hydra.no_outputs, grad_accum=2, **_RECIPE)
    before = {k: v.clone() for k, v in state.params.items()}
    batch = _t(np.round(_batch((4, 32, 32, 3), seed=13)))
    losses = []
    for _ in range(2):
        with _NoHostReads():
            state, metrics = step(state, batch)
        losses.append(float(metrics["total_loss"]))
    assert all(np.isfinite(losses)) and state.step == 2
    assert all(not torch.equal(before[k], v)
               for k, v in state.params.items())


def test_targets_come_from_the_rotated_clean_batch(monkeypatch):
    """No noise and no chain: the input of the forward is the rotated,
    rounded clean batch, and the finest target is that same batch."""
    seen = {}

    def capture(model, loss_fns, no_outputs, noisy, gt_scales, *a, **kw):
        seen["noisy"], seen["gt"] = noisy, gt_scales
        raise StopIteration
    monkeypatch.setattr(step_module, "forward_loss", capture)
    cfg = copy.deepcopy(bidt.CONFIGS_DICT[CONFIG])
    hydra = model_builder(_narrow_model()).hydra
    tx, _ = optimizer_builder(cfg["train"]["optimizer"])
    state = create_train_state(hydra, tx, seed=0, device="cpu")
    step = build_train_step(hydra, tx, loss_function_builder(cfg["loss"]),
                            hydra.no_outputs, random_rotate=1.0,
                            random_left_right=False, random_up_down=False)
    batch = _t(np.round(_batch((2, 16, 16, 3), seed=14)))
    with pytest.raises(StopIteration):
        step(state, batch)
    assert not torch.equal(seen["noisy"], batch)
    assert torch.equal(seen["noisy"], seen["gt"][0])


@pytest.mark.parametrize("option", [
    dict(use_random_blur=True), dict(use_jpeg_noise=True),
    dict(quantization=8), dict(inpaint_drop_rate=0.1)],
    ids=lambda o: next(iter(o)))
def test_pallas_noise_with_the_chain_raises_as_in_jax(option):
    cfg = copy.deepcopy(bidt.CONFIGS_DICT[CONFIG])
    hydra = model_builder(_narrow_model()).hydra
    tx, _ = optimizer_builder(cfg["train"]["optimizer"])
    fns = loss_function_builder(cfg["loss"])
    with pytest.raises(ValueError) as got:
        build_train_step(hydra, tx, fns, 2, use_pallas_noise=True, **option)
    with pytest.raises(ValueError) as ref:
        jax_build_train_step(None, None, {"denoiser": None, "model": None},
                             2, use_pallas_noise=True, **option)
    assert str(got.value) == str(ref.value)


def test_loop_with_degradations_passes_options_and_resumes(tmp_path,
                                                           monkeypatch):
    cfg = copy.deepcopy(bidt.CONFIGS_DICT[CONFIG])
    cfg["model"] = _narrow_model()
    cfg["train"].update(total_steps=3, checkpoint_every=-1,
                        visualization_every=-1, log_every=1,
                        gpu_batches_per_step=1, use_test_images=False,
                        ema=0.5)
    cfg["dataset"].update(inputs=[], input_shape=[32, 32, 3], batch_size=2,
                          additional_noise=[1, 80],
                          noise_sampling="log_uniform",
                          apply_degradations=True, use_jpeg_noise=True,
                          quantization=8, inpaint_drop_rate=0.05,
                          degradation_chain_prob=0.5)
    cfg["tpu"] = {"compute_dtype": "float32"}
    built = []
    real = loop_module.build_train_step

    def build(*args, **kw):
        built.append(kw)
        return real(*args, **kw)
    monkeypatch.setattr(loop_module, "build_train_step", build)
    state = loop_module.train_loop(cfg, tmp_path, device="cpu")
    want = loop_module.resolve_degradation_options(cfg["dataset"])
    assert want["random_rotate"] == 1.57 and want["use_random_blur"]
    assert built and all({k: kw[k] for k in want} == want for kw in built)
    rows = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    losses = [r["total_loss"] for r in rows if "total_loss" in r]
    assert len(losses) == 3 and all(np.isfinite(losses))
    manager = CheckpointManager(str(tmp_path))
    hydra = model_builder(cfg["model"]).hydra
    tx, _ = optimizer_builder(cfg["train"]["optimizer"])
    fresh = manager.restore(create_train_state(hydra, tx, seed=1,
                                               device="cpu"))
    assert fresh.step == state.step == 3
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    for k, v in state.ema_params.items():
        assert torch.equal(fresh.ema_params[k], v), k
