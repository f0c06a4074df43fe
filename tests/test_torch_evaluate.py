"""The port's evaluation harness (``blind_image_denoising_torch/evaluate.py``)
and the ops it adds, on the CPU.

* ``noise_sweep`` on identity and perfect denoisers (the bars of
  ``tests/test_evaluate.py``), and on the same denoiser its records agree
  with JAX's sweep in distribution (another noise stream).
* ``ops/losses.psnr`` against JAX's; ``ops/noise.corrupt_batch_fixed_std``
  statistics: the noise stays within ±2σ before rounding, its std is the
  truncated normal's (0.8796σ), the rounding lands on integers, and a
  seeded generator repeats its draw.
* The CLI with ``--device cpu`` on an artifact the test writes; the
  restoration parts, once raises naming ROADMAP item 11, now run (their
  checks against JAX are ``tests/test_torch_degradations.py``), and a bad
  ``--degradations`` spec fails before a model loads; a directory of
  image files decodes (bit-equal to JAX's ``load_eval_images``).
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blind_image_denoising_tpu import evaluate as jevaluate
from blind_image_denoising_tpu.ops.losses import psnr as jax_psnr
from blind_image_denoising_torch import evaluate
from blind_image_denoising_torch.images import load_evaluation_images
from blind_image_denoising_torch.ops.losses import psnr
from blind_image_denoising_torch.ops.noise import corrupt_batch_fixed_std

# std of a standard normal truncated to [-2, 2]
TRUNCATED_STD = 0.8796


def test_noise_sweep_identity_denoiser():
    images = load_evaluation_images(64)
    records = evaluate.noise_sweep(lambda x: x, images, stds=(0, 20))
    by_std = {r["noise_std"]: r for r in records}
    assert by_std[0.0]["mae_denoised"] < 1e-6
    assert abs(by_std[20.0]["mae_denoised"]
               - by_std[20.0]["mae_noisy"]) < 1e-3
    assert by_std[20.0]["mae_noisy"] > 10.0


def test_noise_sweep_perfect_denoiser():
    images = load_evaluation_images(64)
    clean_uint8 = np.clip(np.round(images), 0, 255).astype(np.uint8)
    (r,) = evaluate.noise_sweep(lambda x: clean_uint8, images, stds=(20,))
    assert r["mae_denoised"] < r["mae_noisy"]
    assert r["psnr_denoised"] > r["psnr_noisy"]
    assert r["ssim_denoised"] > r["ssim_noisy"]


def test_noise_sweep_agrees_with_jax_in_distribution():
    images = load_evaluation_images(64)
    ours = evaluate.noise_sweep(lambda x: x, images, stds=(5, 25))
    ref = jevaluate.noise_sweep(lambda x: x, images, stds=(5, 25))
    assert set(ours[0]) == set(ref[0])
    for a, b in zip(ours, ref):
        assert a["noise_std"] == b["noise_std"]
        assert a["mae_noisy"] == pytest.approx(b["mae_noisy"], rel=0.02)
        assert a["psnr_noisy"] == pytest.approx(b["psnr_noisy"], abs=0.1)
        assert a["ssim_noisy"] == pytest.approx(b["ssim_noisy"], abs=0.01)


def test_psnr_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 255, (3, 16, 20, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 7, a.shape), 0, 255).astype(np.float32)
    assert float(psnr(torch.from_numpy(a), torch.from_numpy(b))) == \
        pytest.approx(float(jax_psnr(jnp.asarray(a), jnp.asarray(b))),
                      abs=1e-4)
    # identical images: the 1e-12 floor, as in JAX
    assert float(psnr(torch.from_numpy(a), torch.from_numpy(a))) == \
        pytest.approx(float(jax_psnr(jnp.asarray(a), jnp.asarray(a))),
                      rel=1e-5)


def test_corrupt_batch_fixed_std_statistics():
    clean = torch.full((4, 64, 64, 3), 128.0)
    std = 10.0
    raw = corrupt_batch_fixed_std(torch.Generator().manual_seed(1), clean,
                                  std, round_values=False)
    noise = (raw - clean).numpy()
    assert np.abs(noise).max() <= 2 * std + 1e-4
    assert noise.std() == pytest.approx(TRUNCATED_STD * std, rel=0.02)
    assert abs(noise.mean()) < 0.1
    rounded = corrupt_batch_fixed_std(torch.Generator().manual_seed(1),
                                      clean, std)
    np.testing.assert_array_equal(rounded.numpy(), np.round(raw.numpy()))
    again = corrupt_batch_fixed_std(torch.Generator().manual_seed(1), clean,
                                    std)
    np.testing.assert_array_equal(rounded.numpy(), again.numpy())
    other = corrupt_batch_fixed_std(torch.Generator().manual_seed(2), clean,
                                    std)
    assert not torch.equal(rounded, other)


def test_evaluate_cli_on_cpu(tmp_path, capsys):
    from blind_image_denoising_tpu.inference.export import (
        save_params_artifact)
    from conftest import TINY_RESNET_MODEL, tiny_resnet_hydra

    _, variables = tiny_resnet_hydra()
    artifact = save_params_artifact(
        jax.tree_util.tree_map(np.asarray, variables["params"]),
        {"model": copy.deepcopy(TINY_RESNET_MODEL)}, tmp_path / "artifact")
    rc = evaluate.main(["--model", str(artifact), "--device", "cpu",
                        "--size", "32", "--limit", "2", "--stds", "0,20",
                        "--tta", "4"])
    assert rc == 0
    records = json.loads(capsys.readouterr().out)
    assert [r["noise_std"] for r in records] == [0.0, 20.0]
    assert records[1]["mae_noisy"] > 5.0


def test_unported_parts_raise(tmp_path):
    from PIL import Image
    assert evaluate.parse_degradation_spec("blur:1.5") == [("blur", 1.5)]
    out = evaluate.apply_degradations(np.zeros((1, 8, 8, 3)), "jpeg:50",
                                      device="cpu")
    assert out.shape == (1, 8, 8, 3) and out.dtype == np.float32
    records = evaluate.degradation_sweep(
        lambda x: x, np.zeros((1, 32, 32, 3)), ["jpeg:50"], device="cpu")
    assert [r["degradation"] for r in records] == ["jpeg:50"]
    with pytest.raises(ValueError, match="unknown degradation"):
        evaluate.main(["--model", "unet_laplacian_v6_tpu_scratch",
                       "--device", "cpu", "--degradations", "jpg:50"])
    # a directory without images falls back to the packaged set ...
    imgs = evaluate.load_eval_images(str(tmp_path), size=32, limit=2)
    assert imgs.shape == (2, 32, 32, 3)
    np.testing.assert_array_equal(imgs, load_evaluation_images(32)[:2])
    # ... one with images decodes them, resized with pad, as JAX does
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (20, 28, 3), dtype=np.uint8)).save(
        tmp_path / "a.png")
    imgs = evaluate.load_eval_images(str(tmp_path), size=32)
    assert imgs.shape == (1, 32, 32, 3)
    np.testing.assert_array_equal(imgs, jevaluate.load_eval_images(
        str(tmp_path), size=32))
