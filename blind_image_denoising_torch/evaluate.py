"""Quality evaluation (counterpart of
``blind_image_denoising_tpu/evaluate.py``): corrupt evaluation images,
denoise, and report MAE / PSNR / SSIM of the corrupted and the restored
images against the clean ones. Works with any denoiser callable (uint8
batch in, batch out).

* ``noise_sweep``: additive ±2σ truncated-normal noise over a std sweep.
* ``degradation_sweep``: blind restoration on deterministic corruption
  chains (``parse_degradation_spec``: ``"blur:1.5+noise:25"``, steps
  ``noise``, ``jpeg``, ``blur``, ``posterize``, ``holes`` applied left
  to right through ``ops/degradations.py``), rounded like a stored
  image.

The noise and the holes come from a CPU ``torch.Generator`` seeded from
(seed, level) or (seed, step index) and are moved to the device, so one
(spec, seed) gives the same images on the card and on the CPU; it is
another stream than JAX's, so the two packages agree in distribution
there, and in value on the deterministic steps.

CLI: ``python -m blind_image_denoising_torch.evaluate --model
<registry-name-or-artifact-dir> [--device cpu] [--stds 5,25,50 |
--degradations blur:1.5+noise:25,jpeg:50]`` prints a JSON report.
"""

import argparse
import glob
import json
import logging
import os
import sys
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .ops.losses import psnr
from .ops.noise import corrupt_batch_fixed_std
from .ops.ssim import ssim

logger = logging.getLogger("blind_image_denoising_torch")

DEFAULT_STDS = (1, 5, 10, 20, 30, 40, 50, 60, 70, 80)

# the steps parse_degradation_spec accepts: name -> what the value means
DEGRADATION_STEPS = {
    "noise": "additive truncated-normal std (gray levels)",
    "jpeg": "JPEG quality in [1, 100] (Annex-K DCT quantization)",
    "blur": "Gaussian blur sigma (pixels)",
    "posterize": "bit-depth step (round to multiples of q)",
    "holes": "per-pixel dropout rate in [0, 1)",
}


def noise_sweep(
        denoiser: Callable[[np.ndarray], np.ndarray],
        images: np.ndarray,
        stds: Sequence[float] = DEFAULT_STDS,
        seed: int = 0) -> List[Dict]:
    """images: [N, H, W, C] float32 in [0, 255]. Returns one record per
    std with MAE/PSNR/SSIM of noisy and denoised vs clean."""
    images = np.asarray(images, np.float32)
    clean_t = torch.from_numpy(images)
    records = []
    for i, std in enumerate(stds):
        if std > 0:
            gen = torch.Generator().manual_seed(seed * 1_000_003 + i)
            noisy = np.clip(corrupt_batch_fixed_std(
                gen, clean_t, std=float(std)).numpy(), 0, 255)
        else:
            noisy = images
        den = np.asarray(denoiser(noisy.astype(np.uint8))).astype(np.float32)
        noisy_t, den_t = torch.from_numpy(noisy), torch.from_numpy(den)
        rec = {
            "noise_std": float(std),
            "mae_noisy": float(np.abs(noisy - images).mean()),
            "mae_denoised": float(np.abs(den - images).mean()),
            "psnr_noisy": float(psnr(clean_t, noisy_t)),
            "psnr_denoised": float(psnr(clean_t, den_t)),
            "ssim_noisy": float(ssim(clean_t, noisy_t).mean()),
            "ssim_denoised": float(ssim(clean_t, den_t).mean()),
        }
        records.append(rec)
        logger.info(
            f"std {std}: mae {rec['mae_noisy']:.2f}->"
            f"{rec['mae_denoised']:.2f} psnr {rec['psnr_noisy']:.1f}->"
            f"{rec['psnr_denoised']:.1f}")
    return records


def parse_degradation_spec(spec: str) -> List:
    """``"blur:1.5+noise:25"`` → ``[("blur", 1.5), ("noise", 25.0)]``.
    Steps apply left to right; unknown names or bad values raise
    ``ValueError``."""
    steps = []
    for part in spec.split("+"):
        part = part.strip()
        if not part:
            raise ValueError(f"empty step in degradation spec [{spec}]")
        name, sep, value = part.partition(":")
        name = name.strip().lower()
        if name not in DEGRADATION_STEPS:
            raise ValueError(
                f"unknown degradation [{name}] in [{spec}]; known: "
                f"{sorted(DEGRADATION_STEPS)}")
        if not sep:
            raise ValueError(f"degradation [{part}] needs a :value "
                             f"({DEGRADATION_STEPS[name]})")
        v = float(value)
        ok = {"noise": 0.0 <= v,
              "jpeg": 1.0 <= v <= 100.0,
              "blur": 0.0 < v,
              "posterize": 1.0 <= v,
              "holes": 0.0 <= v < 1.0}[name]
        if not (ok and np.isfinite(v)):
            raise ValueError(
                f"degradation [{name}:{value}] out of range "
                f"({DEGRADATION_STEPS[name]})")
        steps.append((name, v))
    return steps


def apply_degradations(images: np.ndarray, spec: str, seed: int = 0,
                       device=None) -> np.ndarray:
    """Corrupt [N, H, W, C] float images in [0, 255] with the chain
    ``spec`` on ``device`` (None: the card; ``"cpu"`` to run on the
    CPU). The noise and the holes of step i draw from a CPU generator
    seeded from (``seed``, i) and move to the device, so a (spec, seed)
    gives the same images everywhere. Returns float32 in [0, 255],
    rounded to integers like a stored image."""
    from .inference.export import resolve_device
    from .ops.degradations import (inpaint_dropout, jpeg_artifacts,
                                   quantize_batch, separable_blur_batch)
    from .ops.noise import truncated_normal

    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(images, np.float32)).to(dev)
    n, h, w, _ = x.shape
    for i, (name, value) in enumerate(parse_degradation_spec(spec)):
        gen = torch.Generator().manual_seed(seed * 1_000_003 + i)
        if name == "noise":
            z = truncated_normal(tuple(x.shape), gen)
            x = x + float(value) * z.to(dev)
        elif name == "jpeg":
            x = jpeg_artifacts(x, torch.full((n,), value, device=dev))
        elif name == "blur":
            x = separable_blur_batch(x, torch.full((n,), value, device=dev))
        elif name == "posterize":
            x = quantize_batch(x, value)
        elif name == "holes":
            keep = torch.rand((n, h, w, 1), generator=gen) >= float(value)
            x = inpaint_dropout(None, x, value, keep=keep.to(dev))
    return np.clip(np.round(x.cpu().numpy()), 0, 255).astype(np.float32)


def degradation_sweep(
        denoiser: Callable[[np.ndarray], np.ndarray],
        images: np.ndarray,
        specs: Sequence[str],
        seed: int = 0,
        device=None) -> List[Dict]:
    """Restoration counterpart of ``noise_sweep``: one record per
    corruption chain (``apply_degradations`` on ``device``), with MAE /
    PSNR / SSIM of the corrupted and restored images vs clean."""
    images = np.asarray(images, np.float32)
    clean_t = torch.from_numpy(images)
    records = []
    for spec in specs:
        corrupt = apply_degradations(images, spec, seed=seed, device=device)
        den = np.asarray(
            denoiser(corrupt.astype(np.uint8))).astype(np.float32)
        corrupt_t, den_t = torch.from_numpy(corrupt), torch.from_numpy(den)
        rec = {
            "degradation": spec,
            "mae_corrupt": float(np.abs(corrupt - images).mean()),
            "mae_restored": float(np.abs(den - images).mean()),
            "psnr_corrupt": float(psnr(clean_t, corrupt_t)),
            "psnr_restored": float(psnr(clean_t, den_t)),
            "ssim_corrupt": float(ssim(clean_t, corrupt_t).mean()),
            "ssim_restored": float(ssim(clean_t, den_t).mean()),
        }
        records.append(rec)
        logger.info(
            f"[{spec}]: mae {rec['mae_corrupt']:.2f}->"
            f"{rec['mae_restored']:.2f} psnr {rec['psnr_corrupt']:.1f}->"
            f"{rec['psnr_restored']:.1f}")
    return records


def load_eval_images(directory: Optional[str], size: int = 256,
                     limit: int = 4) -> np.ndarray:
    """The first ``limit`` PNG / JPEG files under ``directory``
    (recursive, sorted), each resized with pad to ``size``²; a directory
    without any falls back to the packaged set, as in JAX."""
    from .data.file_operations import load_image
    if directory:
        files = [f for f in sorted(glob.glob(
            os.path.join(directory, "**", "*.*"), recursive=True))
            if f.lower().endswith((".png", ".jpg", ".jpeg"))][:limit]
        if files:
            imgs = [load_image(f, image_size=(size, size), num_channels=3)
                    for f in files]
            return np.stack(imgs, axis=0).astype(np.float32)
        logger.warning(f"no images in [{directory}]; using packaged set")
    from .images import load_evaluation_images
    return load_evaluation_images(size)[:limit]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="noise-sweep and "
                                     "restoration evaluation")
    parser.add_argument("--model", required=True, type=str,
                        help="registry name or artifact directory")
    parser.add_argument("--device", default=None, type=str,
                        help="torch device; default the card ('cpu' to run "
                             "on the CPU)")
    parser.add_argument("--images", default=None, type=str,
                        help="directory of eval images (default: packaged)")
    parser.add_argument("--size", default=256, type=int)
    parser.add_argument("--limit", default=4, type=int,
                        help="max images to evaluate (default 4)")
    parser.add_argument("--stds", default=None, type=str,
                        help="comma-separated noise stds")
    parser.add_argument("--degradations", default=None, type=str,
                        help="comma-separated corruption chains (e.g. "
                             "'blur:1.5+noise:25,jpeg:50,holes:0.1'); runs "
                             "the restoration sweep instead of the noise "
                             "sweep. Steps: "
                             + ", ".join(sorted(DEGRADATION_STEPS)))
    parser.add_argument("--quant", action="store_true",
                        help="evaluate the artifact's int8 path (needs "
                             "quant.msgpack)")
    parser.add_argument("--tta", nargs="?", const=8, default=0, type=int,
                        choices=(0, 2, 4, 8),
                        help="geometric self-ensemble members: bare flag or "
                             "8 = full dihedral group, 4 = flips, 2 = {id, "
                             "180°}")
    parser.add_argument("--blend", nargs="?", const=True, default=None,
                        help="noise-adaptive input blending: bare flag "
                             "requires the artifact's blend.json, or pass a "
                             "table path; default serves a shipped table")
    parser.add_argument("--no-blend", dest="blend", action="store_false",
                        help="disable blending even if the artifact ships "
                             "blend.json")
    parser.add_argument("--dtype", default=None, type=str,
                        choices=("float32", "bfloat16"),
                        help="serving compute dtype; default the artifact's "
                             "own tpu.compute_dtype (pipeline.json)")
    args = parser.parse_args(argv)
    specs = None
    if args.degradations:
        specs = [s for s in (p.strip()
                             for p in args.degradations.split(",")) if s]
        for spec in specs:
            parse_degradation_spec(spec)     # fail before loading a model

    import blind_image_denoising_torch as bidt
    denoiser = bidt.load_model(args.model, quant=args.quant, tta=args.tta,
                               dtype=args.dtype, blend=args.blend,
                               device=args.device)
    images = load_eval_images(args.images, size=args.size, limit=args.limit)
    logger.info(f"evaluating {len(images)} images at {args.size}^2")
    if specs is not None:
        records = degradation_sweep(denoiser, images, specs,
                                    device=args.device)
    else:
        stds = ([float(s) for s in args.stds.split(",")] if args.stds
                else DEFAULT_STDS)
        records = noise_sweep(denoiser, images, stds=stds)
    print(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
