"""Noise-sweep quality evaluation (counterpart of
``blind_image_denoising_tpu/evaluate.py``): corrupt evaluation images
with additive ±2σ truncated-normal noise over a std sweep, denoise, and
report MAE / PSNR / SSIM of the noisy and the denoised images against
the clean ones, per std. Works with any denoiser callable (uint8 batch
in, batch out).

The noise comes from a CPU ``torch.Generator`` seeded from (seed, level),
another stream than JAX's, so the two packages' sweeps agree in
distribution, not in values. The restoration sweep over degradation
chains (``--degradations``) needs ``ops/degradations.py`` and raises
until it is ported.

CLI: ``python -m blind_image_denoising_torch.evaluate --model
<registry-name-or-artifact-dir> [--device cpu] [--stds 5,25,50]``
prints a JSON report.
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
_NOT_PORTED_DEGRADATIONS = ("degradation chains need ops/degradations.py, "
                            "which is not ported yet (ROADMAP Queue 1 item "
                            "11)")


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
    raise NotImplementedError(_NOT_PORTED_DEGRADATIONS)


def apply_degradations(images: np.ndarray, spec: str,
                       seed: int = 0) -> np.ndarray:
    raise NotImplementedError(_NOT_PORTED_DEGRADATIONS)


def degradation_sweep(denoiser: Callable, images: np.ndarray,
                      specs: Sequence[str], seed: int = 0) -> List[Dict]:
    raise NotImplementedError(_NOT_PORTED_DEGRADATIONS)


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
    parser = argparse.ArgumentParser(description="noise-sweep evaluation")
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
                        help="comma-separated corruption chains (not ported "
                             "yet: raises)")
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
    if args.degradations:
        raise NotImplementedError(_NOT_PORTED_DEGRADATIONS)

    import blind_image_denoising_torch as bidt
    denoiser = bidt.load_model(args.model, quant=args.quant, tta=args.tta,
                               dtype=args.dtype, blend=args.blend,
                               device=args.device)
    images = load_eval_images(args.images, size=args.size, limit=args.limit)
    logger.info(f"evaluating {len(images)} images at {args.size}^2")
    stds = ([float(s) for s in args.stds.split(",")] if args.stds
            else DEFAULT_STDS)
    print(json.dumps(noise_sweep(denoiser, images, stds=stds), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
