"""Interpretability CLI (counterpart of
``blind_image_denoising_tpu/analyze.py``): adaptive-filter masks, the
net-bias map and scale equivariance of a denoiser.

``python -m blind_image_denoising_torch.analyze
        --model <registry-name-or-artifact-dir>
        [--image PATH] [--size 128] [--noise-std 25]
        [--pixels "y,x;y,x" | --grid 2] [--channel N]
        [--output-dir DIR] [--device cpu]``
prints a JSON report (``net_bias``, ``scale_equivariance``,
``filters``, ``model``, ``noise_std``); with ``--output-dir`` it also
writes ``filters.png`` and ``bias_map.png`` where matplotlib imports.
Runs on the card unless ``--device`` names another torch device. The
noise is drawn on the host from a generator seeded ``--seed``, so the
card and the CPU analyze the same input.
"""

import argparse
import json
import logging
import os
import sys

import numpy as np
import torch

logger = logging.getLogger("blind_image_denoising_torch")


def _parse_pixels(spec: str):
    pixels = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        r, c = part.split(",")
        pixels.append((int(r), int(c)))
    if not pixels:
        raise ValueError(f"no pixels in spec [{spec}]")
    return pixels


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="bias-free interpretability analysis")
    parser.add_argument("--model", required=True, type=str,
                        help="registry name or artifact directory "
                             "(params.msgpack artifacts)")
    parser.add_argument("--device", default=None, type=str,
                        help="torch device; default the card ('cpu' to run "
                             "on the CPU)")
    parser.add_argument("--image", default=None, type=str,
                        help="image file to analyze (default: first "
                             "packaged eval image)")
    parser.add_argument("--size", default=128, type=int,
                        help="analysis resolution (center-resized)")
    parser.add_argument("--noise-std", default=25.0, type=float,
                        help="corrupt the input at this std before "
                             "analysis (0 = clean input)")
    parser.add_argument("--pixels", default=None, type=str,
                        help="probe pixels 'row,col;row,col;…' "
                             "(default: --grid)")
    parser.add_argument("--grid", default=2, type=int,
                        help="n×n default probe-pixel grid (default 2)")
    parser.add_argument("--channel", default=None, type=int,
                        help="analyze this output channel "
                             "(default: channel mean)")
    parser.add_argument("--alphas", default="0.25,0.5,0.75", type=str,
                        help="scale-equivariance test factors")
    parser.add_argument("--mass-radius", default=8, type=int,
                        help="window radius for the filter-mass metric")
    parser.add_argument("--window", default=33, type=int,
                        help="zoom window for the filter figure")
    parser.add_argument("--output-dir", default=None, type=str,
                        help="write filters.png / bias_map.png here")
    parser.add_argument("--seed", default=0, type=int)
    args = parser.parse_args(argv)

    import blind_image_denoising_torch as bidt
    from . import analysis

    denoiser = bidt.load_model(args.model, device=args.device)

    if args.image:
        from .data.file_operations import load_image
        image = np.asarray(load_image(
            args.image, image_size=(args.size, args.size),
            num_channels=3), np.float32)
    else:
        from .images import load_evaluation_images
        image = load_evaluation_images(args.size)[0].astype(np.float32)

    if args.noise_std > 0:
        from .ops.noise import corrupt_batch_fixed_std
        noisy = corrupt_batch_fixed_std(
            torch.Generator().manual_seed(args.seed),
            torch.from_numpy(image[None]), std=float(args.noise_std))
        image = np.clip(noisy[0].numpy(), 0, 255)

    pixels = (_parse_pixels(args.pixels) if args.pixels
              else analysis.grid_pixels(image.shape[:2], n=args.grid))
    alphas = [float(a) for a in args.alphas.split(",") if a.strip()]

    report, res, denoised, bias_map = analysis.analyze(
        denoiser, image, pixels=pixels, channel=args.channel,
        alphas=alphas, mass_radius=args.mass_radius)
    report["model"] = args.model
    report["noise_std"] = float(args.noise_std)

    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
        fig = analysis.filter_figure(image, res, window=args.window,
                                     mass_radius=args.mass_radius)
        if fig is not None:
            fig.savefig(os.path.join(args.output_dir, "filters.png"),
                        dpi=130)
        fig = analysis.bias_map_figure(image, denoised, bias_map)
        if fig is not None:
            fig.savefig(os.path.join(args.output_dir, "bias_map.png"),
                        dpi=130)
        logger.info(f"figures written to [{args.output_dir}]")

    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
