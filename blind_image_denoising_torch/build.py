"""Build CLI (counterpart of ``blind_image_denoising_tpu/build.py``):

    python -m blind_image_denoising_torch.build \
        --pipeline-config CONFIG.json --output-directory DIR [--device cpu]

Builds the hydra of the config's ``model`` section, initializes it from
seed 0 (``training/train_state.init_params``: glorot-normal kernels, the
port's own draws) and writes ``params.msgpack`` (params, and
``batch_stats`` for BatchNorm models) and ``model_structure.json``, the
tree of param shapes by flax path, as JAX's build writes it. The model
is built on the card unless ``--device`` names another torch device.
``--keras`` raises: JAX writes its Keras archive through jax2tf, and no
converter from PyTorch is installed.
"""

import argparse
import json
import logging
import os
import sys
from pathlib import Path

import torch

from .config import load_config
from .inference.denoiser import resolve_device
from .models.hydra import model_builder
from .training.train_state import init_params
from .weights import flax_from_params, save_msgpack

logger = logging.getLogger("blind_image_denoising_torch")


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return list(tree.shape)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="build a hydra model from a pipeline config")
    parser.add_argument("--pipeline-config", required=True, type=str)
    parser.add_argument("--output-directory", required=True, type=str)
    parser.add_argument("--device", default=None, type=str,
                        help="torch device; default the card ('cpu' to "
                             "build on the CPU)")
    parser.add_argument("--keras", action="store_true",
                        help="raises: no converter from PyTorch to Keras "
                             "is installed")
    args = parser.parse_args(argv)
    if args.keras:
        raise NotImplementedError(
            "the Keras build artifact is not available: JAX writes it "
            "through jax2tf, and no converter from PyTorch is installed "
            "(ai_edge_torch, onnx)")
    if not os.path.isfile(args.pipeline_config):
        logger.error(f"pipeline config [{args.pipeline_config}] not found")
        return 1
    dev = resolve_device(args.device)
    config = load_config(args.pipeline_config)
    out = Path(args.output_directory)
    out.mkdir(parents=True, exist_ok=True)

    hydra = model_builder(config["model"]).hydra
    init_params(hydra, torch.Generator().manual_seed(0))
    variables = flax_from_params(hydra.to(dev))
    save_msgpack(out / "params.msgpack", variables)
    with open(out / "model_structure.json", "w") as f:
        json.dump(_shapes(variables["params"]), f, indent=2)
    n = sum(p.numel() for p in hydra.parameters())
    logger.info(f"built hydra: {n / 1e3:.1f}k params → {out}")
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
