"""Export CLI (counterpart of ``blind_image_denoising_tpu/export.py``):

    python -m blind_image_denoising_torch.export \
        --pipeline-config CONFIG.json --checkpoint-directory RUN \
        --output-directory ARTIFACT [--quantize] [--test-model] [--no-ema] \
        [--to-torch-export] [--device cpu]

Writes ``params.msgpack``, ``pipeline.json``, with ``--quantize``
``quant.msgpack`` and with ``--to-torch-export`` the ``torch.export``
program ``denoiser.pt2`` from the run's latest checkpoint (the port's
own or a JAX run's Orbax step; ``inference/export.export_model``), on
the card unless ``--device`` names another torch device.
``--no-stablehlo`` is accepted and is the default; ``--to-stablehlo``
raises and names ``--to-torch-export``, and ``--to-tflite`` raises: no
converter from PyTorch to TFLite is installed.
"""

import argparse
import logging
import os
import sys

from .inference.export import export_model

logger = logging.getLogger("blind_image_denoising_torch")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="export a trained denoiser to a standalone artifact dir")
    parser.add_argument("--pipeline-config", required=True, type=str)
    parser.add_argument("--checkpoint-directory", required=True, type=str)
    parser.add_argument("--output-directory", required=True, type=str)
    parser.add_argument("--to-stablehlo", action="store_true", default=False,
                        help="raises: the port's serving artifact is "
                             "--to-torch-export")
    parser.add_argument("--no-stablehlo", dest="to_stablehlo",
                        action="store_false", help="the default")
    parser.add_argument("--to-torch-export", action="store_true",
                        help="also write the torch.export program "
                             "denoiser.pt2")
    parser.add_argument("--to-tflite", action="store_true",
                        help="raises: no converter from PyTorch to TFLite "
                             "is installed")
    parser.add_argument("--test-model", action="store_true",
                        help="run an inference self-test after export")
    parser.add_argument("--quantize", action="store_true",
                        help="calibrate and ship int8 input scales "
                             "(quant.msgpack)")
    parser.add_argument("--no-ema", dest="use_ema", action="store_false",
                        default=True,
                        help="export the raw last iterate even when the "
                             "checkpoint tracked a weight EMA (train.ema)")
    parser.add_argument("--device", default=None, type=str,
                        help="torch device; default the card ('cpu' to "
                             "export on the CPU)")
    args = parser.parse_args(argv)
    if not os.path.isfile(args.pipeline_config):
        logger.error(f"pipeline config [{args.pipeline_config}] not found")
        return 1
    export_model(
        pipeline_config=args.pipeline_config,
        checkpoint_directory=args.checkpoint_directory,
        output_directory=args.output_directory,
        to_stablehlo=args.to_stablehlo,
        to_tflite=args.to_tflite,
        to_torch_export=args.to_torch_export,
        test_model=args.test_model,
        quantize=args.quantize,
        use_ema=args.use_ema,
        device=args.device)
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
