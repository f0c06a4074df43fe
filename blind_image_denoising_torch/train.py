"""Training CLI (counterpart of ``blind_image_denoising_tpu/train.py``):

    python -m blind_image_denoising_torch.train \
        --pipeline-config CONFIG.json --checkpoint-directory DIR \
        [--weights-directory ARTIFACT_OR_CHECKPOINT_DIR] [--total-steps N] \
        [--device cpu]

Trains on the card unless ``--device`` names another torch device. The
JAX CLI's multi-host flags raise: several processes are ROADMAP Queue 1
item 13.
"""

import argparse
import logging
import os
import sys

from .training.train_loop import train_loop

logger = logging.getLogger("blind_image_denoising_torch")

_MULTI_HOST = ("coordinator_address", "num_processes", "process_id",
               "local_device_count")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="train a blind image denoiser")
    parser.add_argument("--pipeline-config", required=True, type=str,
                        help="pipeline configuration path (JSON)")
    parser.add_argument("--checkpoint-directory", required=True, type=str,
                        help="directory to save checkpoints / metrics into")
    parser.add_argument("--weights-directory", default=None, type=str,
                        help="artifact directory (params.msgpack) or "
                             "checkpoint directory to fine-tune from")
    parser.add_argument("--total-steps", default=None, type=int,
                        help="override train.total_steps (stop after N "
                             "applied steps)")
    parser.add_argument("--device", default=None, type=str,
                        help="torch device; default the card ('cpu' to "
                             "train on the CPU)")
    for flag in _MULTI_HOST:
        parser.add_argument("--" + flag.replace("_", "-"), default=None,
                            help="multi-host training: not ported (ROADMAP "
                                 "Queue 1 item 13)")
    args = parser.parse_args(argv)
    given = [f for f in _MULTI_HOST if getattr(args, f) is not None]
    if given:
        raise NotImplementedError(
            f"multi-host training ({', '.join(given)}) is not ported yet "
            f"(ROADMAP Queue 1 item 13)")
    if not os.path.isfile(args.pipeline_config):
        logger.error(f"pipeline config [{args.pipeline_config}] not found")
        return 1
    train_loop(pipeline_config=args.pipeline_config,
               checkpoint_directory=args.checkpoint_directory,
               weights_directory=args.weights_directory,
               total_steps_override=args.total_steps, device=args.device)
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
