"""Training CLI (counterpart of ``blind_image_denoising_tpu/train.py``):

    python -m blind_image_denoising_torch.train \
        --pipeline-config CONFIG.json --checkpoint-directory DIR \
        [--weights-directory ARTIFACT_OR_CHECKPOINT_DIR] [--total-steps N] \
        [--device cpu]

Trains on the card unless ``--device`` names another torch device.
Several processes, one command per rank (``parallel/multihost.py``):

    python -m blind_image_denoising_torch.train ... \
        --coordinator-address localhost:29500 --num-processes 2 \
        --process-id $RANK [--device cpu] [--backend gloo]

``dataset.batch_size`` is then the global batch. ``--backend`` defaults
to NCCL on the card and gloo on the CPU; two ranks on one card need
``--backend gloo``.
"""

import argparse
import logging
import os
import sys

from .training.train_loop import train_loop

logger = logging.getLogger("blind_image_denoising_torch")


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
    # several processes (one per device; parallel/multihost.py):
    #   python -m …train --coordinator-address host0:1234 \
    #       --num-processes 4 --process-id $RANK …
    parser.add_argument("--coordinator-address", default=None, type=str,
                        help="host:port of process 0 — enables multi-host "
                             "training")
    parser.add_argument("--num-processes", default=None, type=int,
                        help="total number of processes in the multi-host "
                             "job")
    parser.add_argument("--process-id", default=None, type=int,
                        help="this process's rank in [0, num_processes)")
    parser.add_argument("--local-device-count", default=None, type=int,
                        help="devices per process: the port runs one")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="torch.distributed backend (default: nccl on "
                             "the card, gloo on the CPU; gloo puts several "
                             "ranks on one card)")
    args = parser.parse_args(argv)

    multi = args.coordinator_address is not None
    if multi:
        if args.num_processes is None or args.process_id is None:
            logger.error("--coordinator-address requires --num-processes "
                         "and --process-id")
            return 1
        from .parallel.multihost import initialize
        initialize(args.coordinator_address, args.num_processes,
                   args.process_id,
                   local_device_count=args.local_device_count,
                   backend=args.backend, device=args.device)

    if not os.path.isfile(args.pipeline_config):
        logger.error(f"pipeline config [{args.pipeline_config}] not found")
        return 1

    train_loop(pipeline_config=args.pipeline_config,
               checkpoint_directory=args.checkpoint_directory,
               weights_directory=args.weights_directory,
               total_steps_override=args.total_steps, device=args.device)

    if multi:
        # align the ranks before leaving the process group: the primary's
        # teardown (metrics, TensorBoard) is slower than the others'
        from .parallel.multihost import shutdown, sync
        sync("train_done")
        shutdown()
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
