"""Write the TFLite fixture the port's executor is held on:
``tests/data/tflite_resnet_depthwise_scratch/denoiser_model.tflite``.

It is JAX's ``serialize_tflite`` (``jax2tf`` graph serialization, then
``TFLiteConverter`` with dynamic-range int8 weights) of the packaged
``resnet_depthwise_scratch`` artifact's finest-scale forward, float32
NHWC in [0, 255] → float32. The script needs JAX and TensorFlow and runs
on the CPU (about 10 s):

    python3 write_tflite_fixture.py [--output-directory DIR]

``blind_image_denoising_torch.load_model(DIR)`` serves the directory it
writes through the port's TFLite executor (``inference/tflite.py``).
"""

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARTIFACT = "resnet_depthwise_scratch"
DEFAULT_OUTPUT = ROOT / "tests" / "data" / f"tflite_{ARTIFACT}"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--output-directory", type=Path,
                        default=DEFAULT_OUTPUT)
    args = parser.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT))
    import blind_image_denoising_tpu as bid
    from blind_image_denoising_tpu.inference.export import (
        TFLITE_FILE, serialize_tflite)

    denoiser = bid.load_model(ARTIFACT, dtype="float32", blend=False)
    blob = serialize_tflite(denoiser.model, denoiser.variables)
    args.output_directory.mkdir(parents=True, exist_ok=True)
    path = args.output_directory / TFLITE_FILE
    path.write_bytes(blob)
    print(f"wrote {path} ({len(blob)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
