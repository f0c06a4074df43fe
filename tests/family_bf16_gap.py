"""The bf16-from-f32 gap of an exported ``unet_laplacian_v4`` artifact in
the JAX package and in the port, both on the CPU: the cross-check for
``chip_smoke.py``'s ``unet_laplacian_family`` phase, which serves the v4
run it trains (4 steps from a seeded init) in bf16 on the card and holds
it to PERF.md §2's bf16 bar against the same artifact in f32 on the CPU.

    python tests/family_bf16_gap.py DIR

``DIR`` holds what ``python3 chip_smoke.py --keep-family DIR`` keeps: the
exported artifact (``params.msgpack``, ``pipeline.json``) and
``batch.npy``, the phase's noisy b8 @ 256² uint8 batch. Prints one JSON
line: the mean, p99 and max |bf16 − f32| in gray levels of JAX's
``load_model(dtype="bfloat16")`` against JAX's float32 ``load_model``,
and the share of outputs more than 3 gray levels apart (the p99 bar
fails at 1%), and the same for the port (``device="cpu"``).
"""

import json
import sys
from pathlib import Path

import numpy as np


def gap(a, b):
    d = np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32))
    return dict(mean=float(d.mean()), p99=float(np.percentile(d, 99)),
                max=int(d.max()), share_over_3=float((d > 3).mean()))


def main(directory: str) -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import blind_image_denoising_tpu as bid
    import blind_image_denoising_torch as bidt
    path = Path(directory)
    batch = np.load(path / "batch.npy")
    out = {}
    for name, load in (("jax", lambda **kw: bid.load_model(str(path), **kw)),
                       ("port", lambda **kw: bidt.load_model(
                           str(path), device="cpu", **kw))):
        f32 = np.asarray(load(dtype="float32")(batch))
        bf16 = np.asarray(load(dtype="bfloat16")(batch))
        out[name] = gap(bf16, f32)
    print(json.dumps({"bf16_vs_f32": out, "images": list(batch.shape)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
