"""The int8-from-f32 gap of an exported artifact in the JAX package and in
the port, both on the CPU: the cross-check for ``chip_smoke.py``'s
``export`` phase, which serves the artifact it exports in int8 on the
card and holds it to PERF.md §2's int8 bar, or, where JAX's own int8
path misses that bar on the same artifact, to JAX's gap + 0.5.

    python tests/export_int8_gap.py DIR

``DIR`` holds what ``python3 chip_smoke.py --keep-export DIR`` keeps: the
exported artifact (``params.msgpack``, ``pipeline.json``,
``quant.msgpack``) and ``batch.npy``, the phase's noisy b8 @ 256² uint8
batch. Prints one JSON line: the mean, p99 and max |int8 − f32| in gray
levels of JAX's ``load_model(quant=True)`` against JAX's float32
``load_model``, and the same for the port (``device="cpu"``).
"""

import json
import sys
from pathlib import Path

import numpy as np


def gap(a, b):
    d = np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32))
    return dict(mean=float(d.mean()), p99=float(np.percentile(d, 99)),
                max=int(d.max()))


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
        int8 = np.asarray(load(quant=True)(batch))
        out[name] = gap(int8, f32)
    print(json.dumps({"int8_vs_f32": out, "images": list(batch.shape)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
