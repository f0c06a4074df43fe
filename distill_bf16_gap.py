"""The bf16-from-f32 gaps behind ``chip_smoke.py``'s ``distillation``
phase bars, in the JAX package and in the port, both on the CPU.

    python distill_bf16_gap.py [DIR]

1. The flagship as a bf16 teacher (``build_teacher({"teacher": FLAGSHIP,
   "dtype": "bfloat16"})``: every floating parameter cast to bf16)
   against the float32 flagship applied to the same batch, the phase's
   noisy b16 @ 128² (``chip_smoke.teacher_inputs``); both outputs
   rounded and clipped to gray levels.
2. With ``DIR`` (what ``python3 chip_smoke.py --keep-distill DIR``
   keeps: the distilled run's exported artifact and ``batch.npy``, the
   phase's noisy b8 @ 256² uint8 batch): ``load_model(dtype=
   "bfloat16")`` against the float32 ``load_model`` of that artifact.

Prints one JSON line: for each, the mean, p99 and max |bf16 − f32| in
gray levels in JAX and in the port.
"""

import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent


def gap(a, b):
    d = np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32))
    return dict(mean=float(d.mean()), p99=float(np.percentile(d, 99)),
                max=int(d.max()))


def gray(y):
    return np.clip(np.round(np.asarray(y, np.float32)), 0, 255).astype(
        np.uint8)


def main(argv) -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(REPO))
    import jax.numpy as jnp
    import torch
    import blind_image_denoising_tpu as bid
    import blind_image_denoising_torch as bidt
    import chip_smoke
    from blind_image_denoising_tpu.training import distill as jdistill
    from blind_image_denoising_torch.ops.resize import nchw, nhwc
    from blind_image_denoising_torch.training import distill

    _, batch = chip_smoke.teacher_inputs()
    spec = {"teacher": chip_smoke.FLAGSHIP, "dtype": "bfloat16"}
    out = {"teacher": {}}
    jfn, _ = jdistill.build_teacher(spec)
    jden = bid.load_model(chip_smoke.FLAGSHIP, dtype="float32")
    jref = jden.model.apply(jden.variables, jnp.asarray(batch),
                            train=False)[0]
    out["teacher"]["jax"] = gap(gray(jfn(jnp.asarray(batch))), gray(jref))
    fn, _ = distill.build_teacher(spec, device="cpu")
    model = bidt.load_model(chip_smoke.FLAGSHIP, device="cpu",
                            dtype="float32").model
    with torch.no_grad():
        ref = nhwc(model(nchw(torch.from_numpy(batch)).contiguous())[0])
        got = fn(torch.from_numpy(batch))
    out["teacher"]["port"] = gap(gray(got.numpy()), gray(ref.float().numpy()))
    if argv:
        path = Path(argv[0])
        served = np.load(path / "batch.npy")
        out["distilled"] = {}
        for name, load in (("jax", lambda **kw: bid.load_model(str(path),
                                                               **kw)),
                           ("port", lambda **kw: bidt.load_model(
                               str(path), device="cpu", **kw))):
            out["distilled"][name] = gap(
                np.asarray(load(dtype="bfloat16")(served)),
                np.asarray(load(dtype="float32")(served)))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
