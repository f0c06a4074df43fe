"""The bf16-from-f32 gap of the seeded ``unet`` artifact of
``chip_smoke.py``'s ``unet_backbone`` phase, in the JAX package and in
the port, both on the CPU: the source of that phase's bf16 bar.

    python unet_bf16_gap.py

Builds the phase's artifact as the phase does (the port's ``build`` CLI,
seed 0: the draws are on the CPU, so the card's build writes the same
bytes), makes the phase's noisy b8 @ 256² batch from its seed, and prints
one JSON line: the mean, p99 and max |bf16 − f32| in gray levels of JAX's
``load_model(dtype="bfloat16")`` against JAX's float32 ``load_model``,
and the same for the port (``device="cpu"``), and the two float32
outputs against each other. A seeded model is far from a trained one:
its heads saturate, so a rounding that moves a feature across a
threshold moves an output across the range.
"""

import json
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent


def gap(a, b):
    d = np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32))
    return dict(mean=float(d.mean()), p99=float(np.percentile(d, 99)),
                max=int(d.max()), equal_share=float((d == 0).mean()))


def main() -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(REPO))
    import blind_image_denoising_tpu as bid
    import blind_image_denoising_torch as bidt
    import chip_smoke
    from blind_image_denoising_torch import build as build_cli

    cfg = chip_smoke.unet_config(bidt)
    _, _, batch = chip_smoke.unet_inputs(cfg["dataset"])
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp)
        (path / "config.json").write_text(json.dumps(cfg, indent=1))
        if build_cli.main(["--pipeline-config", str(path / "config.json"),
                           "--output-directory", str(path / "artifact"),
                           "--device", "cpu"]) != 0:
            return 1
        artifact = path / "artifact"
        (artifact / "pipeline.json").write_text(
            (path / "config.json").read_text())
        out = {}
        f32 = {}
        for name, load in (("jax", lambda **kw: bid.load_model(
                str(artifact), **kw)),
                           ("port", lambda **kw: bidt.load_model(
                               str(artifact), device="cpu", **kw))):
            f32[name] = np.asarray(load(dtype="float32")(batch))
            bf16 = np.asarray(load(dtype="bfloat16")(batch))
            out[name] = gap(bf16, f32[name])
    print(json.dumps({"bf16_vs_f32": out,
                      "f32_port_vs_jax": gap(f32["port"], f32["jax"]),
                      "images": list(batch.shape)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
