"""Where a bf16 forward of a ``unet_laplacian`` artifact parts from its
float32 forward, stage by stage, in the JAX package and in the port, both
on the CPU: the follow-up of ``tests/family_bf16_gap.py``, whose whole
forward shows the port's bf16 output a little further from float32 than
JAX's.

    python family_bf16_stages.py DIR [N]

``DIR`` holds an artifact (``params.msgpack``, ``pipeline.json``) and
``batch.npy`` (uint8 [B, H, W, 3], as ``chip_smoke.py --keep-family DIR``
keeps them); the first ``N`` images (default 2) go through the bare
hydra in bfloat16 and in float32. JAX's stages are its modules' outputs
(``capture_intermediates``, jitted), the port's the same modules' through
forward hooks. Prints one JSON line per stage, in the forward's order:
the relative L2 distance of the bf16 output from the f32 output in JAX
and in the port, and their ratio; then the heads' outputs in gray
levels. A stage where the port's distance jumps and JAX's does not is
where the port rounds to bf16 and JAX's fused program does not.
"""

import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def jax_stages(cfg, variables, x, dtype):
    import jax
    import jax.numpy as jnp
    from blind_image_denoising_tpu.models.hydra import model_builder
    hydra = model_builder(cfg, dtype=dtype).hydra

    @jax.jit
    def run(v, x):
        return hydra.apply(v, x, train=False, capture_intermediates=True,
                           mutable=["intermediates"])

    outs, state = run(variables, jnp.asarray(x))
    stages = {}

    def walk(node, path):
        for k, v in node.items():
            if k == "__call__":
                out = v[0]
                if hasattr(out, "ndim") and out.ndim == 4:
                    stages[path] = np.asarray(out, np.float32)
            elif isinstance(v, dict):
                walk(v, f"{path}.{k}" if path else k)

    walk(jax.tree_util.tree_map(lambda a: a, state["intermediates"]), "")
    return stages, [np.asarray(o, np.float32) for o in outs]


def port_stages(cfg, params, x, dtype):
    import torch
    from blind_image_denoising_torch.models.hydra import model_builder
    hydra = model_builder(cfg, dtype=dtype).hydra
    hydra.load_state_dict(params, strict=True)
    hydra.eval()
    stages = {}

    def hook(name):
        def save(_, __, out):
            if isinstance(out, torch.Tensor) and out.ndim == 4:
                stages[name] = out.detach().float().permute(
                    0, 2, 3, 1).numpy()
        return save

    for name, module in hydra.named_modules():
        if name.count(".") <= 1 and name:
            module.register_forward_hook(hook(name))
    with torch.no_grad():
        outs = hydra(torch.from_numpy(x).permute(0, 3, 1, 2))
    return stages, [o.permute(0, 2, 3, 1).float().numpy() for o in outs]


def main(directory: str, n: int = 2) -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(REPO))
    import jax.numpy as jnp
    import torch
    from flax import serialization
    from blind_image_denoising_torch.weights import params_from_flax

    path = Path(directory)
    cfg = json.loads((path / "pipeline.json").read_text())["model"]
    variables = serialization.msgpack_restore(
        (path / "params.msgpack").read_bytes())
    x = np.load(path / "batch.npy")[:n].astype(np.float32)
    params = params_from_flax(variables)
    runs = {}
    for name, dtype_j, dtype_t in (("f32", None, None),
                                   ("bf16", jnp.bfloat16, torch.bfloat16)):
        runs[name] = (jax_stages(cfg, variables, x, dtype_j),
                      port_stages(cfg, params, x, dtype_t))
    (j32, jo32), (p32, po32) = runs["f32"]
    (j16, jo16), (p16, po16) = runs["bf16"]
    for stage in p32:
        if stage not in j32 or stage not in p16 or stage not in j16:
            continue
        dj, dp = rel(j16[stage], j32[stage]), rel(p16[stage], p32[stage])
        print(json.dumps(dict(stage=stage, jax=dj, port=dp,
                              port_over_jax=dp / max(dj, 1e-30))))
    for i, (a, b, c, d) in enumerate(zip(jo16, jo32, po16, po32)):
        print(json.dumps(dict(head=i, jax_gray_mean=float(
            np.abs(a - b).mean()), port_gray_mean=float(np.abs(c - d).mean()),
            jax_rel=rel(a, b), port_rel=rel(c, d))))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], *(int(a) for a in sys.argv[2:3])))
