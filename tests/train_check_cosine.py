"""The bf16-against-f32 gradient cosine of the flagship's train step in the
JAX package and in the port, both on the CPU, on exactly the batch of
``chip_smoke.py``'s ``train_check``: the cross-check for that check's
cosine bar (0.99), which the card meets by a small margin.

    python tests/train_check_cosine.py DIR

``DIR`` holds ``train_check.npz`` as ``python3 chip_smoke.py
--dump-train-check DIR`` writes it: the clean b16 @ 128² batch and the
noisy one (the port's plain noise, seeded). The weights are the packaged
flagship ``unet_laplacian_v6_tpu_scratch``; drop-path and dropout are off,
the scale weights 1/3 each, as in ``train_check``. Prints one JSON line:
each package's cosine of its bf16 gradient against its own f32 one, the
port's f32 against JAX's f32, and the five tensors of lowest cosine of
each package.
"""

import copy
import json
import sys
from pathlib import Path

import numpy as np

FLAGSHIP = "unet_laplacian_v6_tpu_scratch"
CONFIG = "unet_laplacian_v6_tpu"


def cosine(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def main(directory: str) -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    import blind_image_denoising_torch as bidt
    from blind_image_denoising_tpu.models.hydra import (
        model_builder as jax_model_builder)
    from blind_image_denoising_tpu.ops.multiscale import (
        multiscale_targets as jax_multiscale_targets)
    from blind_image_denoising_tpu.training import (
        build_train_step as jax_build_train_step,
        loss_function_builder as jax_loss_function_builder,
        optimizer_builder as jax_optimizer_builder)
    from blind_image_denoising_torch.models.hydra import model_builder
    from blind_image_denoising_torch.ops.multiscale import multiscale_targets
    from blind_image_denoising_torch.training import (forward_loss,
                                                      loss_function_builder)
    from blind_image_denoising_torch.weights import (load_msgpack,
                                                     params_from_flax)

    data = np.load(Path(directory) / "train_check.npz")
    clean, noisy = data["clean"], data["noisy"]
    cfg = copy.deepcopy(bidt.CONFIGS_DICT[CONFIG])
    mc = copy.deepcopy(cfg["model"])
    mc["backbone"].update(depth_drop_rate=0.0,
                          convolutional_self_attention_dropout_rate=0.0)
    tree = load_msgpack(Path(bidt.models[FLAGSHIP]["directory"])
                        / "params.msgpack")
    dw = np.full((3,), 1.0 / 3, np.float32)

    def jax_grads(dtype):
        hydra = jax_model_builder(mc, dtype=dtype).hydra
        tx, _ = jax_optimizer_builder(cfg["train"]["optimizer"])
        step = jax_build_train_step(
            hydra, tx, jax_loss_function_builder(cfg["loss"]), 3)
        cells = dict(zip(step.__code__.co_freevars,
                         (c.cell_contents for c in step.__closure__)))
        gt = jax_multiscale_targets(jnp.asarray(clean), 2, clip_values=True,
                                    round_values=True)
        grads, _ = jax.jit(cells["grad_fn"])(
            tree["params"], {}, jnp.asarray(noisy), gt, jnp.asarray(dw),
            jax.random.PRNGKey(1))
        flat = params_from_flax(jax.tree_util.tree_map(np.asarray, grads))
        return {k: v.double().numpy().ravel() for k, v in flat.items()}

    def port_grads(dtype):
        hydra = model_builder(copy.deepcopy(mc), dtype=dtype).hydra
        hydra.load_state_dict(params_from_flax(tree))
        gt = multiscale_targets(torch.from_numpy(clean), 2, clip_values=True,
                                round_values=True)
        total, _ = forward_loss(hydra, loss_function_builder(cfg["loss"]), 3,
                                torch.from_numpy(noisy), gt,
                                torch.from_numpy(dw),
                                torch.Generator().manual_seed(0))
        total.backward()
        return {n: p.grad.double().numpy().ravel()
                for n, p in hydra.named_parameters()}

    grads = {("jax", "bf16"): jax_grads(jnp.bfloat16),
             ("jax", "f32"): jax_grads(jnp.float32),
             ("port", "bf16"): port_grads(torch.bfloat16),
             ("port", "f32"): port_grads(None)}
    names = sorted(grads[("port", "f32")])

    def whole(key):
        return np.concatenate([grads[key][n] for n in names])

    out = {"batch": list(noisy.shape)}
    for pkg in ("jax", "port"):
        out[f"{pkg}_bf16_vs_f32"] = cosine(whole((pkg, "bf16")),
                                           whole((pkg, "f32")))
        per = sorted((cosine(grads[(pkg, "bf16")][n],
                             grads[(pkg, "f32")][n]), n) for n in names)
        out[f"{pkg}_lowest_tensors"] = [dict(name=n, cosine=c)
                                        for c, n in per[:5]]
    out["port_f32_vs_jax_f32"] = cosine(whole(("port", "f32")),
                                        whole(("jax", "f32")))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
