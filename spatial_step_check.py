#!/usr/bin/env python3
"""The spatially sharded train step against the single-process step,
gradient by gradient, on the flagship (``unet_laplacian_v6_tpu`` with the
packaged ``unet_laplacian_v6_tpu_scratch`` weights, its noise through K3,
drop-path and attention dropout on).

Two gloo ranks (this script, ``--rank``) run ``shard_train_step(step,
create_mesh(data=1, spatial=2), spatial=True)`` on the whole batch, once
with the training margin and once with the margin set to the whole crop
(a control with no slab: every rank runs the whole crop and takes its
owned rows' loss share). Rank 0 then runs the single-process step three
times: as is, again (the device's run-to-run spread), and with cuDNN's
deterministic algorithms (the spread between convolution algorithms).
For each run against the first single step the script prints, per
tensor, max |a − b| over b's largest entry, of the gradients the
optimizer gets and of the params after the step (the worst three).

    python3 spatial_step_check.py                         # card, b4 @ 512²
    python3 spatial_step_check.py --device cpu --float64  # b1 @ 256×128

``--float64`` makes every float32 cast of the step float64 (the model,
the losses, the noise), so what remains between the sharded step and the
single step is what the sharding changes beyond rounding.
"""

import argparse
import copy
import json
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

CONFIG, ARTIFACT = "unet_laplacian_v6_tpu", "unet_laplacian_v6_tpu_scratch"


def _float64() -> None:
    """Every float32 cast and default becomes float64."""
    real_float, real_to = torch.Tensor.float, torch.Tensor.to

    def to_float(self, *a, **k):
        return self if self.dtype == torch.float64 else real_float(
            self, *a, **k)

    def to(self, *a, **k):
        a = tuple(torch.float64 if v is torch.float32 else v for v in a)
        if k.get("dtype") is torch.float32:
            k["dtype"] = torch.float64
        return real_to(self, *a, **k)
    torch.Tensor.float, torch.Tensor.to = to_float, to
    torch.set_default_dtype(torch.float64)


def _run(bidt, cfg, params, clean, device, mesh=None):
    """One step: (gradients by name, params after, loss)."""
    from blind_image_denoising_torch.models.hydra import model_builder
    from blind_image_denoising_torch.parallel import shard_train_step
    from blind_image_denoising_torch.training import (
        build_train_step, create_train_state, loss_function_builder,
        optimizer_builder)
    from blind_image_denoising_torch.training import train_step as step_mod
    hydra = model_builder(copy.deepcopy(cfg["model"])).hydra
    tx, _ = optimizer_builder(cfg["train"]["optimizer"])
    state = create_train_state(hydra, tx, seed=0, params=params,
                               device=device)
    ds = cfg["dataset"]
    step = build_train_step(
        hydra, tx, loss_function_builder(cfg["loss"]), hydra.no_outputs,
        additive_noise=ds["additional_noise"],
        multiplicative_noise=ds["multiplicative_noise"],
        use_pallas_noise=True)
    if mesh is not None:
        step = shard_train_step(step, mesh, spatial=True)
    grads, real = [], step_mod.global_norm

    def norm(gs):
        grads.append([g.detach().cpu().clone() for g in gs])
        return real(gs)
    step_mod.global_norm = norm
    try:
        state, metrics = step(state, torch.from_numpy(clean).to(device))
    finally:
        step_mod.global_norm = real
    names = [n for n, _ in state.model.named_parameters()]
    return (dict(zip(names, grads[0])),
            {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
            float(metrics["total_loss"]))


def _rank(args) -> None:
    if args.float64:
        _float64()
    import blind_image_denoising_torch as bidt
    from blind_image_denoising_torch.parallel import (create_mesh,
                                                      multihost, spatial)
    from blind_image_denoising_torch.weights import (load_msgpack,
                                                     params_from_flax)
    device = torch.device(args.device)
    multihost.initialize(f"localhost:{args.port}", 2, args.rank,
                         backend="gloo", device=args.device)
    cfg = copy.deepcopy(bidt.CONFIGS_DICT[CONFIG])
    params = params_from_flax(load_msgpack(
        f"{bidt.models[ARTIFACT]['directory']}/params.msgpack"))
    if args.float64:
        params = {k: v.double() for k, v in params.items()}
    b, h, w = ((4, 512, 512) if device.type == "cuda" else (1, 256, 128))
    clean = np.round(np.random.default_rng(0).uniform(0, 255, (b, h, w, 3)))
    clean = clean.astype(np.float64 if args.float64 else np.float32)
    mesh = create_mesh(data=1, spatial=2)
    out = {"sharded": _run(bidt, cfg, params, clean, device, mesh)}
    real = spatial.training_margin
    spatial.training_margin = lambda config: 2 * h     # no slab
    try:
        out["whole_crop"] = _run(bidt, cfg, params, clean, device, mesh)
    finally:
        spatial.training_margin = real
    multihost.sync("sharded")
    if args.rank == 0:
        out["single"] = _run(bidt, cfg, params, clean, device)
        out["single_again"] = _run(bidt, cfg, params, clean, device)
        if device.type == "cuda":
            torch.backends.cudnn.deterministic = True
            out["single_deterministic"] = _run(bidt, cfg, params, clean,
                                               device)
            torch.backends.cudnn.deterministic = False
        torch.save(out, Path(args.work) / "runs.pt")
    multihost.sync("done")
    multihost.shutdown()


def _worst(a, b, n=3):
    rel = {k: float((a[k] - v).abs().max() / v.abs().max().clamp_min(1e-30))
           for k, v in b.items()}
    return sorted(((v, k) for k, v in rel.items()), reverse=True)[:n]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--float64", action="store_true")
    parser.add_argument("--rank", type=int, default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--work", default=None)
    args = parser.parse_args()
    if args.rank is not None:
        _rank(args)
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device; pass --device cpu", file=sys.stderr)
        return 1
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    work = tempfile.mkdtemp(prefix="bid-spatial-check-")
    argv = [sys.executable, str(Path(__file__).resolve()), "--device",
            args.device, "--port", str(port), "--work", work] + (
        ["--float64"] if args.float64 else [])
    procs = [subprocess.Popen(argv + ["--rank", str(r)]) for r in range(2)]
    try:
        codes = [p.wait(timeout=1800) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(codes):
        print(f"ranks exited {codes}", file=sys.stderr)
        return 1
    runs = torch.load(Path(work) / "runs.pt", weights_only=False)
    ref_g, ref_p, ref_l = runs["single"]
    rows = {}
    for name, (g, p, loss) in runs.items():
        if name != "single":
            rows[name] = dict(loss_rel=abs(loss - ref_l) / abs(ref_l),
                              grads=_worst(g, ref_g),
                              params=_worst(p, ref_p))
    rows["sharded_vs_whole_crop"] = dict(
        grads=_worst(runs["sharded"][0], runs["whole_crop"][0]))
    device = (torch.cuda.get_device_name(0) if args.device == "cuda"
              else "cpu")
    print(json.dumps(dict(device=device, float64=args.float64,
                          against_single=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
