"""Rank programs for ``tests/test_torch_parallel.py`` (and the card
cohort of ``tests/test_torch_cuda.py``): each runs in a process of its
own, started with the ``spawn`` method, joined to a gloo process group,
and writes what it computed under its output directory for the parent
test to compare. The module imports the port and torch only, so a rank
starts without JAX.

``run_cohort(n, target, out, timeout, **kwargs)`` starts ``n`` ranks of
``target`` (a function of this module named by string), waits at most
``timeout`` seconds for all of them, kills the rest on a timeout or a
failure, and raises with each failed rank's traceback."""

import copy
import hashlib
import multiprocessing
import os
import socket
import time
import traceback
from pathlib import Path

import numpy as np
import torch

RANK_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, n, port, target, out, device, join):
    torch.set_num_threads(1)
    from blind_image_denoising_torch.parallel import multihost
    kwargs = load_result(Path(out, "kwargs.pt"))
    try:
        if join:
            multihost.initialize(f"localhost:{port}", n, rank,
                                 device=device, backend="gloo",
                                 initialization_timeout=120,
                                 heartbeat_timeout_seconds=120)
        globals()[target](rank, n, Path(out), device=device, **kwargs)
        multihost.sync("done")
    except BaseException:
        Path(out, f"error_{rank}.txt").write_text(traceback.format_exc())
        raise
    finally:
        multihost.shutdown()


def run_cohort(n: int, target: str, out, timeout: float = 120.0,
               device: str = "cpu", join: bool = True, **kwargs) -> None:
    """Run ``n`` gloo ranks of ``target(rank, n, out, device=device,
    **kwargs)`` on ``device``; ``join=False``: the target joins the
    process group itself."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    # the arguments go through a file: a large pickle through the start
    # pipe holds each start until that child has imported torch
    torch.save(kwargs, out / "kwargs.pt")
    saved = {k: os.environ.pop(k) for k in RANK_ENV if k in os.environ}
    procs = [ctx.Process(target=_entry, daemon=True,
                         args=(r, n, port, target, str(out), device, join))
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        os.environ.update(saved)
    errors = [f"rank {r}: " + (Path(out, f"error_{r}.txt").read_text()
                               if Path(out, f"error_{r}.txt").exists()
                               else f"exit code {p.exitcode}")
              for r, p in enumerate(procs) if p.exitcode != 0]
    if errors:
        raise AssertionError("\n".join(errors))


def load_result(path):
    """A rank's result file (written by this module's ranks)."""
    return torch.load(path, weights_only=False)


# ---------------------------------------------------------------- steps

def build_step(model_config, loss_config, optimizer_config, params,
               device="cpu", **step_kw):
    """(state, train_step) of the port on ``params`` (a state dict)."""
    from blind_image_denoising_torch.models.hydra import model_builder
    from blind_image_denoising_torch.training import (
        build_train_step, create_train_state, loss_function_builder,
        optimizer_builder)
    hydra = model_builder(copy.deepcopy(model_config)).hydra
    tx, _ = optimizer_builder(optimizer_config)
    state = create_train_state(hydra, tx, params=params, device=device)
    step = build_train_step(hydra, tx, loss_function_builder(loss_config),
                            hydra.no_outputs, **step_kw)
    return state, step


class Recorder:
    """Within the block, keeps every noisy batch the step's forward sees
    and every output of the noise kernel's wrapper (CPU copies)."""

    def __init__(self):
        from blind_image_denoising_torch.training import train_step
        self.module = train_step
        self.noisy, self.k3 = [], []

    def __enter__(self):
        mod = self.module
        self._saved = (mod.forward_loss, mod.corrupt_noise)
        real_loss, real_noise = self._saved

        def forward_loss(model, fns, no, noisy, *a, **k):
            self.noisy.append(noisy.detach().cpu().clone())
            return real_loss(model, fns, no, noisy, *a, **k)

        def corrupt_noise(*a, **k):
            y = real_noise(*a, **k)
            self.k3.append(y.detach().cpu().clone())
            return y
        mod.forward_loss, mod.corrupt_noise = forward_loss, corrupt_noise
        return self

    def __exit__(self, *exc):
        self.module.forward_loss, self.module.corrupt_noise = self._saved


def step_result(state, metrics, recorder):
    return dict(
        params={k: v.detach().cpu().clone()
                for k, v in state.model.state_dict().items()},
        metrics={k: float(v) for k, v in metrics.items()
                 if isinstance(v, torch.Tensor) and v.ndim == 0},
        noisy=recorder.noisy, k3=recorder.k3)


def run_steps(cases, batch, mesh=None, device="cpu", spatial=False):
    """Each case (model, loss, optimizer, params, step kwargs, micro
    batches, and optionally its own global ``batch``) for one step on
    ``batch`` (numpy, the global batch): under ``mesh`` on this rank's
    rows through ``shard_train_step(spatial=spatial)``, else on the whole
    batch. Returns one ``step_result`` a case."""
    from blind_image_denoising_torch.parallel import (shard_batch,
                                                      shard_train_step)
    results = []
    for case in cases:
        state, step = build_step(case["model"], case["loss"],
                                 case["optimizer"], case["params"], device,
                                 **case.get("step", {}))
        accum = case.get("step", {}).get("grad_accum", 1)
        data = case.get("batch", batch)
        if mesh is not None:
            step = shard_train_step(step, mesh, spatial=spatial)
            local = shard_batch(mesh, data, micro_batches=accum,
                                device=device)
        else:
            local = torch.from_numpy(np.ascontiguousarray(data)).to(device)
        with Recorder() as rec:
            state, metrics = step(state, local)
        results.append(step_result(state, metrics, rec))
    return results


def dp_steps(rank, n, out, cases, batch, mesh_kw, device="cpu",
             spatial=False):
    from blind_image_denoising_torch.parallel import create_mesh
    mesh = create_mesh(**mesh_kw)
    torch.save(dict(results=run_steps(cases, batch, mesh, device, spatial),
                    coords=mesh.coords, shape=mesh.shape),
               out / f"rank{rank}.pt")


def spatial_steps(rank, n, out, cases, mesh_kw, device="cpu"):
    """Each case (its own global ``batch``) through
    ``shard_train_step(spatial=True)`` on the mesh, and the
    single-process step of the cases ``c`` with ``c % n == rank``, so
    the ranks share the references."""
    from blind_image_denoising_torch.parallel import create_mesh
    mesh = create_mesh(**mesh_kw)
    sharded = run_steps(cases, None, mesh, device, spatial=True)
    single = {c: run_steps([case], None, None, device)[0]
              for c, case in enumerate(cases) if c % n == rank}
    torch.save(dict(results=sharded, single=single, coords=mesh.coords,
                    shape=mesh.shape), out / f"rank{rank}.pt")


# ---------------------------------------------------------------- spatial

def _tiny_cnn(w, x):
    """JAX's two-ConvBlock test model (3×3 SAME, no bias; relu, then
    linear) on NHWC, the kernels in the port's OIHW layout."""
    import torch.nn.functional as F
    y = F.relu(F.conv2d(x.permute(0, 3, 1, 2), w["c1"], padding=1))
    return F.conv2d(y, w["c2"], padding=1).permute(0, 2, 3, 1)


def spatial_cases(rank, n, out, conv, unet, spatial, flagship=None,
                  device="cpu"):
    """Spatially sharded forwards over a (n / spatial) × spatial mesh,
    gathered: JAX's tiny CNN (``conv``) and a hydra (``unet``: model
    config, state dict, image, margin; ``flagship`` the same) in eval
    mode; the ``margin > local_h`` error on ``unet["small_image"]``;
    ``Denoiser(mesh=…)`` on the hydra's image (float output, no
    padding), and through it, when ``unet`` has them, the input gradient
    of ``sum(y · weight)`` (``unet["weight"]``) and the tangent of
    ``unet["tangent"]``."""
    from blind_image_denoising_torch.inference.denoiser import Denoiser
    from blind_image_denoising_torch.models.hydra import model_builder
    from blind_image_denoising_torch.ops.resize import nchw, nhwc
    from blind_image_denoising_torch.parallel import (
        create_mesh, denoise_spatially_sharded, spatial_shard_image)
    from blind_image_denoising_torch.parallel.spatial import gather_spatial
    mesh = create_mesh(data=n // spatial, spatial=spatial)

    def run(fn, image):
        with torch.no_grad():
            return gather_spatial(mesh, fn(spatial_shard_image(
                mesh, torch.from_numpy(image).to(device)))).cpu()
    result = dict(coords=mesh.coords)
    weights = {k: v.to(device) for k, v in conv["weights"].items()}
    result["conv"] = run(denoise_spatially_sharded(
        _tiny_cnn, weights, mesh, conv["margin"]), conv["image"])
    hydra = model_builder(copy.deepcopy(unet["model_config"])).hydra
    hydra.load_state_dict(unet["params"])
    hydra.to(device).eval()
    fwd = denoise_spatially_sharded(
        lambda v, x: nhwc(hydra(nchw(x))[0]).float(), None, mesh,
        unet["margin"])
    result["unet"] = run(fwd, unet["image"])
    result["error"] = None
    try:
        run(fwd, unet["small_image"])
    except ValueError as e:
        result["error"] = str(e)
    den = Denoiser(hydra, mesh=mesh, spatial_margin=unet["margin"],
                   cast_to_uint8=False, pad_multiple=1, device=device)
    result["served"] = den(unet["image"])
    if "weight" in unet:
        x = torch.from_numpy(unet["image"]).to(device).requires_grad_(True)
        (den.float_forward(x) * torch.from_numpy(unet["weight"]).to(device)
         ).sum().backward()
        result["gradient"] = x.grad.cpu()
        import torch.autograd.forward_ad as fwad
        with fwad.dual_level():
            dual = fwad.make_dual(
                torch.from_numpy(unet["image"]).to(device),
                torch.from_numpy(unet["tangent"]).to(device))
            result["tangent"] = fwad.unpack_dual(
                den.float_forward(dual)).tangent.cpu()
    if flagship is not None:
        big = model_builder(copy.deepcopy(flagship["model_config"])).hydra
        big.load_state_dict(flagship["params"])
        big.to(device).eval()
        result["flagship"] = run(denoise_spatially_sharded(
            lambda v, x: nhwc(big(nchw(x))[0]).float(), None, mesh,
            flagship["margin"]), flagship["image"])
    torch.save(result, out / f"rank{rank}.pt")


# ---------------------------------------------------------------- loop

class LoopProbe:
    """Within the block, keeps what this rank's training loops do: every
    loop's final state dict, each restored state, the checkpoint writes
    (step, wrote), whether each metrics writer was on, a digest of the
    batch each step received, and the port's log lines."""

    def __init__(self):
        self.finals, self.restored, self.saved, self.on = [], [], [], []
        self.batches, self.logs = [], []

    def __enter__(self):
        import logging
        from blind_image_denoising_torch import train
        from blind_image_denoising_torch.training import train_loop as loop
        from blind_image_denoising_torch.training.checkpoint import (
            CheckpointManager)
        self._real = dict(loop=loop.train_loop, cli=train.train_loop,
                          restore=CheckpointManager.restore,
                          save=CheckpointManager._save,
                          writer=loop.MetricsWriter,
                          shard=loop.shard_train_step)
        real = self._real

        def save(manager, state, force, replace):
            wrote = real["save"](manager, state, force, replace)
            self.saved.append((state.step, wrote))
            return wrote

        def writer(directory, enabled=True):
            self.on.append(enabled)
            return real["writer"](directory, enabled=enabled)

        def run(*a, **k):
            state = real["loop"](*a, **k)
            self.finals.append({k2: v.detach().cpu().clone()
                                for k2, v in state.model.state_dict().items()})
            return state

        def restore(manager, state, step=None):
            state = real["restore"](manager, state, step)
            self.restored.append(dict(
                step=state.step, epoch=state.epoch,
                model={k2: v.detach().cpu().clone()
                       for k2, v in state.model.state_dict().items()},
                slots={k2: [t.detach().cpu().clone() for t in v]
                       for k2, v in state.opt_state.slots.items()},
                ema=None if state.ema_params is None else {
                    k2: v.detach().cpu().clone()
                    for k2, v in state.ema_params.items()}))
            return state

        def shard(step, mesh, spatial=False):
            inner = real["shard"](step, mesh, spatial=spatial)

            def probed(state, batch, *a, **k):
                data = batch.detach().cpu().contiguous().numpy()
                self.batches.append(hashlib.sha1(data.tobytes()).hexdigest())
                return inner(state, batch, *a, **k)
            return probed

        class Keep(logging.Handler):
            def emit(handler, record):
                self.logs.append(record.getMessage())

        self._handler = Keep()
        logging.getLogger("blind_image_denoising_torch").addHandler(
            self._handler)
        loop.train_loop = train.train_loop = run
        CheckpointManager.restore, CheckpointManager._save = restore, save
        loop.MetricsWriter, loop.shard_train_step = writer, shard
        return self

    def __exit__(self, *exc):
        import logging
        from blind_image_denoising_torch import train
        from blind_image_denoising_torch.training import train_loop as loop
        from blind_image_denoising_torch.training.checkpoint import (
            CheckpointManager)
        real = self._real
        loop.train_loop, train.train_loop = real["loop"], real["cli"]
        CheckpointManager.restore = real["restore"]
        CheckpointManager._save = real["save"]
        loop.MetricsWriter, loop.shard_train_step = (real["writer"],
                                                     real["shard"])
        logging.getLogger("blind_image_denoising_torch").removeHandler(
            self._handler)

    def result(self):
        return dict(finals=self.finals, restored=self.restored,
                    saved=self.saved, metrics_enabled=self.on,
                    batches=self.batches, logs=self.logs)


def train_cli(rank, n, out, legs, device=None):
    """The train CLI as this rank, once per leg (each ``legs`` entry one
    argv a rank, with the leg's coordinator port): the ``LoopProbe``
    record of its loops. The argv names the device."""
    del device
    from blind_image_denoising_torch import train
    with LoopProbe() as probe:
        for argv in legs:
            if train.main(argv[rank]) != 0:
                raise AssertionError(f"train CLI returned nonzero: {argv}")
    torch.save(probe.result(), out / f"rank{rank}.pt")


def spatial_loops(rank, n, out, runs, device="cpu"):
    """``train_loop`` as this rank on each run (a list of configs, one a
    leg, into one checkpoint directory a run): the ``LoopProbe`` record
    of each run."""
    from blind_image_denoising_torch.training import train_loop as loop
    results = []
    for i, legs in enumerate(runs):
        with LoopProbe() as probe:
            for cfg in legs:
                loop.train_loop(cfg, out / f"ckpt_{i}", device=device)
        results.append(probe.result())
    torch.save(results, out / f"rank{rank}.pt")
