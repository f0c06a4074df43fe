"""Several processes (counterpart of
``blind_image_denoising_tpu/parallel/multihost.py``).

JAX's multi-controller SPMD is ``torch.distributed`` here: every process
runs the same program on ONE device and is one rank of the default
process group. What JAX assembles into global arrays stays local: a
rank holds its own rows of the global batch (``put_batch``), values that
every rank holds alike are ``replicate``d, and the collectives the port
writes (``parallel/mesh.py``, ``parallel/spatial.py``) are built from
``all_reduce`` and ``broadcast`` only, the two that every backend takes
on CUDA tensors (gloo has no CUDA ``send``/``recv`` or ``all_gather``).

Host-side side effects (metrics, checkpoints, figures) run on the
primary rank only. The backend is explicit: ``initialize(backend=None)``
is NCCL when the rank's device is a card and gloo on the CPU; gloo is
the only backend that puts two ranks on one card (NCCL refuses a
duplicate GPU). The choice is logged, and nothing retries on another
backend after a failure.
"""

import datetime
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..logger import logger

# this rank's device, set by initialize (the process group itself is
# torch.distributed's process-wide state)
_RANK = {"device": None}

_PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def _resolve(device, platform, process_id: int) -> torch.device:
    if device is None:
        if platform is not None and platform not in _PLATFORMS:
            raise ValueError(f"platform must be one of {sorted(_PLATFORMS)}, "
                             f"got {platform!r}")
        device = _PLATFORMS.get(platform, "cuda")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", process_id))
            dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def initialize(coordinator_address: str,
               num_processes: int,
               process_id: int,
               platform: Optional[str] = None,
               local_device_count: Optional[int] = None,
               initialization_timeout: int = 600,
               heartbeat_timeout_seconds: int = 600,
               *, backend: Optional[str] = None, device=None) -> None:
    """Join the process group as rank ``process_id`` of ``num_processes``
    through the TCP store at ``coordinator_address`` (``host:port``, rank
    0 listens). Call before any collective.

    ``device``: this rank's device (None: the card, ``cuda:<local rank>``;
    ``platform="cpu"`` or ``device="cpu"``: the CPU). ``backend``: None is
    NCCL for a card and gloo for the CPU; ``"gloo"`` is the way to put
    several ranks on one card. ``local_device_count``: one device a
    process in the port, so only None or 1. The timeouts are JAX's
    generous ones: they bound how long a rank waits for a peer that
    stalls, and never slow a healthy cohort."""
    if local_device_count not in (None, 1):
        raise ValueError(
            f"local_device_count={local_device_count}: the port runs one "
            f"device per process; start one process per device")
    dev = _resolve(device, platform, int(process_id))
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl', 'gloo' or None, got "
                         f"{backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device per rank")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(
        seconds=max(int(initialization_timeout),
                    int(heartbeat_timeout_seconds)))
    logger.info(f"process {process_id}/{num_processes}: backend {backend} "
                f"on {dev}, coordinator {coordinator_address}")
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=timeout)
    _RANK["device"] = dev


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns host-side side effects."""
    return process_index() == 0


def backend() -> Optional[str]:
    """The process group's backend (None without one)."""
    return dist.get_backend() if is_initialized() else None


def device(default=None) -> torch.device:
    """This rank's device (``initialize``'s), else ``default`` (None: the
    card)."""
    if _RANK["device"] is not None and is_initialized():
        return _RANK["device"]
    return torch.device("cuda" if default is None else default)


def comm_device() -> torch.device:
    """Where the process group's own small tensors live: the rank's card
    under NCCL, the CPU under gloo."""
    return device() if backend() == "nccl" else torch.device("cpu")


def put_batch(sharding, local_batch, device_=None) -> torch.Tensor:
    """This rank's rows of the global batch (``local_batch``, numpy or a
    tensor) on its device; a host array goes through pinned memory
    without the host waiting for the card. ``sharding`` (a
    ``parallel/mesh.Sharding`` or None) describes the rows; the caller
    already holds just its own, as JAX's
    ``make_array_from_process_local_data`` takes them."""
    del sharding
    dev = torch.device(device_) if device_ is not None else device()
    t = local_batch if isinstance(local_batch, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(local_batch))
    if dev.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(dev, non_blocking=True)


def replicate(sharding, value, device_=None) -> torch.Tensor:
    """A value that every rank holds alike (e.g. the evaluation batch) on
    this rank's device: ``put_batch`` of the whole value."""
    return put_batch(sharding, value if isinstance(value, torch.Tensor)
                     else np.asarray(value), device_)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def to_host(tree: Any) -> Any:
    """Tensors of a (replicated) tree as host numpy arrays, e.g. before a
    primary-only save; other leaves pass through."""
    return _map(lambda x: x.detach().cpu().numpy()
                if isinstance(x, torch.Tensor) else x, tree)


def broadcast_from_primary(tree: Any) -> Any:
    """The primary rank's tree on every rank (a no-op in one process): one
    ``broadcast`` per tensor or numpy leaf, each returned as the type and
    on the device it came in. Used after the in-loop prune, so a host-side
    transform can never desynchronize the ranks."""
    if process_count() == 1:
        return tree
    comm = comm_device()

    def one(x):
        if isinstance(x, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(x)).to(comm)
            dist.broadcast(t, src=0)
            return t.cpu().numpy()
        if isinstance(x, torch.Tensor):
            t = x.detach().to(comm).clone()
            dist.broadcast(t, src=0)
            return t.to(x.device)
        return x
    return _map(one, tree)


def sync(name: str = "sync") -> None:
    """Barrier across processes (no-op without a process group), after one
    tiny ``all_reduce`` that brings up the backend's communicator while
    the ranks are aligned (NCCL creates it lazily, at the first
    collective)."""
    if not is_initialized():
        return
    dist.all_reduce(torch.zeros((1,), device=comm_device()))
    dev = device()
    if backend() == "nccl":
        dist.barrier(device_ids=[dev.index])
    else:
        dist.barrier()
    logger.debug(f"sync {name}")


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    if is_initialized():
        dist.destroy_process_group()
    _RANK["device"] = None
