"""Device mesh and data-parallel sharding (counterpart of
``blind_image_denoising_tpu/parallel/mesh.py``).

A mesh here is a grid of the ranks of the ``torch.distributed`` process
group, one device per rank, with JAX's axis names: ``data`` (the batch
dimension of every image tensor), ``spatial`` (the H dimension, see
``parallel/spatial.py``) and, outermost, ``dcn`` (slices of a multi-slice
run). Each axis, and the batch axes together, get a sub-group of the
ranks that share every other coordinate. ``torch.distributed.device_mesh``
is not used: it picks each rank's card from the device count, and the
port puts two ranks on one card (gloo) as readily as one rank per card.
Without a process group ``create_mesh()`` is the one-rank mesh and every
path is the single-process one.

What GSPMD does for free in JAX, the port does on purpose, while a step
runs under :func:`batch_shard` (``shard_train_step`` sets it):

* per-sample random draws (flips, the noise, the degradation chain, the
  drop-path and dropout masks) are drawn for the GLOBAL batch from
  generators seeded alike on every rank, and each rank keeps its rows
  (``ops/noise.batch_rand``); the noise kernel K3 takes the rank's first
  row as its ``sample_offset``;
* BatchNorm's batch statistics are sums ``all_reduce``d over the batch
  axes, with a backward that reduces too (``layers/norm.py``);
* gradients, losses and metrics are means over the batch axes, taken
  after the backward, so the update equals the single-process step on
  the global batch and the state stays identical on every rank.
"""

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..logger import logger
from . import multihost

class Mesh:
    """Named axes over a grid of ranks (JAX's ``Mesh`` attributes:
    ``devices`` is the rank grid, ``shape`` maps axis → size).

    Built by :func:`create_mesh`. Where a process group exists, every
    rank builds the same mesh (its sub-groups are collective to create);
    without one the mesh only describes a grid, and a mesh of more than
    one rank then runs nothing."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str]):
        self.devices = ranks
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, ranks.shape))
        self.size = int(ranks.size)
        me = np.argwhere(ranks == multihost.process_index())
        self.coords: Optional[Dict[str, int]] = (
            {a: int(c) for a, c in zip(self.axis_names, me[0])}
            if len(me) else None)
        self._groups: Dict[Tuple[str, ...], object] = {}
        if multihost.is_initialized():
            self._make_groups()

    @property
    def distributed(self) -> bool:
        return multihost.is_initialized()

    def _make_groups(self) -> None:
        world = multihost.process_count()
        if int(self.devices.max()) >= world:
            raise ValueError(f"mesh ranks {self.devices.ravel().tolist()} "
                             f"exceed the process group's {world}")
        keys = [(a,) for a in self.axis_names]
        batch = batch_axes(self)
        if len(batch) > 1:
            keys.append(batch)
        # every rank creates every group, in one order
        for key in keys:
            dims = [self.axis_names.index(a) for a in key]
            rest = [i for i in range(len(self.axis_names)) if i not in dims]
            grid = np.transpose(self.devices, rest + dims).reshape(
                -1, int(np.prod([self.devices.shape[i] for i in dims])))
            for members in grid.tolist():
                if len(members) == world:
                    group = dist.group.WORLD
                elif len(members) == 1:
                    group = None
                else:
                    group = dist.new_group(members)
                if multihost.process_index() in members:
                    self._groups[key] = group

    def group(self, axes: Sequence[str]):
        """This rank's process group over ``axes`` (e.g. ``("spatial",)``
        or :func:`batch_axes`); None when there is nothing to reduce over:
        no process group, one rank of a larger world, or no such axis."""
        axes = tuple(a for a in axes if a in self.shape)
        if not axes:
            return None
        return self._groups.get(axes)

    def index(self, axes: Sequence[str]) -> Tuple[int, int]:
        """(this rank's position, the number of positions) along
        ``axes`` taken together, row-major as JAX lays a dimension over
        several mesh axes."""
        axes = [a for a in axes if a in self.shape]
        count = int(np.prod([self.shape[a] for a in axes])) if axes else 1
        if self.coords is None:
            raise ValueError(f"rank {multihost.process_index()} is not in "
                             f"the mesh {self.shape}")
        pos = 0
        for a in axes:
            pos = pos * self.shape[a] + self.coords[a]
        return pos, count

    def __repr__(self):
        return f"Mesh({self.shape}, ranks={self.devices.ravel().tolist()})"


def create_mesh(data: int = -1, spatial: int = 1, dcn: int = 1,
                devices: Optional[Sequence[int]] = None) -> Mesh:
    """A ('data', 'spatial') mesh — or ('dcn', 'data', 'spatial') when
    ``dcn > 1`` — over ``devices``, a list of ranks (default: every rank
    of the process group; without one, the single rank 0).

    ``data=-1`` → all remaining ranks. The 'dcn' axis is outermost, as in
    JAX. Every rank of the process group must call it alike."""
    devices = list(devices if devices is not None
                   else range(multihost.process_count()))
    n = len(devices)
    dcn = max(1, int(dcn))
    if data == -1:
        if n % (spatial * dcn) != 0:
            raise ValueError(
                f"{n} devices not divisible by spatial={spatial} x dcn={dcn}")
        data = n // (spatial * dcn)
    if dcn * data * spatial > n:
        raise ValueError(
            f"mesh {dcn}x{data}x{spatial} needs more than {n} devices")
    if dcn > 1:
        grid = np.array(devices[: dcn * data * spatial]).reshape(
            dcn, data, spatial)
        mesh = Mesh(grid, ("dcn", "data", "spatial"))
    else:
        grid = np.array(devices[: data * spatial]).reshape(data, spatial)
        mesh = Mesh(grid, ("data", "spatial"))
    if mesh.distributed:
        logger.info(f"mesh {mesh.shape} over ranks "
                    f"{grid.ravel().tolist()} ({multihost.backend()})")
    return mesh


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The mesh axes the batch dimension shards over."""
    return tuple(a for a in ("dcn", "data") if a in mesh.shape)


@dataclass(frozen=True)
class Sharding:
    """Which block of an NHWC tensor a rank holds (JAX's ``NamedSharding``
    as a descriptor): dim 0 split over the mesh axes ``batch`` (row-major),
    dim 1 over the axis ``rows``; nothing split is replicated."""
    mesh: Mesh
    batch: Tuple[str, ...] = ()
    rows: Optional[str] = None

    def shard(self, x, micro_batches: int = 1):
        """This rank's block of ``x`` (numpy or a tensor, the whole
        value). ``micro_batches`` > 1: ``x`` is that many micro-batches
        one after another, and the rank takes its rows of each, so that
        its k-th local micro-batch is its share of the global k-th."""
        if self.batch:
            pos, count = self.mesh.index(self.batch)
            if x.shape[0] % (count * micro_batches):
                raise ValueError(
                    f"batch of {x.shape[0]} does not split over "
                    f"{self.batch}={count} x {micro_batches} micro-batches")
            m = x.shape[0] // micro_batches
            b = m // count
            parts = [x[k * m + pos * b: k * m + (pos + 1) * b]
                     for k in range(micro_batches)]
            x = parts[0] if micro_batches == 1 else (
                torch.cat(parts) if isinstance(x, torch.Tensor)
                else np.concatenate(parts))
        if self.rows is not None:
            pos, count = self.mesh.index((self.rows,))
            if x.shape[1] % count:
                raise ValueError(f"height {x.shape[1]} does not split into "
                                 f"{count} '{self.rows}' shards")
            h = x.shape[1] // count
            x = x[:, pos * h:(pos + 1) * h]
        return x


def data_sharding(mesh: Mesh, spatial: bool = False) -> Sharding:
    """Batch tensors: dim 0 over 'data' (and 'dcn' when present);
    ``spatial=True`` also splits H over 'spatial'."""
    rows = "spatial" if spatial and mesh.shape.get("spatial", 1) > 1 \
        else None
    return Sharding(mesh, batch_axes(mesh), rows)


def replicate_sharding(mesh: Mesh) -> Sharding:
    """Params / scalars / the evaluation batch: every rank the whole."""
    return Sharding(mesh)


def shard_batch(mesh: Mesh, batch, micro_batches: int = 1,
                device=None) -> torch.Tensor:
    """This rank's rows of a host batch (the whole global batch, alike on
    every rank), on its device."""
    sharding = data_sharding(mesh)
    return multihost.put_batch(sharding, sharding.shard(batch,
                                                         micro_batches),
                               device)


# ---------------------------------------------------------------- the step

@dataclass(frozen=True)
class BatchShard:
    """A step's share of the global batch: the rank holds rows
    ``index·b … index·b + b − 1`` of every global micro-batch of
    ``count·b`` rows, and ``group`` reduces over the batch axes."""
    index: int
    count: int
    group: object


_SHARD = contextvars.ContextVar("bidt_batch_shard", default=None)


def current_batch_shard() -> Optional[BatchShard]:
    """The :class:`BatchShard` of the step running now, or None."""
    return _SHARD.get()


@contextlib.contextmanager
def batch_shard(shard: Optional[BatchShard]):
    token = _SHARD.set(shard)
    try:
        yield shard
    finally:
        _SHARD.reset(token)


class _AllReduceSum(torch.autograd.Function):
    """``all_reduce`` (sum) whose backward is the same reduction of the
    output's gradient: each rank's input feeds every rank's output."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``group``."""
    return _AllReduceSum.apply(x, group)


def reduce_mean_(tensors: Sequence[torch.Tensor], shard: BatchShard) -> None:
    """In place: each tensor becomes its mean over the batch axes' ranks,
    through one ``all_reduce`` of the tensors flattened together (float32
    on the tensors' device; no host sync under NCCL)."""
    if not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=shard.group)
    flat.div_(float(shard.count))
    offset = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def _check_equal_rows(rows: int, shard: BatchShard, dev) -> None:
    """Raise unless every rank holds ``rows`` rows (one host read)."""
    comm = dev if multihost.backend() == "nccl" else torch.device("cpu")
    t = torch.tensor([rows, -rows], dtype=torch.int64, device=comm)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=shard.group)
    hi, lo = int(t[0]), -int(t[1])
    if hi != lo:
        raise ValueError(
            f"local batches of {lo} to {hi} rows: the data-parallel step "
            f"needs equal local batches (the global batch divisible by "
            f"dcn x data = {shard.count})")


def shard_train_step(train_step, mesh: Mesh, spatial: bool = False):
    """The port's ``build_train_step`` step under the mesh's batch axes:
    each rank passes its rows of the global batch (``shard_batch``) and a
    state identical on every rank, and the update equals the
    single-process step on the global batch (module docstring). The
    local batches must be equal, as JAX needs ``batch % (dcn·data) ==
    0``; the first call with a new local batch size checks it.

    ``spatial=True`` (spatially sharded training) raises: it needs a halo
    under every conv, pool and resize in autograd, the next slice."""
    if spatial:
        raise NotImplementedError(
            "spatially sharded training (tpu.mesh.spatial_training) is not "
            "ported yet: it needs a halo exchange under every conv, pool "
            "and resize in autograd (ROADMAP Queue 1 item 13, spatial "
            "training, the next slice)")
    axes = batch_axes(mesh)
    group = mesh.group(axes)
    if group is None:
        if mesh.size > 1 and not mesh.distributed:
            raise ValueError(
                f"mesh {mesh.shape} spans {mesh.size} ranks but no process "
                f"group is initialized (parallel.multihost.initialize)")
        return train_step
    index, count = mesh.index(axes)
    shard = BatchShard(index, count, group)
    checked = set()

    def step(state, batch, *args, **kwargs):
        if shard.count > 1 and batch.shape[0] not in checked:
            _check_equal_rows(int(batch.shape[0]), shard,
                              next(state.model.parameters()).device)
            checked.add(int(batch.shape[0]))
        with batch_shard(shard):
            return train_step(state, batch, *args, **kwargs)

    return step
