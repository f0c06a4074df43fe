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

``shard_train_step(spatial=True)`` also splits each crop's rows over
the 'spatial' ranks, under :func:`spatial_shard` (a
:class:`SpatialShard` beside the :class:`BatchShard`): every spatial
rank of a batch shard holds the same full-height rows and prepares them
whole, runs the model on its slab (its owned rows and ``margin`` more
on each side, clipped to the crop), gathers the whole map at each op
that sees it (``parallel/spatial.py``), and takes the losses over its
owned rows; BatchNorm's statistics are sums over the owned rows reduced
over the batch and spatial axes together, and the gradients and
metrics are sums over 'spatial' and means over the batch axes.
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
        if self.shape.get("spatial", 1) > 1:
            keys.append(batch + ("spatial",))
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

    def owned_rows(self, height: int, factor: int = 1) -> Tuple[int, int]:
        """The rows ``[r0, r1)`` of ``height`` this rank owns along
        ``rows`` (:func:`row_bounds`; the whole height when rows are not
        split)."""
        if self.rows is None:
            return 0, height
        pos, count = self.mesh.index((self.rows,))
        return row_bounds(height, pos, count, factor)


def broadcast_over(mesh: Mesh, axis: str, tensor: torch.Tensor):
    """In place: every rank along ``axis`` gets the tensor of the rank at
    position 0 of it (all other coordinates alike)."""
    group = mesh.group((axis,))
    if group is None:
        return tensor
    coords = dict(mesh.coords, **{axis: 0})
    src = int(mesh.devices[tuple(coords[a] for a in mesh.axis_names)])
    dist.broadcast(tensor, src=src, group=group)
    return tensor


def row_bounds(height: int, index: int, count: int,
               factor: int = 1) -> Tuple[int, int]:
    """The rows ``[r0, r1)`` that position ``index`` of ``count`` owns of
    ``height``: equal runs of a multiple of ``factor`` rows (the model's
    total downsample factor, so every bound is one too), the last
    position taking the remainder."""
    run = height // count // factor * factor
    if run == 0:
        raise ValueError(
            f"height {height} does not split into {count} shards of a "
            f"multiple of {factor} rows")
    return index * run, height if index == count - 1 else (index + 1) * run


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


@dataclass(frozen=True)
class SpatialShard:
    """A spatially sharded step's share of each crop: of ``height`` rows
    the rank owns ``rows`` = [r0, r1) and runs the model on ``slab`` =
    [max(0, r0 − margin), min(height, r1 + margin)); position ``index``
    of ``count`` along 'spatial'. ``group`` gathers over 'spatial';
    ``reduce_group`` reduces over the batch axes and 'spatial' together,
    whose batch axes have ``batch_count`` positions. A map of the model
    at a coarser scale holds the same bounds divided by its factor."""
    index: int
    count: int
    height: int
    rows: Tuple[int, int]
    slab: Tuple[int, int]
    group: object
    reduce_group: object
    batch_count: int

    def factor(self, rows: int, whole: bool = False) -> int:
        """The scale of a map that has ``rows`` rows: of the slab, or of
        the whole crop (``whole``)."""
        span = self.height if whole else self.slab[1] - self.slab[0]
        f = span // max(1, rows)
        if f * rows != span or any(v % f for v in self.rows + self.slab):
            raise ValueError(
                f"a map of {rows} rows is no scale of the "
                f"{'crop' if whole else 'slab'} of {span} rows (owned "
                f"{self.rows}, slab {self.slab})")
        return f

    def at(self, rows: int, whole: bool = False) -> "MapRows":
        """The bounds at the scale of a map of ``rows`` rows (of the slab,
        or of the whole crop with ``whole``)."""
        f = self.factor(rows, whole)
        (r0, r1), (s0, s1) = self.rows, self.slab
        return MapRows(s0 // f, (s1 - s0) // f, (r0 - s0) // f,
                       (r1 - r0) // f, self.height // f)


@dataclass(frozen=True)
class MapRows:
    """A map's rows under a :class:`SpatialShard`: the slab starts at
    ``slab_start`` of ``height`` and has ``slab_rows``; the owned rows
    start ``own_start`` into the slab and are ``own_rows`` long."""
    slab_start: int
    slab_rows: int
    own_start: int
    own_rows: int
    height: int


_SPATIAL = contextvars.ContextVar("bidt_spatial_shard", default=None)


def current_spatial_shard() -> Optional[SpatialShard]:
    """The :class:`SpatialShard` of the step running now, or None (also
    inside :func:`whole_map`)."""
    return _SPATIAL.get()


@contextlib.contextmanager
def spatial_shard(shard: Optional[SpatialShard]):
    token = _SPATIAL.set(shard)
    try:
        yield shard
    finally:
        _SPATIAL.reset(token)


def whole_map():
    """Within the block the ops see whole maps: no spatial shard (the
    batch shard stays). An op that runs on a gathered map runs here."""
    return spatial_shard(None)


class _AllReduceSum(torch.autograd.Function):
    """``all_reduce`` (sum) whose backward is the same reduction of the
    output's gradient: each rank's input feeds every rank's output. The
    forward-mode tangent is reduced the same way."""

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

    @staticmethod
    def jvp(ctx, tangent, _):
        tangent = tangent.clone()
        dist.all_reduce(tangent, group=ctx.group)
        return tangent


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``group``."""
    return _AllReduceSum.apply(x, group)


def reduce_mean_(tensors: Sequence[torch.Tensor], group, count: int) -> None:
    """In place: each tensor becomes its sum over the ranks of ``group``
    divided by ``count`` (the batch axes' positions: a mean over them,
    and a sum over 'spatial' when ``group`` holds it too), through one
    ``all_reduce`` of the tensors flattened together (float32 on the
    tensors' device; no host sync under NCCL)."""
    if not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(float(count))
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

    ``spatial=True`` on a mesh with a 'spatial' axis of n > 1 ranks:
    each crop's rows are also split over the n ranks (module
    docstring). The spatial ranks of a batch shard pass the same
    full-height rows (``shard_batch``, as without). A slab reaches
    ``parallel/spatial.training_margin`` of the state's model past its
    owned rows, whose bounds are multiples of the model's total
    downsample factor."""
    axes = batch_axes(mesh)
    group = mesh.group(axes)
    spatial = spatial and mesh.shape.get("spatial", 1) > 1
    if mesh.size > 1 and not mesh.distributed:
        raise ValueError(
            f"mesh {mesh.shape} spans {mesh.size} ranks but no process "
            f"group is initialized (parallel.multihost.initialize)")
    if group is None and not spatial:
        return train_step
    index, count = mesh.index(axes)
    shard = BatchShard(index, count, group)
    rows = data_sharding(mesh, spatial=True)
    checked = set()
    layout = {}

    def spatial_of(model, height: int) -> SpatialShard:
        if "margin" not in layout:
            from .spatial import downsample_factor, training_margin
            layout["margin"] = training_margin(model.config)
            layout["factor"] = downsample_factor(model.config)
        s_index, s_count = mesh.index(("spatial",))
        r0, r1 = rows.owned_rows(height, layout["factor"])
        m = layout["margin"]
        return SpatialShard(
            s_index, s_count, height, (r0, r1),
            (max(0, r0 - m), min(height, r1 + m)),
            mesh.group(("spatial",)), mesh.group(axes + ("spatial",)), count)

    def step(state, batch, *args, **kwargs):
        if shard.count > 1 and batch.shape[0] not in checked:
            _check_equal_rows(int(batch.shape[0]), shard,
                              next(state.model.parameters()).device)
            checked.add(int(batch.shape[0]))
        slab = (spatial_of(state.model, int(batch.shape[1])) if spatial
                else None)
        with batch_shard(shard), spatial_shard(slab):
            return train_step(state, batch, *args, **kwargs)

    return step
