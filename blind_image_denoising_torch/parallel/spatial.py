"""Spatial (halo-exchange) sharding for full-frame / 4K denoising
(counterpart of ``blind_image_denoising_tpu/parallel/spatial.py``).

The image's H axis is split over the mesh's 'spatial' ranks; each rank
takes ``margin`` rows from each neighbour, runs the fully convolutional
denoiser on its padded slab and crops the halo off. Because the hydra is
fully convolutional, the result equals the single-device full-frame
output wherever the halo covers the receptive field.

JAX exchanges the halos with one ``ppermute`` pair. Here every rank
writes its top and bottom ``margin`` rows into its own slots of a buffer
of ``[n, 2, B, margin, W, C]`` zeros and one ``all_reduce`` (sum) over the
spatial sub-group fills every slot, so the exchange works on any backend
(gloo has no CUDA ``send``/``recv``) and is exact (each slot is one
rank's rows plus zeros). The split, the exchange and the gather are
differentiable in both modes, so ``Denoiser.float_forward`` takes
derivatives through a sharded forward: the exchange's backward reduces
the gradient the same way (``mesh.all_reduce_sum``); the gather's
backward takes the rank's rows of a gradient that every rank holds
alike (they all run the same computation on the whole image), and the
split's backward gathers the slabs' gradients, so every rank gets the
whole input's gradient.

Spatially sharded training (``mesh.shard_train_step(spatial=True)``)
needs no exchange: every spatial rank holds the whole crop, so its slab
reaches :func:`training_margin` rows past its owned rows, recomputing
them. An op that sees the whole map (the self-attention's 16×16 resize,
the selector's mask, a gate's or the global pool's mean) runs through
:func:`on_whole_map`: on :func:`gather_rows` of its input, the whole
map, inside ``mesh.whole_map``, its result marked :func:`shared`;
:func:`slab_rows` takes the slab's rows of it. Every spatial rank runs
the op alike, so its backward runs once on the sum of the ranks'
gradients, as the unsharded step's does: ``shared``'s backward sums the
result's gradient over the spatial ranks and divides it by their
number, and ``gather_rows``'s backward sums the input's gradient back.
"""

from typing import Callable, Dict

import torch
import torch.distributed as dist

from .mesh import (Mesh, Sharding, all_reduce_sum, current_spatial_shard,
                   whole_map)


def spatial_sharding(mesh: Mesh) -> Sharding:
    """[B, H, W, C] images: H split over the 'spatial' axis."""
    return Sharding(mesh, (), "spatial")


def spatial_shard_image(mesh: Mesh, image) -> torch.Tensor:
    """This rank's slab of rows of ``image`` (the whole image, alike on
    every rank); a tensor's gradient is the whole image's, gathered from
    every slab's."""
    if not isinstance(image, torch.Tensor) or \
            mesh.shape.get("spatial", 1) == 1:
        return spatial_sharding(mesh).shard(image)
    idx, n = mesh.index(("spatial",))
    h = image.shape[1]
    if h % n:
        raise ValueError(f"height {h} does not split into {n} 'spatial' "
                         f"shards")
    return _Split.apply(image, 1, idx * (h // n), h // n,
                        mesh.group(("spatial",)))


def _placed(part: torch.Tensor, dim: int, start: int,
            height: int) -> torch.Tensor:
    """``part`` at ``start`` of a zero frame of ``height`` along ``dim``."""
    pads = [part.new_zeros(part.shape[:dim] + (rows,) + part.shape[dim + 1:])
            for rows in (start, height - start - part.shape[dim])]
    return torch.cat([pads[0], part, pads[1]], dim=dim)


def _gathered(part: torch.Tensor, dim: int, start: int, height: int,
              group) -> torch.Tensor:
    frame = _placed(part, dim, start, height)
    dist.all_reduce(frame, group=group)
    return frame


class _Split(torch.autograd.Function):
    """A replicated tensor's rows ``[start, start + rows)`` along ``dim``;
    the backward gathers every rank's gradient into the whole."""

    @staticmethod
    def forward(ctx, x, dim, start, rows, group):
        ctx.args = (dim, start, x.shape[dim], group)
        ctx.rows = rows
        return x.narrow(dim, start, rows).clone()

    @staticmethod
    def backward(ctx, grad):
        return (_gathered(grad.contiguous(), *ctx.args),
                None, None, None, None)

    @staticmethod
    def jvp(ctx, tangent, *_):
        dim, start = ctx.args[:2]
        return tangent.narrow(dim, start, ctx.rows).clone()


class _Gather(torch.autograd.Function):
    """Every rank's part, placed at its rows, summed into the whole; for
    a computation that every rank then runs alike, so the backward takes
    the rank's rows of a gradient the ranks hold alike."""

    @staticmethod
    def forward(ctx, part, dim, start, height, group):
        ctx.args = (dim, start, height, group)
        ctx.rows = part.shape[dim]
        return _gathered(part, dim, start, height, group)

    @staticmethod
    def backward(ctx, grad):
        dim, start = ctx.args[:2]
        return (grad.narrow(dim, start, ctx.rows).contiguous(),
                None, None, None, None)

    @staticmethod
    def jvp(ctx, tangent, *_):
        return _gathered(tangent.contiguous(), *ctx.args)


def receptive_field_margin(depth: int, encoder_kernel: int = 5,
                           width: int = 1) -> int:
    """Conservative half-receptive-field for a unet_laplacian-style model:
    each level stacks `width` blocks of k×k depthwise convs, and each
    downsample doubles the stride of everything below it.

    The result is rounded UP to a multiple of 2**depth: strided/pooled 2×
    downsampling samples absolute row parities, so every shard's slab must
    start at a row ≡ 0 (mod the total downsample factor) for the sharded
    pyramid to align with the unsharded one."""
    per_level = (encoder_kernel // 2) * (width + 2) + 2
    margin = 0
    for d in range(depth):
        margin += per_level * (2 ** d)
    factor = 2 ** depth
    return ((margin + factor - 1) // factor) * factor


def _exchange(x: torch.Tensor, margin: int, idx: int, n: int, group):
    """(halo_top, halo_bot): the bottom ``margin`` rows of the shard above
    and the top rows of the shard below (zeros past either edge)."""
    zeros = x.new_zeros(x.shape[:1] + (margin,) + x.shape[2:])
    slots = [zeros] * (2 * n)
    slots[2 * idx] = x.narrow(1, 0, margin)
    slots[2 * idx + 1] = x.narrow(1, x.shape[1] - margin, margin)
    slots = all_reduce_sum(torch.stack(slots), group)
    top = slots[2 * idx - 1] if idx > 0 else zeros
    bot = slots[2 * idx + 2] if idx < n - 1 else zeros
    return top, bot


def denoise_spatially_sharded(
        apply_fn: Callable,
        variables,
        mesh: Mesh,
        margin: int) -> Callable:
    """Build ``fn(slab) -> denoised slab`` running H-sharded over
    'spatial': ``slab`` is this rank's rows of the image
    (:func:`spatial_shard_image`, [B, H/n, W, C]); every rank of the
    spatial sub-group calls ``fn`` together, and :func:`gather_spatial`
    puts the slabs back together.

    ``apply_fn(variables, x)`` must be the single-device denoiser forward
    on NHWC. ``margin`` must be a multiple of the model's total downsample
    factor and ≥ its half receptive field."""
    n_spatial = mesh.shape.get("spatial", 1)
    group = mesh.group(("spatial",))
    idx = mesh.index(("spatial",))[0]

    def fn(x: torch.Tensor) -> torch.Tensor:
        if n_spatial == 1:
            return apply_fn(variables, x)
        if group is None:
            raise ValueError(f"mesh {mesh.shape} has no spatial process "
                             f"group (parallel.multihost.initialize)")
        local_h = x.shape[1]
        if margin > local_h:
            raise ValueError(
                f"halo margin {margin} exceeds the per-shard height "
                f"{local_h}: ppermute can only exchange whole-neighbor "
                f"slabs; use fewer spatial shards or a taller image")
        halo_top, halo_bot = _exchange(x, margin, idx, n_spatial, group)
        zeros = torch.zeros_like(halo_top)
        # Boundary shards present the true image edge AT the slab edge:
        # zero-filled halos are not equivalent, because deeper layers'
        # SAME padding is zero in their own feature space, not in input
        # space. So the top/bottom shards shift their rows flush against
        # the slab boundary and crop asymmetrically.
        if idx == 0:
            slab, start = torch.cat([x, halo_bot, zeros], dim=1), 0
        elif idx == n_spatial - 1:
            slab, start = torch.cat([zeros, halo_top, x], dim=1), 2 * margin
        else:
            slab, start = torch.cat([halo_top, x, halo_bot], dim=1), margin
        y = apply_fn(variables, slab)
        return y.narrow(1, start, local_h)

    return fn


def gather_spatial(mesh: Mesh, slab: torch.Tensor) -> torch.Tensor:
    """The whole image from every spatial rank's ``slab`` (each rank gets
    it), through one ``all_reduce`` of a zero frame that each rank fills
    at its rows: exact, and differentiable."""
    n = mesh.shape.get("spatial", 1)
    if n == 1:
        return slab
    idx = mesh.index(("spatial",))[0]
    h = slab.shape[1]
    return _Gather.apply(slab, 1, idx * h, n * h, mesh.group(("spatial",)))


# ---------------------------------------------------------------- training

def map_rows(x: torch.Tensor, dim: int = 2):
    """(shard, rows) of a slab map under the step's spatial shard (dim
    ``dim`` its rows: 2 for NCHW, 1 for NHWC); (None, None) outside one."""
    shard = current_spatial_shard()
    if shard is None:
        return None, None
    return shard, shard.at(x.shape[dim])


def gather_rows(x: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """The whole map of a slab map: every spatial rank's owned rows in
    one frame. Each rank's losses differ downstream, so the backward
    sums the frame's gradient over the spatial ranks and each takes its
    owned rows. ``x`` itself outside a spatial shard."""
    shard, rows = map_rows(x, dim)
    if shard is None:
        return x
    own = x.narrow(dim, rows.own_start, rows.own_rows)
    return all_reduce_sum(_placed(own, dim, rows.slab_start + rows.own_start,
                                  rows.height), shard.group)


class _Shared(torch.autograd.Function):
    """The identity on a value every spatial rank computes alike; the
    backward is the mean over the ranks of the gradient, so the op that
    made the value differentiates the sum of their gradients, each rank
    a 1/n share of it."""

    @staticmethod
    def forward(ctx, y, group, count):
        ctx.group, ctx.count = group, count
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad.div_(float(ctx.count)), None, None

    @staticmethod
    def jvp(ctx, tangent, *_):
        return tangent


def shared(y: torch.Tensor, shard) -> torch.Tensor:
    """Mark ``y``, computed alike by every spatial rank from gathered
    maps, as such (:class:`_Shared`) under ``shard`` (the spatial shard
    read before ``whole_map``; None: ``y`` itself)."""
    if shard is None:
        return y
    return _Shared.apply(y, shard.group, shard.count)


def on_whole_map(fn: Callable, x: torch.Tensor, *args):
    """``fn(x, *args)`` for an op that sees the whole map of the NCHW map
    ``x``. Under a spatially sharded step it runs on :func:`gather_rows`
    of ``x`` inside ``mesh.whole_map`` and its result is
    :func:`shared`. Returns (the result, the spatial shard or None: what
    :func:`slab_rows` takes)."""
    shard = current_spatial_shard()
    if shard is None:
        return fn(x, *args), None
    full = gather_rows(x)
    with whole_map():
        y = fn(full, *args)
    return shared(y, shard), shard


def slab_rows(y: torch.Tensor, shard, dim: int = 2) -> torch.Tensor:
    """The slab's rows of a whole map ``y`` under ``shard`` (the spatial
    shard read before ``whole_map``; None: ``y`` itself)."""
    if shard is None:
        return y
    rows = shard.at(y.shape[dim], whole=True)
    return y.narrow(dim, rows.slab_start, rows.slab_rows)


# the SSIM loss's 7×7 VALID window reads 6 rows below each owned row
LOSS_ROWS = 6


def _round_up(v: int, factor: int) -> int:
    return -(-v // factor) * factor


def _largest(v) -> int:
    return max(int(k) for k in v) if isinstance(v, (list, tuple)) \
        else int(v)


def _model_margin(backbone: Dict):
    """(half receptive field in input rows, total downsample factor,
    number of output scales) of a backbone config."""
    kind = backbone["type"].strip().lower()
    if kind == "unet_laplacian":
        depth = int(backbone.get("depth", 5))
        s2d = max(1, int(backbone.get("space_to_depth_stem", 0) or 0))
        k = max(_largest(backbone.get("encoder_kernel_size", 5)),
                _largest(backbone.get("decoder_kernel_size", 3)),
                int(backbone.get("gaussian_kernel_size", 3)))
        outputs = depth if backbone.get("multiple_scale_outputs",
                                        True) else 1
        return (receptive_field_margin(
            depth, k, _largest(backbone.get("width", 1))) * s2d,
            2 ** depth * s2d, outputs)
    if kind in ("resnet", "convnext", "unet"):
        convnext = kind == "convnext"
        kernels = backbone.get("block_kernels",
                               [7, 1, 1] if convnext else [3, 3])
        layer = sum(int(k) // 2 for k in kernels)
        if backbone.get("add_mean_sigma_normalization", False):
            layer += 2 * (11 // 2)          # its two 11×11 mean pools
        layers = int(backbone.get("no_layers", 1)) * layer
        base = int(backbone.get("kernel_size", 3)) // 2
        if kind != "unet":
            return base + layers, 1, 1
        # per level, stride 2^l: the encoder and decoder projections and
        # stacks, and a row each for the pool and the upsample
        levels = int(backbone.get("no_levels", 3))
        proj = int(kernels[0]) // 2
        margin = base + sum((2 * (proj + layers) + 2) * 2 ** lvl
                            for lvl in range(levels))
        return margin, 2 ** levels, 1
    raise ValueError(f"no spatial training margin for backbone [{kind}]")


def downsample_factor(model_config: Dict) -> int:
    """The total downsample factor of a hydra config: every row bound of
    a spatially sharded step is a multiple of it."""
    return _model_margin(model_config["backbone"])[1]


def training_margin(model_config: Dict) -> int:
    """Rows a spatial rank's slab reaches past its owned rows in the
    train step, for a hydra config (``model``: backbone and denoiser):
    the backbone's half receptive field (``unet_laplacian``:
    :func:`receptive_field_margin` at its largest kernel and width, times
    its space-to-depth factor; ``resnet`` / ``convnext`` / ``unet``: the
    sum of each conv's ``k // 2``, scaled by the strides) plus the SSIM
    loss's 6 rows at the coarsest output scale, rounded up to a multiple
    of the total downsample factor."""
    margin, factor, outputs = _model_margin(model_config["backbone"])
    return _round_up(margin + LOSS_ROWS * 2 ** (outputs - 1), factor)


def loss_rows(target: torch.Tensor, output: torch.Tensor):
    """A loss's rows under the step's spatial shard: (target rows, output
    rows, :class:`LossShare`) for an NHWC ``target`` of the whole crop at
    its scale and the slab's ``output``. The rows run from the first
    owned row to ``LOSS_ROWS`` past the last (the crop's end at most), so
    the SSIM map's VALID rows are exactly the owned ones; the share holds
    the owned count. ``(target, output, None)`` outside a shard."""
    shard, rows = map_rows(output, 1)
    if shard is None:
        return target, output, None
    own0 = rows.slab_start + rows.own_start
    stop = min(rows.height, own0 + rows.own_rows + LOSS_ROWS)
    if stop - rows.slab_start > rows.slab_rows:
        raise ValueError(f"the slab of {rows.slab_rows} rows lacks the "
                         f"loss's {LOSS_ROWS} rows below its owned ones")
    return (target.narrow(1, own0, stop - own0),
            output.narrow(1, rows.own_start, stop - own0),
            LossShare(rows.own_rows, rows.height, shard.group,
                      shard.index == 0))


class LossShare:
    """A spatial rank's share of a loss over ``height`` rows: it owns the
    first ``rows`` of the rows it is given; ``group`` sums over the
    spatial ranks; ``first``: the rank that adds the constant terms."""

    def __init__(self, rows: int, height: int, group, first: bool):
        self.rows, self.height = rows, height
        self.group, self.first = group, first
