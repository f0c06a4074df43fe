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
rank's rows plus zeros).
"""

from typing import Callable

import torch
import torch.distributed as dist

from .mesh import Mesh, Sharding


def spatial_sharding(mesh: Mesh) -> Sharding:
    """[B, H, W, C] images: H split over the 'spatial' axis."""
    return Sharding(mesh, (), "spatial")


def spatial_shard_image(mesh: Mesh, image) -> torch.Tensor:
    """This rank's slab of rows of ``image`` (the whole image, alike on
    every rank)."""
    return spatial_sharding(mesh).shard(image)


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
    b, h, w, c = x.shape
    slots = x.new_zeros((n, 2, b, margin, w, c))
    slots[idx, 0] = x.narrow(1, 0, margin)
    slots[idx, 1] = x.narrow(1, h - margin, margin)
    dist.all_reduce(slots, group=group)
    top = slots[idx - 1, 1] if idx > 0 else slots[idx, 1].zero_()
    bot = slots[idx + 1, 0] if idx < n - 1 else slots[idx, 0].zero_()
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
    at its rows: exact."""
    n = mesh.shape.get("spatial", 1)
    if n == 1:
        return slab
    idx = mesh.index(("spatial",))[0]
    b, h, w, c = slab.shape
    full = slab.new_zeros((b, n * h, w, c))
    full[:, idx * h:(idx + 1) * h] = slab
    dist.all_reduce(full, group=mesh.group(("spatial",)))
    return full
