"""Laplacian band split: ``band = x − A·x``, ``smooth = A·x``.

Counterpart of ``blind_image_denoising_tpu/ops/pallas_pyramid.py``
``laplacian_band_smooth_pallas`` (Pallas body ``_band_smooth_kernel``),
which the flagship encoder computes at levels 0 and 1
(``models/unet_laplacian.py`` ``avg_pool_same`` + subtract). ``A`` is the
count-aware SAME k×k stride-1 box mean: XLA's SAME padding puts the
extra row and column of an even window on the HIGH side, and the divide
counts only the in-image taps.

CUDA kernel (``csrc/band_smooth.cu``): one pass, one thread per 16-byte
vector of channels of one pixel (NHWC; a C that is no multiple of it, as
the C = 108 level of a ``filters_level_multiplier`` 1.5 config, moves
the largest power of two of channels below a vector that divides C, so
the forward takes any C). Each thread sums its k² taps in
float32 (the neighbours' loads hit L1/L2), multiplies by the reciprocal
of the in-image tap count — computed from the pixel index, not read
from a table — and writes both outputs. It is bound by memory: it must
read x once and write band and smooth once, 3·B·H·W·C·bytes against
the H100's 3.35 TB/s; it does ~k² + 2 operations per element, far
below the ridge. It is CUDA C++ rather than Triton only so that both of
the port's kernels build the same way, into one ``nvcc``-built library
(``ops/cuda_build.py``), with no extra dependency. The JAX module's host-side reciprocal table and row-padded
``[H, W·C]`` layout served the TPU's 128-lane tiling and are not carried
over.

``band_smooth`` takes NHWC tensors like the JAX function. A tensor on
the CPU goes through :func:`band_smooth_plain`, the same arithmetic in
plain PyTorch; a CUDA tensor launches the kernel or raises.

Training differentiates through it: ``band_smooth`` is a
``torch.autograd.Function`` (the JAX custom VJP
``laplacian_band_smooth``, whose backward ``_band_smooth_bwd`` /
``_pool_transpose`` XLA runs) whose backward is
``dx = g_band + Aᵀ(g_smooth − g_band)`` — :func:`band_smooth_bwd`, a
second kernel of the same file, with :func:`band_smooth_bwd_plain`
beside it (JAX ``_band_smooth_bwd``, in the kernel's tap order). On the
H100 the backward is bound by memory: it must read both grads once and
write dx once, 3·B·H·W·C·bytes against 3.35 TB/s. Its design for that:
the work is 2-D tiles (rows × pixels × all C channels) walked by
persistent blocks, with 32-bit index arithmetic and no division in the
loop; a block loads both grads of a tile and its (k−1)-wide halo once
with 16-byte loads, forms ``z = (g_smooth − g_band)·inv_count`` once per
staged pixel in float32 into shared memory (zero outside the image, as
the plain version pads), and then sums the k² taps of each output from
shared memory in the plain version's order, adds the g_band it kept
there and stores 16 bytes: bit-exact against
:func:`band_smooth_bwd_plain`. The next tile's loads are issued before
the current tile's sum, so memory stays busy across the block's
barriers. :func:`bwd_tile_plan` mirrors the kernel's tile plan and its
shared memory. Like the split below, it takes any C: a C that is no whole
number of 16-byte vectors (C = 108 in bf16, the level-3 split of a
``filters_level_multiplier`` 1.5 depth-5 v6, which the train step
differentiates) moves the largest power of two of channels that divides C
a thread (:func:`channels_per_thread`; 8-, 4- or 2-byte accesses, the same
sums in the same order), and a C of more vectors than a block has threads
runs as channel slices, a launch each inside one call. Grads that do not
arrive NHWC-contiguous are copied first and counted in
``bwd_grad_copies`` (the train step hands over none). When
no gradient is wanted (serving under ``inference_mode``) autograd
records nothing and only the forward kernel runs.

:func:`band_split` is the split with decimation, ``band = x − A·x`` and
``down = (A·x)[::2, ::2]``: the counterpart of
``laplacian_band_split_pallas`` (Pallas body ``_band_split_kernel``) and
of its oracle ``laplacian_band_split_reference``, with
:func:`band_split_plain` beside it. It must move x once, band once and a
quarter of that for ``down``, 2.25·B·H·W·C elements against 3.35 TB/s.
Its kernel (``bid_band_split``, a kernel of its own) is built for that:
persistent blocks walk 2-D tiles whose pixels and (k−1)-wide halo arrive
in shared memory by asynchronous 16-byte copies (``cp.async``,
zero-filled outside the image), the next tile's copies in flight while
the block sums the current one; a thread owns even 2×2 quads of one
channel vector, reads each staged row of its column strip once (the
vertical taps reused from registers at k = 2), sums in the plain
version's order and stores four 16-byte band vectors and one ``down``
vector per quad: bit-exact against :func:`band_split_plain`. At a C of no
whole 16-byte vectors a thread moves N channels as the backward's does
(8- and 4-byte ``cp.async``, plain 2-byte loads).
:func:`split_tile_plan` mirrors its tile plan. Like the JAX kernel it is
forward only, and a tensor that wants a gradient or carries a
forward-mode tangent raises.

Forward mode (``torch.autograd.forward_ad``) through ``band_smooth``
takes the Function's ``jvp``: the split is linear, so the tangent's
(band, smooth) is the forward kernel run on the tangent, a second K2
launch beside the primal's.
"""

from typing import Tuple

import torch

from .. import benchmarking
from . import cuda_build
from .precision import has_tangent

# kernel launches made by band_smooth and band_smooth_bwd (the plain
# paths do not count), and the grads band_smooth_bwd had to copy into
# NHWC-contiguous memory before its launch
launches = 0
bwd_launches = 0
bwd_grad_copies = 0
# kernel launches made by band_split
split_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the backward kernel's tile plan (csrc/band_smooth.cu BwdPlan): threads
# per block, 16-byte vectors per tile row it aims at, output rows per
# thread, and the shared memory one block may have on an H100
BWD_THREADS, BWD_ROW_VECTORS, BWD_ROWS_PER_THREAD = 256, 128, 2
SHARED_MEMORY_LIMIT = 232_448
# the split kernel's tile plan (csrc/band_smooth.cu SplitPlan): threads per
# block, 16-byte vectors per tile row it aims at, 2×2 quads per thread
# down its strip, and staged tiles in shared memory at once
SPLIT_THREADS, SPLIT_ROW_VECTORS, SPLIT_QUAD_ROWS, SPLIT_STAGES = \
    128, 128, 1, 2


def band_smooth_plain(x: torch.Tensor,
                      kernel_size: int = 2) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Plain PyTorch version of the kernel, in its order of operations:
    float32 tap sum (rows outer, columns inner, out-of-image taps add
    zero), times the float32 reciprocal of the in-image tap count, then
    ``band = x − smooth``; both outputs cast to the input dtype (float64
    inputs are summed in float64)."""
    b, h, w, c = x.shape
    k = int(kernel_size)
    lo = (k - 1) // 2
    xf = x.to(_acc_dtype(x))
    xp = torch.nn.functional.pad(xf, (0, 0, lo, k - 1 - lo, lo, k - 1 - lo))
    acc = torch.zeros_like(xf)
    for dy in range(k):
        for dx in range(k):
            acc = acc + xp[:, dy:dy + h, dx:dx + w, :]
    rows = _valid_taps(h, k, lo, x.device)
    cols = _valid_taps(w, k, lo, x.device)
    inv = 1.0 / (rows[:, None] * cols[None, :])
    smooth = acc * inv[None, :, :, None]
    band = xf - smooth
    return band.to(x.dtype), smooth.to(x.dtype)


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _valid_taps(n: int, k: int, lo: int, device) -> torch.Tensor:
    """In-image taps of a window starting at i − lo, for each i < n."""
    i = torch.arange(n, device=device)
    first = torch.clamp(i - lo, min=0)
    last = torch.clamp(i - lo + k, max=n)
    return (last - first).float()


def _check(t: torch.Tensor, what: str) -> None:
    """The kernels take float32 or bfloat16, at any C: a C that is no
    whole number of 16-byte vectors moves the largest power of two of
    channels that divides it a thread (:func:`channels_per_thread`)."""
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got "
                        f"{t.dtype}")


def channels_per_thread(c: int, dtype: torch.dtype) -> int:
    """Channels of a pixel one thread of the backward or split kernel
    moves (``chans_per_thread`` in ``csrc/band_smooth.cu``): a 16-byte
    vector where C is a whole number of them, else the largest power of
    two that divides C."""
    vec = 16 // torch.tensor([], dtype=dtype).element_size()
    return min(vec, c & -c)


def band_smooth_forward(x: torch.Tensor, kernel_size: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel (its plain version for a CPU tensor), outside
    autograd."""
    global launches
    if x.device.type == "cpu":
        return band_smooth_plain(x, kernel_size)
    if x.device.type != "cuda":
        raise ValueError(f"band_smooth: unsupported device {x.device}")
    _check(x, "band_smooth")
    b, h, w, c = x.shape
    x = x.contiguous()
    band, smooth = torch.empty_like(x), torch.empty_like(x)
    if x.numel() == 0:
        return band, smooth
    lib = cuda_build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.bid_band_smooth(
            x.data_ptr(), band.data_ptr(), smooth.data_ptr(),
            b, h, w, c, int(kernel_size), _DTYPE_CODES[x.dtype], stream)
    cuda_build.check(lib, rc, "band_smooth kernel")
    launches += 1
    if benchmarking.byte_counters:
        benchmarking.add_kernel_bytes(benchmarking.band_bytes(
            b, h, w, c, x.dtype))
    return band, smooth


def band_smooth_bwd_plain(g_band: torch.Tensor, g_smooth: torch.Tensor,
                          kernel_size: int = 2) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel:
    ``dx = g_band + Aᵀ(g_smooth − g_band)`` with ``Aᵀz`` the sum of
    ``z·inv_count`` over the k² shifts with the transposed padding
    (k−1−lo, lo), in float32 and in the kernel's tap order (rows outer,
    columns inner); cast to the grads' dtype (float64 grads are summed in
    float64)."""
    b, h, w, c = g_band.shape
    k = int(kernel_size)
    lo = (k - 1) // 2
    gb = g_band.to(_acc_dtype(g_band))
    rows = _valid_taps(h, k, lo, g_band.device)
    cols = _valid_taps(w, k, lo, g_band.device)
    inv = 1.0 / (rows[:, None] * cols[None, :])
    z = (g_smooth.to(gb.dtype) - gb) * inv[None, :, :, None]
    zp = torch.nn.functional.pad(z, (0, 0, k - 1 - lo, lo, k - 1 - lo, lo))
    acc = torch.zeros_like(gb)
    for dy in range(k):
        for dx in range(k):
            acc = acc + zp[:, dy:dy + h, dx:dx + w, :]
    return (gb + acc).to(g_band.dtype)


def bwd_tile_plan(b: int, h: int, w: int, c: int, k: int,
                  dtype: torch.dtype) -> dict:
    """The backward kernel's tile for a [b, h, w, c] grad in ``dtype``
    with window ``k``: a mirror of ``bwd_plan`` in ``csrc/band_smooth.cu``,
    which ``chip_smoke.py`` holds against what the built library reports.
    A block owns ``tile_h`` rows × ``tile_w`` pixels × all c channels with
    ``threads_x`` = tile_w·c/V threads across a row (V channels each: 16
    bytes, or fewer for a ragged C) and ``threads_y`` down; it stages
    float32 z of the tile and its k − 1 halo and the tile's own g_band,
    ``smem_bytes``;
    ``tiles`` counts them along W, H and B (the kernel's persistent
    blocks walk them in that order). tile_w aims at 128 vectors per row;
    tile_h and then tile_w halve until the stage fits
    ``SHARED_MEMORY_LIMIT``. V is :func:`channels_per_thread`; a C of
    more than ``BWD_THREADS`` V-channel vectors runs as slices of that
    many, a launch each, and the plan is the first slice's. Raises
    ValueError where no tile fits."""
    if min(c, h, w, k) < 1:
        raise ValueError(f"band_smooth_bwd kernel takes a non-empty image, "
                         f"got {(b, h, w, c)} with k={k}")
    elt = torch.tensor([], dtype=dtype).element_size()
    vec = channels_per_thread(c, dtype)
    c = min(c, BWD_THREADS * vec)
    cv = c // vec
    tw, th = max(1, min(w, BWD_ROW_VECTORS // cv)), None
    while True:
        bdx = tw * cv
        bdy = max(1, min(BWD_THREADS // bdx, h))
        if th is None:
            th = max(1, min(h, bdy * BWD_ROWS_PER_THREAD))
        smem = 4 * (th + k - 1) * (tw + k - 1) * c + elt * th * tw * c
        if smem <= SHARED_MEMORY_LIMIT:
            return dict(tile_w=tw, tile_h=th, threads_x=bdx, threads_y=bdy,
                        smem_bytes=smem,
                        tiles=(-(-w // tw), -(-h // th), b))
        if th > 1:
            th = (th + 1) // 2
        elif tw > 1:
            tw = (tw + 1) // 2
        else:
            raise ValueError(f"band_smooth_bwd: no tile fits "
                             f"{SHARED_MEMORY_LIMIT} B for C={c}, k={k}")


def band_smooth_bwd(g_band: torch.Tensor, g_smooth: torch.Tensor,
                    kernel_size: int = 2) -> torch.Tensor:
    """Gradient of :func:`band_smooth` with respect to x, [B, H, W, C] in
    the grads' dtype. The grads are made contiguous in NHWC first: the
    model's permuted views can hand them over in another layout, and each
    such copy is counted in ``bwd_grad_copies``."""
    global bwd_launches, bwd_grad_copies
    if g_band.shape != g_smooth.shape or g_band.ndim != 4:
        raise ValueError(f"band_smooth_bwd takes two [B, H, W, C] grads, "
                         f"got {tuple(g_band.shape)} and "
                         f"{tuple(g_smooth.shape)}")
    if g_band.device.type == "cpu":
        return band_smooth_bwd_plain(g_band, g_smooth, kernel_size)
    if g_band.device.type != "cuda":
        raise ValueError(f"band_smooth_bwd: unsupported device "
                         f"{g_band.device}")
    if g_smooth.dtype != g_band.dtype or g_smooth.device != g_band.device:
        raise TypeError("band_smooth_bwd: grads differ in dtype or device")
    _check(g_band, "band_smooth_bwd")
    b, h, w, c = g_band.shape
    gb, gs = g_band.contiguous(), g_smooth.contiguous()
    dx = torch.empty_like(gb)
    if gb.numel() == 0:
        return dx
    bwd_grad_copies += (gb is not g_band) + (gs is not g_smooth)
    lib = cuda_build.library()
    with torch.cuda.device(gb.device):
        stream = torch.cuda.current_stream(gb.device).cuda_stream
        rc = lib.bid_band_smooth_bwd(
            gb.data_ptr(), gs.data_ptr(), dx.data_ptr(), b, h, w, c,
            int(kernel_size), _DTYPE_CODES[gb.dtype], stream)
    cuda_build.check(lib, rc, "band_smooth_bwd kernel")
    bwd_launches += 1
    if benchmarking.byte_counters:
        benchmarking.add_kernel_bytes(benchmarking.band_bytes(
            b, h, w, c, gb.dtype))
    return dx


class _BandSmooth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel_size):
        ctx.kernel_size = kernel_size
        return band_smooth_forward(x, kernel_size)

    @staticmethod
    def backward(ctx, g_band, g_smooth):
        return band_smooth_bwd(g_band, g_smooth, ctx.kernel_size), None

    @staticmethod
    def jvp(ctx, x_t, _):
        # linear: the tangents are the split of the tangent, the forward
        # kernel again
        return band_smooth_forward(x_t, ctx.kernel_size)


def band_smooth(x: torch.Tensor,
                kernel_size: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, H, W, C] → (band, smooth), both [B, H, W, C] in x's dtype;
    differentiable in reverse mode (the backward kernel) and in forward
    mode (the forward kernel on the tangent)."""
    if x.ndim != 4:
        raise ValueError(f"band_smooth takes [B, H, W, C], got {x.shape}")
    return _BandSmooth.apply(x, int(kernel_size))


def band_split_plain(x: torch.Tensor,
                     kernel_size: int = 2) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Plain PyTorch version of the split kernel: :func:`band_smooth_plain`
    (the same tap order) and the smooth's even rows and columns."""
    band, smooth = band_smooth_plain(x, kernel_size)
    return band, smooth[:, ::2, ::2, :].contiguous()


def split_tile_plan(b: int, h: int, w: int, c: int, k: int,
                    dtype: torch.dtype) -> dict:
    """The split kernel's tile for a [b, h, w, c] input in ``dtype`` with
    window ``k``: a mirror of ``split_plan`` in ``csrc/band_smooth.cu``,
    which ``chip_smoke.py`` holds against what the built library reports.
    A block owns ``tile_h`` rows × ``tile_w`` pixels × all c channels (both
    even) with ``threads_x`` = tile_w/2·c/V threads across (one vector of
    V channels of one 2×2 quad column each) and ``threads_y`` down, each
    owning up to SPLIT_QUAD_ROWS quads of its column; it stages
    SPLIT_STAGES tiles with their k − 1 halo, each in two planes (the even
    and the odd staged columns), ``smem_bytes``; ``tiles`` counts them
    along W, H and B. tile_w aims at SPLIT_ROW_VECTORS vectors per row;
    tile_h and then tile_w halve, by whole quads, until the stages fit
    ``SHARED_MEMORY_LIMIT``. V is :func:`channels_per_thread`; a C of
    more than ``SPLIT_THREADS`` V-channel vectors runs as slices of that
    many, a launch each, and the plan is the first slice's. Raises
    ValueError for odd or empty h or w, or where no tile fits."""
    if c < 1 or k < 1 or min(h, w) < 2 or h % 2 or w % 2:
        raise ValueError(f"band_split kernel takes even h, w >= 2, got "
                         f"{(b, h, w, c)} with k={k}")
    elt = torch.tensor([], dtype=dtype).element_size()
    vec = channels_per_thread(c, dtype)
    c = min(c, SPLIT_THREADS * vec)
    cv = c // vec
    quads, rows = max(1, min(w // 2, SPLIT_ROW_VECTORS // (2 * cv))), None
    while True:
        bdx = quads * cv
        bdy = max(1, min(SPLIT_THREADS // bdx,
                         -(-(h // 2) // SPLIT_QUAD_ROWS)))
        if rows is None:
            rows = max(1, min(h // 2, bdy * SPLIT_QUAD_ROWS))
        smem = (SPLIT_STAGES * 2 * (2 * rows + k - 1)
                * ((2 * quads + k) // 2) * c * elt)
        if smem <= SHARED_MEMORY_LIMIT:
            tw, th = 2 * quads, 2 * rows
            return dict(tile_w=tw, tile_h=th, threads_x=bdx, threads_y=bdy,
                        smem_bytes=smem,
                        tiles=(-(-w // tw), -(-h // th), b))
        if rows > 1:
            rows = (rows + 1) // 2
        elif quads > 1:
            quads = (quads + 1) // 2
        else:
            raise ValueError(f"band_split: no tile fits "
                             f"{SHARED_MEMORY_LIMIT} B for C={c}, k={k}")


def band_split(x: torch.Tensor,
               kernel_size: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, H, W, C] with H and W even → (band [B, H, W, C], down
    [B, H/2, W/2, C]) in x's dtype. Forward only: raises for a tensor
    that wants a gradient (use :func:`band_smooth` to differentiate)."""
    global split_launches
    if x.ndim != 4:
        raise ValueError(f"band_split takes [B, H, W, C], got {x.shape}")
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError("H and W must be even for the 2x downsample")
    if (torch.is_grad_enabled() and x.requires_grad) or has_tangent(x):
        raise RuntimeError("band_split has no backward and no forward-mode "
                           "derivative (neither has the JAX kernel); use "
                           "band_smooth where a gradient or a tangent is "
                           "wanted")
    if x.device.type == "cpu":
        return band_split_plain(x, kernel_size)
    if x.device.type != "cuda":
        raise ValueError(f"band_split: unsupported device {x.device}")
    _check(x, "band_split")
    x = x.contiguous()
    band = torch.empty_like(x)
    down = torch.empty((b, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return band, down
    lib = cuda_build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.bid_band_split(
            x.data_ptr(), band.data_ptr(), down.data_ptr(),
            b, h, w, c, int(kernel_size), _DTYPE_CODES[x.dtype], stream)
    cuda_build.check(lib, rc, "band_split kernel")
    split_launches += 1
    if benchmarking.byte_counters:
        benchmarking.add_kernel_bytes(benchmarking.band_bytes(
            b, h, w, c, x.dtype, split=True))
    return band, down
