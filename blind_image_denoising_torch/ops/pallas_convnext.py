"""One ConvNext residual unit at inference, fused into one kernel:

    t   = LayerNorm(depthwise_KxK(x))      # f32 statistics, eps 1e-3, scale only
    h   = leaky_relu(W2 · t, 0.1)          # 1×1, C → E = 4C
    p   = W3 · h                           # 1×1, E → C
    out = x + gain · p                     # gain = tanh(relu(1 + w)), + skip

Counterpart of ``blind_image_denoising_tpu/ops/pallas_convnext.py``
``fused_convnext_block`` (Pallas body ``_block_kernel``) in both of its
I/O modes, and of its oracle ``convnext_block_reference``. The packaged
flagship runs it 10 times per forward: at (C, K) = (32, 3) four times at
full resolution and (64, 5) six times at half resolution;
``unet_laplacian_v6`` runs it at (32, 5) and (64, 5), 12 times, and its
fused int8 serving path (``inference/fused.py``) runs the int8 mode (18
times with a depth-4 config and ``fused_levels=(0, 1, 2)``, 6 of them
at (128, 5)); ``unet_laplacian_v3`` and ``_v4`` run it 18 times, 3 each
at (32, 5), (64, 5), (128, 5) and their decoders' (128, 1), (64, 1) and
(32, 1), and ``_v5`` 12 times (its level 2 is its attention level). At
K = 1 the halo is empty (PAD = 0) and the depthwise sum is one tap per
channel; the tile, copy and depthwise code is written in PAD and K,
unchanged.

What is built: every shape JAX's kernel takes (any C, any odd K = 2·pad
+ 1, any E), in every I/O mode (:func:`kernel_supports`). Every C from 1
to 1024 at K = 1, 3, 5 and 7 with E = 4C runs in one pass (the layouts
below); every other shape runs the general route (:func:`runs_general`,
below). Twelve (C, K) have instantiations of their own
(``OWN_SHAPES``: the seven above, (64, 3), (128, 3), and K = 7 at C =
32, 64, 128); any other C up to 128 runs the layout of width C rounded
up to 16 (16, 32, ..., 128: the layouts below written for any multiple
of 16, ``csrc/convnext_class.cuh``), so a unit does about C channels of
depthwise and C' x 4C' of each product, C' = :func:`class_width`; up to
256 the wide class of width 256 (``csrc/convnext_wide.cu``); from
``CLUSTER_FROM`` (257) on a thread-block cluster of ceil(C / 128) blocks
runs the unit (``csrc/convnext_cluster.cuh``, below). A class's padded
channels have zero weights (:func:`kernel_operands` pads them: to the
layout's width, and on the cluster route to the next multiple of 128;
a model's unit prepares them once, ``ConvNextBlock.kernel_operands``,
and hands them to :func:`convnext_block` as ``operands``), its
LayerNorm statistics are taken over the true C, and its tile and output
move in 16-byte units wherever a pixel's row, or the contiguous run of a
tile row's pixels, allows. A depth-5 ``unet_laplacian_v6`` fused to
level 3 runs (256, 5); one with ``filters_level_multiplier`` 1.5 runs
(48, 5), (72, 5) and (108, 5) (the layouts of width 48, 80, 112); one
without self-attention runs (512, 5) at level 4, and at depth 6
(1024, 5) at level 5, and at depth 7 (2048, 5) at level 6, on the
general route; a ``v6`` whose kernel sizes are 7 runs (32, 7) and (64, 7).
An even K raises ``ValueError`` on every device (JAX's kernel has K =
2·pad + 1).

CUDA kernel (``csrc/convnext_block.cu``). Per pixel the unit does about
2K²C + 16C² operations against 2·C·bytes of I/O: ≈ 17 k operations per
128 B at (32, 3) in bf16 and ≈ 69 k per 256 B at (64, 5), so it sits
below or near the H100's 295 operations-per-byte ridge only if the two
1×1 products run on the tensor cores. By that count the bf16 mode is
bound by its bytes, the int8 mode by its CUDA-core operations and the
float32 mode by the three TF32 passes of its products (below); on the
card the bf16 and int8 kernel is bound by its instruction count against
the warp schedulers' rate, about half of it the depthwise sum's (PERF.md
has the split). Design of the bf16 and int8 modes:
* a block owns a tile of 8 × 32 output pixels of one image and walks
  over tiles (persistent blocks), so W2, W3 and the depthwise weights
  are staged into shared memory once per block (64 KB of bf16 at
  C = 64, above the 48 KB default, hence the dynamic shared-memory
  attribute);
* the input tile plus its (K−1)/2 halo arrives by 16-byte ``cp.async``
  copies that write zeros outside the image (SAME padding on all four
  borders); the copies of the next tile are in flight while this one
  is computed (two tile buffers in bf16, a staging buffer of codes in
  int8);
* depthwise and LayerNorm: a thread owns 8 channels of 4 neighbouring
  pixels of a row, loads each tap row's weights and inputs once and
  sums from registers in float32; the C/8 lanes of a pixel share the
  LayerNorm's two-pass statistics by shuffles and store ``t`` as bf16;
* each warp then runs the two products for 16 pixels at a time with
  ``mma.sync`` m16n8k16 (bf16 operands, float32 accumulation, fragments
  loaded by ``ldmatrix``); the expansion's accumulators become the
  projection's A operand in registers, so ``h`` never leaves the
  registers;
* the warp adds ``x + gain·p`` in float32 and writes its 16 pixels with
  16-byte stores: two block barriers per tile (three in int8);
* 256 threads and two blocks per SM at C = 32, one block of 512 threads
  at C = 64, where the tile is stored unpadded and XOR-swizzled so that
  two buffers fit; :func:`kernel_plan` mirrors the threads and
  shared-memory bytes of every instantiation.
At C = 128 the bf16 W2 and W3 alone (272,384 B; 524,288 B in float32)
exceed the 232,448 B a block may have, so they are not staged once per
block: they stream through a ring of three or four shared-memory stages
in chunks of ``STREAM_CHUNK`` E channels (W2's rows and the matching
columns of W3; ``STREAM_CHUNK_SMALL`` where three of those do not fit).
:func:`kernel_operands` lays each chunk out as its stage holds it
(:func:`chunk_images`), so one thread copies a chunk as bulk copies
(``cp.async.bulk``) that complete on the stage's ``mbarrier``; two blocks
on neighbouring tiles form a thread-block cluster, each copying half of
every chunk multicast into both, and a stage is refilled once every warp
of both has released it (``csrc/chunk_ring.cuh``). Each chunk's expansion
feeds the projection's accumulators in registers, so ``h`` still never
leaves them; the projection's accumulators of 16 pixels × 128 channels
(64 a lane) and the tile's A fragments stay in registers over a tile's
chunks, which run on into the next tile's. The tile shrinks to 8 × 16
pixels with 256 threads (one m16 tile a warp, one block an SM). The
LayerNorm's statistics are shuffles over the 16 lanes of a pixel. At
C = 128 the unit does 512 operations a byte of bf16 I/O, above the card's
ridge: it is bound by its products, which ``mma.sync`` runs at about 2/3
of the tensor cores' dense rate. The wide class (128 < C <= 256) takes
tiles of 8 × 8 pixels and chunks of ``WIDE_CHUNK``: the projection's
accumulators of 16 pixels × 256 channels would be 128 registers a lane,
so two warps share an m16 tile, 128 output channels each; each computes
half of a chunk's expansion and hands its ``h`` to the other through
shared memory. Its float32 mode, and every mode at K = 7, keeps ``t`` in
shared memory and runs the depthwise by groups of 64 channels, each
group's input and depthwise weights in a slot that shares its room with
the ring (the cluster's blocks meet before a tile's chunks). At K = 7
(halo 3 a side) the layouts stay where they fit: bf16 (64, 7) and
(128, 7) keep one tile buffer, f32 (64, 7) streams W2 and W3 as C = 128
does and f32 (128, 7) lends its tile buffer's room to the ring from the
depthwise to the epilogue. (32, 7) of its own runs two blocks an SM in
bf16 (one tile buffer, as (64, 7)) and int8; in bf16 the three of their
own move each warp's residual into its ``t`` rows, so that the next tile
is copied under the products. The bf16 depthwise of (32, 7), (64, 7)
and (128, 7) gives a thread 4 channels of two rows of 4 pixels, so that
each input row is loaded and converted once for both output rows and
each tap row's weights once for both.
From ``CLUSTER_FROM`` (257) on a thread-block cluster of
n = ceil(C / 128) blocks (3 to 8) owns a tile of 64 pixels (float32:
32):
block r owns output channels 128r .. 128r + 127 and E channels 512r ..
512r + 511 and streams only 1/n of W2 and W3 a tile. Block r stages the
halo of its 128 channels and sums their depthwise; the LayerNorm's
partial sums and centred squares of the n blocks meet through
distributed shared memory (DSMEM) in rank order, and each block writes
its slice of ``t`` into every block's ``t`` tile. The expansion of the
block's 512 E channels runs once a tile, each warp 64 of them over all
the tile's m16 tiles, W2 streamed by columns of ``t``; ``h`` takes
``t``'s room, and after one cluster barrier each warp reads every
block's ``h`` through DSMEM against W3's rows of its 64 output channels
(float32: 32), W3 streamed by columns of ``h``. W2's and W3's items share one ring of three
``mbarrier`` slots (float32: two) fed by ``cp.async``. The kernel takes
every C above 128; at C = 256 it measured slower than the one-block
class of width 256, which keeps those widths (PERF.md §6). Its float32
mode keeps ``t``, ``h`` and the weights in float32 and runs the products
as 3xTF32 (below) over tiles of 32 pixels, the largest whose ``t`` tile
and two ring slots fit at C = 1024 (230,688 B), each W2 or W3 item's
products summed on their own and added to the running sums rounded to
nearest (one chain of 1,536 products an output left 2e-5 of max |out|
at C = 1024).
:func:`kernel_plan` mirrors each layout.
In float32 mode (``dtype="float32"`` serving and export, the f32
forwards of v3 / v4 / v5, the analysis tools) the result keeps float32
accuracy while the two products, 95% of the operations, run on the
tensor cores as error-compensated 3xTF32: each operand is split into a
TF32 ``big`` and the remainder ``small``, and each product sums
small·big + big·small + big·big with ``mma.sync`` m16n8k8 (float32
accumulation). One TF32 pass would miss the 1e-3 bar (6e-3 on the
flagship's units); three land near 1e-6 of max |out|. So its bound is
three times the products over the TF32 rate, beside the other
operations on the CUDA cores and the bytes. Tiles of 8 × 16 pixels, a
warp per row: a lane holds two pixels' channels ``16i + 4q .. + 3``,
which are its A fragment of the expansion as they stand (the products'
k order is free); the depthwise reuses each tap row's loads over both
pixels, the LayerNorm's statistics are shuffles over four lanes, and
``h`` goes from the expansion's accumulators to the projection in
registers (W3's E index is permuted as [0,2,4,6,1,3,5,7] within each 8
when staged). The f32 W2 and W3 stay in shared memory in fragment order
and are split as they are loaded. Two tile buffers at C = 32 (two
blocks of 8 warps an SM) and at (64, 1); at (64, 5) the f32 weights
leave room for one, refilled while the products run; at C = 128 the
f32 chunks arrive in fragment order (a lane's B operands of two k-steps
of one n8 tile are one 16-byte vector; :func:`chunk_images`), the
residual ``x`` is read back from device memory rather than kept in
registers, and (128, 5) has one tile buffer, refilled once every
depthwise is done. In int8 mode
(``x`` int8 with
``scale_in`` and ``scale_out``) only int8 codes touch device memory: the
codes are dequantized into the bf16 shared tile as
``bf16(q · bf16(scale_in))``, the unit runs the bf16 path above, and the
epilogue writes
``clip(round_half_even((x + gain·p) · f32(1/scale_out)), ±127)``. The
JAX kernel's padded-row channels-first layout and column masks served
the TPU's lane tiling and are not carried over.

The general route (``csrc/convnext_general.cuh``: C above 1024, K = 9,
11, ..., E other than 4C): the unit's weights and its t and h rows no
longer fit one block or one cluster, so it runs as three kernels, t
[P', C'] and h [P', E'] through scratch in device memory that the wrapper
allocates (as much as the library's
``bid_convnext_general_scratch_bytes`` says: P rounded up to the
products' tile of 64 pixels, C and E to 32, the pads zeros): the
depthwise + LayerNorm (a warp a pixel up to C = 1024, else a
block, striding over C; f32 two-pass statistics), then the expansion
and the projection as tiled products on ``mma.sync`` (bf16 operands, or
3xTF32 in float32) fed by ``cp.async`` in two stages, each stage's
products added to the running sums with one rounded f32 add; the
projection's epilogue adds x (and requantizes in int8) at the plain
version's rounding points. Its operands are the weights as they lie
(:func:`kernel_operands`: dw [K², C] and the LayerNorm scale and gain in
float32, W2 [E, C] and W3 [C, E] in the I/O dtype, bf16 in int8), its
plan :func:`general_plan`.

``convnext_block`` takes NHWC tensors like the JAX oracle. A tensor on
the CPU goes through :func:`convnext_block_plain`, the same arithmetic
and rounding points in plain PyTorch; a CUDA tensor launches the kernel
or raises.
"""

import collections

import torch
import torch.nn.functional as F

from .. import benchmarking
from ..constants import DEFAULT_LN_EPSILON
from . import cuda_build
from .precision import has_tangent

# kernel launches made by convnext_block in float mode and in int8 mode
# (the plain path does not count), the same launches by (dtype name, C,
# K), and the ConvNext units outside the kernel's shapes and options that
# ran their PyTorch branch in a forward instead (layers/convnext.py
# ConvNextBlock.forward)
launches = 0
int8_launches = 0
shape_launches = collections.Counter()
branch_units = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# (C, K) with instantiations of their own in csrc/convnext_block.cu, every
# mode, E = 4C: the units of the packaged and family models (K = 1: the
# decoders of unet_laplacian_v3, _v4 and _v5), K = 3 at C = 64, 128, and
# K = 7 (the flax ConvNext layer's default) at C = 32, 64, 128
OWN_SHAPES = frozenset({(32, 1), (32, 3), (32, 5), (32, 7), (64, 1),
                        (64, 3), (64, 5), (64, 7), (128, 1), (128, 3),
                        (128, 5), (128, 7)})
# the one-pass layouts take every C from 1 to ONE_PASS_MAX_CHANNELS at
# these K, with E = 4C (a C outside OWN_SHAPES runs the layout of width
# class_width(C)); every other shape the kernel takes runs the general route
KERNEL_KS = (1, 3, 5, 7)
ONE_PASS_MAX_CHANNELS = 1024
# from CLUSTER_FROM on a thread-block cluster runs the unit
# (csrc/convnext_cluster.cuh; convnext_block.cu's kClusterFrom), each
# block owning CLUSTER_SLICE output channels: its width is the next
# multiple of CLUSTER_SLICE; up to 128 the layouts of C rounded up to
# CLASS_STEP (csrc/convnext_class.cuh's class_width); above, the wide class
# of width WIDE_WIDTH
CLUSTER_FROM = 257
CLUSTER_SLICE = 128
CLASS_STEP = 16
WIDE_WIDTH = 256
# layout widths float32 does not build (csrc/convnext_class.cuh
# built_width: its width-112 layout spilled at 255 registers), which run
# the next width
F32_UNBUILT_WIDTHS = (112,)
# a named sample of what the kernel takes: the twelve of their own and each
# class at widths that are and are not multiples of 16 (odd ones included):
# every layout width up to 128 (16, 32, 48, 64, 80, 96, 112, 128) and the
# ragged edge of each; the tests and chip_smoke.py's build check sweep it
SAMPLE_SHAPES = tuple(sorted(OWN_SHAPES | {
    (c, k) for c in (1, 7, 8, 24, 48, 72, 108, 128, 144, 162, 200, 256, 300,
                     384, 512, 520, 640, 768, 1000, 1024, 16, 40, 80, 88, 96,
                     100, 112, 120)
    for k in KERNEL_KS}))
# the streamed layouts' weight ring (csrc/chunk_ring.cuh): clusters of
# RING_CLUSTER blocks, up to RING_STAGES stages (at least three), whose
# mbarriers take RING_BARS bytes; Cfg's chunks of STREAM_CHUNK E channels
# (STREAM_CHUNK_SMALL where three of those do not fit), the wide class's
# of WIDE_CHUNK
RING_CLUSTER = 2
RING_STAGES = 4
RING_BARS = 16 * RING_STAGES
STREAM_CHUNK = 32
STREAM_CHUNK_SMALL = 16
WIDE_CHUNK = 16
# the wide class's depthwise channel groups (csrc/convnext_wide.cuh GC)
WIDE_GROUP = 64
INT8_MAX = 127
# the general route (csrc/convnext_general.cuh): 256 threads a block; its
# products' tiles of 64 x 128 outputs in two stages of 192 rows of 80
# bytes; its depthwise + LayerNorm pass's block reduction, within the
# default dynamic shared memory of a block
GENERAL_THREADS = 256
GENERAL_GEMM_SMEM = 2 * (64 + 128) * 80
GENERAL_REDUCE = 32
DEFAULT_SHARED_MEMORY = 48 * 1024
# a named sample of the general route's shapes (C, K, E): above C = 1024
# (ragged and whole), K = 9 and 11 (C = 1, 32), E = 2C and 3C; the card
# tests and chip_smoke.py's build check sweep it
GENERAL_SAMPLE_SHAPES = ((1025, 5, 4100), (1040, 5, 4160), (1536, 5, 6144),
                         (2048, 5, 8192), (4096, 1, 16384), (1, 9, 4),
                         (1, 11, 4), (32, 9, 128), (32, 11, 128),
                         (48, 5, 96), (48, 5, 144))
# dynamic shared memory one block may have on an H100, one SM's, and what a
# resident block takes of it for itself
SHARED_MEMORY_LIMIT = 232_448
SM_SHARED_MEMORY = 233_472
BLOCK_RESERVED_SHARED_MEMORY = 1024


def kernel_supports(c: int, k: int, e: int = None) -> bool:
    """Whether the kernel takes a unit of C channels, K x K depthwise and
    (if given) E expansion channels: as JAX's kernel, every C >= 1, odd K
    >= 1 (K = 2·pad + 1) and E >= 1."""
    return c >= 1 and k >= 1 and k % 2 == 1 and (e is None or e >= 1)


def runs_general(c: int, k: int = None, e: int = None) -> bool:
    """Whether the general route runs a unit of C channels (at K and with
    E expansion channels, where given): every shape off the one-pass
    layouts' (C up to ``ONE_PASS_MAX_CHANNELS`` at K in ``KERNEL_KS`` with
    E = 4C), as ``convnext_block.cu``'s dispatcher decides."""
    return (c > ONE_PASS_MAX_CHANNELS
            or (k is not None and k not in KERNEL_KS)
            or (e is not None and e != 4 * c))


def class_width(c: int, dtype: torch.dtype = None, k: int = None,
                e: int = None) -> int:
    """The width of the layout that runs C channels (at K and with E
    expansion channels, where given) in I/O ``dtype``: on the general
    route C itself; on the cluster route (``runs_cluster``) the next
    multiple of ``CLUSTER_SLICE``, above 128 ``WIDE_WIDTH``, else C rounded
    up to ``CLASS_STEP`` (``OWN_SHAPES`` are their own width), but float32
    keeps 128 where that is 112 (``F32_UNBUILT_WIDTHS``): the channels the
    weights are padded to, which the library reports as an
    instantiation's width."""
    if runs_general(c, k, e):
        return c
    if runs_cluster(c):
        return -(-c // CLUSTER_SLICE) * CLUSTER_SLICE
    if c > 128:
        return WIDE_WIDTH
    width = -(-c // CLASS_STEP) * CLASS_STEP
    if dtype == torch.float32 and width in F32_UNBUILT_WIDTHS:
        return width + CLASS_STEP
    return width


def _align16(n):
    return (n + 15) // 16 * 16


def kernel_plan(c: int, k: int, dtype: torch.dtype, e: int = None) -> dict:
    """Threads per block, dynamic shared-memory bytes and cluster size of
    the kernel that runs (C, K, dtype), and, up to C = 128, the blocks an
    SM its registers are capped for (``min_blocks_per_sm``, its
    ``__launch_bounds__``); a layout that streams W2 and W3 through a ring
    of bulk copies also names its stages and the E channels of a chunk
    (``ring_stages``, ``chunk_channels``; its cluster is
    ``RING_CLUSTER``): a mirror of ``Cfg`` in
    ``csrc/convnext_block.cuh`` (C up to 128, laid out at its class's
    width), of ``WCfg`` in ``csrc/convnext_wide.cuh`` (128 < C <= 256) and
    of ``clayout`` in ``csrc/convnext_cluster.cuh`` (from ``CLUSTER_FROM``
    on), and of the general route (``general_plan``), which
    ``chip_smoke.py`` holds against what the built library reports. Raises
    ``ValueError`` where the kernel does not take the unit (an even K)."""
    if not kernel_supports(c, k, e):
        raise ValueError(
            f"convnext_block kernel does not take C={c} K={k} E={e}")
    if runs_general(c, k, e):
        return general_plan(c)
    if runs_cluster(c):
        return cluster_plan(c, k, dtype)
    plan = _layout(c, k, dtype)
    keys = ("threads_per_block", "smem_bytes", "cluster_size")
    keys += ("min_blocks_per_sm",) if class_width(c, dtype) <= 128 else ()
    if plan["ring_stages"]:
        keys += ("ring_stages", "chunk_channels")
    return {key: plan[key] for key in keys}


def _layout(c: int, k: int, dtype: torch.dtype) -> dict:
    """The layout of the one-block kernel (C up to 256) that runs (C, K,
    dtype), as ``kernel_plan`` names it, and how a streamed layout's
    chunks lie (``ring_stages`` 0 where W2 and W3 are resident):
    ``chunk_channels`` (ECH), ``order`` ("rows": W2 [ECH][C' + pad] and W3
    [C'][ECH + pad], "fragments": both in the f32 fragment order of
    ``_fragment_chunks``), the rows' pads and each part's elements."""
    ragged = (c, k) not in OWN_SHAPES
    c = class_width(c, dtype)
    if c > 128:
        return _wide_layout(k, dtype)
    mma, int8 = dtype != torch.float32, dtype == torch.int8
    e, pad, elt = 4 * c, k // 2, 2 if mma else 4
    # one block of 512 threads on 8 x 32 tiles in bf16 at C = 64 and (48,
    # 7); tiles of 8 x 32 at C <= 32, else 8 x 16
    block512 = mma and (c == 64 or (c == 48 and k == 7))
    th, tw = 8, 32 if mma and (c <= 32 or block512) else 16
    ih, iw = th + 2 * pad, tw + 2 * pad
    # tile rows unpadded (swizzled) at C = 64, 128 in bf16, else padded by 8
    ldx = c if mma and c % 64 == 0 else c + 8
    xbuf = elt * ih * iw * ldx
    off_x = _align16(4 * k * k * c)                       # depthwise weights
    off_x = _align16(_align16(off_x + 4 * c) + 4 * c)     # LN scale, gain
    t_tile = 2 * th * tw * (c + 8) if mma else 0          # t / output tile
    # int8 stages its codes: a ragged layout the tile's rows as they lie in
    # device memory (a row's run from the 16-byte boundary before it)
    stage = (0 if not int8 else ih * _align16(iw * c + 15) if ragged
             else ih * iw * c)

    def chunk_bytes(ech):
        # W2 [ECH][C] and W3 [C][ECH] (bf16 rows padded by 8; f32 packed)
        return (_align16(2 * ech * (c + 8)) + _align16(2 * c * (ech + 8))
                if mma else 2 * _align16(4 * ech * c))

    # W2 and W3 stream through a ring of E chunks where their bf16 padded
    # rows take more than half of a block's shared memory (C >= 96) and in
    # f32 where the resident ones do not fit beside one tile
    stream = (chunk_bytes(e) > SHARED_MEMORY_LIMIT // 2 if mma
              else off_x + xbuf + chunk_bytes(e) > SHARED_MEMORY_LIMIT)

    def three_fit(ech):
        return (off_x + xbuf + stage + t_tile + 3 * chunk_bytes(ech)
                + RING_BARS <= SHARED_MEMORY_LIMIT)

    # chunks of 32 where three fit, else 16; f32 where three of 16 do not
    # fit either ((128, 7)) the ring takes the tile buffer's room
    ring_in_x = stream and not mma and not three_fit(STREAM_CHUNK_SMALL)
    ech = (STREAM_CHUNK_SMALL if stream and not ring_in_x
           and not three_fit(STREAM_CHUNK) else STREAM_CHUNK)
    wbuf = chunk_bytes(ech if stream else e)
    bars = RING_BARS if stream else 0
    # (32, 7) of its own runs two blocks an SM: bf16 with one tile buffer
    two_blocks7 = mma and not ragged and (c, k) == (32, 7)
    # int8 one tile buffer (and its staged codes); bf16 and f32 two where
    # they fit beside the weights (streamed: beside three stages)
    buffers = (1 if int8 or ring_in_x or two_blocks7 else 2 if off_x + 2 * xbuf
               + (3 if stream else 1) * wbuf + t_tile + bars
               <= SHARED_MEMORY_LIMIT else 1)
    off_w2 = (off_x if ring_in_x
              else _align16(_align16(off_x + buffers * xbuf) + stage))
    stages = 0
    if stream:
        # f32 parks t (C / 2 floats a thread) in the tile's room during the
        # products: with kRingInX after the ring's stages
        room = (xbuf - 4 * (32 * 8) * (c // 2) if ring_in_x
                else SHARED_MEMORY_LIMIT - off_w2 - t_tile - bars)
        stages = min(RING_STAGES, room // wbuf)
    off_t = (_align16(off_x + xbuf) if ring_in_x
             else off_w2 + max(stages, 1) * wbuf)
    smem = off_t + t_tile + bars
    # f32: a warp per tile row
    threads = 32 * th if not mma else 512 if block512 else 256
    # two blocks an SM wherever two fit with W2 and W3 resident at K < 7
    # and at (32, 7) of its own
    blocks = 2 if (k < 7 or two_blocks7) and not stream and 2 * (
        smem + BLOCK_RESERVED_SHARED_MEMORY) <= SM_SHARED_MEMORY else 1
    plan = dict(threads_per_block=threads, smem_bytes=smem,
                cluster_size=RING_CLUSTER if stream else 1,
                min_blocks_per_sm=blocks, ring_stages=stages,
                chunk_channels=ech if stream else 0, width=c)
    if stream:
        plan.update(order="rows" if mma else "fragments", w2_pad=8,
                    w3_pad=8)
    return plan


def _wide_layout(k: int, dtype: torch.dtype) -> dict:
    """``_layout`` of the wide class (width 256: 8 x 8 tiles, 256 threads,
    chunks of ``WIDE_CHUNK`` E channels, rows padded by 16 bytes in bf16,
    4 floats in f32). Whole-C tiles (bf16, int8 at K <= 5): the small
    weights, the input tiles, the ring's stages (W2 [ECH][C], W3 [C][ECH]),
    the t tile (int8 stages its codes there), two sets of the warps' h
    blocks [16][ECH], the ring's mbarriers. Grouped (K = 7, and f32 at
    every K): the LayerNorm scale and gain, t, the h blocks, then a region
    that holds the ring's stages or, before the products, the raw f32 sums
    [P][C + 4] (bf16, int8) and one or two group slots (a group's input in
    the I/O type and its depthwise weights), then the mbarriers."""
    mma, int8 = dtype != torch.float32, dtype == torch.int8
    c, pad, elt = WIDE_WIDTH, k // 2, 2 if mma else 4
    io = torch.tensor([], dtype=dtype).element_size()
    px = 8 * 8
    ih, iw = 8 + 2 * pad, 8 + 2 * pad
    ech, rowpad = WIDE_CHUNK, 8 if mma else 4
    grouped = k == 7 or not mma
    wbuf = (_align16(elt * ech * (c + rowpad))
            + _align16(elt * c * (ech + rowpad)))
    t_rows = elt * px * (c + rowpad)
    t_bytes = _align16(max(t_rows, ih * iw * c) if int8 and not grouped
                       else t_rows)
    h_bytes = 2 * elt * 16 * (ech + rowpad) * (px // 16)
    if grouped:
        off_u = _align16(_align16(_align16(4 * c) + 4 * c) + t_bytes
                         + h_bytes)
        room = SHARED_MEMORY_LIMIT - RING_BARS - off_u
        stages = min(RING_STAGES, room // wbuf)
        raw = 4 * px * (c + 4) if mma else 0
        slot = _align16(io * ih * iw * WIDE_GROUP) + 4 * k * k * WIDE_GROUP
        slots = 2 if raw + 2 * slot <= room else 1
        smem = off_u + max(stages * wbuf, raw + slots * slot) + RING_BARS
    else:
        xbuf = elt * ih * iw * c
        off_x = _align16(_align16(_align16(4 * k * k * c) + 4 * c) + 4 * c)
        rest = t_bytes + h_bytes + RING_BARS
        buffers = (1 if int8 else 2 if off_x + 2 * xbuf + 3 * wbuf + rest
                   <= SHARED_MEMORY_LIMIT else 1)
        off_w2 = _align16(off_x + buffers * xbuf)
        stages = min(RING_STAGES,
                     (SHARED_MEMORY_LIMIT - off_w2 - rest) // wbuf)
        smem = off_w2 + stages * wbuf + rest
    return dict(threads_per_block=256, smem_bytes=smem,
                cluster_size=RING_CLUSTER, ring_stages=stages,
                chunk_channels=ech, width=c, order="rows", w2_pad=rowpad,
                w3_pad=rowpad)


def _dwln_smem(c: int) -> int:
    """The general route's depthwise + LayerNorm pass's dynamic shared
    memory: a warp a pixel (8 a block) up to C = 1024, else the block (and
    its reduction's ``GENERAL_REDUCE`` bytes), each pixel's raw f32 sums
    where they fit within ``DEFAULT_SHARED_MEMORY`` (else recomputed)."""
    group = 32 if c <= ONE_PASS_MAX_CHANNELS else GENERAL_THREADS
    red = GENERAL_REDUCE if group == GENERAL_THREADS else 0
    rows = GENERAL_THREADS // group * c * 4
    return red + rows if red + rows <= DEFAULT_SHARED_MEMORY else red


def general_plan(c: int) -> dict:
    """``kernel_plan`` of the general route at C channels (any K, E and
    mode): its threads, the largest shared memory of its three kernels (the
    products' two stages, or the depthwise pass's raw sums), one block (no
    cluster); ``csrc/convnext_general.cuh``."""
    return dict(threads_per_block=GENERAL_THREADS,
                smem_bytes=max(GENERAL_GEMM_SMEM, _dwln_smem(c)),
                cluster_size=1)


def runs_cluster(c: int) -> bool:
    """Whether a thread-block cluster runs C channels: from
    ``CLUSTER_FROM`` on, as ``convnext_block.cu``'s ``kClusterFrom``."""
    return c >= CLUSTER_FROM


def cluster_layout(n: int, dtype: torch.dtype) -> tuple:
    """(pixels a tile, E columns a W2 item, E columns a W3 item, ring
    slots) of the cluster of n blocks in I/O ``dtype``
    (``csrc/convnext_cluster.cuh`` ``with_layout``; 8 warps): float32
    (32, 16, 64, 2); else (64, 32, 128, 3) for n <= 4, (64, 16, 64, 3)
    above."""
    if dtype == torch.float32:
        return 32, 16, 64, 2
    return (64, 32, 128, 3) if n <= 4 else (64, 16, 64, 3)


def cluster_plan(c: int, k: int, dtype: torch.dtype) -> dict:
    """``kernel_plan`` of the cluster that runs C channels at K (n =
    ceil(C / 128) blocks, C' = 128 n; ``CLayout``): 32 B of mbarriers, the
    LayerNorm's partial sums [2][M] f32, the ring's slots of the larger of
    a W2 item [512][KC + 8] and a W3 item [128][KC3 + 8], and one region
    for the staged halo of a block's 128 channels [M / 8 + K - 1][8 + K -
    1] in the I/O type, t [M][C' + 8] and h [M][512]; t, h and the weights
    in bf16 (float32 in float32)."""
    n = -(-c // CLUSTER_SLICE)
    m, kc, kc3, slots = cluster_layout(n, dtype)
    elt = 4 if dtype == torch.float32 else 2
    io = torch.tensor([], dtype=dtype).element_size()
    halo = (m // 8 + k - 1) * (8 + k - 1) * CLUSTER_SLICE * io
    slot = max(4 * CLUSTER_SLICE * (kc + 8), CLUSTER_SLICE * (kc3 + 8)) * elt
    region = max(m * (CLUSTER_SLICE * n + 8) * elt,
                 m * 4 * CLUSTER_SLICE * elt, halo)
    return dict(threads_per_block=256,
                smem_bytes=_align16(32 + 8 * m) + slots * slot + region,
                cluster_size=n)


def _round_bf16(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).float()


def _f32(v: float) -> float:
    """v rounded to float32, as a Python float."""
    return torch.tensor(float(v), dtype=torch.float32).item()


def int8_constants(scale_in: float, scale_out: float):
    """The int8 mode's two constants, as the JAX kernel rounds them:
    ``bf16(scale_in)`` (the dequantize multiplier) and ``f32(1/scale_out)``
    (the requantize multiplier: a multiply by the reciprocal, not a
    divide). The kernel and the plain version take the same values."""
    s_in = torch.tensor(float(scale_in), dtype=torch.bfloat16).item()
    return s_in, _f32(1.0 / float(scale_out))


def _quantize_f32(xf: torch.Tensor, inv_scale: float) -> torch.Tensor:
    q = torch.round(xf * inv_scale)               # half to even
    return torch.clamp(q, -INT8_MAX, INT8_MAX).to(torch.int8)


def quantize(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``round(f32(x) · f32(1/scale))`` clipped to ±127 (not −128), as
    int8: the counterpart of the JAX module's ``quantize_cf``, on a tensor
    of any layout (the port's are NHWC)."""
    return _quantize_f32(x.float(), _f32(1.0 / float(scale)))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it whose data starts on 16 bytes: the kernel
    moves x, W2 and W3 in 16-byte vectors."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def convnext_block_plain(x, dw, ln_scale, w2, w3, gain, slope: float = 0.1,
                         scale_in=None, scale_out=None, operands=None):
    """Plain PyTorch version of the kernel (``operands``, the kernel's
    prepared weights, is taken and not read, so that a caller of the
    wrapper can call this in its place). x: [B, H, W, C] float32,
    bfloat16, or int8 codes with ``scale_in``/``scale_out``. In bfloat16
    and int8 the products see bf16 operands (``t``, ``h`` and the weights
    rounded to bf16) with float32 sums, as the tensor cores do; int8 codes
    are dequantized to ``bf16(q · bf16(scale_in))`` first and the output
    is requantized with ``f32(1/scale_out)`` (the JAX kernel's rounding
    points); everything else is float32. Returns x's dtype."""
    b, h, w, c = x.shape
    k = dw.shape[-1]
    pad = k // 2
    int8 = x.dtype == torch.int8
    bf16 = int8 or x.dtype == torch.bfloat16
    if int8:
        s_in, inv_out = int8_constants(scale_in, scale_out)
        xf = _round_bf16(x.float() * s_in)
    else:
        xf = x.float()
    xp = F.pad(xf, (0, 0, pad, pad, pad, pad))
    dwf = dw.float().reshape(c, k, k)
    acc = torch.zeros_like(xf)
    for dy in range(k):
        for dx in range(k):
            acc = acc + xp[:, dy:dy + h, dx:dx + w, :] * dwf[:, dy, dx]
    mean = acc.mean(dim=-1, keepdim=True)
    cent = acc - mean
    var = (cent * cent).mean(dim=-1, keepdim=True)
    t = cent * torch.rsqrt(var + DEFAULT_LN_EPSILON) * ln_scale.float()
    w2f, w3f = w2.float(), w3.float()
    if bf16:
        t, w2f, w3f = _round_bf16(t), _round_bf16(w2f), _round_bf16(w3f)
    hid = F.leaky_relu(t @ w2f.t(), slope)
    if bf16:
        hid = _round_bf16(hid)
    p = hid @ w3f.t()
    out = xf + gain.float() * p
    if int8:
        return _quantize_f32(out, inv_out)
    return out.to(x.dtype)


def _pair(tile: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Column 2j + s of an m16n8k8 n8 tile pair (tile, n index n): the
    order in which a lane's B operands of two k-steps are one 16-byte
    vector of W2's or W3's rows (``csrc/convnext_block.cuh``
    ``expand_project_f32``)."""
    return 16 * (tile >> 1) + 4 * (n >> 1) + 2 * (tile & 1) + (n & 1)


def _chunk_positions(e: int, c: int, layout: dict) -> torch.Tensor:
    """Where each element of a streamed layout's chunk images comes from
    (:func:`chunk_images`): [NCH, chunk] positions in W2 [E', C'] and W3
    [C', E'] flattened one after the other, 2 E' C' for a pad (a zero)."""
    ech = layout["chunk_channels"]
    nch = e // ech
    n = e * c
    w2c = torch.arange(n).reshape(nch, ech, c)
    w3c = torch.arange(n, 2 * n).reshape(c, nch, ech).permute(1, 0, 2)
    if layout["order"] == "rows":
        w2c = F.pad(w2c, (0, layout["w2_pad"]), value=2 * n)
        w3c = F.pad(w3c, (0, layout["w3_pad"]), value=2 * n)
    else:
        i = torch.arange(ech * c // 4)
        lane, rest = i & 31, i >> 5
        g, q = lane >> 2, lane & 3
        four = torch.arange(4)
        row2 = _pair(rest // (c // 16), g)
        col2 = 16 * (rest % (c // 16)) + 4 * q
        row3 = _pair(rest % (c // 8), g)
        col3 = 16 * (rest // (c // 8)) + 4 * q
        w2c = w2c[:, row2[:, None], col2[:, None] + four]
        w3c = w3c[:, row3[:, None], col3[:, None] + four]
    return torch.cat([w2c.reshape(nch, -1), w3c.reshape(nch, -1)], dim=1)


# chunk positions by (E', C', layout, device), made once
_CHUNK_POSITIONS = {}


def chunk_images(w2: torch.Tensor, w3: torch.Tensor, layout: dict):
    """W2 [E', C'] and W3 [C', E'] (padded to the layout's width C') as a
    streamed layout's ring copies them (``_layout``): row c of the image
    is chunk c of ECH E channels, the bytes its stage holds (its W2 part,
    then its W3 part), so that a chunk is one contiguous range of device
    memory. ``order`` "rows": W2's rows c ECH .. + ECH - 1 [ECH][C' +
    w2_pad], then W3's columns of them [C'][ECH + w3_pad], the pads zero;
    "fragments" (f32 at C' <= 128): one 16-byte vector per lane (g = lane
    / 4, q = lane % 4) of 32, W2 vector (n, i) channels 16i + 4q .. + 3 of
    the chunk's E row ``_pair(n, g)``, then W3 vector (m, o) the chunk's E
    16m + 4q .. + 3 of output channel ``_pair(o, g)``. One gather over
    positions worked out once a layout and device. Returns [NCH, chunk] in
    the weights' dtype."""
    e, c = w2.shape
    key = (e, c, layout["chunk_channels"], layout["order"],
           layout["w2_pad"], layout["w3_pad"], w2.device)
    pos = _CHUNK_POSITIONS.get(key)
    if pos is None:
        pos = _chunk_positions(e, c, layout).to(w2.device)
        _CHUNK_POSITIONS[key] = pos
    src = torch.cat([w2.reshape(-1), w3.reshape(-1), w2.new_zeros(1)])
    return src[pos]


def _operand_shapes(c: int, k: int, dtype: torch.dtype, e: int,
                    general: bool = False) -> tuple:
    """The shapes of :func:`kernel_operands`' five tensors for a unit of C
    channels at K with E expansion channels run on x of ``dtype`` (on the
    general route where ``general``, whatever the shape)."""
    if general or runs_general(c, k, e):
        return (k * k, c), (c,), (e, c), (c, e), (c,)
    width = class_width(c, dtype)
    dw = (k * k, width) if runs_cluster(c) else (width, k * k)
    w2, w3 = (4 * width, width), (width, 4 * width)
    if not runs_cluster(c):
        lay = _layout(c, k, dtype)
        if lay["ring_stages"]:
            ech = lay["chunk_channels"]
            nch = 4 * width // ech
            if lay["order"] == "rows":
                w2 = w3 = (nch, ech * (width + lay["w2_pad"])
                           + width * (ech + lay["w3_pad"]))
            else:
                w2 = w3 = (nch, 2 * ech * width)
    return dw, (width,), w2, w3, (width,)


def kernel_operands(dtype, dw, ln_scale, w2, w3, gain,
                    general: bool = False):
    """The weights as the kernel takes them for x of ``dtype``. On the
    general route (:func:`runs_general`, or whatever the shape where
    ``general``) as they lie: dw [K², C], the LayerNorm scale and the gain
    [C] in float32, W2 [E, C] and W3 [C, E] in x's dtype (bf16 for int8),
    contiguous on 16 bytes. Else dw [C', K²]
    (on the cluster route transposed, [K², C']), the LayerNorm scale and
    the gain [C'] in float32, W2 [4C', C'] and W3 [C', 4C'] in x's dtype
    (bf16 for int8), contiguous on 16 bytes, with C' = ``class_width(C,
    dtype)``
    (on the cluster route the next multiple of ``CLUSTER_SLICE``): a class
    kernel's padded channels have zero depthwise weights, LayerNorm scale
    and gain, W2 columns and W3 rows, and its padded E rows of W2 and
    columns of W3 are zeros. A layout that streams W2 and W3 through its
    ring takes them as its chunks' images (:func:`chunk_images`), one
    tensor given as both W2 and W3."""
    c, k, e = ln_scale.numel(), dw.shape[-1], w2.shape[0]
    w_dtype = torch.bfloat16 if dtype == torch.int8 else dtype
    dw_f = dw.reshape(c, k * k).float().contiguous()
    ln_f = ln_scale.float().contiguous()
    gain_f = gain.float().contiguous()
    w2_io = _aligned(w2.to(w_dtype).contiguous())
    w3_io = _aligned(w3.to(w_dtype).contiguous())
    if general or runs_general(c, k, e):
        return _aligned(dw_f.t().contiguous()), ln_f, w2_io, w3_io, gain_f
    cluster = runs_cluster(c)
    pad = class_width(c, dtype) - c
    if pad:
        dw_f = F.pad(dw_f, (0, 0, 0, pad))
        ln_f, gain_f = F.pad(ln_f, (0, pad)), F.pad(gain_f, (0, pad))
        w2_io = F.pad(w2_io, (0, pad, 0, 4 * pad))
        w3_io = F.pad(w3_io, (0, 4 * pad, 0, pad))
    if cluster:
        dw_f = dw_f.t().contiguous()
    else:
        lay = _layout(c, k, dtype)
        if lay["ring_stages"]:
            w2_io = w3_io = chunk_images(w2_io, w3_io, lay)
    return dw_f, ln_f, w2_io, w3_io, gain_f


def _check_operands(operands, x, c, k, e, general=False):
    """Raise unless ``operands`` are :func:`kernel_operands`' layout for a
    unit of C channels, K x K taps and E expansion channels run on x (on
    the general route where ``general``): shapes, dtypes, device, 16-byte
    starts; the kernel reads them without bounds."""
    w_dtype = torch.bfloat16 if x.dtype == torch.int8 else x.dtype
    want = _operand_shapes(c, k, x.dtype, e, general)
    dtypes = (torch.float32, torch.float32, w_dtype, w_dtype, torch.float32)
    if len(operands) != 5 or any(
            tuple(t.shape) != s or t.dtype != d or t.device != x.device
            or not t.is_contiguous() or t.data_ptr() % 16
            for t, s, d in zip(operands, want, dtypes)):
        raise ValueError("convnext_block: operands are not kernel_operands' "
                         f"layout for C={c} K={k} in {x.dtype}")


def convnext_block(x, dw, ln_scale, w2, w3, gain, slope: float = 0.1,
                   scale_in=None, scale_out=None, operands=None, *,
                   general: bool = False):
    """One fused ConvNext residual unit. x: [B, H, W, C] float32/bfloat16,
    or int8 codes with their ``scale_in`` and the ``scale_out`` to
    requantize with (int8 mode: int8 in, int8 out); dw: [C, 1, K, K] or
    [C, K, K] depthwise kernel; ln_scale: [C]; w2: [E, C]; w3: [C, E];
    gain: [C], the activated tanh(relu(1 + w)). ``operands``: the same
    weights as :func:`kernel_operands` gives them for x's dtype, prepared
    once by the caller (``ConvNextBlock.kernel_operands`` caches them), so
    that the launch runs no cast, pad or copy of them; without, they are
    prepared on every call (for ``general``, as :func:`kernel_operands`
    gives them with ``general=True``). ``general``: run the general route
    whatever the shape (a reading beside the one-pass layouts; the shapes
    those take run them otherwise). Any C, odd K and E, as JAX's kernel; an
    even K raises ``ValueError`` on every device. Returns [B, H, W, C] in
    x's dtype."""
    global launches, int8_launches
    if x.ndim != 4:
        raise ValueError(f"convnext_block takes [B, H, W, C], got {x.shape}")
    k = dw.shape[-1]
    if k % 2 == 0:
        raise ValueError(f"convnext_block takes an odd K (K = 2·pad + 1, as "
                         f"JAX's kernel), got K={k}")
    int8 = x.dtype == torch.int8
    if (scale_in is not None, scale_out is not None) != (int8, int8):
        raise ValueError("convnext_block: int8 x takes scale_in and "
                         "scale_out, a float x takes neither")
    if has_tangent(x):
        raise RuntimeError("convnext_block has no forward-mode derivative "
                           "(neither has the JAX kernel); run the unit's "
                           "branch for a dual tensor")
    if x.device.type == "cpu":
        return convnext_block_plain(x, dw, ln_scale, w2, w3, gain, slope,
                                    scale_in, scale_out)
    if x.device.type != "cuda":
        raise ValueError(f"convnext_block: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"convnext_block kernel takes float32, bfloat16 or "
                        f"int8, got {x.dtype}")
    b, h, w, c = x.shape
    e = w2.shape[0]
    if not kernel_supports(c, k, e):
        raise ValueError(f"convnext_block kernel does not take C={c} K={k} "
                         f"E={e}")
    if (tuple(w2.shape) != (e, c) or tuple(w3.shape) != (c, e)
            or dw.numel() != c * k * k or ln_scale.numel() != c
            or gain.numel() != c):
        raise ValueError("convnext_block: weight shapes do not match x")
    tensors = (dw, ln_scale, w2, w3, gain)
    if any(t.device != x.device for t in tensors):
        raise ValueError("convnext_block: weights must be on x's device")
    s_in, inv_out = int8_constants(scale_in, scale_out) if int8 else (1.0,
                                                                       1.0)
    forced, general = general, general or runs_general(c, k, e)
    x = _aligned(x.contiguous())
    if operands is None:
        operands = kernel_operands(x.dtype, dw, ln_scale, w2, w3, gain,
                                   general=general)
    else:
        _check_operands(operands, x, c, k, e, general)
    dw_f, ln_f, w2_io, w3_io, gain_f = operands
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = cuda_build.library()
    code = _DTYPE_CODES[x.dtype]
    # the general route's t and h (none on the one-pass layouts); the
    # library's dispatcher picks the route by shape, its general entry
    # point runs the general route at any shape (``general``)
    nscratch = (lib.bid_convnext_general_scratch_bytes(b * h * w, c, e, code)
                if general else 0)
    scratch = (torch.empty(nscratch, dtype=torch.uint8, device=x.device)
               if general else None)
    entry = (lib.bid_convnext_block_general if forced
             else lib.bid_convnext_block)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = entry(
            x.data_ptr(), out.data_ptr(), dw_f.data_ptr(), ln_f.data_ptr(),
            w2_io.data_ptr(), w3_io.data_ptr(), gain_f.data_ptr(),
            None if scratch is None else scratch.data_ptr(), nscratch,
            b, h, w, c, k, e, code, float(slope), s_in, inv_out, stream)
    cuda_build.check(lib, rc, "convnext_block kernel")
    if int8:
        int8_launches += 1
    else:
        launches += 1
    shape_launches[str(x.dtype).split(".")[-1], c, k] += 1
    if benchmarking.byte_counters:
        benchmarking.add_kernel_bytes(benchmarking.convnext_bytes(
            b, h, w, c, k, x.dtype, e=e, general=general))
    return out
