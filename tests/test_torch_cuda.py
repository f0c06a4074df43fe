"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and ``nvcc`` and skips without
them. Run on a machine with the card (this file imports no JAX, so the
JAX-only ``conftest.py`` is bypassed):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: K2's backward and the decimating split K4 are bit-exact
against their plain versions in float32 and bfloat16 (the same float32
products, summed in the same order); float32 outputs agree to 1e-5 for
the band split K2 (same arithmetic, same order) and 1e-3 for the
ConvNext unit (the kernel sums in another order than the plain
matmuls), and there also 1e-5 of the plain output's largest entry (its
products run as error-compensated 3xTF32 on the tensor cores, which
keeps float32 accuracy), with two launches giving the same bits;
bfloat16 K2 outputs to one bf16 ulp of the output and
ConvNext-unit outputs to 0.05, or one bf16 ulp where the output is large
enough (|out| >= 8) for one ulp to exceed 0.05: the kernel sums the
products in another order than the plain matmuls, which can flip the
final bf16 rounding; in int8 mode that reordering moves an output code
whose pre-rounding value sits near x.5, so codes agree within one, with
at least 99.9% equal. The noise kernel K3 draws the same Philox words as
its plain version: per-sample flags and stds identical; unrounded
outputs within 1e-3, except where a first normal draw lies within 1e-5
of the ±2 redraw threshold (``logf``/``sincosf`` on the card and on the
host may differ in the last bit and pick the other draw there); rounded
outputs within 1, on at most 1e-4 of the elements (or on one element,
in batches too small for that share to allow one).

The packaged artifacts on the card: each serves within the serving bars
of the port's f32 CPU output, every int8 conv accumulator of a v5.6
request equals the int64 plain version, and a float32 forward gives the
same output whatever the global TF32 flags say.

The Denoiser's surface on the card: TTA launches 10 K1 and 2 K2 per
member and is equivariant to within 1e-2; the resnet tiled equals it
untiled within one gray level on >= 99.9% of pixels; ``dispatch`` makes
no host sync (``torch.cuda.set_sync_debug_mode("error")``); the
gradient of ``float_forward`` matches the CPU's (cosine >= 0.9999)
through K2's backward.

Train → export → serve on the card: the flagship's int8 calibration
matches the CPU's (scales within 1e-4 relative); one BatchNorm train
step of the full-width resnet matches the CPU's (loss 1e-5 relative,
running statistics 1e-4 of their largest magnitude); an exported run
serves through K1 and K2 on its float route and without K1 on its
``quant=True`` route.

Forward mode and the tools on the card: a dual tensor through a
K1-routed unit takes its branch and through K2 its ``jvp`` (tangents
within 1e-4 and 1e-5 of the plain versions'; the kernel wrappers refuse a
dual tensor); the flagship's distilled step matches the CPU's (loss 1e-4
relative, gradient cosine >= 0.9999); the analysis matches the CPU's
(means within 1e-3 gray levels, filter rows cosine >= 0.9999).
"""

import numpy as np
import pytest
import torch

from blind_image_denoising_torch.ops import (cuda_build, pallas_convnext,
                                             pallas_noise, pallas_pyramid)

pytestmark = pytest.mark.cuda

# the f32 fused forward, card vs CPU: mean gray levels (PERF.md, readings)
FUSED_F32_CARD_VS_CPU_MEAN = 1e-3
# K1 int8 against its plain version: the most codes that may differ (by
# one), as a share (the sound kernel: ~1e-5 at the fused path's shapes)
K1_INT8_SHARE_DIFFERING = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 numbers at |v| (8 significant bits)."""
    a = v.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def test_kernels_build(dev):
    path = cuda_build.build(verbose=True)
    assert path.is_file()
    cuda_build.library()


# C of no whole 16-byte vectors too: 108 (the band split of a
# filters_level_multiplier 1.5 unet_laplacian_v6's level 3; 4 bf16 channels
# a thread), 6 and 3
@pytest.mark.parametrize("shape", [(2, 64, 64, 32), (1, 37, 53, 64),
                                   (8, 256, 256, 32), (2, 32, 32, 108),
                                   (1, 19, 23, 6), (1, 9, 11, 3)])
@pytest.mark.parametrize("k", [2, 3, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_smooth_kernel_matches_plain(dev, shape, k, dtype):
    g = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(shape, generator=g).to(dev, dtype)
    before = pallas_pyramid.launches
    band, smooth = pallas_pyramid.band_smooth(x, k)
    torch.cuda.synchronize()
    assert pallas_pyramid.launches == before + 1
    band_p, smooth_p = pallas_pyramid.band_smooth_plain(x, k)
    for got, ref in ((band, band_p), (smooth, smooth_p)):
        assert got.dtype == dtype and got.shape == x.shape
        err = (got.float() - ref.float()).abs()
        if dtype == torch.float32:
            assert float(err.max()) <= 1e-5
        else:
            assert bool((err <= _bf16_ulp(ref)).all())


def _unit_weights(c, k, dev, seed=0, e=None):
    rng = np.random.default_rng(seed)
    e = 4 * c if e is None else e
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa
    return dict(
        dw=t(rng.normal(0, 0.3, (c, 1, k, k))),
        ln_scale=t(rng.uniform(0.5, 1.5, (c,))),
        w2=t(rng.normal(0, 1.0 / np.sqrt(c), (e, c))),
        w3=t(rng.normal(0, 1.0 / np.sqrt(e), (c, e))),
        gain=t(rng.uniform(0.3, 0.9, (c,))))


# [B, H, W] against K1's tiles of 8 x 32 pixels (8 x 16 in float32 and at
# C = 128, 8 x 8 above 128 and on the clusters above 256, 4 x 8 in float32
# above 256): whole tiles; ragged in both directions; one pixel over a
# tile in both; smaller than a tile; and 3 x 13 x 10 = 390 tiles (8 x 32),
# more than the persistent grid holds at once and no multiple of it. The
# kernel tests run them at every (C, K) of SAMPLE_SHAPES: the twelve of
# their own and the classes and clusters at C that are no multiple of 8
# or 16 (1, 7, 24, 72, 108, 162, 200, 300, 520, 1000) and at C = 256, 384,
# 512, 640, 768, 1024, at K = 1, 3, 5, 7
K1_BHW = [(2, 16, 64), (2, 13, 45), (3, 9, 33), (1, 5, 20), (3, 100, 300)]


@pytest.mark.parametrize("ck", pallas_convnext.SAMPLE_SHAPES)
@pytest.mark.parametrize("bhw", K1_BHW)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_convnext_kernel_matches_plain(dev, ck, bhw, dtype):
    c, k = ck
    w = _unit_weights(c, k, dev)
    g = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randn((*bhw, c), generator=g).to(dev, dtype)
    before = pallas_convnext.launches
    got = pallas_convnext.convnext_block(x, **w)
    torch.cuda.synchronize()
    assert pallas_convnext.launches == before + 1
    ref = pallas_convnext.convnext_block_plain(x, **w)
    assert got.dtype == dtype and got.shape == x.shape
    diff = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        # 3xTF32 keeps float32 accuracy: about 1e-6 of max |ref| in a CPU
        # emulation of the split (tests/test_torch_kernels.py)
        assert float(diff.max()) <= 1e-3
        assert float(diff.max()) <= 1e-5 * float(ref.abs().max())
    else:
        tol = torch.clamp(_bf16_ulp(ref), min=0.05)
        assert bool((diff <= tol).all()), float(diff.max())


@pytest.mark.parametrize("ck", pallas_convnext.SAMPLE_SHAPES)
def test_convnext_f32_kernel_is_deterministic(dev, ck):
    """Two launches on the same float32 input give the same bits (no
    atomics, no split-K; a cluster sums the LayerNorm's parts in rank
    order): the exported program is held to eager's bits."""
    c, k = ck
    w = _unit_weights(c, k, dev)
    g = torch.Generator(device="cpu").manual_seed(6)
    x = torch.randn((*K1_BHW[-1], c), generator=g).to(dev)
    first = pallas_convnext.convnext_block(x, **w)
    second = pallas_convnext.convnext_block(x, **w)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("ck", pallas_convnext.SAMPLE_SHAPES)
@pytest.mark.parametrize("bhw", K1_BHW)
def test_convnext_int8_kernel_matches_plain(dev, ck, bhw):
    c, k = ck
    w = _unit_weights(c, k, dev)
    g = torch.Generator(device="cpu").manual_seed(4)
    x = torch.randn((*bhw, c), generator=g).to(dev)
    s_in = float(x.abs().max()) / 127
    s_out = float(pallas_convnext.convnext_block_plain(
        x, **w).abs().max()) / 127
    xq = pallas_convnext.quantize(x, s_in)
    before = pallas_convnext.int8_launches
    got = pallas_convnext.convnext_block(xq, scale_in=s_in, scale_out=s_out,
                                         **w)
    torch.cuda.synchronize()
    assert pallas_convnext.int8_launches == before + 1
    ref = pallas_convnext.convnext_block_plain(xq, scale_in=s_in,
                                               scale_out=s_out, **w)
    assert got.dtype == torch.int8 and got.shape == x.shape
    dcode = (got.int() - ref.int()).abs()
    assert int(dcode.max()) <= 1
    assert float((dcode == 0).float().mean()) >= 0.999


def _ring_unit_matches_plain(dev, c, k, dtype, shape, seed=3, x_seed=None,
                             e=None):
    """A unit (of a streamed layout: W2 and W3 through the bulk-copy ring
    of csrc/chunk_ring.cuh, on a cluster of two blocks; or of any other,
    with E expansion channels, 4C by default) on x of ``shape`` against its
    plain version at the kernel tests' bars above; a second launch gives
    the same bits, and both launch the kernel."""
    w = _unit_weights(c, k, dev, seed=seed, e=e)
    g = torch.Generator(device="cpu").manual_seed(
        seed + 5 if x_seed is None else x_seed)
    x = torch.randn(shape, generator=g).to(dev)
    scales = {}
    if dtype == torch.int8:
        scales = dict(scale_in=float(x.abs().max()) / 127,
                      scale_out=float(pallas_convnext.convnext_block_plain(
                          x, **w).abs().max()) / 127)
        x = pallas_convnext.quantize(x, scales["scale_in"])
    else:
        x = x.to(dtype)
    ops = pallas_convnext.kernel_operands(x.dtype, **w)
    before = pallas_convnext.launches + pallas_convnext.int8_launches
    got = pallas_convnext.convnext_block(x, **w, **scales, operands=ops)
    again = pallas_convnext.convnext_block(x, **w, **scales, operands=ops)
    torch.cuda.synchronize()
    assert (pallas_convnext.launches + pallas_convnext.int8_launches
            == before + 2)
    assert got.dtype == x.dtype and got.shape == x.shape
    assert torch.equal(got.view(torch.uint8), again.view(torch.uint8))
    ref = pallas_convnext.convnext_block_plain(x, **w, **scales)
    diff = (got.float() - ref.float()).abs()
    if dtype == torch.int8:
        assert int(diff.max()) <= 1
        assert float((diff == 0).float().mean()) >= 0.999
    elif dtype == torch.float32:
        assert float(diff.max()) <= 1e-3
        assert float(diff.max()) <= 1e-5 * float(ref.abs().max())
    else:
        tol = torch.clamp(_bf16_ulp(ref), min=0.05)
        assert bool((diff <= tol).all()), float(diff.max())


def _resident_clusters(c, k, dtype):
    """The blocks of the layout that runs (C, K) the card holds at once."""
    import ctypes
    info = (ctypes.c_int * 9)()
    assert cuda_build.library().bid_convnext_block_info(
        c, k, 4 * c, pallas_convnext._DTYPE_CODES[dtype], info) == 0
    return info


@pytest.mark.parametrize("ck", [(c, k) for c in (96, 112, 128)
                                for k in (1, 3, 5, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_convnext_c128_walks_the_chunk_ring_over_many_tiles(dev, ck, dtype):
    """From C = 96 (f32 from 80, and (64, 7)) W2 and W3 stream through a
    ring of three or more stages of bulk copies, multicast over a cluster
    of two blocks on neighbouring tiles, 16 or 32 E channels a chunk, the
    chunks running on from tile to tile (f32 (128, 7): the ring takes the
    tile buffer's room from the depthwise to the epilogue). On 32 x 64 x
    64 (a depth-4 fused unet_laplacian_v6's level 2 at b32 @ 256²) there
    are 1024 tiles of 8 x 16 pixels, several times the resident clusters,
    so every block walks the ring around many times; held to the kernel
    tests' bars, two launches equal."""
    c, k = ck
    info = _resident_clusters(c, k, dtype)
    assert info[8] >= 3 and info[5] == pallas_convnext.RING_CLUSTER
    shape = (32, 64, 64, c)
    assert shape[0] * (shape[1] // 8) * (shape[2] // 16) >= 4 * info[6] * 2
    _ring_unit_matches_plain(dev, c, k, dtype, shape)


@pytest.mark.parametrize("ck", [(16, 5), (48, 5), (40, 3), (72, 5), (80, 1),
                                (96, 5), (88, 3), (108, 5), (112, 1),
                                (100, 7), (48, 7), (120, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_convnext_class_widths_over_many_tiles(dev, ck, dtype):
    """Every layout of a width that is a multiple of 16 (C rounded up to
    16: 16, 48, 80, 96, 112 but in float32, and 128's ragged edge) over
    many tiles: on
    48 x 64 x 64 there are 768 tiles of 8 x 32 pixels or 1536 of 8 x 16,
    several times the resident blocks, so every block walks the streamed
    weight ring (from width 96 in bf16 and int8, from 80 in float32) and
    its tile buffers or stage over many tiles; held to the kernel tests'
    bars, and two launches give the same bits."""
    import ctypes
    c, k = ck
    info = (ctypes.c_int * 9)()
    assert cuda_build.library().bid_convnext_block_info(
        c, k, 4 * c, pallas_convnext._DTYPE_CODES[dtype], info) == 0
    assert info[7] == pallas_convnext.class_width(c, dtype) == (
        128 if dtype == torch.float32 and 96 < c <= 112 else -(-c // 16) * 16)
    resident = info[4] * torch.cuda.get_device_properties(
        0).multi_processor_count
    shape = (48, 64, 64, c)
    assert shape[0] * (shape[1] // 8) * (shape[2] // 32) >= 2 * resident
    w = _unit_weights(c, k, dev, seed=3)
    g = torch.Generator(device="cpu").manual_seed(8)
    x = torch.randn(shape, generator=g).to(dev)
    scales = {}
    if dtype == torch.int8:
        scales = dict(scale_in=float(x.abs().max()) / 127,
                      scale_out=float(pallas_convnext.convnext_block_plain(
                          x, **w).abs().max()) / 127)
        x = pallas_convnext.quantize(x, scales["scale_in"])
    else:
        x = x.to(dtype)
    got = pallas_convnext.convnext_block(x, **w, **scales)
    again = pallas_convnext.convnext_block(x, **w, **scales)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ref = pallas_convnext.convnext_block_plain(x, **w, **scales)
    diff = (got.float() - ref.float()).abs()
    if dtype == torch.int8:
        assert int(diff.max()) <= 1
        assert float((diff == 0).float().mean()) >= 0.999
    elif dtype == torch.float32:
        assert float(diff.max()) <= 1e-3
        assert float(diff.max()) <= 1e-5 * float(ref.abs().max())
    else:
        tol = torch.clamp(_bf16_ulp(ref), min=0.05)
        assert bool((diff <= tol).all()), float(diff.max())


@pytest.mark.parametrize("ck, dtype", [((108, 5), torch.int8),
                                       ((99, 3), torch.int8),
                                       ((108, 5), torch.bfloat16),
                                       ((100, 5), torch.bfloat16)])
def test_convnext_ragged_x_ending_inside_a_16_byte_unit(dev, ck, dtype):
    """A ragged x of odd B·H·W whose last byte falls inside a 16-byte unit,
    as a view at the start of a buffer that goes on with another tensor's
    bytes (int8 codes of -128, bf16 NaN): the same bits as on a copy of x
    alone, the neighbour's bytes untouched, and the kernel tests' bars."""
    c, k = ck
    shape = (1, 15, 15, c)
    n = int(np.prod(shape))
    w = _unit_weights(c, k, dev, seed=5)
    g = torch.Generator(device="cpu").manual_seed(6)
    x = torch.randn(shape, generator=g).to(dev)
    scales = {}
    if dtype == torch.int8:
        scales = dict(scale_in=float(x.abs().max()) / 127,
                      scale_out=float(pallas_convnext.convnext_block_plain(
                          x, **w).abs().max()) / 127)
        x = pallas_convnext.quantize(x, scales["scale_in"])
    else:
        x = x.to(dtype)
    assert n * x.element_size() % 16
    buf = torch.empty(n + 64, dtype=dtype, device=dev)
    buf[n:] = -128 if dtype == torch.int8 else float("nan")
    view = buf[:n].view(shape)
    view.copy_(x)
    tail = buf[n:].view(torch.uint8).clone()
    got = pallas_convnext.convnext_block(view, **w, **scales)
    alone = pallas_convnext.convnext_block(x.clone(), **w, **scales)
    torch.cuda.synchronize()
    assert view.data_ptr() == buf.data_ptr()
    assert torch.equal(got, alone)
    assert torch.equal(buf[n:].view(torch.uint8), tail)
    ref = pallas_convnext.convnext_block_plain(x, **w, **scales)
    diff = (got.float() - ref.float()).abs()
    if dtype == torch.int8:
        assert int(diff.max()) <= 1
        assert float((diff == 0).float().mean()) >= 0.999
    else:
        tol = torch.clamp(_bf16_ulp(ref), min=0.05)
        assert bool((diff <= tol).all()), float(diff.max())


def test_convnext_cached_operands_launch_the_same_bits(dev):
    """A launch on the operands ``kernel_operands`` prepared once gives the
    bits of one that prepares them, in every mode and at a padded width;
    operands of another layout are refused."""
    for c, k in ((48, 5), (108, 5), (64, 5)):
        w = _unit_weights(c, k, dev, seed=2)
        g = torch.Generator(device="cpu").manual_seed(3)
        x = torch.randn((2, 16, 40, c), generator=g).to(dev)
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            scales = {}
            v = x.to(dtype) if dtype != torch.int8 else None
            if dtype == torch.int8:
                scales = dict(scale_in=float(x.abs().max()) / 127,
                              scale_out=4 * float(x.abs().max()) / 127)
                v = pallas_convnext.quantize(x, scales["scale_in"])
            ops = pallas_convnext.kernel_operands(v.dtype, **w)
            assert torch.equal(
                pallas_convnext.convnext_block(v, **w, **scales),
                pallas_convnext.convnext_block(v, **w, **scales,
                                               operands=ops))
    other = pallas_convnext.kernel_operands(torch.float32,
                                            **_unit_weights(32, 5, dev))
    x = torch.zeros((1, 8, 8, 48), device=dev)
    with pytest.raises(ValueError):
        pallas_convnext.convnext_block(x, **_unit_weights(48, 5, dev),
                                       operands=other)


@pytest.mark.parametrize("ck", [(32, 4), (1025, 6)])
def test_convnext_kernel_rejects_unbuilt_shape(dev, ck):
    """K1 takes every shape JAX's kernel takes, so what it refuses is what
    JAX's cannot take: an even K raises ``ValueError`` on a CUDA tensor as
    on the CPU (K = 2·pad + 1), and the library's entry points refuse it;
    weights whose shapes do not match x raise ``ValueError`` too."""
    import ctypes
    c, k = ck
    w = _unit_weights(c, k, dev)
    x = torch.zeros((1, 8, 8, c), device=dev)
    for v, wts in ((x, w), (x.cpu(), {n: t.cpu() for n, t in w.items()})):
        with pytest.raises(ValueError):
            pallas_convnext.convnext_block(v, **wts)
    assert cuda_build.library().bid_convnext_block_info(
        c, k, 4 * c, 1, (ctypes.c_int * 9)()) == -1
    w = _unit_weights(c, k + 1, dev)
    for bad in (dict(w, w3=w["w3"][:, :c]), dict(w, gain=w["gain"][:1]),
                dict(w, dw=w["dw"][:1])):
        with pytest.raises(ValueError):
            pallas_convnext.convnext_block(x, **bad)


# the general route's card cases: (C, K, E) on [B, H, W]: above C = 1024
# (ragged rows of no whole 16-byte vectors at 1025; 1040, 1536, and 2048 at
# a depth-7 no-attention v6's level-6 shape 8 x 4 x 4 and a ragged one) at
# K = 5, C = 4096 at K = 1; C = 1 and 32 at K = 9 and 11; (48, 5) at E = 2C
# and 3C; the pixels no multiple of the products' tiles of 64, and from
# dozens to hundreds of tiles (the expansion's 128 E columns a tile)
GENERAL_CASES = [((1025, 5, 4100), (2, 9, 13)),
                 ((1040, 5, 4160), (3, 7, 11)),
                 ((1536, 5, 6144), (2, 8, 9)),
                 ((2048, 5, 8192), (8, 4, 4)),
                 ((2048, 5, 8192), (2, 9, 7)),
                 ((4096, 1, 16384), (1, 5, 7)),
                 ((1, 9, 4), (3, 37, 45)),
                 ((1, 11, 4), (2, 19, 23)),
                 ((32, 9, 128), (3, 37, 45)),
                 ((32, 11, 128), (2, 19, 23)),
                 ((48, 5, 96), (4, 33, 35)),
                 ((48, 5, 144), (4, 33, 35))]


@pytest.mark.parametrize("cke, bhw", GENERAL_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_convnext_general_route_matches_plain(dev, cke, bhw, dtype):
    """Every shape off the one-pass layouts runs the general route (three
    kernels through scratch in device memory): against its plain version
    at the kernel tests' bars (bf16 max(0.05, 1 ulp), int8 codes within 1
    on at most 1e-3 of them, f32 1e-3 and 1e-5 of max |out|), two launches
    giving the same bits."""
    c, k, e = cke
    assert pallas_convnext.runs_general(c, k, e)
    _ring_unit_matches_plain(dev, c, k, dtype, (*bhw, c), seed=11, e=e)


@pytest.mark.parametrize("ck", [(512, 5), (32, 3), (1024, 7)])
def test_convnext_general_route_at_one_pass_shapes(dev, ck):
    """``general=True`` runs the general route at a shape the one-pass
    layouts take (a reading beside them): the same bars against the plain
    version in every mode, and the same bits on operands prepared once
    (``kernel_operands(..., general=True)``)."""
    c, k = ck
    w = _unit_weights(c, k, dev, seed=12)
    g = torch.Generator(device="cpu").manual_seed(13)
    x = torch.randn((2, 9, 11, c), generator=g).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        v = x.to(dtype)
        got = pallas_convnext.convnext_block(v, **w, general=True)
        ref = pallas_convnext.convnext_block_plain(v, **w)
        diff = (got.float() - ref.float()).abs()
        if dtype == torch.float32:
            assert float(diff.max()) <= 1e-3
            assert float(diff.max()) <= 1e-5 * float(ref.abs().max())
        else:
            tol = torch.clamp(_bf16_ulp(ref), min=0.05)
            assert bool((diff <= tol).all()), float(diff.max())
        ops = pallas_convnext.kernel_operands(dtype, **w, general=True)
        assert torch.equal(got, pallas_convnext.convnext_block(
            v, **w, general=True, operands=ops))
    s_in = float(x.abs().max()) / 127
    s_out = float(pallas_convnext.convnext_block_plain(
        x, **w).abs().max()) / 127
    xq = pallas_convnext.quantize(x, s_in)
    got = pallas_convnext.convnext_block(xq, scale_in=s_in, scale_out=s_out,
                                         **w, general=True)
    ref = pallas_convnext.convnext_block_plain(xq, scale_in=s_in,
                                               scale_out=s_out, **w)
    dcode = (got.int() - ref.int()).abs()
    assert int(dcode.max()) <= 1
    assert float((dcode == 0).float().mean()) >= 0.999


@pytest.mark.parametrize("cke", pallas_convnext.GENERAL_SAMPLE_SHAPES)
def test_convnext_general_route_built_as_planned(dev, cke):
    """The library reports the general route's instantiations as
    ``general_plan`` has them (the largest shared memory of its three
    kernels, 256 threads, cluster size 1, width C, no ring), spilling
    nothing and holding a block an SM; its scratch is t then h, P rounded
    up to 64 pixels and C, E to 32 elements (bf16, float32 in float32
    I/O), h 256-byte aligned."""
    import ctypes
    c, k, e = cke
    lib = cuda_build.library()
    for dtype, code in pallas_convnext._DTYPE_CODES.items():
        v = (ctypes.c_int * 9)()
        assert lib.bid_convnext_block_info(c, k, e, code, v) == 0
        plan = pallas_convnext.kernel_plan(c, k, dtype, e)
        assert plan == pallas_convnext.general_plan(c)
        assert (v[0], v[3], v[5], v[7], v[8]) == (
            plan["smem_bytes"], plan["threads_per_block"], 1, c, 0), list(v)
        assert v[2] == 0 and v[4] >= 1 and v[6] >= 1, list(v)
        elt = 4 if dtype == torch.float32 else 2
        for p in (1, 63, 64, 1000, 8 * 256 * 256):
            rows = -(-p // 64) * 64
            t_bytes = rows * (-(-c // 32) * 32) * elt
            assert lib.bid_convnext_general_scratch_bytes(p, c, e, code) == \
                -(-t_bytes // 256) * 256 + rows * (-(-e // 32) * 32) * elt


@pytest.mark.parametrize("ck", pallas_convnext.SAMPLE_SHAPES)
def test_convnext_sample_shapes_keep_their_one_pass_route(dev, ck):
    """Every (C, K) of SAMPLE_SHAPES at E = 4C keeps the route it had
    before the general route: the library reports its layout (the
    plan's shared memory and cluster, its width), not the general route's
    signature (cluster 1 at width C with no ring and the general plan's
    shared memory)."""
    import ctypes
    c, k = ck
    general = pallas_convnext.general_plan(c)
    for dtype, code in pallas_convnext._DTYPE_CODES.items():
        v = (ctypes.c_int * 9)()
        assert cuda_build.library().bid_convnext_block_info(
            c, k, 4 * c, code, v) == 0
        assert not pallas_convnext.runs_general(c, k, 4 * c)
        plan = pallas_convnext.kernel_plan(c, k, dtype)
        assert (v[0], v[5]) == (plan["smem_bytes"], plan["cluster_size"])
        assert (v[0], v[5], v[7], v[8]) != (
            general["smem_bytes"], 1, c, 0), (dtype, list(v))


def test_cost_bytes_of_a_k1_launch_is_its_kernel_byte_count(dev):
    """``benchmarking.cost_bytes`` of one K1 launch on prepared operands
    is the bytes the kernel reports (``benchmarking.convnext_bytes``): the
    wrapper runs no aten operator that moves bytes, on a one-pass layout
    and on the general route (its scratch counted)."""
    from blind_image_denoising_torch import benchmarking
    g = torch.Generator(device="cpu").manual_seed(14)
    for c, k, e in ((32, 3, 128), (48, 5, 96), (1025, 5, 4100)):
        w = _unit_weights(c, k, dev, e=e)
        x = torch.randn((2, 16, 16, c), generator=g).to(dev, torch.bfloat16)
        ops = pallas_convnext.kernel_operands(x.dtype, **w)
        got = benchmarking.cost_bytes(
            lambda: pallas_convnext.convnext_block(x, **w, operands=ops))
        assert got == benchmarking.convnext_bytes(
            2, 16, 16, c, k, x.dtype, e=e,
            general=pallas_convnext.runs_general(c, k, e))


@pytest.mark.parametrize("ck", [(c, k) for c in (129, 160, 192, 250, 256)
                                for k in (1, 3, 5, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_convnext_wide_walks_the_chunk_ring_over_many_tiles(dev, ck, dtype):
    """Above C = 128 the wide class streams W2 and W3 in chunks of 16 E
    channels through its ring of bulk copies, multicast over a cluster of
    two blocks; whole-C tiles (bf16, int8 at K <= 5) run the chunks on
    from tile to tile, the grouped layouts (K = 7, f32) give the ring its
    region once the LayerNorm is done. On 32 x 32 x 32 (a depth-5 fused
    unet_laplacian_v6's level 3 at b32 @ 256²) there are 512 tiles of 8 x 8
    pixels, several times the resident clusters, so every block walks the
    ring around many times; held to the kernel tests' bars, two launches
    equal."""
    c, k = ck
    info = _resident_clusters(c, k, dtype)
    assert info[8] >= 3 and info[5] == pallas_convnext.RING_CLUSTER
    shape = (32, 32, 32, c)
    assert shape[0] * (shape[1] // 8) * (shape[2] // 8) >= 3 * info[6] * 2
    _ring_unit_matches_plain(dev, c, k, dtype, shape)


@pytest.mark.parametrize("c", [96, 112, 128, 129, 160, 192, 250, 256])
@pytest.mark.parametrize("k", [1, 3, 5, 7])
@pytest.mark.parametrize("shape", [(1, 5, 7), (1, 24, 40), (3, 8, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_convnext_ring_takes_odd_and_tiny_tile_counts(dev, c, k, shape,
                                                      dtype):
    """A cluster of two blocks takes two neighbouring tiles a round: one
    image smaller than a tile (one tile, the cluster's other block a ghost
    throughout), an odd count (3 x 3 tiles of 8 x 16 or 3 x 5 of 8 x 8:
    the last round's second block a ghost) and three of each layout's
    tiles; the ghost computes on zeros, stores nothing and takes every
    chunk with its partner."""
    _ring_unit_matches_plain(dev, c, k, dtype, (*shape, c), seed=11)


# K = 7's layouts that share the bf16 depthwise (a run's two halves of 4
# channels in turn): (32, 7), (64, 7) and (128, 7) of their own and the
# class widths 16, 48, 80 (C = 72) and 112 (C = 108)
K7_CHANNELS = [32, 64, 128, 16, 48, 72, 108]


@pytest.mark.parametrize("c", K7_CHANNELS)
@pytest.mark.parametrize("shape", [(48, 64, 64), (1, 5, 7), (3, 37, 70)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_convnext_k7_layouts_over_many_tiles_and_odd_images(dev, c, shape,
                                                           dtype):
    """Each K = 7 layout over many tiles (48 x 64 x 64: 768 tiles of 8 x
    32 pixels or 1536 of 8 x 16, more than twice the blocks the card
    holds, so every block walks its tile buffers, the copies of its next
    tile and, at (32, 7), its SM's second block over several tiles) and
    over odd and tiny images (1 x 5 x 7, one tile; 3 x 37 x 70, ragged
    edges both ways), at the kernel tests' bars, two launches giving the
    same bits; built as ``kernel_plan`` has it, with at least its
    ``min_blocks_per_sm`` resident (two at (32, 7))."""
    info = _resident_clusters(c, 7, dtype)
    plan = pallas_convnext.kernel_plan(c, 7, dtype)
    assert (info[0], info[3], info[5], info[8]) == (
        plan["smem_bytes"], plan["threads_per_block"], plan["cluster_size"],
        plan.get("ring_stages", 0)), list(info)
    assert info[2] == 0 and info[4] >= plan["min_blocks_per_sm"], list(info)
    if c == 32:
        assert plan["min_blocks_per_sm"] == 2
    if shape[0] > 3:
        tiles = shape[0] * (shape[1] // 8) * (shape[2] // 32)
        assert tiles >= 2 * info[4] * torch.cuda.get_device_properties(
            0).multi_processor_count
    _ring_unit_matches_plain(dev, c, 7, dtype, (*shape, c), seed=17)


@pytest.mark.parametrize("ck", pallas_convnext.SAMPLE_SHAPES)
def test_convnext_built_plan_matches_kernel_plan(dev, ck):
    """Every instantiation of SAMPLE_SHAPES (K = 7 and C up to 1024
    included) is built with the threads, shared memory, cluster size and
    ring stages ``kernel_plan`` mirrors, fits one block, holds at least
    one block an SM and one cluster on the card and spills nothing."""
    import ctypes
    c, k = ck
    for dtype, code in pallas_convnext._DTYPE_CODES.items():
        v = (ctypes.c_int * 9)()
        assert cuda_build.library().bid_convnext_block_info(
            c, k, 4 * c, code, v) == 0
        plan = pallas_convnext.kernel_plan(c, k, dtype)
        assert (v[0], v[3], v[5]) == (
            plan["smem_bytes"], plan["threads_per_block"],
            plan["cluster_size"]), (dtype, list(v))
        assert v[0] <= pallas_convnext.SHARED_MEMORY_LIMIT
        assert v[2] == 0 and v[4] >= 1 and v[6] >= 1, (dtype, list(v))
        # the layout's width is the one the wrapper pads the weights to,
        # and it holds the blocks an SM its registers are capped for
        assert v[7] == pallas_convnext.class_width(c, dtype), (dtype, list(v))
        assert v[4] >= plan.get("min_blocks_per_sm", 1), (dtype, list(v))
        # a streamed layout's ring: its stages (three or more), on a
        # cluster of RING_CLUSTER blocks
        assert v[8] == plan.get("ring_stages", 0), (dtype, list(v))
        assert v[8] == 0 or v[8] >= 3


@pytest.mark.parametrize("ck", [(256, 7), (200, 7), (512, 5), (384, 7),
                                (300, 1), (512, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_convnext_grouped_wide_over_many_tiles(dev, ck, dtype):
    """The grouped wide class (K = 7 at width 256, and f32 at every K)
    copies each 64-channel group with its depthwise weights into a slot
    that shares its room with the weight ring, so a tile's groups,
    LayerNorm, chunks and epilogue follow each other over the same memory
    (the cluster's blocks meet before the ring takes it). On 16 x 32 x 32
    (256 tiles of 8 x 8) every block walks several tiles; held to the
    kernel tests' bars, two launches equal. Above C = 256 the cases run
    the cluster kernel over as many tiles."""
    c, k = ck
    _ring_unit_matches_plain(dev, c, k, dtype, (16, 32, 32, c), seed=9,
                             x_seed=10)


@pytest.mark.parametrize("ck", [(520, 5), (1000, 5), (1000, 7),
                                (1024, 1), (768, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_convnext_cluster_over_many_tiles(dev, ck, dtype):
    """The thread-block cluster (C above 256) over many tiles, ragged
    slices included: at C = 520 (5 blocks, the last owning 8 true channels
    of its 128) and C = 1000 (8 blocks, the last 104), a tile's halo and
    depthwise, the LayerNorm's statistics across the cluster, the t slices
    pushed into every block, the chunks and the epilogue follow each
    other over the same memory. On 16 x 32 x 32 there are 256 tiles of
    8 x 8 pixels (float32: 512 of 4 x 8), several times the clusters the
    card holds, so every cluster walks many; held to the kernel tests'
    bars, and two launches give the same bits."""
    import ctypes
    c, k = ck
    w = _unit_weights(c, k, dev, seed=9)
    g = torch.Generator(device="cpu").manual_seed(10)
    x = torch.randn((16, 32, 32, c), generator=g).to(dev)
    info = (ctypes.c_int * 9)()
    assert cuda_build.library().bid_convnext_block_info(
        c, k, 4 * c, pallas_convnext._DTYPE_CODES[dtype], info) == 0
    assert info[5] == -(-c // 128) and 16 * 4 * 4 >= 3 * info[6]
    scales = {}
    if dtype == torch.int8:
        scales = dict(scale_in=float(x.abs().max()) / 127,
                      scale_out=float(pallas_convnext.convnext_block_plain(
                          x, **w).abs().max()) / 127)
        x = pallas_convnext.quantize(x, scales["scale_in"])
    else:
        x = x.to(dtype)
    got = pallas_convnext.convnext_block(x, **w, **scales)
    again = pallas_convnext.convnext_block(x, **w, **scales)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ref = pallas_convnext.convnext_block_plain(x, **w, **scales)
    diff = (got.float() - ref.float()).abs()
    if dtype == torch.int8:
        assert int(diff.max()) <= 1
        assert float((diff == 0).float().mean()) >= 0.999
    elif dtype == torch.float32:
        assert float(diff.max()) <= 1e-3
        assert float(diff.max()) <= 1e-5 * float(ref.abs().max())
    else:
        tol = torch.clamp(_bf16_ulp(ref), min=0.05)
        assert bool((diff <= tol).all()), float(diff.max())


# [B, H, W, C] against the split's tiles (32 x 8 pixels at C = 32 bf16,
# 16 x 8 at C = 64): one quad, 100 x 300, last tiles ragged in both
# directions, B = 1 and 16, C 8 to 128, and more tiles than resident
# blocks (16 x 128^2 x 32 and 8 x 256^2 x 32), so blocks walk several
SPLIT_SHAPES = [(1, 2, 2, 8), (16, 2, 2, 8), (1, 100, 300, 16),
                (16, 34, 66, 32), (1, 38, 54, 64), (2, 18, 30, 128),
                (16, 10, 100, 64), (16, 128, 128, 32), (8, 256, 256, 32)]


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_split_kernel_matches_plain(dev, shape, k, dtype):
    g = torch.Generator(device="cpu").manual_seed(5)
    x = torch.randn(shape, generator=g).to(dev, dtype)
    before = pallas_pyramid.split_launches
    band, down = pallas_pyramid.band_split(x, k)
    torch.cuda.synchronize()
    assert pallas_pyramid.split_launches == before + 1
    band_p, down_p = pallas_pyramid.band_split_plain(x, k)
    assert down.shape == (shape[0], shape[1] // 2, shape[2] // 2, shape[3])
    for got, ref in ((band, band_p), (down, down_p)):
        assert got.dtype == dtype and got.shape == ref.shape
        assert float((got.float() - ref.float()).abs().max()) == 0.0
    with pytest.raises(ValueError, match="even"):
        pallas_pyramid.band_split(x[:, 1:], k)


def test_band_split_tile_plan_matches_library(dev):
    """The Python tile plan is the one the library builds, with no spill,
    at the checked shapes and some edges."""
    import ctypes
    lib = cuda_build.library()
    for dtype, code in pallas_pyramid._DTYPE_CODES.items():
        for b, h, w, c, k in [(8, 256, 256, 32, 2), (8, 128, 128, 64, 2),
                              (1, 2, 2, 8, 5), (2, 18, 30, 128, 3),
                              (1, 2160, 3840, 32, 2)]:
            v = (ctypes.c_int * 9)()
            assert lib.bid_band_split_info(h, w, c, k, code, v) == 0
            plan = pallas_pyramid.split_tile_plan(b, h, w, c, k, dtype)
            assert list(v)[:5] == [plan[key] for key in (
                "tile_w", "tile_h", "threads_x", "threads_y", "smem_bytes")]
            assert v[6] == 0 and v[7] >= 1


def test_v6_fused_forward_on_card(dev, monkeypatch):
    """unet_laplacian_v6 at full width from a seeded init, b2 @ 64²: the
    float32 fused forward agrees with the same forward on the CPU (plain
    K1, the same weights) within FUSED_F32_CARD_VS_CPU_MEAN gray levels
    (mean, every scale). The bf16 float and int8 fused forwards make 12 K1
    launches each (float and int8 mode) and no K2, and every one of those
    launches agrees with K1's plain version on the same input (bf16:
    max(0.05, 1 ulp); int8: codes within one, at most
    K1_INT8_SHARE_DIFFERING of them). The whole bf16 and int8 forwards
    are not held against the CPU's: the two devices part there by whole
    bf16 roundings and int8 codes, which this seeded model spreads
    through every later unit (``chip_smoke.py``'s ``fused`` phase logs
    those gaps; PERF.md)."""
    import copy
    import blind_image_denoising_torch as bidt
    from blind_image_denoising_torch.inference import fused
    from blind_image_denoising_torch.models.hydra import model_builder
    from blind_image_denoising_torch.training.train_state import init_params
    cfg = copy.deepcopy(bidt.load_config(
        bidt.CONFIGS_DICT["unet_laplacian_v6"])["model"])
    hydra = model_builder(cfg, dtype=torch.bfloat16).hydra
    init_params(hydra, torch.Generator().manual_seed(0))
    hydra = hydra.to(dev).eval().requires_grad_(False)
    yy, xx = torch.meshgrid(torch.arange(64.0), torch.arange(64.0),
                            indexing="ij")
    clean = torch.stack([yy * 3, xx * 3, (yy + xx) * 1.5])[None].repeat(
        2, 1, 1, 1)
    g = torch.Generator().manual_seed(1)
    x = (clean + 10 * torch.randn(clean.shape, generator=g)).clamp(
        0, 255).round().to(dev)
    f32 = model_builder(cfg).hydra
    f32.load_state_dict({k: v.cpu() for k, v in hydra.state_dict().items()})
    f32.eval().requires_grad_(False)
    ref = fused.build_fused_forward(cfg, f32, dtype=torch.float32)[0](x.cpu())
    got = fused.build_fused_forward(cfg, f32.to(dev),
                                    dtype=torch.float32)[0](x)
    gaps = [float((a.cpu() - b).abs().mean()) for a, b in zip(got, ref)]
    assert max(gaps) <= FUSED_F32_CARD_VS_CPU_MEAN, gaps

    scales = fused.calibrate_fused(cfg, hydra, x)
    real, launches = fused.convnext_block, []

    def against_plain(v, **kw):
        out = real(v, **kw)
        ref = pallas_convnext.convnext_block_plain(v, **kw)
        d = (out.float() - ref.float()).abs()
        if v.dtype == torch.int8:
            launches.append((int(d.max()) <= 1 and float(
                (d > 0).float().mean()) <= K1_INT8_SHARE_DIFFERING,
                int((d > 0).sum())))
        else:
            launches.append((bool((d <= torch.clamp(
                _bf16_ulp(ref), min=0.05)).all()), float(d.max())))
        return out

    monkeypatch.setattr(fused, "convnext_block", against_plain)
    counts = lambda: (pallas_convnext.launches,  # noqa: E731
                      pallas_convnext.int8_launches,
                      pallas_pyramid.launches)
    for sc, want in ((None, (12, 0, 0)), (scales, (0, 12, 0))):
        fwd, _ = fused.build_fused_forward(cfg, hydra, sc)
        before = counts()
        outs = fwd(x)
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(counts(), before)) == want
        assert all(bool(torch.isfinite(o).all()) for o in outs)
    assert len(launches) == 24 and all(ok for ok, _ in launches), launches


def test_flagship_f32_serving_on_card_matches_cpu(dev):
    """dtype="float32" serving runs K1's CUDA-core path and K2 in f32 on
    the card; with TF32 off it must agree with the CPU plain path to one
    gray level, exactly on >= 99% of pixels."""
    import blind_image_denoising_torch as bidt
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:100, 0:90].astype(np.float32)
    clean = np.stack([yy * 2.0, xx * 2.5, (yy + xx) * 1.2], -1)[None]
    img = np.clip(np.round(clean + rng.normal(0, 15, (2, 100, 90, 3))),
                  0, 255).astype(np.uint8)
    card = bidt.load_model("unet_laplacian_v6_tpu_scratch", dtype="float32")
    cpu = bidt.load_model("unet_laplacian_v6_tpu_scratch", device="cpu",
                          dtype="float32")
    k1, k2 = pallas_convnext.launches, pallas_pyramid.launches
    got = card(img)
    assert (pallas_convnext.launches - k1, pallas_pyramid.launches - k2) \
        == (10, 2)
    diff = np.abs(got.astype(int) - cpu(img).astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


@pytest.mark.parametrize("shape", [(16, 128, 128, 32), (16, 64, 64, 64),
                                   (1, 37, 53, 64)])
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_smooth_bwd_kernel_matches_plain(dev, shape, k, dtype):
    g = torch.Generator(device="cpu").manual_seed(2)
    g_band = torch.randn(shape, generator=g).to(dev, dtype)
    # the smooth grad arrives permuted, as the model hands it over
    g_smooth = torch.randn(shape, generator=g).to(dev, dtype).permute(
        0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    before = pallas_pyramid.bwd_launches
    copies = pallas_pyramid.bwd_grad_copies
    dx = pallas_pyramid.band_smooth_bwd(g_band, g_smooth, k)
    torch.cuda.synchronize()
    assert pallas_pyramid.bwd_launches == before + 1
    assert pallas_pyramid.bwd_grad_copies == copies + 1      # g_smooth only
    ref = pallas_pyramid.band_smooth_bwd_plain(g_band, g_smooth, k)
    assert dx.dtype == dtype and dx.shape == g_band.shape
    assert float((dx.float() - ref.float()).abs().max()) == 0.0


def test_band_smooth_autograd_launches_both_kernels(dev):
    x = torch.randn((2, 16, 16, 32), device=dev, requires_grad=True)
    f, b = pallas_pyramid.launches, pallas_pyramid.bwd_launches
    band, smooth = pallas_pyramid.band_smooth(x, 2)
    (band.square().sum() + smooth.sum()).backward()
    torch.cuda.synchronize()
    assert (pallas_pyramid.launches - f, pallas_pyramid.bwd_launches - b) \
        == (1, 1)
    ref = pallas_pyramid.band_smooth_bwd_plain(2 * band.detach(),
                                               torch.ones_like(smooth), 2)
    assert float((x.grad - ref).abs().max()) <= 1e-5


def _bwd_grads(dev, shape, dtype, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dev, dtype) for _ in range(2)]


def _assert_bwd_bit_exact(g_band, g_smooth, k):
    before = pallas_pyramid.bwd_launches
    dx = pallas_pyramid.band_smooth_bwd(g_band, g_smooth, k)
    torch.cuda.synchronize()
    assert pallas_pyramid.bwd_launches == before + 1
    ref = pallas_pyramid.band_smooth_bwd_plain(g_band, g_smooth, k)
    assert dx.dtype == ref.dtype and dx.shape == ref.shape
    assert float((dx.float() - ref.float()).abs().max()) == 0.0


# [B, H, W] against the backward's tiles (32 x 8 pixels at C = 32 bf16,
# 16 x 8 in f32): ragged in both directions, one pixel, one row, one
# column, and many tiles
BWD_BHW = [(2, 13, 45), (1, 1, 1), (1, 1, 37), (1, 29, 1), (3, 9, 33),
           (1, 100, 300)]


@pytest.mark.parametrize("bhw", BWD_BHW)
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_smooth_bwd_kernel_tile_edges(dev, bhw, k, dtype):
    g_band, g_smooth = _bwd_grads(dev, (*bhw, 32), dtype, seed=5)
    _assert_bwd_bit_exact(g_band, g_smooth, k)


@pytest.mark.parametrize("c", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("k", [2, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_smooth_bwd_kernel_channels(dev, c, k, dtype):
    g_band, g_smooth = _bwd_grads(dev, (2, 19, 23, c), dtype, seed=6)
    _assert_bwd_bit_exact(g_band, g_smooth, k)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_smooth_bwd_kernel_nchw_grads(dev, k, dtype):
    """Both grads NCHW-contiguous: the wrapper copies both to NHWC (and
    counts two copies), and the result is still bit-exact."""
    g_band, g_smooth = (g.permute(0, 3, 1, 2).contiguous().permute(
        0, 2, 3, 1) for g in _bwd_grads(dev, (2, 37, 53, 64), dtype, seed=7))
    copies = pallas_pyramid.bwd_grad_copies
    _assert_bwd_bit_exact(g_band, g_smooth, k)
    assert pallas_pyramid.bwd_grad_copies == copies + 2


def test_band_smooth_bwd_tile_plan_matches_library(dev):
    """The Python tile plan is the one the library builds, with no
    spill, at the train step's and some edge shapes."""
    import ctypes
    lib = cuda_build.library()
    for dtype, code in pallas_pyramid._DTYPE_CODES.items():
        for b, h, w, c, k in [(16, 128, 128, 32, 2), (16, 64, 64, 64, 2),
                              (1, 1, 1, 8, 5), (1, 29, 1, 128, 3),
                              (1, 2160, 3840, 32, 2)]:
            v = (ctypes.c_int * 9)()
            assert lib.bid_band_smooth_bwd_info(h, w, c, k, code, v) == 0
            plan = pallas_pyramid.bwd_tile_plan(b, h, w, c, k, dtype)
            assert list(v)[:5] == [plan[key] for key in (
                "tile_w", "tile_h", "threads_x", "threads_y", "smem_bytes")]
            assert v[6] == 0 and v[7] >= 1


# C of no whole 16-byte vectors: 108 (the level-3 split of a
# filters_level_multiplier 1.5 depth-5 unet_laplacian_v6: 4 bf16 channels
# a thread), 36 (2 f32 channels), 6 and 3; and C of more vectors than a
# block has threads, which run as channel slices (2056: 257 bf16 vectors;
# 514: 257 2-channel vectors)
RAGGED_C = [108, 36, 6, 3, 2056, 514]


@pytest.mark.parametrize("c", RAGGED_C)
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_smooth_bwd_kernel_ragged_channels(dev, c, k, dtype):
    """K2's backward at any C: bit-exact against its plain version, one
    launch a call (the ragged tiles over 2 x 19 x 23, and the train step's
    16 x 16 x 16 at C = 108)."""
    for shape in ((2, 19, 23, c), (16, 16, 16, c)):
        g_band, g_smooth = _bwd_grads(dev, shape, dtype, seed=11)
        _assert_bwd_bit_exact(g_band, g_smooth, k)


@pytest.mark.parametrize("c", RAGGED_C)
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_split_kernel_ragged_channels(dev, c, k, dtype):
    """K4 at any C: bit-exact against its plain version, one launch a
    call."""
    g = torch.Generator(device="cpu").manual_seed(12)
    for shape in ((2, 18, 30, c), (8, 32, 32, c)):
        x = torch.randn(shape, generator=g).to(dev, dtype)
        before = pallas_pyramid.split_launches
        band, down = pallas_pyramid.band_split(x, k)
        torch.cuda.synchronize()
        assert pallas_pyramid.split_launches == before + 1
        band_p, down_p = pallas_pyramid.band_split_plain(x, k)
        for got, ref in ((band, band_p), (down, down_p)):
            assert got.dtype == dtype and got.shape == ref.shape
            assert float((got.float() - ref.float()).abs().max()) == 0.0


def test_band_tile_plans_match_library_at_ragged_c(dev):
    """K2 backward's and K4's Python tile plans are the ones the library
    builds at every ragged C, with no spill."""
    import ctypes
    lib = cuda_build.library()
    for dtype, code in pallas_pyramid._DTYPE_CODES.items():
        for c in RAGGED_C:
            for info, plan_of in (
                    (lib.bid_band_smooth_bwd_info,
                     pallas_pyramid.bwd_tile_plan),
                    (lib.bid_band_split_info,
                     pallas_pyramid.split_tile_plan)):
                v = (ctypes.c_int * 9)()
                assert info(16, 16, c, 2, code, v) == 0
                plan = plan_of(16, 16, 16, c, 2, dtype)
                assert list(v)[:5] == [plan[key] for key in (
                    "tile_w", "tile_h", "threads_x", "threads_y",
                    "smem_bytes")], (dtype, c, list(v))
                assert v[6] == 0 and v[7] >= 1


def _noise_case(dev, b=16, h=128, w=128):
    g = torch.Generator(device="cpu").manual_seed(3)
    x = (torch.rand((b, h, w, 3), generator=g) * 255).round().to(dev)
    return x, dict(additive_noise=[5, 40], multiplicative_noise=[0.05, 0.1])


def test_corrupt_noise_kernel_matches_plain(dev):
    x, kw = _noise_case(dev)
    before = pallas_noise.launches
    got, params = pallas_noise.corrupt_noise(1234, x, round_values=False,
                                             return_params=True, **kw)
    torch.cuda.synchronize()
    assert pallas_noise.launches == before + 1
    ref, ref_params = pallas_noise.corrupt_batch_plain(
        1234, x, round_values=False, return_params=True, **kw)
    assert torch.equal(params, ref_params)
    z0_mul, _, z0_add, _ = pallas_noise.normal_draws_plain(
        1234, x.shape[0], x[0].numel(), dev)
    edge = (((z0_mul.abs() - 2).abs() < 1e-5) & (params[:, :1] > 0)) | \
        (((z0_add.abs() - 2).abs() < 1e-5) & (params[:, 2:3] > 0))
    err = (got - ref).abs().reshape(x.shape[0], -1)
    assert float(err[~edge].max()) <= 1e-3
    rounded = pallas_noise.corrupt_noise(1234, x, **kw)
    rounded_ref = pallas_noise.corrupt_batch_plain(1234, x, **kw)
    diff = (rounded - rounded_ref).abs()
    assert torch.equal(rounded, rounded.round())
    assert float(diff.max()) <= 1.0
    assert float((diff > 0).float().mean()) <= 1e-4


def test_corrupt_noise_kernel_statistics(dev):
    x = torch.full((64, 128, 128, 3), 128.0, device=dev)
    y, p = pallas_noise.corrupt_noise(
        7, x, additive_noise=[5, 40], multiplicative_noise=[0.05, 0.1],
        return_params=True)
    assert torch.equal(y, pallas_noise.corrupt_noise(
        7, x, additive_noise=[5, 40], multiplicative_noise=[0.05, 0.1]))
    assert abs(float(y.mean()) - 128.0) < 1.0
    for col in (0, 2):
        assert abs(float(p[:, col].mean()) - 0.5) <= 0.15
    res = (y - x).reshape(64, -1)
    clean = (p[:, 0] == 0) & (p[:, 2] == 0)
    assert float(res[clean].abs().max()) == 0.0
    bound = 2 * (128 * p[:, 1] * p[:, 0] * 1.1 + p[:, 3] * p[:, 2]) + 0.5
    assert bool((res.abs().max(dim=1).values <= bound).all())


def _assert_noise_matches_plain(x, seed, kw, offset=0):
    before = pallas_noise.launches
    kw = dict(kw, sample_offset=offset)
    got, params = pallas_noise.corrupt_noise(seed, x, round_values=False,
                                             return_params=True, **kw)
    rounded = pallas_noise.corrupt_noise(seed, x, **kw)
    torch.cuda.synchronize()
    assert pallas_noise.launches == before + 2
    ref, ref_params = pallas_noise.corrupt_batch_plain(
        seed, x, round_values=False, return_params=True, **kw)
    assert got.shape == x.shape and torch.equal(params, ref_params)
    z0_mul, _, z0_add, _ = pallas_noise.normal_draws_plain(
        seed, x.shape[0], x[0].numel(), x.device, offset)
    edge = (((z0_mul.abs() - 2).abs() < 1e-5) & (params[:, :1] > 0)) | \
        (((z0_add.abs() - 2).abs() < 1e-5) & (params[:, 2:3] > 0))
    err = (got - ref).abs().reshape(x.shape[0], -1)[~edge]
    assert err.numel() == 0 or float(err.max()) <= 1e-3
    diff = (rounded - pallas_noise.corrupt_batch_plain(seed, x, **kw)).abs()
    assert torch.equal(rounded, rounded.round())
    assert float(diff.max()) <= 1.0
    assert float((diff > 0).float().mean()) <= 1e-4 or int(
        (diff > 0).sum()) <= 1
    return params


# [B, H, W, C]: n = H W C not a multiple of 4 (the scalar path), n below
# one thread's 4 elements, one sample, and 1000 samples
NOISE_SHAPES = [(3, 7, 5, 3), (5, 1, 1, 3), (4, 1, 1, 1), (1, 64, 64, 3),
                (1000, 8, 8, 3)]


@pytest.mark.parametrize("shape", NOISE_SHAPES)
@pytest.mark.parametrize("mul", [False, True])
@pytest.mark.parametrize("add", [False, True])
def test_corrupt_noise_kernel_shapes_and_modes(dev, shape, mul, add):
    g = torch.Generator(device="cpu").manual_seed(8)
    x = (torch.rand(shape, generator=g) * 255).round().to(dev)
    kw = dict(additive_noise=[5, 40] if add else None,
              multiplicative_noise=[0.05, 0.1] if mul else None)
    params = _assert_noise_matches_plain(x, 99, kw)
    if not (mul or add):
        assert torch.equal(pallas_noise.corrupt_noise(99, x, **kw), x)
    if shape[0] == 1000:
        for col in (0, 2):
            assert abs(float(params[:, col].mean()) - 0.5) <= 0.05


def test_corrupt_noise_kernel_sample_offset(dev):
    """A rank's rows of a global batch at ``sample_offset``: the kernel's
    output and per-sample params are rows of the kernel's global draw bit
    for bit, the params equal the plain version's at the offset bit for
    bit and the outputs agree with it at the kernel's tolerances."""
    x, kw = _noise_case(dev)
    full, params = pallas_noise.corrupt_noise(1234, x, return_params=True,
                                              **kw)
    for r in range(4):
        rows = slice(4 * r, 4 * r + 4)
        part, p = pallas_noise.corrupt_noise(1234, x[rows].contiguous(),
                                             return_params=True,
                                             sample_offset=4 * r, **kw)
        assert torch.equal(part, full[rows]) and torch.equal(p, params[rows])
        _assert_noise_matches_plain(x[rows].contiguous(), 1234, kw, 4 * r)
    same = pallas_noise.corrupt_noise(1234, x, sample_offset=0, **kw)
    assert torch.equal(same, pallas_noise.corrupt_noise(1234, x, **kw))


def _dp_cases():
    """The BatchNorm resnet of ``tests/test_parallel.py`` (seeded init)
    with flips and the noise kernel, two micro-batches."""
    from blind_image_denoising_torch.models.hydra import model_builder
    from blind_image_denoising_torch.training.train_state import init_params
    cfg = {"backbone": {
        "type": "resnet", "input_shape": ["?", "?", 3], "filters": 4,
        "no_layers": 1, "kernel_size": 3, "block_kernels": [3, 3],
        "block_filters": [4, 4], "activation": "relu", "batchnorm": True,
        "value_range": [0, 255], "kernel_regularizer": "l1",
        "kernel_initializer": "glorot_normal"},
        "denoiser": {"use_bias": False, "output_channels": 3}}
    model = model_builder(cfg).hydra
    init_params(model, torch.Generator().manual_seed(0))
    return [dict(model=cfg, params=dict(model.state_dict()),
                 loss={"hinge": 0.0, "mae_multiplier": 1.0,
                       "ssim_multiplier": -1.0, "regularization": 0.01},
                 optimizer={"type": "ADAM", "schedule": {
                     "type": "cosine_decay", "config": {
                         "learning_rate": 0.01, "decay_steps": 1000}}},
                 step=dict(additive_noise=[5, 10],
                           multiplicative_noise=[0.1, 0.2],
                           use_pallas_noise=True, grad_accum=2))]


def test_dp_step_on_card_matches_single_process(dev, tmp_path):
    """Two gloo ranks on the card (2 × b4, two micro-batches) against the
    single-process step on b8 on the card: loss within 1e-6 relative,
    params and running statistics within 1e-5 of each tensor's largest
    entry, each rank's noisy rows and K3 rows bit for bit, the ranks'
    params bit-equal."""
    import torch_parallel_workers as workers
    batch = np.random.default_rng(1).uniform(
        0, 255, (8, 16, 16, 3)).astype(np.float32)
    cases = _dp_cases()
    workers.run_cohort(2, "dp_steps", tmp_path, 300.0, device="cuda",
                       cases=cases, batch=batch, mesh_kw=dict(data=2))
    ranks = [workers.load_result(tmp_path / f"rank{r}.pt")["results"][0]
             for r in range(2)]
    ref = workers.run_steps(cases, batch, device="cuda")[0]
    assert len(ref["k3"]) == 2
    for index, got in enumerate(ranks):
        assert abs(got["metrics"]["total_loss"]
                   - ref["metrics"]["total_loss"]) <= 1e-6 * abs(
                       ref["metrics"]["total_loss"])
        for name, v in ref["params"].items():
            assert float((got["params"][name] - v).abs().max()) <= \
                1e-5 * float(v.abs().max()), name
            assert torch.equal(got["params"][name], ranks[0]["params"][name])
        for key in ("noisy", "k3"):
            for a, b in zip(ref[key], got[key]):
                assert torch.equal(a[index * 2:(index + 1) * 2], b), key


def test_spatial_forward_on_card_is_exact(dev, tmp_path):
    """A depth-2 ``unet_laplacian`` (JAX's spatial test model) in float32
    on 2 gloo ranks of the card, H sharded with its halo margin, against
    the unsharded forward on the card: within 1e-3."""
    import copy
    import torch_parallel_workers as workers
    from blind_image_denoising_torch.models.hydra import model_builder
    from blind_image_denoising_torch.parallel.spatial import (
        receptive_field_margin)
    from blind_image_denoising_torch.training.train_state import init_params
    cfg = {"backbone": {
        "type": "unet_laplacian", "input_shape": ["?", "?", 3], "depth": 2,
        "width": 1, "filters": 4, "encoder_kernel_size": 3,
        "decoder_kernel_size": 3, "use_self_attention": False,
        "multiple_scale_outputs": False, "depth_drop_rate": 0.0},
        "denoiser": {"filters": 4, "use_bias": False, "output_channels": 3}}
    model = model_builder(copy.deepcopy(cfg)).hydra
    init_params(model, torch.Generator().manual_seed(0))
    params = dict(model.state_dict())
    image = np.random.default_rng(0).uniform(
        0, 255, (1, 128, 64, 3)).astype(np.float32)
    margin = receptive_field_margin(2, 3, 1)
    conv = dict(weights={"c1": torch.randn(8, 3, 3, 3),
                         "c2": torch.randn(3, 8, 3, 3)},
                image=image, margin=2)
    workers.run_cohort(2, "spatial_cases", tmp_path, 300.0, device="cuda",
                       conv=conv, unet=dict(model_config=cfg, params=params,
                                            image=image, margin=margin,
                                            small_image=image[:, :16]),
                       spatial=2)
    model.to(dev).eval()
    with torch.no_grad():
        ref = model(torch.from_numpy(image).to(dev).permute(0, 3, 1, 2))[0]
    ref = ref.permute(0, 2, 3, 1).cpu()
    for r in range(2):
        got = workers.load_result(tmp_path / f"rank{r}.pt")
        assert float((got["unet"] - ref).abs().max()) <= 1e-3
        assert "exceeds the per-shard height" in got["error"]


def test_corrupt_noise_kernel_unaligned_batch(dev):
    """A batch that starts 4 bytes into its storage (n a multiple of 4):
    the kernel takes its scalar path and still matches."""
    g = torch.Generator(device="cpu").manual_seed(9)
    flat = (torch.rand(1 + 6 * 16 * 16 * 4, generator=g) * 255).round()
    x = flat.to(dev)[1:].view(6, 16, 16, 4)
    assert x.data_ptr() % 16 != 0
    _assert_noise_matches_plain(
        x, 5, dict(additive_noise=[5, 40], multiplicative_noise=[0.05, 0.1]))


def test_flagship_trains_two_steps_on_card(dev):
    """Two bf16 train steps of the packaged flagship at b4 @ 64² with the
    noise kernel: finite losses, 1 K3 + 2 K2 forward + 2 K2 backward
    launches per step, and no K1 launch."""
    import copy
    import blind_image_denoising_torch as bidt
    from blind_image_denoising_torch.config import load_config
    from blind_image_denoising_torch.models.hydra import model_builder
    from blind_image_denoising_torch.training import (
        build_train_step, create_train_state, loss_function_builder,
        optimizer_builder)
    from blind_image_denoising_torch.weights import (load_msgpack,
                                                     params_from_flax)
    cfg = load_config(bidt.CONFIGS_DICT["unet_laplacian_v6_tpu"])
    hydra = model_builder(copy.deepcopy(cfg["model"]),
                          dtype=torch.bfloat16).hydra
    tree = load_msgpack(bidt.models["unet_laplacian_v6_tpu_scratch"]
                        ["directory"] + "/params.msgpack")
    tx, _ = optimizer_builder(cfg["train"]["optimizer"])
    state = create_train_state(hydra, tx, params=params_from_flax(tree))
    ds = cfg["dataset"]
    step = build_train_step(
        hydra, tx, loss_function_builder(cfg["loss"]), hydra.no_outputs,
        additive_noise=ds["additional_noise"],
        multiplicative_noise=ds["multiplicative_noise"],
        use_pallas_noise=True)
    batch = (torch.rand((4, 64, 64, 3), device=dev) * 255).to(torch.uint8)
    counts = (pallas_convnext.launches, pallas_noise.launches,
              pallas_pyramid.launches, pallas_pyramid.bwd_launches)
    for _ in range(2):
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    now = (pallas_convnext.launches, pallas_noise.launches,
           pallas_pyramid.launches, pallas_pyramid.bwd_launches)
    assert tuple(a - b for a, b in zip(now, counts)) == (0, 2, 4, 4)
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())


# ---------------------------------------------------------------- artifacts

def _smooth_noisy(n, h, w, sigma, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    clean = np.stack([127.5 + 90 * np.sin(yy / h * (3 + c) + xx / w * 2)
                      for c in range(3)], -1)
    clean = np.broadcast_to(clean, (n, h, w, 3))
    noisy = np.clip(np.round(clean + rng.normal(0, sigma, clean.shape)),
                    0, 255).astype(np.uint8)
    return clean, noisy


@pytest.mark.parametrize("name,kw,sigma", [
    ("resnet_depthwise_scratch", {}, 25.0),
    ("unet_laplacian_v56_highnoise", {}, 60.0),
    ("unet_laplacian_v56_highnoise", {"quant": True}, 60.0)])
def test_packaged_artifacts_serve_on_card(dev, name, kw, sigma):
    """Each packaged artifact through load_model on the card: the resnet
    (bf16) and v56 (f32) against the port's f32 CPU output with the
    serving bars (bf16: mean <= 1, p99 <= 3; f32: max <= 1, >= 99%
    equal), v56 int8 within 2.5 gray levels (mean) of its f32 output on
    the card, and every output closer to the clean image than the input."""
    import blind_image_denoising_torch as bidt
    clean, noisy = _smooth_noisy(2, 96, 80, sigma)
    card = bidt.load_model(name, **kw)
    out = card(noisy)
    assert out.shape == noisy.shape and out.dtype == np.uint8
    assert np.abs(out - clean).mean() < np.abs(noisy - clean).mean()
    if kw.get("quant"):
        f32 = bidt.load_model(name)(noisy)
        assert np.abs(out.astype(int) - f32.astype(int)).mean() <= 2.5
        return
    ref = bidt.load_model(name, device="cpu", dtype="float32")(noisy)
    diff = np.abs(out.astype(int) - ref.astype(int))
    if card.model.dtype == torch.bfloat16:
        assert diff.mean() <= 1.0 and np.percentile(diff, 99) <= 3
    else:
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


def test_int8_accumulators_bit_exact_on_card(dev, monkeypatch):
    """Every int8 conv site of one v56 request: the int32 accumulator on
    the card equals the int64 plain version on the host, on the same
    codes."""
    import blind_image_denoising_torch as bidt
    from blind_image_denoising_torch.ops import quant
    calls = []
    real = quant.int8_conv

    def recording(x8, k8, strides, padding, groups):
        y = real(x8, k8, strides, padding, groups)
        calls.append((x8.cpu(), k8.cpu(), y.cpu(), strides, padding,
                      groups))
        return y

    monkeypatch.setattr(quant, "int8_conv", recording)
    den = bidt.load_model("unet_laplacian_v56_highnoise", quant=True)
    den(_smooth_noisy(1, 64, 64, 60.0)[1])
    assert len(calls) == 55
    for x8, k8, y, strides, padding, groups in calls:
        ref = quant.int8_conv_reference(x8, k8, strides, padding, groups)
        assert y.dtype == torch.int32 and torch.equal(y.long(), ref)


@pytest.mark.parametrize("name", ["unet_laplacian_v56_highnoise",
                                  "resnet_depthwise_scratch",
                                  "unet_laplacian_v6_tpu_scratch"])
def test_f32_forward_ignores_global_tf32_flags(dev, name):
    """A float32 forward gives the same output whether the process allows
    TF32 or not, and leaves the flags as it found them."""
    import blind_image_denoising_torch as bidt
    model = bidt.load_model(name, dtype="float32").model
    x = torch.from_numpy(_smooth_noisy(2, 64, 64, 25.0)[1]).to(
        dev).float().permute(0, 3, 1, 2)
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    outs = []
    try:
        for flag in (True, False):
            cudnn.allow_tf32 = matmul.allow_tf32 = flag
            with torch.no_grad():
                outs.append(model(x)[0])
            assert (cudnn.allow_tf32, matmul.allow_tf32) == (flag, flag)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
    assert torch.equal(outs[0], outs[1])


# ------------------------------------------------- the Denoiser's surface

@pytest.mark.parametrize("tta,shape", [(8, (1, 128, 96, 3)),
                                       (4, (2, 64, 64, 3)),
                                       (2, (1, 64, 64, 3))])
def test_tta_launches_kernels_per_member(dev, tta, shape):
    """Each TTA member is one flagship forward: 10 K1 and 2 K2 launches
    per member (transposed members of a non-square image included), and
    the ensemble keeps the uint8 contract."""
    import blind_image_denoising_torch as bidt
    den = bidt.load_model("unet_laplacian_v6_tpu_scratch", tta=tta)
    img = _smooth_noisy(*shape[:3], 20.0)[1]
    k1, k2 = pallas_convnext.launches, pallas_pyramid.launches
    out = den(img)
    assert out.shape == img.shape and out.dtype == np.uint8
    assert (pallas_convnext.launches - k1,
            pallas_pyramid.launches - k2) == (10 * tta, 2 * tta)


def test_tta_equivariant_on_card(dev):
    """The 8-member ensemble on the card is equivariant to a flip and a
    transpose of the input (its members are summed in float64)."""
    import blind_image_denoising_torch as bidt
    from blind_image_denoising_torch.inference.denoiser import Denoiser
    served = bidt.load_model("unet_laplacian_v6_tpu_scratch")
    den = Denoiser(served.model, cast_to_uint8=False, tta=8,
                   blend=served.blend)
    img = _smooth_noisy(1, 96, 96, 20.0)[1][0]
    y = den(img)
    assert np.abs(den(img[:, ::-1]) - y[:, ::-1]).max() <= 1e-2
    assert np.abs(den(img.transpose(1, 0, 2))
                  - y.transpose(1, 0, 2)).max() <= 1e-2


def test_resnet_tiled_equals_untiled_on_card(dev):
    """The fully convolutional resnet: 256-row tiles with a 64 halo give
    the untiled frame within one gray level, >= 99.9% equal. In float32,
    so the check is of the tiling: in bf16 the tiles' shapes let cuDNN
    pick other algorithms, whose other summation order flips a bf16
    rounding on ~0.4% of the pixels (chip_smoke.py holds the bf16
    artifact to the same bar on its 1024×768 frame)."""
    import blind_image_denoising_torch as bidt
    from blind_image_denoising_torch.inference.denoiser import Denoiser
    den = bidt.load_model("resnet_depthwise_scratch", dtype="float32")
    tiled = Denoiser(den.model, tile_rows=256, tile_halo=64)
    img = _smooth_noisy(1, 640, 384, 25.0)[1][0]
    diff = np.abs(tiled(img).astype(int) - den(img).astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


def test_dispatch_makes_no_host_sync(dev):
    """dispatch (pinned upload, the pipeline, the uint8 epilogue) and the
    HostCopy that starts the result's way back raise nothing under
    torch.cuda.set_sync_debug_mode("error"); the copy then equals the
    synchronous answer."""
    import blind_image_denoising_torch as bidt
    from blind_image_denoising_torch.inference.denoiser import HostCopy
    den = bidt.load_model("unet_laplacian_v6_tpu_scratch")
    img = _smooth_noisy(2, 64, 96, 20.0)[1]
    want = den(img)                         # builds and warms up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = den.dispatch(img)
        host = HostCopy(out)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out.is_cuda and out.dtype == torch.uint8
    np.testing.assert_array_equal(np.asarray(host), want)


def test_float_forward_gradient_on_card(dev):
    """The gradient of float_forward's sum with respect to the input, in
    float32 on the card, against the CPU: cosine >= 0.9999 and
    max |g_card - g_cpu| / max |g_cpu| <= 1e-3; K2's backward kernel
    launches, K1 does not (autograd takes the units' plain path)."""
    import blind_image_denoising_torch as bidt
    from blind_image_denoising_torch.ops.precision import exact_float32
    img = _smooth_noisy(1, 64, 64, 20.0)[1].astype(np.float32)
    grads = []
    for device in ("cuda", "cpu"):
        den = bidt.load_model("unet_laplacian_v6_tpu_scratch",
                              dtype="float32", device=device)
        x = torch.from_numpy(img).to(device).requires_grad_(True)
        k1, kb = pallas_convnext.launches, pallas_pyramid.bwd_launches
        with exact_float32(device == "cuda"):
            (g,) = torch.autograd.grad(den.float_forward(x).sum(), x)
        if device == "cuda":
            assert pallas_convnext.launches == k1
            assert pallas_pyramid.bwd_launches - kb == 2
        grads.append(g.double().cpu().ravel())
    cos = float(grads[0] @ grads[1] / grads[0].norm() / grads[1].norm())
    rel = float((grads[0] - grads[1]).abs().max() / grads[1].abs().max())
    assert cos >= 0.9999 and rel <= 1e-3, (cos, rel)


# ---------------------------------------------------------------- train loop

@pytest.mark.parametrize("shape", [(4, 256, 256, 32), (4, 128, 128, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_kernels_at_the_loop_shapes(dev, shape, dtype):
    """K2 and its backward at the training loop's micro-batch levels (b4 @
    256²): the forward within 1e-5 (f32) or one bf16 ulp, the backward
    bit-exact."""
    g = torch.Generator(device="cpu").manual_seed(4)
    x, g_band, g_smooth = (torch.randn(shape, generator=g).to(dev, dtype)
                           for _ in range(3))
    for got, ref in zip(pallas_pyramid.band_smooth(x, 2),
                        pallas_pyramid.band_smooth_plain(x, 2)):
        err = (got.float() - ref.float()).abs()
        if dtype == torch.float32:
            assert float(err.max()) <= 1e-5
        else:
            assert bool((err <= _bf16_ulp(ref)).all())
    dx = pallas_pyramid.band_smooth_bwd(g_band, g_smooth, 2)
    ref = pallas_pyramid.band_smooth_bwd_plain(g_band, g_smooth, 2)
    assert float((dx.float() - ref.float()).abs().max()) == 0.0


def test_noise_kernel_at_the_loop_shape(dev):
    x = torch.round(255 * torch.rand((4, 256, 256, 3), device=dev))
    _assert_noise_matches_plain(
        x, 11, dict(additive_noise=[5, 40], multiplicative_noise=[0.05, 0.1]))


@pytest.mark.parametrize("transfer", [None, np.uint8])
def test_device_prefetch_side_stream_matches_cpu(dev, transfer):
    """Batches copied from pinned buffers on the side stream equal the CPU
    path's, in order, also when the consumer queues work between them and
    the pinned buffers are reused."""
    from blind_image_denoising_torch.data.prefetch import device_prefetch
    rng = np.random.default_rng(6)
    batches = [np.round(rng.uniform(0, 255, (8, 64, 64, 3))).astype(
        np.float32) for _ in range(12)]
    cpu = [b.clone() for b in device_prefetch(batches, device="cpu",
                                              transfer_dtype=transfer)]
    got = []
    it = device_prefetch(batches, device=dev, prefetch=2,
                         transfer_dtype=transfer)
    for b in it:
        assert b.is_cuda
        torch.cuda._sleep(1_000_000)          # the consumer's stream lags
        got.append((b.float() * 1.0).cpu())
    assert not it.thread.is_alive()
    assert len(got) == len(cpu) == 12
    for g, c in zip(got, cpu):
        assert torch.equal(g, c.float())


def _tiny_loop_config(**train):
    import copy
    import blind_image_denoising_torch as bidt
    cfg = copy.deepcopy(bidt.CONFIGS_DICT["unet_laplacian_v6_tpu"])
    cfg["model"]["backbone"].update(filters=32, width=[1, 1, 1])
    cfg["train"].update(dict(dict(
        total_steps=3, checkpoint_every=-1, visualization_every=2,
        log_every=1, gpu_batches_per_step=2, ema=0.9, use_test_images=True),
        **train))
    cfg["dataset"].update(inputs=[], input_shape=[64, 64, 3], batch_size=2)
    cfg["tpu"] = {"compute_dtype": "bfloat16", "pallas_noise": True}
    return cfg


def test_remat_on_card_gives_the_loss_without_remat(dev):
    """bf16 forward_loss with drop-path and dropout on, with and without
    remat, on one generator seed: the same loss bit for bit and the same
    gradients within 1e-2 of each tensor's largest entry (cuDNN's backward
    may sum in another order between two runs)."""
    from blind_image_denoising_torch.models.hydra import model_builder
    from blind_image_denoising_torch.ops.multiscale import multiscale_targets
    from blind_image_denoising_torch.training import (forward_loss,
                                                      loss_function_builder)
    from blind_image_denoising_torch.training.train_state import init_params
    cfg = _tiny_loop_config()
    cfg["model"]["backbone"].update(
        depth_drop_rate=0.5, convolutional_self_attention_dropout_rate=0.5)
    hydra = model_builder(cfg["model"], dtype=torch.bfloat16).hydra
    init_params(hydra, torch.Generator().manual_seed(0))
    hydra.to(dev)
    clean = torch.round(255 * torch.rand((2, 64, 64, 3), device=dev))
    noisy = torch.round(clean + 10 * torch.randn(clean.shape, device=dev))
    gt = multiscale_targets(clean, 2, clip_values=True, round_values=True)
    fns = loss_function_builder(cfg["loss"])
    dw = torch.full((3,), 1.0 / 3, device=dev)
    out = {}
    for remat in (False, True):
        hydra.zero_grad(set_to_none=True)
        gen = torch.Generator(device=dev).manual_seed(3)
        total, _ = forward_loss(hydra, fns, 3, noisy, gt, dw, gen,
                                remat=remat)
        total.backward()
        out[remat] = (float(total.detach()),
                      {n: p.grad.float().clone()
                       for n, p in hydra.named_parameters()})
    assert out[True][0] == out[False][0]
    for n, g in out[False][1].items():
        scale = max(float(g.abs().max()), 1e-30)
        assert float((out[True][1][n] - g).abs().max()) <= 1e-2 * scale, n


def test_loop_steps_make_no_host_sync(dev, tmp_path, monkeypatch):
    """Three steps of train_loop on the card (bf16, the noise kernel, the
    EMA, a stats step and a sweep), each train step under
    torch.cuda.set_sync_debug_mode("error"): nothing inside a step waits
    for the device; the records are complete and finite."""
    import json
    import blind_image_denoising_torch as bidt
    from blind_image_denoising_torch.training import train_loop as loop
    real = loop.build_train_step

    def build(*args, **kw):
        step = real(*args, **kw)

        def strict(state, batch, **kws):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return step(state, batch, **kws)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return strict

    monkeypatch.setattr(loop, "build_train_step", build)
    state = bidt.train_loop(_tiny_loop_config(), tmp_path / "ckpt")
    assert state.step == 3 and state.ema_params is not None
    rows = [json.loads(line) for line in
            (tmp_path / "ckpt" / "metrics.jsonl").read_text().splitlines()]
    losses = {r["step"]: r["total_loss"] for r in rows if "total_loss" in r}
    assert sorted(losses) == [1, 2, 3]
    assert all(np.isfinite(v) for v in losses.values())
    assert any("eval/mae_noise_20" in r for r in rows)


# ------------------------------------------------- train → export → serve

def _flat_quant(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_quant(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = float(np.asarray(v))
    return out


def test_flagship_calibration_on_card_matches_cpu(dev):
    """The packaged flagship in float32 calibrated on the card (the f32
    hydra runs in exact float32 there, every ConvNext unit per site, no
    K1) against the same weights and images on the CPU: the same 53
    sites, scales within 1e-4 relative (the amax of a float32 forward
    summed in another order)."""
    import blind_image_denoising_torch as bidt
    from blind_image_denoising_torch.inference.quantize import calibrate
    images = _smooth_noisy(4, 64, 64, 25.0)[1].astype(np.float32)
    k1 = pallas_convnext.launches
    card = _flat_quant(calibrate(bidt.load_model(
        "unet_laplacian_v6_tpu_scratch", dtype="float32").model, images))
    assert pallas_convnext.launches == k1
    cpu = _flat_quant(calibrate(bidt.load_model(
        "unet_laplacian_v6_tpu_scratch", dtype="float32",
        device="cpu").model, images))
    assert set(card) == set(cpu) and len(cpu) == 53
    for k, v in cpu.items():
        assert card[k] == pytest.approx(v, rel=1e-4), k


@pytest.mark.parametrize("batchnorm", [True, "bias_free"])
def test_batch_norm_train_step_on_card_matches_cpu(dev, batchnorm):
    """One float32 train step of the resnet config at its full width
    (filters 32, 6 layers) from the same seeded weights on the same batch
    (noise and flips off), 2 micro-batches: the loss within 1e-5
    relative and every running statistic within 1e-4 of its tensor's
    largest magnitude on the card against the CPU."""
    import copy
    import blind_image_denoising_torch as bidt
    from blind_image_denoising_torch.models.hydra import model_builder
    from blind_image_denoising_torch.training import (
        build_train_step, create_train_state, loss_function_builder,
        optimizer_builder)
    cfg = copy.deepcopy(bidt.CONFIGS_DICT[
        "resnet_color_1x6_bn_32x128x32_1x3x1_128x128_depthwise_l1_relu"])
    cfg["model"]["backbone"]["batchnorm"] = batchnorm
    batch = torch.from_numpy(_smooth_noisy(4, 64, 64, 30.0)[1])
    out = {}
    for device in ("cpu", "cuda"):
        hydra = model_builder(copy.deepcopy(cfg["model"])).hydra
        tx, _ = optimizer_builder(cfg["train"]["optimizer"])
        state = create_train_state(hydra, tx, seed=5, device=device)
        step = build_train_step(hydra, tx, loss_function_builder(cfg["loss"]),
                                hydra.no_outputs, grad_accum=2,
                                random_left_right=False, random_up_down=False)
        state, metrics = step(state, batch)
        out[device] = (float(metrics["total_loss"]),
                       {k: v.cpu() for k, v in hydra.named_buffers()})
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for k, v in out["cpu"][1].items():
        rel = float((out["cuda"][1][k] - v).abs().max() / v.abs().max())
        assert rel <= 1e-4, (k, rel)


def test_export_serves_through_k1_and_k2_on_card(dev, tmp_path):
    """A narrow flagship config (depth 2, one unit a level) trained two
    steps on the card, exported on the card with ``quantize=True`` and
    ``test_model=True``: its float route (bf16, the config's dtype)
    launches K1 once per ConvNext unit and K2 once per band split (2 and
    1), and its ``quant=True`` route no K1 (the units run per site, as in
    JAX) and the same one K2."""
    import copy
    import blind_image_denoising_torch as bidt
    from blind_image_denoising_torch.inference.export import export_model
    cfg = copy.deepcopy(bidt.CONFIGS_DICT["unet_laplacian_v6_tpu"])
    cfg["model"]["backbone"].update(depth=2, filters=32, width=[1, 1],
                                    encoder_kernel_size=[3, 5],
                                    decoder_kernel_size=[3, 5])
    cfg["train"].update(total_steps=2, checkpoint_every=-1,
                        visualization_every=-1, use_test_images=False,
                        ema=0.5)
    cfg["dataset"].update(inputs=[], input_shape=[64, 64, 3], batch_size=2)
    bidt.train_loop(cfg, tmp_path / "run")
    out = export_model(cfg, tmp_path / "run", tmp_path / "artifact",
                       quantize=True, test_model=True)
    img = _smooth_noisy(2, 64, 64, 20.0)[1]
    for kw, want in (({}, (2, 1)), ({"quant": True}, (0, 1))):
        den = bidt.load_model(out, **kw)
        k1, k2 = pallas_convnext.launches, pallas_pyramid.launches
        res = den(img)
        assert res.shape == img.shape and res.dtype == np.uint8
        assert (pallas_convnext.launches - k1,
                pallas_pyramid.launches - k2) == want, kw


@pytest.mark.parametrize("name,per_forward", [
    ("unet_laplacian_v3", dict(k1=18, k2=3, branch=0)),
    ("unet_laplacian_v4", dict(k1=18, k2=3, branch=0)),
    ("unet_laplacian_v5", dict(k1=12, k2=2, branch=0))])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_unet_laplacian_family_launches_per_forward(dev, name, per_forward,
                                                    dtype):
    """v3 / v4 / v5 at full width from a seeded init: K1 at every unit
    (C = 32, 64 and 128; the decoders' at K = 1), K2 per band split, no
    unit on its PyTorch branch; the f32 forward's outputs
    within a mean of 1e-3 gray levels of the CPU's (the fused f32 path's
    bar) and a max of 1e-2 (the card and the CPU sum in other orders:
    0.0022 at most on v3 / v4)."""
    import copy
    import blind_image_denoising_torch as bidt
    from blind_image_denoising_torch.models.hydra import model_builder
    from blind_image_denoising_torch.training.train_state import init_params
    cfg = copy.deepcopy(bidt.CONFIGS_DICT[name]["model"])
    model = model_builder(cfg, dtype=dtype).hydra
    init_params(model, torch.Generator().manual_seed(0))
    model.eval().requires_grad_(False)
    x = torch.rand((2, 3, 64, 64), generator=torch.Generator().manual_seed(
        1)) * 255
    ref = model(x) if dtype is None else None
    model.to(dev)
    c0 = (pallas_convnext.launches, pallas_pyramid.launches,
          pallas_convnext.branch_units)
    with torch.no_grad():
        outs = model(x.to(dev))
    torch.cuda.synchronize()
    assert (pallas_convnext.launches - c0[0], pallas_pyramid.launches - c0[1],
            pallas_convnext.branch_units - c0[2]) == (
        per_forward["k1"], per_forward["k2"], per_forward["branch"])
    if ref is not None:
        for r, o in zip(ref, outs):
            diff = (o.cpu() - r).abs()
            assert float(diff.mean()) <= FUSED_F32_CARD_VS_CPU_MEAN
            assert float(diff.max()) <= 1e-2


# ------------------------------------------------- the restoration path

def _restoration_batch(n=4, size=64, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.round(rng.uniform(0, 255, (n, size, size, 3))
                                     ).astype(np.float32))


def test_degradation_ops_on_card_match_cpu(dev):
    """Each deterministic op of the chain on the card against the CPU, at
    the CPU tests' bars against JAX: rotation 1e-3, blur 1e-4, JPEG mean
    1e-3 with >= 99.9% within 1e-2 (exact float32 on the card), posterize
    and holes from a given mask exact."""
    from blind_image_denoising_torch.ops import degradations as deg
    x = _restoration_batch()
    keep = torch.rand((4, 64, 64, 1),
                      generator=torch.Generator().manual_seed(1)) >= 0.1
    cases = {
        "rotate": (lambda t: deg.rotate_batch(
            t, torch.tensor([-1.57, -0.3, 0.3, 1.57], device=t.device)), 1e-3),
        "blur": (lambda t: deg.separable_blur_batch(
            t, torch.tensor([0.1, 0.7, 1.3, 2.0], device=t.device)), 1e-4),
        "posterize": (lambda t: deg.quantize_batch(t, 8.0), 0.0),
        "holes": (lambda t: deg.inpaint_dropout(
            None, t, 0.1, keep=keep.to(t.device)), 0.0)}
    for name, (fn, bar) in cases.items():
        got, ref = fn(x.to(dev)).cpu(), fn(x)
        assert float((got - ref).abs().max()) <= bar, name
    q = torch.tensor([25.0, 40.0, 60.0, 75.0])
    d = (deg.jpeg_artifacts(x.to(dev), q.to(dev)).cpu()
         - deg.jpeg_artifacts(x, q)).abs()
    assert float(d.mean()) <= 1e-3
    assert float((d <= 1e-2).float().mean()) >= 0.999


def test_apply_degradations_on_card_equals_cpu(dev):
    """``evaluate.apply_degradations`` on the card against the CPU on each
    of the recipe's specs: the noise and the holes are the CPU's draws,
    so after rounding >= 99.9% of pixels are equal and none is off by
    more than one gray level."""
    from blind_image_denoising_torch import evaluate
    images = _restoration_batch(2, 96).numpy()
    for spec in ("jpeg:30", "blur:1.5+noise:25", "noise:30+jpeg:50",
                 "posterize:8+noise:20", "holes:0.1+noise:10"):
        card = evaluate.apply_degradations(images, spec, seed=3)
        host = evaluate.apply_degradations(images, spec, seed=3,
                                           device="cpu")
        d = np.abs(card - host)
        assert (d == 0).mean() >= 0.999 and d.max() <= 1.0, spec


def test_restoration_step_makes_no_host_sync(dev):
    """The recipe's train step (rotation, blur, JPEG, posterize, holes,
    master gate 0.5, log-uniform noise) on a narrowed flagship in bf16,
    two steps under ``torch.cuda.set_sync_debug_mode("error")``: no sync,
    finite losses, K2 and its backward once per band split and micro-batch
    and no noise kernel."""
    from blind_image_denoising_torch.models.hydra import model_builder
    from blind_image_denoising_torch.training import (
        build_train_step, create_train_state, loss_function_builder,
        optimizer_builder)
    cfg = _tiny_loop_config()
    hydra = model_builder(cfg["model"], dtype=torch.bfloat16).hydra
    tx, _ = optimizer_builder(cfg["train"]["optimizer"])
    state = create_train_state(hydra, tx, seed=0)
    step = build_train_step(
        hydra, tx, loss_function_builder(cfg["loss"]), hydra.no_outputs,
        additive_noise=[1, 80], noise_sampling="log_uniform", grad_accum=2,
        random_rotate=1.57, use_random_blur=True, use_jpeg_noise=True,
        quantization=8, inpaint_drop_rate=0.05, degradation_chain_prob=0.5)
    batch = _restoration_batch().to(dev)
    dw = torch.full((hydra.no_outputs,), 1.0 / hydra.no_outputs, device=dev)
    state, _ = step(state, batch, depth_weights=dw)
    torch.cuda.synchronize()
    before = (pallas_pyramid.launches, pallas_pyramid.bwd_launches,
              pallas_noise.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            state, metrics = step(state, batch, depth_weights=dw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert np.isfinite(float(metrics["total_loss"]))
    splits = hydra.no_outputs - 1
    assert (pallas_pyramid.launches - before[0],
            pallas_pyramid.bwd_launches - before[1],
            pallas_noise.launches - before[2]) == (
        2 * 2 * splits, 2 * 2 * splits, 0)


def test_unet_backbone_train_step_on_card_matches_cpu(dev):
    """A float32 unet (builder defaults, gates, sparse features,
    he_normal) forward and backward in train mode on the card against the
    CPU from the same seeded weights: loss within 1e-4 relative, gradient
    cosine >= 0.9999; no K1-K4 launch."""
    import copy
    import torch.nn.functional as F
    from blind_image_denoising_torch.models.hydra import model_builder
    from blind_image_denoising_torch.ops.multiscale import multiscale_targets
    from blind_image_denoising_torch.ops.precision import exact_float32
    from blind_image_denoising_torch.training import (forward_loss,
                                                      loss_function_builder)
    from blind_image_denoising_torch.training.train_state import init_params
    mc = {"backbone": {"type": "unet", "input_shape": ["?", "?", 3],
                       "value_range": [0, 255], "add_gates": True,
                       "add_sparse_features": True,
                       "kernel_initializer": "he_normal"},
          "denoiser": {"output_channels": 3}}
    seeded = model_builder(copy.deepcopy(mc)).hydra
    init_params(seeded, torch.Generator().manual_seed(0))
    clean = _restoration_batch(4, 64, seed=2)
    noisy = torch.round(clean + 20 * torch.randn(
        clean.shape, generator=torch.Generator().manual_seed(3)))
    gt = multiscale_targets(clean, 0, clip_values=True, round_values=True)
    fns = loss_function_builder({"hinge": 0.5, "mae_multiplier": 1.0})
    out = {}
    before = (pallas_convnext.launches, pallas_pyramid.launches)
    for device in ("cpu", dev):
        hydra = model_builder(copy.deepcopy(mc)).hydra
        hydra.load_state_dict(seeded.state_dict())
        hydra.to(device)
        with exact_float32(device != "cpu"):
            total, _ = forward_loss(hydra, fns, 1, noisy.to(device),
                                    [g.to(device) for g in gt],
                                    torch.ones((1,), device=device),
                                    torch.Generator(device=device))
            total.backward()
        out[str(device)] = (float(total.detach()), torch.cat([
            (torch.zeros_like(p) if p.grad is None else p.grad)
            .double().flatten().cpu() for p in hydra.parameters()]))
    torch.cuda.synchronize()
    assert (pallas_convnext.launches, pallas_pyramid.launches) == before
    cpu, card = out["cpu"], out[str(dev)]
    assert abs(card[0] - cpu[0]) <= 1e-4 * abs(cpu[0])
    assert float(F.cosine_similarity(card[1], cpu[1], dim=0)) >= 0.9999


# ------------------------------------------------ forward mode and the tools

def test_forward_mode_tangents_on_card_equal_the_plain_versions(dev):
    """A dual tensor through a K1-routed ConvNext unit and through K2 on
    the card: the unit takes its branch (no K1 launch) and its tangent
    equals the CPU branch's (1e-4 of the largest); K2's tangents are the
    plain split of the tangent (1e-5), one launch for the primal and one
    for the tangent; ``convnext_block`` and ``band_split`` refuse a dual
    tensor instead of dropping its tangent."""
    from torch.autograd import forward_ad
    from blind_image_denoising_torch.layers.convnext import ConvNextBlock
    torch.manual_seed(0)
    unit = ConvNextBlock(32, kernel_size=3, expansion=128)
    assert unit.kernel_route
    with torch.no_grad():
        for p in unit.parameters():
            p.normal_(0, 0.2)
    unit.requires_grad_(False)
    x, v = torch.randn(2, 32, 16, 16), torch.randn(2, 32, 16, 16)
    tangents = {}
    for device in ("cpu", dev):
        unit.to(device)
        k1 = pallas_convnext.launches
        with torch.no_grad(), forward_ad.dual_level():
            y = unit(forward_ad.make_dual(
                x.to(device).contiguous(memory_format=torch.channels_last),
                v.to(device).contiguous(memory_format=torch.channels_last)))
            tangents[str(device)] = forward_ad.unpack_dual(
                y).tangent.float().cpu()
        assert pallas_convnext.launches == k1
    ref = tangents["cpu"]
    assert float((tangents[str(dev)] - ref).abs().max()
                 / ref.abs().max()) <= 1e-4
    xh = torch.randn(2, 32, 32, 32, device=dev)
    vh = torch.randn(2, 32, 32, 32, device=dev)
    k2 = pallas_pyramid.launches
    with forward_ad.dual_level():
        band, smooth = pallas_pyramid.band_smooth(
            forward_ad.make_dual(xh, vh), 2)
        got = [forward_ad.unpack_dual(t).tangent for t in (band, smooth)]
        w = unit.kernel_weights(torch.float32)
        dual = forward_ad.make_dual(xh, vh)
        with pytest.raises(RuntimeError, match="forward-mode"):
            pallas_convnext.convnext_block(dual, slope=unit.slope, **w)
        with pytest.raises(RuntimeError, match="tangent"):
            pallas_pyramid.band_split(dual)
    assert pallas_pyramid.launches - k2 == 2
    want = pallas_pyramid.band_smooth_plain(vh, 2)
    for g, r in zip(got, want):
        assert float((g - r).abs().max()) <= 1e-5


def test_distilled_step_on_card_matches_cpu(dev):
    """One float32 micro-batch of the flagship's distilled step (its
    packaged weights, a teacher output from the f32 v5.6 teacher on the
    same batch, gt_weight 0.5): the loss within 1e-4 relative and the
    gradient's cosine >= 0.9999, card against CPU; drop-path and attention
    dropout off."""
    import copy
    import torch.nn.functional as F
    import blind_image_denoising_torch as bidt
    from blind_image_denoising_torch.models.hydra import model_builder
    from blind_image_denoising_torch.ops.multiscale import multiscale_targets
    from blind_image_denoising_torch.ops.precision import exact_float32
    from blind_image_denoising_torch.training import (forward_loss,
                                                      loss_function_builder)
    from blind_image_denoising_torch.training.distill import build_teacher
    from blind_image_denoising_torch.weights import (load_msgpack,
                                                     params_from_flax)
    cfg = copy.deepcopy(bidt.CONFIGS_DICT["unet_laplacian_v6_tpu"])
    # drop-path and attention dropout off: their masks come from each
    # device's own generator
    cfg["model"]["backbone"].update(
        depth_drop_rate=0.0, convolutional_self_attention_dropout_rate=0.0)
    params = params_from_flax(load_msgpack(
        bidt.models["unet_laplacian_v6_tpu_scratch"]["directory"]
        + "/params.msgpack"))
    clean = torch.from_numpy(np.ascontiguousarray(
        _smooth_noisy(2, 64, 64, 20.0)[0])).float()
    noisy = torch.round(clean + 20 * torch.randn(
        clean.shape, generator=torch.Generator().manual_seed(3)))
    n = model_builder(cfg["model"]).hydra.no_outputs
    gt = multiscale_targets(clean, n - 1, clip_values=True,
                            round_values=True)
    fns = loss_function_builder(cfg["loss"])
    out = {}
    for device in ("cpu", dev):
        teacher_fn, opts = build_teacher(
            {"teacher": "unet_laplacian_v56_highnoise", "gt_weight": 0.5},
            device=device)
        hydra = model_builder(cfg["model"]).hydra
        hydra.load_state_dict(params)
        hydra.to(device)
        x = noisy.to(device)
        with exact_float32(device != "cpu"):
            total, _ = forward_loss(
                hydra, fns, n, x, [g.to(device) for g in gt],
                torch.full((n,), 1.0 / n, device=device),
                torch.Generator(device=device), teacher_out=teacher_fn(x),
                distill_weight=opts["weight"], gt_weight=opts["gt_weight"])
            total.backward()
        out[str(device)] = (float(total.detach()), torch.cat([
            (torch.zeros_like(p) if p.grad is None else p.grad)
            .double().flatten().cpu() for p in hydra.parameters()]))
    cpu, card = out["cpu"], out[str(dev)]
    assert abs(card[0] - cpu[0]) <= 1e-4 * abs(cpu[0])
    assert float(F.cosine_similarity(card[1], cpu[1], dim=0)) >= 0.9999


def test_analysis_on_card_matches_cpu(dev):
    """``analysis.analyze`` of the f32 flagship on a noisy 64² crop, card
    against CPU: the denoised image and the bias map within 1e-3 gray
    levels on average, each filter row's cosine >= 0.9999 and max |Δ| /
    max |a| <= 1e-2; no K1 launch in either derivative mode; the bias
    map from forward mode (two K2 launches on the tangent beside the
    primal's)."""
    import blind_image_denoising_torch as bidt
    from blind_image_denoising_torch import analysis
    img = _smooth_noisy(1, 64, 64, 25.0)[1][0].astype(np.float32)
    out = {}
    for device in ("cpu", dev):
        den = bidt.load_model("unet_laplacian_v6_tpu_scratch",
                              dtype="float32", device=device)
        fwd = analysis.forward_from_denoiser(den)
        k1, k2 = pallas_convnext.launches, pallas_pyramid.launches
        y, bias = analysis.net_bias_map(fwd, img)
        res = analysis.adaptive_filters(fwd, img, [(16, 16), (40, 50)])
        if device != "cpu":
            assert pallas_convnext.launches == k1
            assert pallas_pyramid.launches - k2 == 4 + 2
        out[str(device)] = (y, bias, res.filters)
    cpu, card = out["cpu"], out[str(dev)]
    assert np.abs(card[0] - cpu[0]).mean() <= 1e-3
    assert np.abs(card[1] - cpu[1]).mean() <= 1e-3
    for a, b in zip(card[2], cpu[2]):
        a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
        assert a @ b / np.linalg.norm(a) / np.linalg.norm(b) >= 0.9999
        assert np.abs(a - b).max() / np.abs(b).max() <= 1e-2
