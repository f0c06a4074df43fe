#!/usr/bin/env python3
"""Time versions of the band-split kernels of ``band_smooth.cu`` (K2's
backward ``bid_band_smooth_bwd`` and the decimating split K4
``bid_band_split``) and of the noise kernel K3 (``bid_corrupt_noise`` in
``corrupt_noise.cu``) against each other on one NVIDIA GPU, inside one
process: the backward at the flagship train step's shapes 16×128²×32
and 16×64²×64 bf16 with k = 2, K4 at the flagship's level-0/1 band
shapes of a b8 @ 256² request, 8×256²×32 and 8×128²×64 bf16 with k = 2,
the noise at 16×128²×3 f32 with the train config's noise ranges.

    python3 band_noise_compare.py [--rounds N] [--out DIR] \
        [--kernels bwd,split,noise] NAME=SOURCE[@CUT[+CUT...]] ...

Each SOURCE is a ``band_smooth.cu`` or a ``corrupt_noise.cu`` (the
checkout's, or a parent commit's unpacked beside it); ``common.cuh`` is
taken from the checkout. A ``band_smooth.cu`` is timed as K2's backward
and as K4, unless ``--kernels`` names fewer. ``@CUT`` builds a copy of
SOURCE with a part of a kernel cut out or replaced (``CUTS`` below names
each one and the exact text it replaces; a cut whose text is not in
SOURCE fails), to split a kernel's time into its parts: a cut copy
computes other values, and its difference from the plain version is
printed, not checked.
Every source is compiled by ``nvcc`` for ``sm_90a`` into a library of its
own, and the libraries are timed in turns (in the given order in even
rounds, reversed in odd ones: parent, change, change, parent with two
names and two rounds), each both warm (20 calls on one set of inputs,
which may sit in the 50 MB L2) and cold (rotating over copies that move
twice the L2 between two uses, ``chip_smoke.cold_copies``). Per source
and shape it prints one JSON line with the device milliseconds of every
round (CUDA events around calls queued behind a spin kernel), the
bound, the share of the bound of the best cold time, and the largest
difference from the plain PyTorch version; then the card's name and
power limit. With ``--out DIR`` the compiler's resource report
(``-Xptxas -v``) and the SASS (``cuobjdump -sass``) of every source are
written to ``DIR/NAME.ptxas.txt`` and ``DIR/NAME.sass.txt``.
"""

import argparse
import copy
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from chip_smoke import (TRAIN_BATCH, TRAIN_CONFIG, TRAIN_SIZE, band_bound_ms,
                        cold_copies, cuda_ms, noise_bound_ms,
                        synthetic_images)

BWD_SHAPES = [(TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 32),
              (TRAIN_BATCH, TRAIN_SIZE // 2, TRAIN_SIZE // 2, 64)]
SPLIT_SHAPES = [(8, 256, 256, 32), (8, 128, 128, 64)]
# C of no whole 16-byte vectors (a source that refuses them skips the row):
# the level-3 band split of a filters_level_multiplier 1.5 depth-5
# unet_laplacian_v6, C = 108, in its train step (b16 @ 128²) and in a b8 @
# 256² request
BWD_RAGGED_SHAPES = [(TRAIN_BATCH, TRAIN_SIZE // 8, TRAIN_SIZE // 8, 108)]
SPLIT_RAGGED_SHAPES = [(8, 32, 32, 108)]
NOISE_SEED = 20260802

_BWD_REGION = ("band_smooth_bwd_kernel(", 'extern "C" int bid_band_smooth_bwd')
# K4 of band_smooth.cu, first version: the grid-stride pooling loop it
# shared with K2's forward (band_smooth_kernel<T, true>) and its launch
_SPLIT_REGION = ("band_smooth_kernel(", "// Tile plan of the backward")
_NOISE_REGION = ("corrupt_noise_kernel(", "")
_WHOLE = ("", "")
# name -> (region of the source the edits apply to, [(text, replacement)]):
# each text must occur exactly once in the region
CUTS = {
    # K4 of band_smooth.cu, first version (grid-stride, flat index)
    # (a) the five 64-bit % and / of the index, as shifts and masks (the
    # same values when C / V, W and H are powers of two)
    "split-index": (_SPLIT_REGION, [(
        "    const int cv = (int)(i % cv_n);\n"
        "    const long long pix = i / cv_n;\n"
        "    const int w = (int)(pix % W);\n"
        "    const long long bh = pix / W;\n"
        "    const int h = (int)(bh % H);\n"
        "    const long long b = bh / H;\n",
        "    const int cv = (int)(i & (cv_n - 1));\n"
        "    const long long pix = i >> (__ffs(cv_n) - 1);\n"
        "    const int w = (int)(pix & (W - 1));\n"
        "    const long long bh = pix >> (__ffs(W) - 1);\n"
        "    const int h = (int)(bh & (H - 1));\n"
        "    const long long b = bh >> (__ffs(H) - 1);\n")]),
    # (b) the per-pixel tap count and IEEE reciprocal, as a constant
    "split-divide": (_SPLIT_REGION, [(
        "const float inv = __fdiv_rn(1.f, (float)(rows * cols));",
        "const float inv = 0.25f;")]),
    # (c) every tap reads the thread's own pixel (L1), not its neighbours
    "split-taps": (_SPLIT_REGION, [(
        "x + ((b * H + y) * W + xx) * C + cv * V);",
        "x + ((b * H + h) * W + w) * C + cv * V);")]),
    # (d) no cap on the grid: one vector per thread, no grid-stride turns
    "split-cap": (_SPLIT_REGION, [("if (blocks > cap) blocks = cap;",
                                   "(void)cap;")]),
    # (e) every thread stores its smooth into down, at its quad's address
    # (four threads a vector, so no lane idles on the store)
    "split-down": (_SPLIT_REGION, [("} else if (((h | w) & 1) == 0) {",
                                    "} else {")]),
    # the kernel returns at once (launch and the capped grid: the floor)
    "split-empty": (_SPLIT_REGION, [(
        "  const int lo = (k - 1) / 2;\n  for (long long i",
        "  if (n != 0) return;\n  const int lo = (k - 1) / 2;\n"
        "  for (long long i")]),
    # K2 backward of band_smooth.cu, first version (grid-stride, flat index)
    # (a) the five 64-bit % and / of the index, as shifts and masks (the
    # same values when C / V, W and H are powers of two)
    "bwd-index": (_BWD_REGION, [(
        "    const int cv = (int)(i % cv_n);\n"
        "    const long long pix = i / cv_n;\n"
        "    const int w = (int)(pix % W);\n"
        "    const long long bh = pix / W;\n"
        "    const int h = (int)(bh % H);\n"
        "    const long long b = bh / H;\n",
        "    const int cv = (int)(i & (cv_n - 1));\n"
        "    const long long pix = i >> (__ffs(cv_n) - 1);\n"
        "    const int w = (int)(pix & (W - 1));\n"
        "    const long long bh = pix >> (__ffs(W) - 1);\n"
        "    const int h = (int)(bh & (H - 1));\n"
        "    const long long b = bh >> (__ffs(H) - 1);\n")]),
    # (b) the per-tap tap count and IEEE reciprocal, as a constant
    "bwd-divide": (_BWD_REGION, [(
        "const float inv = __fdiv_rn(1.f, (float)(rows * cols));",
        "const float inv = 0.25f;")]),
    # (c) every tap reads the thread's own pixel (L1), not its neighbours
    "bwd-taps": (_BWD_REGION, [(
        "const long long off = ((b * H + y) * W + xx) * C + cv * V;",
        "const long long off = ((b * H + h) * W + w) * C + cv * V;")]),
    # (d) no cap on the grid: one vector per thread, no grid-stride turns
    "bwd-cap": (_BWD_REGION, [("if (blocks > cap) blocks = cap;",
                               "(void)cap;")]),
    # K3 of corrupt_noise.cu, first version (per-sample blocks, one element
    # a thread)
    # (b) every thread computes its sample's header: no barrier, no
    # shared memory
    "noise-header": (_NOISE_REGION, [
        ("  __shared__ Header hdr;\n  if (threadIdx.x == 0) {\n"
         "    hdr = sample_header(key, b, mlo, mhi, alo, ahi);\n",
         "  const Header hdr = sample_header(key, b, mlo, mhi, alo, ahi);\n"
         "  if (threadIdx.x == 0) {\n"),
        ("  __syncthreads();\n", "")]),
    # the element's Philox call, as a few integer operations
    "noise-philox": (_NOISE_REGION, [(
        "const uint4 w = philox4x32_10(make_uint4((uint32_t)e, b, 0u, 0u), "
        "key);",
        "const uint4 w = make_uint4((uint32_t)e * 0x9E3779B9u, "
        "(uint32_t)e ^ b, (uint32_t)e * 0x85EBCA6Bu, (uint32_t)e + b);")]),
    # the Box-Muller pair and its redraw, as a difference of uniforms
    "noise-boxmuller": (("truncated_normal(uint32_t a", "sample_header"), [(
        "  const float u1 = bits_to_uniform(a), u2 = bits_to_uniform(b);\n"
        "  const float r = __fsqrt_rn(__fmul_rn(-2.f, logf(fmaxf(u1, "
        "1e-12f))));\n"
        "  float s, c;\n"
        "  sincosf(__fmul_rn(6.2831855f, u2), &s, &c);\n"
        "  const float z0 = __fmul_rn(r, c), z1 = __fmul_rn(r, s);\n"
        "  const float z = fabsf(z0) <= 2.f ? z0 : z1;\n"
        "  return fminf(fmaxf(z, -2.f), 2.f);\n",
        "  return __fsub_rn(bits_to_uniform(a), bits_to_uniform(b));\n")]),
    # (d) every sample with both noises on, or with none
    "noise-all-on": (_NOISE_REGION, [
        ("const bool mul = use_mul && hdr.mul_on != 0.f;",
         "const bool mul = use_mul;"),
        ("const bool add = use_add && hdr.add_on != 0.f;",
         "const bool add = use_add;")]),
    "noise-all-off": (_NOISE_REGION, [
        ("const bool mul = use_mul && hdr.mul_on != 0.f;",
         "const bool mul = false;"),
        ("const bool add = use_add && hdr.add_on != 0.f;",
         "const bool add = false;")]),
    # (a) no cap on the grid: one element per thread
    "noise-cap": (_NOISE_REGION, [("if (per_sample > cap) per_sample = cap;",
                                   "(void)cap;")]),
    # either version of K3: the kernel returns at once (launch and grid)
    "noise-empty": (_NOISE_REGION, [(
        "const uint2 key = make_uint2(seed, 0u);",
        "if (n != 0) return;\n  const uint2 key = make_uint2(seed, 0u);")]),
    # K3, redesigned version: the four Philox calls of a quad, as a few
    # integer operations each
    "noise2-philox": (_NOISE_REGION, [(
        "w[j] = philox4x32_10(make_uint4(e0 + j, b, 0u, 0u), key);",
        "w[j] = make_uint4((e0 + j) * 0x9E3779B9u, (e0 + j) ^ b, "
        "(e0 + j) * 0x85EBCA6Bu, e0 + j + b);")]),
    # its levers: 256 or 64 threads a block instead of 128; the blocks
    # ordered sample by sample (grid x over samples), so that consecutive
    # blocks belong to other samples
    "noise2-threads256": (_WHOLE, [("constexpr int kNoiseThreads = 128;",
                                    "constexpr int kNoiseThreads = 256;")]),
    "noise2-threads64": (_WHOLE, [("constexpr int kNoiseThreads = 128;",
                                   "constexpr int kNoiseThreads = 64;")]),
    "noise2-interleave": (_WHOLE, [
        ("const uint32_t b = blockIdx.y;", "const uint32_t b = blockIdx.x;"),
        ("params != nullptr && blockIdx.x == 0",
         "params != nullptr && blockIdx.y == 0"),
        ("4ull * ((unsigned long long)blockIdx.x * kNoiseThreads",
         "4ull * ((unsigned long long)blockIdx.y * kNoiseThreads"),
        ("const dim3 grid((unsigned)((quads + kNoiseThreads - 1) / "
         "kNoiseThreads),\n                  (unsigned)B);",
         "const dim3 grid((unsigned)B, (unsigned)((quads + kNoiseThreads - "
         "1) / kNoiseThreads));")]),
    # K2 backward, redesigned version: the next tile's loads issued after
    # this tile's sum instead of before it (no overlap)
    "bwd3-noprefetch": (_WHOLE, [
        ("    if (t + (int)gridDim.x < n_tiles) issue(t + gridDim.x, st);\n",
         ""),
        ("    __syncthreads();                  // the sum is done with "
         "shared memory\n",
         "    __syncthreads();\n"
         "    if (t + (int)gridDim.x < n_tiles) "
         "issue(t + gridDim.x, st);\n")]),
    # K2 backward, redesigned version, its levers: four output rows a
    # thread (tiles of 8 rows instead of 4); 64 vectors a tile row instead
    # of 128; two halo vectors loaded ahead instead of one; the register
    # budget of 2 resident blocks per SM instead of 3
    "bwd2-rows4": (_WHOLE, [("constexpr int kRowsPerThread = 2;",
                             "constexpr int kRowsPerThread = 4;")]),
    "bwd2-rowvec64": (_WHOLE, [("constexpr int kRowVectors = 128;",
                                "constexpr int kRowVectors = 64;")]),
    "bwd2-halo2": (_WHOLE, [("constexpr int kHaloSlots = 1;",
                             "constexpr int kHaloSlots = 2;")]),
    "bwd2-minblocks2": (_WHOLE, [("constexpr int kBwdMinBlocks = 3;",
                                  "constexpr int kBwdMinBlocks = 2;")]),
    # the tile's own g_band kept in registers through the sum (shared
    # memory as planned), not in shared memory
    "bwd3-center-registers": (_WHOLE, [
        ("#pragma unroll\n    for (int i = 0; i < R; ++i) {\n"
         "      const int r = ty + i * blockDim.y, y = h0 + r;\n"
         "      if (r >= th) continue;\n"
         "      gc[r * rv + tx] = st.b[i].raw;\n",
         "    Vec16<T> center[R];\n#pragma unroll\n"
         "    for (int i = 0; i < R; ++i) {\n"
         "      const int r = ty + i * blockDim.y, y = h0 + r;\n"
         "      center[i] = st.b[i];\n"
         "      if (r >= th) continue;\n"),
        ("      cen.raw = gc[r * rv + tx];", "      cen = center[i];")]),
    # K4, redesigned version, its levers: two quads a thread down its
    # strip (tiles of 8 rows instead of 4); 64 or 256 vectors a tile row
    # instead of 128; the register budget of 8 resident blocks per SM
    # instead of 6 (64 registers); 256 threads a block (3 blocks per SM,
    # tiles of 8 rows) or 64 (12 blocks, tiles of 2 rows) instead of 128
    # (6 blocks, tiles of 4 rows); band and down stored with the
    # evict-first hint (st.global.cs); the next tile's copies issued
    # after this tile's sum instead of before it (no overlap); the grid
    # cut to ceil(tiles / rounds) blocks, rounds = ceil(tiles / resident
    # blocks), so that no block walks more tiles than another but one
    "split2-quadrows2": (_WHOLE, [("constexpr int kSplitQuadRows = 1;",
                                   "constexpr int kSplitQuadRows = 2;")]),
    "split2-rowvec64": (_WHOLE, [("constexpr int kSplitRowVectors = 128;",
                                  "constexpr int kSplitRowVectors = 64;")]),
    "split2-rowvec256": (_WHOLE, [("constexpr int kSplitRowVectors = 128;",
                                   "constexpr int kSplitRowVectors = 256;")]),
    "split2-minblocks8": (_WHOLE, [("constexpr int kSplitMinBlocks = 6;",
                                    "constexpr int kSplitMinBlocks = 8;")]),
    "split2-threads256": (_WHOLE, [
        ("constexpr int kSplitThreads = 128;",
         "constexpr int kSplitThreads = 256;"),
        ("constexpr int kSplitMinBlocks = 6;",
         "constexpr int kSplitMinBlocks = 3;")]),
    "split2-threads64": (_WHOLE, [
        ("constexpr int kSplitThreads = 128;",
         "constexpr int kSplitThreads = 64;"),
        ("constexpr int kSplitMinBlocks = 6;",
         "constexpr int kSplitMinBlocks = 12;")]),
    "split2-evict-first": (_WHOLE, [
        ("    *reinterpret_cast<uint4*>(bo + (y * W + xx) * C + c * V) = "
         "sb.raw;",
         "    __stcs(reinterpret_cast<uint4*>(bo + (y * W + xx) * C + c * V), "
         "sb.raw);"),
        ("      *reinterpret_cast<uint4*>(dn + ((y >> 1) * (W >> 1) + (xx >> "
         "1)) * C +\n                                c * V) = ss.raw;",
         "      __stcs(reinterpret_cast<uint4*>(dn + ((y >> 1) * (W >> 1) + "
         "(xx >> 1)) * C + c * V), ss.raw);")]),
    "split2-noprefetch": (_WHOLE, [
        ("    if (t + (int)gridDim.x < n_tiles) issue(t + gridDim.x, st ^ 1);\n"
         "    cp_async_commit();\n", "    cp_async_commit();\n"),
        ("    __syncthreads();                  // the sum is done with this "
         "stage\n",
         "    __syncthreads();\n"
         "    if (t + (int)gridDim.x < n_tiles) issue(t + gridDim.x, st ^ 1);\n"
         "    cp_async_commit();\n")]),
    "split2-balanced": (_WHOLE, [(
        "  split_kernel<T>(k)<<<(int)(tiles < cap ? tiles : cap), "
        "dim3(p.bdx, p.bdy),",
        "  const long long rounds = (tiles + cap - 1) / cap;\n"
        "  split_kernel<T>(k)<<<(int)((tiles + rounds - 1) / rounds), "
        "dim3(p.bdx, p.bdy),")]),
}


def apply_cuts(text, cuts):
    for cut in cuts:
        (start, end), edits = CUTS[cut]
        lo = text.index(start)
        hi = text.index(end, lo) if end else len(text)
        region = text[lo:hi]
        for old, new in edits:
            if region.count(old) != 1:
                raise ValueError(f"cut {cut}: {old!r} occurs "
                                 f"{region.count(old)} times in the region")
            region = region.replace(old, new)
        text = text[:lo] + region + text[hi:]
    return text


def build(name, text, work, out_dir):
    from blind_image_denoising_torch.ops import cuda_build
    src, lib_path = work / f"{name}.cu", work / f"{name}.so"
    src.write_text(text)
    cmd = [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
           "-I", str(cuda_build.CSRC_DIR), "-shared", str(src), "-o",
           str(lib_path)]
    done = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{done.stdout}")
    if out_dir is not None:
        (out_dir / f"{name}.ptxas.txt").write_text(done.stdout)
        tool = Path(cuda_build.find_nvcc()).with_name("cuobjdump")
        sass = subprocess.run([str(tool), "-sass", str(lib_path)],
                              capture_output=True, text=True, check=True)
        (out_dir / f"{name}.sass.txt").write_text(sass.stdout)
    lib = ctypes.CDLL(str(lib_path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if "bid_band_smooth_bwd" in text:
        for fn in (lib.bid_band_smooth_bwd, lib.bid_band_split):
            fn.argtypes = [p, p, p, i, i, i, i, i, i, p]
            fn.restype = i
        return ("bwd", "split"), lib
    # a source with the sample offset takes it after the seed (0 here: the
    # local batch is the global one); an older source has no such argument
    lib.noise_offset = (0,) if "uint32_t offset, float mlo" in text else ()
    lib.bid_corrupt_noise.argtypes = [
        p, p, p, i, ctypes.c_longlong, ctypes.c_uint32,
        *[ctypes.c_uint32] * len(lib.noise_offset), f, f, f, f, i, i, i, p]
    lib.bid_corrupt_noise.restype = i
    return ("noise",), lib


def run_in_turns(libs, rounds, call, inputs):
    """{name: (warm ms per round, cold ms per round)}, in turns."""
    cold = cold_copies(*inputs)
    times = {name: ([], []) for name in libs}
    for r in range(rounds):
        order = list(libs) if r % 2 == 0 else list(libs)[::-1]
        for name in order:
            fn = lambda *a, lib=libs[name]: call(lib, *a)  # noqa: E731
            times[name][0].append(cuda_ms(lambda: fn(*inputs)))
            times[name][1].append(cuda_ms(fn, inputs=cold))
    return times


def report(name, times, bound, by, err, **fields):
    warm, cold = times
    print(json.dumps(dict(
        source=name, **fields, ms=warm, cold_ms=cold, ms_min=min(warm),
        cold_ms_min=min(cold), bound_ms=bound, bound_by=by,
        share_of_bound_cold=bound / min(cold),
        max_abs_diff_from_plain=err)), flush=True)


def takes(call, name, lib, shape, kernel, *args):
    """Launch ``call(lib, *args)``; False (and a line saying so) where the
    source refuses the shape's C (a parent from before ragged C)."""
    try:
        call(lib, *args)
    except RuntimeError:
        if shape[-1] % 8 == 0:
            raise
        print(json.dumps(dict(source=name, kernel=kernel, shape=list(shape),
                              unsupported=True)), flush=True)
        return False
    return True


def compare_bwd(libs, rounds, rng, stream):
    from blind_image_denoising_torch.ops import pallas_pyramid as pp
    for shape in BWD_SHAPES + BWD_RAGGED_SHAPES:
        g_band, g_smooth = (torch.from_numpy(rng.normal(0, 1, shape).astype(
            np.float32)).cuda().to(torch.bfloat16) for _ in range(2))
        dx = torch.empty_like(g_band)
        ref = pp.band_smooth_bwd_plain(g_band, g_smooth, 2)

        def call(lib, gb, gs, out):
            rc = lib.bid_band_smooth_bwd(gb.data_ptr(), gs.data_ptr(),
                                         out.data_ptr(), *shape, 2, 1, stream)
            if rc != 0:
                raise RuntimeError(f"launch refused: code {rc}")

        errs = {}
        for name, lib in libs.items():
            dx.zero_()
            if not takes(call, name, lib, shape, "band_smooth_bwd",
                         g_band, g_smooth, dx):
                continue
            torch.cuda.synchronize()
            errs[name] = float((dx.float() - ref.float()).abs().max())
        row_libs = {name: libs[name] for name in errs}
        times = run_in_turns(row_libs, rounds, call, (g_band, g_smooth, dx))
        bound, by = band_bound_ms(*shape, 2, torch.bfloat16, backward=True)
        for name in row_libs:
            report(name, times[name], bound, by, errs[name],
                   kernel="band_smooth_bwd", shape=list(shape),
                   dtype="bf16", k=2)


def compare_split(libs, rounds, rng, stream):
    from blind_image_denoising_torch.ops import pallas_pyramid as pp
    for shape in SPLIT_SHAPES + SPLIT_RAGGED_SHAPES:
        b, h, w, c = shape
        x = torch.from_numpy(rng.normal(0, 1, shape).astype(
            np.float32)).cuda().to(torch.bfloat16)
        band = torch.empty_like(x)
        down = torch.empty((b, h // 2, w // 2, c), dtype=x.dtype,
                           device=x.device)
        refs = pp.band_split_plain(x, 2)

        def call(lib, xs, bs, ds):
            rc = lib.bid_band_split(xs.data_ptr(), bs.data_ptr(),
                                    ds.data_ptr(), *shape, 2, 1, stream)
            if rc != 0:
                raise RuntimeError(f"launch refused: code {rc}")

        errs = {}
        for name, lib in libs.items():
            band.zero_()
            down.zero_()
            if not takes(call, name, lib, shape, "band_split", x, band,
                         down):
                continue
            torch.cuda.synchronize()
            errs[name] = max(float((o.float() - r.float()).abs().max())
                             for o, r in zip((band, down), refs))
        row_libs = {name: libs[name] for name in errs}
        times = run_in_turns(row_libs, rounds, call, (x, band, down))
        bound, by = band_bound_ms(*shape, 2, torch.bfloat16, split=True)
        for name in row_libs:
            report(name, times[name], bound, by, errs[name],
                   kernel="band_split", shape=list(shape), dtype="bf16",
                   k=2)


def compare_noise(libs, rounds, rng, stream):
    import blind_image_denoising_torch as bidt
    from blind_image_denoising_torch.ops import pallas_noise as pn
    ds = copy.deepcopy(bidt.CONFIGS_DICT[TRAIN_CONFIG])["dataset"]
    mlo, mhi = sorted(ds["multiplicative_noise"])
    alo, ahi = sorted(ds["additional_noise"])
    x = torch.from_numpy(synthetic_images(
        TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, rng)).round().cuda()
    b, n = x.shape[0], x[0].numel()
    out = torch.empty_like(x)
    params = torch.empty((b, 4), device="cuda")

    def call(lib, xs, os, p=None):
        rc = lib.bid_corrupt_noise(
            xs.data_ptr(), os.data_ptr(), None if p is None else p.data_ptr(),
            b, n, ctypes.c_uint32(NOISE_SEED), *lib.noise_offset, mlo, mhi,
            alo, ahi, 1, 1, 0, stream)
        if rc != 0:
            raise RuntimeError(f"launch refused: code {rc}")

    kw = dict(multiplicative_noise=[mlo, mhi], additive_noise=[alo, ahi])
    ref, ref_params = pn.corrupt_batch_plain(
        NOISE_SEED, x, round_values=False, return_params=True, **kw)
    errs = {}
    for name, lib in libs.items():
        out.zero_()
        call(lib, x, out, params)
        torch.cuda.synchronize()
        errs[name] = dict(
            params_equal=bool(torch.equal(params, ref_params)),
            max_abs_diff=float((out - ref).abs().max()))
    times = run_in_turns(libs, rounds, call, (x, out))
    flags = (ref_params[:, 0] + ref_params[:, 2]).int().tolist()
    bound, by, parts = noise_bound_ms(n, flags)
    for name in libs:
        report(name, times[name], bound, by, errs[name],
               kernel="corrupt_noise", shape=list(x.shape), dtype="f32",
               bound_parts_ms=parts,
               samples_by_noises_on=[flags.count(k) for k in range(3)])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("sources", nargs="+",
                        metavar="NAME=SOURCE[@CUT[+CUT...]]")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--out", type=Path, default=None)
    parser.add_argument("--kernels", default="bwd,split,noise",
                        help="which kernels to time (comma-separated)")
    args = parser.parse_args()
    wanted = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        print("band_noise_compare: no CUDA device available",
              file=sys.stderr)
        return 1
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    groups = {"bwd": {}, "split": {}, "noise": {}}
    with tempfile.TemporaryDirectory() as work:
        for spec in args.sources:
            name, rest = spec.split("=", 1)
            src, _, cuts = rest.partition("@")
            text = apply_cuts(Path(src).read_text(),
                              cuts.split("+") if cuts else [])
            kinds, lib = build(name, text, Path(work), args.out)
            for kind in wanted.intersection(kinds):
                groups[kind][name] = lib
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    torch.backends.cuda.matmul.allow_tf32 = False
    if groups["bwd"]:
        compare_bwd(groups["bwd"], args.rounds, rng, stream)
    if groups["split"]:
        compare_split(groups["split"], args.rounds, rng, stream)
    if groups["noise"]:
        compare_noise(groups["noise"], args.rounds, rng, stream)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
