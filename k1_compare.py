#!/usr/bin/env python3
"""Time versions of the ConvNext-unit kernel (K1) against each other on
one NVIDIA GPU, inside one process. The rows: the seven (C, K) with
instantiations of their own in every mode at the shapes ``chip_smoke.py``
reports (bf16 (32,3) 8×256², (64,5) 8×128², (32,5) 32×256², (64,5)
32×128²; int8 (32,5) 32×256², (64,5) 32×128²; f32 (32,3) 8×256² and
(64,5) 8×128² for ``dtype="float32"`` serving; the K = 1 decoders'
(32,1) 8×256² and (64,1) 8×128²; C = 128 at 8×64²,
``unet_laplacian_v4``'s level 2 at b8 @ 256², and int8 (128,5) at 32×64², a depth-4 fused
``unet_laplacian_v6``'s level 2 at b32 @ 256²), then the classes: (256,5)
at 32×32² in bf16 and int8 and at 8×32² in f32 (a depth-5 fused v6's
level 3), bf16 (48,5), (72,5) and (108,5) at 32×128², 32×64² and 32×32²
(the levels of one with ``filters_level_multiplier`` 1.5), and bf16 (64,3)
at 8×128² and (128,3) at 8×64²; then K = 7 and C = 512 (``NEW_ROWS``:
(32,7) 8×256² and (64,7) 8×128² in every mode, bf16 (128,7) 8×64² and
(256,7) 8×32², (512,5) 8×16² in every mode and bf16 (512,7)); then
the clusters' widths (``CLUSTER_ROWS``: (1024,5) 8×8² in every mode, a
no-attention depth-6 v6's level 5 at b8 @ 256², and bf16 (384,5) 8×16²).
A source built without a row's kernel (a parent from before it) skips
that row. The padded classes' rows (``CLASS_ROWS``: bf16 (48,5), (72,5),
(108,5) and (48,7), int8 (48,5), f32 (48,5)) have beside them the width
the padded classes of widths 32 / 64 / 128 ran them at and the widths of
the layouts that run them now (``PADDED_ROWS``: bf16 (128,5) at 32×64²
and 32×32², (80,5) 32×64², (112,5) 32×32²).

    python3 k1_compare.py [--rounds N] [--out DIR] [--mma-rate]
                          [--channels C,...] [--dtype D] [--wrapper]
                          [--rows k7] [--k7-build] [--sass]
                          [NAME=SOURCE[@CUT+CUT...] ...]

``--rows k7`` times only ``K7_ROWS`` (K = 7's own layouts in bf16, int8
and f32, (128, 7), and the class widths at K = 7); ``--k7-build`` builds
only the sources those rows run (``K7_SOURCES``, the others' entry points
stubbed by ``K7_STUB``), a few minutes less a library; ``--sass`` prints,
per K = 7 instantiation in bf16 and int8, its depthwise loop's
instructions, FFMAs and shared-memory loads from the library's SASS.

Each SOURCE is a ``convnext_block.cu`` (a parent commit's before the
kernel had sources of its own beside it) or a directory of K1 sources
(``csrc/`` of the checkout or of a parent, or a copy with a phase cut
out), whose ``convnext*.cu`` are built; ``common.cuh`` is taken from the
source's directory, else from the checkout. Every source is compiled by
``nvcc`` for ``sm_90a`` (one process per file, all started together) into
a library of its own, and the libraries are timed in turns (in the given
order in even rounds, reversed in odd ones: parent, change, change,
parent with two names and two rounds), since times of different
processes or machines do not compare. Per source and shape it prints
one JSON line with the device milliseconds of every round (CUDA events
around calls queued behind a spin kernel), warm (``ms``: one input) and
cold (``cold_ms``: the calls rotate over copies of the input that move
twice the L2), the largest difference from the plain PyTorch version
(in float32 also over the plain output's largest entry), and the bound
(in float32 also ``bound_cuda_cores_ms``, every operation on the CUDA
cores); then the card's name and power limit. With ``--out DIR`` the
compiler's resource report
(``-Xptxas -v``) of every source is written to ``DIR/NAME.ptxas.txt``,
and with ``--sass`` its SASS (``cuobjdump -sass``) to
``DIR/NAME.sass.txt``. With
``--channels 256,512`` only the rows at those C are timed, with
``--dtype bf16`` only those in that mode. Each library gets the weights
as its own route takes them: padded to the width of the layout that its
``bid_convnext_block_info`` reports (the eighth int; a library that
fills seven, from before the layouts of widths that are multiples of 16,
pads to its class of ``ONE_BLOCK_WIDTHS``), with the depthwise weights
transposed where it reports a thread-block cluster; so a parent, or a
copy of the sources whose ``cluster_from`` differs, is timed on its own
layout. ``--wrapper`` adds two rows a shape through this checkout's
package (``pallas_convnext.convnext_block``, its library built from
``csrc/``): ``wrapper`` prepares the operands on every call, as the
functional wrapper does, and ``wrapper_cached`` takes them prepared once
(``pallas_convnext.kernel_operands``), as the model's units do.

``--mma-rate`` first measures the rate of ``mma.sync`` itself, the
ceiling of the products of the float32 mode (m16n8k8 on TF32) and of
the bf16 and int8 modes (m16n8k16 on bf16): a kernel of chains of
independent products on one block of 8 or 16 warps per SM, timed by the
SM's clock, prints one JSON line per case with the products a clock an
SM (one m16n8k8 TF32 product a clock an SM is the dense TF32 peak).
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from chip_smoke import cold_copies, convnext_bound_ms, cuda_ms

# the library's status for a (C, K) it was not built for
UNSUPPORTED = -1
# (dtype, C, K, batch, height and width): the seven (C, K) that had
# instantiations of their own before the classes, every mode
ROWS = [("bf16", 32, 3, 8, 256), ("bf16", 64, 5, 8, 128),
        ("bf16", 32, 5, 32, 256), ("bf16", 64, 5, 32, 128),
        ("int8", 32, 5, 32, 256), ("int8", 64, 5, 32, 128),
        ("f32", 32, 3, 8, 256), ("f32", 64, 5, 8, 128),
        ("f32", 32, 1, 8, 256), ("f32", 64, 1, 8, 128),
        ("bf16", 128, 5, 8, 64), ("bf16", 128, 1, 8, 64),
        ("f32", 128, 5, 8, 64), ("f32", 128, 1, 8, 64),
        ("int8", 128, 5, 32, 64),
        ("bf16", 32, 1, 8, 256), ("int8", 32, 1, 8, 256),
        ("int8", 32, 3, 8, 256), ("f32", 32, 5, 32, 256),
        ("bf16", 64, 1, 8, 128), ("int8", 64, 1, 8, 128),
        ("int8", 128, 1, 8, 64)]
# the classes, and (64, 3) and (128, 3) of their own: the padded classes
# at the multiplier-1.5 depth-5 v6's levels 1-3 (b32 @ 256²) in bf16, its
# level 1 in int8 (its int8 fused forward) and f32 (b8), and at K = 7
CLASS_ROWS = [("bf16", 256, 5, 32, 32), ("int8", 256, 5, 32, 32),
              ("f32", 256, 5, 8, 32), ("bf16", 48, 5, 32, 128),
              ("bf16", 72, 5, 32, 64), ("bf16", 108, 5, 32, 32),
              ("bf16", 64, 3, 8, 128), ("bf16", 128, 3, 8, 64),
              ("int8", 48, 5, 32, 128), ("f32", 48, 5, 8, 128),
              ("bf16", 48, 7, 32, 128)]
# beside the padded classes: (128, 5) at (72, 5)'s and (108, 5)'s pixels
# (the width the padded classes ran them at), and (80, 5) and (112, 5),
# the widths of their layouts since
PADDED_ROWS = [("bf16", 128, 5, 32, 64), ("bf16", 128, 5, 32, 32),
               ("bf16", 80, 5, 32, 64), ("bf16", 112, 5, 32, 32)]
# K = 7 and 256 < C <= 512: a K = 7 unet_laplacian_v6's levels 0 and 1 at
# b8 @ 256² in every mode, (128, 7) and (256, 7) at its deeper levels'
# widths, and (512, 5) at a no-attention depth-5 v6's level 4 (b8 @ 256²:
# 16²) in every mode, and (512, 7)
NEW_ROWS = [("bf16", 32, 7, 8, 256), ("bf16", 64, 7, 8, 128),
            ("int8", 32, 7, 8, 256), ("int8", 64, 7, 8, 128),
            ("f32", 32, 7, 8, 256), ("f32", 64, 7, 8, 128),
            ("bf16", 128, 7, 8, 64), ("bf16", 256, 7, 8, 32),
            ("bf16", 512, 5, 8, 16), ("int8", 512, 5, 8, 16),
            ("f32", 512, 5, 8, 16), ("bf16", 512, 7, 8, 16)]
# C = 1024: a no-attention depth-6 v6's level 5 (b8 @ 256²: 8²)
CLUSTER_ROWS = [("bf16", 1024, 5, 8, 8), ("int8", 1024, 5, 8, 8),
                ("f32", 1024, 5, 8, 8), ("bf16", 384, 5, 8, 16)]
# the streamed layouts' other shapes: (128, 3) and (128, 7) in int8 and
# f32 (f32 (128, 7) takes the tile buffer's room for its ring), and a
# ragged width of the wide class, bf16 (192, 5) at 32×32²
RING_ROWS = [("int8", 128, 3, 8, 64), ("f32", 128, 3, 8, 64),
             ("int8", 128, 7, 8, 64), ("f32", 128, 7, 8, 64),
             ("bf16", 192, 5, 32, 32)]
# K = 7 (``--rows k7``): a K = 7 unet_laplacian_v6's levels 0 and 1 at b8
# @ 256² in bf16 and int8 (and f32, whose layout keeps its own depthwise),
# (128, 7) at its level 2, and the class widths that share the bf16
# depthwise: 16 (C = 16 at 8×256²) and the levels of a K = 7 v6 with
# ``filters_level_multiplier`` 1.5 at b32 @ 256² (C = 48, 72, 108: widths
# 48, 80, 112)
K7_ROWS = [("bf16", 32, 7, 8, 256), ("bf16", 64, 7, 8, 128),
           ("int8", 32, 7, 8, 256), ("int8", 64, 7, 8, 128),
           ("f32", 32, 7, 8, 256), ("f32", 64, 7, 8, 128),
           ("bf16", 128, 7, 8, 64), ("int8", 128, 7, 8, 64),
           ("bf16", 16, 7, 8, 256), ("bf16", 48, 7, 32, 128),
           ("int8", 48, 7, 32, 128), ("bf16", 72, 7, 32, 64),
           ("bf16", 108, 7, 32, 32)]
# the widths of the one-block classes any version of the library had (512
# until the cluster took 256 < C <= 512 over)
ONE_BLOCK_WIDTHS = (32, 64, 128, 256, 512)
# ``--k7-build``: the K1 sources a K = 7 row at C <= 128 runs, and a stub
# for the entry points of the others (each returns the library's
# "unsupported", so a row that needs them is skipped)
K7_SOURCES = ("convnext_block.cu", "convnext_k7.cu", "convnext_k7_class.cu",
              "convnext_k7_class_80.cu", "convnext_k7_class_112.cu")
K7_STUB = r"""
#include "convnext_block.cuh"
namespace bid_k1 {
#define BID_STUB(NAME)                                                     \
  int launch_##NAME(int, const void*, void*, const void*, const void*,     \
                    const void*, const void*, const void*, int, int, int,  \
                    int, int, float, float, float, cudaStream_t) {         \
    return BID_ERR_UNSUPPORTED;                                            \
  }                                                                        \
  int info_##NAME(int, int, int, int*) { return BID_ERR_UNSUPPORTED; }
BID_STUB(class)
BID_STUB(wide)
#undef BID_STUB
int launch_k7_class_16_64(int, const void*, void*, const void*, const void*,
                          const void*, const void*, const void*, int, int,
                          int, int, int, float, float, float, cudaStream_t);
int info_k7_class_16_64(int, int, int, int*);
int launch_k7_class_80_96(int, const void*, void*, const void*, const void*,
                          const void*, const void*, const void*, int, int,
                          int, int, int, float, float, float, cudaStream_t);
int info_k7_class_80_96(int, int, int, int*);
int launch_k7_class_112_128(int, const void*, void*, const void*,
                            const void*, const void*, const void*,
                            const void*, int, int, int, int, int, float,
                            float, float, cudaStream_t);
int info_k7_class_112_128(int, int, int, int*);
static int k7_width(int dtype, int C) {
  const int cw = (C + 15) / 16 * 16;
  return dtype == 0 && cw == 112 ? 128 : cw;
}
int launch_k7_class(int dtype, const void* x, void* out, const void* dw,
                    const void* ln, const void* w2, const void* w3,
                    const void* gain, int B, int H, int W, int C, float slope,
                    float s_in, float inv_out, cudaStream_t s) {
  const int cw = k7_width(dtype, C);
  auto* f = cw <= 64 ? launch_k7_class_16_64 : cw <= 96 ? launch_k7_class_80_96
                                                        : launch_k7_class_112_128;
  return f(dtype, x, out, dw, ln, w2, w3, gain, B, H, W, C, 7, slope, s_in,
           inv_out, s);
}
int info_k7_class(int dtype, int C, int* v) {
  const int cw = k7_width(dtype, C);
  auto* f = cw <= 64 ? info_k7_class_16_64 : cw <= 96 ? info_k7_class_80_96
                                                      : info_k7_class_112_128;
  return f(dtype, C, 7, v);
}
template <typename T>
int launch_cluster_unit(const void*, void*, const void*, const void*,
                        const void*, const void*, const void*, int, int, int,
                        int, int, float, float, float, cudaStream_t) {
  return BID_ERR_UNSUPPORTED;
}
template <typename T>
int info_cluster_unit(int, int, int*) {
  return BID_ERR_UNSUPPORTED;
}
#define BID_STUB_T(T)                                                       \
  template int launch_cluster_unit<T>(const void*, void*, const void*,      \
                                      const void*, const void*, const void*, \
                                      const void*, int, int, int, int, int,  \
                                      float, float, float, cudaStream_t);    \
  template int info_cluster_unit<T>(int, int, int*);
BID_STUB_T(float)
BID_STUB_T(bf16)
BID_STUB_T(int8_t)
#undef BID_STUB_T
int launch_general(int, const void*, void*, const void*, const void*,
                   const void*, const void*, const void*, void*, long long,
                   int, int, int, int, int, int, float, float, float,
                   cudaStream_t) {
  return BID_ERR_UNSUPPORTED;
}
int info_general(int, int, int*) { return BID_ERR_UNSUPPORTED; }
long long general_scratch_bytes(long long, int, int, int) { return 0; }
}  // namespace bid_k1
"""


def route_operands(pc, dtype, wts, cluster_size, width=0):
    """The weights as a library whose layout for them is ``width`` channels
    wide on a cluster of ``cluster_size`` blocks (1: one block) takes
    them, as ``pallas_convnext.kernel_operands`` gives them on this
    checkout's route: dw [C', K²] ([K², C'] on a cluster), the LayerNorm
    scale and the gain [C'] in float32, W2 [4C', C'] and W3 [C', 4C'] in
    the I/O dtype (bf16 for int8), zero-padded to C' = ``width``; a
    ``width`` of 0 (a library that does not report it) is 128 n on a
    cluster, else the class's width (``ONE_BLOCK_WIDTHS``)."""
    c, k = wts["ln_scale"].numel(), wts["dw"].shape[-1]
    width = width or (pc.CLUSTER_SLICE * cluster_size if cluster_size > 1
                      else next(w for w in ONE_BLOCK_WIDTHS if c <= w))
    pad = width - c
    w_dtype = torch.bfloat16 if dtype == torch.int8 else dtype
    dw = torch.nn.functional.pad(wts["dw"].reshape(c, k * k).float(),
                                 (0, 0, 0, pad))
    ln = torch.nn.functional.pad(wts["ln_scale"].float(), (0, pad))
    gain = torch.nn.functional.pad(wts["gain"].float(), (0, pad))
    w2 = torch.nn.functional.pad(wts["w2"].to(w_dtype), (0, pad, 0, 4 * pad))
    w3 = torch.nn.functional.pad(wts["w3"].to(w_dtype), (0, 4 * pad, 0, pad))
    if cluster_size > 1:
        dw = dw.t()
    return tuple(v.contiguous() for v in (dw, ln, w2, w3, gain))


# Text edits of the K1 sources that cut one part of a kernel's work or
# replace one mechanism, to split its time (``NAME=SOURCE@CUT``): each
# is (file, old, new), and ``old`` must occur once in the file. They are
# written against the padded classes of widths 32 / 64 / 128 (``acfa7e3``'s
# csrc):
# "shifts": the ragged copy loop finds a copy's pixel by a shift, and the
#   ragged store walks its (pixel, unit) pairs without a division;
# "copy16": the ragged copies and stores move 16-byte units, their
#   addresses rounded down to 16 bytes (wrong values, the same bytes);
# "products": the products of a class stop at E' = 4 C' (C' = C rounded
#   up to 16), the E side of the padding cut (the C side stays the
#   class's width).
# Written against the layouts of widths that are multiples of 16:
# "tw32": the width-48 layout at K < 7 on 8 x 32 tiles and one block of
#   512 threads an SM (the width-64 layout's shape, which it takes at
#   K = 7) in place of 8 x 16 and two blocks of 256;
# "dwbcast": every depthwise run of a warp reads the same pixels (wrong
#   values; the loads of distinct pixels' rows then never share a bank);
# "noproducts": the layouts with resident weights skip both products (the
#   epilogue adds x + gain * 0), their share of the time.
_CUH = "convnext_block.cuh"
_WIDE = "convnext_wide.cuh"
CUTS = {
    "shifts": [
        (_CUH, "const int pix = G::kMma && G::C >= 128 ? i >> ush : i / upp;",
         "const int pix = i >> ush;"),
        (_CUH, """    for (int i = lane; i < 16 * nu; i += 32) {
      const int m = m0 + i / nu, j = i % nu;""",
         """    const int dm = 32 / nu, dj = 32 - dm * nu;
    int m = m0 + lane / nu, j = lane - (lane / nu) * nu;
    for (int i = lane; i < 16 * nu; i += 32, m += dm, j += dj) {
      if (j >= nu) j -= nu, ++m;"""),
    ],
    "copy16": [
        (_CUH, "const int unit = G::kRagged ? io_unit<T>(cr) : 16;",
         "const int unit = 16;"),
        (_CUH, "copy_unit(dst + d, d0 + d, xb + src, inside, unit);",
         "copy_unit(dst + d, d0 + d, xb + (src & ~15LL), inside, unit);"),
        (_CUH, """store_unit(ob + ((t.b * H + gy) * W + gx) * cr * (long long)sizeof(T) +
                       j * unit,""",
         """store_unit(ob + ((((t.b * H + gy) * W + gx) * cr *
                        (long long)sizeof(T) + j * unit) & ~15LL),"""),
    ],
    "products": [
        (_CUH, "for (int ec = 0; ec < G::E; ec += G::EC)",
         "for (int ec = 0; ec < (G::kRagged ? 4 * ((cr + 15) & ~15) : G::E);"
         " ec += G::EC)"),
        (_CUH, "for (int ec = 0; ec < E; ec += EF) {",
         "for (int ec = 0; ec < (G::kRagged ? 4 * ((cr + 15) & ~15) : E);"
         " ec += EF) {"),
        (_CUH, "unsigned char* ring, int c, bool more, int tid) {",
         "unsigned char* ring, int c, bool more, int tid, int nch = G::NCH) {"),
        (_CUH, "if (c + 1 < G::NCH)", "if (c + 1 < nch)"),
        (_CUH, "const int unit = G::kRagged ? io_unit<T>(cr) : 16;",
         "const int unit = G::kRagged ? io_unit<T>(cr) : 16;\n"
         "  const int nch = G::kRagged ? 4 * ((cr + 15) & ~15) / G::ECH"
         " : G::NCH;"),
        (_CUH, """        for (int c = 0; c < G::NCH; ++c) {
          await_chunk<G>(w2, w3, ring, c, next < ntiles, tid);
          const uint32_t b""", """        for (int c = 0; c < nch; ++c) {
          await_chunk<G>(w2, w3, ring, c, next < ntiles, tid, nch);
          const uint32_t b"""),
        (_CUH, """        for (int c = 0; c < G::NCH; ++c) {
          await_chunk<G>(w2, w3, ring, c, next < ntiles, tid);
          if constexpr""", """        for (int c = 0; c < nch; ++c) {
          await_chunk<G>(w2, w3, ring, c, next < ntiles, tid, nch);
          if constexpr"""),
    ],
    "tw32": [
        (_CUH, "kBlock512 = kMma && (C == 64 || (C == 48 && K == 7));",
         "kBlock512 = kMma && (C == 64 || C == 48);"),
    ],
    "dwbcast": [
        (_CUH, "const int ry = run / G::RUNS_W, rx = (run % G::RUNS_W) * R;",
         "const int ry = 0 * run, rx = 0;"),
    ],
    "noproducts": [
        (_CUH, "for (int ec = 0; ec < G::E; ec += G::EC)",
         "for (int ec = 0; ec < 0; ec += G::EC)"),
    ],
    # Written against the K = 7 layouts of ``a28c11e`` (their step 0), each
    # cutting only the K = 7 layouts with resident W2 and W3:
    # "k7nodw": the depthwise and the LayerNorm skipped (t is what the t
    #   tile holds);
    # "k7noproducts": both products skipped (the epilogue adds x + gain * 0);
    # "k7nowait": bf16 with one tile buffer ((64, 7)) does not wait for the
    #   copies of its next tile, which start once the epilogue is done
    #   (wrong values; the block waits for them once, before it ends): what
    #   the copies that no compute overlaps cost;
    # "k7cap2": (32, 7) built for two blocks an SM (a 128-register cap); in
    #   bf16 its 131,072 B still hold one block an SM, int8's 105,536 B two;
    # "k7two": the same, and bf16 (32, 7) with one tile buffer refilled once
    #   the epilogue is done (88,512 B), so that two blocks fit: what
    #   occupancy alone gives.
    "k7nodw": [
        (_CUH, "      depthwise_layernorm<G>(xs, dws, lns, ts, tid, cr, "
         "inv_cr);\n",
         "      if constexpr (G::K < 7)\n"
         "        depthwise_layernorm<G>(xs, dws, lns, ts, tid, cr, inv_cr);\n"),
    ],
    "k7noproducts": [
        (_CUH, "for (int ec = 0; ec < G::E; ec += G::EC)",
         "for (int ec = 0; ec < (G::K < 7 ? G::E : 0); ec += G::EC)"),
    ],
    "k7nowait": [
        (_CUH, "    cp_async_wait_all();\n    // this tile (or its codes) has "
         "landed",
         "    if (round == 0 || !(G::K == 7 && G::kMma && !G::kInt8 &&\n"
         "                        !G::kStream && G::NXBUF == 1))\n"
         "      cp_async_wait_all();\n"
         "    // this tile (or its codes) has landed"),
        (_CUH, "  // no block leaves while the cluster's others may still "
         "arrive on its",
         "  cp_async_wait_all();\n"
         "  // no block leaves while the cluster's others may still arrive "
         "on its"),
    ],
    # Written against the K = 7 redesign (the own layouts' depthwise by runs
    # of two rows, the class widths' as the parent's), to time its parts
    # and the depthwise designs it was chosen from on the same layouts:
    # "k7nodw2": the own layouts' depthwise and LayerNorm skipped;
    # "k7resx": bf16 (32, 7), (64, 7), (128, 7) refill their one tile buffer
    #   once the epilogue has read its residual there, not once every
    #   warp's residual has moved into its t rows;
    # "k7line32": (32, 7) with two tile buffers whose rows are unpadded so
    #   that two blocks still fit (114,048 B), the two pixels of each
    #   128-byte line in 16-byte slots (4 (ix & 1) + c) ^ F(L), F(L) =
    #   (L & 3) | 4 ((L >> 1) & 1) (free of bank conflicts for the
    #   depthwise's half-warps and the epilogue's reads), in place of one
    #   padded buffer;
    # "k7norows2": the own layouts take the class widths' depthwise (the
    #   parent's);
    # "k7halves": the class widths' depthwise (with "k7norows2" every
    #   width's) by halves of a run's 8 channels: per tap row a half's
    #   K x 4 weights and its inputs' 8-byte halves, the tap rows unrolled,
    #   lane cg of the run at column rx taking half ((cg ^ rx) >> 3) & 1
    #   first;
    # "k7fullrow": the class widths' depthwise as at K <= 5 (a row's K x 8
    #   weights in registers, the rows unrolled).
    "k7resx": [
        (_CUH, "  static constexpr bool kResT = kMma &&",
         "  static constexpr bool kResT = false && kMma &&"),
    ],
    "k7nodw2": [
        (_CUH, "      if constexpr (G::kRows2)\n"
         "        depthwise_layernorm_rows2<G>(xs, dws, lns, ts, tid);\n",
         "      if constexpr (G::kRows2)\n        (void)0;\n"),
    ],
    "k7line32": [
        (_CUH, "  static constexpr int LDX = kSwizzle ? C : C + 8;",
         "  static constexpr int LDX =\n"
         "      kSwizzle || (kMma && !kRagged && C == 32 && K == 7) ? C : C + 8;"),
        (_CUH, "      kInt8 || kRingInX || kTwoBlocks7 ? 1\n",
         "      kInt8 || kRingInX ? 1\n"),
        (_CUH, """  static __device__ __forceinline__ int xoff(int ix, int chunk) {
    if constexpr (kSwizzle) chunk ^= ix & 7;""", """  static __device__ __forceinline__ int xoff(int ix, int chunk) {
    if constexpr (kMma && !kRagged && C == 32 && K == 7) {
      const int line = ix >> 1;
      return line * 2 * C +
             ((((ix & 1) << 2) + chunk) ^ ((line & 3) | ((line << 1) & 4))) *
                 V;
    }
    if constexpr (kSwizzle) chunk ^= ix & 7;"""),
    ],
    "k7norows2": [
        (_CUH, "  static constexpr bool kRows2 = kMma && !kRagged && K == 7;",
         "  static constexpr bool kRows2 = false;"),
    ],
    "k7halves": [
        (_CUH, "    if constexpr (K >= 7) {\n      // (the class widths;",
         """    if constexpr (K >= 7 && C > 0) {
      const int sw = ((cg ^ rx) >> 3) & 1;
      float first[R][4], part[R][4];
#pragma unroll 1
      for (int hh = 0; hh < 2; ++hh) {
        const int h = hh ^ sw;
        const float4* wh = wp + h * CG;
        const bf16* xh = xs + 4 * h + ry * G::IW * G::LDX;
#pragma unroll
        for (int j = 0; j < R; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) part[j][c] = 0.f;
#pragma unroll
        for (int dy = 0; dy < K; ++dy) {
          const bf16* xrow = xh + dy * G::IW * G::LDX;
          float4 w[K];
#pragma unroll
          for (int dx = 0; dx < K; ++dx) w[dx] = wh[(dy * K + dx) * 2 * CG];
#pragma unroll
          for (int i = 0; i < R + K - 1; ++i) {
            const uint2 raw = *reinterpret_cast<const uint2*>(xrow + xo[i]);
            const float xv[4] = {__uint_as_float(raw.x << 16),
                                 __uint_as_float(raw.x & 0xffff0000u),
                                 __uint_as_float(raw.y << 16),
                                 __uint_as_float(raw.y & 0xffff0000u)};
#pragma unroll
            for (int dx = 0; dx < K; ++dx) {
              const int j = i - dx;
              if (j >= 0 && j < R) {
                part[j][0] = fmaf(xv[0], w[dx].x, part[j][0]);
                part[j][1] = fmaf(xv[1], w[dx].y, part[j][1]);
                part[j][2] = fmaf(xv[2], w[dx].z, part[j][2]);
                part[j][3] = fmaf(xv[3], w[dx].w, part[j][3]);
              }
            }
          }
        }
        if (hh == 0) {
#pragma unroll
          for (int j = 0; j < R; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) first[j][c] = part[j][c];
        }
      }
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[j][c] = sw ? part[j][c] : first[j][c];
          acc[j][4 + c] = sw ? first[j][c] : part[j][c];
        }
    } else if constexpr (K >= 7) {
      // (the class widths;"""),
    ],
    "k7fullrow": [
        (_CUH, "    if constexpr (K >= 7) {\n      // (the class widths;",
         "    if constexpr (K >= 7 && C < 0) {\n      // (the class widths;"),
    ],
    "k7cap2": [
        (_CUH, "      K < 7 && !kStream && 2 * (SMEM + kSmemPerBlock) <= "
         "kSmemPerSm ? 2 : 1;",
         "      (K < 7 && !kStream && 2 * (SMEM + kSmemPerBlock) <= "
         "kSmemPerSm) ||\n"
         "              (K == 7 && C == 32 && NT == 256)\n"
         "          ? 2\n          : 1;"),
    ],
    "k7two": [
        (_CUH, "      kInt8 || kRingInX ? 1\n",
         "      kInt8 || kRingInX || (K == 7 && C == 32) ? 1\n"),
        (_CUH, "      K < 7 && !kStream && 2 * (SMEM + kSmemPerBlock) <= "
         "kSmemPerSm ? 2 : 1;",
         "      (K < 7 || (K == 7 && C == 32 && NT == 256)) && !kStream &&\n"
         "              2 * (SMEM + kSmemPerBlock) <= kSmemPerSm\n"
         "          ? 2\n          : 1;"),
    ],
    # Written against the streamed layouts' bulk-copy ring
    # (csrc/chunk_ring.cuh): "cluster1": one block, no multicast (each
    # block copies every chunk itself), so that the ring and the
    # multicast are timed apart.
    "cluster1": [
        (_CUH, "constexpr int kRingCluster = 2;",
         "constexpr int kRingCluster = 1;"),
    ],
    # "ringonly": the streamed layouts skip both products (the chunks
    #   still stream, are waited for and released; f32 at C <= 128 reads
    #   one value of t and of each chunk);
    # "noring": no chunk is issued, waited for or released (the products
    #   run on what the stages hold): the ring's share.
    "ringonly": [
        (_CUH, "expand_project<G>(af, pacc, rows.w2 + b, rows.w3 + b, slope);",
         "(void)b;"),
        (_CUH, """          expand_project_f32<G>(t_at, pacc, wc, wc + G::W2_BYTES / 16, slope,
                                lane);""",
         "          pacc[0][0] += wc[0].x + t_at(0, 0).x;"),
        (_WIDE, "      expand_half<G>(af, hb(par), rows.w2 + b, slope, part, "
         "lane);", "      (void)b;"),
        (_WIDE, """      project_half<G>(pacc, h_lane + (uint32_t)(par * G::HB1), rows.w3 + b,
                      part);""", ""),
        (_WIDE, """      if (part < G::ECH / 8)
        expand_half_f32<G>(ts, w2c, hb(par), slope, mt, part, lane);""",
         "      (void)w2c;"),
        (_WIDE, "      project_half_f32<G>(pacc, hb(par), w2c + G::W2_BYTES / 4, "
         "part, lane);", ""),
    ],
    "noring": [
        (_CUH, "      ring_.wait(g);\n", ""),
        (_CUH, """      ring_.release(g, lane);
      if (tid == 0 && g + G::NS - 1 < limit)
        issue(smem, g + G::NS - 1, chunks);
""", ""),
        (_CUH, """      for (int j = r * G::NCH; j < r * G::NCH + G::NS - 1 && j < limit; ++j)
        issue(smem, j, chunks);""", """      for (int j = r * G::NCH; j < r * G::NCH + G::NS - 1 && j < limit; ++j)
        (void)j;"""),
    ],
    # Written against the streamed layouts with per-thread chunk copies
    # (``cedafbd``'s csrc: C = 128's and the wide class's), to split their
    # time before the chunk ring:
    # "nochunks": no weight chunk is copied (the products run on what the
    #   two buffers hold; the barrier a chunk stays);
    # "nochunkproducts": the streamed layouts skip both products (float32
    #   at C = 128 folds t into its accumulators once a tile, so that its
    #   depthwise stays);
    # "nodwln": the depthwise and the LayerNorm are skipped (float32 at
    #   C = 128 takes t and x from the tile as they lie).
    "nochunks": [
        (_CUH, "  const int e0 = chunk * ECH;\n",
         "  const int e0 = chunk * ECH;\n"
         "  if (e0 >= 0) {\n    cp_async_commit();\n    return;\n  }\n"),
    ],
    "nochunkproducts": [
        (_CUH, "expand_project<G>(af, pacc, rows.w2 + b, rows.w3 + b, slope);",
         "(void)b;"),
        (_CUH, """expand_project_f32<G>(tv, pacc, wc, wc + G::W2_BYTES / 16, slope,
                                lane);""",
         """(void)wc;
          if (c == 0)
#pragma unroll
            for (int r = 0; r < C / 4; ++r)
              pacc[r % (C / 8)][0] += tv[0][r] + tv[1][r];"""),
        (_WIDE, "expand_half<G>(af, hb, rows.w2 + b, slope, part, lane);",
         "(void)b;"),
        (_WIDE, "project_half<G>(pacc, h_lane, rows.w3 + b, part);", ""),
        (_WIDE, "expand_half_f32<G>(ts, w2c, hb, slope, mt, part, lane);",
         "(void)w2c;"),
        (_WIDE, "project_half_f32<G>(pacc, hb, w2c + G::W2_BYTES / 4, part, "
         "lane);", ""),
    ],
    "nodwln": [
        (_CUH, "      depthwise_layernorm<G>(xs, dws, lns, ts, tid, cr, "
         "inv_cr);\n", ""),
        (_CUH, """depthwise_layernorm_f32<G>(xs, dws, lns, tv, xc, warp, lane, cr,
                                 inv_cr);""",
         """#pragma unroll
      for (int r = 0; r < C / 4; ++r)
        tv[0][r] = tv[1][r] = xc[0][r] = xc[1][r] = xs[lane + r];"""),
        (_WIDE, "        depthwise_layernorm<G>(xs, dws, lns, ts, tid, cr, "
         "inv_cr);\n", ""),
        (_WIDE, """          depthwise_group<G>(
              reinterpret_cast<const float*>(xbuf(G::NXBUF == 2 ? grp & 1 : 0)),
              dws + grp * G::GC, C, ts, grp * G::GC, tid, s_in);""", ""),
        (_WIDE, "layernorm_rows<G>(ts, ts, lns, cr, inv_cr, warp, lane);", ""),
    ],
}


def cut_copy(source: Path, cuts, work: Path, name: str) -> Path:
    """A copy of the source directory with the edits of ``cuts`` applied."""
    import shutil
    dst = work / f"{name}-src"
    shutil.copytree(source, dst)
    for cut in cuts:
        for fname, old, new in CUTS[cut]:
            f = dst / fname
            text = f.read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"cut {cut}: {old!r} occurs "
                                   f"{text.count(old)} times in {fname}")
            f.write_text(text.replace(old, new))
    return dst


def build(name, source, work, out_dir, sass=False, k7=False):
    """Build one K1 library from ``source`` (a directory of sources, a
    copy of it with ``@CUTS``, or one ``convnext_block.cu``); with ``k7``
    only its ``K7_SOURCES`` and ``K7_STUB``."""
    from blind_image_denoising_torch.ops import cuda_build
    source = str(source)
    if "@" in source:
        source, cuts = source.split("@", 1)
        source = cut_copy(Path(source), cuts.split("+"), work, name)
    source = Path(source)
    files = (sorted(source.glob("convnext*.cu")) if source.is_dir()
             else [source])
    if k7:
        stub = work / f"{name}-k7stub.cu"
        stub.write_text(K7_STUB)
        files = [f for f in files if f.name in K7_SOURCES] + [stub]
    inc = ["-I", str(source if source.is_dir() else source.parent), "-I",
           str(cuda_build.CSRC_DIR)]
    objs = [work / f"{name}-{f.stem}.o" for f in files]
    procs = [subprocess.Popen(
        [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
         *inc, "-c", str(f), "-o", str(o)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for f, o in zip(files, objs)]
    report = [p.communicate()[0] for p in procs]
    if any(p.returncode for p in procs):
        raise RuntimeError(f"nvcc failed for {name}:\n" + "\n".join(report))
    lib_path = work / f"{name}.so"
    link = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
                           "-shared", *map(str, objs), "-o", str(lib_path)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed for {name}:\n{link.stdout}")
    if out_dir is not None:
        (out_dir / f"{name}.ptxas.txt").write_text("\n".join(report))
    if sass:
        tool = Path(cuda_build.find_nvcc()).with_name("cuobjdump")
        text = subprocess.run([str(tool), "-sass", str(lib_path)],
                              capture_output=True, text=True,
                              check=True).stdout
        if out_dir is not None:
            (out_dir / f"{name}.sass.txt").write_text(text)
        for line in depthwise_sass(text):
            print(json.dumps(dict(source=name, **line)), flush=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # a library with the general route takes E (and the route's scratch);
    # one from before it takes neither
    lib.takes_e = hasattr(lib, "bid_convnext_general_scratch_bytes")
    if lib.takes_e:
        lib.bid_convnext_block.argtypes = [p, p, p, p, p, p, p, p,
                                           ctypes.c_longlong, i, i, i, i,
                                           i, i, i, f, f, f, p]
        lib.bid_convnext_block_info.argtypes = [i, i, i, i,
                                                ctypes.POINTER(i)]
    else:
        lib.bid_convnext_block.argtypes = [p, p, p, p, p, p, p,
                                           i, i, i, i, i, i, f, f, f, p]
        lib.bid_convnext_block_info.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.bid_convnext_block.restype = i
    lib.bid_convnext_block_info.restype = i
    return lib


def k1_info(lib, c, k, code, info):
    """``bid_convnext_block_info`` of (C, K) at E = 4C, in either ABI."""
    if lib.takes_e:
        return lib.bid_convnext_block_info(c, k, 4 * c, code, info)
    return lib.bid_convnext_block_info(c, k, code, info)


def k1_launch(lib, x, out, dw, ln, w2, w3, gain, b, h, w, c, k, code,
              slope, s_in, inv_out, stream):
    """``bid_convnext_block`` at E = 4C (a one-pass layout: no scratch),
    in either ABI."""
    head = (x, out, dw, ln, w2, w3, gain)
    if lib.takes_e:
        return lib.bid_convnext_block(*head, None, 0, b, h, w, c, k, 4 * c,
                                      code, slope, s_in, inv_out, stream)
    return lib.bid_convnext_block(*head, b, h, w, c, k, code, slope, s_in,
                                  inv_out, stream)


# a K1 kernel's mangled name: I/O type, C, K, ragged
_KERNEL_NAME = re.compile(
    r"convnext_block_kernelI(13__nv_bfloat16|a|f)Li(\d+)ELi(\d+)ELb([01])E")
_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)([^;]*);")
_SASS_MODES = {"13__nv_bfloat16": "bf16", "a": "int8", "f": "f32"}


def depthwise_sass(text):
    """Per K = 7 instantiation in bf16 and int8 of a library's SASS
    (``cuobjdump -sass``): its instructions and FFMAs, and those of its
    depthwise loop, the smallest loop (a backward branch and the
    instructions from its target to it) that holds at least 128 FFMAs,
    with its instructions per FFMA and its shared-memory loads. NOPs are
    not counted."""
    out = []
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = part.split("\n", 1)[0].strip()
        m = _KERNEL_NAME.search(name)
        if m is None or m.group(3) != "7" or _SASS_MODES[m.group(1)] == "f32":
            continue
        insts = [(int(a, 16), op, rest) for a, op, rest in
                 _SASS_LINE.findall(part) if op != "NOP"]
        addrs = [a for a, _, _ in insts]
        loops = []
        for a, op, rest in insts:
            t = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and t and int(t.group(1), 16) <= a:
                body = [o for b, o, _ in insts if int(t.group(1), 16) <= b <= a]
                ffma = sum(o.startswith("FFMA") for o in body)
                if ffma >= 128:
                    loops.append((len(body), ffma, sum(
                        o.startswith("LDS") for o in body)))
        entry = dict(mode=_SASS_MODES[m.group(1)], C=int(m.group(2)), K=7,
                     ragged=m.group(4) == "1", instructions=len(addrs),
                     ffma=sum(op.startswith("FFMA") for _, op, _ in insts))
        if loops:
            n, ffma, lds = min(loops)
            entry.update(loop_instructions=n, loop_ffma=ffma, loop_lds=lds,
                         loop_instructions_per_ffma=round(n / ffma, 3))
        out.append(entry)
    return out


MMA_RATE_SOURCE = r"""
#include <cstdint>
#include <cstdio>
template <bool BF16>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if (BF16)
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                   "r"(b1));
  else
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                 "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                   "r"(b1));
}
template <int CHAINS, bool BF16>
__global__ void chains(float* out, long long* clocks, int iters) {
  float d[CHAINS][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u,
                         threadIdx.x * 7u};
  const uint32_t b0 = threadIdx.x * 11u, b1 = threadIdx.x * 13u;
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) mma<BF16>(d[j], a, b0, b1);
  __syncthreads();
  const long long t1 = clock64();
  float s = 0.f;
  for (int j = 0; j < CHAINS; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) clocks[blockIdx.x] = t1 - t0;
}
template <int CHAINS, bool BF16>
void run(int warps) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  long long* clocks;
  cudaMalloc(&out, sms * 1024 * sizeof(float));
  cudaMalloc(&clocks, sms * sizeof(long long));
  const int iters = 2000;
  for (int rep = 0; rep < 2; ++rep)  // the second launch is timed
    chains<CHAINS, BF16><<<sms, 32 * warps>>>(out, clocks, iters);
  long long host[1024];
  cudaMemcpy(host, clocks, sms * sizeof(long long), cudaMemcpyDeviceToHost);
  double mean = 0.0;
  for (int i = 0; i < sms; ++i) mean += (double)host[i] / sms;
  printf("{\"mma\": \"%s\", \"chains_per_warp\": %d, \"warps_per_sm\": %d, "
         "\"per_clock_per_sm\": %.4f}\n",
         BF16 ? "m16n8k16.bf16" : "m16n8k8.tf32", CHAINS, warps,
         (double)warps * iters * CHAINS / mean);
  cudaFree(out);
  cudaFree(clocks);
}
int main() {
  run<1, false>(8); run<2, false>(8); run<4, false>(8); run<8, false>(8);
  run<1, false>(16); run<4, false>(16);
  run<4, true>(8); run<8, true>(16);
  return cudaDeviceSynchronize() != cudaSuccess;
}
"""


# The L2 -> SM read rate: many blocks read one resident buffer of 1 MB
# (what every block of K1's streamed layouts does with W2 and W3), by
# 16-byte loads that skip L1 (ld.global.cg) from every thread of one block
# an SM, and by the streamed layouts' own bulk copies (csrc/chunk_ring.cuh:
# one thread a block issues 16 KB chunks into a ring of four stages, the
# 8 warps wait on each stage's full barrier and release it) on one block
# an SM and, multicast, on clusters of 2 (the L2 reads half the bytes that
# land); then how many clusters of 1, 2 and 4 blocks of 220 KB of shared
# memory the card holds at once.
L2_RATE_SOURCE = r"""
#include <cstdio>
#include "chunk_ring.cuh"
constexpr int kBuf = 1 << 20, kChunk = 16384, kStages = 4;
__global__ void ldcg_read(const uint4* __restrict__ buf, int reps,
                          uint4* sink) {
  uint4 acc = make_uint4(0, 0, 0, 0);
  for (int r = 0; r < reps; ++r)
    for (int i = threadIdx.x; i < kBuf / 16; i += blockDim.x) {
      const uint4 v = __ldcg(buf + i);
      acc.x ^= v.x; acc.y ^= v.y; acc.z ^= v.z; acc.w ^= v.w;
    }
  sink[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}
// the ring's loop over `chunks` chunks; NCL blocks a cluster. MC: block r
// copies 1/NCL of each chunk multicast to the cluster (else each block its
// whole chunk to itself); CR: a stage is refilled once every block's warps
// released it (else once this block's did); SEM: the releases and the
// producer's wait at cluster scope (else at the default, CTA scope)
template <int NCL, bool MC, bool CR, bool SEM, int NS, bool STAG = false>
__global__ void bulk_read(const unsigned char* buf, int chunks,
                          unsigned* sink) {
  extern __shared__ __align__(128) unsigned char smem[];
  using namespace bid_ring;
  const uint32_t bars = smem_addr(smem), ring = smem_addr(smem + 256);
  const int tid = threadIdx.x, lane = tid & 31, warps = blockDim.x / 32;
  const int rank = cluster_rank<NCL>();
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (NS + st); };
  if (tid == 0) {
    for (int st = 0; st < NS; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), CR ? NCL * warps : warps);
    }
    fence_mbar_init();
  }
  sync_cluster<NCL>();
  // STAG: each cluster starts at another chunk of the buffer, so that the
  // L2 serves distinct lines at once (else every block reads the same)
  const int shift = STAG ? (int)(blockIdx.x / NCL) * 5 : 0;
  auto src = [&](int g) {
    return buf + (size_t)((g + shift) % (kBuf / kChunk)) * kChunk;
  };
  auto issue = [&](int g) {
    const int st = g % NS;
    if (g >= NS) {
      const uint32_t parity = (uint32_t)((g / NS - 1) & 1);
      if (SEM)
        asm volatile(
            "{\n.reg .pred p;\nWAIT_CL:\n"
            "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
            "[%0], %1;\n@!p bra WAIT_CL;\n}\n" ::"r"(empty(st)),
            "r"(parity)
            : "memory");
      else
        wait_parity(empty(st), parity);
    }
    arrive_expect_tx(full(st), kChunk);
    const uint32_t dst = ring + st * kChunk;
    if (MC && NCL > 1) {
      const uint32_t part = kChunk / NCL;
      bulk_copy_multicast(dst + rank * part, src(g) + rank * part, part,
                          full(st), (uint16_t)((1u << NCL) - 1));
    } else {
      bulk_copy(dst, src(g), kChunk, full(st));
    }
  };
  if (tid == 0)
    for (int g = 0; g < NS - 1 && g < chunks; ++g) issue(g);
  unsigned acc = 0;
  for (int g = 0; g < chunks; ++g) {
    wait_parity(full(g % NS), (uint32_t)((g / NS) & 1));
    acc += reinterpret_cast<const unsigned*>(smem + 256 + (g % NS) *
                                             kChunk)[tid];
    __syncwarp();
    if (CR && NCL > 1) {
      if (lane < NCL) {
        if (SEM) {
          asm volatile(
              "{\n.reg .b32 remote;\n"
              "mapa.shared::cluster.u32 remote, %0, %1;\n"
              "mbarrier.arrive.release.cluster.shared::cluster.b64 _, "
              "[remote];\n}\n" ::"r"(empty(g % NS)),
              "r"(lane)
              : "memory");
        } else {
          arrive_cluster(empty(g % NS), (uint32_t)lane);
        }
      }
    } else if (lane == 0) {
      arrive_local(empty(g % NS));
    }
    if (tid == 0 && g + NS - 1 < chunks) issue(g + NS - 1);
  }
  sync_cluster<NCL>();
  sink[blockIdx.x * blockDim.x + tid] = acc;
}
int sms() {
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, 0);
  return n;
}
float time_ms(cudaEvent_t a, cudaEvent_t b) {
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  return ms;
}
template <typename Kern>
int clusters(Kern kern, int ncl, int smem) {
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(ncl, 1, 1);
  cfg.blockDim = dim3(256, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kern, &cfg) != cudaSuccess) n = -1;
  return n;
}
template <int NCL, bool MC, bool CR, bool SEM, int NS, bool STAG = false>
void bulk(const unsigned char* buf, unsigned* sink, cudaEvent_t a,
          cudaEvent_t b) {
  const int smem = 256 + NS * kChunk, chunks = 64 * (kBuf / kChunk);
  auto kern = bulk_read<NCL, MC, CR, SEM, NS, STAG>;
  const int ncl = clusters(kern, NCL, smem);
  const int grid = (sms() / NCL < ncl ? sms() / NCL : ncl) * NCL;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NCL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(256, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  float ms = 0.f;
  for (int rep = 0; rep < 2; ++rep) {  // the second launch is timed
    cudaEventRecord(a);
    const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, buf, chunks, sink);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    if (e != cudaSuccess || cudaGetLastError() != cudaSuccess) {
      printf("{\"probe\": \"bulk\", \"cluster\": %d, \"error\": %d}\n", NCL,
             (int)e);
      return;
    }
    ms = time_ms(a, b);
  }
  const double landed = (double)grid * chunks * kChunk;
  printf("{\"probe\": \"bulk\", \"cluster\": %d, \"multicast\": %d, "
         "\"cluster_release\": %d, \"cluster_scope\": %d, \"staggered\": %d, "
         "\"blocks\": %d, \"stages\": %d, \"chunk_bytes\": %d, "
         "\"ms\": %.4f, \"landed_tb_per_s\": %.3f, "
         "\"l2_read_tb_per_s\": %.3f}\n",
         NCL, (int)MC, (int)CR, (int)SEM, (int)STAG, grid, NS, kChunk, ms,
         landed / ms / 1e9, landed / (MC ? NCL : 1) / ms / 1e9);
}
int main() {
  unsigned char* buf;
  uint4* sink;
  cudaMalloc(&buf, kBuf);
  cudaMemset(buf, 1, kBuf);
  cudaMalloc(&sink, 132 * 1024 * 16);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (int threads : {256, 1024}) {
    const int reps = 16;
    float ms = 0.f;
    for (int rep = 0; rep < 2; ++rep) {
      cudaEventRecord(a);
      ldcg_read<<<sms(), threads>>>(reinterpret_cast<const uint4*>(buf),
                                     reps, sink);
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      ms = time_ms(a, b);
    }
    printf("{\"probe\": \"ld.global.cg\", \"blocks\": %d, \"threads\": %d, "
           "\"ms\": %.4f, \"l2_read_tb_per_s\": %.3f}\n", sms(), threads, ms,
           (double)sms() * reps * kBuf / ms / 1e9);
  }
  unsigned* sk = reinterpret_cast<unsigned*>(sink);
  bulk<1, false, false, false, 4>(buf, sk, a, b);
  bulk<2, false, false, false, 4>(buf, sk, a, b);
  bulk<2, false, true, true, 4>(buf, sk, a, b);
  bulk<2, false, true, false, 4>(buf, sk, a, b);
  bulk<2, true, false, false, 4>(buf, sk, a, b);
  bulk<2, true, true, true, 4>(buf, sk, a, b);
  bulk<2, true, true, false, 4>(buf, sk, a, b);
  bulk<2, true, true, true, 8>(buf, sk, a, b);
  bulk<1, false, false, false, 8>(buf, sk, a, b);
  bulk<1, false, false, false, 4, true>(buf, sk, a, b);
  bulk<2, true, true, false, 4, true>(buf, sk, a, b);
  bulk<1, false, false, false, 8, true>(buf, sk, a, b);
  bulk<2, true, true, false, 8, true>(buf, sk, a, b);
  printf("{\"probe\": \"clusters_at_220KB\", \"1\": %d, \"2\": %d, "
         "\"4\": %d}\n",
         clusters(bulk_read<1, false, false, false, 4>, 1, 225280),
         clusters(bulk_read<2, true, true, true, 4>, 2, 225280),
         clusters(bulk_read<4, true, true, true, 4>, 4, 225280));
  return cudaDeviceSynchronize() != cudaSuccess;
}
"""


def run_probe(work: Path, name: str, source: str) -> None:
    """Build ``source`` (with the checkout's ``csrc/`` on the include path)
    and run it; print its JSON lines."""
    from blind_image_denoising_torch.ops import cuda_build
    src, exe = work / f"{name}.cu", work / name
    src.write_text(source)
    built = subprocess.run([cuda_build.find_nvcc(), "-gencode",
                            "arch=compute_90a,code=sm_90a", "-std=c++17",
                            "-O3", "-I", str(cuda_build.CSRC_DIR), "-o",
                            str(exe), str(src)], capture_output=True,
                           text=True)
    if built.returncode != 0:
        print(json.dumps(dict(probe=name, build_error=built.stderr[-4000:])),
              flush=True)
        return
    ran = subprocess.run([str(exe)], capture_output=True, text=True)
    print(ran.stdout.strip(), flush=True)
    if ran.returncode != 0:
        print(json.dumps(dict(probe=name, exit=ran.returncode,
                              stderr=ran.stderr[-2000:])), flush=True)


def mma_rate(work: Path) -> None:
    """Build and run ``MMA_RATE_SOURCE``; print its JSON lines."""
    run_probe(work, "mma_rate", MMA_RATE_SOURCE)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("sources", nargs="*", metavar="NAME=SOURCE")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--out", type=Path, default=None)
    parser.add_argument("--sass", action="store_true",
                        help="print the K = 7 depthwise loops' SASS counts "
                             "(with --out, also write each library's SASS)")
    parser.add_argument("--rows", choices=("all", "k7"), default="all",
                        help="k7: only K7_ROWS")
    parser.add_argument("--k7-build", action="store_true",
                        help="build only the sources the K = 7 rows at "
                             "C <= 128 run (K7_SOURCES; the rest stubbed)")
    parser.add_argument("--mma-rate", action="store_true")
    parser.add_argument("--l2-rate", action="store_true",
                        help="measure the L2 -> SM read rate first")
    parser.add_argument("--channels", default=None,
                        help="time only the rows at these C (comma list)")
    parser.add_argument("--dtype", default=None, choices=("bf16", "int8",
                                                           "f32"),
                        help="time only the rows in this mode")
    parser.add_argument("--wrapper", action="store_true",
                        help="time the checkout's wrapper beside the "
                             "libraries, operands prepared on every call "
                             "and once")
    args = parser.parse_args()
    if not args.sources and not args.mma_rate and not args.l2_rate:
        parser.error("give NAME=SOURCE pairs, --mma-rate, --l2-rate, or "
                     "several")
    if not torch.cuda.is_available():
        print("k1_compare: no CUDA device available", file=sys.stderr)
        return 1
    if args.mma_rate or args.l2_rate:
        with tempfile.TemporaryDirectory() as work:
            if args.mma_rate:
                mma_rate(Path(work))
            if args.l2_rate:
                run_probe(Path(work), "l2_rate", L2_RATE_SOURCE)
        if not args.sources:
            return 0
    from blind_image_denoising_torch.ops import pallas_convnext as pc
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    named = [spec.split("=", 1) for spec in args.sources]
    with tempfile.TemporaryDirectory() as work:
        libs = {name: build(name, Path(src), Path(work), args.out,
                            args.sass, args.k7_build)
                for name, src in named}
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device="cuda")

    only = (None if args.channels is None
            else {int(c) for c in args.channels.split(",")})
    rows = (K7_ROWS if args.rows == "k7" else list(dict.fromkeys(
        ROWS + CLASS_ROWS + PADDED_ROWS + NEW_ROWS + CLUSTER_ROWS + RING_ROWS
        + K7_ROWS)))
    for dtype, c, k, b, hw in rows:
        if (only is not None and c not in only) or (
                args.dtype is not None and dtype != args.dtype):
            continue
        e = 4 * c
        wts = dict(dw=t(rng.normal(0, 0.3, (c, 1, k, k))),
                   ln_scale=t(rng.uniform(0.5, 1.5, (c,))),
                   w2=t(rng.normal(0, 1 / np.sqrt(c), (e, c))),
                   w3=t(rng.normal(0, 1 / np.sqrt(e), (c, e))),
                   gain=t(rng.uniform(0.3, 0.9, (c,))))
        x = t(rng.normal(0, 1, (b, hw, hw, c)))
        if dtype != "f32":
            x = x.to(torch.bfloat16)
        scales = {}
        s_in, inv_out = 1.0, 1.0
        if dtype == "int8":
            scales = dict(scale_in=float(x.abs().max()) / 127,
                          scale_out=4 * float(x.abs().max()) / 127)
            x = pc.quantize(x, scales["scale_in"])
            s_in, inv_out = pc.int8_constants(**scales)
        ref = pc.convnext_block_plain(x, **wts, **scales)
        # the weights as each library's layout for (C, K) takes them (a
        # library from before the cluster fills 5 ints, so its cluster size
        # stays 1, and one from before the layouts of widths that are
        # multiples of 16 fills 7, so its width stays 0: its class's);
        # None where it has no layout
        # (and one that streams W2 and W3 through a bulk-copy ring, its
        # ninth int, the ring's chunks as this checkout's wrapper makes
        # them)
        operands, infos = {}, {}
        for name, lib in libs.items():
            info = (ctypes.c_int * 9)(*[0] * 5, 1, 0, 0, 0)
            rc = k1_info(lib, c, k, pc._DTYPE_CODES[x.dtype],
                                             info)
            if rc not in (0, UNSUPPORTED):
                raise RuntimeError(f"{name}: info {rc}")
            infos[name] = dict(zip(("smem_bytes", "registers", "local_bytes",
                                    "threads", "blocks_per_sm"), info[:5]))
            operands[name] = (
                None if rc else pc.kernel_operands(x.dtype, **wts)
                if info[8] else route_operands(pc, x.dtype, wts, info[5],
                                               info[7]))
        out = torch.empty_like(x)
        kw = dict(slope=0.1, **scales)
        wrappers = {} if not args.wrapper else {
            "wrapper": lambda x=x: pc.convnext_block(x, **wts, **kw),
            "wrapper_cached": lambda x=x, ops=pc.kernel_operands(
                x.dtype, **wts): pc.convnext_block(x, **wts, **kw,
                                                   operands=ops)}

        def call(name, x=x):
            if name in wrappers:
                return wrappers[name](x)
            if operands[name] is None:
                raise RuntimeError("no layout for this C")
            lib, (dw, ln, w2, w3, gain) = libs[name], operands[name]
            rc = k1_launch(
                lib, x.data_ptr(), out.data_ptr(), dw.data_ptr(),
                ln.data_ptr(), w2.data_ptr(), w3.data_ptr(), gain.data_ptr(),
                b, hw, hw, c, k, pc._DTYPE_CODES[x.dtype], 0.1, s_in,
                inv_out, stream)
            if rc != 0:
                raise RuntimeError(f"launch refused: code {rc}")
            return rc

        errs, rels, row_libs = {}, {}, []
        for name in [*libs, *wrappers]:
            if name in libs and operands[name] is None:
                print(json.dumps(dict(source=name, dtype=dtype, C=c, K=k,
                                      unsupported=True)), flush=True)
                continue
            out.zero_()
            got = call(name)
            torch.cuda.synchronize()
            row_libs.append(name)
            got = got if name in wrappers else out
            errs[name] = float((got.float() - ref.float()).abs().max())
            rels[name] = errs[name] / float(ref.float().abs().max())
        times = {name: [] for name in row_libs}
        cold = {name: [] for name in row_libs}
        copies = cold_copies(x)
        for r in range(args.rounds):
            order = row_libs if r % 2 == 0 else row_libs[::-1]
            for name in order:
                times[name].append(cuda_ms(lambda: call(name)))
                cold[name].append(cuda_ms(lambda xc: call(name, xc),
                                          inputs=copies))
        bound, by = convnext_bound_ms(b, hw, hw, c, k, x.dtype)
        f32 = {} if dtype != "f32" else dict(
            bound_cuda_cores_ms=convnext_bound_ms(
                b, hw, hw, c, k, x.dtype, cuda_cores=True)[0])
        for name in row_libs:
            if dtype == "f32":
                f32["relative_diff_from_plain"] = rels[name]
            print(json.dumps(dict(
                source=name, dtype=dtype, C=c, K=k, shape=[b, hw, hw, c],
                ms=times[name], ms_min=min(times[name]), cold_ms=cold[name],
                cold_ms_min=min(cold[name]), bound_ms=bound,
                bound_by=by, max_abs_diff_from_plain=errs[name], **f32,
                **({"info": infos[name]} if name in infos else {}))),
                flush=True)
        del copies
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
