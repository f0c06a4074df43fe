#!/usr/bin/env python3
"""Time versions of the ConvNext-unit kernel (K1) against each other on
one NVIDIA GPU, inside one process, at the six shapes ``chip_smoke.py``
reports (bf16 (32,3) 8×256², (64,5) 8×128², (32,5) 32×256², (64,5)
32×128² and int8 (32,5) 32×256², (64,5) 32×128²) and, for
``dtype="float32"`` serving, f32 (32,3) 8×256² and (64,5) 8×128².

    python3 k1_compare.py [--rounds N] [--out DIR] NAME=SOURCE [NAME=SOURCE ...]

Each SOURCE is a ``convnext_block.cu`` (the checkout's, a parent
commit's, or a copy with a phase cut out); ``common.cuh`` is taken from
the checkout. Every source is compiled by ``nvcc`` for ``sm_90a`` into a
library of its own, and the libraries are timed in turns (in the given
order in even rounds, reversed in odd ones: parent, change, change,
parent with two names and two rounds), since times of different
processes or machines do not compare. Per source and shape it prints
one JSON line with the device milliseconds of every round (CUDA events
around calls queued behind a spin kernel), the largest difference from
the plain PyTorch version, and the bound; then the card's name and power
limit. With ``--out DIR`` the compiler's resource report
(``-Xptxas -v``) and the SASS (``cuobjdump -sass``) of every source are
written to ``DIR/NAME.ptxas.txt`` and ``DIR/NAME.sass.txt``.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from chip_smoke import convnext_bound_ms, cuda_ms

# (dtype, C, K, batch, height and width)
ROWS = [("bf16", 32, 3, 8, 256), ("bf16", 64, 5, 8, 128),
        ("bf16", 32, 5, 32, 256), ("bf16", 64, 5, 32, 128),
        ("int8", 32, 5, 32, 256), ("int8", 64, 5, 32, 128),
        ("f32", 32, 3, 8, 256), ("f32", 64, 5, 8, 128)]


def build(name, source, work, out_dir):
    from blind_image_denoising_torch.ops import cuda_build
    lib_path = work / f"{name}.so"
    cmd = [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
           "-I", str(cuda_build.CSRC_DIR), "-shared", str(source), "-o",
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
    lib.bid_convnext_block.argtypes = [p, p, p, p, p, p, p,
                                       i, i, i, i, i, i, f, f, f, p]
    lib.bid_convnext_block.restype = i
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("sources", nargs="+", metavar="NAME=SOURCE")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("k1_compare: no CUDA device available", file=sys.stderr)
        return 1
    from blind_image_denoising_torch.ops import pallas_convnext as pc
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    named = [s.split("=", 1) for s in args.sources]
    with tempfile.TemporaryDirectory() as work:
        libs = {name: build(name, Path(src), Path(work), args.out)
                for name, src in named}
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device="cuda")

    for dtype, c, k, b, hw in ROWS:
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
        dw = wts["dw"].reshape(c, k * k).contiguous()
        w_dtype = torch.float32 if dtype == "f32" else torch.bfloat16
        w2, w3 = (wts[n].to(w_dtype).contiguous() for n in ("w2", "w3"))
        out = torch.empty_like(x)

        def call(lib):
            rc = lib.bid_convnext_block(
                x.data_ptr(), out.data_ptr(), dw.data_ptr(),
                wts["ln_scale"].data_ptr(), w2.data_ptr(), w3.data_ptr(),
                wts["gain"].data_ptr(), b, hw, hw, c, k,
                pc._DTYPE_CODES[x.dtype], 0.1, s_in, inv_out, stream)
            if rc != 0:
                raise RuntimeError(f"launch refused: code {rc}")

        times = {name: [] for name in libs}
        errs = {}
        for name, lib in libs.items():
            out.zero_()
            call(lib)
            torch.cuda.synchronize()
            errs[name] = float((out.float() - ref.float()).abs().max())
        for r in range(args.rounds):
            order = list(libs) if r % 2 == 0 else list(libs)[::-1]
            for name in order:
                times[name].append(cuda_ms(lambda: call(libs[name])))
        bound, by = convnext_bound_ms(b, hw, hw, c, k, x.dtype)
        for name in libs:
            print(json.dumps(dict(
                source=name, dtype=dtype, C=c, K=k, shape=[b, hw, hw, c],
                ms=times[name], ms_min=min(times[name]), bound_ms=bound,
                bound_by=by, max_abs_diff_from_plain=errs[name])), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
