"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into an
object (one ``nvcc`` per source, all started together, so the build
takes as long as the slowest source however many kernels later slices
add), the objects are linked into one shared library with a plain C
interface, and the library is loaded with ``ctypes``. The build happens at first use, in
the process that launches the first kernel, never at import. It is
cached under ``blind_image_denoising_torch/_build/<hash>/``, keyed by
the sources and the flags, and a finished build is moved into place
atomically so concurrent processes never load a half-written library.

``nvcc`` is taken from ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
then ``PATH``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
LIB_NAME = "libbid_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# seconds the last build took in this process (0.0 when it was cached)
build_seconds = 0.0


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def find_nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def _digest(srcs: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, srcs: List[Path], out_dir: Path,
             verbose: bool) -> None:
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    for s in srcs:
        obj = out_dir / (s.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(s), "-o", str(obj)]
        procs.append((s, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for s, p in procs:
        out, _ = p.communicate()
        if verbose and out:
            print(out, flush=True)
        if p.returncode != 0:
            failed.append(f"{s.name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    objs = [str(out_dir / (s.stem + ".o")) for s in srcs]
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", str(out_dir / LIB_NAME)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")


def build(verbose: bool = False) -> Path:
    """Build the kernel library if no cached build matches the sources;
    return its path."""
    global build_seconds
    srcs = sources()
    target = BUILD_DIR / _digest(srcs)
    lib_path = target / LIB_NAME
    if lib_path.is_file():
        build_seconds = 0.0
        return lib_path
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR, prefix=".tmp-"))
    try:
        _compile(find_nvcc(), srcs, tmp, verbose)
        try:
            tmp.rename(target)
        except OSError:
            if not lib_path.is_file():      # lost a race to a broken build
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return lib_path


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bid_convnext_block.argtypes = [p, p, p, p, p, p, p,
                                       i, i, i, i, i, i, f, p]
    lib.bid_convnext_block.restype = i
    lib.bid_band_smooth.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.bid_band_smooth.restype = i
    lib.bid_error_string.argtypes = [i]
    lib.bid_error_string.restype = ctypes.c_char_p


def library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build(verbose)))
            _declare(lib)
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry point returned a nonzero status (a CUDA error
    from the launch, or a negative code for an unsupported shape)."""
    if rc != 0:
        msg = lib.bid_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: {msg} (code {rc})")
