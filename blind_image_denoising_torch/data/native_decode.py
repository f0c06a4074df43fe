"""ctypes loader for the native JPEG / PNG decoder (``data/native/decode.cc``,
the port's copy of the JAX package's).

The shared library is built at first use with ``g++ -O2 -shared -fPIC
... -ljpeg -lpng`` into ``blind_image_denoising_torch/_build/``, keyed
by a hash of the source, and moved into place atomically. Where it
cannot build (no compiler, no libjpeg / libpng headers), ``available()``
is False and ``load_image`` decodes with PIL, as the JAX package does.
This is host decode: one C call per file with the interpreter lock
released, so the dataset's decode threads run in parallel.
"""

import ctypes
import hashlib
import logging
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger("blind_image_denoising_torch")

SRC = Path(__file__).resolve().parent / "native" / "decode.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ["-O2", "-shared", "-fPIC"]
_LIBS = ["-ljpeg", "-lpng"]

_lock = threading.Lock()
_lib = None
_tried = False


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS + _LIBS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"decode-{h.hexdigest()[:16]}" / "_bid_decode.so"


def _build(target: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR, prefix=".tmp-decode-"))
    try:
        cmd = ["g++", *_FLAGS, "-o", str(tmp / target.name), str(SRC),
               *_LIBS]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            logger.info(f"native decoder build failed ({e}); using PIL")
            return False
        try:
            tmp.rename(target.parent)
        except OSError:
            if not target.is_file():      # lost a race to a broken build
                raise
        return True
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _library_path()
        if not path.is_file() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            logger.info(f"native decoder unavailable ({e}); using PIL")
            return None
        lib.bid_decode.restype = ctypes.POINTER(ctypes.c_ubyte)
        lib.bid_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.bid_free.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decode(path, num_channels: int = 3) -> Optional[np.ndarray]:
    """Decode a JPEG / PNG file to uint8 HWC, or None when the native path
    cannot (another format, a decode error, no library)."""
    lib = _load()
    if lib is None:
        return None
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    buf = lib.bid_decode(str(path).encode(), int(num_channels),
                         ctypes.byref(w), ctypes.byref(h), ctypes.byref(c))
    if not buf:
        return None
    try:
        n = h.value * w.value * c.value
        arr = np.ctypeslib.as_array(buf, shape=(n,)).copy()
        return arr.reshape(h.value, w.value, c.value)
    finally:
        lib.bid_free(buf)
