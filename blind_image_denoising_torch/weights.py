"""Artifact weights: a pure-Python reader for flax's ``params.msgpack`` and
the layout conversion from flax parameter trees to a torch state dict.

The reader covers the subset of msgpack that ``flax.serialization.to_bytes``
writes: maps, arrays, str, bin, ints, floats, nil and bool, plus flax's
two numpy extension types — ext 1 (ndarray: a packed
``(shape, dtype_name, C-order bytes)`` tuple) and ext 3 (numpy scalar,
the same payload with shape ``()``). It needs neither ``msgpack`` nor
flax, so the port loads artifacts on machines that have only torch and
numpy.

Layouts (flax → torch):
* conv kernels HWIO ``[kh, kw, in, out]`` → OIHW ``[out, in, kh, kw]``;
  a depthwise kernel ``[K, K, 1, C]`` becomes ``[C, 1, K, K]`` by the
  same rule;
* the two 1×1 kernels inside a ConvNext unit (``conv_2``/``conv_3`` of a
  subtree that also holds ``conv_1``) become plain matrices ``[E, C]``
  and ``[C, E]``, the operands of the fused unit kernel
  (``ops/pallas_convnext.py``);
* every other leaf keeps its shape.
"""

import struct
from typing import Any, Dict

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.read_map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.read_array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            n = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            return bytes(self.take(n))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xD3:
            return self.unpack({0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                                0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                                0xD2: ">i", 0xD3: ">q"}[b])
        if 0xD4 <= b <= 0xD8:
            n = 1 << (b - 0xD4)
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        if b in (0xD9, 0xDA, 0xDB):
            n = self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return str(self.take(n), "utf-8")
        if b in (0xDC, 0xDD):
            return self.read_array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.read_map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def read_array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def read_map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _ext(code: int, payload: bytes):
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack ext type {code}")
    shape, dtype_name, buf = _Reader(payload).read()
    name = dtype_name.decode("ascii") if isinstance(dtype_name, bytes) \
        else dtype_name
    if name == "bfloat16":
        # numpy has no bfloat16: widen the bit patterns to float32 (exact)
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        arr = bits.view(np.float32).reshape(tuple(shape))
    else:
        arr = np.frombuffer(buf, dtype=np.dtype(name)).reshape(tuple(shape))
    return arr[()] if code == _EXT_NPSCALAR else arr


def msgpack_restore(data: bytes) -> Dict:
    """Decode flax ``to_bytes``/``msgpack_serialize`` output into a nested
    dict of numpy arrays (the equivalent of
    ``flax.serialization.msgpack_restore``)."""
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def load_msgpack(path) -> Dict:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def _is_convnext_unit(node: Dict) -> bool:
    return isinstance(node, dict) and {"conv_1", "conv_2",
                                       "conv_3"} <= set(node)


def params_from_flax(tree: Dict) -> Dict[str, torch.Tensor]:
    """Flax ``params`` tree (numpy leaves, optionally wrapped in
    ``{"params": ...}``) → flat float32 torch state dict whose keys are the
    flax paths joined by ``.``, with the layouts of the module docstring."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Dict, prefix: str, in_unit: bool):
        unit = _is_convnext_unit(node)
        for key, val in node.items():
            path = f"{prefix}{key}"
            if isinstance(val, dict):
                walk(val, path + ".", unit and key in ("conv_2", "conv_3"))
                continue
            t = torch.from_numpy(np.array(val, np.float32))
            if t.ndim == 4:
                t = t.permute(3, 2, 0, 1)          # HWIO -> OIHW
                if in_unit:
                    t = t[:, :, 0, 0]              # 1x1 -> [out, in]
            out[path] = t.contiguous()

    walk(tree, "", False)
    return out
