"""Artifact weights: a pure-Python reader and writer for flax's
``params.msgpack`` and the layout conversion between flax parameter trees
and a torch state dict.

The reader and the writer cover the subset of msgpack that
``flax.serialization.to_bytes`` writes: maps, arrays, str, bin, ints,
floats, nil and bool, plus flax's two numpy extension types — ext 1
(ndarray: a packed ``(shape, dtype_name, C-order bytes)`` tuple) and
ext 3 (numpy scalar, the same payload with shape ``()``). They need
neither ``msgpack`` nor flax, so the port reads and writes artifacts on
machines that have only torch and numpy. :func:`msgpack_serialize` writes
the bytes ``flax.serialization.msgpack_serialize`` writes for a tree in
the same key order (flax's own call sorts the keys first; ``to_bytes``
keeps them as given).

Layouts (flax → torch):
* conv kernels HWIO ``[kh, kw, in, out]`` → OIHW ``[out, in, kh, kw]``;
  a depthwise kernel ``[K, K, 1, C]`` becomes ``[C, 1, K, K]`` by the
  same rule, and so do a transposed conv's ``[kh, kw, in, out]`` (held
  as ``[out, in, kh, kw]``) and a separable conv's ``depthwise_kernel``
  and ``pointwise_kernel``;
* the two 1×1 kernels inside a ConvNext unit (``conv_2``/``conv_3`` of a
  subtree that also holds ``conv_1``) become plain matrices ``[E, C]``
  and ``[C, E]``, the operands of the fused unit kernel
  (``ops/pallas_convnext.py``);
* every other leaf keeps its shape.

Batch statistics (``batch_stats``) merge into the same state dict as the
params, and :func:`attach_quant_scales` hangs the int8 scales of a
``quant.msgpack`` on the modules at their flax paths.
:func:`flax_from_params` goes the other way: a model (or its state
dict) back to the flax variables tree.
"""

import struct
from typing import Any, Dict, Union

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
# flax splits an array leaf above this many bytes into chunks
_MAX_CHUNK_BYTES = 2 ** 30


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


def _pack_uint(n: int, fixed: int, codes) -> bytes:
    """The shortest of msgpack's length or unsigned headers for ``n``:
    the fix form below ``fixed`` (``codes[0]`` | n), then 8/16/32 bits
    (``codes[1:]``, None where msgpack has no such form)."""
    if n < fixed:
        return bytes([codes[0] | n])
    for code, fmt, limit in zip(codes[1:], (">B", ">H", ">I"),
                                (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of {n} entries or bytes is too large")


def _pack_int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32),
                                 (0xCF, ">Q", 1 << 64)):
            if v < limit:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31),
                                 (0xD3, ">q", 1 << 63)):
            if v >= -limit:
                return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} does not fit msgpack")


def _pack_ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = (bytes([fixed[n]]) if n in fixed
            else _pack_uint(n, 0, (0, 0xC7, 0xC8, 0xC9)))
    return head + struct.pack(">b", code) + payload


def _pack_ndarray(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError("object and structured dtypes do not serialize")
    if arr.nbytes > _MAX_CHUNK_BYTES:
        raise ValueError("an array leaf above 1 GiB would be chunked by flax")
    # flax packs (shape, dtype name, C-order bytes) as a msgpack array
    return _pack((tuple(int(d) for d in arr.shape), arr.dtype.name,
                  np.ascontiguousarray(arr).tobytes("C")))


def _pack(obj) -> bytes:
    if obj is None:
        return b"\xc0"
    if obj is True or obj is False:
        return b"\xc3" if obj else b"\xc2"
    if type(obj) is int:
        return _pack_int(obj)
    if type(obj) is float:
        return b"\xcb" + struct.pack(">d", obj)
    if type(obj) is str:
        raw = obj.encode("utf-8")
        return _pack_uint(len(raw), 32, (0xA0, 0xD9, 0xDA, 0xDB)) + raw
    if type(obj) is bytes:
        return _pack_uint(len(obj), 0, (0, 0xC4, 0xC5, 0xC6)) + obj
    if type(obj) in (list, tuple):
        return (_pack_uint(len(obj), 16, (0x90, None, 0xDC, 0xDD))
                + b"".join(_pack(v) for v in obj))
    if isinstance(obj, dict):
        return (_pack_uint(len(obj), 16, (0x80, None, 0xDE, 0xDF))
                + b"".join(_pack(k) + _pack(v) for k, v in obj.items()))
    if isinstance(obj, np.ndarray):
        return _pack_ext(_EXT_NDARRAY, _pack_ndarray(obj))
    if isinstance(obj, np.generic):
        return _pack_ext(_EXT_NPSCALAR, _pack_ndarray(np.asarray(obj)))
    raise TypeError(f"cannot msgpack-serialize {type(obj).__name__}")


def msgpack_serialize(tree: Dict) -> bytes:
    """Encode a nested dict of numpy arrays (or numpy scalars, Python
    scalars) as flax does: maps in the given key order,
    an ndarray as ext 1 and a numpy scalar as ext 3. The inverse of
    :func:`msgpack_restore`; ``flax.serialization.msgpack_restore`` and
    ``from_bytes`` read it. Leaves above flax's 1 GiB chunk size are
    refused (flax would split them)."""
    return _pack(tree)


def save_msgpack(path, tree: Dict) -> None:
    """Write :func:`msgpack_serialize` of ``tree`` to ``path``."""
    with open(path, "wb") as f:
        f.write(msgpack_serialize(tree))


def _is_convnext_unit(node: Dict) -> bool:
    return isinstance(node, dict) and {"conv_1", "conv_2",
                                       "conv_3"} <= set(node)


_COLLECTIONS = ("params", "batch_stats")
# the leaves of a flax BatchNorm / BiasFreeBatchNorm that live in its
# batch_stats collection
_BATCH_STATS_LEAVES = ("mean", "var", "mean_sq")


def params_from_flax(tree: Dict) -> Dict[str, torch.Tensor]:
    """Flax variables (numpy leaves: a bare ``params`` tree, or a dict of
    the ``params`` and ``batch_stats`` collections) → flat float32 torch
    state dict whose keys are the flax paths joined by ``.``, with the
    layouts of the module docstring. The collections merge into one
    dict: a BatchNorm's ``scale``/``bias`` (params) and ``mean``/``var``
    or ``mean_sq`` (batch_stats) sit on the same module. A ``quant``
    collection is skipped: :func:`attach_quant_scales` takes it."""
    if set(tree) <= {*_COLLECTIONS, "quant"} and "params" in tree:
        trees = [tree[c] for c in _COLLECTIONS if c in tree]
    else:
        trees = [tree]
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Dict, prefix: str, in_unit: bool):
        # a ConvNext unit whose convs are subtrees ({"kernel": ...}) is
        # K1's: its 1x1 kernels become matrices. A unit holding its
        # convs as leaves (unet_laplacian_v56) keeps 4-D OIHW kernels.
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
            if path in out:
                raise ValueError(f"[{path}] is in more than one collection")
            out[path] = t.contiguous()

    for t in trees:
        walk(t, "", False)
    return out


def attach_quant_scales(model: torch.nn.Module, quant: Dict) -> int:
    """Attach a flax ``quant`` collection (``quant.msgpack``:
    ``{module path...: {"<site>_scale": s}}``) to ``model`` as
    non-persistent float32 scalar buffers named ``<site>_scale`` on the
    module at that path, where ``ops/quant.conv2d`` finds them. Returns
    the number of scales; a path with no module raises."""
    n = 0

    def walk(node: Dict, path: str):
        nonlocal n
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, f"{path}.{key}" if path else key)
                continue
            if not key.endswith("_scale"):
                raise ValueError(f"unexpected quant leaf [{path}/{key}]")
            module = model.get_submodule(path)
            t = torch.from_numpy(np.array(val, np.float32))
            ref = next(model.parameters(), None)
            if ref is not None:
                t = t.to(ref.device)
            module.register_buffer(key, t, persistent=False)
            n += 1

    walk(quant, "")
    return n


def _set_path(tree: Dict, parts, value) -> None:
    for part in parts[:-1]:
        tree = tree.setdefault(part, {})
    tree[parts[-1]] = value


def flax_from_params(model: Union[torch.nn.Module, Dict[str, torch.Tensor]]
                     ) -> Dict:
    """The inverse of :func:`params_from_flax`: a model, or its state
    dict, → the flax variables tree of float32 numpy arrays,
    ``{"params": ..., "batch_stats": ...}`` (batch_stats where the model
    has BatchNorm statistics), plus ``quant`` when a module is given that
    carries int8 scales (:func:`attach_quant_scales`). OIHW kernels go
    back to HWIO and a ConvNext unit's 1×1 matrices to ``[1, 1, in,
    out]``."""
    quant = {}
    if isinstance(model, torch.nn.Module):
        state = model.state_dict()
        for name, buf in model.named_buffers():
            if name not in state and name.endswith("_scale"):
                quant[name] = buf
    else:
        state = model
    # module paths of the ConvNext units whose convs are subtrees
    units = {k.rsplit(".conv_1.", 1)[0] for k in state if ".conv_1." in k}
    tree: Dict[str, Dict] = {}
    for key, t in state.items():
        parts = key.split(".")
        a = t.detach().float().cpu().numpy()
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)                # OIHW -> HWIO
        elif (a.ndim == 2 and parts[-2:-1] in (["conv_2"], ["conv_3"])
              and ".".join(parts[:-2]) in units):
            a = a.T[None, None]                        # [out, in] -> 1x1
        collection = ("batch_stats" if parts[-1] in _BATCH_STATS_LEAVES
                      else "params")
        _set_path(tree.setdefault(collection, {}), parts,
                  np.ascontiguousarray(a))
    for name, buf in quant.items():
        _set_path(tree.setdefault("quant", {}), name.split("."),
                  np.asarray(buf.detach().float().cpu().numpy()))
    return tree
