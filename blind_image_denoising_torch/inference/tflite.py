"""TFLite graph executor in PyTorch (counterpart of
``blind_image_denoising_tpu/inference/tflite.py``).

It loads a ``.tflite`` flatbuffer — the reference's ``denoiser_model.tflite``
(a ``[1, None, None, C]`` uint8 DenoiserModule graph) or JAX's
``serialize_tflite`` output (the hydra's finest scale, float32 NHWC) —
and runs its operators as PyTorch operations on the requested device.

Unlike JAX, which parses with TensorFlow's ``schema_py_generated``, the
port reads the flatbuffer with its own minimal reader
(:class:`_Table`, ``struct`` and numpy), so the path needs neither
TensorFlow nor ``flatbuffers``. It reads the schema tables the executor
needs (``tensorflow/lite/schema/schema.fbs``): Model, SubGraph, Tensor
and its QuantizationParameters, Buffer (inline data, or an offset into
the file), Operator, OperatorCode (the builtin code is the larger of
``builtin_code`` and ``deprecated_builtin_code``, as in JAX) and the
options tables of the operators below.

Constants: int8 weights with a quantization scale (dynamic-range
quantization, TFLite's ``Optimize.DEFAULT``) are dequantized to float32
at load, as JAX does; float constants then live on the device, integer
constants on the host. Shape arithmetic stays on the host as in JAX: an
operator whose operands are all host values (``SHAPE``'s output, the
integer constants, what is computed from them) runs in numpy, and any
other on the device in PyTorch. On the card the graph runs inside
``ops/precision.exact_float32`` (no TF32), as JAX's float32 does.

Operators (JAX's dispatch table): the binary ADD, SUB, MUL, DIV,
SQUARED_DIFFERENCE, MINIMUM, MAXIMUM, POW, FLOOR_DIV with their fused
activations; MEAN, RSQRT; the unary LOG, CEIL, ROUND (half to even),
TANH, RELU, GELU, FLOOR, EXP, SQRT, ABS, NEG; LEAKY_RELU, SOFTMAX,
BATCH_MATMUL, RESHAPE (shape tensor or ReshapeOptions), SHAPE,
TRANSPOSE, PACK, CONCATENATION, FILL, CAST, STRIDED_SLICE, SLICE, PAD,
RESIZE_BILINEAR (half-pixel centres, or the legacy TF1 grid
``src = dst · in / out`` that is the flatbuffer's default), BROADCAST_TO,
CONV_2D (grouped when its weights hold fewer input channels than x,
which JAX's executor does not take) and DEPTHWISE_CONV_2D with fused
activations (SAME padding puts the odd extra on the high side, as TF),
and the reference graph's one
``CUSTOM:FlexConv2D`` (SAME, stride 1, HWIO). Any other operator raises
``NotImplementedError`` when it runs.
"""

import logging
import struct
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.precision import exact_float32
from ..ops.resize import resize_bilinear, same_pads
from .denoiser import resolve_device

logger = logging.getLogger("blind_image_denoising_torch")

TFLITE_FILE = "denoiser_model.tflite"

# tensorflow/lite/schema/schema.fbs enums
_DTYPES = {0: np.float32, 1: np.float16, 2: np.int32, 3: np.uint8,
           4: np.int64, 6: np.bool_, 7: np.int16, 9: np.int8,
           10: np.float64}
_BUILTINS = {
    0: "ADD", 2: "CONCATENATION", 3: "CONV_2D", 4: "DEPTHWISE_CONV_2D",
    8: "FLOOR", 18: "MUL", 19: "RELU", 22: "RESHAPE",
    23: "RESIZE_BILINEAR", 25: "SOFTMAX", 28: "TANH", 32: "CUSTOM",
    34: "PAD", 39: "TRANSPOSE", 40: "MEAN", 41: "SUB", 42: "DIV",
    45: "STRIDED_SLICE", 47: "EXP", 53: "CAST", 55: "MAXIMUM",
    57: "MINIMUM", 59: "NEG", 65: "SLICE", 73: "LOG", 75: "SQRT",
    76: "RSQRT", 77: "SHAPE", 78: "POW", 83: "PACK", 90: "FLOOR_DIV",
    94: "FILL", 98: "LEAKY_RELU", 99: "SQUARED_DIFFERENCE", 101: "ABS",
    104: "CEIL", 116: "ROUND", 126: "BATCH_MATMUL", 130: "BROADCAST_TO",
    150: "GELU"}
_PAD_SAME = 0
_ACT = {0: None, 1: "relu", 2: "relu_n1_to_1", 3: "relu6", 4: "tanh"}


class _Table:
    """A flatbuffer table: field ``i``'s slot is at ``vtable + 4 + 2i``
    and holds its offset from the table's start (0: absent, the
    default)."""

    def __init__(self, buf: bytes, pos: int):
        self.buf, self.pos = buf, pos
        self.vtable = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vsize = struct.unpack_from("<H", buf, self.vtable)[0]

    def _field(self, i: int) -> int:
        slot = 4 + 2 * i
        if slot >= self.vsize:
            return 0
        off = struct.unpack_from("<H", self.buf, self.vtable + slot)[0]
        return self.pos + off if off else 0

    def scalar(self, i: int, fmt: str, default=0):
        at = self._field(i)
        return struct.unpack_from("<" + fmt, self.buf, at)[0] if at \
            else default

    def _target(self, i: int) -> int:
        at = self._field(i)
        return at + struct.unpack_from("<I", self.buf, at)[0] if at else 0

    def table(self, i: int) -> Optional["_Table"]:
        at = self._target(i)
        return _Table(self.buf, at) if at else None

    def vector(self, i: int, dtype) -> np.ndarray:
        """A vector of scalars, as a numpy array (empty when absent)."""
        at = self._target(i)
        if not at:
            return np.zeros((0,), dtype)
        n = struct.unpack_from("<I", self.buf, at)[0]
        return np.frombuffer(self.buf, dtype=np.dtype(dtype).newbyteorder(
            "<"), count=n, offset=at + 4)

    def tables(self, i: int) -> List["_Table"]:
        at = self._target(i)
        if not at:
            return []
        n = struct.unpack_from("<I", self.buf, at)[0]
        out = []
        for k in range(n):
            elem = at + 4 + 4 * k
            out.append(_Table(self.buf, elem + struct.unpack_from(
                "<I", self.buf, elem)[0]))
        return out

    def string(self, i: int) -> str:
        return bytes(self.vector(i, np.uint8)).decode()


def _conv_options(o: Optional[_Table], depthwise: bool) -> Dict[str, Any]:
    if o is None:
        raise ValueError("a TFLite convolution without its options table")
    act = 4 if depthwise else 3
    dil = 5 if depthwise else 4
    return dict(padding=o.scalar(0, "b"),
                stride=(o.scalar(2, "i"), o.scalar(1, "i")),
                dilation=(o.scalar(dil + 1, "i", 1), o.scalar(dil, "i", 1)),
                activation=_ACT.get(o.scalar(act, "b")))


def _options(name: str, o: Optional[_Table]) -> Dict[str, Any]:
    """The operator's options as JAX's parser reads them (its defaults
    where the table is absent, the schema's where a field is)."""
    if name in ("CONV_2D", "DEPTHWISE_CONV_2D"):
        return _conv_options(o, name == "DEPTHWISE_CONV_2D")
    if name in ("ADD", "SUB", "MUL", "DIV"):
        return dict(activation=_ACT.get(o.scalar(0, "b")) if o else None)
    if name == "MEAN":
        return dict(keep_dims=bool(o.scalar(0, "B")) if o else False)
    if name == "STRIDED_SLICE":
        if o.scalar(5, "B"):
            raise NotImplementedError("STRIDED_SLICE with offset=true")
        return dict(begin_mask=o.scalar(0, "i"), end_mask=o.scalar(1, "i"),
                    ellipsis_mask=o.scalar(2, "i"),
                    new_axis_mask=o.scalar(3, "i"),
                    shrink_axis_mask=o.scalar(4, "i"))
    if name == "RESIZE_BILINEAR":
        return dict(align_corners=bool(o.scalar(2, "B")),
                    half_pixel_centers=bool(o.scalar(3, "B")))
    if name == "RESHAPE":
        shape = o.vector(0, np.int32) if o is not None else []
        return dict(new_shape=[int(v) for v in shape]) if len(shape) else {}
    if name == "BATCH_MATMUL":
        return dict(adj_x=bool(o.scalar(0, "B")), adj_y=bool(o.scalar(1, "B")))
    if name == "SOFTMAX":
        return dict(beta=o.scalar(0, "f") if o else 1.0)
    if name == "LEAKY_RELU":
        return dict(alpha=o.scalar(0, "f") if o else 0.2)
    if name == "PACK":
        return dict(axis=o.scalar(1, "i") if o else 0)
    if name == "CONCATENATION":
        return dict(axis=o.scalar(0, "i") if o else 0)
    return {}


class _Op:
    __slots__ = ("name", "inputs", "outputs", "options")

    def __init__(self, name, inputs, outputs, options):
        self.name, self.inputs, self.outputs = name, inputs, outputs
        self.options = options


def _dequantize(arr: np.ndarray, q: Optional[_Table]) -> np.ndarray:
    """int8 dynamic-range weights → float32 ``(q − zero_point) · scale``
    per ``quantized_dimension``; anything else unchanged."""
    if arr.dtype != np.int8 or q is None:
        return arr
    scale = q.vector(2, np.float32).astype(np.float32)
    if not scale.size:
        return arr
    zp = q.vector(3, np.int64).astype(np.float32)
    if not zp.size:
        zp = np.zeros_like(scale)
    shape = [1] * arr.ndim
    if scale.size > 1:
        shape[q.scalar(6, "i")] = scale.size
    return (arr.astype(np.float32) - zp.reshape(shape)) * scale.reshape(shape)


def parse_tflite(data: bytes):
    """(ops, constants, input ids, output ids, tensor dtypes) of the first
    subgraph of a ``.tflite`` flatbuffer."""
    if len(data) < 8 or data[4:8] != b"TFL3":
        raise ValueError("not a TFLite flatbuffer (no TFL3 identifier)")
    model = _Table(data, struct.unpack_from("<I", data, 0)[0])
    names = []
    for oc in model.tables(1):
        code = max(oc.scalar(3, "i"), oc.scalar(0, "b"))
        name = _BUILTINS.get(code, f"UNKNOWN_{code}")
        if name == "CUSTOM":
            name = "CUSTOM:" + oc.string(1)
        names.append(name)
    buffers = model.tables(4)
    sg = model.tables(2)[0]
    constants: Dict[int, np.ndarray] = {}
    dtypes: Dict[int, Any] = {}
    for t, tensor in enumerate(sg.tables(0)):
        dtypes[t] = _DTYPES.get(tensor.scalar(1, "b"), np.float32)
        buf = buffers[tensor.scalar(2, "I")]
        raw = buf.vector(0, np.uint8)
        if not raw.size and buf.scalar(1, "Q") > 1:
            start = buf.scalar(1, "Q")
            raw = np.frombuffer(data, np.uint8, count=buf.scalar(2, "Q"),
                                offset=start)
        if not raw.size:
            continue
        shape = [int(v) for v in tensor.vector(0, np.int32)]
        arr = raw.view(dtypes[t]).reshape(shape).copy()
        arr = _dequantize(arr, tensor.table(4))
        dtypes[t] = arr.dtype.type
        constants[t] = arr
    ops = []
    for op in sg.tables(3):
        name = names[op.scalar(0, "I")]
        ops.append(_Op(name, [int(v) for v in op.vector(1, np.int32)],
                       [int(v) for v in op.vector(2, np.int32)],
                       _options(name, op.table(4))))
    return (ops, constants, [int(v) for v in sg.vector(1, np.int32)],
            [int(v) for v in sg.vector(2, np.int32)], dtypes)


def _is_host(*vals) -> bool:
    return all(isinstance(v, (np.ndarray, np.generic, int, float, bool, list))
               for v in vals)


def _host_list(v) -> list:
    """A shape-arithmetic value as a flat list of Python numbers."""
    if isinstance(v, torch.Tensor):
        return v.flatten().tolist()
    return np.asarray(v).ravel().tolist()


def _fused_activation(y, act: Optional[str]):
    if act is None:
        return y
    host = _is_host(y)
    if act == "relu":
        return np.maximum(y, 0) if host else torch.clamp(y, min=0)
    if act == "relu6":
        return np.clip(y, 0, 6) if host else torch.clamp(y, 0, 6)
    if act == "relu_n1_to_1":
        return np.clip(y, -1, 1) if host else torch.clamp(y, -1, 1)
    if act == "tanh":
        return np.tanh(y) if host else torch.tanh(y)
    raise NotImplementedError(f"fused activation {act}")


def _same_padded(x: torch.Tensor, kh: int, kw: int, stride, dilation):
    """x (NCHW) padded as TF's SAME: the odd extra on the high side."""
    ph = same_pads(x.shape[2], (kh - 1) * dilation[0] + 1, stride[0])
    pw = same_pads(x.shape[3], (kw - 1) * dilation[1] + 1, stride[1])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]))


def _conv(x, weight, bias, opts, groups: int = 1, padding=None):
    """NHWC x, OIHW weight → NHWC, with the op's padding, strides,
    dilation, bias and fused activation."""
    xc = x.permute(0, 3, 1, 2)
    stride = opts.get("stride", (1, 1))
    dilation = opts.get("dilation", (1, 1))
    if (padding if padding is not None else opts["padding"]) == _PAD_SAME:
        xc = _same_padded(xc, weight.shape[2], weight.shape[3], stride,
                          dilation)
    y = F.conv2d(xc, weight, stride=stride, dilation=dilation,
                 groups=groups).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias
    return _fused_activation(y, opts.get("activation"))


def _take(x, dim: int, sl: slice):
    """``x`` sliced along ``dim``; a torch tensor with a negative step is
    gathered, since torch slicing takes positive steps only."""
    if _is_host(x) or sl.step is None or sl.step > 0:
        return x[(slice(None),) * dim + (sl,)]
    index = torch.arange(*sl.indices(x.shape[dim]), device=x.device)
    return x.index_select(dim, index)


def _strided_slice(x, begin, end, strides, opts):
    begin, end, strides = (_host_list(v) for v in (begin, end, strides))
    if opts["ellipsis_mask"] or opts["new_axis_mask"]:
        raise NotImplementedError("ellipsis/new_axis in STRIDED_SLICE")
    shrink = []
    for d in range(len(begin)):
        if (opts["shrink_axis_mask"] >> d) & 1:
            x = _take(x, d, slice(begin[d], begin[d] + 1 or None, 1))
            shrink.append(d)
            continue
        b = None if (opts["begin_mask"] >> d) & 1 else begin[d]
        e = None if (opts["end_mask"] >> d) & 1 else end[d]
        x = _take(x, d, slice(b, e, strides[d]))
    if shrink:
        keep = [n for d, n in enumerate(x.shape) if d not in shrink]
        x = x.reshape(keep)
    return x


def _resize_bilinear(x: torch.Tensor, size, opts) -> torch.Tensor:
    out_h, out_w = (int(v) for v in _host_list(size))
    if opts.get("align_corners"):
        raise NotImplementedError("align_corners resize")
    if opts.get("half_pixel_centers"):
        # jax.image.resize's bilinear, which the port's resize mirrors
        return resize_bilinear(x, (out_h, out_w))
    # the legacy TF1 grid (half_pixel_centers false, the flatbuffer's
    # default): src = dst · in / out, gathered as JAX does
    b, h, w, c = x.shape
    ys = torch.arange(out_h, dtype=torch.float32, device=x.device) \
        * np.float32(h / out_h)
    xs = torch.arange(out_w, dtype=torch.float32, device=x.device) \
        * np.float32(w / out_w)
    y0 = torch.clamp(torch.floor(ys).long(), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).long(), 0, w - 1)
    y1, x1 = torch.clamp(y0 + 1, max=h - 1), torch.clamp(x0 + 1, max=w - 1)
    wy = (ys - y0.float()).reshape(1, out_h, 1, 1)
    wx = (xs - x0.float()).reshape(1, 1, out_w, 1)
    rows0, rows1 = x[:, y0], x[:, y1]
    top = rows0[:, :, x0] * (1 - wx) + rows0[:, :, x1] * wx
    bot = rows1[:, :, x0] * (1 - wx) + rows1[:, :, x1] * wx
    return top * (1 - wy) + bot * wy


_TORCH_DTYPES = {np.float32: torch.float32, np.float16: torch.float16,
                 np.int32: torch.int32, np.uint8: torch.uint8,
                 np.int64: torch.int64, np.bool_: torch.bool,
                 np.int16: torch.int16, np.int8: torch.int8,
                 np.float64: torch.float64}


class TFLiteExecutor:
    """Run a parsed TFLite graph with PyTorch operations on ``device``
    (default: the card)."""

    def __init__(self, path: str, device=None):
        self.device = resolve_device(device)
        with open(path, "rb") as f:
            (self._ops, constants, self._input_ids, self._output_ids,
             self._dtypes) = parse_tflite(f.read())
        # float weights on the device once; integer constants (axes,
        # shapes, paddings) stay on the host for the shape arithmetic
        self._constants = {
            t: (torch.from_numpy(a).to(self.device)
                if np.issubdtype(a.dtype, np.floating) else a)
            for t, a in constants.items()}
        logger.info(f"tflite graph: {len(self._ops)} ops, "
                    f"{len(self._constants)} constants")

    def input_dtype(self, i: int = 0):
        return self._dtypes[self._input_ids[i]]

    def __call__(self, *inputs):
        env: Dict[int, Any] = dict(self._constants)
        for tid, value in zip(self._input_ids, inputs):
            env[tid] = self._device(value)
        with torch.no_grad(), exact_float32(self.device.type == "cuda"):
            for op in self._ops:
                self._execute(op, env)
        outs = [env[t] for t in self._output_ids]
        return outs[0] if len(outs) == 1 else outs

    def _device(self, v) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v.to(self.device)
        return torch.as_tensor(np.asarray(v), device=self.device)

    def _pair(self, a, b):
        """Both operands on the device unless both are host values."""
        if _is_host(a, b):
            return a, b
        return self._device(a), self._device(b)

    # ---- op dispatch -----------------------------------------------------
    def _execute(self, op: _Op, env: Dict[int, Any]):
        def inp(i):
            t = op.inputs[i]
            return None if t == -1 else env[t]

        name, opts = op.name, op.options
        if name == "CONV_2D":
            # TFLite conv weights are OHWI, I the input channels of one
            # group (a grouped conv: fewer than x's)
            x, w = self._device(inp(0)), inp(1)
            y = _conv(x, w.permute(0, 3, 1, 2), inp(2), opts,
                      groups=x.shape[-1] // w.shape[-1])
        elif name == "DEPTHWISE_CONV_2D":
            # TFLite depthwise weights are [1, H, W, C·multiplier]
            x = self._device(inp(0))
            y = _conv(x, inp(1).permute(3, 0, 1, 2), inp(2), opts,
                      groups=x.shape[-1])
        elif name == "CUSTOM:FlexConv2D":
            # the reference graph's one Flex conv: SAME, stride 1, HWIO
            y = _conv(self._device(inp(0)), inp(1).permute(3, 2, 0, 1),
                      None, {}, padding=_PAD_SAME)
        elif name in ("ADD", "SUB", "MUL", "DIV", "SQUARED_DIFFERENCE",
                      "MINIMUM", "MAXIMUM", "POW", "FLOOR_DIV"):
            a, b = self._pair(inp(0), inp(1))
            host = _is_host(a, b)
            if name == "ADD":
                y = a + b
            elif name == "SUB":
                y = a - b
            elif name == "MUL":
                y = a * b
            elif name == "DIV":
                y = a / b
            elif name == "SQUARED_DIFFERENCE":
                y = (a - b) ** 2 if host else torch.square(a - b)
            elif name == "MINIMUM":
                y = np.minimum(a, b) if host else torch.minimum(a, b)
            elif name == "MAXIMUM":
                y = np.maximum(a, b) if host else torch.maximum(a, b)
            elif name == "POW":
                y = np.power(a, b) if host else torch.pow(a, b)
            else:
                y = a // b
            y = _fused_activation(y, opts.get("activation"))
        elif name == "MEAN":
            axes = tuple(_host_list(inp(1)))
            x = inp(0)
            y = (np.mean(x, axis=axes, keepdims=opts["keep_dims"])
                 if _is_host(x) else
                 torch.mean(x, dim=axes, keepdim=opts["keep_dims"]))
        elif name == "RSQRT":
            x = inp(0)
            y = 1.0 / np.sqrt(x) if _is_host(x) else torch.rsqrt(x)
        elif name in ("LOG", "CEIL", "ROUND", "TANH", "RELU", "GELU",
                      "FLOOR", "EXP", "SQRT", "ABS", "NEG"):
            x = inp(0)
            if name == "GELU":
                y = F.gelu(self._device(x))
            elif name == "RELU":
                y = np.maximum(x, 0) if _is_host(x) else torch.relu(x)
            else:
                # ROUND is half to even in numpy, torch and TF alike
                fn = {"LOG": "log", "CEIL": "ceil", "ROUND": "round",
                      "TANH": "tanh", "FLOOR": "floor", "EXP": "exp",
                      "SQRT": "sqrt", "ABS": "abs",
                      "NEG": "negative"}[name]
                y = getattr(np if _is_host(x) else torch, fn)(x)
        elif name == "LEAKY_RELU":
            y = F.leaky_relu(self._device(inp(0)), opts["alpha"])
        elif name == "SOFTMAX":
            y = torch.softmax(self._device(inp(0)) * opts["beta"], dim=-1)
        elif name == "BATCH_MATMUL":
            a, b = self._device(inp(0)), self._device(inp(1))
            if opts.get("adj_x"):
                a = a.transpose(-1, -2)
            if opts.get("adj_y"):
                b = b.transpose(-1, -2)
            y = torch.matmul(a, b)
        elif name == "RESHAPE":
            shape = (_host_list(inp(1))
                     if len(op.inputs) > 1 and inp(1) is not None
                     else opts.get("new_shape"))
            if shape is None:
                raise NotImplementedError(
                    "RESHAPE without a shape tensor or ReshapeOptions")
            x = inp(0)
            y = np.reshape(x, shape) if _is_host(x) else x.reshape(shape)
        elif name == "SHAPE":
            y = np.asarray(tuple(inp(0).shape), np.int32)
        elif name == "TRANSPOSE":
            perm = _host_list(inp(1))
            x = inp(0)
            y = np.transpose(x, perm) if _is_host(x) else x.permute(perm)
        elif name in ("PACK", "CONCATENATION"):
            vals = [inp(i) for i in range(len(op.inputs))]
            axis = opts.get("axis", 0)
            if _is_host(*vals):
                y = (np.stack if name == "PACK" else np.concatenate)(
                    vals, axis=axis)
            else:
                vals = [self._device(v) for v in vals]
                y = (torch.stack if name == "PACK" else torch.cat)(
                    vals, dim=axis)
        elif name == "FILL":
            shape, value = _host_list(inp(0)), inp(1)
            y = (np.full(shape, value) if _is_host(value)
                 else value.reshape(()).expand(shape).clone())
        elif name == "CAST":
            x = inp(0)
            out = self._dtypes[op.outputs[0]]
            y = x.astype(out) if _is_host(x) else x.to(_TORCH_DTYPES[out])
        elif name == "STRIDED_SLICE":
            y = _strided_slice(inp(0), inp(1), inp(2), inp(3), opts)
        elif name == "SLICE":
            begin, size = _host_list(inp(1)), _host_list(inp(2))
            y = inp(0)
            for d, (b, s) in enumerate(zip(begin, size)):
                y = _take(y, d, slice(b, None if s == -1 else b + s))
        elif name == "PAD":
            pads = np.asarray(inp(1)).tolist()
            x = inp(0)
            y = (np.pad(x, pads) if _is_host(x) else
                 F.pad(x, [p for pair in reversed(pads) for p in pair]))
        elif name == "RESIZE_BILINEAR":
            y = _resize_bilinear(self._device(inp(0)), inp(1), opts)
        elif name == "BROADCAST_TO":
            shape, x = _host_list(inp(1)), inp(0)
            y = (np.broadcast_to(x, shape) if _is_host(x)
                 else x.expand(shape))
        else:
            raise NotImplementedError(f"TFLite op [{name}] not implemented")
        env[op.outputs[0]] = y


def load_tflite_denoiser(path: str, device=None):
    """``fn(x) -> output`` over a ``.tflite`` file on ``device`` (default:
    the card): x [B, H, W, C] (uint8 or float, fed to the graph as its
    input type), the graph's own output as a numpy array. The graph pads
    to its own size contract internally."""
    executor = TFLiteExecutor(path, device=device)
    in_dtype = _TORCH_DTYPES[executor.input_dtype()]

    def fn(x):
        x = torch.as_tensor(np.asarray(x)).to(executor.device, in_dtype)
        y = executor(x)
        return y.cpu().numpy() if isinstance(y, torch.Tensor) \
            else np.asarray(y)

    return fn
