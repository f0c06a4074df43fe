"""Post-training int8 quantization (counterpart of
``blind_image_denoising_tpu/ops/quant.py``).

Quantized execution is a mode entered with :func:`quant_mode` around a
forward:

* ``"calibrate"``: the float path, and every conv site records the
  absolute max of its input into the ``stats`` dict the caller passes
  (``inference/quantize.calibrate``);
* ``"int8"``: a conv site whose module holds a ``{site}_scale`` buffer
  (loaded from ``quant.msgpack`` by ``weights.attach_quant_scales``)
  quantizes its input per tensor and its kernel per output channel,
  convolves the codes with an exact integer accumulator and rescales;
  a site without a scale keeps the float path.

Sites are named as in the JAX package: a module's flax path
('/'-joined, set by :func:`set_module_paths`) plus the site name, so the
shipped ``quant.msgpack`` keys load as they are. ``exclude`` regexes on
the module path keep matching sites in float.

JAX's rounding points are kept: ``quantize`` is ``round(x_f32 / s)``
(a division, round half to even) clipped to ±127; the weight scale is
``max(amax, 1e-12) / 127`` per output channel; the rescale multiplies the
int32 accumulator, as float32, by ``s_in·s_w`` formed in float32, then
casts to the compute dtype.

The accumulator: neither CPU nor CUDA PyTorch has an int8 convolution.
:func:`int8_conv` convolves the codes in float64 and rounds. Every
product is an integer below 2^14 and every partial sum an integer below
2^53, so any summation order is exact (and FFT or Winograd algorithms
err by far less than 0.5): the int32 result equals lax's int8 × int8 →
int32 convolution bit for bit. In JAX this is a lax convolution, not a
Pallas kernel, so the route here is a library one.
"""

import contextlib
import contextvars
import re
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from .resize import same_pads

INT8_MAX = 127.0

_MODE = contextvars.ContextVar("bidt_quant_mode", default=None)
_EXCLUDE = contextvars.ContextVar("bidt_quant_exclude", default=())
_F32_RESCALE = contextvars.ContextVar("bidt_quant_f32_rescale", default=True)
_STATS = contextvars.ContextVar("bidt_quant_stats", default=None)


@contextlib.contextmanager
def quant_mode(mode: Optional[str], exclude: Sequence[str] = (),
               f32_rescale: bool = True, stats: Optional[Dict] = None):
    """Enter a quantization mode: None, ``"calibrate"`` or ``"int8"``.

    ``exclude``: regexes matched against a site's module path; matching
    sites keep the float path. ``f32_rescale``: dequantize the int32
    accumulator through float32 (exact) or directly in the compute
    dtype. ``stats``: the dict that ``"calibrate"`` fills with
    ``{(module_path, site): amax}`` (float32 scalars on the device); in
    calibrate mode without one, nothing is recorded."""
    if mode not in (None, "calibrate", "int8"):
        raise ValueError(f"unknown quant mode [{mode}]")
    tokens = (_MODE.set(mode), _EXCLUDE.set(tuple(exclude)),
              _F32_RESCALE.set(bool(f32_rescale)), _STATS.set(stats))
    try:
        yield
    finally:
        for var, token in zip((_MODE, _EXCLUDE, _F32_RESCALE, _STATS),
                              tokens):
            var.reset(token)


def current_quant_mode(module_path: str = "") -> Optional[str]:
    """The active mode for a module at ``module_path`` (None if
    excluded)."""
    mode = _MODE.get()
    if mode is None:
        return None
    for pattern in _EXCLUDE.get():
        if re.search(pattern, module_path):
            return None
    return mode


def set_module_paths(root: nn.Module) -> None:
    """Give every submodule of ``root`` its flax path ('/'-joined
    attribute names; the root is ''), which names its conv sites."""
    for name, module in root.named_modules():
        module._quant_path = name.replace(".", "/")


def has_scales(model: nn.Module) -> bool:
    """Whether any conv site of ``model`` holds an int8 input scale."""
    return any(name.endswith("_scale") for name, _ in model.named_buffers())


def amax(x: torch.Tensor) -> torch.Tensor:
    """Scalar absolute maximum, float32."""
    return x.float().abs().max()


def quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric int8 quantization: round(x / scale) clipped to ±127.
    ``scale`` broadcasts against x (per tensor, or per output channel of
    an OIHW kernel as [O, 1, 1, 1])."""
    q = torch.round(x.float() / scale)
    return torch.clamp(q, -INT8_MAX, INT8_MAX).to(torch.int8)


def weight_scales(kernel: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Per-output-channel symmetric scales [O] of an OIHW kernel (dim 0
    is the output channel for plain, grouped and depthwise convs)."""
    a = kernel.float().abs().amax(dim=tuple(range(1, kernel.ndim)))
    return torch.clamp(a, min=eps) / INT8_MAX


def conv_nchw(x: torch.Tensor, kernel: torch.Tensor, strides,
              padding: str, groups: int) -> torch.Tensor:
    """NCHW × OIHW convolution with XLA's SAME (odd extra on the high
    side) or VALID padding, in the inputs' dtype."""
    sh, sw = strides
    if str(padding).upper() == "SAME":
        ph = same_pads(x.shape[2], kernel.shape[2], sh)
        pw = same_pads(x.shape[3], kernel.shape[3], sw)
        if ph[0] != ph[1] or pw[0] != pw[1]:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            ph, pw = (0, 0), (0, 0)
        pad = (ph[0], pw[0])
    elif str(padding).upper() == "VALID":
        pad = (0, 0)
    else:
        raise ValueError(f"unknown padding [{padding}]")
    return F.conv2d(x, kernel, stride=(sh, sw), padding=pad, groups=groups)


def int8_conv(x8: torch.Tensor, k8: torch.Tensor, strides=(1, 1),
              padding: str = "SAME", groups: int = 1) -> torch.Tensor:
    """int8 × int8 → int32 convolution of NCHW codes with OIHW codes,
    exact (module docstring). It runs inside the profiler range
    ``quant.int8_conv``, so a profile splits out the route's time."""
    with record_function("quant.int8_conv"):
        y = conv_nchw(x8.double(), k8.double(), tuple(strides), padding,
                      groups)
        return torch.round(y).to(torch.int32)


def int8_conv_reference(x8: torch.Tensor, k8: torch.Tensor, strides=(1, 1),
                        padding: str = "SAME",
                        groups: int = 1) -> torch.Tensor:
    """The same convolution in int64 arithmetic, tap by tap (the plain
    version that :func:`int8_conv`'s accumulators are held against);
    returns int64 on x8's device."""
    sh, sw = strides
    x, k = x8.to(torch.int64), k8.to(torch.int64)
    if str(padding).upper() == "SAME":
        ph = same_pads(x.shape[2], k.shape[2], sh)
        pw = same_pads(x.shape[3], k.shape[3], sw)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    b, c, h, w = x.shape
    o, cg, kh, kw = k.shape
    oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
    xg = x.view(b, groups, cg, h, w)
    kg = k.view(groups, o // groups, cg, kh, kw)
    y = torch.zeros((b, groups, o // groups, oh, ow), dtype=torch.int64,
                    device=x.device)
    for dy in range(kh):
        for dx in range(kw):
            tap = xg[..., dy:dy + (oh - 1) * sh + 1:sh,
                     dx:dx + (ow - 1) * sw + 1:sw]
            y += torch.einsum("gos,bgshw->bgohw", kg[..., dy, dx], tap)
    return y.view(b, o, oh, ow)


def conv2d(module: nn.Module, site: str, x: torch.Tensor,
           kernel: torch.Tensor, strides=(1, 1), padding: str = "SAME",
           groups: int = 1, compute_dtype=None) -> torch.Tensor:
    """NCHW × OIHW convolution with the PTQ hooks:

    * no mode: the float conv in ``compute_dtype`` (default x's);
    * ``"calibrate"``: the float conv, and the input's amax recorded
      under ``(module path, site)``;
    * ``"int8"`` with a ``{site}_scale`` buffer on ``module``: quantize,
      the exact int8 conv, rescale (module docstring).
    """
    cdt = compute_dtype or x.dtype
    strides = tuple(strides)
    path = getattr(module, "_quant_path", "")
    mode = current_quant_mode(path)
    if mode == "calibrate":
        stats = _STATS.get()
        if stats is not None:
            a = amax(x)
            key = (path, site)
            stats[key] = a if key not in stats else torch.maximum(stats[key],
                                                                  a)
    s_in = getattr(module, f"{site}_scale", None)
    if mode == "int8" and s_in is not None:
        x8 = quantize(x, s_in)
        s_w = weight_scales(kernel)
        k8 = quantize(kernel, s_w.view(-1, 1, 1, 1))
        y32 = int8_conv(x8, k8, strides, padding, groups)
        rescale = (s_in * s_w).view(1, -1, 1, 1)
        if _F32_RESCALE.get():
            return (y32.float() * rescale).to(cdt)
        return y32.to(cdt) * rescale.to(cdt)
    return conv_nchw(x.to(cdt), kernel.to(cdt), strides, padding, groups)
