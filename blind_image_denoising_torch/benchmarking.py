"""Timing by chained applications, a byte roofline check, and the counts of
each kernel's work from its shapes: the counterpart of
``blind_image_denoising_tpu/benchmarking.py`` on the NVIDIA H100.

The method: time k chained applications of the unit under test at three
or more values of k, each ended by one read of a scalar result
(``float(result)``, which waits for the device), and take the time a
unit as the least-squares slope of wall time over k, fitted to the
per-k minima (host load only ever adds time); the slope of each repeat
gives the spread, and R² of the fit flags a nonlinearity (something
other than the steady state was timed). :func:`roofline_check` then
flags a time that claims to beat the memory system by more than
``ROOFLINE_TOLERANCE`` against the bytes one application moves
(:func:`cost_bytes`).

The counts of each kernel's work (bytes it must move, operations it must
do) and the card's peak rates are here once, for ``chip_smoke.py``'s
bounds and for the kernels' byte reports to :func:`cost_bytes`.

Imports torch and numpy only.
"""

import time
from typing import Callable, Dict, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# the NVIDIA H100 80GB HBM3 (SXM): its data sheet's HBM3 rate
H100_HBM_BYTES_PER_S = 3.35e12
# measurements above this fraction of the byte roofline are flagged
ROOFLINE_TOLERANCE = 1.10

DEFAULT_K_VALUES = (5, 15, 30)

# the card's peak rates (NVIDIA's H100 SXM data sheet, dense): bf16 on the
# tensor cores, TF32 on the tensor cores, float32 on the CUDA cores
TENSOR_BF16_OPS_PER_S = 989e12
TENSOR_TF32_OPS_PER_S = 495e12
FP32_OPS_PER_S = 67e12
# thread-instructions per second of one H100 SXM (132 SMs at the 1.98 GHz
# boost clock) per SM and clock (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0): four schedulers issue
# one warp-instruction each (128), float32 add/multiply/FMA 128, 32-bit
# integer add/multiply/logic/shift/compare 64, special functions (MUFU)
# and type conversions 16
SM_CLOCKS_PER_S = 132 * 1.98e9
SASS_RATES = dict(issue=128, float=128, integer=64, mufu_or_convert=16)


def lstsq_slope(ks: Sequence[float], ts: Sequence[float]):
    """Least-squares fit t = a + b*k -> (slope b, intercept a, R^2)."""
    k = np.asarray(ks, np.float64)
    t = np.asarray(ts, np.float64)
    b, a = np.polyfit(k, t, 1)
    pred = a + b * k
    ss_res = float(((t - pred) ** 2).sum())
    ss_tot = float(((t - t.mean()) ** 2).sum())
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0
    return float(b), float(a), r2


def time_chain_slope(make_chain: Callable[[int], Callable],
                     args: tuple,
                     k_values: Sequence[int] = DEFAULT_K_VALUES,
                     reps: int = 5) -> Dict:
    """Wall time per application of the chained program, host included,
    with its spread.

    ``make_chain(k)`` returns a callable whose result is a scalar tensor
    and whose cost is k chained applications of the unit under test;
    ``float(result)`` is the barrier (it waits for the device).

    Returns {"unit_s", "slope_spread_s", "r2", "times"}:
    * unit_s: least-squares slope over per-K minimum times;
    * slope_spread_s: [min, max] over per-repeat slopes (repeat r pairs
      its r-th sample at every K);
    * times: per-K list of all repeat times (seconds), for the record.
    """
    if len(k_values) < 3:
        raise ValueError(f"need >= 3 K values, got {k_values!r}")
    if reps < 3:
        raise ValueError(f"need >= 3 repeats, got {reps}")
    ks = sorted(int(k) for k in k_values)
    times = {}
    for k in ks:
        fn = make_chain(k)
        float(fn(*args))  # warm
        samples = []
        for _ in range(reps):
            t0 = time.perf_counter()
            float(fn(*args))  # waits for the device
            samples.append(time.perf_counter() - t0)
        times[k] = samples
    mins = [min(times[k]) for k in ks]
    slope, _, r2 = lstsq_slope(ks, mins)
    rep_slopes = [lstsq_slope(ks, [times[k][r] for k in ks])[0]
                  for r in range(reps)]
    return {
        "unit_s": slope,
        "slope_spread_s": [float(min(rep_slopes)), float(max(rep_slopes))],
        "r2": r2,
        "times": {k: [round(t, 4) for t in v] for k, v in times.items()},
    }


# the counts that cost_bytes runs are adding to (a kernel wrapper reports
# its launch's bytes to each: add_kernel_bytes)
byte_counters = []


def add_kernel_bytes(n: float) -> None:
    """A launch of one of the port's kernels moved ``n`` bytes (the
    wrappers call this while :func:`cost_bytes` runs: a launch through
    ``ctypes`` is invisible to the dispatcher)."""
    for counter in byte_counters:
        counter.total += n


def _tensor_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    return 0


class _ByteCount(TorchDispatchMode):
    """Operand and result bytes of every aten operator that runs, but
    allocations and views (they move nothing)."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        schema = func._schema
        name = schema.name.split("::")[-1]
        view = not schema.is_mutable and any(
            r.alias_info is not None for r in schema.returns)
        if not view and not name.startswith(("empty", "new_empty")):
            self.total += (_tensor_bytes(args) + _tensor_bytes(kwargs)
                           + _tensor_bytes(out))
        return out


def cost_bytes(fn: Callable, *args) -> float:
    """The bytes that one execution of ``fn(*args)`` moves as it runs:
    every aten operator's operand and result bytes (counted under a
    ``TorchDispatchMode``; allocations and views move none), plus each
    launch of one of the port's own kernels (K1, K2 and its backward, K3,
    K4), which reports its kernel's bytes (its inputs read once, its
    outputs written once; K1's general route also its scratch). Like XLA's
    "bytes accessed", the count follows the implementation: an operator
    that a fused kernel would spare is counted as it runs."""
    counter = _ByteCount()
    byte_counters.append(counter)
    try:
        with counter:
            fn(*args)
    finally:
        byte_counters.remove(counter)
    return float(counter.total)


def roofline_check(measured_unit_s: float, bytes_per_unit: float,
                   bw_bytes_per_s: float = H100_HBM_BYTES_PER_S) -> Dict:
    """Cross-check a measured per-unit time against the byte roofline.

    Returns {"roofline_unit_s", "fraction_of_roofline", "ok"}; ok=False
    means the measurement claims to beat the memory system by more than
    ``ROOFLINE_TOLERANCE``: a measurement error."""
    floor = bytes_per_unit / bw_bytes_per_s
    frac = floor / measured_unit_s if measured_unit_s > 0 else float("inf")
    return {
        "roofline_unit_s": floor,
        "fraction_of_roofline": frac,
        "ok": bool(frac <= ROOFLINE_TOLERANCE),
    }


def _elt(dtype: torch.dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


def convnext_bytes(b, h, w, c, k, dtype, e=None, general=False) -> float:
    """The bytes of one K1 unit on [B, H, W, C] x of ``dtype``: x read and
    the output written once, the depthwise weights, LayerNorm scale and
    gain (float32) and W2, W3 (bf16 in int8) read once; with ``general``
    also the general route's t [P, C] and h [P, E] (float32 in float32
    I/O, else bf16) written and read once each. E defaults to 4C."""
    e = 4 * c if e is None else e
    px = b * h * w
    elt = _elt(dtype)
    w_elt = 2 if dtype == torch.int8 else elt
    n = 2 * px * c * elt + (k * k * c + 2 * c) * 4 + 2 * e * c * w_elt
    if general:
        n += 2 * px * (c + e) * (4 if dtype == torch.float32 else 2)
    return n


def convnext_bound_ms(b, h, w, c, k, dtype, cuda_cores=False, e=None):
    """K1's least time: the larger of bytes over the memory rate and
    operations over the peak rate for their type. In bf16 and int8 the two
    products run on the tensor cores and the depthwise, LayerNorm and
    epilogue on the CUDA cores; the two units run at once, so each is a
    bound of its own and the least time is the largest of the three, not a
    sum. int8 moves 1-byte codes, keeps bf16 weights, and adds a dequantize
    and a requantize multiply per element. float32 keeps float32 accuracy
    with the products as three TF32 passes on the tensor cores (3xTF32), so
    their part is three times the products over the TF32 rate; with
    ``cuda_cores`` it is every operation on the CUDA cores instead (the
    float32 bound before the products moved to the tensor cores). Any odd
    K; E defaults to 4C. Returns (ms, "bytes" or "operations")."""
    e = 4 * c if e is None else e
    px = b * h * w
    nbytes = convnext_bytes(b, h, w, c, k, dtype, e=e)
    products = px * 4 * c * e
    other = px * (2 * k * k * c + 8 * c + e
                  + (2 * c if dtype == torch.int8 else 0))
    if dtype != torch.float32:
        ops_s = max(products / TENSOR_BF16_OPS_PER_S, other / FP32_OPS_PER_S)
    elif cuda_cores:
        ops_s = (products + other) / FP32_OPS_PER_S
    else:
        ops_s = max(3 * products / TENSOR_TF32_OPS_PER_S,
                    other / FP32_OPS_PER_S)
    byte_s = nbytes / H100_HBM_BYTES_PER_S
    return max(byte_s, ops_s) * 1e3, ("bytes" if byte_s >= ops_s
                                      else "operations")


def band_bytes(b, h, w, c, dtype, split=False) -> float:
    """The bytes of K2's forward (read x, write band and smooth) or
    backward (read g_band and g_smooth, write dx) on n = B·H·W·C elements
    of ``dtype``, 3n; of the decimating split K4 (``split``: a quarter of
    the smooth), 2.25n."""
    return (2.25 if split else 3) * b * h * w * c * _elt(dtype)


def band_bound_ms(b, h, w, c, k, dtype, backward=False, split=False):
    """K2 and K4's least time: :func:`band_bytes` over the memory rate, or
    the operations (forward: k² adds, a multiply and a subtract per
    element; backward: a subtract, a multiply and an add per tap, and the
    final add) over the float32 rate, the larger. Returns (ms, "bytes" or
    "operations")."""
    n = b * h * w * c
    byte_s = band_bytes(b, h, w, c, dtype, split=split) / H100_HBM_BYTES_PER_S
    ops_s = n * ((3 * k * k + 1) if backward else (k * k + 2)) \
        / FP32_OPS_PER_S
    return max(byte_s, ops_s) * 1e3, ("bytes" if byte_s >= ops_s
                                      else "operations")


def noise_bytes(n_per_sample, samples) -> float:
    """K3's bytes over ``samples`` samples of n float32 elements: one read
    and one write of every element."""
    return 2 * samples * n_per_sample * 4


def noise_bound_ms(n_per_sample, flags):
    """K3's least time over B samples of n float32 elements, from the work
    and not from any kernel's code: the larger of one read and one write
    of every element over the memory rate, Philox4x32-10's 40 32-bit
    multiplies (10 rounds of two 32x32 -> 64-bit products) per element of
    a sample with a noise on at the integer rate, and the four special
    functions (log, square root, sine, cosine) of each Box-Muller pair
    (one per element and noise on) at the MUFU rate. ``flags``: the
    noises on in each sample (0, 1 or 2). The units run at once, so the
    bound is the largest of the three, not their sum. Returns (ms, "bytes"
    or "operations", the three times in ms)."""
    n_on = sum(1 for f in flags if f)
    times = dict(
        bytes=noise_bytes(n_per_sample, len(flags)) / H100_HBM_BYTES_PER_S,
        integer=40 * n_on * n_per_sample
        / (SASS_RATES["integer"] * SM_CLOCKS_PER_S),
        mufu=4 * sum(flags) * n_per_sample
        / (SASS_RATES["mufu_or_convert"] * SM_CLOCKS_PER_S))
    by = max(times, key=times.get)
    return times[by] * 1e3, ("bytes" if by == "bytes" else "operations"), \
        {k: t * 1e3 for k, t in times.items()}
