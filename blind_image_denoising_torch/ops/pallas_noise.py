"""Fused training-noise corruption, K3 (counterpart of
``blind_image_denoising_tpu/ops/pallas_noise.py`` ``corrupt_batch_pallas``,
Pallas body ``_corrupt_kernel``), on when ``tpu.pallas_noise`` is set.

Per sample: with probability 0.5 multiplicative noise ``x·(1 + σz)``,
σ ~ U[mlo, mhi]; then with probability 0.5 additive noise ``+ σz``,
σ ~ U[alo, ahi]; then rounding half to even. ``z`` is a Box–Muller
normal redrawn once where it lies beyond ±2, then clipped to ±2 — the
TPU kernel's approximation of the ±2σ truncated normal
(``ops/noise.py`` draws the exact one).

CUDA kernel (``csrc/corrupt_noise.cu``): one pass over the batch, one
read and one write per element. Its random numbers come from a
Philox4x32-10 written into the kernel, keyed by the seed: every draw is a
function of (seed, sample, element index, stream) alone, so
:func:`corrupt_batch_plain` repeats the kernel's draws in PyTorch — the
kernel and its plain version agree on every sample's flags and stds and,
up to the last bits of ``logf``/``sincosf``, on every element. The
streams are not the TPU's, so the port is held to K3's distribution, not
its bits. On the H100 its least time is the bytes' (8 per element: 1.9
µs at the train step's 16×128²×3), above Philox's 40 multiplies per
element and the four special functions per Box–Muller pair
(``chip_smoke.noise_bound_ms``); in practice the ~240 instructions per
element of a sample with both noises bound it. The design against that:
each thread takes 4 consecutive elements (16-byte load and store) and
runs their four Philox chains side by side so they hide each other's
latency, derives its sample's header from warp-uniform values without a
block barrier, and a sample's elements spread over many small blocks so
the scheduler mixes samples with both noises and with none over the
SMs. It is CUDA C++ rather than Triton because Triton's ``tl.randn``
stream cannot be repeated by a plain version, and the port's other
kernels already build that way (``ops/cuda_build.py``).

``corrupt_noise`` takes an NHWC float32 batch like the JAX function. A
tensor on the CPU goes through :func:`corrupt_batch_plain`; a CUDA
tensor launches the kernel or raises. ``sample_offset`` names the
batch's first row in a larger global batch: the counter's sample word is
the global row, so a data-parallel rank holding rows ``r·b … r·b + b −
1`` draws exactly those rows of the single-process draw (the JAX kernel
under GSPMD draws over the global batch); offset 0 is the kernel as it
was, bit for bit.
"""

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from .. import benchmarking
from . import cuda_build

# kernel launches made by corrupt_noise (the plain path does not count)
launches = 0

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_TWO_PI_F32 = torch.tensor(2.0 * math.pi, dtype=torch.float32).item()


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """High and low 32 bits of the 64-bit product of the uint32 constant
    ``a`` and uint32 values ``b`` (int64 tensor), in int64 arithmetic:
    ``b`` is split into 16-bit halves so no product exceeds 2^48."""
    t = a * (b & 0xFFFF)
    s = a * (b >> 16) + (t >> 16)
    return s >> 16, ((s & 0xFFFF) << 16) | (t & 0xFFFF)


def philox4x32_10(counter: Sequence[torch.Tensor],
                  key: Tuple[int, int]) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 on int64 tensors holding uint32 values (Random123's
    round function and key schedule); returns four int64 tensors."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """23 mantissa bits → float32 in [0, 1) (the TPU kernel's rule)."""
    one = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return one - 1.0


def _box_muller(a: torch.Tensor,
                b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z0, z): the first Box–Muller normal of the words (a, b), and the
    truncated normal — z0 where |z0| <= 2, else the pair's second
    normal, clipped to ±2."""
    u1, u2 = _bits_to_uniform(a), _bits_to_uniform(b)
    r = torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-12)))
    angle = u2 * _TWO_PI_F32
    z0, z1 = r * torch.cos(angle), r * torch.sin(angle)
    return z0, torch.clamp(torch.where(z0.abs() <= 2.0, z0, z1), -2.0, 2.0)


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _ranges(additive_noise, multiplicative_noise):
    use_mul = multiplicative_noise is not None and len(multiplicative_noise) > 0
    use_add = additive_noise is not None and len(additive_noise) > 0
    mlo, mhi = ((float(min(multiplicative_noise)),
                 float(max(multiplicative_noise))) if use_mul else (0.0, 0.0))
    alo, ahi = ((float(min(additive_noise)), float(max(additive_noise)))
                if use_add else (0.0, 0.0))
    return use_mul, use_add, mlo, mhi, alo, ahi


def _check_offset(batch_size: int, sample_offset: int) -> None:
    if sample_offset < 0 or sample_offset + batch_size > _MASK32 + 1:
        raise ValueError(f"sample_offset {sample_offset} + batch "
                         f"{batch_size} must lie in [0, 2^32]")


def _rows(batch_size: int, sample_offset: int, device) -> torch.Tensor:
    """The global rows of the batch, int64 (the counter's sample word)."""
    _check_offset(batch_size, sample_offset)
    return torch.arange(sample_offset, sample_offset + batch_size,
                        dtype=torch.int64, device=device)


def sample_params_plain(seed: int, batch_size: int, mlo: float, mhi: float,
                        alo: float, ahi: float, device=None,
                        sample_offset: int = 0) -> torch.Tensor:
    """Per-sample [mul_on, mul_std, add_on, add_std], [B, 4] float32, from
    Philox stream 1 — the kernel's per-sample header — for the global
    rows ``sample_offset … sample_offset + B − 1``."""
    b = _rows(batch_size, sample_offset, device)
    zero = torch.zeros_like(b)
    w = philox4x32_10((zero, b, zero + 1, zero), (int(seed) & _MASK32, 0))
    u = [_bits_to_uniform(v) for v in w]
    lo_m, lo_a = _f32(mlo).to(device), _f32(alo).to(device)
    mul_std = lo_m + u[1] * (_f32(mhi).to(device) - lo_m)
    add_std = lo_a + u[3] * (_f32(ahi).to(device) - lo_a)
    return torch.stack([(u[0] > 0.5).float(), mul_std,
                        (u[2] > 0.5).float(), add_std], dim=1)


def normal_draws_plain(seed: int, batch_size: int, n: int,
                       device=None,
                       sample_offset: int = 0) -> Tuple[torch.Tensor, ...]:
    """Philox stream 0 for ``n`` elements of each sample (global rows from
    ``sample_offset``): the first Box–Muller draw and the truncated
    normal, for the multiplicative and the additive noise — (z0_mul,
    z_mul, z0_add, z_add), each [B, n]."""
    e = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    b = _rows(batch_size, sample_offset, device)[:, None]
    zero = torch.zeros((batch_size, n), dtype=torch.int64, device=device)
    w = philox4x32_10((zero + e, zero + b, zero, zero),
                      (int(seed) & _MASK32, 0))
    return _box_muller(w[0], w[1]) + _box_muller(w[2], w[3])


def corrupt_batch_plain(seed: int, batch: torch.Tensor,
                        additive_noise: Optional[Sequence[float]] = None,
                        multiplicative_noise: Optional[Sequence[float]] = None,
                        round_values: bool = True,
                        return_params: bool = False,
                        sample_offset: int = 0):
    """Plain PyTorch version of the kernel: the same Philox draws and the
    same float32 steps in the same order. Returns the corrupted batch, or
    (batch, [B, 4] per-sample params) with ``return_params``."""
    b = batch.shape[0]
    use_mul, use_add, mlo, mhi, alo, ahi = _ranges(additive_noise,
                                                   multiplicative_noise)
    params = sample_params_plain(seed, b, mlo, mhi, alo, ahi, batch.device,
                                 sample_offset)
    y = batch.float()
    if use_mul or use_add:
        flat = y.reshape(b, -1)
        _, z_mul, _, z_add = normal_draws_plain(seed, b, flat.shape[1],
                                                batch.device, sample_offset)
        if use_mul:
            on = params[:, 0:1] > 0
            flat = torch.where(on, flat * (1.0 + params[:, 1:2] * z_mul),
                               flat)
        if use_add:
            on = params[:, 2:3] > 0
            flat = torch.where(on, flat + params[:, 3:4] * z_add, flat)
        y = flat.reshape(batch.shape)
    if round_values:
        y = torch.round(y)
    return (y, params) if return_params else y


def corrupt_noise(seed: int, batch: torch.Tensor,
                  additive_noise: Optional[Sequence[float]] = None,
                  multiplicative_noise: Optional[Sequence[float]] = None,
                  round_values: bool = True, return_params: bool = False,
                  sample_offset: int = 0):
    """Fused corruption of a float32 [B, H, W, C] batch in [0, 255].
    ``seed``: an int in [0, 2^32) (the train step draws one per micro-batch
    on the host). With ``return_params`` also returns the per-sample
    [mul_on, mul_std, add_on, add_std], [B, 4] float32.
    ``sample_offset``: the batch's first row in the global batch."""
    global launches
    if batch.ndim != 4:
        raise ValueError(f"corrupt_noise takes [B, H, W, C], got "
                         f"{tuple(batch.shape)}")
    if batch.device.type == "cpu":
        return corrupt_batch_plain(seed, batch, additive_noise,
                                   multiplicative_noise, round_values,
                                   return_params, sample_offset)
    if batch.device.type != "cuda":
        raise ValueError(f"corrupt_noise: unsupported device {batch.device}")
    if batch.dtype != torch.float32:
        raise TypeError(f"corrupt_noise kernel takes float32, got "
                        f"{batch.dtype}")
    use_mul, use_add, mlo, mhi, alo, ahi = _ranges(additive_noise,
                                                   multiplicative_noise)
    b = batch.shape[0]
    n = batch[0].numel() if b else 0
    if n > _MASK32 or b > 65535:
        raise ValueError(f"corrupt_noise kernel takes B <= 65535 and "
                         f"H·W·C < 2^32, got {tuple(batch.shape)}")
    _check_offset(b, sample_offset)
    x = batch.contiguous()
    out = torch.empty_like(x)
    params = (torch.empty((b, 4), dtype=torch.float32, device=x.device)
              if return_params else None)
    if x.numel():
        lib = cuda_build.library()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = lib.bid_corrupt_noise(
                x.data_ptr(), out.data_ptr(),
                params.data_ptr() if params is not None else None,
                b, n, ctypes.c_uint32(int(seed) & _MASK32),
                ctypes.c_uint32(int(sample_offset)), mlo, mhi, alo, ahi,
                int(use_mul), int(use_add), int(bool(round_values)), stream)
        cuda_build.check(lib, rc, "corrupt_noise kernel")
        launches += 1
        if benchmarking.byte_counters:
            benchmarking.add_kernel_bytes(benchmarking.noise_bytes(n, b))
    return (out, params) if return_params else out
