"""Noise corruption and flips for training, in plain PyTorch (counterpart
of ``blind_image_denoising_tpu/ops/noise.py``). NHWC float32 batches in
[0, 255].

Every draw comes from the ``torch.Generator`` the caller passes, on the
batch's device: per sample, a flag with probability 0.5 and a std
(``draw_stds``: U[lo, hi], or log-uniform) for the multiplicative noise,
then the same for the additive noise. The noise is the exact ±2σ
truncated normal (``tf.random.truncated_normal``), drawn by inverting
the normal CDF on a uniform restricted to [Φ(−2), Φ(2)], as
``jax.random.truncated_normal`` does. This is the corruption when ``tpu.pallas_noise`` is off, and the
yardstick the noise kernel (``ops/pallas_noise.py``, which redraws once
and clips) is held against by its statistics.

Every per-sample draw goes through :func:`batch_rand`: under a
data-parallel step (``parallel/mesh.batch_shard``) it draws for the
global batch and keeps this rank's rows, so each rank's samples get the
draws they get in the single-process step on the global batch.
"""

import math
from typing import Optional, Sequence, Tuple

import torch

from ..parallel.mesh import current_batch_shard


def batch_rand(shape: Tuple[int, ...], generator: torch.Generator,
               device=None, dtype=torch.float32) -> torch.Tensor:
    """``torch.rand(shape)`` whose dim 0 is the batch. Under a
    data-parallel step with this rank at position ``i`` of ``n`` it is
    rows ``i·b … i·b + b − 1`` of the draw of ``(n·b,) + shape[1:]``."""
    shard = current_batch_shard()
    if shard is None or shard.count == 1:
        return torch.rand(shape, generator=generator, device=device,
                          dtype=dtype)
    b = shape[0]
    full = torch.rand((shard.count * b,) + tuple(shape[1:]),
                      generator=generator, device=device, dtype=dtype)
    return full[shard.index * b:(shard.index + 1) * b]


def truncated_normal(shape: Tuple[int, ...], generator: torch.Generator,
                     device=None, dtype=torch.float32) -> torch.Tensor:
    """Standard normal truncated to [−2, 2]."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = batch_rand(tuple(shape), generator, device, dtype)
    z = math.sqrt(2.0) * torch.erfinv(lo + u * (hi - lo))
    return torch.clamp(z, -2.0, 2.0)


def draw_stds(generator: torch.Generator, b: int, lo: float, hi: float,
              sampling: str = "uniform", device=None) -> torch.Tensor:
    """Per-sample noise stds, [b, 1, 1, 1]. ``uniform``: σ ~ U[lo, hi].
    ``log_uniform``: σ = exp(U[log lo, log hi]) with lo floored at 1e-3,
    equal mass per octave."""
    if sampling == "uniform":
        return lo + (hi - lo) * batch_rand((b, 1, 1, 1), generator, device)
    if sampling == "log_uniform":
        lo = max(float(lo), 1e-3)
        hi = max(float(hi), lo)
        u = batch_rand((b, 1, 1, 1), generator, device)
        return torch.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * u)
    raise ValueError(f"unknown noise_sampling [{sampling}] "
                     f"(expected 'uniform' or 'log_uniform')")


def corrupt_batch(generator: torch.Generator, batch: torch.Tensor,
                  additive_noise: Optional[Sequence[float]] = None,
                  multiplicative_noise: Optional[Sequence[float]] = None,
                  round_values: bool = True,
                  noise_sampling: str = "uniform") -> torch.Tensor:
    """Per-sample corruption of a float32 [B, H, W, C] batch: with
    probability 0.5 multiplicative noise ``x·(1 + σz)``, σ from
    ``draw_stds`` on [mlo, mhi]; then with probability 0.5 additive noise
    ``+ σz``, σ on [alo, ahi]; then optional rounding."""
    b, dev = batch.shape[0], batch.device
    noisy = batch
    for rng, multiplicative in ((multiplicative_noise, True),
                                (additive_noise, False)):
        if rng is None or len(rng) == 0:
            continue
        lo, hi = float(min(rng)), float(max(rng))
        flags = batch_rand((b, 1, 1, 1), generator, dev) > 0.5
        stds = draw_stds(generator, b, lo, hi, noise_sampling, dev)
        z = truncated_normal(batch.shape, generator, device=dev)
        noisy = torch.where(flags, noisy * (1.0 + stds * z) if multiplicative
                            else noisy + stds * z, noisy)
    if round_values:
        noisy = torch.round(noisy)
    return noisy


def corrupt_batch_fixed_std(generator: torch.Generator, batch: torch.Tensor,
                            std: float,
                            round_values: bool = True) -> torch.Tensor:
    """Additive ±2σ truncated-normal noise at a fixed std, then optional
    rounding: the evaluation sweep's corruption (``evaluate.py``,
    ``inference/blend.calibrate_blend``)."""
    noisy = batch + float(std) * truncated_normal(
        tuple(batch.shape), generator, device=batch.device)
    if round_values:
        noisy = torch.round(noisy)
    return noisy


def random_flips(generator: torch.Generator, batch: torch.Tensor,
                 left_right: bool = True,
                 up_down: bool = True) -> torch.Tensor:
    """Per-sample random horizontal and vertical flips of [B, H, W, C]."""
    b = batch.shape[0]
    out = batch
    for on, axis in ((left_right, 2), (up_down, 1)):
        if on:
            flags = batch_rand((b, 1, 1, 1), generator, batch.device) > 0.5
            out = torch.where(flags, out.flip(axis), out)
    return out
