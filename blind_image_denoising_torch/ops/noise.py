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
"""

import math
from typing import Optional, Sequence, Tuple

import torch


def truncated_normal(shape: Tuple[int, ...], generator: torch.Generator,
                     device=None, dtype=torch.float32) -> torch.Tensor:
    """Standard normal truncated to [−2, 2]."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    z = math.sqrt(2.0) * torch.erfinv(lo + u * (hi - lo))
    return torch.clamp(z, -2.0, 2.0)


def draw_stds(generator: torch.Generator, b: int, lo: float, hi: float,
              sampling: str = "uniform", device=None) -> torch.Tensor:
    """Per-sample noise stds, [b, 1, 1, 1]. ``uniform``: σ ~ U[lo, hi].
    ``log_uniform``: σ = exp(U[log lo, log hi]) with lo floored at 1e-3,
    equal mass per octave."""
    if sampling == "uniform":
        return lo + (hi - lo) * torch.rand((b, 1, 1, 1), generator=generator,
                                           device=device)
    if sampling == "log_uniform":
        lo = max(float(lo), 1e-3)
        hi = max(float(hi), lo)
        u = torch.rand((b, 1, 1, 1), generator=generator, device=device)
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
        flags = torch.rand((b, 1, 1, 1), generator=generator,
                           device=dev) > 0.5
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
            flags = torch.rand((b, 1, 1, 1), generator=generator,
                               device=batch.device) > 0.5
            out = torch.where(flags, out.flip(axis), out)
    return out
