"""Normalization layers (counterpart of
``blind_image_denoising_tpu/layers/norm.py`` and of flax's
``nn.BatchNorm``), on NCHW tensors, normalizing over C.

* :class:`FastLayerNorm`: mean and reciprocal std in float32, the
  full-resolution normalize-and-scale (and bias) in the compute dtype, as
  the JAX module does so that bf16 serving moves bf16 bytes.
* :class:`BatchNorm`: flax ``nn.BatchNorm`` with its order of
  operations: ``mul = rsqrt(var + eps)·scale`` in float32, then
  ``(x − mean)·mul (+ bias)`` in float32, cast to the compute dtype.
  Running ``mean`` / ``var`` are buffers (the artifact's
  ``batch_stats``).
* :class:`BiasFreeBatchNorm`: ``x · (scale·rsqrt(mean_sq + eps))`` with
  the multiplier cast to the compute dtype; running ``mean_sq`` buffer.

In train mode (``forward(x, train=True)``) both normalize by the batch's
statistics, float32 over N, H and W and differentiable, as flax 0.12's
``use_fast_variance``: ``var = max(0, E[x²] − E[x]²)``, the biased
estimate. Then the buffers take the running update ``ra ← m·ra +
(1 − m)·batch`` with flax's momentum m (0.995): ``mean`` and ``var``, or
``mean_sq`` alone. (``torch.nn.BatchNorm2d`` would update with the
unbiased variance and the reverse momentum, so it is not used.) Inside
:func:`frozen_statistics` the update is skipped: a rematerialized
forward runs the layer a second time and must not update it twice.
Under a data-parallel step (``parallel/mesh.batch_shard``) the batch's
statistics are the global batch's: the per-channel sums of x and x² are
``all_reduce``d over the batch axes (a differentiable reduction whose
backward reduces too), so every rank normalizes by, and updates its
buffers with, the same values. Under a spatially sharded step
(``parallel/mesh.spatial_shard``) the sums run over the slab's owned
rows and are reduced over the batch and spatial axes together.
"""

import contextlib
import contextvars

import torch
from torch import nn

from ..constants import DEFAULT_BN_EPSILON, DEFAULT_BN_MOMENTUM
from ..parallel.mesh import (all_reduce_sum, current_batch_shard,
                             current_spatial_shard)

_FROZEN = contextvars.ContextVar("bidt_frozen_batch_stats", default=False)


@contextlib.contextmanager
def frozen_statistics(frozen: bool = True):
    """Within the block, train-mode batch norms normalize by the batch's
    statistics but leave their running buffers as they are."""
    token = _FROZEN.set(bool(frozen))
    try:
        yield
    finally:
        _FROZEN.reset(token)


def _batch_moments(x: torch.Tensor):
    """float32 (E[x], E[x²]) per channel of an NCHW tensor, over N, H, W
    (of the global batch under a data-parallel step, and of the whole
    crops under a spatially sharded one)."""
    xf = x.float()
    spatial = current_spatial_shard()
    if spatial is not None:
        rows = spatial.at(x.shape[2])
        own = xf.narrow(2, rows.own_start, rows.own_rows)
        sums = all_reduce_sum(torch.stack([own.sum(dim=(0, 2, 3)),
                                           own.square().sum(dim=(0, 2, 3))]),
                              spatial.reduce_group)
        n = float(spatial.batch_count * x.shape[0] * rows.height
                  * x.shape[3])
        return sums[0] / n, sums[1] / n
    shard = current_batch_shard()
    if shard is None or shard.group is None:
        return xf.mean(dim=(0, 2, 3)), xf.square().mean(dim=(0, 2, 3))
    sums = all_reduce_sum(torch.stack([xf.sum(dim=(0, 2, 3)),
                                       xf.square().sum(dim=(0, 2, 3))]),
                          shard.group)
    n = float(shard.count * x.shape[0] * x.shape[2] * x.shape[3])
    return sums[0] / n, sums[1] / n


@torch.no_grad()
def _running_update(buffer: torch.Tensor, batch: torch.Tensor,
                    momentum: float) -> None:
    if not _FROZEN.get():
        buffer.copy_(momentum * buffer + (1.0 - momentum) * batch.detach())


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


class FastLayerNorm(nn.Module):
    """Normalizes NCHW tensors over C. ``dtype`` is the compute dtype of
    the normalize/scale step (``None``: the input's)."""

    def __init__(self, features: int, epsilon: float = 1e-6,
                 use_bias: bool = False, dtype=None):
        super().__init__()
        self.epsilon = float(epsilon)
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.dtype or x.dtype
        xf = x.float()
        mean = xf.mean(dim=1, keepdim=True)
        var = (xf - mean).square().mean(dim=1, keepdim=True)
        rsig = torch.rsqrt(var + self.epsilon)
        xhat = (x.to(cdt) - mean.to(cdt)) * rsig.to(cdt)
        y = xhat * _channel(self.scale.to(cdt))
        if self.bias is not None:
            y = y + _channel(self.bias.to(cdt))
        return y


def parse_bn_flag(value):
    """A config ``batchnorm`` / ``use_bn`` value → ``(use_bn,
    bias_free)``: booleans, or the string ``"bias_free"``."""
    if isinstance(value, str):
        key = value.strip().lower().replace("-", "_")
        if key in ("bias_free", "biasfree"):
            return True, True
        raise ValueError(
            f"unknown batchnorm mode [{value}] — use true/false or "
            f"'bias_free'")
    return bool(value), False


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm``. ``dtype`` None
    keeps flax's promotion: the output is float32 when a float32 scale or
    bias takes part; ``forward(x, dtype=...)`` names it for one call."""

    def __init__(self, features: int, epsilon: float = DEFAULT_BN_EPSILON,
                 momentum: float = DEFAULT_BN_MOMENTUM,
                 use_bias: bool = False, use_scale: bool = True, dtype=None):
        super().__init__()
        self.epsilon = float(epsilon)
        self.momentum = float(momentum)
        self.dtype = dtype
        self.scale = (nn.Parameter(torch.ones(features)) if use_scale
                      else None)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False,
                dtype=None) -> torch.Tensor:
        cdt = dtype or self.dtype
        if cdt is None:
            cdt = (torch.promote_types(x.dtype, torch.float32)
                   if self.scale is not None or self.bias is not None
                   else x.dtype)
        if train:
            mean, mean_sq = _batch_moments(x)
            var = torch.clamp(mean_sq - mean.square(), min=0.0)
            _running_update(self.mean, mean, self.momentum)
            _running_update(self.var, var, self.momentum)
        else:
            mean, var = self.mean.float(), self.var.float()
        mul = torch.rsqrt(var + self.epsilon)
        if self.scale is not None:
            mul = mul * self.scale.float()
        y = (x.float() - _channel(mean)) * _channel(mul)
        if self.bias is not None:
            y = y + _channel(self.bias.float())
        return y.to(cdt)


class BiasFreeBatchNorm(nn.Module):
    """Strictly bias-free BatchNorm: ``y = x · rsqrt(E[x²] + ε) · γ`` from
    the running second moment (the batch's in train mode); no mean
    subtraction, no β."""

    def __init__(self, features: int, epsilon: float = DEFAULT_BN_EPSILON,
                 momentum: float = DEFAULT_BN_MOMENTUM,
                 use_scale: bool = True, dtype=None):
        super().__init__()
        self.epsilon = float(epsilon)
        self.momentum = float(momentum)
        self.dtype = dtype
        self.scale = (nn.Parameter(torch.ones(features)) if use_scale
                      else None)
        self.register_buffer("mean_sq", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False,
                dtype=None) -> torch.Tensor:
        cdt = dtype or self.dtype or x.dtype
        if train:
            mean_sq = _batch_moments(x)[1]
            _running_update(self.mean_sq, mean_sq, self.momentum)
        else:
            mean_sq = self.mean_sq.float()
        mult = torch.rsqrt(mean_sq + self.epsilon)
        if self.scale is not None:
            mult = self.scale.float() * mult
        return x.to(cdt) * _channel(mult.to(cdt))
