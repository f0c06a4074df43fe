"""Selector block (counterpart of
``blind_image_denoising_tpu/layers/selector.py``): a learned mix of two
signals, ``m·input_1 + (1 − m)·input_2``, on NCHW tensors.

The mask comes from a third, selector signal: optionally a 1×1 conv to
the target channels (``selector_1x1``), global and local
normalization and the low- and high-pass filters of
``ops/normalize.py``; then by ``scale_type``

* ``LOCAL``: a SAME average pool of ``pool_size`` at strides pool // 4,
  a 1×1 compress (leaky ReLU 0.3) and expand (ReLU), resized back
  bilinearly;
* ``MULTISCALE``: the same on the pools of half, one and two
  ``pool_size`` side by side;
* ``MIXED``: the pool beside the spatial mean;
* ``GLOBAL``: the spatial mean through two dense layers, one mask per
  channel.

The expand is ≥ 0, so ``m = act(2.5 − y)`` starts biased towards
``input_1``; ``act`` is the hard sigmoid (``HARD``) or the sigmoid
(``SOFT``). Module names are flax's (``{local,multiscale,mixed}_c0`` /
``_c1``, ``global_d0`` / ``_d1``); every conv and dense carries
``kernel_regularizer`` (L1 by default), which ``regularization_loss``
sums. Under a spatially sharded train step the mask is computed on the
whole selector map (``parallel/spatial.on_whole_map``) and the slab's
rows of it mix the two signals.
"""

from enum import Enum
from typing import Tuple

import torch
from torch import nn

from ..ops.normalize import (global_normalization, highpass_filter,
                             local_normalization, lowpass_filter)
from ..ops.resize import avg_pool_same, nchw, nhwc, resize_bilinear
from ..parallel.mesh import current_spatial_shard
from ..parallel.spatial import on_whole_map, slab_rows
from .activations import hard_sigmoid
from .conv import ConvBlock, DenseBlock


class ScaleType(Enum):
    LOCAL = 0
    GLOBAL = 1
    MIXED = 2
    MULTISCALE = 3

    @staticmethod
    def from_string(s) -> "ScaleType":
        if isinstance(s, ScaleType):
            return s
        return ScaleType[s.strip().upper()]


class ActivationType(Enum):
    SOFT = 0   # sigmoid
    HARD = 1   # hard_sigmoid

    @staticmethod
    def from_string(s) -> "ActivationType":
        if isinstance(s, ActivationType):
            return s
        return ActivationType[s.strip().upper()]


_BRANCH_WIDTH = {ScaleType.LOCAL: 1, ScaleType.MULTISCALE: 3,
                 ScaleType.MIXED: 2, ScaleType.GLOBAL: 1}


class SelectorBlock(nn.Module):
    """``features``: the channels of the two mixed signals;
    ``selector_features``: the selector's."""

    def __init__(self, features: int, selector_features: int,
                 scale_type=ScaleType.LOCAL,
                 activation_type=ActivationType.HARD,
                 filters_compress_ratio: float = 0.25,
                 kernel_regularizer="l1",
                 kernel_initializer="glorot_normal",
                 pool_size: Tuple[int, int] = (32, 32),
                 use_conv1x1_selector: bool = False,
                 use_local_normalization: bool = False,
                 use_global_normalization: bool = False,
                 use_lowpass: bool = False, use_highpass: bool = False,
                 dtype=None):
        super().__init__()
        self.scale_type = ScaleType.from_string(scale_type)
        self.hard = (ActivationType.from_string(activation_type)
                     == ActivationType.HARD)
        target = int(features)
        compress = max(1, int(round(target * filters_compress_ratio)))
        self.pool = tuple(int(p) for p in pool_size)
        self.strides = (max(1, self.pool[0] // 4), max(1, self.pool[1] // 4))
        self.use_global_normalization = bool(use_global_normalization)
        self.use_local_normalization = bool(use_local_normalization)
        self.use_lowpass, self.use_highpass = bool(use_lowpass), bool(
            use_highpass)
        conv = dict(kernel_size=1, use_bias=False,
                    kernel_regularizer=kernel_regularizer,
                    kernel_initializer=kernel_initializer, dtype=dtype)
        c = int(selector_features)
        if use_conv1x1_selector:
            self.selector_1x1 = ConvBlock(c, target, **conv)
            c = target
        if self.scale_type == ScaleType.GLOBAL:
            dense = dict(kernel_regularizer=kernel_regularizer,
                         kernel_initializer=kernel_initializer, dtype=dtype)
            self.global_d0 = DenseBlock(c, compress, activation="leaky_relu",
                                        **dense)
            self.global_d1 = DenseBlock(compress, target, activation="relu",
                                        **dense)
        else:
            name = self.scale_type.name.lower()
            self.add_module(f"{name}_c0", ConvBlock(
                c * _BRANCH_WIDTH[self.scale_type], compress,
                activation="leaky_relu", **conv))
            self.add_module(f"{name}_c1", ConvBlock(
                compress, target, activation="relu", **conv))

    def _pooled(self, x: torch.Tensor) -> torch.Tensor:
        """The pooled selector signal of the spatial scale types, NHWC."""
        pool, strides = self.pool, self.strides
        if self.scale_type == ScaleType.LOCAL:
            return avg_pool_same(x, pool, strides)
        if self.scale_type == ScaleType.MULTISCALE:
            return torch.cat([
                avg_pool_same(x, (max(1, pool[0] // 2),
                                  max(1, pool[1] // 2)), strides),
                avg_pool_same(x, pool, strides),
                avg_pool_same(x, (pool[0] * 2, pool[1] * 2), strides)],
                dim=-1)
        y_local = avg_pool_same(x, pool, strides)
        y_global = torch.mean(x, dim=(1, 2), keepdim=True).expand(
            y_local.shape)
        return torch.cat([y_local, y_global], dim=-1)

    def forward(self, input_1: torch.Tensor, input_2: torch.Tensor,
                selector: torch.Tensor, train: bool = False) -> torch.Tensor:
        shard = current_spatial_shard()
        size = tuple(input_1.shape[2:]) if shard is None else (
            shard.at(input_1.shape[2]).height, input_1.shape[3])
        mask, shard = on_whole_map(self._mask, selector, size, train)
        if mask.shape[2] > 1:             # GLOBAL's mask is one per channel
            mask = slab_rows(mask, shard)
        return input_1 * mask + input_2 * (1.0 - mask)

    def _mask(self, selector: torch.Tensor, size, train: bool):
        """The mixing mask of a selector map, at ``size`` (H, W)."""
        x = selector
        if hasattr(self, "selector_1x1"):
            x = self.selector_1x1(x, train=train)
        x = nhwc(x)
        if self.use_global_normalization:
            x = global_normalization(x)
        if self.use_local_normalization:
            x = local_normalization(x, pool_size=self.pool)
        if self.use_lowpass:
            x = lowpass_filter(x, a=4.0, b=4.0)
        if self.use_highpass:
            x = highpass_filter(x, a=4.0, b=4.0)
        if self.scale_type == ScaleType.GLOBAL:
            y = self.global_d0(torch.mean(x, dim=(1, 2)), train=train)
            y = self.global_d1(y, train=train)[:, :, None, None]
        else:
            name = self.scale_type.name.lower()
            y = nchw(self._pooled(x)).contiguous(
                memory_format=torch.channels_last)
            y = getattr(self, f"{name}_c0")(y, train=train)
            y = getattr(self, f"{name}_c1")(y, train=train)
            y = nchw(resize_bilinear(nhwc(y), size))
        # y >= 0 after the relu: the mask starts biased towards input_1
        y = 2.5 - y
        return hard_sigmoid(y) if self.hard else torch.sigmoid(y)
