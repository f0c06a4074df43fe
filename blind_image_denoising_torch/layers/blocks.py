"""Residual block stack (counterpart of
``blind_image_denoising_tpu/layers/blocks.py`` ``ResnetBlocks``).

``no_layers`` residual blocks of up to three convs each, on NCHW
tensors. Per block: optional local mean/sigma normalization of the
branch input, conv 1, optional LayerNorm (convnext mode), conv 2, conv 3
(BatchNorm after convs 2 and 3 when ``use_bn``; also after conv 1 with
``bn_first_conv``), optional channelwise and scalar multipliers,
optional ``RandomOnOff`` drop of the whole branch (a per-sample mask, as
flax's Dropout broadcast over H, W and C), the skip add and an optional
activation. Module names follow the flax tree (``block_{i}_conv_1``,
``block_{i}_ln``, ``block_{i}_channelwise`` …), so
``weights.params_from_flax`` output loads directly.

``use_gate`` puts a :class:`DenseGate` (``block_{i}_gate``) after conv
2, fed by conv 2's output (conv 1's, or the LayerNorm's, without one).
``selector_params`` (a dict of :class:`SelectorBlock` options; ``{}``
is the selector with its defaults) replaces the skip add by
``block_{i}_selector``, which mixes the block's input and its branch by
a mask computed from conv 1's output (the LayerNorm's, in convnext
mode).
"""

from typing import Dict, Optional

import torch
from torch import nn

from ..constants import (DEFAULT_CHANNELWISE_MULTIPLIER_L1,
                         DEFAULT_LN_EPSILON, DEFAULT_MULTIPLIER_L1)
from ..ops.normalize import local_normalization
from ..ops.resize import nchw, nhwc
from ..parallel.spatial import on_whole_map
from .activations import Activation
from .conv import DenseBlock, conv_block_from_params
from .multipliers import ChannelwiseMultiplier, Multiplier
from .norm import FastLayerNorm
from .selector import SelectorBlock
from .stochastic import StochasticDepth


class DenseGate(nn.Module):
    """Channel gate (flax ``DenseGate``): the gate signal's spatial mean →
    dense to max(f/8, 2), relu → dense to f, hard sigmoid → per-channel
    multiply of ``x``. Both denses are bias-free with an L2 penalty.
    Under a spatially sharded train step the mean is the whole map's."""

    def __init__(self, in_features: int, gate_filters: int, dtype=None):
        super().__init__()
        hidden = max(int(gate_filters) // 8, 2)
        self.gate_dense_0 = DenseBlock(in_features, hidden, activation="relu",
                                       kernel_regularizer="l2", dtype=dtype)
        self.gate_dense_1 = DenseBlock(hidden, int(gate_filters),
                                       activation="hard_sigmoid",
                                       kernel_regularizer="l2", dtype=dtype)

    def forward(self, gate_signal: torch.Tensor, x: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        y, _ = on_whole_map(self._gate, gate_signal, train)
        return x * y[:, :, None, None]

    def _gate(self, gate_signal: torch.Tensor, train: bool) -> torch.Tensor:
        y = torch.mean(gate_signal, dim=(2, 3))
        return self.gate_dense_1(self.gate_dense_0(y, train=train),
                                 train=train)


def gate_filters_of(first_conv_params: Optional[Dict],
                    second_conv_params: Optional[Dict]) -> int:
    """The gated channels: conv 2's filters, or conv 1's times conv 2's
    depth multiplier."""
    if second_conv_params and "filters" in second_conv_params:
        return int(second_conv_params["filters"])
    if (second_conv_params and "depth_multiplier" in second_conv_params
            and first_conv_params):
        return int(first_conv_params["filters"]
                   * second_conv_params["depth_multiplier"])
    raise ValueError("cannot infer gate filters")


class ResnetBlocks(nn.Module):
    def __init__(self, in_features: int, no_layers: int,
                 first_conv_params: Optional[Dict] = None,
                 second_conv_params: Optional[Dict] = None,
                 third_conv_params: Optional[Dict] = None,
                 use_bn: bool = False, bn_center: bool = False,
                 bn_bias_free: bool = False, bn_first_conv: bool = False,
                 ln_after_first_conv: bool = False, use_gate: bool = False,
                 dropout_rate: float = 0.0, use_multiplier: bool = False,
                 use_channelwise: bool = False,
                 selector_params: Optional[Dict] = None,
                 post_addition_activation: Optional[str] = None,
                 mean_sigma_pool: Optional[int] = None, dtype=None):
        super().__init__()
        if no_layers < 0:
            raise ValueError("no_layers must be >= 0")
        gate_filters = (gate_filters_of(first_conv_params,
                                        second_conv_params)
                        if use_gate else 0)
        self.no_layers = int(no_layers)
        self.mean_sigma_pool = mean_sigma_pool
        bn = dict(bn_center=bn_center, bn_bias_free=bn_bias_free,
                  dtype=dtype)
        c = in_features
        for i in range(self.no_layers):
            c_in, first = c, None
            if first_conv_params is not None:
                conv = conv_block_from_params(
                    c, first_conv_params, use_bn=use_bn and bn_first_conv,
                    **bn)
                self.add_module(f"block_{i}_conv_1", conv)
                c = first = conv.out_features
            if ln_after_first_conv:
                first = c
                self.add_module(f"block_{i}_ln", FastLayerNorm(
                    c, epsilon=DEFAULT_LN_EPSILON, dtype=dtype))
            signal = c
            for j, params in ((2, second_conv_params),
                              (3, third_conv_params)):
                if params is not None:
                    conv = conv_block_from_params(c, params, use_bn=use_bn,
                                                  **bn)
                    self.add_module(f"block_{i}_conv_{j}", conv)
                    c = conv.out_features
                if j == 2:
                    signal = c
                if j == 2 and use_gate:
                    self.add_module(f"block_{i}_gate", DenseGate(
                        signal, gate_filters, dtype=dtype))
            if use_channelwise:
                self.add_module(f"block_{i}_channelwise", ChannelwiseMultiplier(
                    c, multiplier=1.0, activation="relu",
                    l1_coefficient=DEFAULT_CHANNELWISE_MULTIPLIER_L1))
            if use_multiplier:
                self.add_module(f"block_{i}_multiplier", Multiplier(
                    multiplier=1.0, activation="relu",
                    l1_coefficient=DEFAULT_MULTIPLIER_L1))
            if dropout_rate > 0.0:
                self.add_module(f"block_{i}_onoff",
                                StochasticDepth(dropout_rate))
            if c != c_in:
                raise ValueError(
                    f"residual block {i} maps {c_in} channels to {c}: the "
                    f"skip add needs the last conv to return {c_in}")
            if selector_params is not None:
                if first is None:
                    raise ValueError("selector requires a first conv output")
                self.add_module(f"block_{i}_selector", SelectorBlock(
                    c_in, first, dtype=dtype, **selector_params))
            if post_addition_activation:
                self.add_module(f"block_{i}_post_act", Activation(
                    post_addition_activation, c))
        self.out_features = c

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator = None) -> torch.Tensor:
        for i in range(self.no_layers):
            previous, x_first = x, None
            if self.mean_sigma_pool is not None:
                p = self.mean_sigma_pool
                x = nchw(local_normalization(nhwc(x), (p, p)))
            gate_signal = None
            for name in (f"block_{i}_conv_1", f"block_{i}_ln",
                         f"block_{i}_conv_2", f"block_{i}_gate",
                         f"block_{i}_conv_3"):
                layer = getattr(self, name, None)
                if layer is None:
                    continue
                if name.endswith("_ln"):
                    x = layer(x)
                elif name.endswith("_gate"):
                    if gate_signal is None:
                        raise ValueError("the gate needs a conv 1 or conv 2 "
                                         "output")
                    x = layer(gate_signal, x, train=train)
                else:
                    x = layer(x, train=train)
                if not name.endswith(("_gate", "_conv_3")):
                    gate_signal = x
                if name.endswith(("_conv_1", "_ln")):
                    x_first = x
            for name in (f"block_{i}_channelwise", f"block_{i}_multiplier"):
                layer = getattr(self, name, None)
                if layer is not None:
                    x = layer(x)
            onoff = getattr(self, f"block_{i}_onoff", None)
            if onoff is not None:
                x = onoff(x, train=train, generator=generator)
            selector = getattr(self, f"block_{i}_selector", None)
            x = (x + previous if selector is None
                 else selector(previous, x, x_first, train=train))
            post_act = getattr(self, f"block_{i}_post_act", None)
            if post_act is not None:
                x = post_act(x)
        return x
