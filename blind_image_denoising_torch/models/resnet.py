"""ResNet and ConvNext backbones (counterpart of
``blind_image_denoising_tpu/models/resnet.py``): a base conv followed by
a stack of bias-free residual blocks (``layers/blocks.py``); the
convnext variant turns block BatchNorm off, adds a LayerNorm after each
block's first conv and an initial BatchNorm.

Config keys follow the reference schema (``block_kernels`` /
``block_filters`` / ``block_depthwise`` / ``block_groups`` /
``block_regularizer`` / ``block_activation`` …). Module names follow the
flax tree (``skeleton.base_conv``, ``skeleton.initial_bn``,
``skeleton.blocks.block_{i}_conv_{j}`` …), so the packaged
``resnet_depthwise_scratch`` artifact loads directly. A backbone returns
one scale.
"""

from typing import Any, Dict, List

import torch
from torch import nn

from ..constants import (DEFAULT_CHANNELWISE_MULTIPLIER_L1,
                         DEFAULT_MULTIPLIER_L1)
from ..layers.blocks import ResnetBlocks
from ..layers.conv import conv_block_from_params
from ..layers.multipliers import ChannelwiseMultiplier, Multiplier
from ..layers.norm import BatchNorm, BiasFreeBatchNorm, parse_bn_flag


def _block_conv_params(cfg: Dict) -> List[Dict]:
    """Per-block conv parameter tables from the config lists."""
    block_kernels = list(cfg.get("block_kernels", [3, 3]))
    block_filters = list(cfg.get("block_filters", [32, 32]))
    n = len(block_kernels)
    if not 1 <= n <= 3 or len(block_filters) != n:
        raise ValueError("block_kernels/block_filters must have matching "
                         "length in [1, 3]")

    def fill(key, default):
        v = list(cfg.get(key) or [])
        if not v:
            return [default] * n
        if len(v) != n:
            raise ValueError(
                f"{key} must have {n} entries (one per block_kernels entry), "
                f"got {len(v)}")
        return v

    kernel_regularizer = cfg.get("kernel_regularizer", "l1")
    kernel_initializer = cfg.get("kernel_initializer", "glorot_normal")
    activation = cfg.get("activation", "relu")
    use_bias = cfg.get("use_bias", False)

    block_depthwise = fill("block_depthwise", -1)
    block_groups = fill("block_groups", 1)
    block_regularizer = fill("block_regularizer", kernel_regularizer)
    block_activation = fill("block_activation", activation)

    params = []
    for i in range(n):
        p = dict(kernel_size=block_kernels[i], strides=(1, 1),
                 padding="same", use_bias=use_bias,
                 activation=block_activation[i],
                 kernel_regularizer=block_regularizer[i],
                 kernel_initializer=kernel_initializer)
        if block_depthwise[i] == -1:
            p["filters"] = block_filters[i]
            p["groups"] = block_groups[i]
        else:
            p["depth_multiplier"] = block_depthwise[i]
        params.append(p)
    # the residual block's output conforms to the base activation
    params[-1]["activation"] = cfg.get("base_activation", "linear")
    while len(params) < 3:
        params.append(None)
    return params


class _ResidualSkeleton(nn.Module):
    """Shared structure of the resnet/convnext backbones."""

    def __init__(self, config: Dict[str, Any], in_channels: int,
                 convnext_mode: bool = False, dtype=None):
        super().__init__()
        cfg = dict(config)
        use_bias = cfg.get("use_bias", False)
        use_bn, bn_bias_free = parse_bn_flag(
            cfg.get("use_bn", cfg.get("batchnorm", True)))
        base_conv_params = cfg.get("base_conv_params") or dict(
            kernel_size=cfg.get("kernel_size", 3),
            filters=cfg.get("filters", 32), strides=(1, 1), padding="same",
            use_bias=use_bias,
            activation=cfg.get("base_activation", "linear"),
            kernel_regularizer=cfg.get("kernel_regularizer", "l1"))
        conv_params = _block_conv_params(cfg)

        def bn(features):
            if bn_bias_free:
                return BiasFreeBatchNorm(features, dtype=dtype)
            return BatchNorm(features, use_bias=use_bias, dtype=dtype)

        self.base_conv = conv_block_from_params(in_channels, base_conv_params,
                                                dtype=dtype)
        c = self.base_conv.out_features
        if cfg.get("add_initial_bn", convnext_mode):
            self.initial_bn = bn(c)
        dropout_rate = cfg.get("dropout_rate", -1)
        selector_params = cfg.get("selector_params", None)
        self.blocks = ResnetBlocks(
            c, no_layers=cfg.get("no_layers", 1),
            first_conv_params=conv_params[0],
            second_conv_params=conv_params[1],
            third_conv_params=conv_params[2],
            use_bn=use_bn and not convnext_mode, bn_center=use_bias,
            bn_bias_free=bn_bias_free, ln_after_first_conv=convnext_mode,
            use_gate=cfg.get("add_gates", False),
            dropout_rate=max(0.0, dropout_rate) if dropout_rate != -1
            else 0.0,
            use_multiplier=cfg.get("add_learnable_multiplier", False),
            use_channelwise=cfg.get("add_channelwise_scaling", False),
            selector_params=(dict(selector_params)
                             if selector_params is not None else None),
            mean_sigma_pool=(11 if cfg.get("add_mean_sigma_normalization",
                                           False) else None),
            dtype=dtype)
        if cfg.get("add_final_bn", False):
            self.final_bn = bn(c)
        self.concat_input = bool(cfg.get("add_concat_input", False))
        if self.concat_input:
            c += in_channels
        if cfg.get("add_channelwise_scaling", False):
            self.final_channelwise = ChannelwiseMultiplier(
                c, multiplier=1.0, activation="relu",
                l1_coefficient=DEFAULT_CHANNELWISE_MULTIPLIER_L1)
        if cfg.get("add_learnable_multiplier", False):
            self.final_multiplier = Multiplier(
                multiplier=1.0, activation="relu",
                l1_coefficient=DEFAULT_MULTIPLIER_L1)
        self.out_features = [c]

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator = None) -> List[torch.Tensor]:
        y_input = x
        x = self.base_conv(x, train=train)
        if hasattr(self, "initial_bn"):
            x = self.initial_bn(x, train=train)
        x = self.blocks(x, train=train, generator=generator)
        if hasattr(self, "final_bn"):
            x = self.final_bn(x, train=train)
        if self.concat_input:
            dt = torch.promote_types(x.dtype, y_input.dtype)
            x = torch.cat([x.to(dt), y_input.to(dt)], dim=1)
        for name in ("final_channelwise", "final_multiplier"):
            if hasattr(self, name):
                x = getattr(self, name)(x)
        return [x]


class ResnetBackbone(nn.Module):
    """Bias-free ResNet."""

    def __init__(self, config: Dict[str, Any], in_channels: int = 3,
                 dtype=None):
        super().__init__()
        self.skeleton = _ResidualSkeleton(config, in_channels,
                                          convnext_mode=False, dtype=dtype)
        self.out_features = self.skeleton.out_features
        self.kernel_initializer = config.get("kernel_initializer",
                                             "glorot_normal")

    def forward(self, x, train: bool = False, generator=None):
        return self.skeleton(x, train=train, generator=generator)


class ConvNextBackbone(nn.Module):
    """ConvNext-flavoured residual backbone: no block BatchNorm, a
    LayerNorm after the first (depthwise) conv of each block."""

    def __init__(self, config: Dict[str, Any], in_channels: int = 3,
                 dtype=None):
        super().__init__()
        cfg = dict(config)
        cfg.setdefault("block_kernels", [7, 1, 1])
        cfg.setdefault("block_filters", [96, 384, 96])
        cfg.setdefault("block_depthwise", [1, -1, -1])
        cfg.setdefault("block_activation", ["linear", "gelu", "linear"])
        cfg.setdefault("activation", "linear")
        self.skeleton = _ResidualSkeleton(cfg, in_channels,
                                          convnext_mode=True, dtype=dtype)
        self.out_features = self.skeleton.out_features
        self.kernel_initializer = cfg.get("kernel_initializer",
                                          "glorot_normal")

    def forward(self, x, train: bool = False, generator=None):
        return self.skeleton(x, train=train, generator=generator)


# config keys the resnet/convnext skeleton understands; the builder warns
# on anything else instead of silently building a different model
KNOWN_KEYS = frozenset({
    "type", "input_shape", "value_range",
    "filters", "no_layers", "kernel_size", "activation", "base_activation",
    "use_bias", "use_bn", "batchnorm",
    "kernel_regularizer", "kernel_initializer",
    "block_kernels", "block_filters", "block_depthwise", "block_groups",
    "block_regularizer", "block_activation", "base_conv_params",
    "add_initial_bn", "add_final_bn", "add_concat_input", "add_gates",
    "add_channelwise_scaling", "add_learnable_multiplier",
    "add_mean_sigma_normalization", "selector_params", "dropout_rate",
})
