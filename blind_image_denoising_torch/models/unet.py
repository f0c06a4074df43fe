"""The classic U-Net backbone (counterpart of
``blind_image_denoising_tpu/models/unet.py``), on NCHW tensors.

A base conv (optional initial BatchNorm); per encoder level a
projection (from level 1 on) and a residual stack (``ResnetBlocks``,
optionally gated), then a SAME 2×2 max-pool; per decoder level, coarsest
first, a nearest 2× upsample concatenated with the level's skip as
``[up, skip]``, a projection and a residual stack; then the optional
final BatchNorm, the input concatenated, the sparse features, the
channelwise and scalar multipliers and a ``tanh`` clip. One output
scale. Module names follow the flax tree (``base_conv``,
``enc_{l}_proj``, ``enc_{l}_blocks``, ``dec_{l}_proj``,
``dec_{l}_blocks``, ``initial_bn``, ``final_bn``, ``sparse``,
``final_channelwise``, ``final_multiplier``), so
``weights.params_from_flax`` output loads directly. No hand-written
kernel runs here: JAX runs the model in XLA.
"""

from typing import Any, Dict, List

import torch
from torch import nn

from ..constants import (DEFAULT_CHANNELWISE_MULTIPLIER_L1,
                         DEFAULT_MULTIPLIER_L1)
from ..layers.blocks import ResnetBlocks
from ..layers.conv import conv_block_from_params
from ..layers.misc import SparseBlock
from ..layers.multipliers import ChannelwiseMultiplier, Multiplier
from ..layers.norm import BatchNorm, BiasFreeBatchNorm, parse_bn_flag
from ..ops.resize import max_pool_same, nchw, nhwc, upsample_2x_nearest
from .resnet import _block_conv_params


class UnetBackbone(nn.Module):
    def __init__(self, config: Dict[str, Any], in_channels: int = 3,
                 dtype=None):
        super().__init__()
        cfg = dict(config)
        use_bias = cfg.get("use_bias", False)
        use_bn, bn_bias_free = parse_bn_flag(
            cfg.get("use_bn", cfg.get("batchnorm", True)))
        self.no_levels = int(cfg.get("no_levels", 3))
        self.kernel_initializer = cfg.get("kernel_initializer",
                                          "glorot_normal")
        dropout_rate = cfg.get("dropout_rate", -1)
        base_conv_params = dict(
            kernel_size=cfg.get("kernel_size", 3),
            filters=cfg.get("filters", 32), strides=(1, 1), padding="same",
            use_bias=use_bias,
            activation=cfg.get("base_activation", "linear"),
            kernel_regularizer=cfg.get("kernel_regularizer", "l1"),
            kernel_initializer=self.kernel_initializer)
        conv_params = _block_conv_params(cfg)

        def res_stack(c):
            return ResnetBlocks(
                c, no_layers=cfg.get("no_layers", 1),
                first_conv_params=conv_params[0],
                second_conv_params=conv_params[1],
                third_conv_params=conv_params[2],
                use_bn=use_bn, bn_center=use_bias, bn_bias_free=bn_bias_free,
                use_gate=cfg.get("add_gates", False),
                dropout_rate=(max(0.0, dropout_rate) if dropout_rate != -1
                              else 0.0),
                use_multiplier=cfg.get("add_learnable_multiplier", False),
                mean_sigma_pool=(11 if cfg.get(
                    "add_mean_sigma_normalization", False) else None),
                dtype=dtype)

        def bn(c):
            if bn_bias_free:
                return BiasFreeBatchNorm(c, dtype=dtype)
            return BatchNorm(c, use_bias=use_bias, dtype=dtype)

        def proj(c):
            return conv_block_from_params(c, conv_params[0], dtype=dtype)

        self.base_conv = conv_block_from_params(in_channels, base_conv_params,
                                                dtype=dtype)
        c = self.base_conv.out_features
        if cfg.get("add_initial_bn", False):
            self.initial_bn = bn(c)
        skips = []
        for lvl in range(self.no_levels):
            if lvl > 0:
                self.add_module(f"enc_{lvl}_proj", proj(c))
                c = getattr(self, f"enc_{lvl}_proj").out_features
            self.add_module(f"enc_{lvl}_blocks", res_stack(c))
            skips.append(c)
        c = None
        for lvl in reversed(range(self.no_levels)):
            c = skips[lvl] if c is None else c + skips[lvl]
            self.add_module(f"dec_{lvl}_proj", proj(c))
            c = getattr(self, f"dec_{lvl}_proj").out_features
            self.add_module(f"dec_{lvl}_blocks", res_stack(c))
        if cfg.get("add_final_bn", False):
            self.final_bn = bn(c)
        self.concat_input = bool(cfg.get("add_concat_input", False))
        if self.concat_input:
            c += in_channels
        if cfg.get("add_sparse_features", False):
            self.sparse = SparseBlock(c, threshold_sigma=1.0,
                                      symmetrical=True)
        if cfg.get("add_channelwise_scaling", False):
            self.final_channelwise = ChannelwiseMultiplier(
                c, multiplier=1.0, activation="relu",
                l1_coefficient=DEFAULT_CHANNELWISE_MULTIPLIER_L1)
        if cfg.get("add_learnable_multiplier", False):
            self.final_multiplier = Multiplier(
                multiplier=1.0, activation="relu",
                l1_coefficient=DEFAULT_MULTIPLIER_L1)
        self.clip = bool(cfg.get("add_clip", False))
        self.out_features = [c]

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator = None) -> List[torch.Tensor]:
        y_input = x
        x = self.base_conv(x, train=train)
        if hasattr(self, "initial_bn"):
            x = self.initial_bn(x, train=train)
        levels = []
        for lvl in range(self.no_levels):
            if lvl > 0:
                x = getattr(self, f"enc_{lvl}_proj")(x, train=train)
            x = getattr(self, f"enc_{lvl}_blocks")(x, train=train,
                                                   generator=generator)
            levels.append(x)
            x = nchw(max_pool_same(nhwc(x), (2, 2), (2, 2)))
        x = None
        for lvl in reversed(range(self.no_levels)):
            skip = levels[lvl]
            if x is None:
                x = skip
            else:
                x = torch.cat([nchw(upsample_2x_nearest(nhwc(x))), skip],
                              dim=1)
            x = getattr(self, f"dec_{lvl}_proj")(x, train=train)
            x = getattr(self, f"dec_{lvl}_blocks")(x, train=train,
                                                   generator=generator)
        if hasattr(self, "final_bn"):
            x = self.final_bn(x, train=train)
        if self.concat_input:
            dt = torch.promote_types(x.dtype, y_input.dtype)
            x = torch.cat([x.to(dt), y_input.to(dt)], dim=1)
        if hasattr(self, "sparse"):
            x = self.sparse(x, train=train)
        for name in ("final_channelwise", "final_multiplier"):
            if hasattr(self, name):
                x = getattr(self, name)(x)
        if self.clip:
            x = torch.tanh(x)
        return [x]


# config keys the unet builder understands; the builder warns on anything
# else instead of silently building a different model
KNOWN_KEYS = frozenset({
    "type", "input_shape", "value_range",
    "filters", "no_layers", "no_levels", "kernel_size", "activation",
    "base_activation", "use_bias", "use_bn", "batchnorm",
    "kernel_regularizer", "kernel_initializer",
    "block_kernels", "block_filters", "block_depthwise", "block_groups",
    "block_regularizer", "block_activation",
    "add_initial_bn", "add_final_bn", "add_concat_input", "add_gates",
    "add_channelwise_scaling", "add_learnable_multiplier",
    "add_mean_sigma_normalization", "add_clip", "add_sparse_features",
    "dropout_rate",
})
