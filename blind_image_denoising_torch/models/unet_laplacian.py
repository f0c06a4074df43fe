"""U-Net Laplacian backbone, the flagship family (counterpart of
``blind_image_denoising_tpu/models/unet_laplacian.py``), with every
option of its builder.

Per level d: a stage of ConvNext residual units (self-attention units at
the deepest level when ``use_self_attention``), the output norm
(BatchNorm then LayerNorm, each optional, when
``use_output_normalization``), the activation; then, between levels, the
Laplacian band split: the band ``x − A·x`` is the skip and the smooth
``A·x`` feeds the downsample (``layers/sampling.py``). With
``use_laplacian_averaging`` A is the count-aware SAME box mean and the
split is one call of ``ops/pallas_pyramid.band_smooth`` (K2; under
``torch.export`` the custom operator ``bidt::band_smooth`` of
``ops/export_ops.py``); without
it and with ``use_laplacian`` A is a fixed Gaussian blur
(``layers/misc.py``); with neither there is no split. The decoder walks
back up: upsample the level below, gate the skip
(``use_attention_gates``), concatenate or add it, a 1×1 mix
(``use_mix_project``), a residual stage with the decoder's kernel size,
the output norm. ``use_global_pool_information`` scales every skip by a
gain from the deepest level's global mean; ``use_complex_base`` makes
the stem a 5×5 then a 1×1 conv; ``space_to_depth_stem`` r unshuffles the
input r× and shuffles every output back. Outputs are every level's
decoded tensor, finest first.

Tensors are NCHW in ``channels_last`` memory format. Module names follow
the flax tree (``stem_conv`` or ``stem_conv_0`` / ``stem_conv_1``,
``encoder_{d}_{w}``, ``encoder_{d}_{w}_attn``, ``encoder_{d}_out_bn`` /
``_ln``, ``down_{d}``, ``gpool_conv``, ``gpool_bn`` / ``_ln``,
``gpool_proj_{d}``, ``gpool_scale_{d}``, ``up_{d}``, ``gate_{d}``,
``mix_{d}``, ``decoder_{d}_{w}``, ``decoder_{d}_out_bn`` / ``_ln``), so
``weights.params_from_flax`` loads directly.

``forward(x, train=True, generator=g)`` is the training forward: each
ConvNext unit runs its autograd path (``ConvNextBlock.branch``, with its
dropout), each residual branch passes stochastic depth at ``linspace(0,
depth_drop_rate, width)`` per level before the skip add, the attention
units apply their dropout, and every BatchNorm normalizes by the batch's
statistics; every random mask comes from the generator. The band split
is then differentiable through its backward kernel. The kernels carry
their regularizers (``kernel_regularizer``, soft-orthogonal or
-orthonormal 1×1s when the config asks, L1 on the gains); the sum is
``ops/regularizers.regularization_loss(model)``. Under a spatially
sharded train step the global pool's mean is taken on the whole map
(``parallel/spatial.on_whole_map``), as are the attention units.
"""

from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn

from ..constants import DEFAULT_LN_EPSILON
from ..layers.activations import activation_fn
from ..layers.attention import (AdditiveAttentionGate,
                                ConvolutionalSelfAttention)
from ..layers.conv import conv_block_from_params
from ..layers.convnext import ConvNextBlock
from ..layers.misc import GaussianFilter
from ..layers.multipliers import ChannelLearnableMultiplier
from ..layers.norm import BatchNorm, FastLayerNorm
from ..layers.sampling import Downsample, Upsample
from ..layers.stochastic import StochasticDepth
from ..ops.pallas_pyramid import band_smooth
from ..ops.regularizers import soft_ortho_spec
from ..ops.resize import depth_to_space, nchw, nhwc, space_to_depth
from ..parallel.spatial import on_whole_map


def _per_level(val, name: str, depth: int) -> List[int]:
    if isinstance(val, (list, tuple)):
        if len(val) != depth:
            raise ValueError(
                f"{name} must be an int or a list with one entry per level "
                f"({depth}), got {len(val)} entries")
        vals = [int(v) for v in val]
    else:
        vals = [int(val)] * depth
    if any(v < 1 for v in vals):
        raise ValueError(f"{name} entries must be >= 1")
    return vals


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


class UnetLaplacianBackbone(nn.Module):
    def __init__(self, config: Dict[str, Any], in_channels: int = 3,
                 dtype=None):
        super().__init__()
        cfg = dict(config)
        depth = int(cfg.get("depth", 5))
        if depth <= 0:
            raise ValueError("depth must be > 0")
        self.depth = depth
        self.dtype = dtype
        self.widths = _per_level(cfg.get("width", 1), "width", depth)
        filters = int(cfg.get("filters", 32))
        max_filters = int(cfg.get("max_filters", -1))
        mult = float(cfg.get("filters_level_multiplier", 2.0))
        activation = cfg.get("activation", "leaky_relu_01")
        enc_k = _per_level(cfg.get("encoder_kernel_size", 5),
                           "encoder_kernel_size", depth)
        dec_k = _per_level(cfg.get("decoder_kernel_size", 3),
                           "decoder_kernel_size", depth)
        self.gaussian_kernel = int(cfg.get("gaussian_kernel_size", 3))
        use_bn = cfg.get("use_bn", False)
        if isinstance(use_bn, str):
            raise ValueError(
                "unet_laplacian does not support string batchnorm modes "
                "('bias_free' is resnet/convnext/unet-family only; this "
                "family is LayerNorm-based)")
        use_bn = bool(use_bn)
        use_ln = bool(cfg.get("use_ln", True))
        use_bias = bool(cfg.get("use_bias", False))
        use_gamma = bool(cfg.get("use_gamma", True))
        self.use_concat = bool(cfg.get("use_concat", True))
        use_mix_project = bool(cfg.get("use_mix_project", True))
        self.use_gates = bool(cfg.get("use_attention_gates", False))
        use_complex_base = bool(cfg.get("use_complex_base", False))
        self.use_global_pool = bool(cfg.get("use_global_pool_information",
                                            False))
        # the band split: K2's box mean, a Gaussian blur, or none
        averaging = cfg.get("use_laplacian_averaging", True)
        self.split = ("average" if averaging else "gauss"
                      if cfg.get("use_laplacian", True) else None)
        self.use_attention = bool(cfg.get("use_self_attention", False))
        self.use_out_norm = bool(cfg.get("use_output_normalization", False))
        self.multiple_scale_outputs = cfg.get("multiple_scale_outputs", True)
        self.act = activation_fn(activation)
        dropout_rate = max(0.0, cfg.get("dropout_rate", -1.0))
        spatial_dropout_rate = max(0.0, cfg.get("spatial_dropout_rate", -1.0))
        soft_orthogonal = cfg.get("use_soft_orthogonal_regularization", False)
        soft_orthonormal = cfg.get("use_soft_orthonormal_regularization",
                                   False)
        if soft_orthogonal and soft_orthonormal:
            raise ValueError("soft orthogonal and orthonormal regularization "
                             "are mutually exclusive")
        kernel_regularizer = cfg.get("kernel_regularizer", "l2")
        reg_1x1 = (soft_ortho_spec(bool(soft_orthonormal))
                   if soft_orthogonal or soft_orthonormal
                   else kernel_regularizer)
        self.kernel_initializer = cfg.get("kernel_initializer",
                                          "glorot_normal")
        csa_dropout = float(cfg.get(
            "convolutional_self_attention_dropout_rate", 0.0))
        if not 0.0 <= csa_dropout <= 1.0:
            raise ValueError("convolutional_self_attention_dropout_rate must "
                             "be within [0, 1]")
        depth_drop_rate = max(0.0, float(cfg.get("depth_drop_rate", 0.0)))
        self.s2d = int(cfg.get("space_to_depth_stem", 0) or 0)
        if self.s2d == 1:
            raise ValueError("space_to_depth_stem must be 0 (off) or >= 2")

        def level_filters(d: int) -> int:
            f = int(round(filters * max(1.0, mult ** d)))
            return min(max_filters, f) if max_filters > 0 else f

        self.filters = [level_filters(d) for d in range(depth + 1)]
        # the channels of each returned scale, finest first
        self.out_features = [
            f // max(1, self.s2d) ** 2 for f in (
                self.filters[:depth] if self.multiple_scale_outputs
                else self.filters[:1])]
        if self.s2d > 1:
            for f in self.filters[:len(self.out_features)]:
                if f % (self.s2d * self.s2d):
                    raise ValueError(
                        f"space_to_depth_stem={self.s2d} needs every "
                        f"level's filters divisible by {self.s2d ** 2} to "
                        f"pixel-shuffle back (got C={f}); raise 'filters'")
        same = dict(strides=(1, 1), padding="same", use_bias=use_bias,
                    kernel_regularizer=kernel_regularizer)
        # the per-level conv tables of the JAX builder
        res_3 = [dict(same, kernel_size=1, filters=self.filters[d],
                      activation="linear") for d in range(depth)]

        c_in = in_channels * max(1, self.s2d) ** 2
        if use_complex_base:
            self.stem_conv_0 = conv_block_from_params(
                c_in, dict(same, kernel_size=(5, 5), filters=max(filters, 96),
                           activation="linear"), dtype=dtype)
            self.stem_conv_1 = conv_block_from_params(
                max(filters, 96), dict(same, kernel_size=(1, 1),
                                       filters=filters,
                                       activation=activation), dtype=dtype)
        else:
            self.stem_conv = conv_block_from_params(
                c_in, dict(same, kernel_size=(5, 5), filters=filters,
                           activation=activation), dtype=dtype)

        # per-level drop-path rates, as plain floats like the JAX module
        self.drop_rates = [
            [float(r) for r in np.linspace(0.0, depth_drop_rate,
                                           self.widths[d])]
            for d in range(depth)]

        def stage(prefix: str, d: int, kernel: int, allow_attention: bool,
                  c_in: int):
            f = self.filters[d]
            for w in range(self.widths[d]):
                attention = (allow_attention and self.use_attention
                             and d == depth - 1)
                if attention:
                    self.add_module(f"{prefix}_{d}_{w}_attn",
                                    ConvolutionalSelfAttention(
                                        c_in, filters, use_ln=use_ln,
                                        use_bn=use_bn, bn_center=use_bias,
                                        attention_activation="leaky_relu",
                                        dropout_rate=csa_dropout,
                                        kernel_regularizer=soft_ortho_spec(
                                            True),
                                        dtype=dtype))
                else:
                    self.add_module(f"{prefix}_{d}_{w}", ConvNextBlock(
                        c_in, kernel, 4 * f, activation,
                        depthwise_regularizer=kernel_regularizer,
                        pointwise_regularizer=reg_1x1, out_features=f,
                        use_bias=use_bias, use_bn=use_bn, use_ln=use_ln,
                        use_gamma=use_gamma, dropout_rate=dropout_rate,
                        spatial_dropout_rate=spatial_dropout_rate))
                # the branch keeps the channels: drop path and skip add
                if self.drop_rates[d][w] > 0.0 and (attention or c_in == f):
                    self.add_module(f"{prefix}_{d}_{w}_droppath",
                                    StochasticDepth(self.drop_rates[d][w]))
                c_in = c_in if attention else f

        def out_norm(name: str, features: int):
            if use_bn:
                self.add_module(f"{name}_bn", BatchNorm(
                    features, use_bias=use_bias, dtype=dtype))
            if use_ln:
                self.add_module(f"{name}_ln", FastLayerNorm(
                    features, epsilon=DEFAULT_LN_EPSILON, use_bias=use_bias,
                    dtype=dtype))

        for d in range(depth):
            c_in = filters if d == 0 else self.filters[d]
            stage("encoder", d, enc_k[d], True, c_in)
            if self.use_out_norm:
                out_norm(f"encoder_{d}_out", self.filters[d])
            if d != depth - 1:
                if self.split == "gauss":
                    self.add_module(f"encoder_{d}_gauss", GaussianFilter(
                        (self.gaussian_kernel, self.gaussian_kernel)))
                self.add_module(f"down_{d}", Downsample(
                    cfg.get("downsample_type", "strides"), self.filters[d],
                    dict(same, kernel_size=enc_k[d],
                         filters=self.filters[d + 1],
                         activation=activation), dtype=dtype))
        if self.use_global_pool:
            bottom = self.filters[depth - 1]
            self.gpool_conv = conv_block_from_params(
                bottom, dict(res_3[depth - 1], kernel_size=(1, 1),
                             activation=activation), dtype=dtype)
            out_norm("gpool", bottom)
            for d in range(depth - 1):
                self.add_module(f"gpool_proj_{d}", conv_block_from_params(
                    bottom, dict(res_3[d], kernel_size=(1, 1),
                                 activation="linear"), dtype=dtype))
                self.add_module(f"gpool_scale_{d}",
                                ChannelLearnableMultiplier(self.filters[d]))
        up_type = cfg.get("upsample_type", "bilinear")
        for d in range(depth - 2, -1, -1):
            up = Upsample(up_type, self.filters[d + 1],
                          dict(same, kernel_size=enc_k[d],
                               filters=self.filters[d],
                               activation=activation), dtype=dtype)
            self.add_module(f"up_{d}", up)
            c_up = (self.filters[d + 1] if up.conv is None
                    else up.conv.out_features)
            if self.use_gates:
                self.add_module(f"gate_{d}", AdditiveAttentionGate(
                    self.filters[d], c_up, self.filters[d],
                    use_bias=use_bias, use_bn=use_bn, use_ln=use_ln,
                    use_soft_orthogonal_regularization=bool(soft_orthogonal),
                    use_soft_orthonormal_regularization=bool(
                        soft_orthonormal),
                    dtype=dtype))
            c_in = self.filters[d] + c_up if self.use_concat else c_up
            if use_mix_project:
                self.add_module(f"mix_{d}", conv_block_from_params(
                    c_in, dict(res_3[d], kernel_size=(1, 1),
                               activation=activation), dtype=dtype))
                c_in = self.filters[d]
            stage("decoder", d, dec_k[d], False, c_in)
            if self.use_out_norm:
                out_norm(f"decoder_{d}_out", self.filters[d])

    def _stage(self, v: torch.Tensor, prefix: str, d: int, train: bool,
               generator) -> torch.Tensor:
        for w in range(self.widths[d]):
            attn = getattr(self, f"{prefix}_{d}_{w}_attn", None)
            unit = getattr(self, f"{prefix}_{d}_{w}", None)
            if not train and unit is not None:
                v = unit(v)                       # the unit adds the skip
                continue
            branch = (attn(v, train=train, generator=generator)
                      if attn is not None
                      else unit.branch(v, train=train, generator=generator))
            if branch.shape[1] != v.shape[1]:
                v = branch
                continue
            drop = getattr(self, f"{prefix}_{d}_{w}_droppath", None)
            if drop is not None:
                branch = drop(branch, train=train, generator=generator)
            v = v + branch
        return v

    def _out_norm(self, v: torch.Tensor, name: str,
                  train: bool) -> torch.Tensor:
        bn = getattr(self, f"{name}_bn", None)
        ln = getattr(self, f"{name}_ln", None)
        if bn is not None:
            v = bn(v, train=train)
        if ln is not None:
            v = ln(v)
        return v

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator = None) -> List[torch.Tensor]:
        """x: [B, C_in, H, W] normalized input → per-level features, finest
        first (NCHW, channels_last, the compute dtype). ``train`` selects
        the training forward, whose random masks come from
        ``generator``."""
        kw = dict(train=train, generator=generator)
        if self.s2d > 1:
            x = nchw(space_to_depth(nhwc(x), self.s2d))
        x = _channels_last(x)
        if hasattr(self, "stem_conv"):
            x = self.stem_conv(x, **kw)
        else:
            x = self.stem_conv_1(self.stem_conv_0(x, **kw), **kw)
        skips = {}
        for d in range(self.depth):
            x = self._stage(x, "encoder", d, train, generator)
            if self.use_out_norm:
                x = self._out_norm(x, f"encoder_{d}_out", train)
            x = self.act(x)
            skips[d] = x
            if d != self.depth - 1:
                if self.split == "average":
                    split = band_smooth
                    if torch.compiler.is_exporting():
                        # K2 as the exported graph's custom operator
                        from ..ops import export_ops
                        split = export_ops.band_smooth
                    band, smooth = split(nhwc(x), self.gaussian_kernel)
                    skips[d], x = nchw(band), nchw(smooth)
                elif self.split == "gauss":
                    smooth = getattr(self, f"encoder_{d}_gauss")(x)
                    skips[d], x = x - smooth, smooth
                x = getattr(self, f"down_{d}")(x, **kw)
        if self.use_global_pool:
            pooled, _ = on_whole_map(
                lambda bottom: self._out_norm(
                    bottom.mean(dim=(2, 3), keepdim=True), "gpool", train),
                self.gpool_conv(skips[self.depth - 1], **kw))
            for d in range(self.depth - 1):
                gain = getattr(self, f"gpool_scale_{d}")(
                    getattr(self, f"gpool_proj_{d}")(pooled, **kw))
                skips[d] = skips[d] * gain
        decoded = {self.depth - 1: skips[self.depth - 1]}
        for d in range(self.depth - 2, -1, -1):
            x_same = skips[d]
            x_up = getattr(self, f"up_{d}")(decoded[d + 1], **kw)
            if self.use_gates:
                x_same = getattr(self, f"gate_{d}")(x_same, x_up,
                                                    train=train)
            v = (_channels_last(torch.cat([x_same, x_up], dim=1))
                 if self.use_concat else x_same + x_up)
            mix = getattr(self, f"mix_{d}", None)
            if mix is not None:
                v = mix(v, **kw)
            v = self._stage(v, "decoder", d, train, generator)
            if self.use_out_norm:
                v = self._out_norm(v, f"decoder_{d}_out", train)
            decoded[d] = v
        outs = ([decoded[d] for d in range(self.depth)]
                if self.multiple_scale_outputs else [decoded[0]])
        if self.s2d > 1:
            outs = [_channels_last(nchw(depth_to_space(nhwc(o), self.s2d)))
                    for o in outs]
        return outs
