"""U-Net Laplacian backbone, the flagship family (counterpart of
``blind_image_denoising_tpu/models/unet_laplacian.py``).

Per level d: a stage of ConvNext residual units (self-attention units at
the deepest level when ``use_self_attention``), the output LayerNorm,
the activation; then, between levels, the Laplacian band split: the
band ``x − A·x`` is the skip and the smooth ``A·x`` feeds a 2×2 stride-2
conv. The band split is one call of ``ops/pallas_pyramid.band_smooth``.
The decoder walks back up: nearest 2× + 3×3 conv, add the skip, a
residual stage, the output LayerNorm. Outputs are every level's decoded
tensor, finest first.

Tensors are NCHW in ``channels_last`` memory format. Module names follow
the flax tree (``stem_conv``, ``encoder_{d}_{w}``, ``encoder_{d}_{w}_attn``,
``encoder_{d}_out_ln``, ``down_{d}``, ``up_{d}``, ``decoder_{d}_{w}``,
``decoder_{d}_out_ln``), so ``weights.params_from_flax`` loads directly.

``forward(x, train=True, generator=g)`` is the training forward: each
ConvNext unit runs its autograd path (``ConvNextBlock.branch``), each
residual branch passes stochastic depth at ``linspace(0,
depth_drop_rate, width)`` per level before the skip add, and the
attention units apply their dropout; every random mask comes from the
generator. The band split is then differentiable through its backward
kernel. The kernels carry their regularizers (``kernel_regularizer``,
soft-orthonormal 1×1s when the config asks, L1 on the gains); the sum is
``ops/regularizers.regularization_loss(model)``.

Options outside the flagship's subset raise ``NotImplementedError``
naming the ROADMAP item that ports them.
"""

from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn

from ..constants import DEFAULT_LN_EPSILON
from ..layers.activations import activation_fn
from ..layers.attention import ConvolutionalSelfAttention
from ..layers.conv import conv_block_from_params
from ..layers.convnext import ConvNextBlock
from ..layers.norm import FastLayerNorm
from ..layers.sampling import Downsample, Upsample
from ..layers.stochastic import StochasticDepth
from ..ops.pallas_pyramid import band_smooth
from ..ops.regularizers import soft_ortho_spec
from ..ops.resize import nchw, nhwc

# options whose non-default value is not ported: key -> the value the
# port supports
_FIXED_OPTIONS = {
    "use_bn": False, "use_ln": True, "use_bias": False, "use_gamma": True,
    "use_concat": False, "use_mix_project": False,
    "use_attention_gates": False, "use_complex_base": False,
    "use_global_pool_information": False,
    "space_to_depth_stem": 0,
}
_DEFAULTS = {"use_ln": True, "use_gamma": True, "use_concat": True,
             "use_mix_project": True}


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


class UnetLaplacianBackbone(nn.Module):
    def __init__(self, config: Dict[str, Any], in_channels: int = 3,
                 dtype=None):
        super().__init__()
        cfg = dict(config)
        for key, supported in _FIXED_OPTIONS.items():
            value = cfg.get(key, _DEFAULTS.get(key, supported))
            if (value or 0) != (supported or 0):
                raise NotImplementedError(
                    f"unet_laplacian option {key}={value!r} is not ported "
                    f"yet (ROADMAP Queue 1 item 9)")
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
        use_laplacian = cfg.get("use_laplacian", True)
        averaging = cfg.get("use_laplacian_averaging", True)
        if use_laplacian and not averaging:
            raise NotImplementedError(
                "the Gaussian-filter band split is not ported yet (ROADMAP "
                "Queue 1 item 11)")
        self.band_split = bool(averaging)
        self.use_attention = bool(cfg.get("use_self_attention", False))
        self.use_out_norm = bool(cfg.get("use_output_normalization", False))
        self.multiple_scale_outputs = cfg.get("multiple_scale_outputs", True)
        self.act = activation_fn(activation)
        if max(0.0, cfg.get("dropout_rate", -1.0)) > 0.0 or \
                max(0.0, cfg.get("spatial_dropout_rate", -1.0)) > 0.0:
            raise NotImplementedError(
                "dropout inside the ConvNext units is not ported yet "
                "(ROADMAP Queue 1 item 9)")
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
        depth_drop_rate = max(0.0, float(cfg.get("depth_drop_rate", 0.0)))

        def level_filters(d: int) -> int:
            f = int(round(filters * max(1.0, mult ** d)))
            return min(max_filters, f) if max_filters > 0 else f

        self.filters = [level_filters(d) for d in range(depth + 1)]
        # the channels of each returned scale, finest first
        self.out_features = (self.filters[:depth]
                             if self.multiple_scale_outputs
                             else self.filters[:1])
        same = dict(strides=(1, 1), padding="same", use_bias=False,
                    kernel_regularizer=kernel_regularizer)

        self.stem_conv = conv_block_from_params(
            in_channels, dict(same, kernel_size=(5, 5), filters=filters,
                              activation=activation), dtype=dtype)

        def stage(prefix: str, d: int, kernel: int, allow_attention: bool):
            f = self.filters[d]
            for w in range(self.widths[d]):
                if allow_attention and self.use_attention and d == depth - 1:
                    self.add_module(f"{prefix}_{d}_{w}_attn",
                                    ConvolutionalSelfAttention(
                                        f, filters, use_ln=True,
                                        attention_activation="leaky_relu",
                                        dropout_rate=csa_dropout,
                                        kernel_regularizer=soft_ortho_spec(
                                            True),
                                        dtype=dtype))
                else:
                    self.add_module(f"{prefix}_{d}_{w}",
                                    ConvNextBlock(
                                        f, kernel, 4 * f, activation,
                                        depthwise_regularizer=(
                                            kernel_regularizer),
                                        pointwise_regularizer=reg_1x1))
                rate = self.drop_rates[d][w]
                if rate > 0.0:
                    self.add_module(f"{prefix}_{d}_{w}_droppath",
                                    StochasticDepth(rate))

        # per-level drop-path rates, as plain floats like the JAX module
        self.drop_rates = [
            [float(r) for r in np.linspace(0.0, depth_drop_rate,
                                           self.widths[d])]
            for d in range(depth)]

        def out_ln(name: str, d: int):
            if self.use_out_norm:
                self.add_module(name, FastLayerNorm(
                    self.filters[d], epsilon=DEFAULT_LN_EPSILON, dtype=dtype))

        for d in range(depth):
            stage("encoder", d, enc_k[d], allow_attention=True)
            out_ln(f"encoder_{d}_out_ln", d)
            if d != depth - 1:
                self.add_module(f"down_{d}", Downsample(
                    cfg.get("downsample_type", "strides"), self.filters[d],
                    dict(same, kernel_size=enc_k[d],
                         filters=self.filters[d + 1],
                         activation=activation), dtype=dtype))
        for d in range(depth - 2, -1, -1):
            self.add_module(f"up_{d}", Upsample(
                cfg.get("upsample_type", "bilinear"), self.filters[d + 1],
                dict(same, kernel_size=enc_k[d], filters=self.filters[d],
                     activation=activation), dtype=dtype))
            stage("decoder", d, dec_k[d], allow_attention=False)
            out_ln(f"decoder_{d}_out_ln", d)

    def _stage(self, v: torch.Tensor, prefix: str, d: int, train: bool,
               generator) -> torch.Tensor:
        for w in range(self.widths[d]):
            attn = getattr(self, f"{prefix}_{d}_{w}_attn", None)
            unit = getattr(self, f"{prefix}_{d}_{w}", None)
            if not train and unit is not None:
                v = unit(v)                       # the unit adds the skip
                continue
            branch = (attn(v, train=train, generator=generator)
                      if attn is not None else unit.branch(v))
            drop = getattr(self, f"{prefix}_{d}_{w}_droppath", None)
            if drop is not None:
                branch = drop(branch, train=train, generator=generator)
            v = v + branch
        return v

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator = None) -> List[torch.Tensor]:
        """x: [B, C_in, H, W] normalized input → per-level features, finest
        first (NCHW, channels_last, the compute dtype). ``train`` selects
        the training forward, whose random masks come from
        ``generator``."""
        x = self.stem_conv(x.contiguous(memory_format=torch.channels_last))
        skips = {}
        for d in range(self.depth):
            x = self._stage(x, "encoder", d, train, generator)
            if self.use_out_norm:
                x = getattr(self, f"encoder_{d}_out_ln")(x)
            x = self.act(x)
            skips[d] = x
            if d != self.depth - 1:
                if self.band_split:
                    band, smooth = band_smooth(nhwc(x), self.gaussian_kernel)
                    skips[d], x = nchw(band), nchw(smooth)
                x = getattr(self, f"down_{d}")(x)
        decoded = {self.depth - 1: skips[self.depth - 1]}
        for d in range(self.depth - 2, -1, -1):
            v = skips[d] + getattr(self, f"up_{d}")(decoded[d + 1])
            v = self._stage(v, "decoder", d, train, generator)
            if self.use_out_norm:
                v = getattr(self, f"decoder_{d}_out_ln")(v)
            decoded[d] = v
        if not self.multiple_scale_outputs:
            return [decoded[0]]
        return [decoded[d] for d in range(self.depth)]
