"""U-Net Laplacian backbone, the flagship family (counterpart of
``blind_image_denoising_tpu/models/unet_laplacian.py``), inference only.

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

Options outside the flagship's subset raise ``NotImplementedError``
naming the ROADMAP item that ports them.
"""

from typing import Any, Dict, List

import torch
from torch import nn

from ..constants import DEFAULT_LN_EPSILON
from ..layers.activations import activation_fn
from ..layers.attention import ConvolutionalSelfAttention
from ..layers.conv import conv_block_from_params
from ..layers.convnext import ConvNextBlock
from ..layers.norm import FastLayerNorm
from ..layers.sampling import Downsample, Upsample
from ..ops.pallas_pyramid import band_smooth
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

        def level_filters(d: int) -> int:
            f = int(round(filters * max(1.0, mult ** d)))
            return min(max_filters, f) if max_filters > 0 else f

        self.filters = [level_filters(d) for d in range(depth + 1)]
        same = dict(strides=(1, 1), padding="same", use_bias=False)

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
                                        dtype=dtype))
                else:
                    self.add_module(f"{prefix}_{d}_{w}",
                                    ConvNextBlock(f, kernel, 4 * f,
                                                  activation))

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

    def _stage(self, v: torch.Tensor, prefix: str, d: int) -> torch.Tensor:
        for w in range(self.widths[d]):
            attn = getattr(self, f"{prefix}_{d}_{w}_attn", None)
            if attn is not None:
                v = v + attn(v)
            else:
                v = getattr(self, f"{prefix}_{d}_{w}")(v)  # unit adds skip
        return v

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: [B, C_in, H, W] normalized input → per-level features, finest
        first (NCHW, channels_last, the compute dtype)."""
        x = self.stem_conv(x.contiguous(memory_format=torch.channels_last))
        skips = {}
        for d in range(self.depth):
            x = self._stage(x, "encoder", d)
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
            v = self._stage(v, "decoder", d)
            if self.use_out_norm:
                v = getattr(self, f"decoder_{d}_out_ln")(v)
            decoded[d] = v
        if not self.multiple_scale_outputs:
            return [decoded[0]]
        return [decoded[d] for d in range(self.depth)]
