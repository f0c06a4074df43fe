"""Hydra assembly: normalize → backbone → per-scale denoiser heads →
denormalize (counterpart of ``blind_image_denoising_tpu/models/hydra.py``).

The hydra takes a float32 NCHW image in [v0, v1] and returns one
denoised image per backbone scale, finest first, in [v0, v1]. As in the
JAX module, the heads and the denormalize run in the compute dtype; the
caller casts to float32 afterwards (``inference/denoiser.py``).
"""

from collections import namedtuple
from typing import Any, Dict, List

import torch
from torch import nn

from ..config import input_shape_fixer
from ..layers.conv import ConvBlock
from ..ops.normalize import denormalize, normalize
from .unet_laplacian import UnetLaplacianBackbone

BuilderResults = namedtuple(
    "BuilderResults",
    ["backbone", "normalizer", "denormalizer", "denoiser", "hydra", "options"])

_BACKBONES = {"unet_laplacian": UnetLaplacianBackbone}


def backbone_from_config(config: Dict, dtype=None) -> nn.Module:
    model_type = config["type"].strip().lower()
    if model_type not in _BACKBONES:
        raise NotImplementedError(
            f"backbone [{model_type}] is not ported yet (ROADMAP Queue 1 "
            f"item 9)")
    shape = config.get("input_shape") or [None, None, 3]
    return _BACKBONES[model_type](config, in_channels=int(shape[-1]),
                                  dtype=dtype)


class DenoiserHead(nn.Module):
    """1×1 conv (+activation) → 1×1 conv → tanh(2x)·0.51."""

    def __init__(self, config: Dict[str, Any], in_features: int, dtype=None):
        super().__init__()
        cfg = dict(config)
        if cfg.get("use_bn", False) or cfg.get("use_ln", False):
            raise NotImplementedError(
                "normalized denoiser heads are not ported yet (ROADMAP "
                "Queue 1 item 9)")
        filters = int(cfg.get("filters", 32))
        self.conv_0 = ConvBlock(in_features, filters, kernel_size=1,
                                activation=cfg.get("activation", "linear"),
                                use_bias=cfg.get("use_bias", False),
                                dtype=dtype)
        self.conv_1 = ConvBlock(filters, int(cfg.get("output_channels", 3)),
                                kernel_size=1,
                                use_bias=cfg.get("use_bias", False),
                                dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(2.0 * self.conv_1(self.conv_0(x))) * 0.51


class Hydra(nn.Module):
    def __init__(self, config: Dict[str, Any], dtype=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.backbone = backbone_from_config(config["backbone"], dtype=dtype)
        n_out = (self.backbone.depth
                 if self.backbone.multiple_scale_outputs else 1)
        for i in range(n_out):
            self.add_module(f"denoiser_head_{i}", DenoiserHead(
                config["denoiser"], self.backbone.filters[i], dtype=dtype))

    @property
    def value_range(self):
        vr = self.config["backbone"].get("value_range", (0, 255))
        return float(vr[0]), float(vr[1])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: [B, C, H, W] float32 in the value range → list of [B, C, h, w]
        (finest first) in the compute dtype."""
        v_min, v_max = self.value_range
        feats = self.backbone(normalize(x, v_min, v_max))
        return [denormalize(getattr(self, f"denoiser_head_{i}")(f),
                            v_min, v_max)
                for i, f in enumerate(feats)]


def model_builder(config: Dict, dtype=None) -> BuilderResults:
    """Build the hydra and its sub-model handles from a ``model`` config.
    ``dtype``: compute dtype (``torch.bfloat16``, or None for float32)."""
    backbone_cfg = dict(config["backbone"])
    backbone_cfg["input_shape"] = input_shape_fixer(
        backbone_cfg.get("input_shape", ["?", "?", 3]))
    cfg = {"backbone": backbone_cfg, "denoiser": dict(config["denoiser"])}
    hydra = Hydra(cfg, dtype=dtype)
    v_min, v_max = hydra.value_range
    return BuilderResults(
        backbone=hydra.backbone,
        normalizer=lambda x: normalize(x, v_min, v_max),
        denormalizer=lambda x: denormalize(x, v_min, v_max),
        denoiser=hydra.denoiser_head_0,
        hydra=hydra,
        options={},
    )
