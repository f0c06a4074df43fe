"""Hydra assembly: normalize → backbone → per-scale denoiser heads →
denormalize (counterpart of ``blind_image_denoising_tpu/models/hydra.py``).

The hydra takes a float32 NCHW image in [v0, v1] and returns one
denoised image per backbone scale, finest first, in [v0, v1], float32.
The heads' convs run in the compute dtype; their ``tanh(2x)·0.51``
epilogue and the denormalize run in float32. In the JAX module they are
nominally bf16, but under ``jit`` XLA (excess precision on, its default)
fuses them with the float32 cast that follows in the loss and in the
Denoiser and does not round them to bf16; eager PyTorch would, and in
bf16 training that rounding of every output to a step of up to one gray
level is the largest gradient error (it flips the hinge and SSIM terms
pixel by pixel).
``forward(x, train=True, generator=g)`` is the training forward
(``models/unet_laplacian.py``); ``ops/regularizers.regularization_loss``
sums every kernel's regularizer, the JAX model's sown ``losses``.

Backbones: ``unet_laplacian`` (one output per level), ``resnet`` and
``convnext`` (one output, ``models/resnet.py``), the classic ``unet``
(one output, ``models/unet.py``) and the ``segnet`` stub;
each names the channels of its outputs in ``out_features``. A float32
hydra (``dtype`` None) runs inside ``ops/precision.exact_float32`` on
the card, so its convs and matmuls do not drop to TF32.
"""

import logging
from collections import namedtuple
from typing import Any, Dict, List

import torch
from torch import nn

from ..config import input_shape_fixer
from ..layers.conv import ConvBlock
from ..layers.norm import parse_bn_flag
from ..ops.normalize import denormalize, normalize
from ..ops.precision import exact_float32
from ..ops.quant import set_module_paths
from . import resnet as _resnet_mod
from . import unet as _unet_mod
from .resnet import ConvNextBackbone, ResnetBackbone
from .segnet import SegnetBackbone
from .unet import UnetBackbone
from .unet_laplacian import UnetLaplacianBackbone

logger = logging.getLogger("blind_image_denoising_torch")

BuilderResults = namedtuple(
    "BuilderResults",
    ["backbone", "normalizer", "denormalizer", "denoiser", "hydra", "options"])

_BACKBONES = {
    "resnet": ResnetBackbone,
    "unet_laplacian": UnetLaplacianBackbone,
    "convnext": ConvNextBackbone,
    "unet": UnetBackbone,
    "segnet": SegnetBackbone,
}

_BACKBONE_KEYS = {
    "resnet": _resnet_mod.KNOWN_KEYS,
    "convnext": _resnet_mod.KNOWN_KEYS,
    "unet": _unet_mod.KNOWN_KEYS,
}

# options the reference's own snapshot parses but never applies
_REFERENCE_NOOP_KEYS = frozenset({"add_gradient_dropout"})

# each misconfigured key warns once per process
_WARNED_KEYS = set()


def _warn_unknown_keys(config: Dict, model_type: str) -> None:
    """Warn on config keys the builder does not understand, instead of
    silently building a different model."""
    known = _BACKBONE_KEYS.get(model_type)
    if known is None:
        return
    for k in sorted(config):
        if k in known or (model_type, k) in _WARNED_KEYS:
            continue
        _WARNED_KEYS.add((model_type, k))
        if k in _REFERENCE_NOOP_KEYS:
            logger.warning(
                f"backbone [{model_type}]: '{k}' accepted but a NO-OP "
                f"(the reference snapshot also never applies it)")
        else:
            logger.warning(
                f"backbone [{model_type}]: unrecognized config key "
                f"'{k}' is IGNORED")


def backbone_from_config(config: Dict, dtype=None) -> nn.Module:
    model_type = config["type"].strip().lower()
    if model_type == "efficientnet":
        raise NotImplementedError("efficientnet not implemented")
    if model_type not in _BACKBONES:
        raise ValueError(f"don't know how to build backbone [{model_type}]")
    _warn_unknown_keys(config, model_type)
    shape = config.get("input_shape") or [None, None, 3]
    return _BACKBONES[model_type](config, in_channels=int(shape[-1]),
                                  dtype=dtype)


class DenoiserHead(nn.Module):
    """1×1 conv (+BN/LN, +activation) → 1×1 conv → tanh(2x)·0.51
    (float32)."""

    def __init__(self, config: Dict[str, Any], in_features: int, dtype=None):
        super().__init__()
        cfg = dict(config)
        use_bias = cfg.get("use_bias", False)
        use_bn, bn_bias_free = parse_bn_flag(cfg.get("use_bn", False))
        filters = int(cfg.get("filters", 32))
        reg = cfg.get("kernel_regularizer", "l2")
        init = cfg.get("kernel_initializer", "glorot_normal")
        self.conv_0 = ConvBlock(in_features, filters, kernel_size=1,
                                activation=cfg.get("activation", "linear"),
                                use_bias=use_bias, use_bn=use_bn,
                                use_ln=cfg.get("use_ln", False),
                                bn_center=use_bias,
                                bn_bias_free=bn_bias_free,
                                kernel_regularizer=reg, dtype=dtype,
                                kernel_initializer=init)
        self.conv_1 = ConvBlock(filters, int(cfg.get("output_channels", 3)),
                                kernel_size=1, use_bias=use_bias,
                                kernel_regularizer=reg, dtype=dtype,
                                kernel_initializer=init)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.conv_1(self.conv_0(x, train=train), train=train)
        return torch.tanh(2.0 * y.float()) * 0.51


class Hydra(nn.Module):
    def __init__(self, config: Dict[str, Any], dtype=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.backbone = backbone_from_config(config["backbone"], dtype=dtype)
        self.no_outputs = len(self.backbone.out_features)
        for i, features in enumerate(self.backbone.out_features):
            self.add_module(f"denoiser_head_{i}", DenoiserHead(
                config["denoiser"], features, dtype=dtype))
        set_module_paths(self)

    @property
    def value_range(self):
        vr = self.config["backbone"].get("value_range", (0, 255))
        return float(vr[0]), float(vr[1])

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator = None) -> List[torch.Tensor]:
        """x: [B, C, H, W] float32 in the value range → list of [B, C, h, w]
        float32, finest first."""
        v_min, v_max = self.value_range
        with exact_float32(self.dtype is None and x.is_cuda):
            feats = self.backbone(normalize(x, v_min, v_max), train=train,
                                  generator=generator)
            return [denormalize(getattr(self, f"denoiser_head_{i}")(
                f, train=train), v_min, v_max)
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
