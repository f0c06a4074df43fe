"""The convolution block, float path (counterpart of
``blind_image_denoising_tpu/layers/conv.py`` ``ConvBlock``):
conv → optional LayerNorm → activation.

Covers the flagship's plain and depthwise convolutions: the 5×5 stem,
the 2×2 stride-2 down conv, the 3×3 up conv and the 1×1 head and
attention convs. Tensors are NCHW (``channels_last``), kernels OIHW.
The conv runs in the compute dtype (``dtype``, or the input's), as
``ops/quant.py`` ``conv2d`` does with no quantization mode; these convs
sit outside any TPU kernel, so they go to ``F.conv2d``. SAME padding
follows XLA: an odd total pads one more on the high side.

Not ported yet, and raising: BatchNorm, bias, transposed, separable and
grouped convs (ROADMAP Queue 1 item 9). Dropout is the identity at
inference.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..constants import DEFAULT_LN_EPSILON
from ..ops.resize import same_pads
from .activations import activation_fn
from .norm import FastLayerNorm


def _pair(v):
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def conv2d_same(x: torch.Tensor, kernel: torch.Tensor, strides=(1, 1),
                groups: int = 1, dtype=None) -> torch.Tensor:
    """SAME-padded convolution of NCHW x with an OIHW kernel, in ``dtype``
    (default: x's)."""
    cdt = dtype or x.dtype
    sh, sw = _pair(strides)
    kh, kw = kernel.shape[-2:]
    ph = same_pads(x.shape[2], kh, sh)
    pw = same_pads(x.shape[3], kw, sw)
    x = x.to(cdt)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        padding = (ph[0], pw[0])
    else:
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        padding = (0, 0)
    return F.conv2d(x, kernel.to(cdt), stride=(sh, sw), padding=padding,
                    groups=groups)


class ConvBlock(nn.Module):
    """conv → optional LayerNorm → activation. ``depth_multiplier`` not
    None selects a depthwise conv over ``in_features``."""

    def __init__(self, in_features: int, features: int = 0, kernel_size=3,
                 strides=(1, 1), depth_multiplier: Optional[int] = None,
                 activation: str = "linear", use_ln: bool = False,
                 use_bn: bool = False, use_bias: bool = False,
                 groups: int = 1, transpose: bool = False,
                 separable: bool = False, dtype=None):
        super().__init__()
        if use_bn or use_bias or transpose or separable or groups != 1:
            raise NotImplementedError(
                "ConvBlock options use_bn/use_bias/transpose/separable/"
                "groups are not ported yet (ROADMAP Queue 1 item 9)")
        kh, kw = _pair(kernel_size)
        self.strides = _pair(strides)
        self.dtype = dtype
        if depth_multiplier is not None:
            out = in_features * int(depth_multiplier)
            self.groups = in_features
            self.kernel = nn.Parameter(torch.zeros(out, 1, kh, kw))
        else:
            out = int(features)
            self.groups = 1
            self.kernel = nn.Parameter(torch.zeros(out, in_features, kh, kw))
        self.out_features = out
        self.ln = (FastLayerNorm(out, epsilon=DEFAULT_LN_EPSILON, dtype=dtype)
                   if use_ln else None)
        self.act = activation_fn(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d_same(x, self.kernel, self.strides, self.groups, self.dtype)
        if self.ln is not None:
            y = self.ln(y)
        return self.act(y)


def conv_block_from_params(in_features: int, params: dict, dtype=None,
                           use_ln: bool = False, **overrides) -> ConvBlock:
    """A ConvBlock from a reference-schema conv-params dict (kernel_size /
    filters / depth_multiplier / strides / use_bias / activation …)."""
    p = dict(params or {})
    p.update(overrides)
    if str(p.get("padding", "same")).lower() != "same":
        raise NotImplementedError(
            "VALID padding is not ported yet (ROADMAP Queue 1 item 9)")
    return ConvBlock(
        in_features, features=p.get("filters", 0),
        kernel_size=p.get("kernel_size", 3),
        strides=p.get("strides", (1, 1)),
        depth_multiplier=p.get("depth_multiplier", None),
        activation=p.get("activation", "linear"),
        use_ln=use_ln, use_bias=p.get("use_bias", False),
        groups=p.get("groups", 1), transpose=p.get("transpose", False),
        separable=p.get("separable", False), dtype=dtype)
