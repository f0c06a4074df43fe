"""Attention layers (counterpart of
``blind_image_denoising_tpu/layers/attention.py``
``AdditiveAttentionGate``, ``ConvolutionalSelfAttention``,
``NonLocalAttention`` and ``logit_norm``).

:class:`AdditiveAttentionGate` gates a U-Net skip: the encoder feature
and the upsampled decoder signal are each normalized (BatchNorm and/or
LayerNorm, before the conv) and projected by a 1×1 conv to the
attention channels; ``leaky_relu(x + y, 0.1)`` goes through a 1×1 conv
back to the encoder's channels and a per-channel gain, and the encoder
feature is multiplied by ``sigmoid(4·o)``. Its convs carry the
soft-orthogonal or soft-orthonormal regularizer when the model asks, or
L2 1e-4 (JAX ``_pick_regularizer``).

:class:`ConvolutionalSelfAttention`: the input is resized (bilinear,
antialiased when it shrinks) to 16×16, normalized (BatchNorm, then
LayerNorm, each optional), projected to q/k/v by 1×1 convs with
``leaky_relu``
(slope 0.3), attended with unscaled dot products and a softmax over the
keys, resized back, and mixed by a 1×1 output conv and a per-channel
gain. It returns the branch; the stage adds the skip. JAX runs it in
XLA, so the products here are ``torch.matmul``; the softmax is taken in
float32. In training, dropout of ``dropout_rate`` hits the softmax
weights element by element, drawn from the caller's generator; the four
convs carry ``kernel_regularizer`` (soft-orthonormal in the flagship).
Under a spatially sharded train step the unit runs on the whole map
(``parallel/spatial.on_whole_map``), its BatchNorm and dropout as
unsharded, and returns the slab's rows.

:class:`NonLocalAttention` is the full-resolution Non-Local-Nets block:
1×1 projections ``theta`` / ``phi`` / ``g`` to the attention channels,
the scores ``theta·phiᵀ`` over all H·W positions (optionally
L2-normalized by :func:`logit_norm`), a softmax over the keys, the
weighted sum of ``g`` and a 1×1 ``out`` conv. It is O((H·W)²): for small
feature maps only.
"""

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..constants import DEFAULT_EPSILON, DEFAULT_LN_EPSILON
from ..ops.regularizers import soft_ortho_spec
from ..ops.resize import nchw, nhwc, resize_bilinear
from ..parallel.spatial import on_whole_map, slab_rows
from .conv import ConvBlock
from .multipliers import ChannelLearnableMultiplier
from .norm import BatchNorm, FastLayerNorm
from .stochastic import drop_mask


def logit_norm(x: torch.Tensor, t: float = 1.0,
               axis: int = -1) -> torch.Tensor:
    """L2-normalized logits (logit normalization) along ``axis``, at
    temperature ``t``."""
    denom = torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True)
                       + DEFAULT_EPSILON) + DEFAULT_EPSILON
    return x / (denom * t)


def pick_regularizer(use_soft_orthogonal: bool, use_soft_orthonormal: bool):
    """The 1×1 convs' regularizer spec of the attention layers."""
    if use_soft_orthogonal and use_soft_orthonormal:
        raise ValueError("soft orthogonal and orthonormal regularization "
                         "are mutually exclusive")
    if use_soft_orthogonal:
        return soft_ortho_spec(False)
    if use_soft_orthonormal:
        return soft_ortho_spec(True)
    return {"type": "l2", "config": {"l2": 1e-4}}


class AdditiveAttentionGate(nn.Module):
    """``encoder ⊙ sigmoid(4·scale_o(conv_o(leaky_relu(conv_x(norm(up)) +
    conv_y(norm(encoder)), 0.1))))``. Module names are flax's:
    ``bn_y`` / ``ln_y``, ``conv_y``, ``bn_x`` / ``ln_x``, ``conv_x``,
    ``conv_o``, ``scale_o``."""

    def __init__(self, encoder_features: int, upsample_features: int,
                 attention_channels: int, use_bias: bool = False,
                 use_bn: bool = False, use_ln: bool = False,
                 use_soft_orthogonal_regularization: bool = False,
                 use_soft_orthonormal_regularization: bool = False,
                 dtype=None):
        super().__init__()
        if use_bn and use_ln:
            raise ValueError("use_bn and use_ln are mutually exclusive")
        reg = pick_regularizer(use_soft_orthogonal_regularization,
                               use_soft_orthonormal_regularization)
        for name, features in (("y", encoder_features),
                               ("x", upsample_features)):
            if use_bn:
                self.add_module(f"bn_{name}", BatchNorm(
                    features, use_bias=use_bias, dtype=dtype))
            if use_ln:
                self.add_module(f"ln_{name}", FastLayerNorm(
                    features, epsilon=DEFAULT_LN_EPSILON, use_bias=use_bias,
                    dtype=dtype))
            self.add_module(f"conv_{name}", ConvBlock(
                features, attention_channels, kernel_size=1,
                use_bias=use_bias, kernel_regularizer=reg, dtype=dtype))
        self.conv_o = ConvBlock(attention_channels, encoder_features,
                                kernel_size=1, use_bias=use_bias,
                                kernel_regularizer=reg, dtype=dtype)
        self.scale_o = ChannelLearnableMultiplier(encoder_features)

    def _project(self, v: torch.Tensor, name: str, train: bool):
        bn, ln = getattr(self, f"bn_{name}", None), getattr(
            self, f"ln_{name}", None)
        if bn is not None:
            v = bn(v, train=train)
        if ln is not None:
            v = ln(v)
        return getattr(self, f"conv_{name}")(v, train=train)

    def forward(self, encoder_feature: torch.Tensor,
                upsample_signal: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        y = self._project(encoder_feature, "y", train)
        x = self._project(upsample_signal, "x", train)
        o = self.scale_o(self.conv_o(F.leaky_relu(x + y, 0.1), train=train))
        return encoder_feature * torch.sigmoid(4.0 * o)


class ConvolutionalSelfAttention(nn.Module):
    def __init__(self, features: int, attention_channels: int,
                 use_ln: bool = True, use_bn: bool = False,
                 use_gamma: bool = True,
                 attention_activation: str = "leaky_relu",
                 output_activation: str = "linear",
                 attention_resolution: Tuple[int, int] = (16, 16),
                 dropout_rate: float = 0.0, kernel_regularizer=None,
                 bn_center: bool = False, dtype=None):
        super().__init__()
        if not 0.0 <= dropout_rate <= 1.0:
            raise ValueError("attention dropout_rate must be within [0, 1]")
        self.dropout_rate = float(dropout_rate)
        self.resolution = tuple(int(v) for v in attention_resolution)
        self.channels = int(attention_channels)
        self.bn = (BatchNorm(features, use_bias=bn_center, dtype=dtype)
                   if use_bn else None)
        self.ln = (FastLayerNorm(features, epsilon=DEFAULT_LN_EPSILON,
                                 use_bias=bn_center, dtype=dtype)
                   if use_ln else None)
        qkv = dict(kernel_size=1, activation=attention_activation,
                   kernel_regularizer=kernel_regularizer, dtype=dtype)
        self.query_conv = ConvBlock(features, self.channels, **qkv)
        self.key_conv = ConvBlock(features, self.channels, **qkv)
        self.value_conv = ConvBlock(features, self.channels, **qkv)
        self.output_conv = ConvBlock(self.channels, features, kernel_size=1,
                                     activation=output_activation,
                                     kernel_regularizer=kernel_regularizer,
                                     dtype=dtype)
        self.gamma = ChannelLearnableMultiplier(features) if use_gamma \
            else None

    def forward(self, inputs: torch.Tensor, train: bool = False,
                generator: torch.Generator = None) -> torch.Tensor:
        """inputs: NCHW → the attention branch, NCHW."""
        y, shard = on_whole_map(self._branch, inputs, train, generator)
        return slab_rows(y, shard)

    def _branch(self, inputs: torch.Tensor, train: bool,
                generator: torch.Generator) -> torch.Tensor:
        b, _, h, w = inputs.shape
        rh, rw = self.resolution
        x = nchw(resize_bilinear(nhwc(inputs), (rh, rw)))
        if self.bn is not None:
            x = self.bn(x, train=train)
        if self.ln is not None:
            x = self.ln(x)

        def tokens(conv):               # [B, rh*rw, channels]
            return conv(x).flatten(2).transpose(1, 2)

        q, k, v = (tokens(self.query_conv), tokens(self.key_conv),
                   tokens(self.value_conv))
        scores = q @ k.transpose(1, 2)
        weights = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        if train and self.dropout_rate > 0.0:
            keep = drop_mask(weights.shape, self.dropout_rate, generator,
                             weights.device)
            weights = torch.where(keep, weights / (1.0 - self.dropout_rate),
                                  torch.zeros_like(weights))
        attended = (weights @ v).transpose(1, 2).reshape(
            b, self.channels, rh, rw)
        y = nchw(resize_bilinear(nhwc(attended), (h, w)))
        y = self.output_conv(y.contiguous(memory_format=torch.channels_last))
        if self.gamma is not None:
            y = self.gamma(y)
        return y


class NonLocalAttention(nn.Module):
    """``out(softmax(theta·phiᵀ)·g)`` over every position of an NCHW
    map; module names are flax's (``theta``, ``phi``, ``g``, ``out``)."""

    def __init__(self, features: int, attention_channels: int,
                 use_bias: bool = False, use_logit_norm: bool = False,
                 activation: str = "linear", kernel_regularizer="l2",
                 dtype=None):
        super().__init__()
        self.channels = int(attention_channels)
        self.use_logit_norm = bool(use_logit_norm)
        common = dict(kernel_size=1, use_bias=use_bias,
                      kernel_regularizer=kernel_regularizer, dtype=dtype)
        self.theta = ConvBlock(features, self.channels, **common)
        self.phi = ConvBlock(features, self.channels, **common)
        self.g = ConvBlock(features, self.channels, **common)
        self.out = ConvBlock(self.channels, self.channels,
                             activation=activation, **common)

    def forward(self, inputs: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        b, _, h, w = inputs.shape

        def tokens(conv):               # [B, H*W, channels]
            return conv(inputs, train=train).flatten(2).transpose(1, 2)

        theta, phi, g = tokens(self.theta), tokens(self.phi), tokens(self.g)
        scores = theta @ phi.transpose(1, 2)
        if self.use_logit_norm:
            scores = logit_norm(scores, axis=-1)
        weights = torch.softmax(scores, dim=-1)
        y = (weights @ g).transpose(1, 2).reshape(b, self.channels, h, w)
        return self.out(y.contiguous(memory_format=torch.channels_last),
                        train=train)
