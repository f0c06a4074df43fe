"""Resolution-pinned self-attention (counterpart of
``blind_image_denoising_tpu/layers/attention.py``
``ConvolutionalSelfAttention``).

The input is resized (bilinear, antialiased when it shrinks) to 16×16,
layer-normalized, projected to q/k/v by 1×1 convs with ``leaky_relu``
(slope 0.3), attended with unscaled dot products and a softmax over the
keys, resized back, and mixed by a 1×1 output conv and a per-channel
gain. It returns the branch; the stage adds the skip. JAX runs it in
XLA, so the products here are ``torch.matmul``; the softmax is taken in
float32. In training, dropout of ``dropout_rate`` hits the softmax
weights element by element, drawn from the caller's generator; the four
convs carry ``kernel_regularizer`` (soft-orthonormal in the flagship).
"""

from typing import Tuple

import torch
from torch import nn

from ..constants import DEFAULT_LN_EPSILON
from ..ops.resize import nchw, nhwc, resize_bilinear
from .conv import ConvBlock
from .multipliers import ChannelLearnableMultiplier
from .norm import FastLayerNorm
from .stochastic import drop_mask


class ConvolutionalSelfAttention(nn.Module):
    def __init__(self, features: int, attention_channels: int,
                 use_ln: bool = True, use_bn: bool = False,
                 use_gamma: bool = True,
                 attention_activation: str = "leaky_relu",
                 output_activation: str = "linear",
                 attention_resolution: Tuple[int, int] = (16, 16),
                 dropout_rate: float = 0.0, kernel_regularizer=None,
                 dtype=None):
        super().__init__()
        if use_bn:
            raise NotImplementedError(
                "BatchNorm in attention is not ported yet (ROADMAP Queue 1 "
                "item 9)")
        if not 0.0 <= dropout_rate <= 1.0:
            raise ValueError("attention dropout_rate must be within [0, 1]")
        self.dropout_rate = float(dropout_rate)
        self.resolution = tuple(int(v) for v in attention_resolution)
        self.channels = int(attention_channels)
        self.ln = (FastLayerNorm(features, epsilon=DEFAULT_LN_EPSILON,
                                 dtype=dtype) if use_ln else None)
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
        b, _, h, w = inputs.shape
        rh, rw = self.resolution
        x = nchw(resize_bilinear(nhwc(inputs), (rh, rw)))
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
