"""The shipped pretrained ``unet_laplacian_v5.6`` (counterpart of
``blind_image_denoising_tpu/models/unet_laplacian_v56.py``), the model of
the ``unet_laplacian_v56_highnoise`` artifact.

* ConvNext units: depthwise k×k (linear) → LayerNorm → 1×1 expand ×4
  with exact GELU → 1×1 project → gain tanh(relu(1+w)), residual; k = 5
  in the encoder, 1 in the decoder; three per level.
* The band split is ``h − gaussian_blur(h, 3×3)``; downsampling is a
  stride-2 slice of the smooth half, a 1×1 conv and leaky ReLU 0.1.
* Three residual self-attention units at level 2, at full resolution:
  LayerNorm → exact-GELU 1×1 q/k/v → softmax(q·valueᵀ) · key, with no
  1/√d scale (the saved artifact passed [q, k, v] to a layer whose
  contract is [query, value, key]) → LayerNorm → 1×1 → gain. JAX
  materializes the full score matrix too, so these are plain matmuls.
* Upsampling is a 1×1 conv then bilinear 2× (``ops/resize.py``), plus
  the band skip.
* Heads: LayerNorm → 1×1 (leaky 0.1) → 1×1 → tanh(2x)·0.51 (float32) →
  denormalize. Only the finest head runs unless ``all_scales``.

The LayerNorms take their statistics in the input dtype (``_LN``), unlike
``FastLayerNorm``: in bf16 each mean accumulates in float32 and rounds
to bf16, as ``jnp.mean`` does. Every conv goes through
``ops/quant.py``'s ``conv2d`` under the JAX module's site names
(``stem``, ``enc_0_0``'s ``dw``/``expand``/``project``, ``attn_0``'s
``qkv``/``out``, ``down_0``, ``up_0``, ``head_0_0`` …), so the shipped
``quant.msgpack`` attaches as it is. Parameters are the flax leaves
(``stem``, ``enc_0_0.conv_1``, ``enc_0_0.ln.scale``, ``enc_0_0.gamma.w``
…) in OIHW. Tensors are NCHW; a float32 model runs inside
``ops/precision.exact_float32`` on the card.
"""

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import quant as quant_ops
from ..ops.gaussian import gaussian_blur
from ..ops.normalize import denormalize, normalize
from ..ops.precision import exact_float32
from ..ops.resize import nchw, nhwc, upsample_2x_bilinear


def _leaky(x):
    return F.leaky_relu(x, 0.1)


def _gelu(x):
    return F.gelu(x, approximate="none")


def _qconv(module, site, x, kernel, groups=1):
    """A conv site with the int8 PTQ hooks, in the module's compute dtype
    (float32 when it has none)."""
    return quant_ops.conv2d(module, site, x, kernel, groups=groups,
                            compute_dtype=module.dtype or torch.float32)


def _channel_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over C accumulated in float32, rounded to x's dtype."""
    return x.float().mean(dim=1, keepdim=True).to(x.dtype)


class _LN(nn.Module):
    """LayerNorm over channels, scale only, eps 1e-3, statistics in the
    input dtype."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))

    def forward(self, x):
        mean = _channel_mean(x)
        var = _channel_mean(torch.square(x - mean))
        return ((x - mean) * torch.rsqrt(var + 1e-3)
                * self.scale.to(x.dtype).view(1, -1, 1, 1))


class _Gamma(nn.Module):
    """Per-channel gain tanh(relu(1 + w)) · x."""

    def __init__(self, features: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        gain = torch.tanh(torch.clamp(1.0 + self.w, min=0.0)).to(x.dtype)
        return x * gain.view(1, -1, 1, 1)


def _kernel(out_features, in_features, k=1):
    return nn.Parameter(torch.zeros(out_features, in_features, k, k))


class _ConvNextV56(nn.Module):
    """dw k×k (linear) → LN → 1×1 expand (GELU) → 1×1 project → gamma."""

    def __init__(self, features: int, dw_kernel: int, dtype=None):
        super().__init__()
        c = features
        self.dtype = dtype
        self.conv_1 = _kernel(c, 1, dw_kernel)
        self.ln = _LN(c)
        self.conv_2 = _kernel(4 * c, c)
        self.conv_3 = _kernel(c, 4 * c)
        self.gamma = _Gamma(c)

    def forward(self, x):
        y = _qconv(self, "dw", x, self.conv_1, groups=x.shape[1])
        y = _gelu(_qconv(self, "expand", self.ln(y), self.conv_2))
        return self.gamma(_qconv(self, "project", y, self.conv_3))


class _AttentionV56(nn.Module):
    """Full-resolution self-attention (module docstring)."""

    def __init__(self, channels: int, attention_channels: int = 32,
                 dtype=None):
        super().__init__()
        ca = attention_channels
        self.dtype = dtype
        self.ln_0 = _LN(channels)
        self.query_conv = _kernel(ca, channels)
        self.key_conv = _kernel(ca, channels)
        self.value_conv = _kernel(ca, channels)
        self.ln_1 = _LN(ca)
        self.output_fn = _kernel(channels, ca)
        self.gamma = _Gamma(channels)

    def forward(self, x):
        b, _, h, w = x.shape
        y = self.ln_0(x)

        def qkv(kernel):
            # the three projections read the same tensor: one shared site
            t = _gelu(_qconv(self, "qkv", y, kernel))
            return nhwc(t).reshape(b, h * w, -1)

        q, k, v = (qkv(self.query_conv), qkv(self.key_conv),
                   qkv(self.value_conv))
        scores = torch.matmul(q, v.transpose(1, 2))
        a = torch.matmul(torch.softmax(scores, dim=-1), k)
        a = self.ln_1(nchw(a.reshape(b, h, w, -1)))
        return self.gamma(_qconv(self, "out", a, self.output_fn))


class UnetLaplacianV56(nn.Module):
    """normalize → backbone → LN → head → denormalize. ``forward(x)``: x
    [B, 3, H, W] float32 in [0, 255] → a list holding the finest head's
    [B, 3, H, W] float32 output (all three heads with ``all_scales``)."""

    def __init__(self, filters: int = 32, width: int = 3, dtype=None):
        super().__init__()
        f = filters
        self.width = width
        self.dtype = dtype
        self.channels = {0: f, 1: 2 * f, 2: 4 * f}
        ch = self.channels
        self.stem = _kernel(f, 3, 5)
        for d in (0, 1):
            for w in range(width):
                self.add_module(f"enc_{d}_{w}", _ConvNextV56(ch[d], 5, dtype))
            self.register_parameter(f"down_{d}", _kernel(ch[d + 1], ch[d]))
        for w in range(width):
            self.add_module(f"attn_{w}", _AttentionV56(ch[2], dtype=dtype))
        for d in (1, 0):
            self.register_parameter(f"up_{d}", _kernel(ch[d], ch[d + 1]))
            for w in range(width):
                self.add_module(f"dec_{d}_{w}", _ConvNextV56(ch[d], 1, dtype))
        for i in (0, 1, 2):
            self.add_module(f"out_ln_{i}", _LN(ch[i]))
            self.register_parameter(f"head_{i}_conv_0", _kernel(f, ch[i]))
            self.register_parameter(f"head_{i}_conv_1", _kernel(3, f))
        quant_ops.set_module_paths(self)

    def _head(self, z, i: int):
        z = getattr(self, f"out_ln_{i}")(z)
        z = _leaky(_qconv(self, f"head_{i}_0", z,
                          getattr(self, f"head_{i}_conv_0")))
        z = _qconv(self, f"head_{i}_1", z, getattr(self, f"head_{i}_conv_1"))
        return denormalize(torch.tanh(2.0 * z.float()) * 0.51, 0.0, 255.0)

    def forward(self, x: torch.Tensor, all_scales: bool = False,
                train: bool = False) -> List[torch.Tensor]:
        """``train`` is accepted for the hydra calling convention and
        ignored: the model is inference-only, as in JAX."""
        with exact_float32(self.dtype is None and x.is_cuda):
            return self._forward(x, all_scales)

    def _forward(self, x, all_scales):
        h = _leaky(_qconv(self, "stem", normalize(x, 0.0, 255.0), self.stem))
        skips: Dict[int, torch.Tensor] = {}
        for d in (0, 1):
            for w in range(self.width):
                h = h + getattr(self, f"enc_{d}_{w}")(h)
            smooth = nchw(gaussian_blur(nhwc(h), kernel_size=(3, 3)))
            skips[d] = h - smooth
            h = _leaky(_qconv(self, f"down_{d}", smooth[:, :, ::2, ::2],
                              getattr(self, f"down_{d}")))
        for w in range(self.width):
            h = h + getattr(self, f"attn_{w}")(h)
        decoded = {2: h}
        for d in (1, 0):
            up = _qconv(self, f"up_{d}", decoded[d + 1],
                        getattr(self, f"up_{d}"))
            v = nchw(upsample_2x_bilinear(nhwc(up))) + skips[d]
            for w in range(self.width):
                v = v + getattr(self, f"dec_{d}_{w}")(v)
            decoded[d] = v
        if not all_scales:
            return [self._head(decoded[0], 0)]
        return [self._head(decoded[d], d) for d in (0, 1, 2)]
