"""Fused int8 serving path for the ``unet_laplacian`` flagship family
(counterpart of ``blind_image_denoising_tpu/inference/fused.py``).

The ConvNext stages of the fused levels (by default the two finest; any
level whose units K1 is built for, e.g. ``fused_levels=(0, 1, 2)`` on a
depth-4 config, whose level 2 is 128 channels wide) run
as K1 (``ops/pallas_convnext.convnext_block``) in its int8 I/O mode: the
stage input is quantized once, the units chain int8 → int8, each unit's
``scale_in`` the previous unit's ``scale_out``, and the last output is
dequantized in the compute dtype. Without scales the same stages run K1
in the dtype's float mode. Everything else is the hydra forward,
computed by the port's own layers on the model's parameters: the stem,
the out-LayerNorms, the band split as ``avg_pool_same`` and a subtract
(outside any kernel, as the JAX module does, so this path launches no
K2), the down and up convs, the attention units of the deepest level,
and the heads with their float32 ``tanh(2x)·0.51`` epilogue and
denormalize (the port's hydra keeps them in float32; JAX's eager
``fwd`` rounds them to bf16 in bf16 mode).

``supports_fused`` guards the config subset the forward implements one
way. Unlike the JAX function, which raises ``TypeError`` on a per-level
kernel-size list (the packaged ``unet_laplacian_v6_tpu`` config), it
returns False there, and ``build_fused_forward`` raises its
``ValueError``.

Usage (``model``: the port's ``Hydra`` holding the weights; its dtype
must be None or the forward's ``dtype``, since its layers compute in
their own dtype or the input's)::

    scales = calibrate_fused(config, model, images)   # site -> int8 scale
    fwd, sites = build_fused_forward(config, model, scales)
    outs = fwd(x)        # x: [B, 3, H, W] in the value range, like Hydra;
                         # per-scale float32 outputs, finest first

Site names are the JAX module's, so a scales dict calibrated by either
package serves in the other. The forward runs on the model's device.
"""

import logging
from typing import Dict, List, Optional

import torch

from ..ops.normalize import denormalize, normalize
from ..ops.pallas_convnext import convnext_block, quantize
from ..ops.precision import exact_float32
from ..ops.resize import avg_pool_same, nchw, nhwc

logger = logging.getLogger("blind_image_denoising_torch")


def supports_fused(backbone_cfg: Dict) -> bool:
    """True when the config is in the fused path's supported subset (the
    JAX guards, option by option; a per-level kernel-size list is outside
    it)."""
    c = backbone_cfg
    kernels = (c.get("encoder_kernel_size", 5), c.get("decoder_kernel_size", 3))
    if any(isinstance(k, (list, tuple)) for k in kernels):
        return False
    ok = (
        c.get("type", "").strip().lower() == "unet_laplacian"
        and int(c.get("depth", 5)) >= 2
        and not c.get("use_bn", False)
        and c.get("use_ln", True)
        and not c.get("use_bias", False)
        and c.get("use_gamma", True)
        and not c.get("use_concat", True)       # must be add-skip
        and not c.get("use_mix_project", True)
        and c.get("use_laplacian_averaging", True)
        and not c.get("use_attention_gates", False)
        and not c.get("use_complex_base", False)
        and not c.get("use_global_pool_information", False)
        and c.get("use_output_normalization", False)
        and c.get("activation", "leaky_relu_01") == "leaky_relu_01"
        and c.get("upsample_type") == "upsample_nearest_conv2d"
        and c.get("downsample_type") == "conv2d"
        and int(kernels[0]) == 5
        and int(kernels[1]) == 5
        and c.get("multiple_scale_outputs", True)
    )
    return bool(ok)


def supports_fused_head(denoiser_cfg: Dict) -> bool:
    """True when the denoiser-head config is in the fused path's subset:
    activation leaky_relu_01 or linear, no BN/LN/bias."""
    c = denoiser_cfg
    return bool(
        c.get("activation", "linear") in ("leaky_relu_01", "linear")
        and not c.get("use_bn", False)
        and not c.get("use_ln", False)
        and not c.get("use_bias", False)
    )


def _stage_sites(levels, width: int) -> List[str]:
    """Calibration-site names: one for each fused stage input and each
    fused unit output, per fused level."""
    names = []
    for kind in ("encoder", "decoder"):
        for d in sorted(levels):
            names.append(f"{kind}_{d}_in")
            for w in range(width):
                names.append(f"{kind}_{d}_{w}_out")
    return names


class _AmaxRecorder:
    def __init__(self):
        self.amax: Dict[str, float] = {}

    def record(self, name: str, x: torch.Tensor) -> None:
        a = float(x.float().abs().max())
        self.amax[name] = max(a, self.amax.get(name, 0.0))


def build_fused_forward(config: Dict, model, scales: Optional[Dict] = None,
                        dtype=torch.bfloat16,
                        fused_levels: Optional[tuple] = None,
                        _recorder: Optional[_AmaxRecorder] = None):
    """Return ``(fwd, sites)``: ``fwd(x) -> [outputs]`` mirrors the hydra
    forward for the flagship config family with the ConvNext stages of
    ``fused_levels`` (default: ``range(min(2, depth - 1))``) fused, and
    ``sites`` lists their calibration sites. ``scales`` (site → int8
    scale, from :func:`calibrate_fused` or the JAX package's) selects the
    int8 I/O mode; None runs the fused stages in ``dtype``'s float
    mode."""
    bcfg = dict(config["backbone"])
    dcfg = dict(config["denoiser"])
    if not supports_fused(bcfg):
        raise ValueError("backbone config outside the fused path's "
                         "supported subset — use the standard hydra path")
    if not supports_fused_head(dcfg):
        raise ValueError("denoiser-head config outside the fused path's "
                         "supported subset (needs leaky_relu_01/linear "
                         "activation, no BN/LN/bias) — use the standard "
                         "hydra path")
    if model.dtype not in (None, dtype):
        raise ValueError(f"the model computes in {model.dtype}; build it "
                         f"with dtype None or {dtype} for a {dtype} fused "
                         f"forward")
    bb = model.backbone
    depth = int(bcfg.get("depth", 5))
    width = max(1, int(bcfg.get("width", 1)))
    gk = int(bcfg.get("gaussian_kernel_size", 3))
    vr = bcfg.get("value_range", (0, 255))
    v_min, v_max = float(vr[0]), float(vr[1])
    quant = scales is not None
    if fused_levels is None:
        fused_levels = tuple(range(min(2, depth - 1)))
    device = next(model.parameters()).device

    def fused_stage(x, kind: str, d: int):
        """width × K1, int8 (or float) I/O, NHWC between the units."""
        site_in = f"{kind}_{d}_in"
        if _recorder is not None:
            _recorder.record(site_in, x)
        v = nhwc(x)
        s_prev = None
        if quant:
            s_prev = scales[site_in]
            v = quantize(v, s_prev)
        for w in range(width):
            unit = getattr(bb, f"{kind}_{d}_{w}")
            w_dtype = torch.bfloat16 if quant else dtype
            wts = unit.kernel_weights(w_dtype)
            ops = (unit.kernel_operands(w_dtype, io_dtype=v.dtype)
                   if v.is_cuda else None)
            site_out = f"{kind}_{d}_{w}_out"
            if quant:
                v = convnext_block(v, slope=unit.slope, scale_in=s_prev,
                                   scale_out=scales[site_out], operands=ops,
                                   **wts)
                s_prev = scales[site_out]
            else:
                v = convnext_block(v, slope=unit.slope, operands=ops, **wts)
            if _recorder is not None:
                _recorder.record(site_out, v)
        if quant:    # bf16(q) · bf16(s) in bf16, as cf.astype(dtype) * s
            v = v.to(dtype) * torch.tensor(s_prev, dtype=dtype)
        return nchw(v.to(dtype))

    def xla_stage(x, kind: str, d: int):
        """A stage outside the fused levels (the attention units of the
        deepest level), in plain PyTorch as JAX leaves it to XLA."""
        for w in range(width):
            attn = getattr(bb, f"{kind}_{d}_{w}_attn", None)
            x = x + (attn(x) if attn is not None
                     else getattr(bb, f"{kind}_{d}_{w}").branch(x))
        return x

    def stage(x, kind: str, d: int):
        if d in fused_levels:
            return fused_stage(x, kind, d)
        return xla_stage(x, kind, d)

    @torch.no_grad()
    def fwd(x):
        x = torch.as_tensor(x).to(device, torch.float32)
        with exact_float32(dtype == torch.float32 and x.is_cuda):
            return forward(x)

    def forward(x):
        xn = normalize(x, v_min, v_max).to(dtype).contiguous(
            memory_format=torch.channels_last)
        v = bb.stem_conv(xn)
        skips = {}
        for d in range(depth):
            v = stage(v, "encoder", d)
            v = bb.act(getattr(bb, f"encoder_{d}_out_ln")(v))
            skips[d] = v
            if d != depth - 1:
                smooth = nchw(avg_pool_same(nhwc(v), (gk, gk), (1, 1)))
                skips[d] = v - smooth
                v = getattr(bb, f"down_{d}")(smooth)

        decoded = {depth - 1: skips[depth - 1]}
        for d in range(depth - 2, -1, -1):
            v = skips[d] + getattr(bb, f"up_{d}")(decoded[d + 1])
            v = stage(v, "decoder", d)
            decoded[d] = getattr(bb, f"decoder_{d}_out_ln")(v)

        return [denormalize(getattr(model, f"denoiser_head_{i}")(decoded[i]),
                            v_min, v_max) for i in range(depth)]

    return fwd, _stage_sites(fused_levels, width)


def calibrate_fused(config: Dict, model, images, margin: float = 1.0,
                    fused_levels: Optional[tuple] = None
                    ) -> Dict[str, float]:
    """Run representative images one at a time through the bf16 FLOAT
    fused forward, recording each stage site's activation amax; return
    site → int8 scale ``max(margin · amax, 1e-6) / 127``.

    ``images``: [N, C, H, W] (the layout ``fwd`` takes) in the model's
    value range; include noisy samples spanning deployment noise
    levels. ``fused_levels``: as :func:`build_fused_forward`'s, whose
    int8 forward needs the sites of every fused level (the JAX function
    calibrates the default levels only)."""
    rec = _AmaxRecorder()
    fwd, sites = build_fused_forward(config, model, scales=None,
                                     dtype=torch.bfloat16,
                                     fused_levels=fused_levels,
                                     _recorder=rec)
    images = torch.as_tensor(images)
    for i in range(images.shape[0]):
        fwd(images[i:i + 1])
    # the deepest level has no decoder stage, whose sites _stage_sites
    # names all the same when that level is fused
    deepest = int(config["backbone"].get("depth", 5)) - 1
    missing = [s for s in sites if s not in rec.amax
               and not s.startswith(f"decoder_{deepest}_")]
    if missing:
        raise ValueError(f"calibration left sites unrecorded: {missing}")
    scales = {k: max(margin * a, 1e-6) / 127.0 for k, a in rec.amax.items()}
    logger.info("fused int8 calibration: %d sites", len(scales))
    return scales
