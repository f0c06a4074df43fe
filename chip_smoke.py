#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``blind_image_denoising_torch``) on one
NVIDIA GPU: build the hand-written CUDA kernels from the checkout, hold
each against its plain PyTorch version at the serving path's shapes,
serve the packaged flagship ``unet_laplacian_v6_tpu_scratch`` through
``load_model`` (bf16, adaptive blend on) and check what comes out, then
time the kernels and the serving path.

    python3 chip_smoke.py [--profile-out FILE]

Imports only the port, torch and numpy; images are synthetic, made from
a seed. Any failed check raises, so the exit code is nonzero and the
final line is not printed. Without a CUDA device it exits 1 at once.
Output: one line per phase; then a ``{"kernels": [...]}`` JSON line, the
``nvidia-smi`` name and power limit, and, last, the
``{"ok": true, "device": ...}`` line. ``--profile-out FILE`` also writes
the full per-kernel device-time table of the profiled serving batches
(torch.profiler) to FILE.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

FLAGSHIP = "unet_laplacian_v6_tpu_scratch"
SEED = 0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
TENSOR_BF16_OPS_PER_S = 989e12   # dense bf16 tensor cores
FP32_OPS_PER_S = 67e12           # float32 on the CUDA cores


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def synthetic_images(n: int, h: int, w: int, rng) -> np.ndarray:
    """Smooth colour fields with sharp-edged shapes, [n, h, w, 3] float32
    in [0, 255]."""
    out = np.empty((n, h, w, 3), np.float32)
    for i in range(n):
        low = torch.from_numpy(rng.uniform(30, 220, (1, 3, 6, 6)).astype(
            np.float32))
        img = F.interpolate(low, size=(h, w), mode="bicubic",
                            align_corners=False)[0].permute(1, 2, 0).numpy()
        for _ in range(12):
            y0, x0 = rng.integers(0, h), rng.integers(0, w)
            y1 = min(h, y0 + rng.integers(h // 16, h // 3))
            x1 = min(w, x0 + rng.integers(w // 16, w // 3))
            img[y0:y1, x0:x1] = rng.uniform(0, 255, 3)
        out[i] = np.clip(img, 0, 255)
    return out


def add_noise(clean: np.ndarray, sigma: float, rng) -> np.ndarray:
    return np.clip(np.round(clean + rng.normal(0, sigma, clean.shape)),
                   0, 255).astype(np.uint8)


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    a = v.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


# --------------------------------------------------------------- kernels

def unit_inputs(model, name, b, h, w, dtype, rng):
    unit = getattr(model.backbone, name)
    c = unit.conv_1.kernel.shape[0]
    x = torch.from_numpy(rng.normal(0, 1, (b, h, w, c)).astype(
        np.float32)).cuda().to(dtype)
    return x, unit.kernel_weights(dtype), unit.slope


def convnext_library(x, dw, ln_scale, w2, w3, gain, slope):
    """The same function from PyTorch library calls (cuDNN depthwise conv,
    F.layer_norm, two F.linear): the timed yardstick only."""
    c, k = x.shape[-1], dw.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), dw.to(x.dtype), padding=k // 2,
                 groups=c).permute(0, 2, 3, 1)
    t = F.layer_norm(y, (c,), ln_scale.to(x.dtype), None, 1e-3)
    h = F.leaky_relu(F.linear(t, w2), slope)
    return x + gain.to(x.dtype) * F.linear(h, w3)


def band_smooth_library(x, k):
    """Count-aware SAME box mean from F.avg_pool2d: the timed yardstick."""
    _, h, w, _ = x.shape
    lo = (k - 1) // 2
    xp = F.pad(x.permute(0, 3, 1, 2), (lo, k - 1 - lo, lo, k - 1 - lo))
    ones = F.pad(torch.ones((1, 1, h, w), device=x.device, dtype=x.dtype),
                 (lo, k - 1 - lo, lo, k - 1 - lo))
    count = F.avg_pool2d(ones, k, stride=1)
    smooth = (F.avg_pool2d(xp, k, stride=1) / count).permute(0, 2, 3, 1)
    return x - smooth, smooth


def convnext_bound_ms(b, h, w, c, k, dtype):
    """The larger of bytes over the memory rate and operations over the
    peak rate for their type. In bf16 the two products run on the tensor
    cores and the depthwise, LayerNorm and epilogue on the CUDA cores;
    the two units run at once, so each is a bound of its own and the
    least time is the largest of the three, not a sum."""
    px = b * h * w
    elt = torch.tensor([], dtype=dtype).element_size()
    e = 4 * c
    nbytes = 2 * px * c * elt + (k * k * c + 2 * c) * 4 + 2 * e * c * elt
    products = px * 4 * c * e
    other = px * (2 * k * k * c + 8 * c + e)
    if dtype == torch.bfloat16:
        ops_s = max(products / TENSOR_BF16_OPS_PER_S, other / FP32_OPS_PER_S)
    else:
        ops_s = (products + other) / FP32_OPS_PER_S
    return max(nbytes / HBM_BYTES_PER_S, ops_s) * 1e3, \
        ("bytes" if nbytes / HBM_BYTES_PER_S >= ops_s else "operations")


def band_bound_ms(b, h, w, c, k, dtype):
    n = b * h * w * c
    elt = torch.tensor([], dtype=dtype).element_size()
    byte_s = 3 * n * elt / HBM_BYTES_PER_S
    ops_s = n * (k * k + 2) / FP32_OPS_PER_S
    return max(byte_s, ops_s) * 1e3, ("bytes" if byte_s >= ops_s
                                      else "operations")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile-out", type=Path, default=None,
                        help="write the profiled per-kernel table here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import blind_image_denoising_torch as bidt
    from blind_image_denoising_torch.ops import (cuda_build, pallas_convnext,
                                                 pallas_pyramid)

    # ---- phase 1: device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log("device", kind=kind, count=torch.cuda.device_count(), smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)

    # ---- phase 2: build every kernel from the checkout's sources
    t0 = time.perf_counter()
    cuda_build.library()
    log("build", seconds=round(time.perf_counter() - t0, 3),
        nvcc_seconds=round(cuda_build.build_seconds, 3),
        sources=[s.name for s in cuda_build.sources()])

    rng = np.random.default_rng(SEED)
    den = bidt.load_model(FLAGSHIP)                     # card, bf16, blend
    model = den.model
    if model.dtype != torch.bfloat16 or den.blend is None:
        raise AssertionError("flagship did not load as bf16 + blend")

    # ---- phase 3: each kernel against its plain version, main-path shapes
    # (b8 @ 256²: level 0 is 256², level 1 is 128²)
    unit_shapes = [("encoder_0_0", 0, 8, 256, 256),
                   ("encoder_1_0", 1, 8, 128, 128)]
    band_shapes = [(8, 256, 256, 32), (8, 128, 128, 64)]
    errors = {"convnext_block": 0.0, "band_smooth": 0.0}
    for dtype, atol in ((torch.bfloat16, 0.05), (torch.float32, 1e-3)):
        for name, _, b, h, w in unit_shapes:
            x, wts, slope = unit_inputs(model, name, b, h, w, dtype, rng)
            got = pallas_convnext.convnext_block(x, slope=slope, **wts)
            ref = pallas_convnext.convnext_block_plain(x, slope=slope, **wts)
            torch.cuda.synchronize()
            diff = (got.float() - ref.float()).abs()
            err = float(diff.max())
            # bf16: the kernel sums the products in another order than the
            # plain matmuls, which can flip the final bf16 rounding; where
            # |out| >= 8 one bf16 ulp (0.0625) exceeds the 0.05 bar
            tol = torch.full_like(diff, atol)
            if dtype == torch.bfloat16:
                tol = torch.maximum(tol, bf16_ulp(ref))
            n_over = int((diff > atol).sum())
            log("check", kernel="convnext_block", unit=name,
                shape=list(x.shape), dtype=str(dtype), max_abs_err=err,
                tolerance=(f"max({atol}, 1 bf16 ulp of the plain output)"
                           if dtype == torch.bfloat16 else str(atol)),
                n_over_atol=n_over, n_elements=diff.numel())
            if not bool((diff <= tol).all()):
                raise AssertionError(f"convnext_block {name} {dtype}: {err}")
            if dtype == torch.bfloat16:
                errors["convnext_block"] = max(errors["convnext_block"], err)
    for dtype in (torch.bfloat16, torch.float32):
        for shape in band_shapes:
            x = torch.from_numpy(rng.normal(0, 1, shape).astype(
                np.float32)).cuda().to(dtype)
            outs = pallas_pyramid.band_smooth(x, 2)
            refs = pallas_pyramid.band_smooth_plain(x, 2)
            torch.cuda.synchronize()
            err = max(float((o.float() - r.float()).abs().max())
                      for o, r in zip(outs, refs))
            if dtype == torch.float32:
                ok, tol = err <= 1e-5, "1e-5"
            else:
                ok = all(bool(((o.float() - r.float()).abs()
                               <= bf16_ulp(r)).all())
                         for o, r in zip(outs, refs))
                tol = "1 bf16 ulp"
                errors["band_smooth"] = max(errors["band_smooth"], err)
            log("check", kernel="band_smooth", shape=list(shape),
                dtype=str(dtype), max_abs_err=err, tolerance=tol)
            if not ok:
                raise AssertionError(f"band_smooth {shape} {dtype}: {err}")

    # ---- phase 4: serve three requests through the main path
    clean_b8 = synthetic_images(8, 256, 256, rng)
    noisy_b8 = add_noise(clean_b8, 25.0, rng)
    clean_512 = synthetic_images(1, 512, 512, rng)[0]
    noisy_512 = add_noise(clean_512, 25.0, rng)
    clean_bsd = synthetic_images(1, 321, 481, rng)[0]
    noisy_bsd = add_noise(clean_bsd, 25.0, rng)
    requests = [noisy_b8, noisy_512, noisy_bsd]

    pallas_convnext.launches = 0
    pallas_pyramid.launches = 0
    outs = [den(r) for r in requests]
    torch.cuda.synchronize()
    k1, k2 = pallas_convnext.launches, pallas_pyramid.launches
    log("serve", requests=[list(r.shape) for r in requests],
        convnext_block_launches=k1, band_smooth_launches=k2)
    if (k1, k2) != (10 * len(requests), 2 * len(requests)):
        raise AssertionError(f"expected 10 K1 + 2 K2 launches per forward, "
                             f"got {k1} and {k2} for {len(requests)}")
    for r, o in zip(requests, outs):
        if o.shape != r.shape or o.dtype != np.uint8:
            raise AssertionError(f"bad output {o.shape} {o.dtype}")
    mae_noisy = float(np.abs(noisy_b8.astype(np.float32) - clean_b8).mean())
    mae_out = float(np.abs(outs[0].astype(np.float32) - clean_b8).mean())
    cpu = bidt.load_model(FLAGSHIP, device="cpu", dtype="float32")
    ref = cpu(noisy_b8[0])
    diff = np.abs(outs[0][0].astype(np.int32) - ref.astype(np.int32))
    quality = dict(mae_noisy=mae_noisy, mae_out=mae_out,
                   bf16_card_vs_f32_cpu_mean=float(diff.mean()),
                   bf16_card_vs_f32_cpu_p99=float(np.percentile(diff, 99)),
                   bf16_card_vs_f32_cpu_max=int(diff.max()))
    log("quality", **quality)
    if not mae_out < mae_noisy:
        raise AssertionError("denoised output is not closer to the clean "
                             "images than the noisy input")
    if not (quality["bf16_card_vs_f32_cpu_mean"] <= 1.0
            and quality["bf16_card_vs_f32_cpu_p99"] <= 3):
        raise AssertionError(f"bf16 card output drifts from the f32 CPU "
                             f"reference: {quality}")

    # ---- phase 5: timing
    entries = {}
    for name, level, b, h, w in unit_shapes:
        x, wts, slope = unit_inputs(model, name, b, h, w, torch.bfloat16,
                                    rng)
        c, k = x.shape[-1], wts["dw"].shape[-1]
        # per forward: the encoder's and the decoder's units at this level
        per_fwd = 2 * model.backbone.widths[level]
        t = dict(
            ms=cuda_ms(lambda: pallas_convnext.convnext_block(
                x, slope=slope, **wts)),
            plain_ms=cuda_ms(lambda: pallas_convnext.convnext_block_plain(
                x, slope=slope, **wts), iters=5),
            library_ms=cuda_ms(lambda: convnext_library(x, slope=slope,
                                                        **wts)))
        bound, by = convnext_bound_ms(b, h, w, c, k, torch.bfloat16)
        log("time", kernel="convnext_block", C=c, K=k, shape=[b, h, w, c],
            dtype="bf16", calls_per_forward=per_fwd, bound_ms=bound,
            bound_by=by, **t)
        entries.setdefault("convnext_block", []).append(
            (per_fwd, t, bound, by))
    for shape in band_shapes:
        x = torch.from_numpy(rng.normal(0, 1, shape).astype(
            np.float32)).cuda().to(torch.bfloat16)
        t = dict(ms=cuda_ms(lambda: pallas_pyramid.band_smooth(x, 2)),
                 plain_ms=cuda_ms(lambda: pallas_pyramid.band_smooth_plain(
                     x, 2), iters=5),
                 library_ms=cuda_ms(lambda: band_smooth_library(x, 2)))
        bound, by = band_bound_ms(*shape, 2, torch.bfloat16)
        log("time", kernel="band_smooth", shape=list(shape), dtype="bf16",
            calls_per_forward=1, bound_ms=bound, bound_by=by, **t)
        entries.setdefault("band_smooth", []).append((1, t, bound, by))

    def serve_s(req, n):
        den(req)
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            den(req)
            times.append(time.perf_counter() - t0)
        return times

    b8_times = serve_s(noisy_b8, 10)
    lat_512 = serve_s(noisy_512, 10)
    xb8 = torch.from_numpy(noisy_b8).cuda().float().permute(0, 3, 1, 2)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(xb8), iters=10)
    serving = dict(
        b8_256_images_per_s=8 / statistics.median(b8_times),
        b8_256_request_ms=[round(t * 1e3, 3) for t in b8_times],
        b8_256_forward_ms=fwd_ms,
        latency_512_ms_median=statistics.median(lat_512) * 1e3,
        latency_512_ms=[round(t * 1e3, 3) for t in lat_512])
    log("serving", dtype="bf16", blend=True, smi=smi, **serving)

    # where one b8 @ 256² request spends device time, by kernel and by
    # the Denoiser's own stage ranges (denoiser.*)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            den(noisy_b8)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    def device_us(evt, kind):   # kind: "self_" or "" (torch < 2.4: cuda)
        us = getattr(evt, f"{kind}device_time_total", None)
        return us if us is not None else getattr(evt, f"{kind}cuda_time_total")

    rows = []
    stages = {}
    for evt in prof.key_averages():
        if evt.key.startswith("denoiser."):
            # the CPU range carries its host time and its kernels' device
            # time; its device-side twin is a span, not kernel time
            if evt.device_type == torch.autograd.DeviceType.CPU:
                stages[evt.key] = dict(
                    host_ms=evt.cpu_time_total / evt.count / 1e3,
                    device_ms=device_us(evt, "") / evt.count / 1e3)
            continue
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        rows.append((device_us(evt, "self_"), evt.count, evt.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    groups = {"convnext_block (K1)": ("convnext_block_kernel",),
              "band_smooth (K2)": ("band_smooth_kernel",),
              "convolutions (cuDNN)": ("fprop", "conv", "implicit_gemm",
                                       "cudnn"),
              "reductions": ("reduce_kernel",),
              "sort (blend median)": ("sort", "radix", "scan"),
              "matmul (attention)": ("gemm", "gemv")}
    by_group = {}
    for us, _, key in rows:
        group = next((g for g, pats in groups.items()
                      if any(p in key.lower() for p in pats)),
                     "other elementwise")
        by_group[group] = by_group.get(group, 0.0) + us / 3
    if args.profile_out is not None:
        args.profile_out.parent.mkdir(parents=True, exist_ok=True)
        with open(args.profile_out, "w") as f:
            f.write(f"{smi}\n3 requests of b8 @ 256^2 bf16 blend; wall "
                    f"{wall_us:.1f} us, device busy {busy:.1f} us\n")
            for key, st in stages.items():
                f.write(f"stage {key}: per request host {st['host_ms']:.3f} "
                        f"ms, device {st['device_ms']:.3f} ms\n")
            for us, count, key in rows:
                f.write(f"{us:12.1f} us {count:6d}x  {key}\n")
    log("profile", requests=3, wall_us=wall_us, device_busy_us=busy,
        idle_share_profiled=(1 - busy / wall_us) if busy else None,
        idle_share_unprofiled=(1 - busy / 3 / statistics.median(b8_times)
                               / 1e6) if busy else None,
        device_us_per_request=by_group, stages_per_request=stages,
        top=[dict(us=round(us, 1), count=c, name=k[:80])
             for us, c, k in rows[:12]])

    # ---- result lines
    replaces = {
        "convnext_block": ("blind_image_denoising_torch/csrc/"
                           "convnext_block.cu",
                           "blind_image_denoising_tpu/ops/pallas_convnext.py"
                           ":196"),
        "band_smooth": ("blind_image_denoising_torch/csrc/band_smooth.cu",
                        "blind_image_denoising_tpu/ops/pallas_pyramid.py"
                        ":165"),
    }
    launches = {"convnext_block": k1, "band_smooth": k2}
    kernels = []
    for name, rows_k in entries.items():
        # one b8 @ 256² forward's worth of calls, summed over its shapes
        total = lambda key: sum(n * t[key] for n, t, _, _ in rows_k)  # noqa
        bound = sum(n * bd for n, _, bd, _ in rows_k)
        bound_by = max(rows_k, key=lambda r: r[0] * r[2])[3]
        kernels.append(dict(
            name=name, route="cuda", source=replaces[name][0],
            replaces=replaces[name][1], launches=launches[name],
            max_abs_err=errors[name], ms=total("ms"),
            plain_ms=total("plain_ms"), bound_ms=bound, bound_by=bound_by,
            library_ms=total("library_ms")))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
