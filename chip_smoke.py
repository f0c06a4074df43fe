#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``blind_image_denoising_torch``) on one
NVIDIA GPU: build the hand-written CUDA kernels from the checkout, hold
each against its plain PyTorch version at the main paths' shapes, then
drive the two paths of the port through the entry points a user calls:

* serve: the packaged flagship ``unet_laplacian_v6_tpu_scratch`` through
  ``load_model`` (bf16, adaptive blend on), three requests;
* inference: the JAX ``Denoiser``'s whole surface on the flagship —
  TTA (8 members on 512², 4 on b8 @ 256², equivariance), tiling (the
  resnet tiled against untiled, a 2160×3840 frame with its peak memory),
  ``float_forward``'s input gradient against the CPU (with its spread
  over seeds and sizes), ``dispatch`` under
  ``torch.cuda.set_sync_debug_mode("error")``, ``BatchingDenoiser`` with
  64 clients at pipeline depth 1 and 2 (answers against each image
  alone, then a steady-state window), and ``evaluate.noise_sweep``;
  then every K1 / K2 / K2-backward shape the phase launched against the
  plain versions;
* train: the flagship's train step (``unet_laplacian_v6_tpu`` config,
  the packaged weights, bf16 compute) through ``build_train_step`` on
  b16 @ 128² with the noise kernel on — first one injected batch
  against the port's float32 CPU loss and gradients, then 3 warm-up and
  20 timed steps and 3 profiled ones;
* benchmarking: the port's ``benchmarking`` module (``bench.py``'s
  protocol): ``time_chain_slope`` over K = 5, 15, 30 chained
  applications with 5 repeats and ``roofline_check`` against
  ``cost_bytes`` of one application, for K1 (32, 3) alone on 8×256²
  bf16, the flagship served b8 @ 256² and the train step b16 @ 128²;
  fails where K1's row reads ``ok: false``;
* fused: ``unet_laplacian_v6`` at full width from a seeded init, bf16,
  through ``inference/fused.py``: ``calibrate_fused`` on 8 images (4
  clean, 4 at σ = 25), then the float and the int8 fused forwards and
  the standard bf16 hydra on b32 @ 256², with launch counts, every K1
  launch of the fused forwards against its plain version on the same
  input, the fused outputs against the hydra's, the f32 fused forward
  against the same forward on the CPU, and the three timed;
* fused_depth4: the same fused path at a depth-4 ``unet_laplacian_v6``
  (the config's filters 32, width 3 and K = 5, the depth set to 4, so
  its attention level is level 3 at C = 256; seeded, bf16) with
  ``fused_levels=(0, 1, 2)``: calibrated at those levels, float and
  int8 fused forwards and the bf16 hydra on b32 @ 256², 18 K1 a fused
  forward with 6 at (128, 5), every launch against its plain version,
  the fused phase's bars (``FUSED4_INT8_OWN_MARGIN`` for int8), the
  forwards timed, and K1 int8 at (128, 5) on 32×64²×128 timed;
* fused_widths: the same fused path at three depth-5
  ``unet_laplacian_v6`` (seeded, bf16): the config's widths (level 3 at
  C = 256, K1's wide class) and ``filters_level_multiplier`` 1.5
  (C = 32, 48, 72, 108: K1's padded classes) with
  ``fused_levels=(0, 1, 2, 3)`` on b32 @ 256², 24 K1 a fused or hydra
  forward, 6 at each level's (C, 5); without self-attention (level 4 at
  C = 512, a cluster of 4 blocks) with every level fused on b8 @ 256²,
  27 K1 a forward, 3 at (512, 5); and that model at depth 6 (level 5 at
  C = 1024, a cluster of 8) with every level fused on b8 @ 256², 33 K1 a
  forward, 3 at (1024, 5); and that model at depth 7 (level 6 at
  C = 2048, K1's general route: three kernels through scratch) on b8 @
  256², 39 K1 a forward, 3 at (2048, 5); no unit on its PyTorch branch,
  the fused_depth4 phase's bars, and each model's float32 fused forward
  counted by (C, K); then K1 off the (C, K) of its own timed
  (``FUSEDW_K1_ROWS``, the general route's (2048, 5) in every mode and
  (32, 9) 8×256² bf16 among them) and the general route at (512, 5) and
  (1024, 5) as a reading beside the clusters
  (``FUSEDW_GENERAL_READINGS``);
* wider_shapes: the multiplier-1.5 depth-5 v6 trained in bf16 at
  b16 @ 128² with K3 and Adam (one batch against the port's f32 CPU step
  at the train phase's bars, then 6 steps with exact launches, K2's
  backward at C = 108, no whole 16-byte vectors, once a step), and the
  bf16 hydra of a v6 whose kernel sizes are 7 at b8 @ 256² (12 K1 a
  forward, 6 each at (32, 7) and (64, 7), no unit on its branch; its f32
  forward card vs CPU); every kernel input of both against the plain
  versions, K2's backward at C = 108 and K1 at K = 7 timed; then K1's
  general route through the wrapper at the card tests' shapes
  (``GENERAL_CHECKS``: C above 1024, K = 9 and 11, E = 2C and 3C) in
  every mode against its plain version, each launch counted;
* band_split: the decimating band split (K4) through its op, the only
  entry point it has, at the flagship's level-0/1 band shapes 8×256²×32
  and 8×128²×64 and at 8×32²×108 (C of no whole 16-byte vectors; the
  build line holds its tile plan, registers and spills against
  ``pallas_pyramid.split_tile_plan``);
* train_loop: ``train_loop`` on 24 seeded 480×640 scenes written as PNG
  files (decoded natively, by PIL, or, with neither, the synthetic
  stream), the ``unet_laplacian_v6_tpu`` config at its shipped widths
  (b4 × 8 micro-batches of 256² crops, bf16) with the overrides of
  ``LOOP_OVERRIDES``: 6 steps fine-tuned from the packaged flagship
  artifact, then resumed on the same checkpoint directory to 8 — the
  restored state against the step-6 checkpoint bit for bit, the EMA not
  re-seeded, one injected batch's loss on the saved and the restored
  state, ``metrics.jsonl`` (steps 1–8, the schedule's learning rate, the
  noise sweeps at steps 3 and 6), exact launch counts per step and per
  sweep, no synchronizing call inside a step
  (``torch.cuda.set_sync_debug_mode("warn")``), steps/s, the profiled
  step's idle share and the host pipeline's decode rate; then every K1 /
  K2 / K2-backward / K3 input the legs launched against the plain
  versions, and the loop's kernel shapes timed;
* artifacts: the two other packaged artifacts through ``load_model`` —
  ``resnet_depthwise_scratch`` in bf16 and ``unet_laplacian_v56_highnoise``
  in float32 and in int8 (``quant=True``) — on b8 @ 256² and one 512²
  image, against the port's f32 CPU output, every int8 conv site's
  accumulator against an int64 computation on the host, timed and
  profiled (no K1–K4 launch: JAX runs both models in XLA);
* export: the train_loop phase's run (the flagship config at its shipped
  width, EMA 0.999, 8 steps) through ``export_model(quantize=True,
  test_model=True)``: ``params.msgpack`` against the checkpoint's EMA bit
  for bit, ``load_model`` of the artifact on b8 @ 256² and one 512² in
  bf16 (10 K1 and 2 K2 per forward) against the same artifact in f32 on
  the CPU, the card's ``quant.msgpack`` against the CPU's calibration,
  ``quant=True`` serving (per site, no K1) against f32, the host-clock
  median of 10 requests, and the ``export`` and ``build`` CLIs as
  subprocesses (the CLI's params byte-equal, ``model_structure.json``
  equal to the hydra's param shapes); then every K1 / K2 input the phase
  launched against the plain versions;
* formats: the committed TFLite fixture
  (``tests/data/tflite_resnet_depthwise_scratch``, JAX's
  ``serialize_tflite`` of the packaged resnet) through ``load_model`` on
  the card with the port's own flatbuffer reader and executor, b8 @ 256²
  and one 481×321 image, against the executor on the CPU and against the
  native resnet's f32 forward, images/s beside the native resnet's; then
  the train_loop phase's run through ``export_model(...,
  to_torch_export=True)``, the ``torch.export`` program loaded on the
  card against the eager f32 hydra (1e-4 of max |y|, 10 K1 + 2 K2 a
  forward), its ms beside eager's, and every K1 / K2 input the program
  launched against the plain versions;
* resnet_train_export: the BatchNorm resnet config at its full width
  (filters 32, 6 layers, blocks 32/128/32, batches of 16 at 128² in 2
  micro-batches, f32): one step on the card against the same step on the
  CPU (loss, running statistics), 4 ``train_loop`` steps from a seeded
  init on the train_loop phase's scenes, ``export_model``, the exported
  ``batch_stats`` against the checkpoint's buffers bit for bit, and
  ``load_model`` serving b8 @ 256² (no K1–K4 launch: the resnet runs in
  PyTorch ops and its config takes the plain noise path);
* unet_laplacian_family: ``unet_laplacian_v4`` at its full width and
  shipped size (filters 32, depth 4, width 3, decoder K = 1, attention
  gates, Laplacian upsample, strided downsample; b4 × 8 micro-batches of
  256², f32): one f32 train step on the card against the CPU (loss, the
  gradient's cosine), 4 ``train_loop`` steps from a seeded init on the
  train_loop phase's scenes with a checkpoint and a noise sweep at step 4,
  ``export_model``, and ``load_model`` of the run in f32 and bf16 on
  b8 @ 256² and one 512² against the same artifact in f32 on the CPU;
  ``unet_laplacian_v3`` and ``_v5`` from the ``build`` CLI's seeded
  artifacts served b8 @ 256²; exact launches per forward (K1 at every
  unit, C = 32, 64 and 128, the decoders' at K = 1: 18 for v3 / v4, 12
  for v5; K2 per band split; no unit on its PyTorch branch,
  ``pallas_convnext.branch_units``) and per micro-batch (K2, its
  backward, K3; no K1); then every K1 / K2 / K2-backward / K3 input it
  launched against the plain versions, and K1 at (32, 1) and (64, 1) and
  at C = 128, (128, 5) and (128, 1) on 8×64²×128, timed;
* restoration: the blind-restoration recipe (``scripts/train_restoration.py``:
  ``unet_laplacian_v6_tpu`` at its full width, 128² crops, b16 × 8
  micro-batches, bf16, the degradation chain with the master gate 0.5,
  log-uniform noise on [1, 80], EMA 0.9995, cosine decay from 2e-4;
  ``RESTORE_OVERRIDES``): each deterministic op of the chain at fixed
  values on the card against the CPU at b16 @ 128² × 3 and timed; the
  chain's gate rates, hole rate and ranges over 64 draws on the card, its
  redrawn gates bit-exact and its noise-only samples the chain's own noise
  draw; the recipe's step from the packaged flagship without a sync
  (``torch.cuda.set_sync_debug_mode("error")``), its launches per
  micro-batch (K2 2, K2 bwd 2, no K3) and the device ms of its
  ``degradations.chain`` range; ``train_loop`` fine-tuning the packaged
  flagship for 6 steps on the train_loop phase's scenes (the cuts: steps
  and inputs) with exact launches and no sync in a step; ``export_model``
  and bf16 serving of the fine-tune (10 K1 + 2 K2 a forward) against the
  same artifact in f32 on the CPU; ``evaluate.degradation_sweep`` over the
  recipe's seven specs on the packaged evaluation images, the packaged
  flagship against the fine-tune, the card's ``apply_degradations``
  against the CPU's on each spec; then every K2 / K2-backward / K1 input
  it launched against the plain versions;
* unet_backbone: the classic ``unet`` at the JAX builder's defaults
  (filters 32, 3 levels, 1 layer, kernel 3, BatchNorm) with gates, sparse
  features and ``he_normal`` (``UNET_BACKBONE``; the resnet config's train
  and dataset sections): one f32 forward and backward in train mode card
  against CPU from the same seeded weights (loss, gradient cosine, running
  statistics), the ``build`` CLI's seeded artifact served through
  ``load_model`` at b8 @ 256² in f32 and bf16 against f32 on the CPU; no
  K1–K4 launch;
* distillation: the per-level-width flagship config at its shipped size
  (b4 × 8 × 256², bf16, the noise kernel) from a seeded init, distilled
  from the packaged v5.6 (f32, weight 1, gt_weight 0.5) with
  ``train.prune`` (``DISTILL_OVERRIDES``; the cut: 4 steps on the
  train_loop phase's scenes): the distilled step without a sync and its
  launches per micro-batch (K2 2, K2 bwd 2, K3 1, no K1), one f32
  micro-batch card against CPU, ``train_loop`` with exact launches, no
  sync in a step and ``distill/mae_loss`` in ``metrics.jsonl``, each
  epoch's checkpoint (params and EMA) equal to ``prune_params`` of what
  the loop pruned, bit for bit; ``export_model`` and bf16 serving (10 K1
  + 2 K2 a forward) against f32 on the CPU; the flagship as a bf16
  teacher (``build_teacher``) on b16 @ 128² (10 K1 + 2 K2) against the
  f32 flagship on the CPU; then every kernel input it launched against
  the plain versions;
* analysis: ``analysis.analyze`` of the f32 flagship on a noisy 128²
  crop of a packaged evaluation image, card against CPU, with each
  tool's exact launches (the net-bias map in forward mode: K2 on the
  primal and on the tangent, no K2 backward, no K1), and the ``analyze``
  CLI on the bf16 flagship;
* layers_breadth: the resnet config at full width with ``selector_params``
  (its defaults, and GLOBAL / SOFT): one f32 train-mode step card
  against CPU, then served f32 at b8 @ 256²; ``SqueezeExcite``,
  ``GatedMLP``, ``ValueCompressor`` and ``NonLocalAttention`` (16 × 16)
  forward card against CPU; no K1–K4 launch;
* parallel: several processes of this script on the one card
  (``--parallel-worker``; each rank's failure or timeout fails the
  phase). Two gloo ranks (NCCL refuses two ranks on one device): the
  flagship's data-parallel step (``parallel.shard_train_step``, 2 × b8
  @ 128², full width, packaged weights, K3, drop-path on) against the
  single-process step on b16 in f32 (loss 1e-6 relative, every param
  1e-5 of its tensor's largest entry) and in bf16 (read), the ranks'
  params and each rank's K3 rows bit-equal to the single step's, K2 2,
  K2 bwd 2, K3 1 a rank; the 2160×3840 frame through
  ``Denoiser(mesh=…, spatial_margin=88)`` on 2 spatial ranks, the
  attention-free flagship config at full width from a seeded init, f32
  within 1e-3 gray levels of the unsharded forward and bf16 within §2's
  bar, each slab launching what one unsharded forward does, peak memory
  a rank; the packaged flagship sharded (read: its attention sees a
  slab). The spatially sharded step (``shard_train_step(spatial=True)``
  on a data 1 × spatial 2 mesh, the same config, b4 @ 512², each rank
  its slab of every crop) against the single-process step at the DP
  bars in f32 and read in bf16, the ranks' params and K3 outputs
  bit-equal, K2 2, K2 bwd 2, K3 1 a rank, each rank's ms and peak GiB
  beside the single step's. Then the train CLI as 2 gloo ranks
  (``--coordinator-address``) on the train_loop phase's config and
  scenes (8 steps from the artifact, a resume to 12): rank 0 alone
  writes checkpoints and ``metrics.jsonl``, the ranks end bit-equal,
  the restore is bit for bit, K2 16, K2 bwd 16, K3 8 a step at the
  local b2, the syncs in a gloo step, steps/s and rank 0's profiled
  idle share (read); and one
  NCCL rank alone, 6 steps with ``set_sync_debug_mode("error")`` inside
  each; and the CLI as 2 gloo ranks with ``tpu.mesh: {spatial: 2,
  spatial_training: true}`` (5 steps from the artifact, a resume to 7,
  a sweep at 7) under the DP loop's checks, with its steps/s.
  Every kernel input the ranks launched against the plain versions
  (rank 0);

check what comes out, and time the kernels and the paths (K1 also in
its float32 I/O mode, which serves ``load_model(dtype="float32")``: one
f32 request's launches, then its rows). Each kernel row is timed warm
(20 calls on one set of inputs, which may stay in the 50 MB L2) and cold (``cold_ms``: the calls rotate over copies of the
inputs that move twice the L2 between two uses of one copy), and held
against its bound: the bytes it must move over the memory rate or the
operations it must do over their peak rate, whichever is larger
(``convnext_bound_ms``, ``band_bound_ms``, ``noise_bound_ms``).

    python3 chip_smoke.py [--profile-out FILE] [--keep-export DIR]
                          [--keep-family DIR] [--keep-distill DIR]
                          [--dump-train-check DIR]

Imports only the port, torch and numpy; images are synthetic, made from
a seed. Any failed check raises, so the exit code is nonzero and the
final line is not printed. Without a CUDA device it exits 1 at once.
Output: one line per phase; then a ``{"kernels": [...]}`` JSON line, the
``nvidia-smi`` name and power limit, and, last, the
``{"ok": true, "device": ...}`` line. ``--profile-out FILE`` also writes
the full per-kernel device-time tables of the profiled serving requests,
train steps, v6 forwards and artifact requests (torch.profiler) to FILE.
``--keep-export``, ``--keep-family``, ``--keep-distill`` and
``--dump-train-check`` keep an artifact and its batch, or
``train_check``'s batch, for the CPU cross-checks
``tests/export_int8_gap.py``, ``tests/family_bf16_gap.py``,
``distill_bf16_gap.py`` and ``tests/train_check_cosine.py``.
The TF32 flags are PyTorch's defaults from the serving phase on, as a
user runs the library; only the kernel checks hold TF32 off.
"""

import argparse
import contextlib
import faulthandler
import json
import statistics
import struct
import subprocess
import sys
import threading
import time
import zlib
from pathlib import Path

import copy

import numpy as np
import torch
import torch.nn.functional as F

# the card's peak rates and the counts of each kernel's work, one formula
# for the port and this script (the port imports no JAX)
from blind_image_denoising_torch.benchmarking import (  # noqa: F401
    FP32_OPS_PER_S, H100_HBM_BYTES_PER_S as HBM_BYTES_PER_S, SASS_RATES,
    SM_CLOCKS_PER_S, TENSOR_BF16_OPS_PER_S, TENSOR_TF32_OPS_PER_S,
    band_bound_ms, convnext_bound_ms, cost_bytes, noise_bound_ms,
    roofline_check, time_chain_slope)

FLAGSHIP = "unet_laplacian_v6_tpu_scratch"
TRAIN_CONFIG = "unet_laplacian_v6_tpu"
TRAIN_BATCH, TRAIN_SIZE = 16, 128          # the JAX bench's train protocol
FUSED_CONFIG = "unet_laplacian_v6"
FUSED_BATCH, FUSED_SIZE = 32, 256          # scripts/bench_fused_e2e.py's
# the fused phase's bars, in mean gray levels, each set from the readings
# in PERF.md: the card's f32 float fused forward against the same forward
# on the CPU (on FUSED_CPU_IMAGES images), and the bf16 float fused
# forward against the bf16 hydra
FUSED_CPU_IMAGES = 2
FUSED_F32_CARD_VS_CPU_MEAN = 1e-3
FUSED_FLOAT_VS_HYDRA_MEAN = 2.0
ARTIFACT_RESNET = "resnet_depthwise_scratch"
ARTIFACT_V56 = "unet_laplacian_v56_highnoise"
# kernel groups of the artifacts' requests (profiler names, lower case)
ARTIFACT_GROUPS = {
    "convolutions (cuDNN)": ("fprop", "conv", "implicit_gemm", "cudnn",
                             "xmma", "depthwise"),
    "matmul (attention)": ("gemm", "gemv", "cutlass"),
    "softmax": ("softmax",),
    "reductions": ("reduce_kernel",),
    "batch norm and elementwise": ("elementwise", "vectorized"),
}
SEED = 0
# K1 float32 against its plain version: besides max |diff| <= 1e-3, max
# |diff| <= this times max |plain output| (3xTF32 keeps float32 accuracy:
# about 1e-6 of it in a CPU emulation of the split)
K1_F32_RELATIVE = 1e-5
L2_BYTES = 50 * 2**20            # H100 SXM L2 cache


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3, inputs=None) -> float:
    """Mean device milliseconds per call of ``fn`` (CUDA events). The
    calls are queued behind a spin kernel that outlasts their launches,
    so they run back to back and the events time the device, not the
    host's launch rate (a small kernel launched from Python finishes
    before the next launch arrives). With ``inputs`` (argument tuples,
    from :func:`cold_copies`) call ``i`` runs ``fn(*inputs[i % n])``, so
    each call finds its inputs out of the L2; without, every call reuses
    the same tensors, which may sit in the L2 from the call before."""
    args = (lambda i: ()) if inputs is None else (
        lambda i: inputs[i % len(inputs)])
    for i in range(warmup):
        fn(*args(i))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*args(i))
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * 2e9) + 1_000_000)   # ~2x the launches
    start.record()
    for i in range(iters):
        fn(*args(i))
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_copies(*tensors):
    """Copies of ``tensors`` to rotate through with ``cuda_ms(inputs=)``:
    enough sets that the ones between two uses of a set move at least
    twice the 50 MB L2, so every call reads its inputs from DRAM."""
    set_bytes = sum(t.numel() * t.element_size() for t in tensors)
    n = 2 + -(-2 * L2_BYTES // set_bytes)
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def forward_event_ms(fn, n=10, warmup=2):
    """Median of n CUDA-event times of whole forwards, host included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


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
    h = F.leaky_relu(F.linear(t, w2.to(x.dtype)), slope)
    return x + gain.to(x.dtype) * F.linear(h, w3.to(x.dtype))


def convnext_int8_library(xq, s_in, s_out, dw, ln_scale, w2, w3, gain,
                          slope):
    """The int8 unit from PyTorch library calls: dequantize to bf16, the
    float chain of :func:`convnext_library`, quantize (the yardstick)."""
    x = xq.to(torch.bfloat16) * torch.tensor(s_in, dtype=torch.bfloat16)
    out = convnext_library(x, dw, ln_scale, w2, w3, gain, slope)
    return torch.round(out.float() * (1.0 / s_out)).clamp(-127, 127).to(
        torch.int8)


def band_split_library(x, k):
    """Count-aware F.avg_pool2d, subtract and even-pixel slice (the
    yardstick of K4)."""
    band, smooth = band_smooth_library(x, k)
    return band, smooth[:, ::2, ::2].contiguous()


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


def k1_instantiations(lib, pallas_convnext):
    """Shared memory, registers, spill bytes, threads per block, resident
    blocks per SM, cluster size, the clusters (blocks of the one-block
    layouts) the card holds at once, the layout's width and the stages of
    its weight ring (0: none) of the K1 instantiation that
    runs each (C, K) of ``pallas_convnext.SAMPLE_SHAPES`` (the twelve of
    their own and every class at widths that are and are not multiples of
    16), from the library (``bid_convnext_block_info``). An instantiation
    that spills, differs from ``kernel_plan`` (its resident blocks fewer
    than the plan's ``min_blocks_per_sm``), fits no cluster on the card or
    is laid out at another width than ``class_width`` (the width the
    wrapper pads the weights to) fails. The same for the general route's
    instantiations at each (C, K, E) of
    ``pallas_convnext.GENERAL_SAMPLE_SHAPES`` (the largest shared memory,
    registers and spills of its three kernels; its plan
    ``general_plan``: cluster 1, width C, no ring); a (C, K) of
    SAMPLE_SHAPES reported with that signature fails too (its one-pass
    route kept)."""
    import ctypes
    out = []
    shapes = [(c, k, 4 * c) for c, k in pallas_convnext.SAMPLE_SHAPES] + \
        list(pallas_convnext.GENERAL_SAMPLE_SHAPES)
    for dtype, code in pallas_convnext._DTYPE_CODES.items():
        for c, k, e in shapes:
            vals = (ctypes.c_int * 9)()
            rc = lib.bid_convnext_block_info(c, k, e, code, vals)
            if rc != 0:
                raise AssertionError(f"K1 info {dtype} ({c}, {k}, {e}): "
                                     f"{rc}")
            general = pallas_convnext.runs_general(c, k, e)
            out.append(dict(zip(
                ("smem_bytes", "registers", "local_bytes",
                 "threads_per_block", "blocks_per_sm", "cluster_size",
                 "active_clusters", "width", "ring_stages"), vals),
                dtype=str(dtype).split(".")[-1], C=c, K=k,
                **({"E": e, "route": "general"} if general else {})))
            if out[-1]["local_bytes"] > 0:
                raise AssertionError(f"K1 instantiation spills: {out[-1]}")
            if out[-1]["active_clusters"] < 1 or out[-1]["blocks_per_sm"] < 1:
                raise AssertionError(f"K1 instantiation fits no cluster: "
                                     f"{out[-1]}")
            plan = dict(pallas_convnext.kernel_plan(c, k, dtype, e))
            plan.pop("chunk_channels", None)
            plan.setdefault("ring_stages", 0)
            if out[-1]["blocks_per_sm"] < plan.pop("min_blocks_per_sm", 1) \
                    or any(out[-1][key] != want for key, want in plan.items()) \
                    or out[-1]["width"] != pallas_convnext.class_width(
                        c, dtype, k, e):
                raise AssertionError(f"K1 built as {out[-1]}, planned as "
                                     f"{plan}")
            signature = [out[-1][key] for key in (
                "smem_bytes", "cluster_size", "width", "ring_stages")]
            if not general and signature == [pallas_convnext.general_plan(
                    c)["smem_bytes"], 1, c, 0]:
                raise AssertionError(f"K1 ({c}, {k}) reported as the "
                                     f"general route: {out[-1]}")
    return out


# K2 backward's inputs on the paths: the train step's two levels (b16 @
# 128²), the f32 float_forward gradients at 128² and 256², and the
# training loop's micro-batch levels (b4 @ 256²)
BWD_PATH_SHAPES = [(TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 32),
                   (TRAIN_BATCH, TRAIN_SIZE // 2, TRAIN_SIZE // 2, 64),
                   (1, 128, 128, 32), (1, 64, 64, 64), (1, 256, 256, 32),
                   (1, 128, 128, 64), (4, 256, 256, 32), (4, 128, 128, 64)]


# K4's inputs: the band_split phase's two shapes, checked in bf16 and f32
SPLIT_PATH_SHAPES = [(8, 256, 256, 32), (8, 128, 128, 64)]


def band_tile_plans(what, info, plan_of, shapes, codes):
    """A band kernel's tile, shared memory, registers, spill bytes and
    resident blocks per SM at every shape in bf16 and f32 (``codes``), from
    the library's ``info`` entry point (``bid_band_smooth_bwd_info``,
    ``bid_band_split_info``), with window 2. A plan that spills or differs
    from the Python mirror ``plan_of`` (``pallas_pyramid.bwd_tile_plan``,
    ``split_tile_plan``) fails."""
    import ctypes
    out = []
    for dtype, code in codes.items():
        for b, h, w, c in shapes:
            vals = (ctypes.c_int * 9)()
            rc = info(h, w, c, 2, code, vals)
            if rc != 0:
                raise AssertionError(f"{what} info {dtype} {(b, h, w, c)}: "
                                     f"{rc}")
            got = dict(zip(("tile_w", "tile_h", "threads_x", "threads_y",
                            "smem_bytes", "registers", "local_bytes",
                            "blocks_per_sm"), vals))
            out.append(dict(got, dtype=str(dtype).split(".")[-1],
                            shape=[b, h, w, c]))
            plan = plan_of(b, h, w, c, 2, dtype)
            if got["local_bytes"] > 0 or any(
                    got[key] != plan[key] for key in got if key in plan):
                raise AssertionError(f"{what} built as {got}, planned as "
                                     f"{plan}")
    return out


def sass_class(op):
    """The unit a SASS opcode issues to: "uniform" (once per warp, on the
    uniform datapath), "mufu_or_convert", "float", "integer", or "other"
    (memory, control, barriers), which take an issue slot only."""
    base = op.split(".")[0]
    if base.startswith("U"):
        return "uniform"
    if base == "MUFU" or base in ("F2I", "I2F", "F2F", "FRND", "F2FP"):
        return "mufu_or_convert"
    if base[0] == "F" or base.startswith("H"):
        return "float"
    if base in ("BRA", "BSSY", "BSYNC", "EXIT", "CALL", "RET", "BAR", "NOP",
                "WARPSYNC", "DEPBAR") or base[:2] in ("LD", "ST") \
            or base in ("S2R", "S2UR", "CS2R"):
        return "other"
    return "integer"


def sass_element_paths(sass, per_iteration):
    """Instructions per element of a kernel whose thread handles
    ``per_iteration`` elements once, from its SASS (``cuobjdump -sass``).
    The body is the whole function from its first instruction to its
    last ``EXIT`` (an earlier unpredicated ``EXIT`` is not a way
    through); it is a DAG once back edges are dropped. A
    fast path avoids calls, local memory and float64 (the out-of-range
    branches of ``sqrtf`` and ``sincosf``, which the kernel's arguments
    never take). Returns, for each k, the class counts per element of the
    shortest fast path through the body that executes exactly
    k · ``per_iteration`` MUFU instructions (one per Box-Muller normal: k
    = 2 for a sample with both noises on, 1 with one, 0 with none)."""
    import re
    ins = []
    for line in sass.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)\s*([^;]*);", line)
        if m:
            ins.append((int(m.group(1), 16), bool(m.group(2)), m.group(3),
                        m.group(4)))
    at = {a: i for i, (a, *_) in enumerate(ins)}

    def target(i):
        m = re.match(r"0x([0-9a-f]+)", ins[i][3].strip())
        return int(m.group(1), 16) if m else None

    head = 0
    tail = max(i for i, (_, _, op, _) in enumerate(ins) if op == "EXIT")
    inf = float("inf")
    # best[i][k]: (instructions, path) from i to the end of the body
    best = [None] * (tail + 2)
    best[tail + 1] = {0: (0, ())}
    for i in range(tail, head - 1, -1):
        _, pred, op, _ = ins[i]
        base = op.split(".")[0]
        if base in ("CALL", "LDL", "STL") or base[0] == "D" or (
                base == "EXIT" and i < tail and not pred):
            best[i] = {}
            continue
        succ = []
        t = target(i) if base == "BRA" else None
        if i == tail:
            succ = [tail + 1]
        elif t is not None and t > ins[i][0]:
            succ = [at[t] if t in at and at[t] <= tail else tail + 1]
            if pred:
                succ.append(i + 1)
        else:                       # a back edge is not taken
            succ = [i + 1]
        mufu = int(base == "MUFU")
        best[i] = {}
        for j in succ:
            for k, (cost, path) in best[j].items():
                kk = k + mufu
                if cost + 1 < best[i].get(kk, (inf,))[0]:
                    best[i][kk] = (cost + 1, (i,) + path)
    out = {}
    for k, (cost, path) in best[head].items():
        if k % per_iteration:
            continue
        counts = {"issue": cost}
        for i in path:
            c = sass_class(ins[i][2])
            counts[c] = counts.get(c, 0) + 1
        out[k // per_iteration] = {c: n / per_iteration
                                   for c, n in counts.items()}
    return out


def kernel_sass(obj, function):
    """SASS of one kernel of an object file, by ``cuobjdump``."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(obj)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    parts = text.split("Function : ")
    found = [p for p in parts[1:] if function in p.splitlines()[0]]
    if len(found) != 1:
        raise AssertionError(f"{function}: {len(found)} functions in {obj}")
    return found[0]


def sass_issue_ms(n_per_sample, flags, paths):
    """Diagnostic: the instructions that a kernel's SASS issues per
    element (``paths`` from :func:`sass_element_paths`, k = the sample's
    noises on), each class over its rate, in ms; None where the SASS has
    no path for some k."""
    per_class = {}
    for k in flags:
        if int(k) not in paths:
            return None
        for c, count in paths[int(k)].items():
            per_class[c] = per_class.get(c, 0) + count * n_per_sample
    return {c: per_class.get(c, 0) / (rate * SM_CLOCKS_PER_S) * 1e3
            for c, rate in SASS_RATES.items()}


def band_smooth_bwd_library(x, k, g_band, g_smooth):
    """The band-split backward through F.avg_pool2d's autograd: returns a
    function that runs only the backward of a recorded forward."""
    xg = x.detach().requires_grad_(True)
    outs = band_smooth_library(xg, k)
    return lambda: torch.autograd.grad(outs, xg, (g_band, g_smooth),
                                       retain_graph=True)


def device_us(evt, kind):
    """Device time of a profiler event; kind "self_" or "" (torch < 2.4:
    cuda_time)."""
    us = getattr(evt, f"{kind}device_time_total", None)
    return us if us is not None else getattr(evt, f"{kind}cuda_time_total")


def profile_rows(prof):
    """(device µs, count, name) of every CUDA kernel, largest first."""
    rows = [(device_us(evt, "self_"), evt.count, evt.key)
            for evt in prof.key_averages()
            if evt.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(rows, reverse=True)


def group_rows(rows, groups, per):
    out = {}
    for us, _, key in rows:
        group = next((g for g, pats in groups.items()
                      if any(p in key.lower() for p in pats)),
                     "other elementwise")
        out[group] = out.get(group, 0.0) + us / per
    return out


# --------------------------------------------------------------- training

def check_band_smooth_bwd(pallas_pyramid, rng, shapes):
    """K2's backward against its plain version, bit-exact in bf16 and
    f32 (the same float32 products summed in the same order); returns
    the largest bf16 error."""
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for shape in shapes:
            g_band, g_smooth = (torch.from_numpy(rng.normal(
                0, 1, shape).astype(np.float32)).cuda().to(dtype)
                for _ in range(2))
            got = pallas_pyramid.band_smooth_bwd(g_band, g_smooth, 2)
            ref = pallas_pyramid.band_smooth_bwd_plain(g_band, g_smooth, 2)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            if dtype == torch.bfloat16:
                worst = max(worst, err)
            log("check", kernel="band_smooth_bwd", shape=list(shape),
                dtype=str(dtype), max_abs_err=err, tolerance="0 (bit-exact)")
            if err != 0.0:
                raise AssertionError(f"band_smooth_bwd {shape} {dtype}: "
                                     f"{err}")
    return worst


def check_corrupt_noise(pallas_noise, x, noise_kw):
    """K3 against its plain version on the same seed, and its statistics
    on a constant batch; returns the largest unrounded error off the
    redraw threshold."""
    seed = 20260801
    got, params = pallas_noise.corrupt_noise(seed, x, round_values=False,
                                             return_params=True, **noise_kw)
    ref, ref_params = pallas_noise.corrupt_batch_plain(
        seed, x, round_values=False, return_params=True, **noise_kw)
    torch.cuda.synchronize()
    if not torch.equal(params, ref_params):
        raise AssertionError("corrupt_noise: per-sample flags or stds "
                             "differ from the plain version")
    # where a first normal lies within 1e-5 of ±2, the last bit of
    # logf/sincosf decides between the draw and its redraw
    z0_mul, _, z0_add, _ = pallas_noise.normal_draws_plain(
        seed, x.shape[0], x[0].numel(), x.device)
    edge = (((z0_mul.abs() - 2).abs() < 1e-5) & (params[:, :1] > 0)) | \
        (((z0_add.abs() - 2).abs() < 1e-5) & (params[:, 2:3] > 0))
    err = (got - ref).abs().reshape(x.shape[0], -1)
    worst = float(err[~edge].max())
    rounded = pallas_noise.corrupt_noise(seed, x, **noise_kw)
    diff = (rounded - pallas_noise.corrupt_batch_plain(
        seed, x, **noise_kw)).abs()
    share = float((diff > 0).float().mean())
    log("check", kernel="corrupt_noise", shape=list(x.shape),
        flags_and_stds_identical=True, max_abs_err_unrounded=worst,
        n_near_threshold=int(edge.sum()), max_abs_err_unrounded_all=float(
            err.max()), rounded_max_abs_err=float(diff.max()),
        rounded_share_differing=share,
        tolerance="unrounded 1e-3 off the threshold; rounded <= 1 on at "
                  "most 1e-4 of the elements")
    if worst > 1e-3 or float(diff.max()) > 1.0 or share > 1e-4:
        raise AssertionError(f"corrupt_noise disagrees with its plain "
                             f"version: {worst}, {float(diff.max())}, "
                             f"{share}")
    const = torch.full((64,) + tuple(x.shape[1:]), 128.0, device=x.device)
    y, p = pallas_noise.corrupt_noise(seed + 1, const, return_params=True,
                                      **noise_kw)
    res = (y - const).reshape(64, -1)
    mlo, mhi = noise_kw["multiplicative_noise"]
    alo, ahi = noise_kw["additive_noise"]
    bound = 2 * (128 * p[:, 1] * p[:, 0] + p[:, 3] * p[:, 2]) + 0.5
    stats = dict(mean=float(y.mean()), mul_share=float(p[:, 0].mean()),
                 add_share=float(p[:, 2].mean()),
                 mul_std_range=[float(p[:, 1].min()), float(p[:, 1].max())],
                 add_std_range=[float(p[:, 3].min()), float(p[:, 3].max())],
                 integer=bool(torch.equal(y, y.round())),
                 within_2_sigma=bool((res.abs().max(dim=1).values
                                      <= bound + 1e-3).all()))
    log("check", kernel="corrupt_noise", statistics_of=list(const.shape),
        **stats)
    if not (abs(stats["mean"] - 128.0) < 1.0 and stats["integer"]
            and stats["within_2_sigma"]
            and abs(stats["mul_share"] - 0.5) <= 0.15
            and abs(stats["add_share"] - 0.5) <= 0.15
            and mlo <= stats["mul_std_range"][0]
            and stats["mul_std_range"][1] <= mhi
            and alo <= stats["add_std_range"][0]
            and stats["add_std_range"][1] <= ahi):
        raise AssertionError(f"corrupt_noise statistics: {stats}")
    return worst


def build_trainer(cfg, params, dtype, device, drop=True):
    """The bench protocol's train step on ``device``: the flagship config,
    the given params, the noise kernel on (``tpu.pallas_noise``)."""
    from blind_image_denoising_torch.models.hydra import model_builder
    from blind_image_denoising_torch.training import (
        build_train_step, create_train_state, loss_function_builder,
        optimizer_builder)
    mc = copy.deepcopy(cfg["model"])
    if not drop:
        mc["backbone"].update(depth_drop_rate=0.0,
                              convolutional_self_attention_dropout_rate=0.0)
    hydra = model_builder(mc, dtype=dtype).hydra
    tx, _ = optimizer_builder(cfg["train"]["optimizer"])
    state = create_train_state(hydra, tx, seed=SEED, params=params,
                               device=device)
    ds = cfg["dataset"]
    step = build_train_step(
        hydra, tx, loss_function_builder(cfg["loss"]), hydra.no_outputs,
        additive_noise=ds["additional_noise"],
        multiplicative_noise=ds["multiplicative_noise"],
        random_left_right=ds.get("random_left_right", True),
        random_up_down=ds.get("random_up_down", True),
        round_values=ds.get("round_values", True), grad_accum=1,
        use_pallas_noise=cfg["tpu"]["pallas_noise"])
    return state, step


def train_card_vs_cpu(cfg, params, clean, noise_kw, card_dtype=torch.bfloat16,
                      loss_rtol=2e-2, min_cosine=0.99, phase="train_check",
                      dump=None):
    """One injected noisy batch, drop rates 0: the card's loss and
    gradients (bf16 by default) against the port's float32 CPU ones.
    ``dump``: a directory to write the batch into (``train_check.npz``:
    the clean batch, the noisy one, the noise seed), which
    ``tests/train_check_cosine.py`` reads. Returns the logged result."""
    from blind_image_denoising_torch.ops.multiscale import multiscale_targets
    from blind_image_denoising_torch.ops.pallas_noise import (
        corrupt_batch_plain)
    from blind_image_denoising_torch.ops.precision import exact_float32
    from blind_image_denoising_torch.training import (forward_loss,
                                                      loss_function_builder)
    clean = torch.from_numpy(clean).round()
    noisy = corrupt_batch_plain(SEED + 2, clean, **noise_kw)
    bb = cfg["model"]["backbone"]
    n_out = int(bb["depth"]) if bb.get("multiple_scale_outputs", True) else 1
    gt = multiscale_targets(clean, n_out - 1, clip_values=True,
                            round_values=True)
    fns = loss_function_builder(cfg["loss"])
    if dump is not None:
        dump.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(dump / "train_check.npz", clean=clean.numpy(),
                            noisy=noisy.numpy(), seed=SEED + 2)
    out = {}
    for dev, dtype in (("cuda", card_dtype), ("cpu", None)):
        state, _ = build_trainer(cfg, params, dtype, dev, drop=False)
        hydra = state.model
        # float32 parts without TF32, as the library's train step runs them
        with exact_float32(dev == "cuda"):
            total, _ = forward_loss(hydra, fns, hydra.no_outputs,
                                    noisy.to(dev), [g.to(dev) for g in gt],
                                    torch.full((n_out,), 1.0 / n_out,
                                               device=dev),
                                    torch.Generator(device=dev))
            total.backward()
        out[dev] = (float(total.detach()),
                    {n: p.grad.float().flatten().cpu()
                     for n, p in hydra.named_parameters()})
    rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    card, cpu = out["cuda"][1], out["cpu"][1]
    # in float64: a float32 sum over ~1e6 terms reads above 1
    cos = float(F.cosine_similarity(torch.cat(list(card.values())).double(),
                                    torch.cat(list(cpu.values())).double(),
                                    dim=0))
    per_tensor = sorted((float(F.cosine_similarity(
        card[n].double(), cpu[n].double(), dim=0)), n) for n in cpu)
    card = "bf16" if card_dtype == torch.bfloat16 else "f32"
    result = {"batch": list(noisy.shape), f"loss_{card}_card": out["cuda"][0],
              "loss_f32_cpu": out["cpu"][0], "loss_rel_diff": rel,
              "grad_cosine": cos,
              "n_grad": int(sum(v.numel() for v in cpu.values())),
              "lowest_tensor_cosines": [dict(name=n, cosine=c)
                                        for c, n in per_tensor[:5]],
              "tolerance": f"loss rel <= {loss_rtol}, grad cosine >= "
                           f"{min_cosine}"}
    log(phase, **result)
    if not (rel <= loss_rtol and cos >= min_cosine):
        raise AssertionError(f"{card} card train step drifts from the f32 "
                             f"CPU reference: {result}")
    return result


# --------------------------------------------------------------- artifacts

def artifacts_phase(bidt, rng, smi, acts, read_counts, zero_counts,
                    profile_text):
    """The two other packaged artifacts through ``load_model`` on the card:
    ``resnet_depthwise_scratch`` (bf16, its pipeline's dtype) at σ = 25,
    ``unet_laplacian_v56_highnoise`` in float32 (its default) and with
    ``quant=True`` at σ = 60. Each serves b8 @ 256² and one 512² image
    with no K1–K4 launch; card against the port's f32 CPU output on one
    256² image; denoised MAE against the noisy input's; every int8 conv
    site of one 256² request bit-exact against the int64 plain version
    on the host; images/s, 512² ms, launches, busy and idle share and the
    int8 conv route's device time per request."""
    from blind_image_denoising_torch.ops import quant
    clean_b8 = synthetic_images(8, 256, 256, rng)
    clean_512 = synthetic_images(1, 512, 512, rng)[0]
    runs = {"resnet_bf16": (ARTIFACT_RESNET, {}, 25.0),
            "v56_f32": (ARTIFACT_V56, {}, 60.0),
            "v56_int8": (ARTIFACT_V56, {"quant": True}, 60.0)}
    noisy = {sigma: (add_noise(clean_b8, sigma, rng),
                     add_noise(clean_512, sigma, rng))
             for sigma in {r[2] for r in runs.values()}}
    outs, report = {}, {}
    for name, (artifact, kw, sigma) in runs.items():
        den = bidt.load_model(artifact, **kw)
        b8, one = noisy[sigma]
        outs[name] = den(b8)
        out_512 = den(one)
        torch.cuda.synchronize()
        launches = read_counts()
        if launches != zero_counts():
            raise AssertionError(f"{name}: K1-K4 launched on a path that has "
                                 f"none: {launches}")
        for o, r in ((outs[name], b8), (out_512, one)):
            if o.shape != r.shape or o.dtype != np.uint8:
                raise AssertionError(f"{name}: bad output {o.shape} {o.dtype}")
        mae_noisy = float(np.abs(b8.astype(np.float32) - clean_b8).mean())
        mae_out = float(np.abs(outs[name].astype(np.float32)
                               - clean_b8).mean())
        q = dict(dtype=str(den.model.dtype or torch.float32), sigma=sigma,
                 mae_noisy=mae_noisy, mae_out=mae_out, kernel_launches=launches)
        if not kw.get("quant"):
            cpu = bidt.load_model(artifact, device="cpu", dtype="float32")
            diff = np.abs(outs[name][0].astype(np.int32)
                          - cpu(b8[0]).astype(np.int32))
            q.update(card_vs_f32_cpu_mean=float(diff.mean()),
                     card_vs_f32_cpu_p99=float(np.percentile(diff, 99)),
                     card_vs_f32_cpu_max=int(diff.max()),
                     card_vs_f32_cpu_equal_share=float((diff == 0).mean()))
        report[name] = (den, b8, one, q)

    # the bars
    r, v, i8 = (report[k][3] for k in ("resnet_bf16", "v56_f32", "v56_int8"))
    int8_vs_f32 = float(np.abs(outs["v56_int8"].astype(np.int32)
                               - outs["v56_f32"].astype(np.int32)).mean())
    i8["int8_vs_f32_card_mean"] = int8_vs_f32
    bars = dict(resnet_bf16="card vs f32 CPU mean <= 1.0, p99 <= 3; MAE "
                            "below the noisy input's",
                v56_f32="card vs f32 CPU max <= 1, >= 99% equal; MAE < 0.5x "
                        "the noisy input's",
                v56_int8="int32 accumulators bit-exact at every site; mean "
                         "|int8 - f32| <= 2.5; MAE below the noisy input's")
    failed = []
    if not (r["card_vs_f32_cpu_mean"] <= 1.0 and r["card_vs_f32_cpu_p99"] <= 3
            and r["mae_out"] < r["mae_noisy"]):
        failed.append("resnet_bf16")
    if not (v["card_vs_f32_cpu_max"] <= 1
            and v["card_vs_f32_cpu_equal_share"] >= 0.99
            and v["mae_out"] < 0.5 * v["mae_noisy"]):
        failed.append("v56_f32")
    if not (int8_vs_f32 <= 2.5 and i8["mae_out"] < i8["mae_noisy"]):
        failed.append("v56_int8")

    # every int8 site of one 256² request, card against the host in int64
    sites = []
    real = quant.int8_conv

    def recording(x8, k8, strides, padding, groups):
        y = real(x8, k8, strides, padding, groups)
        sites.append((x8.cpu(), k8.cpu(), y.cpu(), strides, padding, groups))
        return y

    quant.int8_conv = recording
    try:
        report["v56_int8"][0](report["v56_int8"][1][:1])
    finally:
        quant.int8_conv = real
    torch.cuda.synchronize()
    mismatched = [n for n, (x8, k8, y, st, pad, g) in enumerate(sites)
                  if y.dtype != torch.int32 or not torch.equal(
                      y.long(), quant.int8_conv_reference(x8, k8, st, pad, g))]
    i8.update(int8_sites=len(sites), int8_sites_bit_exact=len(sites) - len(
        mismatched), int8_macs_per_request=sum(
            int(y.numel()) * int(k8[0].numel()) for _, k8, y, *_ in sites))
    if mismatched or len(sites) != 55:
        failed.append("v56_int8 accumulators")

    # timing and a profiled request of each
    timing = {}
    for name, (den, b8, one, _) in report.items():
        times = {}
        for key, req in (("b8", b8), ("512", one)):
            den(req)
            torch.cuda.synchronize()
            t = []
            for _ in range(10):
                t0 = time.perf_counter()
                den(req)
                t.append(time.perf_counter() - t0)
            times[key] = t
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            den(b8)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = [row for row in profile_rows(prof)
                if not row[2].startswith(("denoiser.", "quant."))]
        busy = sum(row[0] for row in rows)
        int8_route = [device_us(evt, "") for evt in prof.key_averages()
                      if evt.key == "quant.int8_conv"
                      and evt.device_type == torch.autograd.DeviceType.CPU]
        timing[name] = dict(
            b8_256_images_per_s=8 / statistics.median(times["b8"]),
            b8_256_request_ms=[round(x * 1e3, 3) for x in times["b8"]],
            latency_512_ms_median=statistics.median(times["512"]) * 1e3,
            latency_512_ms=[round(x * 1e3, 3) for x in times["512"]],
            kernels_per_request=sum(row[1] for row in rows),
            device_busy_ms=busy / 1e3,
            idle_share_profiled=1 - busy / wall_us,
            idle_share_unprofiled=1 - busy / 1e6 / statistics.median(
                times["b8"]),
            int8_conv_route_device_ms=(sum(int8_route) / 1e3
                                       if int8_route else None),
            device_ms_by_group={k: us / 1e3 for k, us in group_rows(
                rows, ARTIFACT_GROUPS, 1).items()},
            top=[dict(us=round(us, 1), count=c, name=k[:80])
                 for us, c, k in rows[:8]])
        profile_text.append(f"\none b8 @ 256^2 request, {name}; wall "
                            f"{wall_us:.1f} us, device busy {busy:.1f} us\n")
        profile_text += [f"{us:12.1f} us {count:6d}x  {key}\n"
                         for us, count, key in rows]
    log("artifacts", smi=smi, bars=bars,
        quality={k: rep[3] for k, rep in report.items()}, timing=timing)
    if failed:
        raise AssertionError(f"artifacts phase failed: {failed}")


# ---------------------------------------------------------------- inference

def tile_patches(h, w, t):
    """Forwards a tiled Denoiser runs on an h×w image with tile_rows t:
    bands along the longer axis, each split once more along the other
    axis when that is still over t (``Denoiser._run_tiled``)."""
    if max(h, w) <= t:
        return 1
    n, other = (h, w) if h >= w else (w, h)
    return -(-n // t) * (-(-other // t) if other > t else 1)


class KernelInputs:
    """Within the block, records every distinct K1 / K2 / K2-backward / K3
    launch the port makes on the card: (shape, dtype, kernel size; K3:
    its noise ranges) with the first such call's weights (K1's without
    the operands its unit prepared from them). The layers and
    the train step import the wrappers by name, so the block wraps those
    names (and K2's backward, which its autograd Function looks up in
    ``ops/pallas_pyramid``); the wrapped call is the wrapper's own,
    counts included."""

    def __init__(self):
        import importlib
        from blind_image_denoising_torch.layers import convnext as layer
        from blind_image_denoising_torch.models import unet_laplacian
        from blind_image_denoising_torch.ops import pallas_pyramid
        step = importlib.import_module(
            "blind_image_denoising_torch.training.train_step")
        # (module, name, position of the input tensor)
        self._sites = [(layer, "convnext_block", 0),
                       (unet_laplacian, "band_smooth", 0),
                       (pallas_pyramid, "band_smooth_bwd", 0),
                       (step, "corrupt_noise", 1)]
        self.seen = {name: {} for _, name, _ in self._sites}
        self._lock = threading.Lock()
        self._saved = []

    def _wrap(self, name, fn, pos):
        def recording(*args, **kw):
            x = args[pos]
            if x.is_cuda:
                if name == "corrupt_noise":
                    k = json.dumps(kw, sort_keys=True)
                else:
                    k = kw["dw"].shape[-1] if "dw" in kw else args[-1]
                key = (tuple(x.shape), x.dtype, k)
                # the weights, not the operands a unit prepared from them:
                # the checks launch the wrapper as a caller of
                # convnext_block(x, dw, ...) has it
                with self._lock:
                    self.seen[name].setdefault(key, (args[pos + 1:], {
                        n: v for n, v in kw.items() if n != "operands"}))
            return fn(*args, **kw)
        return recording

    def __enter__(self):
        for module, name, pos in self._sites:
            fn = getattr(module, name)
            self._saved.append((module, name, fn))
            setattr(module, name, self._wrap(name, fn, pos))
        return self

    def __exit__(self, *exc):
        for module, name, fn in self._saved:
            setattr(module, name, fn)
        self._saved = []


def check_kernel_inputs(pallas_convnext, pallas_pyramid, pallas_noise, seen,
                        seed, path="inference"):
    """Each recorded K1 / K2 / K2-backward shape against the plain
    version, in bf16 and float32, on N(0, 1) inputs with the recorded
    call's weights, and each recorded K3 shape and noise ranges as
    ``check_corrupt_noise`` holds it, on a rounded batch in [0, 255].
    Tolerances: K1 f32 1e-3 and ``K1_F32_RELATIVE`` of max |plain
    output|, K2 bf16 1 ulp and f32 1e-5,
    K2's backward bit-exact, as in phase 3. K1 bf16: 0.05 + 1 bf16 ulp of the
    plain output, phase 3's 0.05 taken before the output's own bf16
    rounding. Phase 3's max(0.05, 1 ulp) counts a gap of 0.04 before
    that rounding as 2 ulps where |out| is in [4, 8) (0.0625 > 0.05);
    the 2176x3840 frame's 267 M outputs meet such a case, so the elements
    over phase 3's formula are counted and logged beside this bar.
    Returns the largest bf16 error of each kernel."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst = dict(convnext_block=0.0, band_smooth=0.0, band_smooth_bwd=0.0,
                 corrupt_noise=0.0)
    for (shape, _, _), (_, kw) in sorted(seen["corrupt_noise"].items(),
                                         key=str):
        x = torch.round(255 * torch.rand(shape, generator=gen,
                                         device="cuda"))
        worst["corrupt_noise"] = max(worst["corrupt_noise"],
                                     check_corrupt_noise(pallas_noise, x, {
                                         k: kw[k] for k in (
                                             "additive_noise",
                                             "multiplicative_noise")}))
    for dtype in (torch.bfloat16, torch.float32):
        for (shape, _, k), (_, kw) in sorted(seen["convnext_block"].items(),
                                             key=str):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            wts = {n: v.to(dtype) for n, v in kw.items() if n != "slope"}
            got = pallas_convnext.convnext_block(x, slope=kw["slope"], **wts)
            ref = pallas_convnext.convnext_block_plain(x, slope=kw["slope"],
                                                       **wts)
            diff = (got.float() - ref.float()).abs()
            err = float(diff.max())
            extra = {}
            if dtype == torch.bfloat16:
                ulp = bf16_ulp(ref)
                ok = bool((diff <= 0.05 + ulp).all())
                over = (diff > torch.clamp(ulp, min=0.05)).nonzero()
                extra = dict(n_over_phase3_formula=len(over), over=[
                    dict(plain=float(ref[tuple(i)]),
                         kernel=float(got[tuple(i)]))
                    for i in over[:4].tolist()])
                worst["convnext_block"] = max(worst["convnext_block"], err)
                del ulp, over
            else:
                rel = err / float(ref.abs().max())
                ok = err <= 1e-3 and rel <= K1_F32_RELATIVE
                extra = dict(relative_err=rel)
            log("check", path=path, kernel="convnext_block",
                shape=list(shape), K=k, dtype=str(dtype), max_abs_err=err,
                tolerance="0.05 + 1 bf16 ulp" if dtype == torch.bfloat16
                else f"1e-3 and {K1_F32_RELATIVE} x max |ref|",
                n_elements=diff.numel(), **extra)
            if not ok:
                raise AssertionError(f"convnext_block {shape} {dtype}: {err}")
            del x, got, ref, diff
        for kernel, fwd in (("band_smooth", True), ("band_smooth_bwd", False)):
            for shape, _, k in sorted(seen[kernel], key=str):
                ins = [torch.randn(shape, generator=gen, device="cuda").to(
                    dtype) for _ in range(1 if fwd else 2)]
                if fwd:
                    got = pallas_pyramid.band_smooth(*ins, k)
                    ref = pallas_pyramid.band_smooth_plain(*ins, k)
                else:
                    got = [pallas_pyramid.band_smooth_bwd(*ins, k)]
                    ref = [pallas_pyramid.band_smooth_bwd_plain(*ins, k)]
                diffs = [(o.float() - r.float()).abs()
                         for o, r in zip(got, ref)]
                err = max(float(d.max()) for d in diffs)
                if not fwd:
                    ok, tol = err == 0.0, "0 (bit-exact)"
                elif dtype == torch.float32:
                    ok, tol = err <= 1e-5, "1e-5"
                else:
                    ok = all(bool((d <= bf16_ulp(r)).all())
                             for d, r in zip(diffs, ref))
                    tol = "1 bf16 ulp"
                if dtype == torch.bfloat16:
                    worst[kernel] = max(worst[kernel], err)
                log("check", path=path, kernel=kernel,
                    shape=list(shape), dtype=str(dtype), max_abs_err=err,
                    tolerance=tol)
                if not ok:
                    raise AssertionError(f"{kernel} {shape} {dtype}: {err}")
                del ins, got, ref, diffs
    torch.cuda.empty_cache()
    return worst


@contextlib.contextmanager
def leaky_relu_signs(out):
    """Within the block, appends (x > 0) of every ``F.leaky_relu`` input
    to ``out`` (on the host): the kinks of the flagship's gradient."""
    leaky = F.leaky_relu

    def recording(x, negative_slope=0.01, inplace=False):
        out.append((x.detach() > 0).cpu())
        return leaky(x, negative_slope, inplace)

    F.leaky_relu = recording
    try:
        yield
    finally:
        F.leaky_relu = leaky


@contextlib.contextmanager
def leaky_relu_pinned(signs):
    """Within the block, the n-th ``F.leaky_relu`` call takes its slope
    from ``signs[n]`` (another run's x > 0) instead of from x: the same
    function but at a kink that the two runs round to opposite sides."""
    leaky, it = F.leaky_relu, iter(signs)

    def pinned(x, negative_slope=0.01, inplace=False):
        return torch.where(next(it).to(x.device), x, x * negative_slope)

    F.leaky_relu = pinned
    try:
        yield
    finally:
        F.leaky_relu = leaky


def gray_gap(a, b):
    d = np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32))
    return dict(mean=float(d.mean()), p99=float(np.percentile(d, 99)),
                max=int(d.max()), equal_share=float((d == 0).mean()))


def inference_phase(bidt, den, rng, smi, read_counts, counts):
    """The JAX Denoiser's whole surface on the card through the flagship
    (bf16, blend on) unless a point names another model: TTA (8 members
    on a 512² image, 4 on b8 @ 256², equivariance, a 481×321 image),
    tiling (the resnet tiled against untiled on 1024×768; the flagship on
    a 2160×3840 frame with tile_rows=512: peak memory and the gray-level
    gap), float_forward's input gradient in float32 against the CPU,
    dispatch under torch.cuda.set_sync_debug_mode("error"), the batching
    server (64 clients × 4 images of 256² against each image alone, then
    6 s steady-state windows; max_batch 32, max_wait 5 ms, pipeline
    depth 1 and 2) and evaluate.noise_sweep. Every bar raises once all
    points are logged."""
    from blind_image_denoising_torch.evaluate import noise_sweep
    from blind_image_denoising_torch.images import load_evaluation_images
    from blind_image_denoising_torch.inference.denoiser import (Denoiser,
                                                                HostCopy)
    from blind_image_denoising_torch.ops.precision import exact_float32
    from blind_image_denoising_torch.serving import BatchingDenoiser
    failed, report = [], {}

    def delta(before):
        now = read_counts()
        return {k: now[k] - before[k] for k in now}

    def timed_ms(fn, n):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    # 1. TTA
    clean_512 = synthetic_images(1, 512, 512, rng)[0]
    noisy_512 = add_noise(clean_512, 25.0, rng)
    clean_b8 = synthetic_images(8, 256, 256, rng)
    noisy_b8 = add_noise(clean_b8, 25.0, rng)
    tta8 = bidt.load_model(FLAGSHIP, tta=8)
    tta4 = bidt.load_model(FLAGSHIP, tta=4)
    c0 = read_counts()
    out8 = tta8(noisy_512)
    torch.cuda.synchronize()
    n8 = delta(c0)
    c0 = read_counts()
    out4 = tta4(noisy_b8)
    torch.cuda.synchronize()
    n4 = delta(c0)
    if n8 != counts(convnext_block=80, band_smooth=16) or \
            n4 != counts(convnext_block=40, band_smooth=8):
        failed.append(f"tta launches: 8 members {n8}, 4 members {n4}")
    plain = den(noisy_512)
    equiv = Denoiser(tta8.model, cast_to_uint8=False, tta=8,
                     blend=tta8.blend)
    sq = noisy_b8[0]
    y = equiv(sq)
    gaps = {"flip_lr": float(np.abs(equiv(sq[:, ::-1]) - y[:, ::-1]).max()),
            "transpose": float(np.abs(equiv(sq.transpose(1, 0, 2))
                                      - y.transpose(1, 0, 2)).max())}
    bsd = add_noise(synthetic_images(1, 321, 481, rng)[0], 25.0, rng)
    out_bsd = tta8(bsd)
    if max(gaps.values()) > 1e-2:
        failed.append(f"tta equivariance {gaps}")
    for o, r in ((out8, noisy_512), (out4, noisy_b8), (out_bsd, bsd)):
        if o.shape != r.shape or o.dtype != np.uint8:
            failed.append(f"tta output {o.shape} {o.dtype}")
    report["tta"] = dict(
        launches_tta8_512=n8, launches_tta4_b8_256=n4,
        equivariance_max_abs=gaps, bar="K1, K2 = members x (10, 2) per "
        "forward; equivariance max |d| <= 1e-2",
        mae_512=dict(noisy=float(np.abs(noisy_512 - clean_512).mean()),
                     plain=float(np.abs(plain - clean_512).mean()),
                     tta8=float(np.abs(out8 - clean_512).mean())),
        tta8_512_ms=timed_ms(lambda: tta8(noisy_512), 5),
        tta4_b8_256_ms=timed_ms(lambda: tta4(noisy_b8), 5),
        plain_512_ms=timed_ms(lambda: den(noisy_512), 5))

    # 2. tiling
    resnet = bidt.load_model(ARTIFACT_RESNET)
    frame = add_noise(synthetic_images(1, 1024, 768, rng)[0], 25.0, rng)
    c0 = read_counts()
    r_tiled = Denoiser(resnet.model, tile_rows=256, tile_halo=64,
                       blend=resnet.blend)(frame)
    r_full = resnet(frame)
    torch.cuda.synchronize()
    r_counts = delta(c0)
    r_gap = gray_gap(r_tiled, r_full)
    if r_gap["max"] > 1 or r_gap["equal_share"] < 0.999 or \
            r_counts != counts():
        failed.append(f"resnet tiled vs untiled {r_gap} {r_counts}")
    clean_4k = synthetic_images(1, 2160, 3840, rng)[0]
    frame_4k = add_noise(clean_4k, 25.0, rng)
    tiled = Denoiser(den.model, tile_rows=512, blend=den.blend)
    patches = tile_patches(2160, 3840, 512)
    mem, outs_4k, ms_4k, n_4k = {}, {}, {}, {}
    for name, d in (("untiled", den), ("tiled", tiled)):
        d(frame_4k)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        c0 = read_counts()
        outs_4k[name] = d(frame_4k)
        torch.cuda.synchronize()
        n_4k[name] = delta(c0)
        mem[name] = dict(peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         above_resident_gib=(torch.cuda.max_memory_allocated()
                                             - base) / 2**30)
        ms_4k[name] = timed_ms(lambda: d(frame_4k), 3)
    if n_4k["tiled"] != counts(convnext_block=10 * patches,
                               band_smooth=2 * patches) or \
            n_4k["untiled"] != counts(convnext_block=10, band_smooth=2):
        failed.append(f"4K launches {n_4k} for {patches} patches")
    report["tiling"] = dict(
        resnet_1024x768_tile256_vs_untiled=r_gap,
        resnet_bar="max <= 1, >= 99.9% equal; no K1-K4 launch",
        flagship_2160x3840=dict(
            tile_rows=512, patches=patches, launches=n_4k, memory=mem,
            tiled_vs_untiled_gray=gray_gap(outs_4k["tiled"],
                                           outs_4k["untiled"]),
            mae=dict(noisy=float(np.abs(frame_4k - clean_4k).mean()),
                     **{k: float(np.abs(o - clean_4k).mean())
                        for k, o in outs_4k.items()}),
            frame_ms=ms_4k))

    # 3. float_forward: the input gradient in float32, card vs CPU
    x = add_noise(synthetic_images(1, 128, 128, rng), 25.0, rng).astype(
        np.float32)
    fdens = {d: bidt.load_model(FLAGSHIP, dtype="float32", device=d)
             for d in ("cuda", "cpu")}

    def card_vs_cpu(img, blend):
        """cosine and max |g_card - g_cpu| / max |g_cpu| of the gradient
        of float_forward's sum, the leaky-ReLU inputs whose sign differs
        between the card and the CPU, the same ratio with the card held
        to the CPU's signs, and the card's launches."""
        grads, signs, launched = {}, {}, None
        for device, pin in (("cpu", False), ("cuda", False), ("cuda", True)):
            fden = fdens[device]
            d = fden if blend else Denoiser(fden.model, device=device)
            xt = torch.from_numpy(img).to(device).requires_grad_(True)
            signs[device, pin] = []
            c0 = read_counts()
            with exact_float32(device == "cuda"), (
                    leaky_relu_pinned(signs["cpu", False]) if pin
                    else leaky_relu_signs(signs[device, pin])):
                (g,) = torch.autograd.grad(d.float_forward(xt).sum(), xt)
            if device == "cuda" and not pin:
                torch.cuda.synchronize()
                launched = delta(c0)
            grads[device, pin] = g.double().cpu().ravel()
        ref = grads["cpu", False]

        def ratio(g):
            return float((g - ref).abs().max() / ref.abs().max())

        g = grads["cuda", False]
        cos = float(g @ ref / g.norm() / ref.norm())
        flips = sum(int((a != b).sum()) for a, b in zip(
            signs["cpu", False], signs["cuda", False]))
        return cos, ratio(g), flips, ratio(grads["cuda", True]), launched

    cos, rel, flips, rel_pinned, ff_counts = card_vs_cpu(x, blend=True)
    if cos < 0.9999 or rel > 1e-3 or ff_counts != counts(
            band_smooth=2, band_smooth_bwd=2):
        failed.append(f"float_forward gradient cos {cos} rel {rel} "
                      f"{ff_counts}")
    # the ratio's spread over seeds and sizes, with the blend and without
    # it; a leaky-ReLU input that the card and the CPU round to opposite
    # sides of 0 takes the other slope, which moves the gradient in its
    # receptive field by O(1), so each reading carries its count of them
    srng = np.random.default_rng(SEED + 2)
    spread = []
    for h, w in ((128, 128), (256, 256)):
        for _ in range(3):
            img = add_noise(synthetic_images(1, h, w, srng), 25.0,
                            srng).astype(np.float32)
            for blend in (True, False):
                c, r, f, rp, _ = card_vs_cpu(img, blend)
                spread.append(dict(shape=[h, w], blend=blend, cosine=c,
                                   rel=r, leaky_relu_sign_flips=f,
                                   rel_cpu_signs=rp))
                if c < 0.9999 or rp > 1e-3:
                    failed.append(f"float_forward gradient {h}x{w} blend "
                                  f"{blend}: cosine {c}, with the CPU's "
                                  f"signs {rp}")
    report["float_forward"] = dict(
        shape=list(x.shape), dtype="float32", cosine_card_vs_cpu=cos,
        max_abs_diff_over_max_abs_cpu=rel, leaky_relu_sign_flips=flips,
        rel_cpu_signs=rel_pinned, launches=ff_counts,
        bar="cosine >= 0.9999, max |g_card - g_cpu| / max |g_cpu| <= 1e-3; "
            "K2 backward launches, K1 does not; the spread: cosine >= "
            "0.9999, the ratio with the card held to the CPU's leaky-ReLU "
            "signs <= 1e-3",
        spread=spread)
    del fdens

    # 4. dispatch makes no host sync
    want = den(noisy_b8)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = HostCopy(den.dispatch(noisy_b8))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    same = bool(np.array_equal(np.asarray(pending), want))
    if not same:
        failed.append("dispatch result differs from the synchronous call")
    report["dispatch"] = dict(sync_debug_mode="error", raised=False,
                              equals_call=same)

    # 5. the batching server: 64 clients × 4 images at depth 1 and 2,
    # each answer against the same image served alone; then the
    # throughput and latency of a steady-state window per depth
    clean_pool = synthetic_images(16, 256, 256, rng)
    requests = [add_noise(clean_pool[i % 16], 25.0, rng) for i in range(256)]
    alone = [den(r) for r in requests]
    torch.cuda.synchronize()

    class Recording:
        """The Denoiser, recording the time and batch size of every
        dispatch."""

        def __init__(self):
            self.sizes, self.times = [], []

        def dispatch(self, batch):
            self.times.append(time.perf_counter())
            self.sizes.append(batch.shape[0])
            return den.dispatch(batch)

        def __call__(self, batch):
            return den(batch)

    def histogram(sizes):
        return {str(b): sizes.count(b) for b in sorted(set(sizes))}

    serving = {}
    warm = BatchingDenoiser(den, max_batch=32, max_wait_ms=5)
    warm.warm((256, 256, 3))
    warm.close()
    for depth in (1, 2):
        rec = Recording()
        batcher = BatchingDenoiser(rec, max_batch=32, max_wait_ms=5,
                                   pipeline_depth=depth)
        answers = [None] * 256

        def client(c):
            for j in range(4):
                answers[4 * c + j] = batcher(requests[4 * c + j])

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(64)]
        c0 = read_counts()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        batcher.close()
        torch.cuda.synchronize()
        n_b = delta(c0)
        if any(t.is_alive() for t in threads) or any(
                a is None for a in answers):
            failed.append(f"batcher depth {depth}: unanswered requests")
            continue
        gap = gray_gap(np.stack(answers), np.stack(alone))
        if gap["mean"] > 0.1 or gap["p99"] > 1:
            failed.append(f"batcher depth {depth} vs alone {gap}")
        if n_b != counts(convnext_block=10 * len(rec.sizes),
                         band_smooth=2 * len(rec.sizes)):
            failed.append(f"batcher depth {depth} launches {n_b} for "
                          f"{len(rec.sizes)} batches")
        serving[f"depth_{depth}_check"] = dict(
            batches=len(rec.sizes), bucket_histogram=histogram(rec.sizes),
            launches=n_b, vs_alone_gray=gap)

    def clients(batcher, stop, spans):
        """64 threads sending requests without pause until ``stop``."""
        def client(c):
            j = 0
            while not stop.is_set():
                req = requests[(4 * c + j) % 256]
                j += 1
                t0 = time.perf_counter()
                batcher(req)
                spans[c].append((t0, time.perf_counter()))

        return [threading.Thread(target=client, args=(c,))
                for c in range(64)]

    def steady(depth, warm_s=2.0, window_s=6.0):
        """After warm_s of 64 clients sending without pause, the requests
        that end in a window_s window (images/s) and those that both
        start and end in it (latency)."""
        rec = Recording()
        batcher = BatchingDenoiser(rec, max_batch=32, max_wait_ms=5,
                                   pipeline_depth=depth)
        stop, spans = threading.Event(), [[] for _ in range(64)]
        threads = clients(batcher, stop, spans)
        c0 = read_counts()
        for t in threads:
            t.start()
        time.sleep(warm_s)
        w0 = time.perf_counter()
        time.sleep(window_s)
        w1 = time.perf_counter()
        stop.set()
        for t in threads:
            t.join(timeout=300)
        batcher.close()
        torch.cuda.synchronize()
        n_b = delta(c0)
        if any(t.is_alive() for t in threads):
            failed.append(f"steady batcher depth {depth}: clients hang")
        if n_b != counts(convnext_block=10 * len(rec.sizes),
                         band_smooth=2 * len(rec.sizes)):
            failed.append(f"steady batcher depth {depth} launches {n_b} "
                          f"for {len(rec.sizes)} batches")
        ended = [t1 for sp in spans for _, t1 in sp if w0 <= t1 < w1]
        lat = [(t1 - t0) * 1e3 for sp in spans for t0, t1 in sp
               if t0 >= w0 and t1 < w1]
        sizes = [b for t, b in zip(rec.times, rec.sizes) if w0 <= t < w1]
        return dict(window_s=w1 - w0, warm_s=warm_s,
                    images_per_s=len(ended) / (w1 - w0),
                    request_ms_p50=float(np.percentile(lat, 50)),
                    request_ms_p99=float(np.percentile(lat, 99)),
                    requests_in_window=len(lat), batches=len(sizes),
                    bucket_histogram=histogram(sizes))

    for depth in (1, 2):
        serving[f"depth_{depth}"] = steady(depth)
    # where a depth-2 run's time goes: 3 s of clients under the profiler,
    # entered before the threads start (thread start included)
    rec = Recording()
    batcher = BatchingDenoiser(rec, max_batch=32, max_wait_ms=5,
                               pipeline_depth=2)
    stop, spans = threading.Event(), [[] for _ in range(64)]
    threads = clients(batcher, stop, spans)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        time.sleep(3.0)
        stop.set()
        for t in threads:
            t.join(timeout=300)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    batcher.close()
    rows = [r for r in profile_rows(prof)
            if not r[2].startswith(("denoiser.", "quant."))]
    busy = sum(r[0] for r in rows)
    serving["profiled_depth_2"] = dict(
        wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
        idle_share_profiled=1 - busy / wall_us, batches=len(rec.sizes),
        images=sum(len(sp) for sp in spans),
        device_ms_per_batch=busy / 1e3 / max(1, len(rec.sizes)),
        bucket_histogram=histogram(rec.sizes),
        kernels=sum(r[1] for r in rows),
        top=[dict(us=round(us, 1), count=c, name=k[:60])
             for us, c, k in rows[:6]])
    report["batching"] = dict(
        clients=64, shape=[256, 256, 3], max_batch=32, max_wait_ms=5,
        bar="64 clients x 4 images: vs alone mean <= 0.1, p99 <= 1; K1, "
        "K2 = (10, 2) per dispatched bucket", **serving)

    # 6. evaluate.noise_sweep over the packaged evaluation images
    images = load_evaluation_images(256)[:4]
    c0 = read_counts()
    records = noise_sweep(den, images, stds=(5, 25, 50))
    torch.cuda.synchronize()
    sweep_counts = delta(c0)
    by_std = {r["noise_std"]: r for r in records}
    if not all(by_std[s]["mae_denoised"] < by_std[s]["mae_noisy"]
               for s in (25.0, 50.0)):
        failed.append("noise_sweep: denoised MAE not below noisy")
    report["noise_sweep"] = dict(records=records, launches=sweep_counts,
                                 bar="mae_denoised < mae_noisy at 25, 50")
    log("inference", smi=smi, **report)
    if failed:
        raise AssertionError(f"inference phase failed: {failed}")


# --------------------------------------------------------------- train loop

# the train_loop phase: 24 seeded scenes of 480x640 written as PNG files
# (3 steps an epoch), the flagship config at its shipped widths, batch,
# accumulation, crop and dtype, fine-tuned from the packaged artifact for
# 6 steps, then resumed to 8; the profiled step is a plain one (not the
# first, a visualization or a checkpoint step)
LOOP_IMAGES, LOOP_IMAGE_HW = 24, (480, 640)
LOOP_STEPS, LOOP_RESUME_STEPS, LOOP_PROFILE_STEP = 6, 8, 2
LOOP_OVERRIDES = {"train.total_steps": LOOP_STEPS, "train.checkpoint_every": 3,
                  "train.visualization_every": 3, "train.log_every": 1,
                  "train.ema": 0.999, "train.use_test_images": True,
                  "train.profile_at_step": LOOP_PROFILE_STEP,
                  "tpu.pallas_noise": True}


def write_png(path, img):
    """An 8-bit RGB PNG of ``img`` [H, W, 3] uint8 with the standard
    library only (no filter, zlib level 6)."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def loop_config(base, image_dir, total_steps):
    cfg = copy.deepcopy(base)
    cfg["dataset"]["inputs"] = ([{"directory": str(image_dir)}]
                                if image_dir is not None else [])
    for key, value in LOOP_OVERRIDES.items():
        section, name = key.split(".")
        cfg.setdefault(section, {})[name] = value
    cfg["train"]["total_steps"] = total_steps
    return cfg


def state_snapshot(state):
    """A device copy of what a checkpoint holds."""
    return dict(
        model={k: v.detach().clone()
               for k, v in state.model.state_dict().items()},
        slots={k: [t.clone() for t in v]
               for k, v in state.opt_state.slots.items()},
        count=state.opt_state.count, step=state.step, epoch=state.epoch,
        ema=(None if state.ema_params is None else
             {k: v.clone() for k, v in state.ema_params.items()}))


def snapshot_equals_checkpoint(snap, ckpt):
    """Names of the parts of ``snap`` that differ from the checkpoint
    payload ``ckpt`` in any bit."""
    bad = [k for k in ckpt["model"]
           if not torch.equal(snap["model"][k].cpu(), ckpt["model"][k])]
    bad += [f"{k}[{i}]" for k, v in ckpt["opt_state"]["slots"].items()
            for i, t in enumerate(v) if not torch.equal(
                snap["slots"][k][i].cpu(), t)]
    if snap["count"] != ckpt["opt_state"]["count"]:
        bad.append("count")
    bad += [k for k in ("step", "epoch") if snap[k] != ckpt[k]]
    if (snap["ema"] is None) != (ckpt["ema_params"] is None):
        bad.append("ema presence")
    elif snap["ema"] is not None:
        bad += [f"ema {k}" for k, v in ckpt["ema_params"].items()
                if not torch.equal(snap["ema"][k].cpu(), v)]
    return bad


class LoopProbe:
    """Instruments ``training/train_loop.py`` within the block: per train
    step the launch counts, host seconds and the synchronizing CUDA calls
    that ``torch.cuda.set_sync_debug_mode("warn")`` reports inside it; per
    noise sweep the launch counts; the deferred metrics reads (one event
    wait each) and the warnings inside them; a snapshot of the state as
    restored; and a hook on the state before each leg's first step.
    Launches made outside the steps and sweeps (the phase's own checks)
    are not counted."""

    def __init__(self, read_counts):
        import importlib
        self.loop = importlib.import_module(
            "blind_image_denoising_torch.training.train_loop")
        from blind_image_denoising_torch.training.checkpoint import (
            CheckpointManager)
        self._manager = CheckpointManager
        self.read_counts = read_counts
        self.steps, self.sweeps, self.reads = [], [], []
        self.restored, self.before_first = None, None
        self.warnings = []
        self._last_end = 0
        self._saved = []

    def _delta(self, before):
        after = self.read_counts()
        return {k: after[k] - before[k] for k in after}

    def __enter__(self):
        probe, loop = self, self.loop
        real_build, real_sweep = loop.build_train_step, loop._noise_sweep_eval
        real_read = loop._PendingMetrics.read
        real_restore = self._manager.restore

        def build(*args, **kw):
            step_fn = real_build(*args, **kw)
            stats = bool(kw.get("grad_stats"))

            def step(state, batch, **kws):
                if probe.before_first is not None:
                    hook, probe.before_first = probe.before_first, None
                    hook(state)
                c0, w0 = probe.read_counts(), len(probe.warnings)
                t0 = time.perf_counter()
                out = step_fn(state, batch, **kws)
                probe.steps.append(dict(
                    step=state.step, stats=stats, start=t0,
                    host_s=time.perf_counter() - t0,
                    syncs=len(probe.warnings) - w0,
                    syncs_before=w0 - probe._last_end,
                    launches=probe._delta(c0)))
                probe._last_end = len(probe.warnings)
                return out
            return step

        def sweep(eval_step, state, eval_batch, writer, step, **kw):
            c0, t0 = probe.read_counts(), time.perf_counter()
            real_sweep(eval_step, state, eval_batch, writer, step, **kw)
            probe.sweeps.append(dict(step=step, launches=probe._delta(c0),
                                     seconds=time.perf_counter() - t0))

        def read(pending):
            w0 = len(probe.warnings)
            out = real_read(pending)
            probe.reads.append(dict(step=pending.step,
                                    syncs=len(probe.warnings) - w0))
            return out

        def restore(manager, state, step=None):
            out = real_restore(manager, state, step)
            probe.restored = state_snapshot(out)
            return out

        self._saved = [(loop, "build_train_step", real_build),
                       (loop, "_noise_sweep_eval", real_sweep),
                       (loop._PendingMetrics, "read", real_read),
                       (self._manager, "restore", real_restore)]
        loop.build_train_step, loop._noise_sweep_eval = build, sweep
        loop._PendingMetrics.read = read
        self._manager.restore = restore
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self._saved:
            setattr(obj, name, fn)


def train_loop_phase(bidt, smi, read_counts, counts, profile_text):
    """The training loop through ``train_loop`` on the card (see
    ``LOOP_OVERRIDES``): a fine-tune leg from the packaged artifact to
    step 6 and a resume leg to step 8 on the same checkpoint directory,
    with the checks of the module docstring, then every K1 / K2 /
    K2-backward / K3 input the legs launched against the plain versions
    and the training shapes timed. Returns (launch counts of the steps and
    sweeps, the worst error per kernel, the timed rows)."""
    import logging
    import tempfile
    import warnings
    from blind_image_denoising_torch.data import native_decode
    from blind_image_denoising_torch.data.dataset import dataset_builder
    from blind_image_denoising_torch.data.file_operations import load_image
    from blind_image_denoising_torch.images import load_evaluation_images
    from blind_image_denoising_torch.ops import (pallas_convnext,
                                                 pallas_noise, pallas_pyramid)
    from blind_image_denoising_torch.ops.losses import mae
    from blind_image_denoising_torch.ops.multiscale import multiscale_targets
    from blind_image_denoising_torch.ops.noise import corrupt_batch_fixed_std
    from blind_image_denoising_torch.ops.precision import exact_float32
    from blind_image_denoising_torch.training import (
        build_eval_step, forward_loss, loss_function_builder)
    from blind_image_denoising_torch.training.checkpoint import (
        CheckpointManager)
    from blind_image_denoising_torch.training.optimizer import (
        schedule_builder)

    base = bidt.CONFIGS_DICT[TRAIN_CONFIG]
    artifact = bidt.models[FLAGSHIP]["directory"]
    rng = np.random.default_rng(SEED + 4)
    work = Path(tempfile.mkdtemp(prefix="bid-train-loop-"))
    image_dir, ckpt_dir = work / "images", work / "checkpoints"
    image_dir.mkdir()
    scenes = np.round(synthetic_images(
        LOOP_IMAGES, *LOOP_IMAGE_HW, rng)).astype(np.uint8)
    for i, img in enumerate(scenes):
        write_png(image_dir / f"scene_{i:02d}.png", img)
    native = native_decode.available()
    try:
        import PIL  # noqa: F401
        pil = True
    except ImportError:
        pil = False
    decoder = "native" if native else ("PIL" if pil else "none")
    if decoder != "none":
        back = load_image(image_dir / "scene_00.png", dtype=np.uint8)
        if not np.array_equal(back, scenes[0]):
            raise AssertionError(f"{decoder} decode of a written PNG differs")
        data = "images"
    else:
        image_dir, data = None, "synthetic"
    cfg6 = loop_config(base, image_dir, LOOP_STEPS)
    cfg8 = loop_config(base, image_dir, LOOP_RESUME_STEPS)
    log("train_loop_setup", config=TRAIN_CONFIG, overrides=dict(
        LOOP_OVERRIDES, **{"dataset.inputs": cfg6["dataset"]["inputs"]}),
        images=[LOOP_IMAGES, *LOOP_IMAGE_HW], decoder=decoder, data=data,
        weights_directory=artifact,
        batch=cfg6["dataset"]["batch_size"],
        micro_batches=cfg6["train"]["gpu_batches_per_step"],
        crop=cfg6["dataset"]["input_shape"],
        dtype=cfg6["tpu"]["compute_dtype"])

    # one injected batch, the same for the saved and the restored state
    clean = torch.from_numpy(np.round(synthetic_images(4, 256, 256, rng)))
    noisy = pallas_noise.corrupt_batch_plain(SEED + 5, clean,
                                             additive_noise=[5, 40],
                                             multiplicative_noise=None)
    gt = [g.cuda() for g in multiscale_targets(clean, 2, clip_values=True,
                                               round_values=True)]
    fns = loss_function_builder(base["loss"])

    def injected_loss(model):
        with torch.no_grad(), exact_float32():
            total, _ = forward_loss(
                model, fns, 3, noisy.cuda(), gt,
                torch.full((3,), 1.0 / 3, device="cuda"),
                torch.Generator(device="cuda").manual_seed(SEED + 6))
        return float(total)

    # the sweep's images and its σ = 20 corruption (a generator seeded 0)
    eval_clean = torch.from_numpy(load_evaluation_images(512)).cuda()
    eval_noisy = corrupt_batch_fixed_std(
        torch.Generator(device="cuda").manual_seed(0), eval_clean, 20.0)
    noisy_mae_20 = float(mae(eval_clean, eval_noisy))

    def sweep_mae(state):
        """The sweep's MAE at σ 0 and 20 with the state's params."""
        step = build_eval_step(state.model)
        return {std: float(mae(eval_clean, step(state, x)))
                for std, x in ((0, eval_clean), (20, eval_noisy))}

    records = []
    handler = logging.Handler()
    handler.emit = lambda record: records.append(record.getMessage())
    pkg_logger = logging.getLogger("blind_image_denoising_torch")
    pkg_logger.addHandler(handler)
    pkg_logger.setLevel(logging.INFO)
    legs = {}
    try:
        with KernelInputs() as kernel_inputs, \
                LoopProbe(read_counts) as probe, \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            probe.warnings = caught
            start = {}

            def before_leg1(state):
                # the fine-tune's start: the artifact's params, as loaded
                start["mae"] = sweep_mae(state)
            probe.before_first = before_leg1
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                state6 = bidt.train_loop(cfg6, ckpt_dir,
                                         weights_directory=artifact)
                legs["finetune_s"] = time.perf_counter() - t0
                legs["finetune_setup_s"] = probe.steps[0]["start"] - t0
                torch.cuda.set_sync_debug_mode(0)
                saved_loss = injected_loss(state6.model)
                ckpt6 = CheckpointManager(str(ckpt_dir)).read(LOOP_STEPS)
                first = {}

                def before_first(state):
                    first["snap"] = state_snapshot(state)
                    first["loss"] = injected_loss(state.model)
                probe.before_first = before_first
                n_leg1 = len(probe.steps)
                torch.cuda.set_sync_debug_mode("warn")
                t0 = time.perf_counter()
                state8 = bidt.train_loop(cfg8, ckpt_dir)
                legs["resume_s"] = time.perf_counter() - t0
                legs["resume_setup_s"] = probe.steps[n_leg1]["start"] - t0
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        pkg_logger.removeHandler(handler)
    del state6

    # fine-tune start, restore and EMA
    if not any(m.startswith("loaded fine-tune weights from artifact")
               for m in records):
        raise AssertionError("the first leg did not load the artifact")
    restore_diff = snapshot_equals_checkpoint(probe.restored, ckpt6)
    first_diff = snapshot_equals_checkpoint(first["snap"], ckpt6)
    ema_moved = max(float((first["snap"]["ema"][k] - p).abs().max())
                    for k, p in first["snap"]["model"].items()
                    if k in first["snap"]["ema"])
    # the JSONL records
    rows = [json.loads(line) for line in
            (ckpt_dir / "metrics.jsonl").read_text().splitlines()]
    step_rows = {r["step"]: r for r in rows if "total_loss" in r}
    schedule = schedule_builder(base["train"]["optimizer"]["schedule"])
    lr_err = max(abs(r["learning_rate"] - schedule(k))
                 for k, r in step_rows.items())
    losses = [step_rows[k]["total_loss"] for k in sorted(step_rows)]
    sweep_rows = {r["step"]: r for r in rows if "eval/mae_noise_20" in r}
    sweep_keys = [f"eval/{m}_noise_{s}" for m in ("mae", "psnr")
                  for s in (0, 20, 40, 60, 80)]
    sweep_vals = {k: {key: next(r[key] for r in rows
                                if r["step"] == k and key in r)
                      for key in sweep_keys} for k in sweep_rows}
    # launches and syncs
    per_step = counts(band_smooth=16, band_smooth_bwd=16, corrupt_noise=8)
    per_sweep = counts(convnext_block=50, band_smooth=10)
    bad_steps = [s for s in probe.steps if s["launches"] != per_step]
    bad_sweeps = [s["launches"] for s in probe.sweeps
                  if s["launches"] != per_sweep]
    step_syncs = [s["syncs"] for s in probe.steps]
    read_syncs = sum(r["syncs"] for r in probe.reads)
    loop_counts = {k: sum(s["launches"][k] for s in probe.steps)
                   + sum(s["launches"][k] for s in probe.sweeps)
                   for k in per_step}
    # host-clock rate over the steady steps: the span from one step's
    # start to the next's, where neither is the profiled step, the first
    # is not the process's first step, not a stats step (a sweep, a
    # checkpoint and an epoch's end follow it) and not the last of leg 1
    steady, between = [], []
    for i, (s, nxt) in enumerate(zip(probe.steps, probe.steps[1:])):
        if (i not in (0, n_leg1 - 1) and not s["stats"]
                and LOOP_PROFILE_STEP not in (s["step"], nxt["step"])):
            steady.append(nxt["start"] - s["start"])
            between.append(nxt["syncs_before"])
    profile = json.loads((ckpt_dir / "profile" / "summary.json").read_text())
    # the host pipeline alone: one epoch of decode, crops and batches
    t0 = time.perf_counter()
    n_batches = sum(1 for _ in dataset_builder(cfg6["dataset"]).training)
    decode_s = time.perf_counter() - t0
    images_per_step = (cfg6["dataset"]["batch_size"]
                       * cfg6["train"]["gpu_batches_per_step"])
    steps_per_s = 1.0 / statistics.median(steady)
    result = dict(
        legs_s=legs, steps=[s["step"] for s in probe.steps],
        final_step=state8.step, final_epoch=state8.epoch,
        restore_bit_exact=not restore_diff, restore_differs=restore_diff[:5],
        ema_kept_on_resume=not first_diff,
        ema_max_abs_from_params=ema_moved,
        injected_loss_saved=saved_loss, injected_loss_restored=first["loss"],
        metrics_steps=sorted(step_rows), losses=losses,
        learning_rate_max_abs_err=lr_err,
        sweeps=sweep_vals, noisy_mae_20=noisy_mae_20,
        artifact_mae=start["mae"],
        launches_per_step=[s["launches"] for s in probe.steps][:1],
        launches_per_sweep=[s["launches"] for s in probe.sweeps][:1],
        steps_with_other_launches=len(bad_steps),
        syncs_in_steps=step_syncs, syncs_between_steady_steps=between,
        metric_reads=len(probe.reads),
        syncs_in_metric_reads=read_syncs,
        warnings_total=len(caught),
        step_host_s=[round(s["host_s"], 4) for s in probe.steps],
        steady_step_s=[round(t, 4) for t in steady],
        steps_per_s=steps_per_s, images_per_s=images_per_step * steps_per_s,
        profiled_step=dict(profile, step=LOOP_PROFILE_STEP),
        decoder=decoder, data=data,
        decode_images_per_s=(LOOP_IMAGES / decode_s if data == "images"
                             else None),
        pipeline_crops_per_s=n_batches * cfg6["dataset"]["batch_size"]
        / decode_s,
        loop_images_per_s=images_per_step * steps_per_s,
        sweep_s=[round(s["seconds"], 3) for s in probe.sweeps], smi=smi,
        tolerance="restore bit-exact; injected loss equal; steps 1-8 "
                  "finite, learning_rate = schedule within 1e-9; sweeps "
                  "finite, step 6's MAE at sigma 20 below the noisy "
                  "input's; per "
                  "step K2 16, K2 bwd 16, K3 8, K1 0; per sweep K1 50, "
                  "K2 10; 0 syncs in a step, <= 1 read per logged step")
    log("train_loop", **result)
    if profile_text is not None:
        profile_text.append(f"\ntrain_loop profiled step "
                            f"{LOOP_PROFILE_STEP}: {json.dumps(profile)}\n")
    problems = []
    if restore_diff or first_diff:
        problems.append("restored state differs from the step-6 "
                        "checkpoint")
    if not ema_moved > 0.0:
        problems.append("the EMA equals the params")
    if saved_loss != first["loss"]:
        problems.append("injected loss differs after the restore")
    if sorted(step_rows) != list(range(1, LOOP_RESUME_STEPS + 1)) or not all(
            np.isfinite(losses)):
        problems.append(f"metrics.jsonl steps {sorted(step_rows)}")
    if lr_err > 1e-9:
        problems.append(f"learning_rate off the schedule by {lr_err}")
    # the weights the run ends with denoise; the step-3 sweep is held
    # finite only: the first Adam steps at the schedule's peak rate move
    # the converged artifact off its minimum (the loss rises, PERF.md)
    if sorted(sweep_vals) != [3, 6] or not all(
            np.isfinite(v) for vals in sweep_vals.values()
            for v in vals.values()) or not (
            sweep_vals[LOOP_STEPS]["eval/mae_noise_20"] < noisy_mae_20):
        problems.append(f"sweeps {sweep_vals}")
    if bad_steps or bad_sweeps or len(probe.sweeps) != 2:
        problems.append(f"launches: steps {bad_steps[:2]}, sweeps "
                        f"{bad_sweeps}")
    if any(step_syncs) or read_syncs or len(probe.reads) > len(step_rows):
        problems.append(f"syncs: steps {step_syncs}, reads "
                        f"{len(probe.reads)} ({read_syncs} warned)")
    if (state8.step != LOOP_RESUME_STEPS
            or len(probe.steps) != LOOP_RESUME_STEPS):
        problems.append(f"ran {len(probe.steps)} steps to {state8.step}")
    if problems:
        raise AssertionError(f"train_loop: {problems}")
    del state8
    torch.cuda.empty_cache()

    errors = check_kernel_inputs(pallas_convnext, pallas_pyramid,
                                 pallas_noise, kernel_inputs.seen, SEED + 7,
                                 path="train_loop")
    log("train_loop_checks", shapes={k: sorted(str(key[0]) for key in v)
                                     for k, v in kernel_inputs.seen.items()})

    # the loop's kernel shapes, timed warm and cold against their bounds:
    # K2 and its backward at the train step's two levels (each launched
    # per_step / 2 times per step), K3, and K1 at the sweep's two levels
    # with the weights the sweep gave it
    timed = []
    for shape in ((4, 256, 256, 32), (4, 128, 128, 64)):
        x, g_band, g_smooth = (torch.randn(shape, device="cuda").to(
            torch.bfloat16) for _ in range(3))
        for kernel, fn, plain, lib, ins, backward in (
                ("band_smooth", lambda a: pallas_pyramid.band_smooth(a, 2),
                 lambda: pallas_pyramid.band_smooth_plain(x, 2),
                 lambda: band_smooth_library(x, 2), (x,), False),
                ("band_smooth_bwd",
                 lambda a, b: pallas_pyramid.band_smooth_bwd(a, b, 2),
                 lambda: pallas_pyramid.band_smooth_bwd_plain(
                     g_band, g_smooth, 2),
                 band_smooth_bwd_library(x, 2, g_band, g_smooth),
                 (g_band, g_smooth), True)):
            t = dict(ms=cuda_ms(lambda: fn(*ins)),
                     cold_ms=cuda_ms(fn, inputs=cold_copies(*ins)),
                     plain_ms=cuda_ms(plain, iters=5),
                     library_ms=cuda_ms(lib))
            bound, by = band_bound_ms(*shape, 2, torch.bfloat16,
                                      backward=backward)
            row = dict(kernel=kernel, shape=list(shape), dtype="bf16",
                       launches_per_loop_step=per_step[kernel] // 2,
                       bound_ms=bound, bound_by=by, **t)
            log("time", path="train_loop", smi=smi, **row)
            timed.append(row)
    x3 = torch.round(255 * torch.rand((4, 256, 256, 3), device="cuda"))
    noise_kw = dict(additive_noise=base["dataset"]["additional_noise"],
                    multiplicative_noise=base["dataset"][
                        "multiplicative_noise"])
    seed = 20260803
    t = dict(ms=cuda_ms(lambda: pallas_noise.corrupt_noise(seed, x3,
                                                           **noise_kw)),
             cold_ms=cuda_ms(lambda xc: pallas_noise.corrupt_noise(
                 seed, xc, **noise_kw), inputs=cold_copies(x3)),
             plain_ms=cuda_ms(lambda: pallas_noise.corrupt_batch_plain(
                 seed, x3, **noise_kw), iters=5), library_ms=None)
    mul, add = (sorted(noise_kw[k]) for k in ("multiplicative_noise",
                                               "additive_noise"))
    p = pallas_noise.sample_params_plain(seed, 4, *mul, *add)
    bound, by, parts = noise_bound_ms(x3[0].numel(),
                                      (p[:, 0] + p[:, 2]).int().tolist())
    row = dict(kernel="corrupt_noise", shape=[4, 256, 256, 3], dtype="f32",
               launches_per_loop_step=8, bound_ms=bound, bound_by=by,
               bound_ms_by_part=parts, **t)
    log("time", path="train_loop", smi=smi, **row)
    timed.append(row)
    for (shape, dtype, k), (_, kw) in sorted(
            kernel_inputs.seen["convnext_block"].items(), key=str):
        if shape[1] not in (512, 256) or shape[1] == 256 and shape[-1] == 32:
            continue                  # the sweep's 4x512^2x32, 4x256^2x64
        x = torch.randn(shape, device="cuda").to(dtype)
        wts = {n: v for n, v in kw.items() if n != "slope"}
        t = dict(ms=cuda_ms(lambda: pallas_convnext.convnext_block(
                     x, slope=kw["slope"], **wts)),
                 cold_ms=cuda_ms(lambda xc: pallas_convnext.convnext_block(
                     xc, slope=kw["slope"], **wts), inputs=cold_copies(x)),
                 plain_ms=cuda_ms(lambda: pallas_convnext.convnext_block_plain(
                     x, slope=kw["slope"], **wts), iters=3, warmup=1),
                 library_ms=cuda_ms(lambda: convnext_library(
                     x, slope=kw["slope"], **wts)))
        bound, by = convnext_bound_ms(*shape, k, dtype)
        # per sweep: five forwards, each with the encoder's and the
        # decoder's units at this level
        level = 0 if shape[-1] == base["model"]["backbone"]["filters"] else 1
        row = dict(kernel="convnext_block", shape=list(shape), K=k,
                   dtype=str(dtype), launches_per_sweep=5 * 2 * base[
                       "model"]["backbone"]["width"][level],
                   bound_ms=bound, bound_by=by, **t)
        log("time", path="train_loop", smi=smi, **row)
        timed.append(row)
        del x
    return loop_counts, errors, timed, dict(work=work, ckpt_dir=ckpt_dir,
                                            image_dir=image_dir)



# the export phase: the train_loop phase's run exported with quantize and
# the self-test, then served from the artifact; the bars are PERF.md §2's
# bf16 serving bar (against the same artifact in f32 on the CPU) and, for
# int8, JAX's own int8-from-f32 gap on the same artifact and batch plus
# 0.5 gray levels: JAX misses PERF.md §2's 2.5 there too (3.197 on the
# CPU, tests/export_int8_gap.py; PERF.md §6); the card's calibration
# against the CPU's
EXPORT_BATCH, EXPORT_SIZE, EXPORT_REQUESTS = 8, 256, 10
EXPORT_BF16_MEAN, EXPORT_BF16_P99 = 1.0, 3.0
EXPORT_INT8_MEAN = 3.197 + 0.5
EXPORT_CALIBRATION_RTOL = 1e-4
# the resnet_train_export phase: the resnet config at its full width,
# seeded glorot init, 4 steps on the train_loop phase's scenes (4 crops a
# scene: 3 steps an epoch), a checkpoint at 4
RESNET_CONFIG = ("resnet_color_1x6_bn_32x128x32_1x3x1_128x128_depthwise_"
                 "l1_relu")
RESNET_STEPS = 4
RESNET_OVERRIDES = {"train.total_steps": RESNET_STEPS,
                    "train.checkpoint_every": RESNET_STEPS,
                    "dataset.no_crops_per_image": 4}
RESNET_LOSS_RTOL, RESNET_STATS_RTOL = 1e-5, 1e-4


def flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def timed_requests(den, img, n):
    """Host-clock seconds of ``n`` requests of ``den`` on ``img`` (after
    one warm-up), each to its uint8 answer on the host."""
    den(img)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        den(img)
        times.append(time.perf_counter() - t0)
    return times


def run_cli(args, timeout=600):
    """``python -m`` one of the port's CLIs from the checkout, on the card;
    returns its wall seconds and the tail of its log."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m"] + args, capture_output=True,
                         text=True, timeout=timeout,
                         cwd=str(Path(__file__).resolve().parent))
    if out.returncode != 0:
        raise AssertionError(f"{args[0]} exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    return time.perf_counter() - t0, out.stderr.strip().splitlines()[-1:]


def export_phase(bidt, smi, read_counts, loop_run, keep=None):
    """The flagship run of the train_loop phase (``unet_laplacian_v6_tpu``
    at its shipped width, EMA 0.999, 8 steps) through ``export_model(...,
    quantize=True, test_model=True)`` on the card; the written weights
    against the checkpoint's EMA; ``load_model`` of the artifact serving
    b8 @ 256² and one 512² in bf16 (10 K1 and 2 K2 per forward) against
    the same artifact in f32 on the CPU; the card's calibration against
    the CPU's; the ``quant=True`` route (no K1); the export and build
    CLIs as subprocesses. ``keep``: a directory to copy the artifact and
    the noisy batch into (``tests/export_int8_gap.py`` reads them).
    Returns the kernel inputs seen."""
    from blind_image_denoising_torch.inference.export import export_model
    from blind_image_denoising_torch.inference.quantize import (
        calibrate, default_calibration_images)
    from blind_image_denoising_torch.models.hydra import model_builder
    from blind_image_denoising_torch.training.checkpoint import (
        CheckpointManager)
    from blind_image_denoising_torch.weights import (
        flax_from_params, load_msgpack, params_from_flax)

    ckpt_dir, work = loop_run["ckpt_dir"], loop_run["work"]
    cfg_path = ckpt_dir / "config.json"
    cfg = json.loads(cfg_path.read_text())
    out_dir = work / "export"
    rng = np.random.default_rng(SEED + 8)
    phases = {}
    problems = []
    with KernelInputs() as kernel_inputs:
        c0, t0 = read_counts(), time.perf_counter()
        export_model(cfg_path, ckpt_dir, out_dir, quantize=True,
                     test_model=True)
        phases["export_s"] = time.perf_counter() - t0
        c1 = read_counts()
        export_launches = {k: c1[k] - c0[k] for k in c1}
        # the weights written: the checkpoint's EMA, bit for bit
        manager = CheckpointManager(str(ckpt_dir))
        step = manager.latest_step()
        ckpt = manager.read(step)
        written = params_from_flax(load_msgpack(out_dir / "params.msgpack"))
        weights_bad = sorted(k for k in written if not torch.equal(
            written[k], ckpt["ema_params"][k]))
        if set(written) != set(ckpt["ema_params"]) or weights_bad:
            problems.append(f"params.msgpack differs from the EMA: "
                            f"{weights_bad[:4]}")

        # the float serve: bf16 from the artifact's pipeline.json
        den = bidt.load_model(out_dir)
        if den.model.dtype != torch.bfloat16:
            problems.append("the artifact did not serve in bf16")
        batch = add_noise(synthetic_images(EXPORT_BATCH, EXPORT_SIZE,
                                           EXPORT_SIZE, rng), 25.0, rng)
        big = add_noise(synthetic_images(1, 512, 512, rng), 25.0, rng)[0]
        per_forward = {}
        outs = {}
        for name, img in (("b8_256", batch), ("1_512", big)):
            c0 = read_counts()
            outs[name] = den(img)
            c1 = read_counts()
            per_forward[name] = {k: c1[k] - c0[k] for k in c1
                                 if c1[k] != c0[k]}
            if per_forward[name] != dict(convnext_block=10, band_smooth=2):
                problems.append(f"{name} launches {per_forward[name]}")
        times = timed_requests(den, batch, EXPORT_REQUESTS)
        cpu = bidt.load_model(out_dir, device="cpu", dtype="float32")
        bf16_gap = {name: gray_gap(outs[name], cpu(img)) for name, img in
                    (("b8_256", batch), ("1_512", big))}
        cpu_b8 = cpu(batch)
        for name, g in bf16_gap.items():
            if g["mean"] > EXPORT_BF16_MEAN or g["p99"] > EXPORT_BF16_P99:
                problems.append(f"bf16 {name} vs f32 CPU {g}")

        # the calibration: the card's quant.msgpack against the CPU's on
        # the same weights and images
        size = min(256, int(cfg["dataset"]["input_shape"][0]))
        images = default_calibration_images(size=size)
        t0 = time.perf_counter()
        cpu_scales = flat_tree(calibrate(cpu.model, images))
        phases["cpu_calibration_s"] = time.perf_counter() - t0
        card_scales = flat_tree(load_msgpack(out_dir / "quant.msgpack"))
        rel = {k: abs(float(card_scales[k]) - float(v)) / float(v)
               for k, v in cpu_scales.items() if k in card_scales}
        worst_site = max(rel, key=rel.get) if rel else None
        if set(card_scales) != set(cpu_scales) or (
                rel[worst_site] > EXPORT_CALIBRATION_RTOL):
            problems.append(f"calibration: {len(card_scales)} vs "
                            f"{len(cpu_scales)} sites, worst {worst_site} "
                            f"{rel.get(worst_site)}")

        # the int8 serve: per site, no K1
        den8 = bidt.load_model(out_dir, quant=True)
        c0 = read_counts()
        out8 = den8(batch)
        c1 = read_counts()
        int8_launches = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
        if int8_launches.get("convnext_block", 0):
            problems.append(f"the int8 route launched K1: {int8_launches}")
        int8_gap = gray_gap(out8, cpu_b8)
        if int8_gap["mean"] > EXPORT_INT8_MEAN:
            problems.append(f"int8 vs f32 {int8_gap}")
        times8 = timed_requests(den8, batch, 3)
    del den, den8, cpu
    torch.cuda.empty_cache()
    if keep is not None:
        keep.mkdir(parents=True, exist_ok=True)
        for f in out_dir.iterdir():
            (keep / f.name).write_bytes(f.read_bytes())
        np.save(keep / "batch.npy", batch)

    # the CLIs, each in a process of its own on the card
    cli_dir = work / "export_cli"
    cli_s, cli_tail = run_cli([
        "blind_image_denoising_torch.export", "--pipeline-config",
        str(cfg_path), "--checkpoint-directory", str(ckpt_dir),
        "--output-directory", str(cli_dir), "--test-model"])
    if (cli_dir / "params.msgpack").read_bytes() != (
            out_dir / "params.msgpack").read_bytes():
        problems.append("the export CLI wrote other params")
    build_dir = work / "build"
    config_file = (Path(__file__).resolve().parent / "blind_image_denoising_"
                   "tpu" / "configs" / f"{TRAIN_CONFIG}.json")
    build_s, build_tail = run_cli([
        "blind_image_denoising_torch.build", "--pipeline-config",
        str(config_file), "--output-directory", str(build_dir)])
    structure = json.loads((build_dir / "model_structure.json").read_text())
    hydra = model_builder(copy.deepcopy(bidt.CONFIGS_DICT[TRAIN_CONFIG][
        "model"])).hydra
    shapes = {k: list(v.shape) for k, v in flat_tree(
        flax_from_params(hydra)["params"]).items()}
    if {k: list(v) for k, v in flat_tree(structure).items()} != shapes:
        problems.append("model_structure.json differs from the hydra")

    median = statistics.median(times)
    result = dict(
        checkpoint_step=step, artifact=sorted(p.name for p in
                                              out_dir.iterdir()),
        export_s=phases["export_s"], export_launches=export_launches,
        params_equal_ema=not weights_bad, launches_per_forward=per_forward,
        serve_b8_256_median_s=median,
        serve_b8_256_images_per_s=EXPORT_BATCH / median,
        serve_b8_256_s=[round(t, 4) for t in times],
        bf16_vs_f32_cpu=bf16_gap,
        calibration_sites=len(card_scales),
        calibration_worst_rel=rel.get(worst_site),
        calibration_worst_site=worst_site,
        cpu_calibration_s=phases["cpu_calibration_s"],
        int8_launches_per_forward=int8_launches,
        int8_vs_f32_cpu=int8_gap,
        int8_b8_256_median_s=statistics.median(times8),
        export_cli_s=cli_s, export_cli_log=cli_tail,
        build_cli_s=build_s, build_cli_log=build_tail,
        model_structure_leaves=len(shapes), smi=smi,
        tolerance=f"params.msgpack = checkpoint EMA bit for bit; bf16 vs "
                  f"f32 CPU mean <= {EXPORT_BF16_MEAN}, p99 <= "
                  f"{EXPORT_BF16_P99}; int8 vs f32 mean <= "
                  f"{EXPORT_INT8_MEAN}; calibration card vs CPU rtol "
                  f"{EXPORT_CALIBRATION_RTOL}; 10 K1 + 2 K2 per float "
                  f"forward, 0 K1 on the int8 route; the export CLI's "
                  f"params.msgpack byte-equal; model_structure.json = the "
                  f"hydra's param shapes")
    log("export", **result)
    if problems:
        raise AssertionError(f"export: {problems}")
    return kernel_inputs.seen


# the formats phase: the committed TFLite fixture (write_tflite_fixture.py)
# and the train_loop phase's run as a torch.export program
FORMATS_FIXTURE = (Path(__file__).resolve().parent / "tests" / "data"
                   / "tflite_resnet_depthwise_scratch")
FORMATS_BATCH, FORMATS_SIZE, FORMATS_REQUESTS = 8, 256, 10
FORMATS_EXPORT_REL = 1e-4        # program vs eager, of the output's max |y|


@contextlib.contextmanager
def export_kernel_inputs(pallas_convnext, pallas_pyramid, seen):
    """Within the block, the inputs of the K1 and K2 launches that an
    exported program's custom operators make (``ops/export_ops.py`` calls
    the wrappers through their modules), recorded into ``seen`` as
    :class:`KernelInputs` records the eager path's."""
    k1, k2 = pallas_convnext.convnext_block, pallas_pyramid.band_smooth_forward

    def record_k1(x, dw, ln_scale, w2, w3, gain, slope=0.1, **kw):
        if x.is_cuda:
            seen["convnext_block"].setdefault(
                (tuple(x.shape), x.dtype, dw.shape[-1]),
                ((), dict(dw=dw, ln_scale=ln_scale, w2=w2, w3=w3, gain=gain,
                          slope=slope)))
        return k1(x, dw, ln_scale, w2, w3, gain, slope, **kw)

    def record_k2(x, kernel_size):
        if x.is_cuda:
            seen["band_smooth"].setdefault(
                (tuple(x.shape), x.dtype, kernel_size), ((kernel_size,), {}))
        return k2(x, kernel_size)

    pallas_convnext.convnext_block = record_k1
    pallas_pyramid.band_smooth_forward = record_k2
    try:
        yield seen
    finally:
        pallas_convnext.convnext_block = k1
        pallas_pyramid.band_smooth_forward = k2


def formats_phase(bidt, smi, read_counts, loop_run):
    """The formats JAX ties to TensorFlow, served on the card, and the
    port's serving artifact.

    TFLite: the committed fixture directory (JAX's ``serialize_tflite`` of
    the packaged resnet, dynamic-range int8 weights) through
    ``load_model(dir)`` on the card — the port's own flatbuffer reader and
    executor, no TensorFlow — at b8 @ 256² and on one 481×321 image,
    against the same executor on the CPU (uint8 ≤ 1 gray level, ≥ 99%
    equal; float32 without TF32 on both), and against the native packaged
    resnet's float32 forward: the card's gap within one gray level of the
    CPU's gap at its largest and 0.01 at its mean (the CPU tests hold the
    CPU's gap equal to JAX's executor's); images/s on the host clock
    (median of 10) beside the native resnet's.

    torch.export: ``export_model(..., to_torch_export=True)`` of the
    train_loop phase's run on the card, ``load_torch_export`` and b8 @
    256² float32 against the eager hydra of the same weights on the card
    (max |Δ| ≤ 1e-4 of max |y|), 10 K1 and 2 K2 a forward, device ms
    (CUDA events) beside eager's, and whether the program came out
    shape-polymorphic. Returns the K1 / K2 inputs the program launched."""
    from blind_image_denoising_torch.inference import tflite
    from blind_image_denoising_torch.inference.denoiser import as_uint8
    from blind_image_denoising_torch.inference.export import (
        TORCH_EXPORT_FILE, export_model, load_torch_export)
    from blind_image_denoising_torch.ops import pallas_convnext, pallas_pyramid

    rng = np.random.default_rng(SEED + 50)
    problems = []
    batch = add_noise(synthetic_images(FORMATS_BATCH, FORMATS_SIZE,
                                       FORMATS_SIZE, rng), 25.0, rng)
    one = add_noise(synthetic_images(1, 321, 481, rng), 25.0, rng)[0]
    images = (("b8_256", batch), ("1_481x321", one))

    # ---- TFLite
    graph_ops = len(tflite.parse_tflite(
        (FORMATS_FIXTURE / tflite.TFLITE_FILE).read_bytes())[0])
    c0 = read_counts()
    den = bidt.load_model(FORMATS_FIXTURE)
    card = {name: den(img) for name, img in images}
    c1 = read_counts()
    tflite_launches = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
    if tflite_launches:
        problems.append(f"the TFLite graph launched {tflite_launches}")
    cpu_den = bidt.load_model(FORMATS_FIXTURE, device="cpu")
    cpu = {name: cpu_den(img) for name, img in images}
    card_vs_cpu = {name: gray_gap(card[name], cpu[name])
                   for name, _ in images}
    for name, g in card_vs_cpu.items():
        if g["max"] > 1 or g["equal_share"] < 0.99:
            problems.append(f"TFLite {name} card vs CPU {g}")
    native = {dev: bidt.load_model(ARTIFACT_RESNET, dtype="float32",
                                   device=dev).model
              for dev in ("cuda", "cpu")}

    def native_forward(dev, img):
        model = native[dev]
        x = torch.from_numpy(np.asarray(img, np.float32)).to(
            next(model.parameters()).device)
        x = x[None] if x.ndim == 3 else x
        with torch.no_grad():
            y = model(x.permute(0, 3, 1, 2))[0].permute(0, 2, 3, 1)
        return as_uint8(y.cpu().numpy()).reshape(np.shape(img))

    vs_native = {}
    for name, img in images:
        g_card = gray_gap(card[name], native_forward("cuda", img))
        g_cpu = gray_gap(cpu[name], native_forward("cpu", img))
        vs_native[name] = dict(card=g_card, cpu=g_cpu)
        if (g_card["max"] > g_cpu["max"] + 1
                or abs(g_card["mean"] - g_cpu["mean"]) > 0.01):
            problems.append(f"TFLite {name} vs native {vs_native[name]}")
    times = timed_requests(den, batch, FORMATS_REQUESTS)
    native_den = bidt.load_model(ARTIFACT_RESNET, dtype="float32")
    native_times = timed_requests(native_den, batch, FORMATS_REQUESTS)
    del den, cpu_den, native, native_den

    # ---- torch.export
    ckpt_dir, work = loop_run["ckpt_dir"], loop_run["work"]
    out_dir = work / "formats_export"
    t0 = time.perf_counter()
    export_model(ckpt_dir / "config.json", ckpt_dir, out_dir,
                 to_torch_export=True)
    export_s = time.perf_counter() - t0
    dynamic = bool(torch.export.load(str(out_dir / TORCH_EXPORT_FILE))
                   .range_constraints)
    t0 = time.perf_counter()
    program = load_torch_export(out_dir)
    load_s = time.perf_counter() - t0
    eager_model = bidt.load_model(out_dir, dtype="float32",
                                  blend=False).model

    def eager(x):
        with torch.no_grad():
            return eager_model(x.permute(0, 3, 1, 2))[0].permute(0, 2, 3, 1)

    x = torch.from_numpy(batch.astype(np.float32)).cuda()
    seen = {k: {} for k in ("convnext_block", "band_smooth",
                            "band_smooth_bwd", "corrupt_noise")}
    with export_kernel_inputs(pallas_convnext, pallas_pyramid, seen):
        c0 = read_counts()
        y = program(x)
        torch.cuda.synchronize()
        c1 = read_counts()
    per_forward = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
    if per_forward != dict(convnext_block=10, band_smooth=2):
        problems.append(f"the exported program launches {per_forward}")
    ref = eager(x)
    err = float((y - ref).abs().max())
    scale = float(ref.abs().max())
    if not err <= FORMATS_EXPORT_REL * scale:
        problems.append(f"exported vs eager {err} of {scale}")
    program_ms = cuda_ms(lambda: program(x))
    eager_ms = cuda_ms(lambda: eager(x))

    median, native_median = (statistics.median(times),
                             statistics.median(native_times))
    log("formats",
        tflite=dict(graph_ops=graph_ops, launches=tflite_launches,
                    card_vs_cpu=card_vs_cpu, vs_native_f32=vs_native,
                    b8_256_median_s=median,
                    b8_256_images_per_s=FORMATS_BATCH / median,
                    native_f32_b8_256_images_per_s=(FORMATS_BATCH
                                                    / native_median),
                    b8_256_s=[round(t, 4) for t in times]),
        torch_export=dict(dynamic=dynamic, export_s=export_s, load_s=load_s,
                          launches_per_forward=per_forward,
                          max_abs_err=err, max_abs_y=scale,
                          program_ms=program_ms, eager_ms=eager_ms,
                          artifact=sorted(p.name for p in
                                          out_dir.iterdir())),
        smi=smi,
        tolerance=f"TFLite card vs CPU <= 1 gray level, >= 99% equal, no "
                  f"K1-K4 launch; vs the native resnet's f32 forward the "
                  f"card's gap <= the CPU's max + 1 and mean +- 0.01; the "
                  f"exported program vs eager <= {FORMATS_EXPORT_REL} of "
                  f"max |y| in f32, 10 K1 + 2 K2 a forward")
    if problems:
        raise AssertionError(f"formats: {problems}")
    return seen


def resnet_train_export_phase(bidt, smi, read_counts, loop_run):
    """The resnet config at its full width (BatchNorm): one step on the
    card against the same step on the CPU from the same seeded weights and
    batch (noise and flips off); then ``train_loop`` for 4 steps on the
    train_loop phase's scenes from a seeded glorot init, ``export_model``,
    the exported ``batch_stats`` against the checkpoint's buffers bit for
    bit, and ``load_model`` serving b8 @ 256². Returns the launches of
    K1–K4 (none: the resnet runs in PyTorch ops, and its config takes
    the plain noise path)."""
    from blind_image_denoising_torch.data.dataset import dataset_builder
    from blind_image_denoising_torch.inference.export import export_model
    from blind_image_denoising_torch.models.hydra import model_builder
    from blind_image_denoising_torch.training import (
        build_train_step, create_train_state, loss_function_builder,
        optimizer_builder)
    from blind_image_denoising_torch.training.checkpoint import (
        CheckpointManager)
    from blind_image_denoising_torch.weights import (load_msgpack,
                                                     params_from_flax)

    base = bidt.CONFIGS_DICT[RESNET_CONFIG]
    work, image_dir = loop_run["work"], loop_run["image_dir"]
    cfg = copy.deepcopy(base)
    cfg["dataset"]["inputs"] = ([{"directory": str(image_dir)}]
                                if image_dir is not None else [])
    for key, value in RESNET_OVERRIDES.items():
        section, name = key.split(".")
        cfg[section][name] = value
    ds, grad_accum = cfg["dataset"], cfg["train"]["gpu_batches_per_step"]
    problems = []
    c_start = read_counts()

    # one step, card against CPU, from the same weights and batch
    batches = iter(dataset_builder(ds).training)
    clean = torch.from_numpy(np.concatenate(
        [next(batches) for _ in range(grad_accum)]))
    step_out = {}
    for device in ("cpu", "cuda"):
        hydra = model_builder(copy.deepcopy(cfg["model"])).hydra
        tx, _ = optimizer_builder(cfg["train"]["optimizer"])
        state = create_train_state(hydra, tx, seed=SEED, device=device)
        step = build_train_step(
            hydra, tx, loss_function_builder(cfg["loss"]), hydra.no_outputs,
            grad_accum=grad_accum, random_left_right=False,
            random_up_down=False, round_values=ds["round_values"])
        t0 = time.perf_counter()
        state, metrics = step(state, clean)
        loss = float(metrics["total_loss"])
        step_out[device] = (loss, time.perf_counter() - t0, {
            k: v.cpu() for k, v in hydra.named_buffers()})
        del hydra, state, step
    loss_rel = abs(step_out["cuda"][0] - step_out["cpu"][0]) / abs(
        step_out["cpu"][0])
    stats_rel = {k: float((step_out["cuda"][2][k] - v).abs().max()
                          / v.abs().max())
                 for k, v in step_out["cpu"][2].items()}
    worst_stat = max(stats_rel, key=stats_rel.get)
    if loss_rel > RESNET_LOSS_RTOL or stats_rel[worst_stat] > \
            RESNET_STATS_RTOL:
        problems.append(f"card vs CPU step: loss {loss_rel}, "
                        f"{worst_stat} {stats_rel[worst_stat]}")

    # the loop, then export and serve
    ckpt_dir, out_dir = work / "resnet_run", work / "resnet_artifact"
    with LoopProbe(read_counts) as probe:
        t0 = time.perf_counter()
        state = bidt.train_loop(cfg, ckpt_dir)
        loop_s = time.perf_counter() - t0
    rows = [json.loads(line) for line in
            (ckpt_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [r["total_loss"] for r in rows if "total_loss" in r]
    if state.step != RESNET_STEPS or len(losses) != RESNET_STEPS or not all(
            np.isfinite(losses)):
        problems.append(f"loop ran to {state.step}: losses {losses}")
    starts = [s["start"] for s in probe.steps]
    steady = [b - a for a, b in zip(starts[1:], starts[2:])]
    steps_per_s = 1.0 / statistics.median(steady)
    del state
    t0 = time.perf_counter()
    export_model(ckpt_dir / "config.json", ckpt_dir, out_dir)
    export_s = time.perf_counter() - t0
    manager = CheckpointManager(str(ckpt_dir))
    ckpt = manager.read(manager.latest_step())
    tree = load_msgpack(out_dir / "params.msgpack")
    stats = params_from_flax({"params": {},
                              "batch_stats": tree.get("batch_stats", {})})
    buffers = {k for k, v in ckpt["model"].items()
               if k.rsplit(".", 1)[-1] in ("mean", "var", "mean_sq")}
    stats_bad = sorted(k for k in stats
                       if not torch.equal(stats[k], ckpt["model"][k]))
    if set(stats) != buffers or not buffers or stats_bad:
        problems.append(f"batch_stats differ from the checkpoint: "
                        f"{len(stats)} vs {len(buffers)}, {stats_bad[:4]}")
    den = bidt.load_model(out_dir)
    rng = np.random.default_rng(SEED + 9)
    batch = add_noise(synthetic_images(EXPORT_BATCH, EXPORT_SIZE,
                                       EXPORT_SIZE, rng), 25.0, rng)
    out = den(batch)
    if out.shape != batch.shape or out.dtype != np.uint8:
        problems.append(f"served {out.shape} {out.dtype}")
    times = timed_requests(den, batch, EXPORT_REQUESTS)
    median = statistics.median(times)
    c_end = read_counts()
    launches = {k: c_end[k] - c_start[k] for k in c_end}
    result = dict(
        config=RESNET_CONFIG, overrides=RESNET_OVERRIDES,
        batch=ds["batch_size"], micro_batches=grad_accum,
        crop=ds["input_shape"], dtype=cfg["tpu"]["compute_dtype"],
        step_loss_card=step_out["cuda"][0], step_loss_cpu=step_out["cpu"][0],
        step_loss_rel=loss_rel, step_stats_worst_rel=stats_rel[worst_stat],
        step_stats_worst=worst_stat, running_statistics=len(stats_rel),
        cpu_step_s=step_out["cpu"][1], loop_s=loop_s, losses=losses,
        steady_step_s=[round(t, 4) for t in steady],
        steps_per_s=steps_per_s,
        images_per_s=steps_per_s * ds["batch_size"] * grad_accum,
        export_s=export_s, batch_stats_equal_checkpoint=not stats_bad,
        batch_stats=len(stats), serve_b8_256_median_s=median,
        serve_b8_256_images_per_s=EXPORT_BATCH / median,
        serve_b8_256_s=[round(t, 4) for t in times],
        launches=launches, smi=smi,
        tolerance=f"card vs CPU step loss rtol {RESNET_LOSS_RTOL}, running "
                  f"statistics {RESNET_STATS_RTOL} of each tensor's largest "
                  f"magnitude (PyTorch's default TF32 flags; the float32 "
                  f"model runs in exact float32); batch_stats = checkpoint "
                  f"bit for bit; 4 finite losses")
    log("resnet_train_export", **result)
    if problems:
        raise AssertionError(f"resnet_train_export: {problems}")
    del den
    torch.cuda.empty_cache()
    return launches


# the unet_laplacian_family phase: unet_laplacian_v4 at its full width and
# shipped size (filters 32, depth 4, width 3, encoder K 5, decoder K 1,
# attention gates, Laplacian upsample, strided downsample; b4 x 8
# micro-batches of 256^2, float32) trained from a seeded init on the
# train_loop phase's scenes; the cut is steps only: 4, with a checkpoint
# and a noise sweep at step 4
FAMILY_TRAIN = "unet_laplacian_v4"
FAMILY_SERVED = ("unet_laplacian_v3", "unet_laplacian_v5")
FAMILY_STEPS = 4
FAMILY_OVERRIDES = dict(LOOP_OVERRIDES, **{
    "train.total_steps": FAMILY_STEPS,
    "train.checkpoint_every": FAMILY_STEPS,
    "train.visualization_every": FAMILY_STEPS})
# launches per forward: K1 at every ConvNext unit (v3 / v4: 18, C = 32,
# 64 and 128, 9 of them the decoders' K = 1; v5: 12, its level 2 is its
# attention level), K2 per band split, and no unit on its PyTorch branch
# (layers/convnext.py kernel_route)
FAMILY_PER_FORWARD = {
    "unet_laplacian_v3": dict(convnext_block=18, band_smooth=3, branch=0),
    "unet_laplacian_v4": dict(convnext_block=18, band_smooth=3, branch=0),
    "unet_laplacian_v5": dict(convnext_block=12, band_smooth=2, branch=0)}
# per micro-batch of the v4 loop: K2 and its backward per band split, K3
FAMILY_PER_MICRO_BATCH = dict(band_smooth=3, band_smooth_bwd=3,
                              corrupt_noise=1)
FAMILY_STEP_LOSS_RTOL, FAMILY_STEP_MIN_COSINE = 1e-4, 0.9999
FAMILY_F32_MEAN, FAMILY_F32_EQUAL = 1.0, 0.99
# K1's timing rows on the family's path, (shape, K): the v4 / v5
# decoders' K = 1 at levels 0 and 1, and v4's level 2 (C = 128, the
# encoder's K = 5 and the decoder's K = 1), at b8 @ 256^2
FAMILY_K1_ROWS = [((8, 256, 256, 32), 1), ((8, 128, 128, 64), 1),
                  ((8, 64, 64, 128), 5), ((8, 64, 64, 128), 1)]


def family_forward_launches(den, img, read_counts, branch_units):
    """One request of ``den`` on ``img`` → (the answer, K1 / K2 launches
    and branch units it made)."""
    c0, b0 = read_counts(), branch_units()
    out = den(img)
    c1 = read_counts()
    launches = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
    branch = branch_units() - b0
    return out, dict(convnext_block=launches.pop("convnext_block", 0),
                     band_smooth=launches.pop("band_smooth", 0),
                     branch=branch, **launches)


def unet_laplacian_family_phase(bidt, smi, read_counts, loop_run,
                                keep=None):
    """``unet_laplacian_v4`` trained at its full width and shipped size
    through ``train_loop`` (4 steps from a seeded init, the cut), one f32
    train step card against CPU, ``export_model`` and ``load_model`` of
    the run in f32 and bf16 on b8 @ 256² and one 512² against the same
    artifact in f32 on the CPU; v3 and v5 built by the ``build`` CLI from a
    seeded init and served b8 @ 256². Exact launches per forward and per
    micro-batch. ``keep``: a directory to copy the v4 artifact and the
    noisy b8 @ 256² batch into (``tests/family_bf16_gap.py`` reads them).
    Returns (kernel inputs seen, launch counts of the phase, branch units
    per forward by config)."""
    from blind_image_denoising_torch import build as build_cli
    from blind_image_denoising_torch.inference.export import export_model
    from blind_image_denoising_torch.ops import pallas_convnext

    def branch_units():
        return pallas_convnext.branch_units

    work, image_dir = loop_run["work"], loop_run["image_dir"]
    base = copy.deepcopy(bidt.CONFIGS_DICT[FAMILY_TRAIN])
    cfg = copy.deepcopy(base)
    cfg["dataset"]["inputs"] = ([{"directory": str(image_dir)}]
                                if image_dir is not None else [])
    for key, value in FAMILY_OVERRIDES.items():
        section, name = key.split(".")
        cfg.setdefault(section, {})[name] = value
    ds, micro = cfg["dataset"], cfg["train"]["gpu_batches_per_step"]
    problems = []
    c_start = read_counts()
    rng = np.random.default_rng(SEED + 11)
    timings = {}
    with KernelInputs() as kernel_inputs:
        # one f32 step, card against CPU, same seeded weights and batch
        noise_kw = dict(additive_noise=ds["additional_noise"],
                        multiplicative_noise=ds["multiplicative_noise"])
        step_check = train_card_vs_cpu(
            cfg, None, synthetic_images(4, 128, 128, rng), noise_kw,
            card_dtype=None, loss_rtol=FAMILY_STEP_LOSS_RTOL,
            min_cosine=FAMILY_STEP_MIN_COSINE, phase="family_train_check")

        # the loop
        ckpt_dir = work / "family_run"
        with LoopProbe(read_counts) as probe:
            t0 = time.perf_counter()
            state = bidt.train_loop(cfg, ckpt_dir)
            timings["loop_s"] = time.perf_counter() - t0
        rows = [json.loads(line) for line in
                (ckpt_dir / "metrics.jsonl").read_text().splitlines()]
        losses = [r["total_loss"] for r in rows if "total_loss" in r]
        sweep = {k: v for r in rows for k, v in r.items()
                 if k.startswith("eval/")}
        if state.step != FAMILY_STEPS or len(losses) != FAMILY_STEPS or \
                not all(np.isfinite(losses)) or not sweep or not all(
                    np.isfinite(v) for v in sweep.values()):
            problems.append(f"loop ran to {state.step}: losses {losses}, "
                            f"sweep {sweep}")
        per_step = dict.fromkeys(read_counts(), 0)
        per_step.update({k: micro * v
                         for k, v in FAMILY_PER_MICRO_BATCH.items()})
        bad_steps = [s["launches"] for s in probe.steps
                     if s["launches"] != per_step]
        sweep_launches = [s["launches"] for s in probe.sweeps]
        per_fwd = FAMILY_PER_FORWARD[FAMILY_TRAIN]
        for launches in sweep_launches:
            n_fwd = launches["band_smooth"] // per_fwd["band_smooth"]
            if n_fwd < 1 or launches != dict(
                    dict.fromkeys(read_counts(), 0),
                    convnext_block=n_fwd * per_fwd["convnext_block"],
                    band_smooth=n_fwd * per_fwd["band_smooth"]):
                problems.append(f"sweep launches {launches}")
        if bad_steps or len(probe.steps) != FAMILY_STEPS or len(
                sweep_launches) != 1:
            problems.append(f"step launches {bad_steps[:2]}, "
                            f"{len(probe.steps)} steps, "
                            f"{len(sweep_launches)} sweeps")
        starts = [s["start"] for s in probe.steps]
        steady = [b - a for i, (a, b) in enumerate(zip(starts, starts[1:]))
                  if i > 0 and LOOP_PROFILE_STEP not in (i + 1, i + 2)]
        profile = json.loads((ckpt_dir / "profile" / "summary.json")
                             .read_text())
        del state
        torch.cuda.empty_cache()

        # export, then serve in f32 and bf16 against f32 on the CPU
        out_dir = work / "family_artifact"
        t0 = time.perf_counter()
        export_model(ckpt_dir / "config.json", ckpt_dir, out_dir)
        timings["export_s"] = time.perf_counter() - t0
        batch = add_noise(synthetic_images(EXPORT_BATCH, EXPORT_SIZE,
                                           EXPORT_SIZE, rng), 25.0, rng)
        big = add_noise(synthetic_images(1, 512, 512, rng), 25.0, rng)[0]
        cpu = bidt.load_model(out_dir, device="cpu", dtype="float32")
        t0 = time.perf_counter()
        cpu_outs = {"b8_256": cpu(batch), "1_512": cpu(big)}
        timings["cpu_f32_s"] = time.perf_counter() - t0
        del cpu
        served = {}
        for dtype in ("float32", "bfloat16"):
            den = bidt.load_model(out_dir, dtype=dtype)
            want = torch.bfloat16 if dtype == "bfloat16" else None
            if den.model.dtype != want:
                problems.append(f"{FAMILY_TRAIN} served as {den.model.dtype}")
            for name, img in (("b8_256", batch), ("1_512", big)):
                out, launches = family_forward_launches(
                    den, img, read_counts, branch_units)
                gap = gray_gap(out, cpu_outs[name])
                if dtype == "float32":
                    ok = gap["mean"] <= FAMILY_F32_MEAN and \
                        gap["equal_share"] >= FAMILY_F32_EQUAL
                else:
                    ok = gap["mean"] <= EXPORT_BF16_MEAN and \
                        gap["p99"] <= EXPORT_BF16_P99
                if not ok or launches != per_fwd:
                    problems.append(f"{FAMILY_TRAIN} {dtype} {name}: gap "
                                    f"{gap}, launches {launches}")
                served[f"{FAMILY_TRAIN}_{dtype}_{name}"] = dict(
                    vs_f32_cpu=gap, launches=launches)
            times = timed_requests(den, batch, EXPORT_REQUESTS)
            served[f"{FAMILY_TRAIN}_{dtype}_b8_256"].update(
                median_s=statistics.median(times),
                images_per_s=EXPORT_BATCH / statistics.median(times))
            del den

        if keep is not None:
            keep.mkdir(parents=True, exist_ok=True)
            for f in out_dir.iterdir():
                (keep / f.name).write_bytes(f.read_bytes())
            np.save(keep / "batch.npy", batch)

        # v3 and v5 from the build CLI's seeded artifacts
        for name in FAMILY_SERVED:
            build_dir = work / f"build_{name}"
            config_file = (Path(__file__).resolve().parent
                           / "blind_image_denoising_tpu" / "configs"
                           / f"{name}.json")
            t0 = time.perf_counter()
            if build_cli.main(["--pipeline-config", str(config_file),
                               "--output-directory", str(build_dir)]) != 0:
                problems.append(f"the build CLI failed on {name}")
            build_s = time.perf_counter() - t0
            (build_dir / "pipeline.json").write_text(
                config_file.read_text())
            want = FAMILY_PER_FORWARD[name]
            for dtype in ("float32", "bfloat16"):
                den = bidt.load_model(build_dir, dtype=dtype)
                out, launches = family_forward_launches(
                    den, batch, read_counts, branch_units)
                if launches != want or out.shape != batch.shape or \
                        out.dtype != np.uint8:
                    problems.append(f"{name} {dtype}: launches {launches}, "
                                    f"{out.shape} {out.dtype}")
                times = timed_requests(den, batch, EXPORT_REQUESTS)
                served[f"{name}_{dtype}_b8_256"] = dict(
                    launches=launches, build_cli_s=build_s,
                    median_s=statistics.median(times),
                    images_per_s=EXPORT_BATCH / statistics.median(times))
                del den
    c_end = read_counts()
    launches = {k: c_end[k] - c_start[k] for k in c_end}
    torch.cuda.empty_cache()
    result = dict(
        config=FAMILY_TRAIN, overrides=FAMILY_OVERRIDES,
        batch=ds["batch_size"], micro_batches=micro,
        crop=ds["input_shape"], dtype=cfg["tpu"]["compute_dtype"],
        step_check=dict(loss_rel=step_check["loss_rel_diff"],
                        grad_cosine=step_check["grad_cosine"]),
        losses=losses, sweep=sweep,
        launches_per_step=[s["launches"] for s in probe.steps][:1],
        launches_per_sweep=sweep_launches,
        step_host_s=[round(s["host_s"], 4) for s in probe.steps],
        steady_step_s=[round(t, 4) for t in steady],
        steps_per_s=(1.0 / statistics.median(steady) if steady else None),
        images_per_s=(ds["batch_size"] * micro / statistics.median(steady)
                      if steady else None),
        profiled_step=dict(profile, step=LOOP_PROFILE_STEP),
        served=served, timings=timings, launches=launches, smi=smi,
        tolerance=f"card vs CPU f32 step loss rtol {FAMILY_STEP_LOSS_RTOL}, "
                  f"grad cosine >= {FAMILY_STEP_MIN_COSINE}; f32 card vs CPU "
                  f"mean <= {FAMILY_F32_MEAN}, >= {FAMILY_F32_EQUAL} equal; "
                  f"bf16 card vs f32 CPU mean <= {EXPORT_BF16_MEAN}, p99 <= "
                  f"{EXPORT_BF16_P99}; per forward {FAMILY_PER_FORWARD}; per "
                  f"micro-batch {FAMILY_PER_MICRO_BATCH}, no K1")
    log("unet_laplacian_family", **result)
    if problems:
        raise AssertionError(f"unet_laplacian_family: {problems}")
    return kernel_inputs.seen, launches, {
        name: served[f"{name}_float32_b8_256"]["launches"]["branch"]
        for name in FAMILY_PER_FORWARD}


def family_k1_times(pallas_convnext, smi, seen):
    """K1 at ``FAMILY_K1_ROWS``, f32 and bf16, warm and cold, with the
    weights the family phase gave it (in the row's dtype), beside its
    bound and its library chain, at phase 3's bars
    (:func:`k1_row_time`)."""
    weights = {(shape[-1], k): kw for (shape, _, k), (_, kw) in
               seen["convnext_block"].items()}
    rows = []
    for shape, k in FAMILY_K1_ROWS:
        kw = weights[(shape[-1], k)]
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, device="cuda")
            wts = {n: v.to(dtype) for n, v in kw.items() if n != "slope"}
            rows.append(k1_row_time(
                pallas_convnext, "f32" if dtype == torch.float32 else "bf16",
                x, wts, kw["slope"], smi, None, path="unet_laplacian_family",
                calls_per_forward=3))
            del x
    return rows


# ------------------------------------------------- the depth-4 fused path

# unet_laplacian_v6 at its own filters (32), width (3) and K (5) with the
# depth set to 4 (self-attention at level 3, C = 256), seeded, bf16,
# levels 0-2 fused: 18 K1 a forward, 6 of them at (128, 5)
FUSED4_DEPTH = 4
FUSED4_LEVELS = (0, 1, 2)
FUSED4_PER_FORWARD = 18
FUSED4_C128_PER_FORWARD = 6
# K1 int8 at C = 128 on this path: codes within one of the plain
# version's on at least 99.9% of the outputs (C <= 64 keeps phase 3's
# share)
FUSED4_C128_SHARE_DIFFERING = 1e-3
# the int8 fused forward against the bf16 hydra: the fused phase's 4 gray
# levels (mean), or, where the seeded model's own int8 error (the same
# int8 forward and the hydra in float32 on an f32 copy of the weights,
# same scales) already reaches it, that error + 0.5 (the export's int8
# margin). On the CPU the depth-4 model's own error is 3.85 on 8 images
# and its bf16 int8 forward sits 4.04 from its bf16 hydra (the depth-3
# phase's model: 3.67 and 3.89)
FUSED4_INT8_OWN_MARGIN = 0.5


def fused_k1_against_plain(fused_module, pallas_convnext, forwards, x):
    """Run each fused forward of ``forwards`` (name -> forward) on ``x``
    with every K1 launch held against K1's plain version on the same
    input. Returns ({name: one record a launch}, {name: outputs}); a
    record has the unit's C and, in int8, the largest code difference and
    the share of codes that differ; in bf16 the largest difference and
    whether all are within max(0.05, 1 bf16 ulp); in float32 the largest
    difference and its ratio to max |plain output|."""
    real_k1 = fused_module.convnext_block
    on_path, outs = {}, {}
    records = []

    def against_plain(v, **kw):
        out = real_k1(v, **kw)
        ref = pallas_convnext.convnext_block_plain(v, **kw)
        d = (out.float() - ref.float()).abs()
        rec = dict(C=v.shape[-1])
        if v.dtype == torch.int8:
            rec.update(max_abs_code_diff=int(d.max()),
                       share_differing=float((d > 0).float().mean()))
        elif v.dtype == torch.float32:
            rec.update(max_abs_err=float(d.max()), relative_err=float(
                d.max() / ref.abs().max()))
        else:
            rec.update(max_abs_err=float(d.max()), within=bool(
                (d <= torch.clamp(bf16_ulp(ref), min=0.05)).all()))
        records.append(rec)
        return out

    fused_module.convnext_block = against_plain
    try:
        for name, fn in forwards.items():
            records = on_path[name] = []
            outs[name] = fn(x)
    finally:
        fused_module.convnext_block = real_k1
    return on_path, outs


def c128_of(shape_counts):
    """K1's launches at C = 128 in ``shape_counts`` (launches by (dtype
    name, C, K)), by dtype name."""
    out = {}
    for (dtype, c, _), n in shape_counts.items():
        if c == 128:
            out[dtype] = out.get(dtype, 0) + n
    return out


def c128_launches(pallas_convnext):
    """K1's launches at C = 128 since the counts were last set to 0, by
    dtype name."""
    return c128_of(pallas_convnext.shape_launches)


def fused_model_run(cfg, levels, rng, reset_counts, read_counts,
                    batch=FUSED_BATCH):
    """The fused path of the seeded bf16 model of ``cfg`` with ``levels``
    fused: calibrated on 8 images (4 clean, 4 at σ = 25;
    ``calibrate_fused(..., fused_levels=levels)``), then its float and int8
    fused forwards and its bf16 hydra on ``batch`` images of 256², each
    from counts set
    to 0 (``runs``: the kernels' counts, ``shapes``: K1's launches by
    (dtype name, C, K)); every K1 launch of the two fused forwards against
    its plain version on the same input (``on_path``); the finest scale of
    each fused output against the hydra's (``gaps``); the f32 fused
    forward (an f32 copy of the weights) on ``FUSED_CPU_IMAGES`` images on
    the card, through the kernel with every launch against its plain
    version (``f32_launches``) and with K1's plain version, against the
    CPU (``card32``, mean gray levels per scale), then once more with the
    counts set to 0 (K1's launches by shape: ``f32_shapes``); the model's
    own int8
    error (the int8 fused forward and the hydra in float32, the same
    scales: ``own_int8``), the finest scale of the bf16 hydra and of both
    fused forwards against that f32 hydra (``vs_f32_hydra``); and the three
    forwards timed (``timing``); the units that ran their PyTorch branch in
    each bf16 forward (``branch_units``)."""
    from blind_image_denoising_torch.inference import fused as fused_module
    from blind_image_denoising_torch.models.hydra import model_builder
    from blind_image_denoising_torch.ops import pallas_convnext
    from blind_image_denoising_torch.training.train_state import init_params
    model = model_builder(copy.deepcopy(cfg), dtype=torch.bfloat16).hydra
    init_params(model, torch.Generator().manual_seed(SEED))
    model = model.cuda().eval().requires_grad_(False)

    def nchw(a):
        return torch.from_numpy(np.asarray(a, np.float32)).permute(0, 3, 1, 2)

    cal_clean = synthetic_images(4, FUSED_SIZE, FUSED_SIZE, rng)
    cal = np.concatenate([cal_clean, add_noise(cal_clean, 25.0, rng)])
    x = nchw(add_noise(synthetic_images(batch, FUSED_SIZE, FUSED_SIZE,
                                        rng), 25.0, rng)).cuda()
    reset_counts()
    scales = fused_module.calibrate_fused(cfg, model, nchw(cal),
                                          fused_levels=levels)
    runs = {"calibrate": read_counts()}
    shapes = {"calibrate": dict(pallas_convnext.shape_launches)}
    fwd_float, sites = fused_module.build_fused_forward(
        cfg, model, fused_levels=levels)
    fwd_int8, _ = fused_module.build_fused_forward(
        cfg, model, scales, fused_levels=levels)

    def hydra(v):
        with torch.inference_mode():
            return model(v)

    forwards = {"fused_float": fwd_float, "fused_int8": fwd_int8,
                "hydra_bf16": hydra}
    outs, branch = {}, {}
    for name, fn in forwards.items():
        reset_counts()
        b0 = pallas_convnext.branch_units
        outs[name] = fn(x)
        torch.cuda.synchronize()
        runs[name] = read_counts()
        shapes[name] = dict(pallas_convnext.shape_launches)
        branch[name] = pallas_convnext.branch_units - b0
    gaps = {}
    for name in ("fused_float", "fused_int8"):
        d = (outs[name][0] - outs["hydra_bf16"][0]).abs()
        gaps[name] = dict(mean=float(d.mean()), p99=float(torch.quantile(
            d.flatten()[::97], 0.99)), max=float(d.max()))
    # every K1 launch of the two bf16 fused forwards against its plain
    # version on the same input
    on_path, _ = fused_k1_against_plain(
        fused_module, pallas_convnext,
        {"fused_float": fwd_float, "fused_int8": fwd_int8}, x)
    # the f32 float fused forward (an f32 copy of the weights): every K1
    # launch on the card against its plain version, then the rest of the
    # path, on the card with K1's plain version, against the CPU. A deep
    # seeded model carries K1's float32-level differences (inside
    # K1_F32_RELATIVE) to ~1e-3 gray levels at the 1/2 scale (depth 4,
    # with level 2 fused or not), so the forward through the kernel is
    # read beside it
    m32 = model_builder(copy.deepcopy(cfg)).hydra
    m32.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    m32.eval().requires_grad_(False)
    x_cpu = x[:FUSED_CPU_IMAGES].cpu()
    ref32 = fused_module.build_fused_forward(
        cfg, m32, dtype=torch.float32, fused_levels=levels)[0](x_cpu)
    fwd32 = fused_module.build_fused_forward(
        cfg, m32.cuda(), dtype=torch.float32, fused_levels=levels)[0]
    x32 = x[:FUSED_CPU_IMAGES]
    f32_on_path, got32 = fused_k1_against_plain(
        fused_module, pallas_convnext, {"kernel": fwd32}, x32)
    real_k1 = fused_module.convnext_block
    fused_module.convnext_block = pallas_convnext.convnext_block_plain
    try:
        got32["plain_k1"] = fwd32(x32)
    finally:
        fused_module.convnext_block = real_k1
    reset_counts()
    fwd32(x32)
    torch.cuda.synchronize()
    f32_shapes = dict(pallas_convnext.shape_launches)
    read_counts()
    card32 = {name: [float((g.cpu() - r).abs().mean()) for g, r in
                     zip(outs32, ref32)] for name, outs32 in got32.items()}
    # the model's own int8 error: the int8 fused forward and the hydra in
    # float32 (the f32 copy, on the card), the same scales; and the finest
    # scale of the bf16 hydra and of the float fused forward against that
    # f32 hydra
    int8_f32 = fused_module.build_fused_forward(
        cfg, m32, scales, dtype=torch.float32, fused_levels=levels)[0](x)[0]
    with torch.inference_mode():
        hydra32 = m32(x)[0]
    own_int8 = float((int8_f32 - hydra32).abs().mean())
    vs_f32 = {name: float((outs[name][0].float() - hydra32).abs().mean())
              for name in ("hydra_bf16", "fused_float", "fused_int8")}
    del m32, int8_f32, hydra32
    timing = {name: dict(zip(("forward_ms_median", "forward_ms"),
                             forward_event_ms(lambda: fn(x))))
              for name, fn in forwards.items()}
    for t in timing.values():
        t["images_per_s"] = batch / t["forward_ms_median"] * 1e3
    return dict(model=model, x=x, sites=len(sites), calibration_images=len(
        cal), runs=runs, shapes=shapes, outs=outs, gaps=gaps,
        branch_units=branch, on_path=on_path,
        f32_launches=f32_on_path["kernel"], f32_shapes=f32_shapes,
        card32=card32,
        own_int8=own_int8, vs_f32_hydra=vs_f32, timing=timing)


def fused_depth4_phase(v6cfg, rng, smi, read_counts, counts, reset_counts,
                       share_differing):
    """The fused path with level 2 fused: the depth-4 ``unet_laplacian_v6``
    (``FUSED4_*``) through :func:`fused_model_run` with
    ``fused_levels=FUSED4_LEVELS``: exact launches (18 K1 a fused forward,
    6 at C = 128), every K1 launch of the two fused forwards against its
    plain version on the same input, the fused outputs against the
    hydra's (float <= ``FUSED_FLOAT_VS_HYDRA_MEAN``, int8 <= 4 mean gray
    levels, or the model's own int8 error + 0.5 where that reaches 4:
    ``FUSED4_INT8_OWN_MARGIN``), the f32 fused forward with every K1
    launch against its plain version (1e-3 and ``K1_F32_RELATIVE`` of max
    |plain output|) and the rest of the path, on the card with K1's plain
    version, against the CPU (<= ``FUSED_F32_CARD_VS_CPU_MEAN`` on every
    scale; the forward through the kernel against the CPU is read), the
    three forwards timed, and K1 int8 at (128, 5) on 32×64²×128 timed.
    Returns (launch counts summed over the phase, C = 128 launches by path
    and dtype, the largest bf16 and int8 differences of the C = 128
    launches from their plain versions, the int8 (128, 5) timing
    entry)."""
    from blind_image_denoising_torch.ops import pallas_convnext
    cfg = copy.deepcopy(v6cfg)
    cfg["backbone"]["depth"] = FUSED4_DEPTH
    run = fused_model_run(cfg, FUSED4_LEVELS, rng, reset_counts,
                          read_counts)
    model, x, runs, on_path = (run["model"], run["x"], run["runs"],
                               run["on_path"])
    outs, gaps, card32, own_int8 = (run["outs"], run["gaps"], run["card32"],
                                    run["own_int8"])
    f32_launches, timing = run["f32_launches"], run["timing"]
    c128 = {name: c128_of(sh) for name, sh in run["shapes"].items()}
    ncal = run["calibration_images"]
    want = {"calibrate": counts(convnext_block=FUSED4_PER_FORWARD * ncal),
            "fused_float": counts(convnext_block=FUSED4_PER_FORWARD),
            "fused_int8": counts(convnext_block_int8=FUSED4_PER_FORWARD),
            "hydra_bf16": counts(convnext_block=FUSED4_PER_FORWARD,
                                 band_smooth=FUSED4_DEPTH - 1)}
    want_c128 = {"calibrate": {"bfloat16": FUSED4_C128_PER_FORWARD * ncal},
                 "fused_float": {"bfloat16": FUSED4_C128_PER_FORWARD},
                 "fused_int8": {"int8": FUSED4_C128_PER_FORWARD},
                 "hydra_bf16": {"bfloat16": FUSED4_C128_PER_FORWARD}}
    card_vs_cpu = card32["plain_k1"]
    int8_bar = max(4.0, own_int8 + FUSED4_INT8_OWN_MARGIN)

    # K1 int8 at (128, 5) on the fused path's level-2 shape, timed
    b, hw = FUSED_BATCH, FUSED_SIZE >> 2
    xu, wts, slope = unit_inputs(model, "encoder_2_0", b, hw, hw,
                                 torch.bfloat16, rng)
    c, k = xu.shape[-1], wts["dw"].shape[-1]
    s_in, s_out = float(xu.abs().max()) / 127, 4 * float(
        xu.abs().max()) / 127
    xq = pallas_convnext.quantize(xu, s_in)
    q = dict(scale_in=s_in, scale_out=s_out, slope=slope)
    dcode = (pallas_convnext.convnext_block(xq, **q, **wts).int()
             - pallas_convnext.convnext_block_plain(xq, **q, **wts).int()
             ).abs()
    t = dict(
        ms=cuda_ms(lambda: pallas_convnext.convnext_block(xq, **q, **wts)),
        cold_ms=cuda_ms(lambda xc: pallas_convnext.convnext_block(
            xc, **q, **wts), inputs=cold_copies(xq)),
        plain_ms=cuda_ms(lambda: pallas_convnext.convnext_block_plain(
            xq, **q, **wts), iters=3, warmup=1),
        library_ms=cuda_ms(lambda: convnext_int8_library(
            xq, s_in, s_out, slope=slope, **wts)))
    bound, by = convnext_bound_ms(b, hw, hw, c, k, torch.int8)
    timed = dict(max_abs_code_diff=int(dcode.max()),
                 share_differing=float((dcode > 0).float().mean()))
    log("time", path="fused_depth4", kernel="convnext_block_int8", C=c, K=k,
        shape=[b, hw, hw, c], calls_per_forward=FUSED4_C128_PER_FORWARD,
        bound_ms=bound, bound_by=by, share_cold=bound / t["cold_ms"],
        smi=smi, **timed, **t)
    del xu, xq, dcode

    c128_int8 = [r for r in on_path["fused_int8"] if r["C"] == 128]
    c128_bf16 = [r for r in on_path["fused_float"] if r["C"] == 128]
    result = dict(
        config=FUSED_CONFIG, depth=FUSED4_DEPTH, fused_levels=FUSED4_LEVELS,
        batch=list(x.shape), dtype="bf16", sites=run["sites"],
        launches=runs, c128_launches=c128,
        k1_on_path=dict(
            int8_max_abs_code_diff=max(r["max_abs_code_diff"]
                                       for r in on_path["fused_int8"]),
            int8_share_differing_c128=[r["share_differing"]
                                       for r in c128_int8],
            int8_share_differing_max_c_le_64=max(
                r["share_differing"] for r in on_path["fused_int8"]
                if r["C"] <= 64),
            bf16_max_abs_err=max(r["max_abs_err"]
                                 for r in on_path["fused_float"]),
            bf16_max_abs_err_c128=max(r["max_abs_err"] for r in c128_bf16)),
        finest_vs_hydra_bf16_gray_levels=gaps,
        own_int8_error_f32_gray_levels=own_int8,
        f32_card_vs_cpu_mean_gray_levels_per_scale=card32,
        k1_f32_on_path=dict(
            max_relative_err=max(r["relative_err"] for r in f32_launches),
            max_relative_err_c128=max(r["relative_err"] for r in f32_launches
                                      if r["C"] == 128),
            max_abs_err=max(r["max_abs_err"] for r in f32_launches)),
        cpu_images=FUSED_CPU_IMAGES, timing=timing, smi=smi,
        tolerance=dict(
            launches=f"{FUSED4_PER_FORWARD} K1 a fused forward, "
                     f"{FUSED4_C128_PER_FORWARD} at C = 128",
            k1_bf16="max(0.05, 1 bf16 ulp)",
            k1_f32=f"1e-3 and {K1_F32_RELATIVE} x max |plain output|",
            f32_card_vs_cpu="the path with K1's plain version on the card "
                            "against the CPU (plain_k1); the path through "
                            "the kernel (kernel) is read",
            k1_int8=f"|code diff| <= 1, share differing <= "
                    f"{share_differing} (C <= 64), "
                    f"{FUSED4_C128_SHARE_DIFFERING} (C = 128)",
            f32_card_vs_cpu_mean=FUSED_F32_CARD_VS_CPU_MEAN,
            float_vs_hydra_mean=FUSED_FLOAT_VS_HYDRA_MEAN,
            int8_vs_hydra_mean=int8_bar))
    log("fused_depth4", **result)
    problems = []
    if runs != want or c128 != want_c128:
        problems.append(f"launches {runs}, C = 128 {c128}")
    for name, o in outs.items():
        if [tuple(v.shape) for v in o] != [
                (FUSED_BATCH, 3, FUSED_SIZE >> i, FUSED_SIZE >> i)
                for i in range(FUSED4_DEPTH)] or not all(
                    bool(torch.isfinite(v).all()) for v in o):
            problems.append(f"{name}: bad outputs")
    if [len(v) for v in on_path.values()] != [FUSED4_PER_FORWARD] * 2 or \
            len(c128_int8) != FUSED4_C128_PER_FORWARD or not all(
                r["within"] for r in on_path["fused_float"]) or not all(
                r["max_abs_code_diff"] <= 1 and r["share_differing"] <= (
                    FUSED4_C128_SHARE_DIFFERING if r["C"] == 128
                    else share_differing) for r in on_path["fused_int8"]):
        problems.append(f"K1 on the path disagrees with its plain version: "
                        f"{on_path}")
    if timed["max_abs_code_diff"] > 1 or \
            timed["share_differing"] > FUSED4_C128_SHARE_DIFFERING:
        problems.append(f"K1 int8 (128, 5) timing input: {timed}")
    if max(card_vs_cpu) > FUSED_F32_CARD_VS_CPU_MEAN:
        problems.append(f"f32 fused card vs CPU {card32}")
    if len(f32_launches) != FUSED4_PER_FORWARD or not all(
            r["max_abs_err"] <= 1e-3 and r["relative_err"] <= K1_F32_RELATIVE
            for r in f32_launches):
        problems.append(f"K1 f32 on the path: {f32_launches}")
    if not gaps["fused_float"]["mean"] <= FUSED_FLOAT_VS_HYDRA_MEAN or \
            not gaps["fused_int8"]["mean"] <= int8_bar:
        problems.append(f"fused vs hydra {gaps}")
    if problems:
        raise AssertionError(f"fused_depth4: {problems}")
    total = {key: sum(r[key] for r in runs.values()) for key in runs[
        "calibrate"]}
    c128_total = {}
    for per in c128.values():
        for dtype, n in per.items():
            c128_total[dtype] = c128_total.get(dtype, 0) + n
    errors = dict(
        bf16=max(r["max_abs_err"] for r in c128_bf16),
        int8=max(timed["max_abs_code_diff"],
                 max(r["max_abs_code_diff"] for r in c128_int8)))
    return total, c128_total, errors, (FUSED4_C128_PER_FORWARD, t, bound, by)


# --------------------------------------------- the fused path's widths

# unet_laplacian_v6 at its own filters (32), width (3) and K (5) with the
# depth set to 5, seeded, bf16: (a) the config's level widths, C =
# 32/64/128/256 (self-attention at level 4), levels 0-3 fused, 24 K1 a
# fused forward, 6 at (256, 5); (b) filters_level_multiplier 1.5, C =
# 32/48/72/108 (level 4, C = 162, is the attention level), levels 0-3
# fused, 6 K1 each at (32, 5), (48, 5), (72, 5) and (108, 5), at b32 @ 256²;
# (c) without self-attention, C = 32/64/128/256/512, every level fused, 27
# K1 a forward, 3 at (512, 5) (level 4 has no decoder stage), at b8 @ 256²;
# (d) as (c) at depth 6, C = 32 ... 1024, every level fused, 33 K1 a
# forward, 6 at (512, 5) and 3 at (1024, 5), at b8 @ 256² (level 5 at 8²);
# (e) as (c) at depth 7, C = 32 ... 2048, every level fused, 39 K1 a
# forward, 3 at (2048, 5) on K1's general route, at b8 @ 256² (level 6 at
# 4²).
# name -> (overrides, fused levels, batch)
FUSEDW_DEPTH = 5
FUSEDW_LEVELS = (0, 1, 2, 3)
FUSEDW_MODELS = {"c256": ({}, FUSEDW_LEVELS, FUSED_BATCH),
                 "x1.5": ({"filters_level_multiplier": 1.5}, FUSEDW_LEVELS,
                          FUSED_BATCH),
                 "c512": ({"use_self_attention": False}, (0, 1, 2, 3, 4), 8),
                 "c1024": ({"use_self_attention": False, "depth": 6},
                           (0, 1, 2, 3, 4, 5), 8),
                 "c2048": ({"use_self_attention": False, "depth": 7},
                           (0, 1, 2, 3, 4, 5, 6), 8)}
# the fused forwards against the bf16 hydra: the fused phase's bars (float
# 2.0 gray levels, int8 max(4, the model's own int8 error in f32 + 0.5)), or,
# where the seeded model's roundings already spread past them, no farther
# from its float32 hydra than its bf16 hydra (float) or its f32 int8 forward
# (int8) is, + 0.5. JAX's own bf16 fused forward sits 3.30 (multiplier 1.5)
# and 2.81 (C = 256) gray levels from its bf16 hydra on these depth-5 models
# (CPU, b1 @ 128²; the port's 2.65 and 2.20)
FUSEDW_OWN_MARGIN = 0.5
# K1 at the classes' shapes and (64, 3), (128, 3), timed (dtype, C, K, B,
# H = W, the unit whose weights it takes: a model of FUSEDW_MODELS and a
# unit, or None for the card tests' seeded weights): (256, 5) at a depth-5
# fused forward's level 3 in bf16 and int8 (b32 @ 256²) and in f32 (b8), the
# multiplier-1.5 model's levels 1-3 in bf16, its level 1 in int8 and f32,
# (48, 7) at its level 1's pixels, (128, 5) at the C = 256 model's level 2,
# and (64, 3) / (128, 3) at b8 @ 256²'s levels 1 and 2. The rows of
# FUSEDW_TIMED_ONLY are timed beside the others and not summed into the
# kernels line's per-forward rows
FUSEDW_TIMED_ONLY = {("int8", 48, 5), ("f32", 48, 5), ("bf16", 128, 5)}
FUSEDW_K1_ROWS = [("bf16", 256, 5, 32, 32, ("c256", "encoder_3_0")),
                  ("int8", 256, 5, 32, 32, ("c256", "encoder_3_0")),
                  ("f32", 256, 5, 8, 32, ("c256", "encoder_3_0")),
                  ("bf16", 48, 5, 32, 128, ("x1.5", "encoder_1_0")),
                  ("bf16", 72, 5, 32, 64, ("x1.5", "encoder_2_0")),
                  ("bf16", 108, 5, 32, 32, ("x1.5", "encoder_3_0")),
                  ("int8", 48, 5, 32, 128, ("x1.5", "encoder_1_0")),
                  ("f32", 48, 5, 8, 128, ("x1.5", "encoder_1_0")),
                  ("bf16", 48, 7, 32, 128, None),
                  ("bf16", 128, 5, 32, 64, ("c256", "encoder_2_0")),
                  ("bf16", 64, 3, 8, 128, None),
                  ("bf16", 128, 3, 8, 64, None),
                  ("bf16", 512, 5, 8, 16, ("c512", "encoder_4_0")),
                  ("int8", 512, 5, 8, 16, ("c512", "encoder_4_0")),
                  ("f32", 512, 5, 8, 16, ("c512", "encoder_4_0")),
                  ("bf16", 1024, 5, 8, 8, ("c1024", "encoder_5_0")),
                  ("int8", 1024, 5, 8, 8, ("c1024", "encoder_5_0")),
                  ("f32", 1024, 5, 8, 8, ("c1024", "encoder_5_0")),
                  ("bf16", 2048, 5, 8, 4, ("c2048", "encoder_6_0")),
                  ("int8", 2048, 5, 8, 4, ("c2048", "encoder_6_0")),
                  ("f32", 2048, 5, 8, 4, ("c2048", "encoder_6_0")),
                  ("bf16", 32, 9, 8, 256, None)]
# the general route at shapes the one-pass clusters take, a reading beside
# their rows (``convnext_block(..., general=True)``; not rerouted): (512, 5)
# 8×16² and (1024, 5) 8×8² bf16 on the models' weights
FUSEDW_GENERAL_READINGS = [("bf16", 512, 5, 8, 16, ("c512", "encoder_4_0")),
                           ("bf16", 1024, 5, 8, 8,
                            ("c1024", "encoder_5_0"))]


def fusedw_depth(name):
    """The depth of the fused_widths model ``name``."""
    return FUSEDW_MODELS[name][0].get("depth", FUSEDW_DEPTH)


def seeded_unit_weights(c, k, seed=0):
    """tests/test_torch_cuda.py's seeded unit weights, on the card."""
    rng = np.random.default_rng(seed)
    e = 4 * c
    t = lambda a: torch.tensor(a, dtype=torch.float32).cuda()  # noqa
    return dict(dw=t(rng.normal(0, 0.3, (c, 1, k, k))),
                ln_scale=t(rng.uniform(0.5, 1.5, (c,))),
                w2=t(rng.normal(0, 1.0 / np.sqrt(c), (e, c))),
                w3=t(rng.normal(0, 1.0 / np.sqrt(e), (c, e))),
                gain=t(rng.uniform(0.3, 0.9, (c,))))


# rows before their layout's last redesign (PERF.md §6's table: this
# script's cold ms, operands prepared on every call): the streamed layouts
# before their chunks became a bulk-copy ring (on ``cedafbd``) and K = 7's
# own layouts before their depthwise reused its taps (on ``a28c11e``), by
# (mode, C, K, shape)
PARENT_K1_COLD_MS = {
    ("bf16", 32, 7, (8, 256, 256, 32)): 0.1277,
    ("bf16", 64, 7, (8, 128, 128, 64)): 0.0777,
    ("int8", 32, 7, (8, 256, 256, 32)): 0.1202,
    ("int8", 64, 7, (8, 128, 128, 64)): 0.0748,
    ("f32", 128, 5, (8, 64, 64, 128)): 0.2018,
    ("f32", 128, 1, (8, 64, 64, 128)): 0.1853,
    ("bf16", 128, 5, (8, 64, 64, 128)): 0.0594,
    ("bf16", 128, 1, (8, 64, 64, 128)): 0.0496,
    ("int8", 128, 5, (32, 64, 64, 128)): 0.1872,
    ("bf16", 128, 3, (8, 64, 64, 128)): 0.0493,
    ("bf16", 256, 5, (32, 32, 32, 256)): 0.2417,
    ("int8", 256, 5, (32, 32, 32, 256)): 0.2381,
    ("f32", 256, 5, (8, 32, 32, 256)): 0.2234,
    ("bf16", 108, 5, (32, 32, 32, 108)): 0.0777}


# the benchmarking phase: bench.py's protocol (K values and repeats)
BENCH_K_VALUES = (5, 15, 30)
BENCH_REPS = 5


def benchmarking_phase(pallas_convnext, model, state, step, batch, dw,
                       smi):
    """The port's ``benchmarking`` module on the card, ``bench.py``'s
    protocol: ``time_chain_slope`` (K 5 / 15 / 30 chained applications, 5
    repeats, each chain ended by one ``float`` of a scalar) and
    ``roofline_check`` of its time a unit against ``cost_bytes`` of one
    application, for K1 (32, 3) alone on 8×256² bf16 (the flagship's
    ``encoder_0_0`` weights, operands prepared once, chained on its own
    output), the flagship served b8 @ 256² (its bf16 hydra's forward,
    chained on its finest output as ``bench.py`` chains it) and the train
    step b16 @ 128² (bf16, the noise kernel, chained on its state; the
    last step's loss read). Logs one line each; raises where K1's row
    reads ``ok: false`` (a time below its own bytes over the HBM rate)."""
    rng = np.random.default_rng(SEED + 26)
    x, wts, slope = unit_inputs(model, "encoder_0_0", 8, 256, 256,
                                torch.bfloat16, rng)
    ops = pallas_convnext.kernel_operands(x.dtype, **wts)

    def k1(v):
        return pallas_convnext.convnext_block(v, slope=slope, operands=ops,
                                              **wts)

    images = torch.from_numpy(add_noise(synthetic_images(
        8, 256, 256, rng), 25.0, rng).astype(np.float32)).permute(
            0, 3, 1, 2).contiguous().cuda()

    def serve(v):
        with torch.inference_mode():
            return model(v)[0].float()

    def train(st):
        return step(st, batch, depth_weights=dw)

    def chained(apply, read):
        def make_chain(k):
            def chain(v):
                for _ in range(k):
                    v = apply(v)
                return read(v)
            return chain
        return make_chain

    items = {
        "convnext_block (32,3) 8x256^2 bf16": (
            chained(k1, lambda v: v.float().sum()), x, k1),
        "flagship served b8 @ 256^2 bf16": (
            chained(serve, lambda v: v.sum()), images, serve),
        f"train step b{TRAIN_BATCH} @ {TRAIN_SIZE}^2 bf16": (
            chained(lambda st: train(st[0]), lambda st: st[1][
                "total_loss"]), (state, None), lambda st: train(st[0])),
    }
    rows = {}
    for name, (make_chain, arg, once) in items.items():
        result = time_chain_slope(make_chain, (arg,), k_values=BENCH_K_VALUES,
                                  reps=BENCH_REPS)
        nbytes = cost_bytes(once, arg)
        roof = roofline_check(result["unit_s"], nbytes)
        rows[name] = dict(result, bytes_per_unit=nbytes, **roof)
        log("benchmarking", item=name, unit_ms=result["unit_s"] * 1e3,
            slope_spread_ms=[t * 1e3 for t in result["slope_spread_s"]],
            r2=result["r2"], times_s=result["times"],
            bytes_per_unit=nbytes, roofline_unit_ms=roof[
                "roofline_unit_s"] * 1e3,
            fraction_of_roofline=roof["fraction_of_roofline"],
            ok=roof["ok"], k_values=BENCH_K_VALUES, reps=BENCH_REPS,
            smi=smi)
    k1_row = rows["convnext_block (32,3) 8x256^2 bf16"]
    if not k1_row["ok"]:
        raise AssertionError(f"benchmarking: K1's time beats its bytes "
                             f"over the HBM rate: {k1_row}")
    return rows


def general_split_ms(fn, n=5):
    """Device ms a call of each of K1's general route's three kernels
    (torch.profiler over ``n`` calls of ``fn``): the depthwise +
    LayerNorm pass, the expansion and the projection. A diagnostic: on
    the H100 the profiler kept only part of these launches, so the parts
    under-count and only their shares may be read."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    split = dict(depthwise_layernorm=0.0, expansion=0.0, projection=0.0)
    for evt in prof.key_averages():
        if "general_dwln_kernel" in evt.key:
            part = "depthwise_layernorm"
        elif "general_gemm_kernel" in evt.key:
            part = ("projection" if "true>" in evt.key or "Lb1E" in evt.key
                    else "expansion")
        else:
            continue
        split[part] += device_us(evt, "self_") / n / 1e3
    return split


def k1_row_time(pallas_convnext, mode, x, wts, slope, smi, share_differing,
                general=False, **fields):
    """K1 on ``x`` (float32; ``mode`` "f32", "bf16" or "int8", whose scales
    are 1/127 and 4/127 of max |x|) warm and cold beside its bound, its
    plain version and its library chain, through the wrapper as a caller
    of ``convnext_block(x, dw, ...)`` has it (the operands prepared on
    every call), its output held to phase 3's bars (bf16 max(0.05, 1 ulp);
    f32 1e-3 and ``K1_F32_RELATIVE`` of max |plain output|; int8 one code
    on at most ``share_differing`` of the outputs) and to the bits of a
    launch on the operands prepared once, as the model's units launch it.
    Logs and returns the row, with the parent's cold ms
    (``PARENT_K1_COLD_MS``) where the row's layout was redesigned; raises
    past a bar. ``general``: the general route whatever the shape (a
    reading; its operands prepared once are ``kernel_operands(...,
    general=True)``)."""
    from blind_image_denoising_torch.ops.precision import exact_float32
    b, h, w, c = x.shape
    parent = PARENT_K1_COLD_MS.get((mode, c, wts["dw"].shape[-1],
                                    (b, h, w, c)))
    if parent is not None:
        fields = dict(fields, parent_cold_ms=parent)
    k = wts["dw"].shape[-1]
    kw = dict(slope=slope)
    if mode == "int8":
        s_in, s_out = float(x.abs().max()) / 127, 4 * float(
            x.abs().max()) / 127
        x = pallas_convnext.quantize(x, s_in)
        kw.update(scale_in=s_in, scale_out=s_out)
        library = lambda: convnext_int8_library(  # noqa: E731
            x, s_in, s_out, slope=slope, **wts)
    else:
        x = x.to(torch.float32 if mode == "f32" else torch.bfloat16)
        library = lambda: convnext_library(  # noqa: E731
            x, slope=slope, **{n: v.to(x.dtype) for n, v in wts.items()})
    if general or pallas_convnext.runs_general(c, k, wts["w2"].shape[0]):
        fields = dict(fields, route="general")
    kwk = dict(kw, general=general)      # the kernel's call
    ops = pallas_convnext.kernel_operands(x.dtype, **wts, general=general)
    with exact_float32():                # the f32 library chain: TF32 off
        got = pallas_convnext.convnext_block(x, **kwk, **wts)
        cached = pallas_convnext.convnext_block(x, **kwk, **wts,
                                                operands=ops)
        ref = pallas_convnext.convnext_block_plain(x, **kw, **wts)
        t = dict(
            ms=cuda_ms(lambda: pallas_convnext.convnext_block(x, **kwk,
                                                              **wts)),
            cold_ms=cuda_ms(lambda xc: pallas_convnext.convnext_block(
                xc, **kwk, **wts), inputs=cold_copies(x)),
            plain_ms=cuda_ms(lambda: pallas_convnext.convnext_block_plain(
                x, **kw, **wts), iters=3, warmup=1),
            library_ms=cuda_ms(library))
        if fields.get("route") == "general":
            fields = dict(fields, general_split_ms=general_split_ms(
                lambda: pallas_convnext.convnext_block(x, **kwk, **wts,
                                                       operands=ops)))
    diff = (got.float() - ref.float()).abs()
    err = float(diff.max())
    if not torch.equal(got, cached):
        raise AssertionError(f"K1 {mode} {[b, h, w, c]} K={k}: the prepared "
                             f"operands gave other bits")
    if mode == "int8":
        share = float((diff > 0).float().mean())
        ok = err <= 1 and share <= share_differing
        extra = dict(share_differing=share)
    elif mode == "f32":
        ok = err <= 1e-3 and err <= K1_F32_RELATIVE * float(ref.abs().max())
        extra = dict(bound_cuda_cores_ms=convnext_bound_ms(
            b, h, w, c, k, x.dtype, cuda_cores=True)[0])
    else:
        ok = bool((diff <= torch.clamp(bf16_ulp(ref), min=0.05)).all())
        extra = {}
    bound, by = convnext_bound_ms(b, h, w, c, k, x.dtype)
    row = dict(kernel="convnext_block" + ("_int8" if mode == "int8" else ""),
               C=c, K=k, shape=[b, h, w, c], dtype=str(x.dtype).split(".")[-1],
               bound_ms=bound, bound_by=by, share_cold=bound / t["cold_ms"],
               max_abs_err=err, **extra, **fields, smi=smi, **t)
    log("time", **row)
    if not ok:
        raise AssertionError(f"K1 {mode} {[b, h, w, c]} K={k}: {row}")
    return row


def fused_widths_phase(v6cfg, rng, smi, read_counts, counts, reset_counts,
                       share_differing):
    """The fused path at the widths K1's classes serve: the three depth-5
    ``unet_laplacian_v6`` models of ``FUSEDW_MODELS`` and the depth-6 one
    through :func:`fused_model_run` with their fused levels: exact
    launches (24 K1 a fused forward and a hydra forward, 6 at each level's
    (C, 5); 27 without self-attention, 3 at (512, 5); 33 at depth 6, 3 at
    (1024, 5); the same in the f32 fused forward; 0 units on their
    PyTorch branch), every K1 launch of the two
    fused forwards against its plain version on the same input (bf16
    max(0.05, 1 ulp); int8 one code on at most ``share_differing`` of the
    outputs at C <= 64, ``FUSED4_C128_SHARE_DIFFERING`` from C = 128; f32
    1e-3 and ``K1_F32_RELATIVE`` of max |plain output|), the fused outputs
    against the hydra's (float <= ``FUSED_FLOAT_VS_HYDRA_MEAN``, int8 <= 4
    mean gray levels or the model's own int8 error +
    ``FUSED4_INT8_OWN_MARGIN``; or, where the seeded model's roundings
    spread past those, each no farther from its f32 hydra than the bf16
    hydra (float) or the f32 int8 forward (int8) + ``FUSEDW_OWN_MARGIN``),
    the f32 fused
    forward with K1's plain version on the card against the CPU (<=
    ``FUSED_F32_CARD_VS_CPU_MEAN``; through the kernel read), the forwards
    timed; then K1 at ``FUSEDW_K1_ROWS`` timed, and the general route at
    ``FUSEDW_GENERAL_READINGS`` (a reading). Returns (launch counts summed
    over the phase, K1's launches by (dtype name, C, K), the largest bf16
    and int8 differences from their plain versions of the launches off the
    (C, K) of their own up to C = 256, the bf16, int8 and f32 ones at
    256 < C <= 512, at 512 < C <= 1024 and above (the general route), the
    timed rows)."""
    from blind_image_denoising_torch.ops import pallas_convnext

    def int8_share(c):
        # the depth-4 phase's rule: C <= 64 keeps phase 3's share; from
        # C = 128 an output sums 4C = 512 or more products in another order
        # than the plain version, and more codes sit near x.5
        return share_differing if c <= 64 else FUSED4_C128_SHARE_DIFFERING

    models, problems = {}, []
    total, by_shape = None, {}
    errors = dict(bf16=0.0, int8=0, bf16_c512=0.0, int8_c512=0,
                  bf16_c1024=0.0, int8_c1024=0, f32_c512=0.0, f32_c1024=0.0,
                  bf16_general=0.0, int8_general=0, f32_general=0.0)
    for name, (overrides, fused_levels, batch) in FUSEDW_MODELS.items():
        depth = fusedw_depth(name)
        cfg = copy.deepcopy(v6cfg)
        cfg["backbone"].update(depth=FUSEDW_DEPTH)
        cfg["backbone"].update(overrides)
        run = fused_model_run(cfg, fused_levels, rng, reset_counts,
                              read_counts, batch=batch)
        branch = sum(run["branch_units"].values())
        model, runs, on_path = run["model"], run["runs"], run["on_path"]
        models[name] = model
        levels = [getattr(model.backbone, f"encoder_{d}_0").conv_1.kernel
                  .shape[0] for d in fused_levels]
        # an encoder and a decoder stage of 3 units a level; the deepest
        # level has no decoder stage
        per_shape = {(c, 5): 3 if d == depth - 1 else 6
                     for d, c in zip(fused_levels, levels)}
        per_forward = sum(per_shape.values())
        ncal = run["calibration_images"]
        mode = {"calibrate": "bfloat16", "fused_float": "bfloat16",
                "fused_int8": "int8", "hydra_bf16": "bfloat16"}
        want = {"calibrate": counts(convnext_block=per_forward * ncal),
                "fused_float": counts(convnext_block=per_forward),
                "fused_int8": counts(convnext_block_int8=per_forward),
                "hydra_bf16": counts(convnext_block=per_forward,
                                     band_smooth=depth - 1)}
        want_shapes = {key: {(mode[key], c, k): n * (
            ncal if key == "calibrate" else 1)
            for (c, k), n in per_shape.items()} for key in want}
        got_shapes = {key: {tuple(sk): n for sk, n in sh.items()}
                      for key, sh in run["shapes"].items()}
        int8_bar = max(4.0, run["own_int8"] + FUSED4_INT8_OWN_MARGIN)
        vs_f32 = run["vs_f32_hydra"]
        float_ok = (run["gaps"]["fused_float"]["mean"]
                    <= FUSED_FLOAT_VS_HYDRA_MEAN
                    or vs_f32["fused_float"]
                    <= vs_f32["hydra_bf16"] + FUSEDW_OWN_MARGIN)
        int8_ok = (run["gaps"]["fused_int8"]["mean"] <= int8_bar
                   or vs_f32["fused_int8"]
                   <= run["own_int8"] + FUSEDW_OWN_MARGIN)
        f32_launches = run["f32_launches"]
        f32_shapes = {tuple(sk): n for sk, n in run["f32_shapes"].items()}
        off = [r for r in on_path["fused_float"]
               if (r["C"], 5) not in pallas_convnext.OWN_SHAPES]
        off_int8 = [r for r in on_path["fused_int8"]
                    if (r["C"], 5) not in pallas_convnext.OWN_SHAPES]
        result = dict(
            config=FUSED_CONFIG, depth=depth, overrides=overrides,
            level_widths=levels, fused_levels=fused_levels,
            batch=list(run["x"].shape), dtype="bf16", sites=run["sites"],
            launches=runs, k1_launches_by_shape={
                key: {str(sk): n for sk, n in sh.items()}
                for key, sh in got_shapes.items()},
            branch_units=run["branch_units"],
            f32_k1_launches_by_shape={str(sk): n
                                      for sk, n in f32_shapes.items()},
            k1_on_path=dict(
                bf16_max_abs_err=max(r["max_abs_err"]
                                     for r in on_path["fused_float"]),
                int8_max_abs_code_diff=max(r["max_abs_code_diff"]
                                           for r in on_path["fused_int8"]),
                int8_max_share_differing_by_c={
                    c: max(r["share_differing"] for r in on_path["fused_int8"]
                           if r["C"] == c) for c in levels},
                f32_max_relative_err=max(r["relative_err"]
                                         for r in f32_launches),
                f32_max_abs_err=max(r["max_abs_err"] for r in f32_launches)),
            finest_vs_hydra_bf16_gray_levels=run["gaps"],
            finest_vs_hydra_f32_gray_levels=vs_f32,
            own_int8_error_f32_gray_levels=run["own_int8"],
            f32_card_vs_cpu_mean_gray_levels_per_scale=run["card32"],
            cpu_images=FUSED_CPU_IMAGES, timing=run["timing"], smi=smi,
            tolerance=dict(
                launches=f"{per_forward} K1 a fused or hydra forward: "
                         f"{sorted(per_shape.items())}, and a f32 fused "
                         f"forward; 0 branch units",
                k1_bf16="max(0.05, 1 bf16 ulp)",
                k1_f32=f"1e-3 and {K1_F32_RELATIVE} x max |plain output|",
                k1_int8=f"|code diff| <= 1, share differing <= "
                        f"{share_differing} (C <= 64), "
                        f"{FUSED4_C128_SHARE_DIFFERING} (C >= 128)",
                f32_card_vs_cpu="the path with K1's plain version on the "
                                "card against the CPU (plain_k1); the path "
                                "through the kernel (kernel) is read",
                f32_card_vs_cpu_mean=FUSED_F32_CARD_VS_CPU_MEAN,
                float_vs_hydra=f"mean <= {FUSED_FLOAT_VS_HYDRA_MEAN}, or "
                               f"against the f32 hydra <= the bf16 hydra's "
                               f"+ {FUSEDW_OWN_MARGIN}",
                int8_vs_hydra=f"mean <= {int8_bar}, or against the f32 "
                              f"hydra <= the f32 int8 forward's + "
                              f"{FUSEDW_OWN_MARGIN}"))
        log("fused_widths", model=name, **result)
        want_f32 = {("float32", c, k): n for (c, k), n in per_shape.items()}
        if runs != want or got_shapes != want_shapes or branch \
                or f32_shapes != want_f32:
            problems.append(f"{name}: launches {runs}, by shape "
                            f"{got_shapes}, f32 {f32_shapes}, branch units "
                            f"{branch}")
        for key, o in run["outs"].items():
            if [tuple(v.shape) for v in o] != [
                    (batch, 3, FUSED_SIZE >> i, FUSED_SIZE >> i)
                    for i in range(depth)] or not all(
                        bool(torch.isfinite(v).all()) for v in o):
                problems.append(f"{name} {key}: bad outputs")
        if [len(v) for v in on_path.values()] != [per_forward] * 2 \
                or not all(r["within"] for r in on_path["fused_float"]) \
                or not all(r["max_abs_code_diff"] <= 1
                           and r["share_differing"] <= int8_share(r["C"])
                           for r in on_path["fused_int8"]):
            problems.append(f"{name}: K1 on the path disagrees with its "
                            f"plain version: {on_path}")
        if max(run["card32"]["plain_k1"]) > FUSED_F32_CARD_VS_CPU_MEAN:
            problems.append(f"{name}: f32 fused card vs CPU {run['card32']}")
        if len(f32_launches) != per_forward or not all(
                r["max_abs_err"] <= 1e-3
                and r["relative_err"] <= K1_F32_RELATIVE
                for r in f32_launches):
            problems.append(f"{name}: K1 f32 on the path: {f32_launches}")
        gaps = run["gaps"]
        if not float_ok or not int8_ok:
            problems.append(f"{name}: fused vs hydra {gaps}, against the "
                            f"f32 hydra {vs_f32}")
        counted = {key: sum(r[key] for r in runs.values())
                   for key in runs["calibrate"]}
        total = counted if total is None else {
            key: total[key] + n for key, n in counted.items()}
        for sh in (*got_shapes.values(), f32_shapes):
            for shape_key, n in sh.items():
                by_shape[shape_key] = by_shape.get(shape_key, 0) + n
        for key, recs, err in (("bf16", off, "max_abs_err"),
                               ("int8", off_int8, "max_abs_code_diff")):
            errors[key] = max([errors[key]] + [r[err] for r in recs
                                               if r["C"] <= 256])
            errors[key + "_c512"] = max([errors[key + "_c512"]] + [
                r[err] for r in recs if 256 < r["C"] <= 512])
            errors[key + "_c1024"] = max([errors[key + "_c1024"]] + [
                r[err] for r in recs if 512 < r["C"] <= 1024])
            errors[key + "_general"] = max([errors[key + "_general"]] + [
                r[err] for r in recs if r["C"] > 1024])
        errors["f32_c512"] = max([errors["f32_c512"]] + [
            r["max_abs_err"] for r in f32_launches if 256 < r["C"] <= 512])
        errors["f32_c1024"] = max([errors["f32_c1024"]] + [
            r["max_abs_err"] for r in f32_launches if 512 < r["C"] <= 1024])
        errors["f32_general"] = max([errors["f32_general"]] + [
            r["max_abs_err"] for r in f32_launches if r["C"] > 1024])
        del run
    if problems:
        raise AssertionError(f"fused_widths: {problems}")
    rows = []
    for mode, c, k, b, hw, unit, general in (
            [(*r, False) for r in FUSEDW_K1_ROWS]
            + [(*r, True) for r in FUSEDW_GENERAL_READINGS]):
        if unit is None:
            wts, slope, on = seeded_unit_weights(c, k), 0.1, "seeded"
        else:
            kw = getattr(models[unit[0]].backbone, unit[1]).kernel_weights(
                torch.float32)
            wts, slope, on = dict(kw), getattr(
                models[unit[0]].backbone, unit[1]).slope, "/".join(unit)
        x = torch.from_numpy(rng.normal(0, 1, (b, hw, hw, c)).astype(
            np.float32)).cuda()
        rows.append(k1_row_time(
            pallas_convnext, mode, x, wts, slope, smi, int8_share(c),
            general=general, path="fused_widths", weights=on,
            timed_only=general or (mode, c, k) in FUSEDW_TIMED_ONLY,
            calls_per_forward=0 if unit is None or general
            else 3 if unit[1].startswith(
                f"encoder_{fusedw_depth(unit[0]) - 1}") else 6))
        del x
    # K2 at the multiplier-1.5 hydra's level-3 band split: C = 108 is no
    # whole number of 16-byte vectors (4 bf16 channels a thread)
    from blind_image_denoising_torch.ops import pallas_pyramid
    shape = (FUSED_BATCH, FUSED_SIZE >> 3, FUSED_SIZE >> 3, 108)
    x = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).cuda(
        ).to(torch.bfloat16)
    got = pallas_pyramid.band_smooth_forward(x, 2)
    ref = pallas_pyramid.band_smooth_plain(x, 2)
    diffs = [(g.float() - r.float()).abs() for g, r in zip(got, ref)]
    err = max(float(d.max()) for d in diffs)
    # phase 3's K2 bar: one bf16 ulp of the plain output, element by element
    within = all(bool((d <= bf16_ulp(r)).all()) for d, r in zip(diffs, ref))
    t = dict(ms=cuda_ms(lambda: pallas_pyramid.band_smooth_forward(x, 2)),
             cold_ms=cuda_ms(lambda xc: pallas_pyramid.band_smooth_forward(
                 xc, 2), inputs=cold_copies(x)),
             plain_ms=cuda_ms(lambda: pallas_pyramid.band_smooth_plain(x, 2),
                              iters=5),
             library_ms=cuda_ms(lambda: band_smooth_library(x, 2)))
    bound, by = band_bound_ms(*shape, 2, torch.bfloat16)
    log("time", path="fused_widths", kernel="band_smooth", shape=list(shape),
        dtype="bf16", calls_per_forward=1, bound_ms=bound, bound_by=by,
        share_cold=bound / t["cold_ms"], max_abs_err=err, smi=smi, **t)
    if not within:
        raise AssertionError(f"K2 at C = 108 against its plain version: {err}")
    return total, by_shape, errors, rows


# the general route's checks (tests/test_torch_cuda.py's card cases): (C,
# K, E) on [B, H, W], every mode: above C = 1024 (1025's rows of no whole
# 16-byte vectors, 1040, 1536, 2048 at the depth-7 model's level-6 shape
# and a ragged one) at K = 5 and 4096 at K = 1; C = 1 and 32 at K = 9 and
# 11; (48, 5) at E = 2C and 3C; pixels no multiple of the products' tiles
GENERAL_CHECKS = [((1025, 5, 4100), (2, 9, 13)),
                  ((1040, 5, 4160), (3, 7, 11)),
                  ((1536, 5, 6144), (2, 8, 9)),
                  ((2048, 5, 8192), (8, 4, 4)),
                  ((2048, 5, 8192), (2, 9, 7)),
                  ((4096, 1, 16384), (1, 5, 7)),
                  ((1, 9, 4), (3, 37, 45)),
                  ((1, 11, 4), (2, 19, 23)),
                  ((32, 9, 128), (3, 37, 45)),
                  ((32, 11, 128), (2, 19, 23)),
                  ((48, 5, 96), (4, 33, 35)),
                  ((48, 5, 144), (4, 33, 35))]


def general_route_checks(pallas_convnext, read_counts, counts, reset_counts,
                         smi):
    """K1's general route through the wrapper on CUDA tensors at
    ``GENERAL_CHECKS`` in every mode: each launches the kernel (counted;
    nothing raises), two launches give the same bits, and the output holds
    to its plain version at the kernel tests' bars (bf16 max(0.05, 1 ulp),
    int8 codes within 1 on at most 1e-3 of them, f32 1e-3 and
    ``K1_F32_RELATIVE`` of max |plain output|). Seeded weights made on the
    card (std 0.3 depthwise, 1/sqrt(fan-in) products). Returns the largest
    differences by mode."""
    worst = dict(bf16=0.0, int8=0, f32=0.0)
    reset_counts()
    n_launches = dict(convnext_block=0, convnext_block_int8=0)
    for (c, k, e), bhw in GENERAL_CHECKS:
        if not pallas_convnext.runs_general(c, k, e):
            raise AssertionError(f"({c}, {k}, {e}) is no general shape")
        g = torch.Generator(device="cuda").manual_seed(c * 100 + k + e)
        rand = lambda *shape: torch.randn(  # noqa: E731
            shape, generator=g, device="cuda")
        wts = dict(dw=0.3 * rand(c, 1, k, k),
                   ln_scale=0.5 + torch.rand(c, generator=g, device="cuda"),
                   w2=rand(e, c) / c ** 0.5, w3=rand(c, e) / e ** 0.5,
                   gain=0.3 + 0.6 * torch.rand(c, generator=g,
                                               device="cuda"))
        x = rand(*bhw, c)
        for mode in ("f32", "bf16", "int8"):
            kw = {}
            if mode == "int8":
                kw = dict(scale_in=float(x.abs().max()) / 127,
                          scale_out=float(pallas_convnext.convnext_block_plain(
                              x, **wts).abs().max()) / 127)
                v = pallas_convnext.quantize(x, kw["scale_in"])
                n_launches["convnext_block_int8"] += 2
            else:
                v = x.to(torch.float32 if mode == "f32" else torch.bfloat16)
                n_launches["convnext_block"] += 2
            got = pallas_convnext.convnext_block(v, **wts, **kw)
            again = pallas_convnext.convnext_block(v, **wts, **kw)
            ref = pallas_convnext.convnext_block_plain(v, **wts, **kw)
            torch.cuda.synchronize()
            diff = (got.float() - ref.float()).abs()
            err = float(diff.max())
            if mode == "int8":
                share = float((diff > 0).float().mean())
                ok = err <= 1 and share <= 1e-3
            elif mode == "f32":
                share = err / float(ref.abs().max())
                ok = err <= 1e-3 and share <= K1_F32_RELATIVE
            else:
                share = None
                ok = bool((diff <= torch.clamp(bf16_ulp(ref), min=0.05)
                           ).all())
            same = torch.equal(got.view(torch.uint8), again.view(torch.uint8))
            worst[mode] = max(worst[mode], err)
            log("general_route", C=c, K=k, E=e, shape=[*bhw, c], mode=mode,
                max_abs_err=err, **({"share_differing": share}
                                    if mode == "int8" else
                                    {"relative_err": share}
                                    if mode == "f32" else {}),
                same_bits=same, smi=smi)
            if not ok or not same or got.shape != v.shape \
                    or got.dtype != v.dtype:
                raise AssertionError(f"general route ({c}, {k}, {e}) "
                                     f"{mode}: err {err}, share {share}, "
                                     f"same bits {same}")
    if read_counts() != counts(**n_launches):
        raise AssertionError(f"general route launches {read_counts()}, "
                             f"want {n_launches}")
    return worst


# ------------------------------------------------------------ wider shapes

# shapes JAX's kernels take that the port's took only from PR 21 on: K2's
# backward and K4 at a C of no whole 16-byte vectors (C = 108: 4 bf16
# channels a thread), K1 at K = 7 (and at C = 512, the fused_widths phase's
# third model). The K2-backward row: the level-3 band split of the
# multiplier-1.5 v6's train step (b16 @ 128²); the K4 row: that model's
# level 3 in a b8 @ 256² request
BWD_RAGGED_SHAPES = [(TRAIN_BATCH, TRAIN_SIZE >> 3, TRAIN_SIZE >> 3, 108)]
SPLIT_RAGGED_SHAPES = [(8, FUSED_SIZE >> 3, FUSED_SIZE >> 3, 108)]
# bf16 train steps of the multiplier-1.5 depth-5 v6 (warm-up, timed), and
# per step: K3 once, K2 and its backward at each of the 4 band splits
WIDER_TRAIN_STEPS = (2, 4)
WIDER_TRAIN_PER_STEP = dict(band_smooth=FUSEDW_DEPTH - 1,
                            band_smooth_bwd=FUSEDW_DEPTH - 1, corrupt_noise=1)
# the K = 7 v6 (configs/unet_laplacian_v6.json, depth 3, width 3, encoder
# and decoder kernel sizes 7): its bf16 hydra at b8 @ 256², 6 K1 each at
# (32, 7) and (64, 7) a forward (level 2 is its attention level), 2 K2
WIDER_K7 = dict(encoder_kernel_size=7, decoder_kernel_size=7)
WIDER_K7_BATCH = 8
WIDER_K7_PER_SHAPE = {("bfloat16", 32, 7): 6, ("bfloat16", 64, 7): 6}


def wider_shapes_phase(bidt, v6cfg, rng, smi, read_counts, counts,
                       reset_counts):
    """Two paths through the shapes PR 21 opened on the card. (a) The
    multiplier-1.5 depth-5 ``unet_laplacian_v6`` (``FUSEDW_MODELS["x1.5"]``,
    seeded) trained in bf16 at b16 @ 128² with K3 and Adam: one batch
    against the port's f32 CPU step (:func:`train_card_vs_cpu`, the train
    phase's bars), then ``WIDER_TRAIN_STEPS`` steps with exact launches
    (``WIDER_TRAIN_PER_STEP``, K2's backward at C = 108 once a step), every
    K2 / K2-backward / K3 input they launched against the plain versions,
    and K2's backward at C = 108 timed. (b) The K = 7 v6's bf16 hydra at
    b8 @ 256²: exact launches (``WIDER_K7_PER_SHAPE``, 2 K2, 0 branch
    units), every K1 / K2 input against the plain versions, its f32 hydra
    on 2 images card vs CPU (with K1's plain version on the card <=
    ``FUSED_F32_CARD_VS_CPU_MEAN``; through the kernel read), the bf16
    hydra timed and K1 at (32, 7) and (64, 7) timed in every mode. Returns
    (the launches of each path, the largest bf16 errors, the timed rows:
    (kernel, rows))."""
    from blind_image_denoising_torch.layers import convnext as convnext_layer
    from blind_image_denoising_torch.models.hydra import model_builder
    from blind_image_denoising_torch.ops import (pallas_convnext,
                                                 pallas_noise, pallas_pyramid)
    from blind_image_denoising_torch.ops.precision import exact_float32
    from blind_image_denoising_torch.training.train_state import init_params
    launches, errors, rows = {}, {}, {}

    # (a) the multiplier-1.5 v6's train step
    cfg = copy.deepcopy(bidt.CONFIGS_DICT[TRAIN_CONFIG])
    cfg["model"] = copy.deepcopy(v6cfg)
    cfg["model"]["backbone"].update(depth=FUSEDW_DEPTH,
                                    **FUSEDW_MODELS["x1.5"][0])
    cfg.setdefault("tpu", {})["pallas_noise"] = True
    ds = cfg["dataset"]
    noise_kw = dict(additive_noise=ds["additional_noise"],
                    multiplicative_noise=ds["multiplicative_noise"])
    seeded = model_builder(copy.deepcopy(cfg["model"])).hydra
    init_params(seeded, torch.Generator().manual_seed(SEED))
    params = {k: v.detach().clone() for k, v in seeded.state_dict().items()}
    del seeded
    clean = synthetic_images(TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, rng)
    check = train_card_vs_cpu(cfg, params, clean, noise_kw,
                              phase="wider_train_check")
    state, step = build_trainer(cfg, params, torch.bfloat16, "cuda")
    batch = torch.from_numpy(clean.round().astype(np.uint8)).cuda()
    n_out = state.model.no_outputs
    dw = torch.full((n_out,), 1.0 / n_out, device="cuda")
    bwd_by_c = {}
    warm, timed = WIDER_TRAIN_STEPS
    losses, host_ms = [], []
    reset_counts()
    with KernelInputs() as seen:
        recording = pallas_pyramid.band_smooth_bwd

        def counting(g_band, g_smooth, kernel_size=2):
            c = g_band.shape[-1]
            bwd_by_c[c] = bwd_by_c.get(c, 0) + 1
            return recording(g_band, g_smooth, kernel_size)

        pallas_pyramid.band_smooth_bwd = counting
        try:
            for i in range(warm + timed):
                t0 = time.perf_counter()
                state, metrics = step(state, batch, depth_weights=dw)
                torch.cuda.synchronize()
                if i >= warm:
                    host_ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(metrics["total_loss"]))
        finally:
            pallas_pyramid.band_smooth_bwd = recording
    n_steps = warm + timed
    per_step = {k: v / n_steps for k, v in read_counts().items()}
    launches["train"] = dict(per_step=per_step, band_smooth_bwd_by_c={
        str(c): n for c, n in sorted(bwd_by_c.items())})
    log("wider_train", config=TRAIN_CONFIG, model="unet_laplacian_v6 x1.5",
        depth=FUSEDW_DEPTH, batch=list(batch.shape), dtype="bf16",
        steps=n_steps, launches_per_step=per_step,
        band_smooth_bwd_launches_by_c=launches["train"][
            "band_smooth_bwd_by_c"],
        loss_first=losses[0], loss_last=losses[-1],
        step_ms_host_median=statistics.median(host_ms),
        step_ms_host=[round(t, 3) for t in host_ms],
        card_vs_cpu=dict(loss_rel_diff=check["loss_rel_diff"],
                         grad_cosine=check["grad_cosine"]), smi=smi)
    if per_step != counts(**WIDER_TRAIN_PER_STEP) \
            or bwd_by_c.get(108) != n_steps:
        raise AssertionError(f"wider train step launches {per_step}, K2 "
                             f"backward by C {bwd_by_c}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"wider train step losses {losses}")
    errors.update(check_kernel_inputs(pallas_convnext, pallas_pyramid,
                                      pallas_noise, seen.seen, SEED + 60,
                                      path="wider_train"))
    del state, step, batch
    torch.cuda.empty_cache()
    for shape in BWD_RAGGED_SHAPES:
        x, g_band, g_smooth = (torch.from_numpy(rng.normal(
            0, 1, shape).astype(np.float32)).cuda().to(torch.bfloat16)
            for _ in range(3))
        t = dict(ms=cuda_ms(lambda: pallas_pyramid.band_smooth_bwd(
                     g_band, g_smooth, 2)),
                 cold_ms=cuda_ms(lambda a, b: pallas_pyramid.band_smooth_bwd(
                     a, b, 2), inputs=cold_copies(g_band, g_smooth)),
                 plain_ms=cuda_ms(lambda: pallas_pyramid.band_smooth_bwd_plain(
                     g_band, g_smooth, 2), iters=5),
                 library_ms=cuda_ms(band_smooth_bwd_library(
                     x, 2, g_band, g_smooth)))
        bound, by = band_bound_ms(*shape, 2, torch.bfloat16, backward=True)
        log("time", path="wider_train", kernel="band_smooth_bwd",
            shape=list(shape), dtype="bf16", calls_per_step=1,
            bound_ms=bound, bound_by=by, share_cold=bound / t["cold_ms"],
            smi=smi, **t)
        rows.setdefault("band_smooth_bwd_ragged", []).append(
            (1, t, bound, by))

    # (b) the K = 7 v6's hydra
    k7cfg = copy.deepcopy(v6cfg)
    k7cfg["backbone"].update(WIDER_K7)
    model = model_builder(copy.deepcopy(k7cfg), dtype=torch.bfloat16).hydra
    init_params(model, torch.Generator().manual_seed(SEED))
    model = model.cuda().eval().requires_grad_(False)
    x = torch.from_numpy(np.asarray(add_noise(synthetic_images(
        WIDER_K7_BATCH, FUSED_SIZE, FUSED_SIZE, rng), 25.0, rng),
        np.float32)).permute(0, 3, 1, 2).cuda()

    def hydra(v):
        with torch.inference_mode():
            return model(v)

    branch0 = pallas_convnext.branch_units
    reset_counts()
    with KernelInputs() as seen:
        outs = hydra(x)
        torch.cuda.synchronize()
    got = read_counts()
    shapes = dict(pallas_convnext.shape_launches)
    branch = pallas_convnext.branch_units - branch0
    launches["k7_hydra"] = dict(per_forward=got, by_shape={
        str(k): n for k, n in shapes.items()}, branch_units=branch)
    n_k1 = sum(WIDER_K7_PER_SHAPE.values())
    ok = (got == counts(convnext_block=n_k1, band_smooth=2)
          and shapes == WIDER_K7_PER_SHAPE and branch == 0
          and [tuple(o.shape) for o in outs] == [
              (WIDER_K7_BATCH, 3, FUSED_SIZE >> i, FUSED_SIZE >> i)
              for i in range(3)]
          and all(bool(torch.isfinite(o).all()) for o in outs))
    for kernel, err in check_kernel_inputs(
            pallas_convnext, pallas_pyramid, pallas_noise, seen.seen,
            SEED + 61, path="k7_hydra").items():
        errors[kernel] = max(errors.get(kernel, 0.0), err)
    # the f32 hydra on an f32 copy of the weights, card vs CPU: with K1's
    # plain version on the card (the bar) and through the kernel (read)
    m32 = model_builder(copy.deepcopy(k7cfg)).hydra
    m32.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    m32.eval().requires_grad_(False)
    x_cpu = x[:FUSED_CPU_IMAGES].cpu()
    with torch.inference_mode():
        ref32 = m32(x_cpu)
    m32 = m32.cuda()
    card32 = {}
    real_k1 = convnext_layer.convnext_block
    for name in ("kernel", "plain_k1"):
        if name == "plain_k1":
            convnext_layer.convnext_block = \
                pallas_convnext.convnext_block_plain
        try:
            with exact_float32(), torch.inference_mode():
                got32 = m32(x[:FUSED_CPU_IMAGES])
        finally:
            convnext_layer.convnext_block = real_k1
        card32[name] = [float((g.cpu() - r).abs().mean())
                        for g, r in zip(got32, ref32)]
    with torch.inference_mode():
        hydra32 = m32(x)[0]
    bf16_vs_f32 = float((outs[0].float() - hydra32).abs().mean())
    del m32, hydra32, got32
    med, times = forward_event_ms(lambda: hydra(x))
    log("k7_hydra", config=FUSED_CONFIG, overrides=WIDER_K7,
        batch=list(x.shape), dtype="bf16", launches=got,
        k1_launches_by_shape=launches["k7_hydra"]["by_shape"],
        branch_units=branch, f32_card_vs_cpu_mean_gray_levels_per_scale=card32,
        finest_bf16_vs_f32_hydra_gray_levels=bf16_vs_f32,
        forward_ms_median=med, forward_ms=[round(t, 3) for t in times],
        images_per_s=WIDER_K7_BATCH / med * 1e3, cpu_images=FUSED_CPU_IMAGES,
        tolerance=dict(
            launches=f"{n_k1} K1 a forward: {WIDER_K7_PER_SHAPE}; 2 K2; 0 "
                     f"branch units",
            f32_card_vs_cpu=f"with K1's plain version on the card <= "
                            f"{FUSED_F32_CARD_VS_CPU_MEAN}; through the "
                            f"kernel read"), smi=smi)
    if not ok:
        raise AssertionError(f"K = 7 hydra: launches {got}, by shape {shapes}"
                             f", branch units {branch}, outputs "
                             f"{[tuple(o.shape) for o in outs]}")
    if max(card32["plain_k1"]) > FUSED_F32_CARD_VS_CPU_MEAN:
        raise AssertionError(f"K = 7 f32 hydra card vs CPU {card32}")
    k7_rows = []
    for level, unit, hw in ((0, "encoder_0_0", FUSED_SIZE),
                            (1, "encoder_1_0", FUSED_SIZE >> 1)):
        block = getattr(model.backbone, unit)
        wts = dict(block.kernel_weights(torch.float32))
        c = wts["dw"].shape[0]
        for mode in ("bf16", "int8", "f32"):
            xin = torch.from_numpy(rng.normal(
                0, 1, (WIDER_K7_BATCH, hw, hw, c)).astype(np.float32)).cuda()
            k7_rows.append(k1_row_time(
                pallas_convnext, mode, xin, wts, block.slope, smi, 1e-4,
                path="k7_hydra", weights=unit,
                calls_per_forward=6 if mode == "bf16" else 0))
            del xin
    rows["convnext_block_k7"] = [
        (r["calls_per_forward"], {k: r[k] for k in (
            "ms", "cold_ms", "plain_ms", "library_ms")}, r["bound_ms"],
         r["bound_by"]) for r in k7_rows if r["dtype"] == "bfloat16"]
    errors["convnext_block_k7"] = max(r["max_abs_err"] for r in k7_rows
                                      if r["dtype"] == "bfloat16")
    del model, x, outs
    torch.cuda.empty_cache()
    return launches, errors, rows


# ------------------------------------------------------------ restoration

# the restoration phase: scripts/train_restoration.py's recipe (the
# degradation chain, fine-tuning the packaged flagship), at its full width
# and crop; the cuts are the steps (6, the recipe runs 15k) and the inputs
# (the train_loop phase's seeded scenes: KITTI and MegaDepth are not in
# the checkout)
RESTORE_STEPS = 6
RESTORE_OVERRIDES = {
    "dataset.input_shape": [128, 128, 3], "dataset.batch_size": 16,
    "dataset.no_crops_per_image": 4, "dataset.repeat": True,
    "dataset.min_crop_std": 2.0, "dataset.additional_noise": [1, 80],
    "dataset.noise_sampling": "log_uniform",
    "dataset.apply_degradations": True, "dataset.random_blur": True,
    "dataset.use_jpeg_noise": True, "dataset.quantization": 8,
    "dataset.inpaint_drop_rate": 0.05, "dataset.degradation_prob": 0.5,
    "dataset.degradation_chain_prob": 0.5,
    "train.epochs": -1, "train.total_steps": RESTORE_STEPS,
    "train.ema": 0.9995, "train.checkpoint_every": RESTORE_STEPS,
    "train.visualization_every": -1, "train.use_test_images": False,
    "train.log_every": 1, "train.profile_at_step": 2,
    "train.optimizer.schedule": {
        "type": "cosine_decay",
        "config": {"learning_rate": 2e-4, "decay_steps": RESTORE_STEPS,
                   "alpha": 0.02}},
    "tpu": {"mesh": {"data": -1}, "compute_dtype": "bfloat16"}}
# the restoration report card (scripts/train_restoration.py SPECS)
RESTORE_SPECS = ("jpeg:30", "jpeg:50", "blur:1.0", "blur:1.5+noise:25",
                 "noise:30+jpeg:50", "posterize:8+noise:20",
                 "holes:0.1+noise:10")
# the sweep's images: the packaged evaluation set at 256^2 (the seeded
# synthetic scenes are no natural images: the flagship restores none of
# them, in JAX as here)
RESTORE_SWEEP_IMAGES, RESTORE_SWEEP_SIZE = 4, 256
# the chain's statistics: 64 draws of the recipe's b16 @ 128^2 micro-batch
CHAIN_DRAWS = 64
# card against CPU on the deterministic ops: the CPU tests' bars against
# JAX (tests/test_torch_degradations.py)
ROTATE_ATOL, BLUR_ATOL = 1e-3, 1e-4
JPEG_MEAN, JPEG_NEAR, JPEG_NEAR_SHARE = 1e-3, 1e-2, 0.999
SPEC_EQUAL_SHARE = 0.999
# launches per micro-batch of the restoration step: K2 and its backward
# per band split of the flagship (depth 3), no noise kernel
RESTORE_PER_MICRO_BATCH = dict(band_smooth=2, band_smooth_bwd=2)


def restoration_config(base, image_dir):
    cfg = copy.deepcopy(base)
    cfg["dataset"]["inputs"] = ([{"directory": str(image_dir)}]
                                if image_dir is not None else [])
    for key, value in RESTORE_OVERRIDES.items():
        node = cfg
        *path, name = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[name] = value
    return cfg


def kernel_ms(fn, n=5):
    """Device milliseconds per call of ``fn`` as the sum of its kernels'
    durations in a ``torch.profiler`` trace of ``n`` calls (after one
    warm-up): device work only, whatever the host does between kernels."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(r[0] for r in profile_rows(prof)) / n / 1e3


def within_sigmas(share, n, p, sigmas=4.0):
    return abs(share - p) <= sigmas * (p * (1 - p) / n) ** 0.5


def chain_statistics(deg, clean, n_draws, ds):
    """The chain's gates on the card over ``n_draws`` draws of ``clean``
    [B, H, W, 3]: each wrapper's flags redrawn from a copy of the
    generator's state (the output must equal the op at those flags and
    values, bit for bit), the master gate (a run with the ops gated on
    against one gated off, the same generator state), and the noise-only
    samples against the chain's noise draw (ops gated off: the output at
    chain_prob 0.5 equals the one at 1.0)."""
    dev = clean.device
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    b = clean.shape[0]
    p = ds["degradation_prob"]
    noise_kw = dict(additive_noise=ds["additional_noise"],
                    multiplicative_noise=ds["multiplicative_noise"],
                    noise_sampling=ds["noise_sampling"], round_values=True,
                    use_random_blur=True, use_jpeg_noise=True,
                    quantization=ds["quantization"],
                    inpaint_drop_rate=ds["inpaint_drop_rate"])
    counts = dict(blur=0, jpeg=0, quantize=0, holes=0, chain=0)
    hole_pixels = gated_pixels = 0
    sigma, quality = [], []
    mismatches = []
    for _ in range(n_draws):
        s = g.get_state()
        out = deg.random_blur(g, clean, prob=p)
        g.set_state(s)
        flags = torch.rand((b, 1, 1, 1), generator=g, device=dev) < p
        sig = 0.1 + 1.9 * torch.rand((b,), generator=g, device=dev)
        if not torch.equal(out, torch.where(
                flags, deg.separable_blur_batch(clean, sig), clean)):
            mismatches.append("blur")
        counts["blur"] += int(flags.sum())
        sigma.append(sig)
        s = g.get_state()
        out = deg.random_jpeg(g, clean, prob=p)
        g.set_state(s)
        flags = torch.rand((b, 1, 1, 1), generator=g, device=dev) < p
        q = 25.0 + 50.0 * torch.rand((b,), generator=g, device=dev)
        if not torch.equal(out, torch.where(
                flags, deg.jpeg_artifacts(clean, q), clean)):
            mismatches.append("jpeg")
        counts["jpeg"] += int(flags.sum())
        quality.append(q)
        out = deg.random_quantize(g, clean, ds["quantization"], prob=p)
        counts["quantize"] += int((out != clean).flatten(1).any(1).sum())
        lifted = clean + 1.0                  # no zero pixel before
        holes = deg.inpaint_dropout(g, lifted, ds["inpaint_drop_rate"],
                                    prob=p) == 0
        gated = holes.flatten(1).any(1)
        counts["holes"] += int(gated.sum())
        if not torch.equal(holes.all(-1), holes.any(-1)):
            mismatches.append("holes across channels")
        hole_pixels += int(holes[gated].all(-1).sum())
        gated_pixels += int(gated.sum()) * clean.shape[1] * clean.shape[2]
        s = g.get_state()
        on = deg.degrade_batch(g, clean, degradation_prob=1.0,
                               chain_prob=ds["degradation_chain_prob"],
                               **noise_kw)
        g.set_state(s)
        off = deg.degrade_batch(g, clean, degradation_prob=0.0,
                                chain_prob=ds["degradation_chain_prob"],
                                **noise_kw)
        g.set_state(s)
        off_one = deg.degrade_batch(g, clean, degradation_prob=0.0,
                                    chain_prob=1.0, **noise_kw)
        if not torch.equal(off, off_one):
            mismatches.append("noise-only draw")
        counts["chain"] += int((on != off).flatten(1).any(1).sum())
    n = n_draws * b
    sigma, quality = torch.cat(sigma), torch.cat(quality)
    rates = {k: v / n for k, v in counts.items()}
    want = dict(blur=p, jpeg=p, quantize=p, holes=p,
                chain=ds["degradation_chain_prob"])
    bad = [k for k, r in rates.items() if not within_sigmas(r, n, want[k])]
    hole_rate = hole_pixels / max(gated_pixels, 1)
    if not within_sigmas(hole_rate, gated_pixels, ds["inpaint_drop_rate"]):
        bad.append("hole rate")
    ranges = dict(sigma=[float(sigma.min()), float(sigma.max())],
                  quality=[float(quality.min()), float(quality.max())])
    if not (0.1 <= ranges["sigma"][0] and ranges["sigma"][1] <= 2.0
            and 25.0 <= ranges["quality"][0]
            and ranges["quality"][1] <= 75.0):
        bad.append("ranges")
    return dict(samples=n, rates=rates, want=want, hole_rate=hole_rate,
                ranges=ranges, mismatches=sorted(set(mismatches)),
                failed=bad + sorted(set(mismatches)))


def ops_card_vs_cpu(deg, clean, device="cuda"):
    """Each deterministic op of the chain at fixed values on the card
    against the CPU, on ``clean`` [B, H, W, 3]: rotation at angles across
    ±1.57, blur at σ across [0.1, 2], JPEG at qualities across [25, 75],
    posterize 8, holes from a fixed mask; each timed on the card by CUDA
    events (``ms``) and by the sum of its kernels (``kernel_ms``)."""
    b = clean.shape[0]
    angles = torch.linspace(-1.57, 1.57, b)
    sigmas = torch.linspace(0.1, 2.0, b)
    qualities = torch.linspace(25.0, 75.0, b)
    mask_gen = torch.Generator().manual_seed(SEED + 22)
    keep = torch.rand((b,) + tuple(clean.shape[1:3]) + (1,),
                      generator=mask_gen) >= 0.05
    ops = {
        "rotate": (deg.rotate_batch, angles),
        "blur": (deg.separable_blur_batch, sigmas),
        "jpeg": (deg.jpeg_artifacts, qualities),
        "posterize": (lambda x, q: deg.quantize_batch(x, q), 8.0),
        "holes": (lambda x, k: deg.inpaint_dropout(None, x, 0.05, keep=k),
                  keep)}
    card_x = clean.to(device)
    out, bad = {}, []
    for name, (fn, value) in ops.items():
        # the op's values on the device before the timing: a host copy
        # inside the timed calls would wait for the device each time
        card_value = (value.to(device) if isinstance(value, torch.Tensor)
                      else value)
        got = fn(card_x, card_value).cpu()
        ref = fn(clean, value)
        d = (got - ref).abs()
        row = dict(max_abs=float(d.max()), mean_abs=float(d.mean()),
                   near_share=float((d <= JPEG_NEAR).float().mean()))
        if card_x.is_cuda:
            row.update(ms=cuda_ms(lambda: fn(card_x, card_value)),
                       kernel_ms=kernel_ms(lambda: fn(card_x, card_value)))
        ok = {"rotate": row["max_abs"] <= ROTATE_ATOL,
              "blur": row["max_abs"] <= BLUR_ATOL,
              "jpeg": row["mean_abs"] <= JPEG_MEAN
              and row["near_share"] >= JPEG_NEAR_SHARE,
              "posterize": row["max_abs"] == 0.0,
              "holes": row["max_abs"] == 0.0}[name]
        if not ok:
            bad.append(name)
        out[name] = row
    return out, bad


def restoration_step_checks(bidt, cfg, read_counts, clean, device="cuda"):
    """The recipe's train step built directly on the card (the flagship's
    packaged weights, bf16, 2 micro-batches): two steps under
    ``torch.cuda.set_sync_debug_mode("error")``, their launches per
    micro-batch, one profiled step's ``degradations.chain`` range (its
    kernels' device ms per micro-batch) and busy share, and the rotation
    and the chain alone on one micro-batch, timed by CUDA events and by
    the sum of their kernels (``kernel_ms``)."""
    from blind_image_denoising_torch.models.hydra import model_builder
    from blind_image_denoising_torch.ops import degradations as deg
    from blind_image_denoising_torch.training import (
        build_train_step, create_train_state, loss_function_builder,
        optimizer_builder)
    from blind_image_denoising_torch.training.train_loop import (
        resolve_degradation_options)
    from blind_image_denoising_torch.weights import (load_msgpack,
                                                     params_from_flax)
    ds = cfg["dataset"]
    hydra = model_builder(copy.deepcopy(cfg["model"]),
                          dtype=torch.bfloat16).hydra
    params = params_from_flax(load_msgpack(
        Path(bidt.models[FLAGSHIP]["directory"]) / "params.msgpack"))
    tx, _ = optimizer_builder(cfg["train"]["optimizer"])
    state = create_train_state(hydra, tx, seed=SEED, params=params,
                               device=device)
    micro = 2
    step = build_train_step(
        hydra, tx, loss_function_builder(cfg["loss"]), hydra.no_outputs,
        additive_noise=ds["additional_noise"],
        multiplicative_noise=ds.get("multiplicative_noise"),
        noise_sampling=ds["noise_sampling"], grad_accum=micro,
        use_pallas_noise=cfg["tpu"].get("pallas_noise", False),
        **resolve_degradation_options(ds))
    batch = clean.repeat(micro, 1, 1, 1).to(device)
    dw = torch.full((hydra.no_outputs,), 1.0 / hydra.no_outputs,
                    device=device)
    state, _ = step(state, batch, depth_weights=dw)       # warm-up
    torch.cuda.synchronize()
    c0 = read_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            state, metrics = step(state, batch, depth_weights=dw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    c1 = read_counts()
    per_micro = {k: (c1[k] - c0[k]) / (2 * micro) for k in c1}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch, depth_weights=dw)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    chain = [evt for evt in prof.key_averages()
             if evt.key == "degradations.chain"
             and evt.device_type == torch.autograd.DeviceType.CPU]
    rows = [r for r in profile_rows(prof)
            if not r[2].startswith("degradations.")]
    busy = sum(r[0] for r in rows)
    chain_ms = (device_us(chain[0], "") / chain[0].count / 1e3
                if chain else None)
    chain_host_ms = (chain[0].cpu_time_total / chain[0].count / 1e3
                     if chain else None)
    loss = float(metrics["total_loss"])
    del state, step, hydra
    torch.cuda.empty_cache()
    # the same work alone, timed by CUDA events: rotation, rounding and
    # the chain on one micro-batch at the recipe's settings
    opts = resolve_degradation_options(ds)
    g = torch.Generator(device=device).manual_seed(SEED + 24)
    x = clean.to(device)

    def chain():
        y = torch.round(deg.random_rotate_batch(g, x, opts["random_rotate"]))
        return deg.degrade_batch(
            g, y, additive_noise=ds["additional_noise"],
            multiplicative_noise=ds.get("multiplicative_noise"),
            noise_sampling=ds["noise_sampling"],
            use_random_blur=opts["use_random_blur"],
            use_jpeg_noise=opts["use_jpeg_noise"],
            quantization=opts["quantization"],
            inpaint_drop_rate=opts["inpaint_drop_rate"],
            degradation_prob=opts["degradation_prob"],
            chain_prob=opts["degradation_chain_prob"])
    event_ms = cuda_ms(chain) if x.is_cuda else None
    alone_ms = kernel_ms(chain) if x.is_cuda else None
    return dict(micro_batches=micro, batch=list(batch.shape),
                launches_per_micro_batch=per_micro, loss=loss,
                rotation_and_chain_event_ms_per_micro_batch=event_ms,
                rotation_and_chain_kernel_ms_per_micro_batch=alone_ms,
                chain_device_ms_per_micro_batch=chain_ms,
                chain_host_ms_per_micro_batch=chain_host_ms,
                profiled_step=dict(wall_ms=wall_us / 1e3,
                                   busy_ms=busy / 1e3,
                                   idle_share=1 - busy / wall_us,
                                   chain_share_of_busy=(
                                       chain_ms * micro * 1e3 / busy
                                       if chain_ms else None)))


def restoration_phase(bidt, smi, read_counts, loop_run):
    """The blind-restoration recipe on the card (``RESTORE_OVERRIDES``):
    the chain's deterministic ops card against CPU and its statistics on
    the card, the recipe's step without a sync and its launches, the
    recipe's loop fine-tuning the packaged flagship for 6 steps,
    ``export_model`` and bf16 serving of the fine-tune (10 K1 + 2 K2 a
    forward) against the same artifact in f32 on the CPU, and
    ``evaluate.degradation_sweep`` over the recipe's seven specs for the
    packaged flagship and the fine-tune, the card's corruptions against
    the CPU's. Returns (the kernel inputs seen, the launch counts of the
    phase)."""
    import warnings
    from blind_image_denoising_torch import evaluate
    from blind_image_denoising_torch.images import load_evaluation_images
    from blind_image_denoising_torch.inference.export import export_model
    from blind_image_denoising_torch.ops import degradations as deg

    work, image_dir = loop_run["work"], loop_run["image_dir"]
    cfg = restoration_config(bidt.CONFIGS_DICT[TRAIN_CONFIG], image_dir)
    ds = cfg["dataset"]
    rng = np.random.default_rng(SEED + 20)
    problems = []
    timings = {}
    c_start = read_counts()
    clean = torch.from_numpy(np.round(synthetic_images(
        ds["batch_size"], *ds["input_shape"][:2], rng)))

    t0 = time.perf_counter()
    ops, bad_ops = ops_card_vs_cpu(deg, clean)
    if bad_ops:
        problems.append(f"ops card vs CPU: {bad_ops}")
    stats = chain_statistics(deg, clean.cuda(), CHAIN_DRAWS, ds)
    if stats["failed"]:
        problems.append(f"chain statistics: {stats['failed']}")
    timings["ops_and_statistics_s"] = time.perf_counter() - t0

    with KernelInputs() as kernel_inputs:
        t0 = time.perf_counter()
        step_check = restoration_step_checks(bidt, cfg, read_counts, clean)
        timings["step_check_s"] = time.perf_counter() - t0
        want_micro = dict(dict.fromkeys(read_counts(), 0),
                          **RESTORE_PER_MICRO_BATCH)
        if step_check["launches_per_micro_batch"] != want_micro or \
                not np.isfinite(step_check["loss"]):
            problems.append(f"step: {step_check}")

        # the recipe's loop, fine-tuning the packaged flagship
        ckpt_dir = work / "restoration_run"
        micro = cfg["train"]["gpu_batches_per_step"]
        with LoopProbe(read_counts) as probe, \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            probe.warnings = caught
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                state = bidt.train_loop(
                    cfg, ckpt_dir,
                    weights_directory=bidt.models[FLAGSHIP]["directory"])
                timings["loop_s"] = time.perf_counter() - t0
            finally:
                torch.cuda.set_sync_debug_mode(0)
        rows = [json.loads(line) for line in
                (ckpt_dir / "metrics.jsonl").read_text().splitlines()]
        losses = [r["total_loss"] for r in rows if "total_loss" in r]
        per_step = dict(dict.fromkeys(read_counts(), 0),
                        **{k: micro * v for k, v in
                           RESTORE_PER_MICRO_BATCH.items()})
        bad_steps = [s["launches"] for s in probe.steps
                     if s["launches"] != per_step]
        step_syncs = [s["syncs"] for s in probe.steps]
        if (state.step != RESTORE_STEPS or len(losses) != RESTORE_STEPS
                or not all(np.isfinite(losses)) or bad_steps
                or any(step_syncs)):
            problems.append(f"loop: step {state.step}, losses {losses}, "
                            f"launches {bad_steps[:2]}, syncs {step_syncs}")
        starts = [s["start"] for s in probe.steps]
        steady = [b - a for i, (a, b) in enumerate(zip(starts, starts[1:]))
                  if i > 0 and cfg["train"]["profile_at_step"] not in
                  (i + 1, i + 2)]
        profile = json.loads((ckpt_dir / "profile" / "summary.json")
                             .read_text())
        del state
        torch.cuda.empty_cache()

        # export, then bf16 serving of the fine-tune against f32 on the CPU
        out_dir = work / "restoration_artifact"
        t0 = time.perf_counter()
        export_model(ckpt_dir / "config.json", ckpt_dir, out_dir)
        timings["export_s"] = time.perf_counter() - t0
        batch = add_noise(synthetic_images(EXPORT_BATCH, EXPORT_SIZE,
                                           EXPORT_SIZE, rng), 25.0, rng)
        tuned = bidt.load_model(out_dir)
        c0 = read_counts()
        served = tuned(batch)
        c1 = read_counts()
        serve_launches = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
        cpu = bidt.load_model(out_dir, device="cpu", dtype="float32")
        serve_gap = gray_gap(served, cpu(batch))
        del cpu
        if serve_launches != dict(convnext_block=10, band_smooth=2) or \
                serve_gap["mean"] > EXPORT_BF16_MEAN or \
                serve_gap["p99"] > EXPORT_BF16_P99:
            problems.append(f"serving the fine-tune: {serve_launches}, "
                            f"{serve_gap}")
        times = timed_requests(tuned, batch, EXPORT_REQUESTS)

        # the restoration report card: the recipe's specs on seeded images,
        # the packaged flagship and the fine-tune, the card's corruptions
        # against the CPU's
        images = load_evaluation_images(RESTORE_SWEEP_SIZE)[
            :RESTORE_SWEEP_IMAGES]
        spec_gap = {}
        for spec in RESTORE_SPECS:
            card = evaluate.apply_degradations(images, spec, seed=SEED)
            host = evaluate.apply_degradations(images, spec, seed=SEED,
                                               device="cpu")
            d = np.abs(card - host)
            spec_gap[spec] = dict(equal_share=float((d == 0).mean()),
                                  max=float(d.max()))
            if spec_gap[spec]["equal_share"] < SPEC_EQUAL_SHARE or \
                    spec_gap[spec]["max"] > 1.0:
                problems.append(f"apply_degradations card vs CPU {spec}: "
                                f"{spec_gap[spec]}")
        t0 = time.perf_counter()
        flagship = bidt.load_model(FLAGSHIP)
        sweeps = {name: evaluate.degradation_sweep(den, images,
                                                   RESTORE_SPECS)
                  for name, den in (("flagship", flagship),
                                    ("fine_tune", tuned))}
        timings["sweeps_s"] = time.perf_counter() - t0
        report = {spec: dict(
            mae_corrupt=sweeps["flagship"][i]["mae_corrupt"],
            mae_flagship=sweeps["flagship"][i]["mae_restored"],
            mae_fine_tune=sweeps["fine_tune"][i]["mae_restored"])
            for i, spec in enumerate(RESTORE_SPECS)}
        if not all(np.isfinite(v) for r in report.values()
                   for v in r.values()):
            problems.append(f"sweep {report}")
        del flagship, tuned
    torch.cuda.empty_cache()
    c_end = read_counts()
    launches = {k: c_end[k] - c_start[k] for k in c_end}
    median = statistics.median(steady) if steady else None
    result = dict(
        config=TRAIN_CONFIG, recipe="scripts/train_restoration.py",
        overrides=RESTORE_OVERRIDES,
        reduced=dict(steps=f"{RESTORE_STEPS} (the recipe runs 15000)",
                     inputs="24 seeded 480x640 PNG scenes (KITTI and "
                            "MegaDepth are not in the checkout)"),
        batch=ds["batch_size"], micro_batches=micro,
        crop=ds["input_shape"], ops_card_vs_cpu=ops,
        chain_statistics=stats, step_check=step_check, losses=losses,
        launches_per_step=[s["launches"] for s in probe.steps][:1],
        syncs_in_steps=step_syncs,
        step_host_s=[round(s["host_s"], 4) for s in probe.steps],
        steady_step_s=[round(t, 4) for t in steady],
        steps_per_s=1.0 / median if median else None,
        images_per_s=(ds["batch_size"] * micro / median if median
                      else None),
        profiled_step=dict(profile, step=cfg["train"]["profile_at_step"]),
        serve_launches_per_forward=serve_launches,
        serve_bf16_vs_f32_cpu=serve_gap,
        serve_b8_256_median_s=statistics.median(times),
        serve_b8_256_images_per_s=EXPORT_BATCH / statistics.median(times),
        apply_degradations_card_vs_cpu=spec_gap, sweep=report,
        timings=timings, launches=launches, smi=smi,
        tolerance=f"ops card vs CPU: rotate {ROTATE_ATOL}, blur "
                  f"{BLUR_ATOL}, JPEG mean {JPEG_MEAN} and >= "
                  f"{JPEG_NEAR_SHARE} within {JPEG_NEAR}, posterize and "
                  f"holes exact; chain gate rates, the hole rate within "
                  f"4 sigma, sigma and quality in range, redrawn gates "
                  f"bit-exact, noise-only = the chain's noise draw; no "
                  f"sync in a step; per micro-batch "
                  f"{RESTORE_PER_MICRO_BATCH}, no K3, no K1; serving 10 K1 "
                  f"+ 2 K2 a forward, bf16 vs f32 CPU mean <= "
                  f"{EXPORT_BF16_MEAN}, p99 <= {EXPORT_BF16_P99}; "
                  f"apply_degradations card vs CPU >= {SPEC_EQUAL_SHARE} "
                  f"equal, max 1")
    log("restoration", **result)
    if problems:
        raise AssertionError(f"restoration: {problems}")
    return kernel_inputs.seen, launches


# ---------------------------------------------------------- unet backbone

# the unet_backbone phase: the classic unet at the JAX builder's defaults
# (filters 32, 3 levels, 1 layer, kernel 3, BatchNorm) with its gates,
# sparse features and the he_normal initializer on, and the train and
# dataset sections of the resnet config (f32); no config of it ships
UNET_BACKBONE = {"type": "unet", "input_shape": ["?", "?", 3],
                 "value_range": [0, 255], "add_gates": True,
                 "add_sparse_features": True,
                 "kernel_initializer": "he_normal"}
UNET_STEP_LOSS_RTOL, UNET_STEP_MIN_COSINE = 1e-4, 0.9999
# the seeded artifact's bf16 serving bar: PERF.md §2's bars do not hold a
# model 0 steps from its init (its heads saturate, so one rounding moves
# an output across the range): JAX's own bf16-from-f32 gap on the same
# artifact and batch (unet_bf16_gap.py) with half of it to spare
# (JAX: mean 2.4345, p99 54; the port on the CPU: 2.3219, 54)
UNET_BF16_MEAN, UNET_BF16_P99 = 1.5 * 2.4345, 1.5 * 54.0


def unet_config(bidt):
    cfg = copy.deepcopy(bidt.CONFIGS_DICT[RESNET_CONFIG])
    cfg["model"] = {"backbone": dict(UNET_BACKBONE),
                    "denoiser": cfg["model"]["denoiser"]}
    return cfg


def unet_inputs(ds):
    """The unet_backbone phase's inputs from its seed: the step's clean
    and noisy batches (the config's batch and crop) and the noisy b8 @
    256² uint8 batch it serves (``unet_bf16_gap.py`` makes the same
    ones)."""
    rng = np.random.default_rng(SEED + 30)
    clean = np.round(synthetic_images(ds["batch_size"],
                                      *ds["input_shape"][:2], rng))
    noisy = add_noise(clean, 20.0, rng).astype(np.float32)
    serve = add_noise(synthetic_images(EXPORT_BATCH, EXPORT_SIZE,
                                       EXPORT_SIZE, rng), 25.0, rng)
    return clean, noisy, serve


def unet_backbone_phase(bidt, smi, read_counts, loop_run):
    """The unet config (``UNET_BACKBONE``): one f32 train step on the card
    against the CPU from the same seeded weights and batch (loss, the
    gradient's cosine, the running statistics), then the ``build`` CLI's
    seeded artifact served through ``load_model`` at b8 @ 256² in f32 and
    bf16 against f32 on the CPU, with no K1 or K2 launch. Returns the
    launch counts of the phase."""
    from blind_image_denoising_torch import build as build_cli
    from blind_image_denoising_torch.models.hydra import model_builder
    from blind_image_denoising_torch.ops.multiscale import multiscale_targets
    from blind_image_denoising_torch.ops.precision import exact_float32
    from blind_image_denoising_torch.training import (forward_loss,
                                                      loss_function_builder)
    from blind_image_denoising_torch.training.train_state import init_params

    work = loop_run["work"]
    cfg = unet_config(bidt)
    problems = []
    c_start = read_counts()
    clean, noisy, batch = unet_inputs(cfg["dataset"])
    clean, noisy = torch.from_numpy(clean), torch.from_numpy(noisy)

    # one f32 step's loss and gradients, card against CPU
    gt = multiscale_targets(clean, 0, clip_values=True, round_values=True)
    fns = loss_function_builder(cfg["loss"])
    seeded = model_builder(copy.deepcopy(cfg["model"])).hydra
    init_params(seeded, torch.Generator().manual_seed(SEED))
    weights = {k: v.clone() for k, v in seeded.state_dict().items()}
    out = {}
    for dev in ("cpu", "cuda"):
        hydra = model_builder(copy.deepcopy(cfg["model"])).hydra
        hydra.load_state_dict(weights)
        hydra.to(dev)
        t0 = time.perf_counter()
        with exact_float32(dev == "cuda"):
            total, _ = forward_loss(hydra, fns, 1, noisy.to(dev),
                                    [g.to(dev) for g in gt],
                                    torch.ones((1,), device=dev),
                                    torch.Generator(device=dev))
            total.backward()
        grads = torch.cat([(torch.zeros_like(p) if p.grad is None
                            else p.grad).double().flatten().cpu()
                           for p in hydra.parameters()])
        out[dev] = (float(total.detach()), grads,
                    {k: v.cpu() for k, v in hydra.named_buffers()},
                    time.perf_counter() - t0)
        del hydra
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    cosine = float(F.cosine_similarity(out["cuda"][1], out["cpu"][1], dim=0))
    stats_rel = max(float((out["cuda"][2][k] - v).abs().max()
                          / v.abs().max().clamp_min(1e-30))
                    for k, v in out["cpu"][2].items())
    if loss_rel > UNET_STEP_LOSS_RTOL or cosine < UNET_STEP_MIN_COSINE or \
            stats_rel > RESNET_STATS_RTOL:
        problems.append(f"step card vs CPU: loss {loss_rel}, cosine "
                        f"{cosine}, statistics {stats_rel}")

    # the build CLI's seeded artifact, served
    cfg_file = work / "unet_config.json"
    cfg_file.write_text(json.dumps(cfg, indent=1))
    build_dir = work / "unet_build"
    t0 = time.perf_counter()
    if build_cli.main(["--pipeline-config", str(cfg_file),
                       "--output-directory", str(build_dir)]) != 0:
        problems.append("the build CLI failed")
    build_s = time.perf_counter() - t0
    (build_dir / "pipeline.json").write_text(cfg_file.read_text())
    reference = bidt.load_model(build_dir, device="cpu",
                                dtype="float32")(batch)
    served = {}
    for dtype in ("float32", "bfloat16"):
        den = bidt.load_model(build_dir, dtype=dtype)
        c0 = read_counts()
        got = den(batch)
        c1 = read_counts()
        launches = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
        gap = gray_gap(got, reference)
        ok = (gap["mean"] <= FAMILY_F32_MEAN
              and gap["equal_share"] >= FAMILY_F32_EQUAL
              if dtype == "float32" else
              gap["mean"] <= UNET_BF16_MEAN and gap["p99"] <= UNET_BF16_P99)
        if not ok or launches or got.shape != batch.shape:
            problems.append(f"{dtype}: gap {gap}, launches {launches}")
        times = timed_requests(den, batch, EXPORT_REQUESTS)
        served[dtype] = dict(vs_f32_cpu=gap, launches=launches,
                             median_s=statistics.median(times),
                             images_per_s=EXPORT_BATCH
                             / statistics.median(times))
        del den
    torch.cuda.empty_cache()
    c_end = read_counts()
    launches = {k: c_end[k] - c_start[k] for k in c_end}
    result = dict(
        backbone=UNET_BACKBONE, train_and_dataset=RESNET_CONFIG,
        params=sum(v.numel() for k, v in weights.items()
                   if not k.endswith(("mean", "var"))),
        step_batch=list(noisy.shape), step_loss_card=out["cuda"][0],
        step_loss_cpu=out["cpu"][0], step_loss_rel=loss_rel,
        step_grad_cosine=cosine, step_statistics_worst_rel=stats_rel,
        cpu_step_s=out["cpu"][3], build_cli_s=build_s, served=served,
        launches=launches, smi=smi,
        tolerance=f"f32 step card vs CPU loss rtol {UNET_STEP_LOSS_RTOL}, "
                  f"grad cosine >= {UNET_STEP_MIN_COSINE}, running "
                  f"statistics {RESNET_STATS_RTOL}; f32 serve vs CPU mean "
                  f"<= {FAMILY_F32_MEAN}, >= {FAMILY_F32_EQUAL} equal; bf16 "
                  f"mean <= {UNET_BF16_MEAN}, p99 <= {UNET_BF16_P99} (JAX's "
                  f"own gap on this artifact and batch, x1.5); no K1-K4 "
                  f"launch")
    log("unet_backbone", **result)
    if problems:
        raise AssertionError(f"unet_backbone: {problems}")
    return launches


# ------------------------------------------------------------ distillation

# the distillation phase: the JAX distill docstring's own use, the
# per-level-width flagship config trained from a seeded init at its shipped
# size (b4 x 8 micro-batches x 256², bf16, the noise kernel as in the
# train_loop phase) and distilled from the packaged v5.6 (f32, weight 1,
# gt_weight 0.5), pruned after each epoch; on the train_loop phase's scenes
# (3 steps an epoch), so the 4 steps (the cut) prune after steps 3 and 4
DISTILL_TEACHER = "unet_laplacian_v56_highnoise"
DISTILL_STEPS = 4
DISTILL_PRUNE = {"strategy": "MINIMUM_THRESHOLD",
                 "config": {"minimum_threshold": 1e-3}, "every_epochs": 1}
DISTILL_SPEC = {"teacher": DISTILL_TEACHER, "dtype": "float32",
                "weight": 1.0, "gt_weight": 0.5}
DISTILL_OVERRIDES = {
    "train.total_steps": DISTILL_STEPS, "train.checkpoint_every": -1,
    "train.visualization_every": -1, "train.log_every": 1,
    "train.ema": 0.999, "train.use_test_images": False,
    "train.profile_at_step": -1, "tpu.pallas_noise": True,
    "train.prune": DISTILL_PRUNE, "train.distillation": DISTILL_SPEC}
DISTILL_PER_MICRO_BATCH = dict(band_smooth=2, band_smooth_bwd=2,
                               corrupt_noise=1)
# the distilled step card vs CPU in f32 (the v4 bars), on one micro-batch
# cut to b2 @ 128² so the CPU's full-width flagship and teacher stay short
DISTILL_CHECK_BATCH, DISTILL_CHECK_SIZE = 2, 128
DISTILL_LOSS_RTOL, DISTILL_MIN_COSINE = 1e-4, 0.9999
# the distilled run served bf16 against f32 on the CPU: a 4-step model
# from a seeded init, where PERF.md §2's p99 bar does not hold for JAX
# either, so JAX's own gap on such an artifact and batch + 0.5. The
# run's artifact differs from card run to card run, and so does the
# gap: `python distill_bf16_gap.py DIR` on eight --keep-distill
# artifacts reads JAX 0.8840-1.5957 / p99 3-6 and the port on the CPU
# 0.7416-1.3511 / p99 3-5, so the bar is JAX's largest of them + 0.5
DISTILL_BF16_MEAN, DISTILL_BF16_P99 = 1.5957 + 0.5, 6.0 + 0.5
# the flagship as a bf16 teacher against the f32 flagship on the CPU:
# PERF.md §2's bars (JAX's own gap there 0.7685 / p99 3, the port's on the
# CPU 0.7126 / 3: distill_bf16_gap.py)
TEACHER_BATCH, TEACHER_SIZE = 16, 128
TEACHER_BF16_MEAN, TEACHER_BF16_P99 = EXPORT_BF16_MEAN, EXPORT_BF16_P99


def distill_config(base, image_dir):
    cfg = copy.deepcopy(base)
    cfg["dataset"]["inputs"] = ([{"directory": str(image_dir)}]
                                if image_dir is not None else [])
    for key, value in DISTILL_OVERRIDES.items():
        section, name = key.split(".")
        cfg.setdefault(section, {})[name] = copy.deepcopy(value)
    return cfg


def teacher_inputs():
    """The distillation phase's served batch (noisy b8 @ 256² uint8) and
    its bf16-teacher batch (noisy b16 @ 128² float32), from its seed;
    ``distill_bf16_gap.py`` makes the same ones."""
    rng = np.random.default_rng(SEED + 40)
    served = add_noise(synthetic_images(EXPORT_BATCH, EXPORT_SIZE,
                                        EXPORT_SIZE, rng), 25.0, rng)
    teacher = add_noise(synthetic_images(TEACHER_BATCH, TEACHER_SIZE,
                                         TEACHER_SIZE, rng), 25.0,
                        rng).astype(np.float32)
    return served, teacher


class PruneProbe:
    """Within the block, records the tensors the training loop hands to
    ``prune_params`` (a CPU copy, before the prune) and the prune
    function, in call order (the params, then the EMA, per epoch)."""

    def __init__(self):
        import importlib
        self.loop = importlib.import_module(
            "blind_image_denoising_torch.training.train_loop")
        self.calls = []

    def __enter__(self):
        real = self._real = self.loop.prune_params

        def recording(tensors, prune_fn, *args, **kw):
            self.calls.append(({k: v.detach().cpu().clone()
                                for k, v in tensors.items()}, prune_fn))
            return real(tensors, prune_fn, *args, **kw)

        self.loop.prune_params = recording
        return self

    def __exit__(self, *exc):
        self.loop.prune_params = self._real


def distilled_step_card_vs_cpu(bidt, cfg, weights, read_counts):
    """One f32 micro-batch of the distilled step (the seeded student with
    drop-path and attention dropout off, the f32 v5.6 teacher on the same
    corrupted batch) on the card and on the CPU: the losses, the
    gradient cosine, the card's launches and the CPU's seconds."""
    from blind_image_denoising_torch.models.hydra import model_builder
    from blind_image_denoising_torch.ops.multiscale import multiscale_targets
    from blind_image_denoising_torch.ops.precision import exact_float32
    from blind_image_denoising_torch.training import (forward_loss,
                                                      loss_function_builder)
    from blind_image_denoising_torch.training.distill import build_teacher
    rng = np.random.default_rng(SEED + 41)
    clean = np.round(synthetic_images(DISTILL_CHECK_BATCH,
                                      DISTILL_CHECK_SIZE,
                                      DISTILL_CHECK_SIZE, rng))
    noisy = torch.from_numpy(add_noise(clean, 25.0, rng).astype(np.float32))
    clean = torch.from_numpy(clean)
    fns = loss_function_builder(cfg["loss"])
    # drop-path and attention dropout off: their masks come from each
    # device's own generator
    mc = copy.deepcopy(cfg["model"])
    mc["backbone"].update(depth_drop_rate=0.0,
                          convolutional_self_attention_dropout_rate=0.0)
    out = {}
    for device in ("cpu", "cuda"):
        teacher_fn, opts = build_teacher(DISTILL_SPEC, device=device)
        hydra = model_builder(copy.deepcopy(mc)).hydra
        hydra.load_state_dict(weights)
        hydra.to(device)
        n = hydra.no_outputs
        gt = multiscale_targets(clean, n - 1, clip_values=True,
                                round_values=True)
        c0, t0 = read_counts(), time.perf_counter()
        with exact_float32(device == "cuda"):
            x = noisy.to(device)
            total, metrics = forward_loss(
                hydra, fns, n, x, [g.to(device) for g in gt],
                torch.full((n,), 1.0 / n, device=device),
                torch.Generator(device=device), teacher_out=teacher_fn(x),
                distill_weight=opts["weight"], gt_weight=opts["gt_weight"])
            total.backward()
        grads = torch.cat([(torch.zeros_like(p) if p.grad is None
                            else p.grad).double().flatten().cpu()
                           for p in hydra.parameters()])
        c1 = read_counts()
        out[device] = (float(total.detach()), grads,
                       float(metrics["distill/mae_loss"]),
                       time.perf_counter() - t0,
                       {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]})
        del hydra, teacher_fn
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    cosine = float(F.cosine_similarity(out["cuda"][1], out["cpu"][1],
                                       dim=0))
    return dict(batch=list(noisy.shape), loss_card=out["cuda"][0],
                loss_cpu=out["cpu"][0], loss_rel=loss_rel,
                grad_cosine=cosine, distill_mae_card=out["cuda"][2],
                distill_mae_cpu=out["cpu"][2], cpu_s=out["cpu"][3],
                card_launches=out["cuda"][4])


def distilled_step_without_sync(bidt, cfg, read_counts):
    """The distilled step built directly on the card (the seeded student,
    bf16, the noise kernel, 2 micro-batches of the config's b4 @ 256²):
    one warm-up step, then two under ``set_sync_debug_mode("error")``;
    returns the launches per micro-batch and the last loss."""
    from blind_image_denoising_torch.models.hydra import model_builder
    from blind_image_denoising_torch.training import (
        build_train_step, create_train_state, loss_function_builder,
        optimizer_builder)
    from blind_image_denoising_torch.training.distill import build_teacher
    ds = cfg["dataset"]
    hydra = model_builder(copy.deepcopy(cfg["model"]),
                          dtype=torch.bfloat16).hydra
    tx, _ = optimizer_builder(cfg["train"]["optimizer"])
    state = create_train_state(hydra, tx, seed=SEED)
    teacher_fn, opts = build_teacher(DISTILL_SPEC)
    micro = 2
    step = build_train_step(
        hydra, tx, loss_function_builder(cfg["loss"]), hydra.no_outputs,
        additive_noise=ds["additional_noise"],
        multiplicative_noise=ds.get("multiplicative_noise"),
        grad_accum=micro, use_pallas_noise=True, teacher_fn=teacher_fn,
        distill_weight=opts["weight"], distill_gt_weight=opts["gt_weight"])
    rng = np.random.default_rng(SEED + 42)
    batch = torch.from_numpy(np.round(synthetic_images(
        micro * ds["batch_size"], *ds["input_shape"][:2], rng))).cuda()
    dw = torch.full((hydra.no_outputs,), 1.0 / hydra.no_outputs,
                    device="cuda")
    state, _ = step(state, batch, depth_weights=dw)
    torch.cuda.synchronize()
    c0 = read_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            state, metrics = step(state, batch, depth_weights=dw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    c1 = read_counts()
    loss = float(metrics["total_loss"])
    distill_mae = float(metrics["distill/mae_loss"])
    del state, step, hydra, teacher_fn
    torch.cuda.empty_cache()
    return dict(micro_batches=micro,
                launches_per_micro_batch={k: (c1[k] - c0[k]) / (2 * micro)
                                          for k in c1},
                loss=loss, distill_mae=distill_mae)


def distillation_phase(bidt, smi, read_counts, loop_run, keep=None):
    """The distillation recipe on the card (``DISTILL_OVERRIDES``): the
    distilled step without a host sync and its launches per micro-batch
    (K2 2, K2 bwd 2, K3 1; no K1: the v5.6 teacher runs none and the
    student trains through the units' branch); one f32 micro-batch card
    against CPU; ``train_loop`` for 4 steps from a seeded init with
    ``train.prune``, the checkpoint's params and EMA equal to the port's
    ``prune_params`` of the tensors the loop pruned, bit for bit;
    ``export_model`` and bf16 serving of the run (10 K1 + 2 K2 a forward)
    against f32 on the CPU; the flagship as a bf16 teacher
    (``build_teacher``) on b16 @ 128² (10 K1 + 2 K2) against the f32
    flagship on the CPU. Returns (kernel inputs seen, launch counts)."""
    import warnings
    from blind_image_denoising_torch import pruning
    from blind_image_denoising_torch.inference.export import export_model
    from blind_image_denoising_torch.models.hydra import model_builder
    from blind_image_denoising_torch.ops.resize import nchw, nhwc
    from blind_image_denoising_torch.training.checkpoint import (
        CheckpointManager)
    from blind_image_denoising_torch.training.distill import build_teacher
    from blind_image_denoising_torch.training.train_state import init_params

    work, image_dir = loop_run["work"], loop_run["image_dir"]
    cfg = distill_config(bidt.CONFIGS_DICT[TRAIN_CONFIG], image_dir)
    problems, timings = [], {}
    c_start = read_counts()
    seeded = model_builder(copy.deepcopy(cfg["model"])).hydra
    init_params(seeded, torch.Generator().manual_seed(SEED))
    weights = {k: v.clone() for k, v in seeded.state_dict().items()}
    del seeded

    with KernelInputs() as kernel_inputs:
        t0 = time.perf_counter()
        no_sync = distilled_step_without_sync(bidt, cfg, read_counts)
        timings["step_without_sync_s"] = time.perf_counter() - t0
        want = dict(dict.fromkeys(read_counts(), 0), **DISTILL_PER_MICRO_BATCH)
        if no_sync["launches_per_micro_batch"] != want or not np.isfinite(
                no_sync["loss"]):
            problems.append(f"step: {no_sync}")

        t0 = time.perf_counter()
        f32 = distilled_step_card_vs_cpu(bidt, cfg, weights, read_counts)
        timings["f32_card_vs_cpu_s"] = time.perf_counter() - t0
        if f32["loss_rel"] > DISTILL_LOSS_RTOL or \
                f32["grad_cosine"] < DISTILL_MIN_COSINE:
            problems.append(f"f32 step card vs CPU: {f32}")

        # the recipe's loop from the seeded init, pruned per epoch
        ckpt_dir = work / "distill_run"
        micro = cfg["train"]["gpu_batches_per_step"]
        with LoopProbe(read_counts) as probe, PruneProbe() as pruned, \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            probe.warnings = caught
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                state = bidt.train_loop(cfg, ckpt_dir)
                timings["loop_s"] = time.perf_counter() - t0
            finally:
                torch.cuda.set_sync_debug_mode(0)
        rows = [json.loads(line) for line in
                (ckpt_dir / "metrics.jsonl").read_text().splitlines()]
        losses = [r["total_loss"] for r in rows if "total_loss" in r]
        distill_mae = [r["distill/mae_loss"] for r in rows
                       if "distill/mae_loss" in r]
        per_step = dict(dict.fromkeys(read_counts(), 0),
                        **{k: micro * v for k, v in
                           DISTILL_PER_MICRO_BATCH.items()})
        bad_steps = [s["launches"] for s in probe.steps
                     if s["launches"] != per_step]
        step_syncs = [s["syncs"] for s in probe.steps]
        if (state.step != DISTILL_STEPS or len(losses) != DISTILL_STEPS
                or not all(np.isfinite(losses)) or bad_steps
                or any(step_syncs) or len(distill_mae) != DISTILL_STEPS
                or not all(np.isfinite(v) and v > 0 for v in distill_mae)):
            problems.append(f"loop: step {state.step}, losses {losses}, "
                            f"distill/mae_loss {distill_mae}, launches "
                            f"{bad_steps[:2]}, syncs {step_syncs}")
        # two epochs ended (after steps 3 and 4): params, then EMA, each;
        # each epoch's checkpoint holds the port's prune of what the loop
        # pruned, bit for bit
        manager = CheckpointManager(str(ckpt_dir))
        prune_report = []
        if len(pruned.calls) != 4:
            problems.append(f"{len(pruned.calls)} prunes, not 4")
        for epoch_end, step in ((0, 3), (1, 4)):
            ckpt = manager.read(step)
            calls = pruned.calls[2 * epoch_end:2 * epoch_end + 2]
            for which, (before, fn), saved in zip(
                    ("params", "ema"), calls,
                    (ckpt["model"], ckpt["ema_params"])):
                want_t = pruning.prune_params(before, fn)
                differ = [k for k, v in want_t.items()
                          if not torch.equal(saved[k], v)]
                zeros = sum(int((v == 0).sum()) for v in want_t.values())
                newly = sum(int(((v == 0) & (before[k] != 0)).sum())
                            for k, v in want_t.items())
                prune_report.append(dict(step=step, tensors=which,
                                         zeros=zeros, pruned_now=newly,
                                         differing=differ[:4]))
                if differ or not newly:
                    problems.append(f"prune at step {step} ({which}): "
                                    f"{len(differ)} differ, {newly} zeroed")
        del state
        torch.cuda.empty_cache()

        # export, then bf16 serving of the run against f32 on the CPU
        out_dir = work / "distill_artifact"
        t0 = time.perf_counter()
        export_model(ckpt_dir / "config.json", ckpt_dir, out_dir)
        timings["export_s"] = time.perf_counter() - t0
        served_batch, teacher_batch = teacher_inputs()
        den = bidt.load_model(out_dir)
        c0 = read_counts()
        served = den(served_batch)
        c1 = read_counts()
        serve_launches = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
        cpu = bidt.load_model(out_dir, device="cpu", dtype="float32")
        serve_gap = gray_gap(served, cpu(served_batch))
        del cpu
        if serve_launches != dict(convnext_block=10, band_smooth=2) or \
                serve_gap["mean"] > DISTILL_BF16_MEAN or \
                serve_gap["p99"] > DISTILL_BF16_P99:
            problems.append(f"serving the distilled run: {serve_launches}, "
                            f"{serve_gap}")
        times = timed_requests(den, served_batch, EXPORT_REQUESTS)
        del den
        if keep is not None:
            keep.mkdir(parents=True, exist_ok=True)
            for name in ("params.msgpack", "pipeline.json"):
                (keep / name).write_bytes((out_dir / name).read_bytes())
            np.save(keep / "batch.npy", served_batch)

        # the flagship as a bf16 teacher (bf16 parameters), against the
        # f32 flagship on the CPU
        t0 = time.perf_counter()
        teacher_fn, _ = build_teacher({"teacher": FLAGSHIP,
                                       "dtype": "bfloat16"})
        x = torch.from_numpy(teacher_batch).cuda()
        teacher_fn(x)                                    # warm-up
        torch.cuda.synchronize()
        c0 = read_counts()
        y = teacher_fn(x)
        torch.cuda.synchronize()
        c1 = read_counts()
        teacher_launches = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
        teacher_ms = cuda_ms(lambda: teacher_fn(x), iters=5, warmup=1)
        ref_model = bidt.load_model(FLAGSHIP, device="cpu",
                                    dtype="float32").model
        with torch.no_grad():
            ref = nhwc(ref_model(nchw(torch.from_numpy(teacher_batch))
                                 .contiguous())[0]).float()
        to_u8 = lambda t: np.clip(np.round(t.cpu().numpy()), 0,  # noqa
                                  255).astype(np.uint8)
        teacher_gap = gray_gap(to_u8(y), to_u8(ref))
        timings["teacher_s"] = time.perf_counter() - t0
        if y.dtype != torch.float32 or tuple(y.shape) != teacher_batch.shape \
                or teacher_launches != dict(convnext_block=10,
                                            band_smooth=2) or \
                teacher_gap["mean"] > TEACHER_BF16_MEAN or \
                teacher_gap["p99"] > TEACHER_BF16_P99:
            problems.append(f"bf16 teacher: {y.dtype} {tuple(y.shape)}, "
                            f"{teacher_launches}, {teacher_gap}")
        del teacher_fn, ref_model, x, y
    torch.cuda.empty_cache()
    c_end = read_counts()
    launches = {k: c_end[k] - c_start[k] for k in c_end}
    starts = [s["start"] for s in probe.steps]
    steady = [b - a for a, b in zip(starts[1:], starts[2:])]
    median = statistics.median(steady) if steady else None
    ds = cfg["dataset"]
    result = dict(
        config=TRAIN_CONFIG, teacher=DISTILL_SPEC, prune=DISTILL_PRUNE,
        reduced=dict(steps=f"{DISTILL_STEPS}",
                     inputs="24 seeded 480x640 PNG scenes",
                     f32_check=f"one micro-batch of b{DISTILL_CHECK_BATCH} "
                               f"@ {DISTILL_CHECK_SIZE}^2"),
        batch=ds["batch_size"], micro_batches=micro, crop=ds["input_shape"],
        step_without_sync=no_sync, f32_card_vs_cpu=f32, losses=losses,
        distill_mae_loss=distill_mae,
        launches_per_step=[s["launches"] for s in probe.steps][:1],
        syncs_in_steps=step_syncs,
        step_host_s=[round(s["host_s"], 4) for s in probe.steps],
        steady_step_s=[round(t, 4) for t in steady],
        steps_per_s=1.0 / median if median else None,
        images_per_s=(ds["batch_size"] * micro / median if median
                      else None),
        prunes=prune_report, serve_launches_per_forward=serve_launches,
        serve_bf16_vs_f32_cpu=serve_gap,
        serve_b8_256_median_s=statistics.median(times),
        serve_b8_256_images_per_s=EXPORT_BATCH / statistics.median(times),
        teacher_bf16=dict(batch=list(teacher_batch.shape),
                          launches=teacher_launches, ms=teacher_ms,
                          vs_f32_cpu=teacher_gap),
        timings=timings, launches=launches, smi=smi,
        tolerance=f"no sync in a step; per micro-batch "
                  f"{DISTILL_PER_MICRO_BATCH}, no K1; f32 step card vs CPU "
                  f"loss rtol {DISTILL_LOSS_RTOL}, grad cosine >= "
                  f"{DISTILL_MIN_COSINE}; checkpoint = prune_params of the "
                  f"pruned tensors bit for bit; served 10 K1 + 2 K2 a "
                  f"forward, bf16 vs f32 CPU mean <= {DISTILL_BF16_MEAN}, "
                  f"p99 <= {DISTILL_BF16_P99}; bf16 teacher 10 K1 + 2 K2, "
                  f"vs the f32 flagship on the CPU mean <= "
                  f"{TEACHER_BF16_MEAN}, p99 <= {TEACHER_BF16_P99}")
    log("distillation", **result)
    if problems:
        raise AssertionError(f"distillation: {problems}")
    return kernel_inputs.seen, launches


# ---------------------------------------------------------------- analysis

# the analysis phase: analysis.analyze on the f32 flagship, a 128² crop of
# the first packaged evaluation image with sigma 25 noise drawn on the host
# (the CLI's defaults: a 2 x 2 pixel grid, alphas 0.25 / 0.5 / 0.75)
ANALYSIS_SIZE, ANALYSIS_SIGMA = 128, 25.0
ANALYSIS_MEAN_GRAY = 1e-3
ANALYSIS_ROW_MIN_COSINE, ANALYSIS_ROW_REL = 0.9999, 1e-2
ANALYSIS_WEIGHT_SUM_ATOL, ANALYSIS_EQUIVARIANCE_ATOL = 1e-3, 1e-4


class ToolProbe:
    """Within the block, the launch counts and seconds of each of
    ``analysis``'s three tools, per call (``analyze`` looks them up in the
    module)."""

    TOOLS = ("net_bias_map", "adaptive_filters", "scale_equivariance")

    def __init__(self, analysis, read_counts):
        self.analysis, self.read_counts = analysis, read_counts
        self.calls = []

    def __enter__(self):
        self._saved = {name: getattr(self.analysis, name)
                       for name in self.TOOLS}
        for name, fn in self._saved.items():
            def probed(*args, _fn=fn, _name=name, **kw):
                c0, t0 = self.read_counts(), time.perf_counter()
                out = _fn(*args, **kw)
                torch.cuda.synchronize()
                c1 = self.read_counts()
                self.calls.append(dict(
                    tool=_name, seconds=time.perf_counter() - t0,
                    launches={k: c1[k] - c0[k] for k in c1
                              if c1[k] != c0[k]}))
                return out
            setattr(self.analysis, name, probed)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.analysis, name, fn)


def analysis_inputs():
    """The analysis phase's image: [128, 128, 3] float32, as the CLI makes
    it at its defaults (``--seed 0``)."""
    from blind_image_denoising_torch.images import load_evaluation_images
    from blind_image_denoising_torch.ops.noise import corrupt_batch_fixed_std
    image = load_evaluation_images(ANALYSIS_SIZE)[0].astype(np.float32)
    noisy = corrupt_batch_fixed_std(torch.Generator().manual_seed(SEED),
                                    torch.from_numpy(image[None]),
                                    std=ANALYSIS_SIGMA)
    return np.clip(noisy[0].numpy(), 0, 255)


def analysis_phase(bidt, smi, read_counts):
    """``analysis.analyze`` of the f32 flagship on the card against the
    same call on the CPU, with each tool's exact launches on the card:
    ``net_bias_map`` in forward mode (K2 on the primal and on the
    tangent: 4, no K1, no K2 backward), ``adaptive_filters`` (no K1; K2
    2 and 2 K2 backward per pixel) and ``scale_equivariance`` (10 K1 +
    2 K2 per forward, 1 + one per alpha forwards); then the ``analyze``
    CLI on the bf16 flagship as a subprocess. Returns (kernel inputs
    seen, launch counts)."""
    from blind_image_denoising_torch import analysis
    problems = []
    c_start = read_counts()
    image = analysis_inputs()
    pixels = analysis.grid_pixels(image.shape[:2])
    alphas = (0.25, 0.5, 0.75)
    out = {}
    with KernelInputs() as kernel_inputs:
        for device in ("cuda", "cpu"):
            den = bidt.load_model(FLAGSHIP, dtype="float32", device=device)
            if device == "cuda":
                analysis.analyze(den, image, pixels=pixels, alphas=alphas)
                torch.cuda.synchronize()
            with ToolProbe(analysis, read_counts) as probe:
                t0 = time.perf_counter()
                out[device] = analysis.analyze(den, image, pixels=pixels,
                                               alphas=alphas)
                seconds = time.perf_counter() - t0
            out[device] = out[device] + (probe.calls, seconds)
            del den
    (report, res, denoised, bias, calls, card_s), \
        (cpu_report, cpu_res, cpu_denoised, cpu_bias, cpu_calls, cpu_s) = \
        out["cuda"], out["cpu"]
    n_fwd = 1 + len(alphas)
    want = dict(
        net_bias_map=dict(band_smooth=4),
        adaptive_filters=dict(band_smooth=2,
                              band_smooth_bwd=2 * len(pixels)),
        scale_equivariance=dict(convnext_block=10 * n_fwd,
                                band_smooth=2 * n_fwd))
    got = {c["tool"]: c["launches"] for c in calls}
    if got != want:
        problems.append(f"launches {got}, want {want}")
    gaps = dict(denoised_mean=float(np.abs(denoised - cpu_denoised).mean()),
                bias_map_mean=float(np.abs(bias - cpu_bias).mean()))
    rows = []
    for a, b in zip(res.filters, cpu_res.filters):
        a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
        rows.append(dict(cosine=float(a @ b / np.linalg.norm(a)
                                      / np.linalg.norm(b)),
                         rel=float(np.abs(a - b).max() / np.abs(b).max())))
    weight_sum = float(np.abs(res.weight_sum - cpu_res.weight_sum).max())
    equivariance = max(abs(g["rel_error"] - r["rel_error"]) for g, r in zip(
        report["scale_equivariance"], cpu_report["scale_equivariance"]))
    if (max(gaps.values()) > ANALYSIS_MEAN_GRAY
            or min(r["cosine"] for r in rows) < ANALYSIS_ROW_MIN_COSINE
            or max(r["rel"] for r in rows) > ANALYSIS_ROW_REL
            or weight_sum > ANALYSIS_WEIGHT_SUM_ATOL
            or equivariance > ANALYSIS_EQUIVARIANCE_ATOL):
        problems.append(f"card vs CPU: {gaps}, rows {rows}, weight_sum "
                        f"{weight_sum}, equivariance {equivariance}")

    # the CLI on the bf16 flagship (its pipeline's dtype), as a user runs it
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "blind_image_denoising_torch.analyze",
         "--model", FLAGSHIP], capture_output=True, text=True, timeout=600,
        cwd=str(Path(__file__).resolve().parent))
    cli_s = time.perf_counter() - t0
    cli_report = None
    if cli.returncode == 0:
        cli_report = json.loads(cli.stdout)
        numbers = ([v for v in cli_report["net_bias"].values()]
                   + [r["rel_error"] for r in
                      cli_report["scale_equivariance"]]
                   + [f[k] for f in cli_report["filters"]
                      for k in ("output", "bias", "weight_sum")])
        if set(cli_report) != {"net_bias", "scale_equivariance", "filters",
                               "model", "noise_std"} or \
                len(cli_report["filters"]) != 4 or \
                not all(np.isfinite(numbers)):
            problems.append(f"CLI report {cli_report}")
    else:
        problems.append(f"CLI exited {cli.returncode}: {cli.stderr[-2000:]}")
    torch.cuda.empty_cache()
    c_end = read_counts()
    launches = {k: c_end[k] - c_start[k] for k in c_end}
    result = dict(
        model=FLAGSHIP, dtype="float32", image=list(image.shape),
        sigma=ANALYSIS_SIGMA, pixels=pixels, alphas=list(alphas),
        tool_launches=got,
        card_tool_s={c["tool"]: round(c["seconds"], 4) for c in calls},
        cpu_tool_s={c["tool"]: round(c["seconds"], 4) for c in cpu_calls},
        card_analyze_s=card_s, cpu_analyze_s=cpu_s, card_vs_cpu=gaps,
        filter_rows=rows, weight_sum_max_diff=weight_sum,
        equivariance_max_diff=equivariance, report=report,
        cli_s=cli_s, cli_net_bias=(cli_report or {}).get("net_bias"),
        launches=launches, smi=smi,
        tolerance=f"card vs CPU: denoised and bias map mean <= "
                  f"{ANALYSIS_MEAN_GRAY}, each filter row cosine >= "
                  f"{ANALYSIS_ROW_MIN_COSINE} and max |d| / max |a| <= "
                  f"{ANALYSIS_ROW_REL}, weight_sum within "
                  f"{ANALYSIS_WEIGHT_SUM_ATOL}, rel_error within "
                  f"{ANALYSIS_EQUIVARIANCE_ATOL}; exact launches {want}; "
                  f"the CLI exits 0 with JAX's report keys, finite")
    log("analysis", **result)
    if problems:
        raise AssertionError(f"analysis: {problems}")
    return kernel_inputs.seen, launches


# ----------------------------------------------------------- layers breadth

# the layers_breadth phase: the resnet config at its full width with the
# selector (its defaults, and GLOBAL / SOFT), one f32 train-mode step card
# against CPU on one micro-batch cut to b8 @ 128² (the resnet's bars), then
# served f32 at b8 @ 256² (the first 2 images against the CPU); the other
# new layers' forwards card against CPU
BREADTH_SELECTORS = ({}, {"scale_type": "GLOBAL", "activation_type": "SOFT"})
BREADTH_STEP_BATCH, BREADTH_MIN_COSINE, BREADTH_LAYER_ATOL = 8, 0.9999, 1e-5


def layers_breadth_phase(bidt, smi, read_counts):
    """See ``BREADTH_SELECTORS``. Returns the launch counts (none)."""
    from blind_image_denoising_torch.inference.denoiser import Denoiser
    from blind_image_denoising_torch.layers import (GatedMLP,
                                                    NonLocalAttention,
                                                    SqueezeExcite,
                                                    ValueCompressor)
    from blind_image_denoising_torch.models.hydra import model_builder
    from blind_image_denoising_torch.ops.multiscale import multiscale_targets
    from blind_image_denoising_torch.ops.precision import exact_float32
    from blind_image_denoising_torch.training import (forward_loss,
                                                      loss_function_builder)
    from blind_image_denoising_torch.training.train_state import init_params
    problems = []
    c_start = read_counts()
    base = bidt.CONFIGS_DICT[RESNET_CONFIG]
    rng = np.random.default_rng(SEED + 50)
    clean = np.round(synthetic_images(BREADTH_STEP_BATCH,
                                      *base["dataset"]["input_shape"][:2],
                                      rng))
    noisy = torch.from_numpy(add_noise(clean, 20.0, rng).astype(np.float32))
    clean = torch.from_numpy(clean)
    serve = add_noise(synthetic_images(EXPORT_BATCH, EXPORT_SIZE,
                                       EXPORT_SIZE, rng), 25.0, rng)
    selectors = []
    for selector in BREADTH_SELECTORS:
        mc = copy.deepcopy(base["model"])
        mc["backbone"]["selector_params"] = selector
        seeded = model_builder(copy.deepcopy(mc)).hydra
        init_params(seeded, torch.Generator().manual_seed(SEED))
        weights = {k: v.clone() for k, v in seeded.state_dict().items()}
        fns = loss_function_builder(base["loss"])
        gt = multiscale_targets(clean, 0, clip_values=True,
                                round_values=True)
        out = {}
        for device in ("cpu", "cuda"):
            hydra = model_builder(copy.deepcopy(mc)).hydra
            hydra.load_state_dict(weights)
            hydra.to(device)
            t0 = time.perf_counter()
            with exact_float32(device == "cuda"):
                total, _ = forward_loss(hydra, fns, 1, noisy.to(device),
                                        [g.to(device) for g in gt],
                                        torch.ones((1,), device=device),
                                        torch.Generator(device=device))
                total.backward()
            out[device] = (float(total.detach()), torch.cat([
                (torch.zeros_like(p) if p.grad is None else p.grad)
                .double().flatten().cpu() for p in hydra.parameters()]),
                {k: v.cpu() for k, v in hydra.named_buffers()},
                time.perf_counter() - t0)
            del hydra
        loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
        cosine = float(F.cosine_similarity(out["cuda"][1], out["cpu"][1],
                                           dim=0))
        stats_rel = max(float((out["cuda"][2][k] - v).abs().max()
                              / v.abs().max().clamp_min(1e-30))
                        for k, v in out["cpu"][2].items())
        selector_params = sum(v.numel() for k, v in weights.items()
                              if "selector" in k)
        if loss_rel > RESNET_LOSS_RTOL or cosine < BREADTH_MIN_COSINE or \
                stats_rel > RESNET_STATS_RTOL or not selector_params:
            problems.append(f"selector {selector} step: loss {loss_rel}, "
                            f"cosine {cosine}, statistics {stats_rel}")
        # served f32: the card's b8 against the CPU on its first 2 images
        served = {}
        for device in ("cuda", "cpu"):
            model = model_builder(copy.deepcopy(mc)).hydra
            model.load_state_dict(weights)
            den = Denoiser(model, device=device)
            served[device] = den(serve if device == "cuda" else serve[:2])
            if device == "cuda":
                times = timed_requests(den, serve, EXPORT_REQUESTS)
            del den, model
        gap = gray_gap(served["cuda"][:2], served["cpu"])
        if gap["mean"] > FAMILY_F32_MEAN or \
                gap["equal_share"] < FAMILY_F32_EQUAL:
            problems.append(f"selector {selector} served: {gap}")
        selectors.append(dict(
            selector_params=selector, selector_weights=selector_params,
            step_batch=list(noisy.shape), step_loss_card=out["cuda"][0],
            step_loss_cpu=out["cpu"][0], step_loss_rel=loss_rel,
            step_grad_cosine=cosine, step_statistics_worst_rel=stats_rel,
            cpu_step_s=out["cpu"][3], serve_f32_vs_cpu=gap,
            serve_b8_256_median_s=statistics.median(times),
            serve_b8_256_images_per_s=EXPORT_BATCH
            / statistics.median(times)))

    # the other new layers, forward card against CPU
    x = torch.from_numpy(rng.normal(0, 1, (2, 32, 16, 16)).astype(
        np.float32)).contiguous(memory_format=torch.channels_last)
    layers = dict(
        squeeze_excite=SqueezeExcite(32, hard_sigmoid_version=True,
                                     learn_to_turn_off=True,
                                     use_scale_gamma=True),
        gated_mlp=GatedMLP(32, 64, use_bias=True),
        value_compressor=ValueCompressor(),
        non_local_attention=NonLocalAttention(32, 16, use_logit_norm=True))
    layer_err = {}
    gen = torch.Generator().manual_seed(SEED + 51)
    for name, layer in layers.items():
        with torch.no_grad():
            for p in layer.parameters():
                p.copy_(0.2 * torch.randn(p.shape, generator=gen))
            ref = layer(x)
            layer.cuda()
            with exact_float32():
                got = layer(x.cuda()).cpu()
        layer_err[name] = float((got - ref).abs().max())
        if layer_err[name] > BREADTH_LAYER_ATOL:
            problems.append(f"{name} card vs CPU {layer_err[name]}")
    torch.cuda.empty_cache()
    c_end = read_counts()
    launches = {k: c_end[k] - c_start[k] for k in c_end}
    result = dict(
        config=RESNET_CONFIG, selectors=selectors, layers_max_abs=layer_err,
        layer_input=list(x.shape), launches=launches, smi=smi,
        tolerance=f"f32 step card vs CPU loss rtol {RESNET_LOSS_RTOL}, "
                  f"running statistics {RESNET_STATS_RTOL}, grad cosine >= "
                  f"{BREADTH_MIN_COSINE}; served f32 vs CPU mean <= "
                  f"{FAMILY_F32_MEAN}, >= {FAMILY_F32_EQUAL} equal; layers "
                  f"{BREADTH_LAYER_ATOL}; no K1-K4 launch")
    log("layers_breadth", **result)
    if problems:
        raise AssertionError(f"layers_breadth: {problems}")
    return launches


# the parallel phase: data-parallel training and spatially sharded serving
# as separate processes on the one card. Two ranks share it through gloo
# (NCCL refuses two ranks on one device); one NCCL rank alone shows the
# NCCL path makes no host sync in a step. The DP step is train_check's
# batch (b16 @ 128², full width, the packaged weights, the noise kernel,
# drop-path on); the loop is the train_loop phase's config at its shipped
# size on its scenes (dataset.repeat, as several processes need), 8 steps
# from the artifact and a resume to 12 (the profile at step 2, the step
# after it and the sweeps at 6 and 12 leave 3 steady gaps a leg); spatial
# serving is the 4K frame; the spatially sharded step and loop split each
# crop's rows over the two ranks
PARALLEL_TIMEOUT = 600
PARALLEL_LOOP_STEPS, PARALLEL_RESUME_STEPS, PARALLEL_PROFILE_STEP = 8, 12, 2
PARALLEL_OVERRIDES = dict(LOOP_OVERRIDES, **{
    "train.checkpoint_every": PARALLEL_LOOP_STEPS,
    "train.visualization_every": 6,
    "train.profile_at_step": PARALLEL_PROFILE_STEP, "dataset.repeat": True})
PARALLEL_NCCL_STEPS = 6
# the DP step against the single-process step on the global batch: loss
# relative, every param of its tensor's largest entry
DP_LOSS_RTOL, DP_PARAM_TOL = 1e-6, 1e-5
SPATIAL_HW = (2160, 3840)
SPATIAL_F32_MAX = 1e-3          # gray levels before rounding, f32
SPATIAL_REQUESTS = 3
# the spatially sharded step: the flagship config (the train phase's noise
# and K3, drop-path on) on a global b4 @ 512², each crop's rows over 2
# ranks, against the single-process step at the DP bars; a timed second
# step after the compared one
SPATIAL_STEP_BATCH, SPATIAL_STEP_SIZE = 4, 512
# the sharded step against the single-process step in f32: the loss at the
# DP bar, and the gradients the optimizer gets within SPATIAL_GRAD_TOL of
# each tensor's largest entry. Each spatial rank backpropagates its own
# loss share, so the gradient is the sum of n backward passes: the
# single step's in float64 (to 4e-13 on the CPU), apart from it by float32
# rounding. Adam's first step divides each entry by its own magnitude, so
# an entry at that rounding moves its param by up to the learning rate:
# the params are read, beside the single step's own spread between
# cuDNN's default and deterministic algorithms (its params 3.5e-5 apart,
# its gradients 9.4e-6, on the card); the gradient bar is ten times that
SPATIAL_GRAD_TOL = 1e-4
# the spatially sharded loop: the DP loop's config with spatial_training,
# 5 steps from the artifact and a resume to 7, one sweep at the end (the
# first leg leaves 3 steady gaps)
SPATIAL_LOOP_STEPS, SPATIAL_RESUME_STEPS, SPATIAL_LOOP_SWEEP = 5, 7, 7


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(role, n, work, timeout=PARALLEL_TIMEOUT, **spec):
    """``n`` processes of this script as ranks of ``role``
    (``--parallel-worker``), each writing ``<role>_<rank>.json`` into
    ``work``; a rank that fails or outlives ``timeout`` fails the phase,
    and every rank still running is killed."""
    port = free_port()
    here = Path(__file__).resolve()
    procs = []
    for rank in range(n):
        arg = json.dumps(dict(spec, role=role, rank=rank, world=n, port=port,
                              work=str(work)))
        log_file = open(work / f"{role}_{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(here), "--parallel-worker", arg],
            stdout=log_file, stderr=subprocess.STDOUT, cwd=str(here.parent)),
            log_file))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p, _ in procs):
            if time.monotonic() > deadline or any(
                    p.poll() not in (None, 0) for p, _ in procs):
                break
            time.sleep(0.5)
    finally:
        for p, f in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            f.close()
    failed = [(rank, p.returncode) for rank, (p, _) in enumerate(procs)
              if p.returncode != 0]
    if failed:
        tails = {rank: (work / f"{role}_{rank}.log").read_text()[-3000:]
                 for rank, _ in failed}
        raise AssertionError(f"parallel {role}: ranks {failed} failed: "
                             f"{tails}")
    return [json.loads((work / f"{role}_{rank}.json").read_text())
            for rank in range(n)]


def worker_counts(read_counts, before):
    after = read_counts()
    return {k: after[k] - before[k] for k in after}


def dp_step_rank(bidt, cfg, params, clean, mesh, dtype, read_counts, work,
                 tag, rank):
    """The flagship's step as this rank of the DP mesh, and on rank 0 the
    single-process step on the whole batch after it: params, loss and the
    noise kernel's output of each into ``work``. Returns this rank's
    launches in its DP step."""
    import importlib
    from blind_image_denoising_torch.parallel import (shard_batch,
                                                      shard_train_step)
    step_mod = importlib.import_module(
        "blind_image_denoising_torch.training.train_step")
    out = {}
    for sharded in ((True, False) if rank == 0 else (True,)):
        state, step = build_trainer(cfg, params, dtype, "cuda", drop=True)
        if sharded:
            step = shard_train_step(step, mesh)
            batch = shard_batch(mesh, clean, device="cuda")
        else:
            batch = torch.from_numpy(clean).cuda()
        kept, real = [], step_mod.corrupt_noise

        def keep(*a, **k):
            y = real(*a, **k)
            kept.append(y.detach().clone())
            return y
        step_mod.corrupt_noise = keep
        try:
            before = read_counts()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            launches = worker_counts(read_counts, before)
        finally:
            step_mod.corrupt_noise = real
        name = "dp" if sharded else "single"
        torch.save(dict(params={k: v.detach().cpu() for k, v in
                                state.model.state_dict().items()},
                        loss=float(metrics["total_loss"]),
                        k3=[t.cpu() for t in kept]),
                   work / f"{tag}_{name}_{rank}.pt")
        out[name] = launches
        del state, step
    torch.cuda.empty_cache()
    return out["dp"]


def spatial_step_rank(cfg, params, clean, mesh, dtype, read_counts, work,
                      tag, rank):
    """The flagship's step as this rank of the data 1 × spatial n mesh on
    the whole batch (each rank runs its slab of every crop), and on rank
    0 the single-process step after it, then the single step again with
    cuDNN's deterministic algorithms (``single_det``: the single step's
    own spread between convolution algorithms). Each kind runs twice, the
    first compared (params, the gradients before the optimizer, loss and
    K3's output into ``work``), the second timed, with the peak memory
    of the pair. Returns this rank's rows: launches in its first sharded
    step, ms and peak GiB of each kind it ran."""
    import importlib
    from blind_image_denoising_torch.parallel import shard_train_step
    step_mod = importlib.import_module(
        "blind_image_denoising_torch.training.train_step")
    out = {}
    kinds = ("sharded", "single", "single_det") if rank == 0 else (
        "sharded",)
    for name in kinds:
        state, step = build_trainer(cfg, params, dtype, "cuda", drop=True)
        if name == "sharded":
            step = shard_train_step(step, mesh, spatial=True)
        batch = torch.from_numpy(clean).cuda()
        kept, grads = [], []
        real, real_norm = step_mod.corrupt_noise, step_mod.global_norm

        def keep(*a, **k):
            y = real(*a, **k)
            kept.append(y.detach().clone())
            return y

        def norm(gs):
            # the reduced gradients, as the optimizer gets them
            grads.append([g.detach().float().cpu() for g in gs])
            return real_norm(gs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_mod.corrupt_noise, step_mod.global_norm = keep, norm
        torch.backends.cudnn.deterministic = name == "single_det"
        try:
            before = read_counts()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            launches = worker_counts(read_counts, before)
        finally:
            step_mod.corrupt_noise, step_mod.global_norm = real, real_norm
        names = [n for n, _ in state.model.named_parameters()]
        torch.save(dict(params={k: v.detach().cpu() for k, v in
                                state.model.state_dict().items()},
                        grads=dict(zip(names, grads[0])),
                        loss=float(metrics["total_loss"]),
                        k3=[t.cpu() for t in kept]),
                   work / f"spatial_{tag}_{name}_{rank}.pt")
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = False
        out[name] = dict(launches=launches,
                         ms=1e3 * (time.perf_counter() - t0),
                         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del state, step, metrics, kept, grads
        torch.cuda.empty_cache()
    return out


def spatial_rank(bidt, mesh, read_counts, rank, smi):
    """Spatial serving of the 4K frame on this rank: the attention-free
    flagship config at full width from a seeded init, f32 and bf16,
    through ``Denoiser(mesh=…, spatial_margin=…)``; rank 0 also runs the
    unsharded forward and holds the two; then the packaged flagship
    sharded and unsharded. Returns (result, launches per sharded
    forward)."""
    from blind_image_denoising_torch.inference.denoiser import Denoiser
    from blind_image_denoising_torch.models.hydra import model_builder
    from blind_image_denoising_torch.parallel.spatial import (
        receptive_field_margin)
    from blind_image_denoising_torch.training.train_state import init_params
    mc = copy.deepcopy(bidt.CONFIGS_DICT[TRAIN_CONFIG]["model"])
    mc["backbone"]["use_self_attention"] = False
    bb = mc["backbone"]
    margin = receptive_field_margin(int(bb["depth"]),
                                    max(bb["encoder_kernel_size"]),
                                    max(bb["width"]))
    rng = np.random.default_rng(SEED + 61)
    frame = add_noise(synthetic_images(1, *SPATIAL_HW, rng), 20.0, rng)[0]
    result = dict(margin=margin, frame=list(frame.shape))
    launches = {}
    # dtype None: float32, its forward with TF32 off (Hydra.forward)
    for dtype, name in ((None, "f32"), (torch.bfloat16, "bf16")):
        model = model_builder(copy.deepcopy(mc), dtype=dtype).hydra
        init_params(model, torch.Generator().manual_seed(SEED + 62))
        den = Denoiser(model, mesh=mesh, spatial_margin=margin,
                       pad_multiple=64, device="cuda")
        den.float_forward(frame[:256])          # warm the card's kernels
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = read_counts()
        t0 = time.perf_counter()
        y = den.float_forward(frame)
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t0
        launches[name] = worker_counts(read_counts, before)
        padded = -(-SPATIAL_HW[0] // 64) * 64
        row = dict(sharded_s=sharded_s, launches=launches[name],
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   slab_rows=padded // mesh.shape["spatial"] + 2 * margin)
        if rank == 0:
            ref_den = Denoiser(model, pad_multiple=64, device="cuda")
            before = read_counts()
            t0 = time.perf_counter()
            ref = ref_den.float_forward(frame)
            torch.cuda.synchronize()
            row["unsharded_s"] = time.perf_counter() - t0
            row["unsharded_launches"] = worker_counts(read_counts, before)
            row["max_abs"] = float((y - ref).abs().max())
            row["gap"] = gray_gap(
                torch.clamp(torch.round(y), 0, 255).cpu().numpy(),
                torch.clamp(torch.round(ref), 0, 255).cpu().numpy())
            del ref, ref_den
        result[name] = row
        del y, den, model
        torch.cuda.empty_cache()
    # the packaged flagship (level-2 attention over the whole map: not
    # exact under sharding, as with tiling)
    den = bidt.load_model(FLAGSHIP)
    sharded = Denoiser(den.model, mesh=mesh, spatial_margin=margin,
                       pad_mode=den._pad_mode, pad_multiple=den._pad_multiple,
                       blend=den.blend, device="cuda")
    before = read_counts()
    times = timed_requests(sharded, frame, SPATIAL_REQUESTS)
    launches["packaged"] = worker_counts(read_counts, before)
    got = sharded(frame)
    row = dict(sharded_median_s=statistics.median(times))
    if rank == 0:
        row["unsharded_median_s"] = statistics.median(
            timed_requests(den, frame, SPATIAL_REQUESTS))
        row["gap"] = gray_gap(got, den(frame))
    result["packaged"] = row
    del den, sharded
    torch.cuda.empty_cache()
    return result, launches


def cohort_worker(spec, bidt, read_counts, smi):
    """Rank ``spec["rank"]`` of the two gloo ranks on the card: the DP
    step in f32 and bf16, the spatially sharded step in f32 and bf16,
    then spatial serving."""
    from blind_image_denoising_torch.ops import (pallas_convnext,
                                                 pallas_noise, pallas_pyramid)
    from blind_image_denoising_torch.parallel import create_mesh, multihost
    from blind_image_denoising_torch.weights import (load_msgpack,
                                                     params_from_flax)
    rank, work = spec["rank"], Path(spec["work"])
    multihost.initialize(f"localhost:{spec['port']}", spec["world"], rank,
                         backend=spec["backend"])
    cfg = copy.deepcopy(bidt.CONFIGS_DICT[TRAIN_CONFIG])
    cfg.setdefault("tpu", {})["pallas_noise"] = True    # as the train phase
    params = params_from_flax(load_msgpack(
        f"{bidt.models[FLAGSHIP]['directory']}/params.msgpack"))
    clean = np.round(synthetic_images(TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE,
                                      np.random.default_rng(SEED + 60)))
    big = np.round(synthetic_images(
        SPATIAL_STEP_BATCH, SPATIAL_STEP_SIZE, SPATIAL_STEP_SIZE,
        np.random.default_rng(SEED + 65)))
    result = dict(backend=multihost.backend(),
                  device=str(multihost.device()))
    with KernelInputs() as kernel_inputs:
        dp_mesh = create_mesh(data=spec["world"])
        result["dp_launches"] = {
            tag: dp_step_rank(bidt, cfg, params, clean, dp_mesh, dtype,
                              read_counts, work, tag, rank)
            for tag, dtype in (("f32", None), ("bf16", torch.bfloat16))}
        spatial_mesh = create_mesh(data=1, spatial=spec["world"])
        result["spatial_step"] = {
            tag: spatial_step_rank(cfg, params, big, spatial_mesh, dtype,
                                   read_counts, work, tag, rank)
            for tag, dtype in (("f32", None), ("bf16", torch.bfloat16))}
        result["spatial"], result["spatial_launches"] = spatial_rank(
            bidt, spatial_mesh, read_counts, rank, smi)
    multihost.sync("cohort")
    if rank == 0:
        result["errors"] = check_kernel_inputs(
            pallas_convnext, pallas_pyramid, pallas_noise, kernel_inputs.seen,
            SEED + 63, path="parallel")
        result["checked"] = checked_shapes(kernel_inputs.seen)
    multihost.shutdown()
    return result


def loop_worker(spec, bidt, read_counts, smi):
    """Rank ``spec["rank"]`` of the train CLI (``spec["legs"]``: one argv a
    leg and rank) under ``LoopProbe``: per step launches and syncs (sync
    debug "warn", or "error" inside each step with ``spec["strict"]``),
    the checkpoints this rank wrote, its metrics writer, each leg's final
    state and the state it restored."""
    import importlib
    import warnings
    from blind_image_denoising_torch import train as train_cli
    from blind_image_denoising_torch.ops import (pallas_convnext,
                                                 pallas_noise, pallas_pyramid)
    from blind_image_denoising_torch.parallel import multihost
    from blind_image_denoising_torch.training.checkpoint import (
        CheckpointManager)
    loop = importlib.import_module(
        "blind_image_denoising_torch.training.train_loop")
    rank, work = spec["rank"], Path(spec["work"])
    wrote, writers, finals, backends = [], [], [], []
    real = dict(save=CheckpointManager._save, writer=loop.MetricsWriter,
                loop=train_cli.train_loop)

    def save(manager, state, force, replace):
        done = real["save"](manager, state, force, replace)
        wrote.append([state.step, done])
        return done

    def writer(directory, enabled=True):
        writers.append(enabled)
        return real["writer"](directory, enabled=enabled)

    def run_loop(*a, **k):
        backends.append(multihost.backend())
        state = real["loop"](*a, **k)
        finals.append({n: v.detach().cpu()
                       for n, v in state.model.state_dict().items()})
        return state
    CheckpointManager._save, loop.MetricsWriter = save, writer
    train_cli.train_loop = run_loop
    legs = []
    try:
        with KernelInputs() as kernel_inputs, \
                LoopProbe(read_counts) as probe, \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            probe.warnings = caught
            if spec.get("strict"):
                probed = loop.build_train_step

                def strict_build(*a, **k):
                    inner = probed(*a, **k)

                    def step(*sa, **sk):
                        torch.cuda.set_sync_debug_mode("error")
                        try:
                            return inner(*sa, **sk)
                        finally:
                            torch.cuda.set_sync_debug_mode(0)
                    return step
                loop.build_train_step = strict_build
            else:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                for argv in spec["legs"]:
                    n0, t0 = len(probe.steps), time.perf_counter()
                    if train_cli.main(argv[rank]) != 0:
                        raise AssertionError(f"train CLI failed: {argv}")
                    legs.append(dict(seconds=time.perf_counter() - t0,
                                     steps=len(probe.steps) - n0))
            finally:
                torch.cuda.set_sync_debug_mode(0)
                if spec.get("strict"):
                    loop.build_train_step = probed
    finally:
        CheckpointManager._save, loop.MetricsWriter = (real["save"],
                                                       real["writer"])
        train_cli.train_loop = real["loop"]
    ckpt_dir = Path(spec["ckpt_dir"])
    restored = None
    if len(spec["legs"]) > 1:
        ckpt = CheckpointManager(str(ckpt_dir)).read(spec["restore_step"])
        restored = snapshot_equals_checkpoint(probe.restored, ckpt)
    torch.save(finals, work / f"{spec['role']}_final_{rank}.pt")
    # start to start of two steps of one leg (a probed step holds the
    # 0-based state.step): not the process's first, not a stats step, not
    # one a sweep follows (the sweep after the loop's 1-based step s falls
    # after 0-based step s - 1), neither the profiled step (1-based
    # profile_at_step) nor the one after it, which its teardown slows
    bounds = set(np.cumsum([leg["steps"] for leg in legs]).tolist())
    profiled = spec.get("profile_step")
    near_profile = set() if profiled is None else {profiled - 1, profiled}
    swept = {s["step"] for s in probe.sweeps}
    steady = [b["start"] - a["start"] for i, (a, b) in enumerate(
        zip(probe.steps, probe.steps[1:]))
        if i and i + 1 not in bounds and not a["stats"]
        and a["step"] + 1 not in swept and a["step"] not in near_profile]
    result = dict(
        backends=backends, legs=legs, checkpoint_writes=wrote,
        metrics_writer_enabled=writers, restore_differs=restored,
        steps=[dict(step=s["step"], launches=s["launches"],
                    syncs=s["syncs"], host_s=round(s["host_s"], 4))
               for s in probe.steps],
        sweeps=[dict(step=s["step"], launches=s["launches"])
                for s in probe.sweeps],
        steady_step_s=steady)
    if rank == 0:
        summary = ckpt_dir / "profile" / "summary.json"
        result["profile"] = (json.loads(summary.read_text())
                             if summary.is_file() else None)
        result["errors"] = check_kernel_inputs(
            pallas_convnext, pallas_pyramid, pallas_noise, kernel_inputs.seen,
            SEED + 64, path=f"parallel_{spec['role']}")
        result["checked"] = checked_shapes(kernel_inputs.seen)
    return result


def checked_shapes(seen):
    """The recorded kernel inputs' shapes (and K, or the noise ranges)."""
    return {k: sorted(f"{list(key[0])} {key[2]}" for key in v)
            for k, v in seen.items()}


def parallel_worker(arg) -> int:
    """A rank of the parallel phase (``--parallel-worker SPEC``)."""
    spec = json.loads(arg)
    faulthandler.enable()
    import blind_image_denoising_torch as bidt
    from blind_image_denoising_torch.ops import (pallas_convnext,
                                                 pallas_noise, pallas_pyramid)

    def read_counts():
        return dict(convnext_block=pallas_convnext.launches,
                    convnext_block_int8=pallas_convnext.int8_launches,
                    band_smooth=pallas_pyramid.launches,
                    band_smooth_bwd=pallas_pyramid.bwd_launches,
                    corrupt_noise=pallas_noise.launches,
                    band_split=pallas_pyramid.split_launches)
    smi = spec["smi"]
    worker = cohort_worker if spec["role"] == "cohort" else loop_worker
    result = worker(spec, bidt, read_counts, smi)
    result["total_launches"] = read_counts()
    Path(spec["work"], f"{spec['role']}_{spec['rank']}.json").write_text(
        json.dumps(result))
    return 0


def parallel_phase(bidt, smi, loop_run):
    """The ``parallel`` phase (module docstring). Returns (launches on the
    paths the ranks drove, summed over ranks; the worst kernel errors of
    the ranks' checks; the seconds)."""
    import tempfile
    work = Path(tempfile.mkdtemp(prefix="bid-parallel-"))
    torch.cuda.empty_cache()            # the ranks need the card's memory
    problems = []
    t0 = time.perf_counter()
    cohort = spawn_ranks("cohort", 2, work, backend="gloo", smi=smi)
    cohort_s = time.perf_counter() - t0

    # the DP step: each rank against the single-process step, bit-equal
    # ranks, each rank's K3 rows those of the single step
    dp = {}
    for tag in ("f32", "bf16"):
        single = torch.load(work / f"{tag}_single_0.pt")
        ranks = [torch.load(work / f"{tag}_dp_{r}.pt") for r in range(2)]
        rel = {name: float((ranks[0]["params"][name] - v).abs().max()
                           / v.abs().max().clamp_min(1e-30))
               for name, v in single["params"].items()}
        worst = max(rel, key=rel.get)
        loss_rel = abs(ranks[0]["loss"] - single["loss"]) / abs(
            single["loss"])
        equal_ranks = all(torch.equal(v, ranks[1]["params"][n])
                          for n, v in ranks[0]["params"].items())
        b = TRAIN_BATCH // 2
        k3_rows = [torch.equal(r["k3"][0], single["k3"][0][i * b:(i + 1) * b])
                   for i, r in enumerate(ranks)]
        dp[tag] = dict(loss_dp=ranks[0]["loss"], loss_single=single["loss"],
                       loss_rel=loss_rel, param_worst_rel=rel[worst],
                       param_worst=worst, ranks_bit_equal=equal_ranks,
                       k3_rows_bit_equal=k3_rows)
        if tag == "f32" and (loss_rel > DP_LOSS_RTOL
                             or rel[worst] > DP_PARAM_TOL):
            problems.append(f"DP step f32: {dp[tag]}")
        if not equal_ranks or not all(k3_rows):
            problems.append(f"DP step {tag}: {dp[tag]}")
    per_step = counts_of(band_smooth=2, band_smooth_bwd=2, corrupt_noise=1)
    for r in cohort:
        for tag, got in r["dp_launches"].items():
            if got != per_step:
                problems.append(f"DP step {tag} launches {got}")
    sp = cohort[0]["spatial"]
    for name in ("f32", "bf16"):
        for r in cohort:
            if r["spatial_launches"][name] != sp[name]["unsharded_launches"]:
                problems.append(f"spatial {name} launches "
                                f"{r['spatial_launches'][name]} per slab, "
                                f"{sp[name]['unsharded_launches']} unsharded")
    if sp["f32"]["max_abs"] > SPATIAL_F32_MAX:
        problems.append(f"spatial f32 {sp['f32']['max_abs']}")
    if sp["bf16"]["gap"]["mean"] > EXPORT_BF16_MEAN or \
            sp["bf16"]["gap"]["p99"] > EXPORT_BF16_P99:
        problems.append(f"spatial bf16 {sp['bf16']['gap']}")

    # the spatially sharded step: each rank against the single-process
    # step (f32 at the DP bars, bf16 read), bit-equal ranks, every rank's
    # K3 output the single step's (each prepares the whole batch)
    spatial_step = {}
    for tag in ("f32", "bf16"):
        single = torch.load(work / f"spatial_{tag}_single_0.pt")
        ranks = [torch.load(work / f"spatial_{tag}_sharded_{r}.pt")
                 for r in range(2)]
        det = torch.load(work / f"spatial_{tag}_single_det_0.pt")

        def rel(a, b):
            """Per tensor, max |a − b| over b's largest entry."""
            return {n: float((a[n] - v).abs().max()
                             / v.abs().max().clamp_min(1e-30))
                    for n, v in b.items()}

        def top(d):
            return sorted(((v, n) for n, v in d.items()), reverse=True)[:3]
        grads = rel(ranks[0]["grads"], single["grads"])
        params_rel = rel(ranks[0]["params"], single["params"])
        loss_rel = abs(ranks[0]["loss"] - single["loss"]) / abs(
            single["loss"])
        equal_ranks = all(torch.equal(v, ranks[1]["params"][n])
                          for n, v in ranks[0]["params"].items())
        k3_equal = [torch.equal(r["k3"][0], single["k3"][0]) for r in ranks]
        tallies = [r["spatial_step"][tag] for r in cohort]
        spatial_step[tag] = dict(
            loss_sharded=ranks[0]["loss"], loss_single=single["loss"],
            loss_rel=loss_rel, grad_worst_rel=top(grads),
            param_worst_rel=top(params_rel),
            single_det_grad_worst_rel=top(rel(det["grads"],
                                              single["grads"])),
            single_det_param_worst_rel=top(rel(det["params"],
                                               single["params"])),
            ranks_bit_equal=equal_ranks, k3_bit_equal=k3_equal,
            sharded_ms=[r["sharded"]["ms"] for r in tallies],
            sharded_peak_gib=[r["sharded"]["peak_gib"] for r in tallies],
            single_ms=tallies[0]["single"]["ms"],
            single_peak_gib=tallies[0]["single"]["peak_gib"],
            launches_per_rank=[r["sharded"]["launches"] for r in tallies])
        if tag == "f32" and (loss_rel > DP_LOSS_RTOL or max(
                grads.values()) > SPATIAL_GRAD_TOL):
            problems.append(f"spatial step f32: {spatial_step[tag]}")
        if not equal_ranks or not all(k3_equal):
            problems.append(f"spatial step {tag}: {spatial_step[tag]}")
        for r in tallies:
            if r["sharded"]["launches"] != per_step:
                problems.append(f"spatial step {tag} launches "
                                f"{r['sharded']['launches']}")

    # the data-parallel loop through the train CLI: 2 gloo ranks, then one
    # NCCL rank alone, then the spatially sharded loop on 2 gloo ranks
    base = bidt.CONFIGS_DICT[TRAIN_CONFIG]
    image_dir = loop_run["image_dir"]
    artifact = bidt.models[FLAGSHIP]["directory"]
    runs = {}
    for role, n, backend, steps in (
            ("loop", 2, "gloo", (PARALLEL_LOOP_STEPS, PARALLEL_RESUME_STEPS)),
            ("nccl", 1, "nccl", (PARALLEL_NCCL_STEPS,)),
            ("sloop", 2, "gloo", (SPATIAL_LOOP_STEPS,
                                  SPATIAL_RESUME_STEPS))):
        ckpt_dir = work / f"{role}_checkpoints"
        legs = []
        for i, total in enumerate(steps):
            cfg = loop_config(base, image_dir, total)
            for key, value in PARALLEL_OVERRIDES.items():
                section, name = key.split(".")
                cfg[section][name] = value
            cfg["train"]["total_steps"] = total
            if role == "nccl":          # no profile, no sweep: steps only
                cfg["train"].update(profile_at_step=-1,
                                    visualization_every=-1)
            if role == "sloop":         # no profile, one sweep
                cfg["train"].update(
                    profile_at_step=-1, checkpoint_every=SPATIAL_LOOP_STEPS,
                    visualization_every=SPATIAL_LOOP_SWEEP)
                cfg["tpu"]["mesh"] = {"spatial": 2, "spatial_training": True}
            path = work / f"{role}_{total}.json"
            path.write_text(json.dumps(cfg))
            port = free_port()
            legs.append([["--pipeline-config", str(path),
                          "--checkpoint-directory", str(ckpt_dir),
                          "--backend", backend, "--coordinator-address",
                          f"localhost:{port}", "--num-processes", str(n),
                          "--process-id", str(r)]
                         + (["--weights-directory", artifact] if i == 0
                            else []) for r in range(n)])
        t0 = time.perf_counter()
        runs[role] = spawn_ranks(role, n, work, legs=legs,
                                 ckpt_dir=str(ckpt_dir), smi=smi,
                                 strict=role == "nccl",
                                 restore_step=steps[0],
                                 profile_step=(PARALLEL_PROFILE_STEP
                                               if role == "loop" else None))
        runs[role + "_s"] = time.perf_counter() - t0
        runs[role + "_ckpt"] = ckpt_dir
    loop_ranks, nccl = runs["loop"], runs["nccl"][0]
    per_loop_step = counts_of(band_smooth=16, band_smooth_bwd=16,
                              corrupt_noise=8)
    finals = [torch.load(work / f"loop_final_{r}.pt") for r in range(2)]
    ranks_equal = [all(torch.equal(v, finals[1][leg][n])
                       for n, v in finals[0][leg].items())
                   for leg in range(2)]
    rows = [json.loads(line) for line in (runs["loop_ckpt"]
                                          / "metrics.jsonl").read_text()
            .splitlines()]
    steps_logged = [r["step"] for r in rows if "total_loss" in r]
    for r, res in enumerate(loop_ranks):
        if any(s["launches"] != per_loop_step for s in res["steps"]):
            problems.append(f"loop rank {r} step launches "
                            f"{[s['launches'] for s in res['steps']]}")
        if res["restore_differs"]:
            problems.append(f"loop rank {r} restore {res['restore_differs']}")
        if res["backends"] != ["gloo", "gloo"]:
            problems.append(f"loop rank {r} backends {res['backends']}")
    if not (loop_ranks[0]["checkpoint_writes"]
            and not loop_ranks[1]["checkpoint_writes"]
            and loop_ranks[0]["metrics_writer_enabled"] == [True, True]
            and loop_ranks[1]["metrics_writer_enabled"] == [False, False]):
        problems.append("loop: writes not rank 0's alone")
    if steps_logged != list(range(1, PARALLEL_RESUME_STEPS + 1)):
        problems.append(f"loop metrics steps {steps_logged}")
    if not all(ranks_equal):
        problems.append(f"loop final params equal across ranks "
                        f"{ranks_equal}")
    per_sweep = counts_of(convnext_block=50, band_smooth=10)
    every = PARALLEL_OVERRIDES["train.visualization_every"]
    if [s["launches"] for s in loop_ranks[0]["sweeps"]] != [per_sweep] * (
            PARALLEL_RESUME_STEPS // every) or loop_ranks[1]["sweeps"]:
        problems.append(f"loop sweeps {loop_ranks[0]['sweeps']}, rank 1 "
                        f"{loop_ranks[1]['sweeps']}")
    if any(s["launches"] != per_loop_step for s in nccl["steps"]) or \
            len(nccl["steps"]) != PARALLEL_NCCL_STEPS or \
            nccl["backends"] != ["nccl"]:
        problems.append(f"nccl run {nccl['steps']} {nccl['backends']}")
    # the spatially sharded loop: as the DP loop's checks, its own steps
    sloop = runs["sloop"]
    sfinals = [torch.load(work / f"sloop_final_{r}.pt") for r in range(2)]
    sloop_equal = [all(torch.equal(v, sfinals[1][leg][n])
                       for n, v in sfinals[0][leg].items())
                   for leg in range(2)]
    slogged = [json.loads(line)["step"] for line in (
        runs["sloop_ckpt"] / "metrics.jsonl").read_text().splitlines()
        if "total_loss" in line]
    for r, res in enumerate(sloop):
        if any(s["launches"] != per_loop_step for s in res["steps"]) or \
                len(res["steps"]) != SPATIAL_RESUME_STEPS:
            problems.append(f"sloop rank {r} step launches "
                            f"{[s['launches'] for s in res['steps']]}")
        if res["restore_differs"]:
            problems.append(f"sloop rank {r} restore "
                            f"{res['restore_differs']}")
    if not (sloop[0]["checkpoint_writes"]
            and not sloop[1]["checkpoint_writes"]
            and sloop[1]["metrics_writer_enabled"] == [False, False]):
        problems.append("sloop: writes not rank 0's alone")
    if slogged != list(range(1, SPATIAL_RESUME_STEPS + 1)):
        problems.append(f"sloop metrics steps {slogged}")
    if not all(sloop_equal):
        problems.append(f"sloop final params equal across ranks "
                        f"{sloop_equal}")
    if [s["launches"] for s in sloop[0]["sweeps"]] != [per_sweep] * (
            SPATIAL_RESUME_STEPS // SPATIAL_LOOP_SWEEP) or \
            sloop[1]["sweeps"]:
        problems.append(f"sloop sweeps {sloop[0]['sweeps']}, rank 1 "
                        f"{sloop[1]['sweeps']}")
    profile = loop_ranks[0]["profile"] or {}
    steady = loop_ranks[0]["steady_step_s"]
    ssteady = sloop[0]["steady_step_s"]
    launches = {k: 0 for k in per_step}
    for res in cohort:
        for got in list(res["dp_launches"].values()) + list(
                res["spatial_launches"].values()) + [
                v["sharded"]["launches"]
                for v in res["spatial_step"].values()]:
            for k, v in got.items():
                launches[k] += v
    for res in loop_ranks + [nccl] + sloop:
        for s in res["steps"] + res["sweeps"]:
            for k, v in s["launches"].items():
                launches[k] += v
    errors = {}
    for res in (cohort[0], loop_ranks[0], nccl, sloop[0]):
        for k, v in res["errors"].items():
            errors[k] = max(errors.get(k, 0.0), v)
    result = dict(
        backends=dict(cohort=[r["backend"] for r in cohort],
                      loop=loop_ranks[0]["backends"],
                      nccl=nccl["backends"]),
        devices=[r["device"] for r in cohort],
        dp_step=dict(dp, batch=[TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3],
                     ranks=2, launches_per_rank=cohort[0]["dp_launches"]),
        spatial_step=dict(spatial_step,
                          batch=[SPATIAL_STEP_BATCH, SPATIAL_STEP_SIZE,
                                 SPATIAL_STEP_SIZE, 3], ranks=2),
        spatial=sp, spatial_rank1=cohort[1]["spatial"],
        spatial_launches_per_slab=[r["spatial_launches"] for r in cohort],
        loop=dict(legs=[r["legs"] for r in loop_ranks],
                  steps_logged=steps_logged, final_ranks_bit_equal=ranks_equal,
                  checkpoint_writes=[r["checkpoint_writes"]
                                     for r in loop_ranks],
                  launches_per_step=loop_ranks[0]["steps"][0]["launches"],
                  syncs_in_steps=[[s["syncs"] for s in r["steps"]]
                                  for r in loop_ranks],
                  steady_step_s=steady, steady_gaps=len(steady),
                  steps_per_s=(1.0 / statistics.median(steady)
                               if steady else None),
                  profiled_step=profile),
        nccl=dict(steps=len(nccl["steps"]), legs=nccl["legs"],
                  host_s_per_step=[s["host_s"] for s in nccl["steps"]],
                  steady_step_s=nccl["steady_step_s"],
                  steady_gaps=len(nccl["steady_step_s"]),
                  steps_per_s=(1.0 / statistics.median(nccl["steady_step_s"])
                               if nccl["steady_step_s"] else None),
                  sync_mode="error inside each step"),
        spatial_loop=dict(
            legs=[r["legs"] for r in sloop], steps_logged=slogged,
            final_ranks_bit_equal=sloop_equal,
            checkpoint_writes=[r["checkpoint_writes"] for r in sloop],
            launches_per_step=sloop[0]["steps"][0]["launches"],
            sweeps=sloop[0]["sweeps"],
            restore_differs=[r["restore_differs"] for r in sloop],
            steady_step_s=ssteady, steady_gaps=len(ssteady),
            steps_per_s=(1.0 / statistics.median(ssteady)
                         if ssteady else None)),
        seconds=dict(cohort=cohort_s, loop=runs["loop_s"],
                     nccl=runs["nccl_s"], sloop=runs["sloop_s"]),
        smi=smi,
        tolerance=f"DP f32 loss rel <= {DP_LOSS_RTOL}, params <= "
                  f"{DP_PARAM_TOL} of each tensor's largest entry; ranks "
                  f"and K3 rows bit-equal; launches K2 2, K2 bwd 2, K3 1 a "
                  f"micro-batch, per slab = unsharded forward; spatial f32 "
                  f"<= {SPATIAL_F32_MAX} gray levels, bf16 mean <= "
                  f"{EXPORT_BF16_MEAN}, p99 <= {EXPORT_BF16_P99}; loop: "
                  f"rank 0 alone writes, ranks bit-equal, restore bit-exact; "
                  f"NCCL: no sync inside a step (error mode); spatial "
                  f"step f32 loss rel <= {DP_LOSS_RTOL}, gradients <= "
                  f"{SPATIAL_GRAD_TOL} of each tensor's largest entry, "
                  f"params read, bf16 read, ranks and K3 "
                  f"bit-equal, launches those of one step a rank; spatial "
                  f"loop as the DP loop")
    log("parallel", **result)
    log("parallel_checks", cohort=cohort[0]["checked"],
        loop=loop_ranks[0]["checked"], nccl=nccl["checked"],
        sloop=sloop[0]["checked"])
    if problems:
        raise AssertionError(f"parallel: {problems}")
    return launches, errors


def counts_of(**nonzero):
    keys = ("convnext_block", "convnext_block_int8", "band_smooth",
            "band_smooth_bwd", "corrupt_noise", "band_split")
    return dict(dict.fromkeys(keys, 0), **nonzero)


def main() -> int:
    script_start = time.perf_counter()
    faulthandler.enable()
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile-out", type=Path, default=None,
                        help="write the profiled per-kernel table here")
    parser.add_argument("--keep-export", type=Path, default=None,
                        help="copy the export phase's artifact and batch "
                             "here (for tests/export_int8_gap.py)")
    parser.add_argument("--keep-family", type=Path, default=None,
                        help="copy the unet_laplacian_family phase's v4 "
                             "artifact and batch here (for "
                             "tests/family_bf16_gap.py)")
    parser.add_argument("--keep-distill", type=Path, default=None,
                        help="copy the distillation phase's artifact and "
                             "batch here (for distill_bf16_gap.py)")
    parser.add_argument("--dump-train-check", type=Path, default=None,
                        help="write train_check's batch here (for "
                             "tests/train_check_cosine.py)")
    parser.add_argument("--parallel-worker", default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if args.parallel_worker is not None:
        return parallel_worker(args.parallel_worker)
    import blind_image_denoising_torch as bidt
    from blind_image_denoising_torch.inference import fused as fused_module
    from blind_image_denoising_torch.inference.fused import (
        build_fused_forward, calibrate_fused)
    from blind_image_denoising_torch.models.hydra import model_builder
    from blind_image_denoising_torch.ops import (cuda_build, pallas_convnext,
                                                 pallas_noise, pallas_pyramid)
    from blind_image_denoising_torch.ops.precision import exact_float32
    from blind_image_denoising_torch.training.train_state import init_params
    from blind_image_denoising_torch.weights import (load_msgpack,
                                                     params_from_flax)

    def reset_counts():
        pallas_convnext.launches = pallas_noise.launches = 0
        pallas_convnext.int8_launches = pallas_pyramid.split_launches = 0
        pallas_convnext.shape_launches.clear()
        pallas_pyramid.launches = pallas_pyramid.bwd_launches = 0
        pallas_pyramid.bwd_grad_copies = 0

    def read_counts():
        return dict(convnext_block=pallas_convnext.launches,
                    convnext_block_int8=pallas_convnext.int8_launches,
                    band_smooth=pallas_pyramid.launches,
                    band_smooth_bwd=pallas_pyramid.bwd_launches,
                    corrupt_noise=pallas_noise.launches,
                    band_split=pallas_pyramid.split_launches)

    def counts(**nonzero):
        return dict(dict.fromkeys(read_counts(), 0), **nonzero)

    # ---- phase 1: device. The kernel checks against their plain versions
    # hold TF32 off; every path from phase 4 on runs with PyTorch's default
    # flags, as a user of the library does (its float32 forwards keep TF32
    # out themselves)
    tf32_defaults = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
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
        nvcc_seconds_by_source=cuda_build.source_seconds,
        sources=[s.name for s in cuda_build.sources()],
        convnext_block=k1_instantiations(cuda_build.library(),
                                         pallas_convnext),
        band_smooth_bwd=band_tile_plans(
            "K2 backward", cuda_build.library().bid_band_smooth_bwd_info,
            pallas_pyramid.bwd_tile_plan, BWD_PATH_SHAPES + BWD_RAGGED_SHAPES,
            pallas_pyramid._DTYPE_CODES),
        band_split=band_tile_plans(
            "K4", cuda_build.library().bid_band_split_info,
            pallas_pyramid.split_tile_plan,
            SPLIT_PATH_SHAPES + SPLIT_RAGGED_SHAPES,
            pallas_pyramid._DTYPE_CODES))

    rng = np.random.default_rng(SEED)
    den = bidt.load_model(FLAGSHIP)                     # card, bf16, blend
    model = den.model
    if model.dtype != torch.bfloat16 or den.blend is None:
        raise AssertionError("flagship did not load as bf16 + blend")
    # unet_laplacian_v6 at full width, bf16, from a seeded init (the fused
    # path's model; the JAX bench builds it the same way)
    v6cfg = copy.deepcopy(bidt.CONFIGS_DICT[FUSED_CONFIG]["model"])
    v6 = model_builder(copy.deepcopy(v6cfg), dtype=torch.bfloat16).hydra
    init_params(v6, torch.Generator().manual_seed(SEED))
    v6 = v6.cuda().eval().requires_grad_(False)

    # ---- phase 3: each kernel against its plain version, main-path shapes
    # (b8 @ 256²: level 0 is 256², level 1 is 128²)
    unit_shapes = [("encoder_0_0", 0, 8, 256, 256),
                   ("encoder_1_0", 1, 8, 128, 128)]
    # unet_laplacian_v6's K1 shapes at the fused path's b32 @ 256²
    v6_unit_shapes = [("encoder_0_0", 0, FUSED_BATCH, 256, 256),
                      ("encoder_1_0", 1, FUSED_BATCH, 128, 128)]
    band_shapes = SPLIT_PATH_SHAPES
    errors = {"convnext_block": 0.0, "band_smooth": 0.0}
    checks = [(m, name, b, h, w) for m, shapes in ((model, unit_shapes),
                                                   (v6, v6_unit_shapes))
              for name, _, b, h, w in shapes]
    for dtype, atol in ((torch.bfloat16, 0.05), (torch.float32, 1e-3)):
        for unit_model, name, b, h, w in checks:
            x, wts, slope = unit_inputs(unit_model, name, b, h, w, dtype,
                                        rng)
            got = pallas_convnext.convnext_block(x, slope=slope, **wts)
            ref = pallas_convnext.convnext_block_plain(x, slope=slope, **wts)
            torch.cuda.synchronize()
            diff = (got.float() - ref.float()).abs()
            err = float(diff.max())
            # bf16: the kernel sums the products in another order than the
            # plain matmuls, which can flip the final bf16 rounding; where
            # |out| >= 8 one bf16 ulp (0.0625) exceeds the 0.05 bar.
            # float32: 3xTF32 keeps float32 accuracy, so the error is also
            # held to K1_F32_RELATIVE of the plain output's largest entry
            tol = torch.full_like(diff, atol)
            if dtype == torch.bfloat16:
                tol = torch.maximum(tol, bf16_ulp(ref))
            rel = err / float(ref.float().abs().max())
            n_over = int((diff > atol).sum())
            log("check", kernel="convnext_block", unit=name,
                C_K=[x.shape[-1], wts["dw"].shape[-1]],
                shape=list(x.shape), dtype=str(dtype), max_abs_err=err,
                tolerance=(f"max({atol}, 1 bf16 ulp of the plain output)"
                           if dtype == torch.bfloat16 else
                           f"{atol} and {K1_F32_RELATIVE} x max |ref|"),
                **({"relative_err": rel} if dtype == torch.float32 else {}),
                n_over_atol=n_over, n_elements=diff.numel())
            if not bool((diff <= tol).all()) or (
                    dtype == torch.float32 and rel > K1_F32_RELATIVE):
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
    # K1 int8 mode at the fused path's shapes: codes within one of the
    # plain version's (the tensor cores sum in another order, which moves
    # a code whose pre-rounding value sits near x.5), and few of them: the
    # sound kernel moves ~1e-5 of the codes; truncating instead of
    # rounding, or skipping the bf16 rounding of t, h or the dequantized
    # tile, moves far more
    max_share_differing = 1e-4
    errors["convnext_block_int8"] = 0.0
    for name, _, b, h, w in v6_unit_shapes:
        x, wts, slope = unit_inputs(v6, name, b, h, w, torch.bfloat16, rng)
        s_in = float(x.abs().max()) / 127
        s_out = float(pallas_convnext.convnext_block(
            x, slope=slope, **wts).abs().max()) / 127
        xq = pallas_convnext.quantize(x, s_in)
        got = pallas_convnext.convnext_block(xq, slope=slope, scale_in=s_in,
                                             scale_out=s_out, **wts)
        ref = pallas_convnext.convnext_block_plain(
            xq, slope=slope, scale_in=s_in, scale_out=s_out, **wts)
        torch.cuda.synchronize()
        dcode = (got.int() - ref.int()).abs()
        err, n_diff = int(dcode.max()), int((dcode > 0).sum())
        share = n_diff / dcode.numel()
        log("check", kernel="convnext_block_int8", unit=name,
            C_K=[x.shape[-1], wts["dw"].shape[-1]], shape=list(x.shape),
            scale_in=s_in, scale_out=s_out, max_abs_code_diff=err,
            n_codes_differing=n_diff, n_codes=dcode.numel(),
            share_differing=share,
            tolerance=f"|code diff| <= 1 and share of codes differing <= "
                      f"{max_share_differing}")
        if got.dtype != torch.int8 or err > 1 or share > max_share_differing:
            raise AssertionError(f"convnext_block_int8 {name}: max code "
                                 f"diff {err}, {n_diff} codes differ")
        errors["convnext_block_int8"] = max(errors["convnext_block_int8"],
                                            err)
        del x, xq, got, ref, dcode
    # K4 (the decimating split): bit-exact in f32 and bf16 (the same
    # float32 sum in the same order, the same reciprocal and rounding),
    # also at a C of no whole 16-byte vectors
    errors["band_split"] = errors["band_split_ragged"] = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for shape in band_shapes + SPLIT_RAGGED_SHAPES:
            x = torch.from_numpy(rng.normal(0, 1, shape).astype(
                np.float32)).cuda().to(dtype)
            outs = pallas_pyramid.band_split(x, 2)
            refs = pallas_pyramid.band_split_plain(x, 2)
            torch.cuda.synchronize()
            err = max(float((o.float() - r.float()).abs().max())
                      for o, r in zip(outs, refs))
            key = ("band_split" if shape in band_shapes
                   else "band_split_ragged")
            errors[key] = max(errors[key], err)
            log("check", kernel="band_split", shape=list(shape),
                dtype=str(dtype), max_abs_err=err, tolerance="0 (bit-exact)",
                down_shape=list(outs[1].shape))
            if err != 0.0 or outs[1].shape != refs[1].shape:
                raise AssertionError(f"band_split {shape} {dtype}: {err}")

    # the train step's kernels at its shapes (b16 @ 128²: level 0 is 128²,
    # level 1 is 64²; the noise kernel sees the RGB batch)
    cfg = copy.deepcopy(bidt.CONFIGS_DICT[TRAIN_CONFIG])
    cfg.setdefault("tpu", {})["pallas_noise"] = True
    ds = cfg["dataset"]
    noise_kw = dict(additive_noise=ds["additional_noise"],
                    multiplicative_noise=ds["multiplicative_noise"])
    train_band_shapes = [(TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 32),
                         (TRAIN_BATCH, TRAIN_SIZE // 2, TRAIN_SIZE // 2, 64)]
    errors["band_smooth_bwd"] = check_band_smooth_bwd(
        pallas_pyramid, rng, train_band_shapes + BWD_RAGGED_SHAPES)
    clean_train = synthetic_images(TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, rng)
    x_train = torch.from_numpy(clean_train).round().cuda()
    errors["corrupt_noise"] = check_corrupt_noise(pallas_noise, x_train,
                                                  noise_kw)

    # ---- phase 4: serve three requests through the main path
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32_defaults
    clean_b8 = synthetic_images(8, 256, 256, rng)
    noisy_b8 = add_noise(clean_b8, 25.0, rng)
    clean_512 = synthetic_images(1, 512, 512, rng)[0]
    noisy_512 = add_noise(clean_512, 25.0, rng)
    clean_bsd = synthetic_images(1, 321, 481, rng)[0]
    noisy_bsd = add_noise(clean_bsd, 25.0, rng)
    requests = [noisy_b8, noisy_512, noisy_bsd]

    reset_counts()
    outs = [den(r) for r in requests]
    torch.cuda.synchronize()
    serve_counts = read_counts()
    k1, k2 = serve_counts["convnext_block"], serve_counts["band_smooth"]
    log("serve", requests=[list(r.shape) for r in requests],
        convnext_block_launches=k1, band_smooth_launches=k2,
        launches=serve_counts)
    n_req = len(requests)
    if serve_counts != counts(convnext_block=10 * n_req,
                              band_smooth=2 * n_req):
        raise AssertionError(f"expected 10 K1 + 2 K2 launches per forward "
                             f"and no training kernel, got {serve_counts} "
                             f"for {n_req} requests")
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
            cold_ms=cuda_ms(lambda xc: pallas_convnext.convnext_block(
                xc, slope=slope, **wts), inputs=cold_copies(x)),
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
    # K1's float32 I/O mode, which serves load_model(dtype="float32"): its
    # launches per f32 serving request, then its rows against the bound,
    # the plain version and the library chain, all with TF32 off as the
    # port's float32 forwards run
    den32 = bidt.load_model(FLAGSHIP, dtype="float32")
    reset_counts()
    den32(noisy_b8)
    torch.cuda.synchronize()
    f32_counts = read_counts()
    log("serve_f32", request=list(noisy_b8.shape), launches=f32_counts)
    if f32_counts != counts(convnext_block=10, band_smooth=2):
        raise AssertionError(f"expected 10 K1 + 2 K2 launches per f32 "
                             f"forward, got {f32_counts}")
    for name, level, b, h, w in unit_shapes:
        x, wts, slope = unit_inputs(den32.model, name, b, h, w,
                                    torch.float32, rng)
        c, k = x.shape[-1], wts["dw"].shape[-1]
        with exact_float32():
            t = dict(
                ms=cuda_ms(lambda: pallas_convnext.convnext_block(
                    x, slope=slope, **wts)),
                cold_ms=cuda_ms(lambda xc: pallas_convnext.convnext_block(
                    xc, slope=slope, **wts), inputs=cold_copies(x)),
                plain_ms=cuda_ms(lambda: pallas_convnext.convnext_block_plain(
                    x, slope=slope, **wts), iters=5),
                library_ms=cuda_ms(lambda: convnext_library(x, slope=slope,
                                                            **wts)))
        bound, by = convnext_bound_ms(b, h, w, c, k, torch.float32)
        log("time", kernel="convnext_block", C=c, K=k, shape=[b, h, w, c],
            dtype="f32", calls_per_forward=2 * den32.model.backbone.widths[
                level], bound_ms=bound, bound_by=by,
            share_cold=bound / t["cold_ms"],
            bound_cuda_cores_ms=convnext_bound_ms(
                b, h, w, c, k, torch.float32, cuda_cores=True)[0],
            smi=smi, **t)
    del den32, x
    for shape in band_shapes:
        x = torch.from_numpy(rng.normal(0, 1, shape).astype(
            np.float32)).cuda().to(torch.bfloat16)
        t = dict(ms=cuda_ms(lambda: pallas_pyramid.band_smooth(x, 2)),
                 cold_ms=cuda_ms(lambda xc: pallas_pyramid.band_smooth(
                     xc, 2), inputs=cold_copies(x)),
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
    stages = {}
    for evt in prof.key_averages():
        # the CPU range carries its host time and its kernels' device
        # time; its device-side twin is a span, not kernel time
        if (evt.key.startswith("denoiser.")
                and evt.device_type == torch.autograd.DeviceType.CPU):
            stages[evt.key] = dict(
                host_ms=evt.cpu_time_total / evt.count / 1e3,
                device_ms=device_us(evt, "") / evt.count / 1e3)
    rows = [r for r in profile_rows(prof) if not r[2].startswith("denoiser.")]
    busy = sum(r[0] for r in rows)
    groups = {"convnext_block (K1)": ("convnext_block_kernel",),
              "band_smooth (K2)": ("band_smooth_kernel",),
              "convolutions (cuDNN)": ("fprop", "conv", "implicit_gemm",
                                       "cudnn"),
              "reductions": ("reduce_kernel",),
              "sort (blend median)": ("sort", "radix", "scan"),
              "matmul (attention)": ("gemm", "gemv")}
    by_group = group_rows(rows, groups, 3)
    profile_text = []
    if args.profile_out is not None:
        profile_text.append(f"{smi}\n3 requests of b8 @ 256^2 bf16 blend; wall "
                            f"{wall_us:.1f} us, device busy {busy:.1f} us\n")
        profile_text += [f"stage {key}: per request host "
                         f"{st['host_ms']:.3f} ms, device "
                         f"{st['device_ms']:.3f} ms\n"
                         for key, st in stages.items()]
        profile_text += [f"{us:12.1f} us {count:6d}x  {key}\n"
                         for us, count, key in rows]
    log("profile", requests=3, wall_us=wall_us, device_busy_us=busy,
        idle_share_profiled=(1 - busy / wall_us) if busy else None,
        idle_share_unprofiled=(1 - busy / 3 / statistics.median(b8_times)
                               / 1e6) if busy else None,
        device_us_per_request=by_group, stages_per_request=stages,
        top=[dict(us=round(us, 1), count=c, name=k[:80])
             for us, c, k in rows[:12]])

    # ---- phase 5b: the Denoiser's whole surface (TTA, tiling,
    # float_forward, dispatch, the batching server, the noise sweep), on a
    # generator of its own so the later phases keep their inputs
    reset_counts()
    with KernelInputs() as kernel_inputs:
        inference_phase(bidt, den, np.random.default_rng(SEED + 1), smi,
                        read_counts, counts)
    inference_counts = read_counts()
    if not all(inference_counts[k] for k in ("convnext_block", "band_smooth",
                                             "band_smooth_bwd")):
        raise AssertionError(f"inference phase launched {inference_counts}")
    torch.cuda.empty_cache()
    # every shape the phase gave K1, K2 and K2's backward (tile bands, the
    # 2160x3840 frame untiled, TTA members, batch buckets 1-32, the f32
    # gradient) against the plain versions
    for kernel, err in check_kernel_inputs(
            pallas_convnext, pallas_pyramid, pallas_noise,
            kernel_inputs.seen, SEED + 3).items():
        errors[kernel] = max(errors[kernel], err)
    log("inference_checks", shapes={k: len(v) for k, v in
                                    kernel_inputs.seen.items()})

    # ---- phase 6: the train step, the second path
    tree = load_msgpack(Path(bidt.models[FLAGSHIP]["directory"])
                        / "params.msgpack")
    params = params_from_flax(tree)
    train_card_vs_cpu(cfg, params, clean_train, noise_kw,
                      dump=args.dump_train_check)

    state, step = build_trainer(cfg, params, torch.bfloat16, "cuda")
    batch = torch.from_numpy(clean_train.round().astype(np.uint8)).cuda()
    dw = torch.full((state.model.no_outputs,), 1.0 / state.model.no_outputs,
                    device="cuda")
    warmup, timed = 3, 20
    losses, host_ms, event_ms = [], [], []
    reset_counts()
    for _ in range(warmup):
        state, metrics = step(state, batch, depth_weights=dw)
        losses.append(metrics["total_loss"])
    torch.cuda.synchronize()
    for _ in range(timed):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, metrics = step(state, batch, depth_weights=dw)
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        event_ms.append(start.elapsed_time(end))
        losses.append(metrics["total_loss"])
    train_counts = read_counts()
    n_steps = warmup + timed
    # grads the K2 backward wrapper had to copy to NHWC before its launch
    grad_copies_per_step = pallas_pyramid.bwd_grad_copies / n_steps
    losses = torch.stack(losses).cpu()
    per_step = {k: v / n_steps for k, v in train_counts.items()}
    log("train", batch=list(batch.shape), dtype="bf16", steps=n_steps,
        launches=train_counts, launches_per_step=per_step,
        band_smooth_bwd_grad_copies_per_step=grad_copies_per_step,
        loss_first=float(losses[0]), loss_last=float(losses[-1]),
        grad_norm_last=float(metrics["grad_norm"]),
        step_ms_host_median=statistics.median(host_ms),
        step_ms_host_min=min(host_ms), step_ms_host_max=max(host_ms),
        step_ms_event_median=statistics.median(event_ms),
        step_ms_event_min=min(event_ms), step_ms_event_max=max(event_ms),
        images_per_s=TRAIN_BATCH / statistics.median(host_ms) * 1e3,
        step_ms_host=[round(t, 3) for t in host_ms], smi=smi)
    if per_step != counts(band_smooth=2, band_smooth_bwd=2, corrupt_noise=1):
        raise AssertionError(f"expected 1 K3, 2 K2 forward, 2 K2 backward "
                             f"and no K1 launch per step, got {per_step}")
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"non-finite train loss: {losses.tolist()}")

    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            state, metrics = step(state, batch, depth_weights=dw)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = profile_rows(prof)
    busy = sum(r[0] for r in rows)
    train_groups = {
        "corrupt_noise (K3)": ("corrupt_noise_kernel",),
        "band_smooth_bwd (K2 bwd)": ("band_smooth_bwd_kernel",),
        "band_smooth (K2)": ("band_smooth_kernel",),
        "convolutions (cuDNN)": ("fprop", "dgrad", "wgrad", "conv",
                                 "implicit_gemm", "cudnn", "xmma"),
        "matmul": ("gemm", "gemv", "cutlass"),
        "optimizer (foreach)": ("multi_tensor", "foreach"),
        "reductions": ("reduce_kernel",),
        "resize (attention)": ("upsample", "interp", "aa_"),
    }
    if args.profile_out is not None:
        profile_text.append(f"\n3 train steps of b16 @ 128^2 bf16; wall "
                            f"{wall_us:.1f} us, device busy {busy:.1f} us\n")
        profile_text += [f"{us:12.1f} us {count:6d}x  {key}\n"
                         for us, count, key in rows]
    # reads of a device value on the host inside the steps (the closing
    # torch.cuda.synchronize is the one cudaDeviceSynchronize expected)
    syncs = {evt.key: evt.count for evt in prof.key_averages()
             if evt.key in ("aten::_local_scalar_dense", "aten::item",
                            "cudaStreamSynchronize", "cudaDeviceSynchronize",
                            "cudaMemcpy")}
    log("train_profile", steps=3, wall_us=wall_us, device_busy_us=busy,
        host_sync_events=syncs,
        idle_share_profiled=(1 - busy / wall_us) if busy else None,
        idle_share_unprofiled=(1 - busy / 3 / statistics.median(host_ms)
                               / 1e3) if busy else None,
        kernels_per_step=sum(r[1] for r in rows) / 3,
        device_us_per_step=group_rows(rows, train_groups, 3),
        top=[dict(us=round(us, 1), count=c, name=k[:80])
             for us, c, k in rows[:15]])

    # the train step's kernels, timed at its shapes
    seed = 20260802
    t = dict(ms=cuda_ms(lambda: pallas_noise.corrupt_noise(
                 seed, x_train, **noise_kw)),
             cold_ms=cuda_ms(lambda xc: pallas_noise.corrupt_noise(
                 seed, xc, **noise_kw), inputs=cold_copies(x_train)),
             plain_ms=cuda_ms(lambda: pallas_noise.corrupt_batch_plain(
                 seed, x_train, **noise_kw), iters=5),
             library_ms=None)
    # the bound from the work and the noises on in each sample of this
    # seed; beside it, as a diagnostic, the instructions the kernel's
    # SASS issues per element (its 16-byte path, a quad per thread)
    mul, add = (sorted(noise_kw[key]) for key in ("multiplicative_noise",
                                                   "additive_noise"))
    p = pallas_noise.sample_params_plain(seed, x_train.shape[0], *mul, *add)
    flags = (p[:, 0] + p[:, 2]).int().tolist()
    bound, by, parts = noise_bound_ms(x_train[0].numel(), flags)
    paths = sass_element_paths(kernel_sass(
        cuda_build.build().parent / "corrupt_noise.o",
        "corrupt_noise_kernelILb1E"), per_iteration=4)
    log("time", kernel="corrupt_noise", shape=list(x_train.shape),
        dtype="f32", calls_per_step=1, bound_ms=bound, bound_by=by,
        bound_ms_by_part=parts, samples_by_noises_on=[
            flags.count(k) for k in range(3)],
        sass_per_element_by_noises_on=paths,
        sass_issue_ms_by_class=sass_issue_ms(x_train[0].numel(), flags,
                                             paths), **t)
    entries["corrupt_noise"] = [(1, t, bound, by)]
    for shape in train_band_shapes:
        x, g_band, g_smooth = (torch.from_numpy(rng.normal(
            0, 1, shape).astype(np.float32)).cuda().to(torch.bfloat16)
            for _ in range(3))
        # NCHW-contiguous grads, as a permuted consumer can hand them over:
        # the wrapper copies both to NHWC first
        g_band_nchw, g_smooth_nchw = (
            g.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
            for g in (g_band, g_smooth))
        t = dict(ms=cuda_ms(lambda: pallas_pyramid.band_smooth_bwd(
                     g_band, g_smooth, 2)),
                 cold_ms=cuda_ms(lambda a, b: pallas_pyramid.band_smooth_bwd(
                     a, b, 2), inputs=cold_copies(g_band, g_smooth)),
                 plain_ms=cuda_ms(lambda: pallas_pyramid.band_smooth_bwd_plain(
                     g_band, g_smooth, 2), iters=5),
                 library_ms=cuda_ms(band_smooth_bwd_library(
                     x, 2, g_band, g_smooth)))
        ms_copies = cuda_ms(lambda: pallas_pyramid.band_smooth_bwd(
            g_band_nchw, g_smooth_nchw, 2))
        fwd = dict(
            forward_ms=cuda_ms(lambda: pallas_pyramid.band_smooth(x, 2)),
            forward_cold_ms=cuda_ms(lambda xc: pallas_pyramid.band_smooth(
                xc, 2), inputs=cold_copies(x)),
            forward_plain_ms=cuda_ms(lambda: pallas_pyramid.band_smooth_plain(
                x, 2), iters=5),
            forward_library_ms=cuda_ms(lambda: band_smooth_library(x, 2)),
            forward_bound_ms=band_bound_ms(*shape, 2, torch.bfloat16)[0])
        bound, by = band_bound_ms(*shape, 2, torch.bfloat16, backward=True)
        log("time", kernel="band_smooth_bwd", shape=list(shape), dtype="bf16",
            calls_per_step=1, bound_ms=bound, bound_by=by,
            ms_with_both_grads_copied=ms_copies,
            grad_copies_per_step=grad_copies_per_step, **fwd, **t)
        if grad_copies_per_step:
            # the step copies grads: its time counts the copies (both grads
            # of every call, the most the wrapper can copy)
            t = dict(t, ms=ms_copies, kernel_only_ms=t["ms"])
        entries.setdefault("band_smooth_bwd", []).append((1, t, bound, by))

    # ---- phase 6b: the port's benchmarking module: chained slopes and the
    # byte roofline of K1 alone, the served flagship and the train step
    t0 = time.perf_counter()
    benchmarking_phase(pallas_convnext, model, state, step, batch, dw, smi)
    bench_s = time.perf_counter() - t0
    reset_counts()

    # ---- phase 7: the fused int8 serving path of unet_laplacian_v6,
    # against the standard bf16 hydra on the same weights
    cal_clean = synthetic_images(4, FUSED_SIZE, FUSED_SIZE, rng)
    cal = np.concatenate([cal_clean, add_noise(cal_clean, 25.0, rng)])
    nchw = lambda a: torch.from_numpy(np.asarray(  # noqa: E731
        a, np.float32)).permute(0, 3, 1, 2)
    fused_clean = synthetic_images(FUSED_BATCH, FUSED_SIZE, FUSED_SIZE, rng)
    xf = nchw(add_noise(fused_clean, 25.0, rng)).cuda()
    reset_counts()
    scales = calibrate_fused(v6cfg, v6, nchw(cal))
    fused_runs = {"calibrate": read_counts()}
    fwd_float, sites = build_fused_forward(v6cfg, v6)
    fwd_int8, _ = build_fused_forward(v6cfg, v6, scales)

    def hydra_v6(x):
        with torch.inference_mode():
            return v6(x)

    forwards = {"fused_float": fwd_float, "fused_int8": fwd_int8,
                "hydra_bf16": hydra_v6}
    outs_v6 = {}
    for name, fn in forwards.items():
        reset_counts()
        outs_v6[name] = fn(xf)
        torch.cuda.synchronize()
        fused_runs[name] = read_counts()
    fused_counts = {k: sum(r[k] for r in fused_runs.values())
                    for k in fused_runs["calibrate"]}
    want = {"calibrate": counts(convnext_block=12 * len(cal)),
            "fused_float": counts(convnext_block=12),
            "fused_int8": counts(convnext_block_int8=12),
            "hydra_bf16": counts(convnext_block=12, band_smooth=2)}
    gaps = {}
    for name in ("fused_float", "fused_int8"):
        d = (outs_v6[name][0] - outs_v6["hydra_bf16"][0]).abs()
        gaps[name] = dict(mean=float(d.mean()), p99=float(torch.quantile(
            d.flatten()[::97], 0.99)), max=float(d.max()))
    # every K1 launch of the two bf16 fused forwards against its plain
    # version on the same input: the kernel on the path's own activations
    on_path, _ = fused_k1_against_plain(
        fused_module, pallas_convnext,
        {"fused_float": fwd_float, "fused_int8": fwd_int8}, xf)
    # the float fused forward in float32 on the card and on the CPU (plain
    # K1, an f32 copy of the weights): the rest of the path, on the card,
    # against plain PyTorch on the host. In bf16 and int8 the two devices
    # part by whole roundings and codes, which this seeded model spreads
    # through every later unit: those gaps are readings, not bars.
    x_cpu = xf[:FUSED_CPU_IMAGES].cpu()
    card_vs_cpu = {}
    for name, dtype, sc in (("fused_float_f32", torch.float32, None),
                            ("fused_float", torch.bfloat16, None),
                            ("fused_int8", torch.bfloat16, scales)):
        m = model_builder(copy.deepcopy(v6cfg), dtype=None if (
            dtype == torch.float32) else dtype).hydra
        m.load_state_dict({k: v.cpu() for k, v in v6.state_dict().items()})
        m.eval().requires_grad_(False)
        ref = build_fused_forward(v6cfg, m, sc, dtype=dtype)[0](x_cpu)
        if name in outs_v6:
            got = [o[:FUSED_CPU_IMAGES] for o in outs_v6[name]]
        else:
            got = build_fused_forward(v6cfg, m.cuda(), sc, dtype=dtype)[0](
                xf[:FUSED_CPU_IMAGES])
        card_vs_cpu[name] = [float((g.cpu() - r).abs().mean())
                             for g, r in zip(got, ref)]
        del m
    bars = dict(k1_int8_share_differing=max_share_differing,
                k1_bf16="max(0.05, 1 bf16 ulp)",
            k1_f32=f"1e-3 and {K1_F32_RELATIVE} x max |plain output|",
            f32_card_vs_cpu="the path with K1's plain version on the card "
                            "against the CPU (plain_k1); the path through "
                            "the kernel (kernel) is read",
                f32_card_vs_cpu_mean=FUSED_F32_CARD_VS_CPU_MEAN,
                float_vs_hydra_mean=FUSED_FLOAT_VS_HYDRA_MEAN,
                int8_vs_hydra_mean=4.0)       # JAX's, tests/test_fused.py
    log("fused", config=FUSED_CONFIG, batch=list(xf.shape), dtype="bf16",
        sites=len(sites), scales_min=min(scales.values()),
        scales_max=max(scales.values()), launches=fused_runs,
        k1_on_path=dict(
            int8_max_abs_code_diff=max(
                r["max_abs_code_diff"] for r in on_path["fused_int8"]),
            int8_share_differing=[r["share_differing"]
                                  for r in on_path["fused_int8"]],
            bf16_max_abs_err=max(r["max_abs_err"]
                                 for r in on_path["fused_float"])),
        finest_vs_hydra_bf16_gray_levels=gaps,
        card_vs_cpu_mean_gray_levels_per_scale=card_vs_cpu,
        cpu_images=FUSED_CPU_IMAGES,
        tolerance=dict(bars, launches="12 K1 per fused forward (int8 mode "
                                      "in the int8 one), no K2"))
    if fused_runs != want:
        raise AssertionError(f"fused path launches {fused_runs}, expected "
                             f"{want}")
    for name, o in outs_v6.items():
        if [tuple(t.shape) for t in o] != [
                (FUSED_BATCH, 3, FUSED_SIZE >> i, FUSED_SIZE >> i)
                for i in range(3)] or not all(
                    bool(torch.isfinite(t).all()) for t in o):
            raise AssertionError(f"{name}: bad outputs")
    if [len(v) for v in on_path.values()] != [12, 12] or not all(
            r["within"] for r in on_path["fused_float"]) or not all(
            r["max_abs_code_diff"] <= 1
            and r["share_differing"] <= max_share_differing
            for r in on_path["fused_int8"]):
        raise AssertionError(f"K1 on the fused path disagrees with its "
                             f"plain version: {on_path}")
    if max(card_vs_cpu["fused_float_f32"]) > bars["f32_card_vs_cpu_mean"]:
        raise AssertionError(f"f32 fused forward on the card drifts from "
                             f"the same forward on the CPU: {card_vs_cpu}")
    if not gaps["fused_float"]["mean"] <= bars["float_vs_hydra_mean"]:
        raise AssertionError(f"float fused forward drifts from the bf16 "
                             f"hydra: {gaps}")
    if not gaps["fused_int8"]["mean"] <= bars["int8_vs_hydra_mean"]:
        # the seeded model's own int8 error, to tell the model's from the
        # kernel's: the int8 fused forward and the hydra in float32 on an
        # f32 copy of the weights, with the same scales
        v6_f32 = model_builder(copy.deepcopy(v6cfg)).hydra
        v6_f32.load_state_dict(v6.state_dict())
        v6_f32 = v6_f32.cuda().eval().requires_grad_(False)
        int8_f32 = build_fused_forward(v6cfg, v6_f32, scales,
                                       dtype=torch.float32)[0](xf)[0]
        with torch.inference_mode():
            hydra_f32 = v6_f32(xf)[0]
        raise AssertionError(
            f"int8 fused forward drifts from the bf16 hydra: {gaps}; in "
            f"float32 the same int8 forward sits "
            f"{float((int8_f32 - hydra_f32).abs().mean())} from the hydra")

    v6_groups = {"convnext_block (K1)": ("convnext_block_kernel",),
                 "band_smooth (K2)": ("band_smooth_kernel",),
                 "convolutions (cuDNN)": ("fprop", "conv", "implicit_gemm",
                                          "cudnn", "xmma"),
                 "reductions": ("reduce_kernel",),
                 "matmul (attention)": ("gemm", "gemv", "cutlass"),
                 "resize (attention)": ("upsample", "interp", "aa_")}
    fused_timing = {}
    for name, fn in forwards.items():
        med, times = forward_event_ms(lambda: fn(xf))
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                fn(xf)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = profile_rows(prof)
        busy = sum(r[0] for r in rows)
        fused_timing[name] = dict(
            forward_ms_median=med, images_per_s=FUSED_BATCH / med * 1e3,
            forward_ms=[round(t, 3) for t in times],
            device_busy_ms=busy / 3 / 1e3,
            idle_share_unprofiled=1 - busy / 3 / 1e3 / med,
            kernels_per_forward=sum(r[1] for r in rows) / 3,
            device_ms_by_group={k: v / 1e3 for k, v in group_rows(
                rows, v6_groups, 3).items()})
        if args.profile_out is not None:
            profile_text.append(f"\n3 forwards {name} of b{FUSED_BATCH} @ "
                                f"{FUSED_SIZE}^2 bf16 ({FUSED_CONFIG}); wall "
                                f"{wall_us:.1f} us, device busy {busy:.1f} "
                                f"us\n")
            profile_text += [f"{us:12.1f} us {count:6d}x  {key}\n"
                             for us, count, key in rows]
    log("fused_timing", smi=smi, int8_speedup_vs_hydra_bf16=(
        fused_timing["hydra_bf16"]["forward_ms_median"]
        / fused_timing["fused_int8"]["forward_ms_median"]), **fused_timing)

    # the fused path's kernels, timed at its shapes: K1 int8 (calls per
    # fused int8 forward) and, for the table, K1 bf16 at (32, 5) and
    # (64, 5) as the v6 hydra runs them
    for name, level, b, h, w in v6_unit_shapes:
        x, wts, slope = unit_inputs(v6, name, b, h, w, torch.bfloat16, rng)
        c, k = x.shape[-1], wts["dw"].shape[-1]
        per_fwd = 2 * v6.backbone.widths[level]
        s_in, s_out = float(x.abs().max()) / 127, 4 * float(
            x.abs().max()) / 127
        xq = pallas_convnext.quantize(x, s_in)
        q = dict(scale_in=s_in, scale_out=s_out, slope=slope)
        t = dict(
            ms=cuda_ms(lambda: pallas_convnext.convnext_block(xq, **q, **wts)),
            cold_ms=cuda_ms(lambda xc: pallas_convnext.convnext_block(
                xc, **q, **wts), inputs=cold_copies(xq)),
            plain_ms=cuda_ms(lambda: pallas_convnext.convnext_block_plain(
                xq, **q, **wts), iters=3, warmup=1),
            library_ms=cuda_ms(lambda: convnext_int8_library(
                xq, s_in, s_out, slope=slope, **wts)))
        bound, by = convnext_bound_ms(b, h, w, c, k, torch.int8)
        log("time", kernel="convnext_block_int8", C=c, K=k,
            shape=[b, h, w, c], calls_per_forward=per_fwd, bound_ms=bound,
            bound_by=by, smi=smi, **t)
        entries.setdefault("convnext_block_int8", []).append(
            (per_fwd, t, bound, by))
        del xq
        t = dict(ms=cuda_ms(lambda: pallas_convnext.convnext_block(
                     x, slope=slope, **wts)),
                 cold_ms=cuda_ms(lambda xc: pallas_convnext.convnext_block(
                     xc, slope=slope, **wts), inputs=cold_copies(x)),
                 plain_ms=cuda_ms(lambda: pallas_convnext.convnext_block_plain(
                     x, slope=slope, **wts), iters=3, warmup=1),
                 library_ms=cuda_ms(lambda: convnext_library(
                     x, slope=slope, **wts)))
        bound, by = convnext_bound_ms(b, h, w, c, k, torch.bfloat16)
        log("time", kernel="convnext_block", model=FUSED_CONFIG, C=c, K=k,
            shape=[b, h, w, c], dtype="bf16", calls_per_forward=per_fwd,
            bound_ms=bound, bound_by=by, smi=smi, **t)
        del x

    # ---- phase 7b: the fused path with level 2 fused (C = 128): a depth-4
    # unet_laplacian_v6
    t0 = time.perf_counter()
    fused4_counts, fused4_c128, fused4_errors, fused4_int8_row = \
        fused_depth4_phase(v6cfg, rng, smi, read_counts, counts,
                           reset_counts, max_share_differing)
    fused4_s = time.perf_counter() - t0
    entries["convnext_block_int8_c128"] = [fused4_int8_row]

    # ---- phase 7c: the fused path at the widths of K1's classes: two
    # depth-5 unet_laplacian_v6 (C = 256 at level 3; levels 1.5x apart)
    t0 = time.perf_counter()
    fusedw_counts, fusedw_shapes, fusedw_errors, fusedw_rows = \
        fused_widths_phase(v6cfg, rng, smi, read_counts, counts,
                           reset_counts, max_share_differing)
    fusedw_s = time.perf_counter() - t0
    # K1's launches in the phase off the (C, K) of their own up to C = 256
    # (the classes), at 256 < C <= 512, up to 1024 and above (the general
    # route), by dtype name
    fusedw_classes, fusedw_c512, fusedw_c1024 = {}, {}, {}
    fusedw_general = {}
    for (dtype, c, k), n in fusedw_shapes.items():
        if (c, k) not in pallas_convnext.OWN_SHAPES:
            into = (fusedw_classes if c <= 256 else fusedw_c512 if c <= 512
                    else fusedw_c1024 if c <= 1024 else fusedw_general)
            into[dtype] = into.get(dtype, 0) + n

    def width_band(c):
        return ("classes" if c <= 256 else "c512" if c <= 512 else "c1024"
                if c <= 1024 else "general")

    def row_entries(rows, dtype, band):
        return [(r["calls_per_forward"], {k: r[k] for k in (
            "ms", "cold_ms", "plain_ms", "library_ms")}, r["bound_ms"],
                 r["bound_by"]) for r in rows
                if r["dtype"] == dtype and r["calls_per_forward"]
                and not r["timed_only"] and width_band(r["C"]) == band]

    # per the two depth-5 float fused forwards (bf16: 6 K1 at each class
    # shape) and per the C = 256 model's int8 fused forward (6 at (256, 5));
    # per the no-attention depth-5 model's fused forwards (3 at (512, 5));
    # per the depth-6 model's (3 at (1024, 5)); per the depth-7 model's (3
    # at (2048, 5), the general route)
    for band in ("classes", "c512", "c1024", "general"):
        entries[f"convnext_block_{band}"] = row_entries(
            fusedw_rows, "bfloat16", band)
        entries[f"convnext_block_int8_{band}"] = row_entries(
            fusedw_rows, "int8", band)
    # per each no-attention model's f32 fused forward (3 at (512, 5), 3 at
    # (1024, 5), 3 at (2048, 5))
    for band in ("c512", "c1024", "general"):
        entries[f"convnext_block_f32_{band}"] = row_entries(
            fusedw_rows, "float32", band)
        errors[f"convnext_block_f32_{band}"] = fusedw_errors[f"f32_{band}"]
    errors["convnext_block_classes"] = fusedw_errors["bf16"]
    errors["convnext_block_int8_classes"] = fusedw_errors["int8"]
    for band in ("c512", "c1024", "general"):
        errors[f"convnext_block_{band}"] = fusedw_errors[f"bf16_{band}"]
        errors[f"convnext_block_int8_{band}"] = fusedw_errors[f"int8_{band}"]

    # ---- phase 7d: the wider shapes' other paths: the multiplier-1.5 v6
    # trained (K2's backward at C = 108) and the K = 7 v6's hydra
    t0 = time.perf_counter()
    wider_launches, wider_errors, wider_rows = wider_shapes_phase(
        bidt, v6cfg, rng, smi, read_counts, counts, reset_counts)
    wider_s = time.perf_counter() - t0
    entries.update(wider_rows)
    errors["band_smooth_bwd_ragged"] = wider_errors["band_smooth_bwd"]
    errors["convnext_block_k7"] = wider_errors["convnext_block_k7"]
    # the general route at its card-test shapes, every mode
    t0 = time.perf_counter()
    general_worst = general_route_checks(pallas_convnext, read_counts,
                                         counts, reset_counts, smi)
    wider_s += time.perf_counter() - t0
    errors["convnext_block_general"] = max(
        errors["convnext_block_general"], general_worst["bf16"])
    errors["convnext_block_int8_general"] = max(
        errors["convnext_block_int8_general"], general_worst["int8"])
    errors["convnext_block_f32_general"] = max(
        errors["convnext_block_f32_general"], general_worst["f32"])

    # ---- phase 8: the decimating band split (K4) through its op, at the
    # flagship's levels and at a C of no whole 16-byte vectors
    split_shapes = band_shapes + SPLIT_RAGGED_SHAPES
    xs_split = [torch.from_numpy(rng.normal(0, 1, shape).astype(
        np.float32)).cuda().to(torch.bfloat16) for shape in split_shapes]
    reset_counts()
    for x in xs_split:
        band, down = pallas_pyramid.band_split(x, 2)
        if down.shape != (x.shape[0], x.shape[1] // 2, x.shape[2] // 2,
                          x.shape[3]) or not bool(torch.isfinite(
                              band).all()):
            raise AssertionError(f"band_split: bad outputs for {x.shape}")
    torch.cuda.synchronize()
    split_counts = read_counts()
    log("band_split", shapes=[list(x.shape) for x in xs_split],
        launches=split_counts)
    if split_counts != counts(band_split=len(xs_split)):
        raise AssertionError(f"band_split path launches {split_counts}")
    for x, shape in zip(xs_split, split_shapes):
        t = dict(ms=cuda_ms(lambda: pallas_pyramid.band_split(x, 2)),
                 cold_ms=cuda_ms(lambda xc: pallas_pyramid.band_split(
                     xc, 2), inputs=cold_copies(x)),
                 plain_ms=cuda_ms(lambda: pallas_pyramid.band_split_plain(
                     x, 2), iters=5),
                 library_ms=cuda_ms(lambda: band_split_library(x, 2)))
        bound, by = band_bound_ms(*shape, 2, torch.bfloat16, split=True)
        log("time", kernel="band_split", shape=list(shape), dtype="bf16",
            calls_per_path=1, bound_ms=bound, bound_by=by, smi=smi, **t)
        entries.setdefault("band_split" if shape in band_shapes
                           else "band_split_ragged", []).append(
                               (1, t, bound, by))

    # ---- phase 9: the two other packaged artifacts (no kernel of K1-K4)
    reset_counts()
    artifacts_phase(bidt, rng, smi, acts, read_counts, counts, profile_text)
    artifact_counts = read_counts()
    if artifact_counts != counts():
        raise AssertionError(f"artifacts phase launched {artifact_counts}")

    # ---- phase 10: the training loop through train_loop (fine-tune from
    # the packaged artifact, then resume)
    loop_counts, loop_errors, _, loop_run = train_loop_phase(
        bidt, smi, read_counts, counts,
        profile_text if args.profile_out is not None else None)
    for kernel, err in loop_errors.items():
        errors[kernel] = max(errors[kernel], err)

    # ---- phase 11: the train_loop phase's run exported (quantize, self-
    # test), served from the artifact in bf16 and int8, and the export and
    # build CLIs
    t0 = time.perf_counter()
    reset_counts()
    export_seen = export_phase(bidt, smi, read_counts, loop_run,
                               keep=args.keep_export)
    export_counts = read_counts()
    errors_export = check_kernel_inputs(pallas_convnext, pallas_pyramid,
                                        pallas_noise, export_seen, SEED + 10,
                                        path="export")
    for kernel, err in errors_export.items():
        errors[kernel] = max(errors[kernel], err)
    phase_s = {"export": time.perf_counter() - t0}

    # ---- phase 11b: the formats: the TFLite fixture served on the card
    # and the train_loop phase's run as a torch.export program
    t0 = time.perf_counter()
    reset_counts()
    formats_seen = formats_phase(bidt, smi, read_counts, loop_run)
    formats_counts = read_counts()
    for kernel, err in check_kernel_inputs(
            pallas_convnext, pallas_pyramid, pallas_noise, formats_seen,
            SEED + 51, path="formats").items():
        errors[kernel] = max(errors[kernel], err)
    phase_s["formats"] = time.perf_counter() - t0

    # ---- phase 12: the resnet config trained, exported and served
    t0 = time.perf_counter()
    reset_counts()
    resnet_counts = resnet_train_export_phase(bidt, smi, read_counts,
                                              loop_run)
    if resnet_counts != counts() or read_counts() != counts():
        raise AssertionError(f"resnet_train_export launched {resnet_counts}")
    phase_s["resnet_train_export"] = time.perf_counter() - t0

    # ---- phase 13: the rest of the unet_laplacian family: v4 trained,
    # exported and served, v3 and v5 built and served, K1 at K = 1
    t0 = time.perf_counter()
    reset_counts()
    family_seen, family_counts, family_branch = unet_laplacian_family_phase(
        bidt, smi, read_counts, loop_run, keep=args.keep_family)
    family_c128 = c128_launches(pallas_convnext)
    for kernel, err in check_kernel_inputs(
            pallas_convnext, pallas_pyramid, pallas_noise, family_seen,
            SEED + 12, path="unet_laplacian_family").items():
        errors[kernel] = max(errors[kernel], err)
    log("family_checks", shapes={k: sorted(str(key[:2]) for key in v)
                                 for k, v in family_seen.items()})
    c128_rows = [r for r in family_k1_times(pallas_convnext, smi,
                                            family_seen)
                 if r["C"] == 128 and r["dtype"] == "bfloat16"]
    # K1 at C = 128 per v4 bf16 forward: 3 units each at (128, 5), (128, 1)
    entries["convnext_block_c128"] = [
        (r["calls_per_forward"], {k: r[k] for k in (
            "ms", "cold_ms", "plain_ms", "library_ms")}, r["bound_ms"],
         r["bound_by"]) for r in c128_rows]
    errors["convnext_block_c128"] = max(
        [r["max_abs_err"] for r in c128_rows] + [fused4_errors["bf16"]])
    errors["convnext_block_int8_c128"] = fused4_errors["int8"]
    phase_s["unet_laplacian_family"] = time.perf_counter() - t0

    # ---- phase 14: the blind-restoration recipe: the chain's ops and
    # statistics, its step, the loop fine-tuning the flagship, export,
    # serving and the degradation sweep
    t0 = time.perf_counter()
    reset_counts()
    restore_seen, restore_counts = restoration_phase(bidt, smi, read_counts,
                                                     loop_run)
    if read_counts() != restore_counts:
        raise AssertionError(f"restoration launched {read_counts()} in all, "
                             f"{restore_counts} counted")
    for kernel, err in check_kernel_inputs(
            pallas_convnext, pallas_pyramid, pallas_noise, restore_seen,
            SEED + 23, path="restoration").items():
        errors[kernel] = max(errors[kernel], err)
    phase_s["restoration"] = time.perf_counter() - t0

    # ---- phase 15: the classic unet backbone (no kernel of K1-K4)
    t0 = time.perf_counter()
    reset_counts()
    unet_counts = unet_backbone_phase(bidt, smi, read_counts, loop_run)
    if unet_counts != counts() or read_counts() != counts():
        raise AssertionError(f"unet_backbone launched {unet_counts}")
    phase_s["unet_backbone"] = time.perf_counter() - t0

    # ---- phase 16: distillation: the per-level-width flagship config from
    # a seeded init, distilled from v5.6 and pruned per epoch; its export
    # served; the flagship as a bf16 teacher
    t0 = time.perf_counter()
    reset_counts()
    distill_seen, distill_counts = distillation_phase(
        bidt, smi, read_counts, loop_run, keep=args.keep_distill)
    if read_counts() != distill_counts:
        raise AssertionError(f"distillation launched {read_counts()} in "
                             f"all, {distill_counts} counted")
    for kernel, err in check_kernel_inputs(
            pallas_convnext, pallas_pyramid, pallas_noise, distill_seen,
            SEED + 43, path="distillation").items():
        errors[kernel] = max(errors[kernel], err)
    phase_s["distillation"] = time.perf_counter() - t0

    # ---- phase 17: the bias-free analysis of the flagship, card vs CPU,
    # and its CLI
    t0 = time.perf_counter()
    reset_counts()
    analysis_seen, analysis_counts = analysis_phase(bidt, smi, read_counts)
    if read_counts() != analysis_counts:
        raise AssertionError(f"analysis launched {read_counts()} in all, "
                             f"{analysis_counts} counted")
    for kernel, err in check_kernel_inputs(
            pallas_convnext, pallas_pyramid, pallas_noise, analysis_seen,
            SEED + 44, path="analysis").items():
        errors[kernel] = max(errors[kernel], err)
    phase_s["analysis"] = time.perf_counter() - t0

    # ---- phase 18: the selector resnet and the other last layers (no
    # kernel of K1-K4)
    t0 = time.perf_counter()
    reset_counts()
    breadth_counts = layers_breadth_phase(bidt, smi, read_counts)
    if breadth_counts != counts() or read_counts() != counts():
        raise AssertionError(f"layers_breadth launched {breadth_counts}")
    phase_s["layers_breadth"] = time.perf_counter() - t0

    # ---- phase 19: several processes on the card: the data-parallel step
    # and loop (2 gloo ranks; 1 NCCL rank) and spatially sharded serving
    t0 = time.perf_counter()
    reset_counts()
    parallel_counts, parallel_errors = parallel_phase(bidt, smi, loop_run)
    if read_counts() != counts():
        raise AssertionError(f"parallel launched {read_counts()} in the "
                             f"driving process")
    for kernel, err in parallel_errors.items():
        errors[kernel] = max(errors[kernel], err)
    phase_s["parallel"] = time.perf_counter() - t0
    log("new_phases", seconds=dict(phase_s, fused_depth4=fused4_s,
                                   fused_widths=fusedw_s,
                                   wider_shapes=wider_s,
                                   benchmarking=bench_s),
        script_s=time.perf_counter() - script_start,
        fused_depth4_launches=fused4_counts,
        fused_widths_launches=fusedw_counts,
        fused_widths_class_launches=fusedw_classes,
        fused_widths_c512_launches=fusedw_c512,
        fused_widths_c1024_launches=fusedw_c1024,
        fused_widths_general_launches=fusedw_general,
        wider_shapes_launches=wider_launches,
        c128_launches=dict(unet_laplacian_family=family_c128,
                           fused_depth4=fused4_c128),
        export_launches=export_counts,
        formats_launches=formats_counts,
        resnet_train_export_launches=resnet_counts,
        unet_laplacian_family_launches=family_counts,
        unet_laplacian_family_branch_units_per_forward=family_branch,
        restoration_launches=restore_counts,
        unet_backbone_launches=unet_counts,
        distillation_launches=distill_counts,
        analysis_launches=analysis_counts,
        layers_breadth_launches=breadth_counts,
        parallel_launches=parallel_counts)
    if args.profile_out is not None:
        args.profile_out.parent.mkdir(parents=True, exist_ok=True)
        args.profile_out.write_text("".join(profile_text))

    # ---- result lines
    replaces = {
        "convnext_block": ("blind_image_denoising_torch/csrc/"
                           "convnext_block.cu",
                           "blind_image_denoising_tpu/ops/pallas_convnext.py"
                           ":196"),
        "band_smooth": ("blind_image_denoising_torch/csrc/band_smooth.cu",
                        "blind_image_denoising_tpu/ops/pallas_pyramid.py"
                        ":165"),
        "band_smooth_bwd": ("blind_image_denoising_torch/csrc/band_smooth.cu",
                            "blind_image_denoising_tpu/ops/pallas_pyramid.py"
                            ":256"),
        "corrupt_noise": ("blind_image_denoising_torch/csrc/corrupt_noise.cu",
                          "blind_image_denoising_tpu/ops/pallas_noise.py"
                          ":101"),
        "convnext_block_int8": ("blind_image_denoising_torch/csrc/"
                                "convnext_block.cu",
                                "blind_image_denoising_tpu/ops/"
                                "pallas_convnext.py:196"),
        "band_split": ("blind_image_denoising_torch/csrc/band_smooth.cu",
                       "blind_image_denoising_tpu/ops/pallas_pyramid.py:81"),
    }
    # K1's C = 128 instantiations, rows of their own
    replaces["convnext_block_c128"] = replaces["convnext_block"]
    replaces["convnext_block_int8_c128"] = replaces["convnext_block_int8"]
    # K1 off the (C, K) of their own: its classes, rows of their own
    # (the layouts of csrc/convnext_class.cuh, built by convnext_class*.cu
    # and convnext_k7_class*.cu, and convnext_wide.cu, beside the entry
    # points in convnext_block.cu)
    replaces["convnext_block_classes"] = replaces["convnext_block"]
    replaces["convnext_block_int8_classes"] = replaces["convnext_block_int8"]
    # the shapes opened since: K1 at K = 7 (of their own, in
    # csrc/convnext_k7.cu), above C = 256 (the thread-block cluster,
    # csrc/convnext_cluster.cuh, built per I/O mode by convnext_cluster.cu,
    # convnext_cluster_int8.cu and convnext_cluster_f32.cu), K2's backward
    # and K4 at a C of no whole 16-byte vectors
    replaces["convnext_block_k7"] = (
        "blind_image_denoising_torch/csrc/convnext_k7.cu",
        replaces["convnext_block"][1])
    for band in ("c512", "c1024"):
        replaces[f"convnext_block_{band}"] = (
            "blind_image_denoising_torch/csrc/convnext_cluster.cu",
            replaces["convnext_block"][1])
        replaces[f"convnext_block_int8_{band}"] = (
            "blind_image_denoising_torch/csrc/convnext_cluster_int8.cu",
            replaces["convnext_block_int8"][1])
    for band in ("c512", "c1024"):
        replaces[f"convnext_block_f32_{band}"] = (
            "blind_image_denoising_torch/csrc/convnext_cluster_f32.cu",
            replaces["convnext_block"][1])
    # the general route (C above 1024, any odd K, any E): three kernels in
    # csrc/convnext_general.cu, every mode
    for name in ("convnext_block_general", "convnext_block_int8_general",
                 "convnext_block_f32_general"):
        replaces[name] = ("blind_image_denoising_torch/csrc/"
                          "convnext_general.cu", replaces["convnext_block"][1])
    replaces["band_smooth_bwd_ragged"] = replaces["band_smooth_bwd"]
    replaces["band_split_ragged"] = replaces["band_split"]
    per = {"convnext_block": "serving forward, b8 @ 256^2",
           "band_smooth": "serving forward, b8 @ 256^2",
           "band_smooth_bwd": "train step, b16 @ 128^2",
           "corrupt_noise": "train step, b16 @ 128^2",
           "convnext_block_int8": f"fused int8 forward, b{FUSED_BATCH} @ "
                                  f"{FUSED_SIZE}^2",
           "band_split": "band_split op path, 8x256^2x32 + 8x128^2x64 bf16",
           "convnext_block_c128": "unet_laplacian_v4 bf16 forward, b8 @ "
                                  "256^2: 3 x (128,5) + 3 x (128,1) at "
                                  "8x64^2",
           "convnext_block_int8_c128": f"depth-4 fused int8 forward, "
                                       f"b{FUSED_BATCH} @ {FUSED_SIZE}^2: "
                                       f"6 x (128,5) at {FUSED_BATCH}x64^2",
           "convnext_block_classes": f"the two depth-5 float fused "
                                     f"forwards, b{FUSED_BATCH} @ "
                                     f"{FUSED_SIZE}^2: 6 x (256,5) at "
                                     f"{FUSED_BATCH}x32^2, 6 x (48,5) at "
                                     f"{FUSED_BATCH}x128^2, 6 x (72,5) at "
                                     f"{FUSED_BATCH}x64^2, 6 x (108,5) at "
                                     f"{FUSED_BATCH}x32^2",
           "convnext_block_int8_classes": f"depth-5 fused int8 forward, "
                                          f"b{FUSED_BATCH} @ "
                                          f"{FUSED_SIZE}^2: 6 x (256,5) at "
                                          f"{FUSED_BATCH}x32^2",
           "convnext_block_c512": "no-attention depth-5 v6 float fused "
                                  "forward, b8 @ 256^2: 3 x (512,5) at "
                                  "8x16^2",
           "convnext_block_int8_c512": "no-attention depth-5 v6 int8 fused "
                                       "forward, b8 @ 256^2: 3 x (512,5) at "
                                       "8x16^2",
           "convnext_block_c1024": "no-attention depth-6 v6 float fused "
                                   "forward, b8 @ 256^2: 3 x (1024,5) at "
                                   "8x8^2",
           "convnext_block_int8_c1024": "no-attention depth-6 v6 int8 fused "
                                        "forward, b8 @ 256^2: 3 x (1024,5) "
                                        "at 8x8^2",
           "convnext_block_f32_c512": "no-attention depth-5 v6 f32 fused "
                                      "forward: 3 x (512,5), timed at "
                                      "8x16^2",
           "convnext_block_general": "no-attention depth-7 v6 float fused "
                                     "forward, b8 @ 256^2: 3 x (2048,5) at "
                                     "8x4^2 (the general route)",
           "convnext_block_int8_general": "no-attention depth-7 v6 int8 "
                                          "fused forward, b8 @ 256^2: 3 x "
                                          "(2048,5) at 8x4^2 (the general "
                                          "route)",
           "convnext_block_f32_general": "no-attention depth-7 v6 f32 fused "
                                         "forward: 3 x (2048,5), timed at "
                                         "8x4^2 (the general route)",
           "convnext_block_f32_c1024": "no-attention depth-6 v6 f32 fused "
                                       "forward: 3 x (1024,5), timed at "
                                       "8x8^2",
           "convnext_block_k7": "K = 7 v6 bf16 hydra forward, b8 @ 256^2: "
                                "6 x (32,7) at 8x256^2, 6 x (64,7) at "
                                "8x128^2",
           "band_smooth_bwd_ragged": "multiplier-1.5 depth-5 v6 train "
                                     "step, b16 @ 128^2: 1 x 16x16^2x108",
           "band_split_ragged": "band_split op path at 8x32^2x108 bf16"}
    # ms, bound and library are per serving forward (K1, K2), per train
    # step (K2 backward, K3), per fused int8 forward (K1 int8) or per
    # band_split path run (K4), summed over the shapes of that unit of
    # work
    kernels = []
    for name, rows_k in entries.items():
        total = lambda key: (None if rows_k[0][1][key] is None  # noqa
                             else sum(n * t[key] for n, t, _, _ in rows_k))
        bound = sum(n * bd for n, _, bd, _ in rows_k)
        bound_by = max(rows_k, key=lambda r: r[0] * r[2])[3]
        if name.endswith("_c128"):
            # launches at C = 128 (the float modes or int8), by path
            modes = ("int8",) if "int8" in name else ("bfloat16", "float32")
            by_path = {path: sum(per.get(m, 0) for m in modes)
                       for path, per in (("unet_laplacian_family",
                                          family_c128),
                                         ("fused_depth4", fused4_c128))}
        elif name.endswith(("_classes", "_c512", "_c1024", "_general")):
            # launches off the (C, K) of their own up to C = 256 (the
            # float modes or int8), at 256 < C <= 512, up to 1024 or above
            # (bf16, int8 or f32), by path
            modes = (("int8",) if "int8" in name else ("float32",)
                     if "_f32_" in name else ("bfloat16", "float32")
                     if name.endswith("_classes") else ("bfloat16",))
            launched = (fusedw_c512 if name.endswith("_c512")
                        else fusedw_c1024 if name.endswith("_c1024")
                        else fusedw_general if name.endswith("_general")
                        else fusedw_classes)
            by_path = {"fused_widths": sum(launched.get(m, 0)
                                           for m in modes)}
        elif name == "convnext_block_k7":
            by_path = {"wider_shapes": wider_launches["k7_hydra"][
                "per_forward"]["convnext_block"]}
        elif name == "band_smooth_bwd_ragged":
            by_path = {"wider_shapes": sum(
                n for c, n in wider_launches["train"][
                    "band_smooth_bwd_by_c"].items() if int(c) % 8)}
        elif name == "band_split_ragged":
            by_path = {"band_split": len(SPLIT_RAGGED_SHAPES)}
        else:
            by_path = dict(serve=serve_counts[name],
                           inference=inference_counts[name],
                           train=train_counts[name],
                           fused=fused_counts[name],
                           fused_depth4=fused4_counts[name],
                           fused_widths=fusedw_counts[name],
                           band_split=split_counts[name],
                           artifacts=artifact_counts[name],
                           train_loop=loop_counts[name],
                           export=export_counts[name],
                           formats=formats_counts[name],
                           resnet_train_export=resnet_counts[name],
                           unet_laplacian_family=family_counts[name],
                           restoration=restore_counts[name],
                           unet_backbone=unet_counts[name],
                           distillation=distill_counts[name],
                           analysis=analysis_counts[name],
                           layers_breadth=breadth_counts[name],
                           parallel=parallel_counts[name])
        kernels.append(dict(
            name=name, route="cuda", source=replaces[name][0],
            replaces=replaces[name][1], launches=sum(by_path.values()),
            launches_by_path=by_path, max_abs_err=errors[name],
            ms=total("ms"), cold_ms=total("cold_ms"),
            plain_ms=total("plain_ms"), bound_ms=bound,
            bound_by=bound_by, library_ms=total("library_ms"),
            **({"grad_copies_per_step": grad_copies_per_step}
               if name == "band_smooth_bwd" else {}),
            # the family's units that run their PyTorch branch, per forward
            **({"branch_units_per_forward": family_branch}
               if name == "convnext_block" else {}),
            per=per[name]))
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"kernels launched no time on their paths: "
                             f"{idle}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
