"""The train and eval steps (counterpart of
``blind_image_denoising_tpu/training/train_step.py`` ``build_train_step``
and ``build_eval_step``).

In the JAX order: the uint8 or float32 NHWC batch is widened to float32
on the device → random flips → random rotation of the clean batch
(``random_rotate`` > 0) → rounding → the corruption: the degradation
chain (``ops/degradations.degrade_batch``) when any of blur, JPEG,
posterize or holes is on, else the noise (the K3 kernel,
``ops/pallas_noise.corrupt_noise``, when ``use_pallas_noise``; else the
exact ``ops/noise.corrupt_batch``) → the multiscale targets of the
rotated clean batch →
the training forward → per-scale losses on the float32 outputs × the
deep-supervision weights → regularization × its multiplier → backward.
Gradients are accumulated over ``grad_accum`` micro-batches and divided
by their number, then clipped and applied by the optimizer; the EMA of
the params follows. Metrics keep the JAX names (``total_loss``,
``regularization_loss``, ``scale_{i}/{mae,mse,ssim,total}_loss``,
``grad_norm``, ``grad_stats``) and stay on the device: nothing in a step
waits for it. The noise kernel's seed is drawn on the host from the
state's CPU generator, one int32 per micro-batch, and the step counter
lives on the host.

A teacher (``teacher_fn``, ``training/distill.py``) runs on the same
corrupted micro-batch outside the graph; its output adds a
``distill_weight``-scaled student-vs-teacher loss on the finest scale
(metrics ``distill/mae_loss`` and ``distill/total_loss``) while the
hard-GT losses are scaled by ``distill_gt_weight``. The chain runs in
eager PyTorch ops inside the profiler range ``degradations.chain``.

Under ``parallel/mesh.shard_train_step`` (a data-parallel step) the
batch is this rank's rows of the global batch: the per-sample draws are
the global batch's rows (``ops/noise.batch_rand``, the noise kernel's
``sample_offset``), BatchNorm's statistics are global, and the
gradients and metrics are ``all_reduce``d to their means over the batch
axes before the clip, the optimizer and the EMA, so the update is the
single-process step's on the global batch and alike on every rank.
Under ``shard_train_step(spatial=True)`` each spatial rank also prepares
the whole crops, runs the model on its slab of rows
(``parallel/mesh.SpatialShard``), takes each scale's losses over its
owned rows (``parallel/spatial.loss_rows``) and the regularization on
the first spatial rank alone; the gradients and metrics are then summed
over the spatial ranks and averaged over the batch axes, in one
``all_reduce``.
"""

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..constants import (MAE_LOSS_STR, MSE_LOSS_STR, REGULARIZATION_LOSS_STR,
                         SSIM_LOSS_STR, TOTAL_LOSS_STR)
from ..layers.norm import frozen_statistics
from ..ops.degradations import degrade_batch, random_rotate_batch
from ..ops.multiscale import multiscale_targets
from ..ops.noise import corrupt_batch, random_flips
from ..ops.pallas_noise import corrupt_noise
from ..ops.precision import exact_float32
from ..ops.regularizers import regularization_loss
from ..ops.resize import nchw, nhwc
from ..parallel.mesh import (batch_shard, current_batch_shard,
                             current_spatial_shard, reduce_mean_,
                             spatial_shard, whole_map)
from ..parallel.spatial import loss_rows
from .optimizer import global_norm
from .train_state import TrainState


def forward_loss(model, loss_fns: Dict[str, Callable], no_outputs: int,
                 noisy: torch.Tensor, gt_scales, depth_weights: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 remat: bool = False,
                 teacher_out: Optional[torch.Tensor] = None,
                 distill_weight: float = 1.0, gt_weight: float = 1.0):
    """The training forward and its losses (JAX ``forward_loss``):
    ``noisy`` [B, H, W, C] float32 → (total loss, metrics dict).

    ``remat``: keep none of the forward's activations; the backward runs
    the forward again (``torch.utils.checkpoint``). The recompute draws
    its drop-path and dropout masks from ``generator`` restored to the
    state it had before the forward, so it draws the same masks, and
    leaves the batch norms' running statistics as the forward left them.

    A BatchNorm model normalizes by the batch's statistics and updates
    its running buffers once per call, so the step's micro-batches update
    them in order, as JAX carries ``batch_stats`` through its
    accumulation scan.

    ``teacher_out``: the teacher's finest-scale output on ``noisy``; the
    per-scale losses are then scaled by ``gt_weight`` and the finest
    output's loss against it, × ``depth_weights[0]`` × ``distill_weight``,
    is added.

    Under a spatially sharded step ``noisy`` and the targets are the
    whole crops: the model runs on the slab's rows and each loss is this
    rank's share over its owned rows (module docstring)."""
    spatial = current_spatial_shard()
    x = nchw(noisy if spatial is None else noisy.narrow(
        1, spatial.slab[0], spatial.slab[1] - spatial.slab[0]))
    if remat:
        saved = generator.get_state() if generator is not None else None
        calls = []
        # the recompute may run on the backward's thread: it re-enters the
        # step's shards, so it issues the forward's collectives
        shards = (current_batch_shard(), spatial)

        def run(x):
            if saved is not None:
                generator.set_state(saved)
            # the recompute leaves the batch norms' running statistics
            # alone: the forward updated them once, as JAX's pure remat
            calls.append(None)
            with frozen_statistics(len(calls) > 1), \
                    batch_shard(shards[0]), spatial_shard(shards[1]):
                return tuple(model(x, train=True, generator=generator))

        outputs = checkpoint(run, x, use_reentrant=False)
    else:
        outputs = model(x, train=True, generator=generator)
    total = torch.zeros((), device=noisy.device)
    metrics = {}
    if teacher_out is None:
        gt_weight = 1.0

    def loss(target, output):
        target, output, share = loss_rows(target, nhwc(output).float())
        if share is None:
            return loss_fns["denoiser"](target, output)
        return loss_fns["denoiser"](target, output, share=share)

    for i in range(no_outputs):
        li = loss(gt_scales[i], outputs[i])
        total = total + li[TOTAL_LOSS_STR] * depth_weights[i] * gt_weight
        for k in (MAE_LOSS_STR, MSE_LOSS_STR, SSIM_LOSS_STR, TOTAL_LOSS_STR):
            metrics[f"scale_{i}/{k}"] = li[k]
    if teacher_out is not None:
        distill = loss(teacher_out, outputs[0])
        total = total + (distill[TOTAL_LOSS_STR] * depth_weights[0]
                         * distill_weight)
        for k in (MAE_LOSS_STR, TOTAL_LOSS_STR):
            metrics[f"distill/{k}"] = distill[k]
    # the spatial ranks' shares sum: the first carries the regularization
    regularization = (regularization_loss(model)
                      if spatial is None or spatial.index == 0
                      else torch.zeros((), device=noisy.device))
    mloss = loss_fns["model"](regularization)
    total = total + mloss[TOTAL_LOSS_STR]
    metrics[TOTAL_LOSS_STR] = total
    metrics[REGULARIZATION_LOSS_STR] = mloss[REGULARIZATION_LOSS_STR]
    return total, metrics


def build_train_step(
        model,
        tx,
        loss_fns: Dict[str, Callable],
        no_outputs: int,
        additive_noise: Optional[Sequence[float]] = None,
        multiplicative_noise: Optional[Sequence[float]] = None,
        noise_sampling: str = "uniform",
        random_left_right: bool = True,
        random_up_down: bool = True,
        random_rotate: float = 0.0,
        use_random_blur: bool = False,
        use_jpeg_noise: bool = False,
        quantization: int = -1,
        inpaint_drop_rate: float = 0.0,
        degradation_prob: float = 0.5,
        degradation_chain_prob: float = 1.0,
        round_values: bool = True,
        grad_accum: int = 1,
        remat: bool = False,
        use_pallas_noise: bool = False,
        grad_stats: bool = False,
        teacher_fn=None,
        distill_weight: float = 1.0,
        distill_gt_weight: float = 1.0,
        ema_decay: float = 0.0):
    """Returns ``train_step(state, batch, generator=None,
    depth_weights=None) -> (state, metrics)``; the JAX step's arguments.

    ``batch``: clean uint8 or float32 [grad_accum·B, H, W, C] in
    [0, 255], on any device (it is moved to the model's). ``generator``:
    the device generator for flips, rotations, the degradation chain,
    drop-path and dropout masks and the non-kernel noise (default: the
    state's). ``depth_weights``:
    [no_outputs] deep-supervision weights (default: equal); pass them on
    the model's device, since a copy from host memory waits for the
    device.

    ``teacher_fn``: a frozen teacher (``training/distill.build_teacher``)
    applied to each corrupted micro-batch; see :func:`forward_loss` for
    ``distill_weight`` and ``distill_gt_weight``.

    ``ema_decay`` > 0: ``state.ema_params`` (seeded by the caller) follows
    ``e ← d·e + (1 − d)·p`` on the updated params with ``d = min(decay,
    (1 + t) / (10 + t))``, t the step before this one (the
    ``tf.train.ExponentialMovingAverage(num_updates=step)`` ramp).
    ``grad_stats``: ``metrics["grad_stats"]`` maps the flax path of every
    2-D and 4-D gradient to its [min, p25, p50, p75, max]
    (``jnp.percentile``'s linear interpolation). ``remat``: see
    :func:`forward_loss`."""
    extended = bool(use_random_blur or use_jpeg_noise
                    or (quantization and quantization > 1)
                    or (inpaint_drop_rate and inpaint_drop_rate > 0.0))
    if use_pallas_noise and noise_sampling != "uniform":
        raise ValueError(
            "tpu.pallas_noise only implements the reference's uniform std "
            f"draw; unset it to use dataset.noise_sampling="
            f"{noise_sampling!r}")
    if use_pallas_noise and extended:
        raise ValueError(
            "tpu.pallas_noise fuses only the noise corruption; unset it to "
            "use random_blur / use_jpeg_noise / quantization / "
            "inpaint_drop_rate")
    n = max(1, int(grad_accum))

    def prepare(state: TrainState, clean: torch.Tensor, generator):
        clean = random_flips(generator, clean, left_right=random_left_right,
                             up_down=random_up_down)
        if random_rotate and random_rotate > 0.0:
            # geometric augmentation of the clean batch: the targets below
            # are built from it
            clean = random_rotate_batch(generator, clean, random_rotate)
        if round_values:
            clean = torch.round(clean)
        if extended:
            with torch.profiler.record_function("degradations.chain"):
                noisy = degrade_batch(
                    generator, clean, additive_noise=additive_noise,
                    multiplicative_noise=multiplicative_noise,
                    noise_sampling=noise_sampling,
                    round_values=round_values,
                    use_random_blur=use_random_blur,
                    use_jpeg_noise=use_jpeg_noise,
                    quantization=quantization,
                    inpaint_drop_rate=inpaint_drop_rate,
                    degradation_prob=degradation_prob,
                    chain_prob=degradation_chain_prob)
        elif use_pallas_noise:
            # one seed for every rank: the host generators are seeded alike
            seed = int(torch.randint(0, 2 ** 31 - 1, (),
                                     generator=state.host_generator))
            shard = current_batch_shard()
            noisy = corrupt_noise(seed, clean, additive_noise=additive_noise,
                                  multiplicative_noise=multiplicative_noise,
                                  round_values=round_values,
                                  sample_offset=(0 if shard is None else
                                                 shard.index
                                                 * clean.shape[0]))
        else:
            noisy = corrupt_batch(generator, clean,
                                  additive_noise=additive_noise,
                                  multiplicative_noise=multiplicative_noise,
                                  round_values=round_values,
                                  noise_sampling=noise_sampling)
        gt_scales = multiscale_targets(clean, no_outputs - 1,
                                       clip_values=True, round_values=True)
        return noisy, gt_scales

    def train_step(state: TrainState, batch: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   depth_weights=None):
        if state.model is not model:
            raise ValueError("the state holds another model than the step "
                             "was built for")
        generator = state.generator if generator is None else generator
        params = list(model.parameters())
        dev = params[0].device
        if depth_weights is None:
            depth_weights = torch.full((no_outputs,), 1.0 / no_outputs,
                                       device=dev)
        depth_weights = torch.as_tensor(depth_weights, dtype=torch.float32,
                                        device=dev)
        batch = batch.to(dev).float()
        if batch.shape[0] % n:
            raise ValueError(f"batch of {batch.shape[0]} does not split into "
                             f"grad_accum={n} micro-batches")
        model.zero_grad(set_to_none=True)
        metrics = {}
        # the step's float32 work (the losses, SSIM's convs, the heads'
        # epilogue and a float32 model) stays float32 on the card
        with exact_float32(dev.type == "cuda"):
            for clean in batch.chunk(n):
                noisy, gt_scales = prepare(state, clean, generator)
                teacher_out = None
                if teacher_fn is not None:
                    with whole_map():       # the teacher sees whole crops
                        teacher_out = teacher_fn(noisy)
                total, m = forward_loss(
                    model, loss_fns, no_outputs, noisy, gt_scales,
                    depth_weights, generator, remat=remat,
                    teacher_out=teacher_out, distill_weight=distill_weight,
                    gt_weight=distill_gt_weight)
                total.backward()
                for k, v in m.items():
                    metrics[k] = metrics.get(k, 0.0) + v.detach()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if n > 1:
            torch._foreach_div_(grads, float(n))
            metrics = {k: v / n for k, v in metrics.items()}
        shard, spatial = current_batch_shard(), current_spatial_shard()
        if spatial is not None:
            # sums over 'spatial', means over the batch axes: one
            # all_reduce of the gradients and the metrics together
            reduce_mean_(grads + list(metrics.values()),
                         spatial.reduce_group, spatial.batch_count)
        elif shard is not None and shard.group is not None:
            # the means over the batch axes
            reduce_mean_(grads + list(metrics.values()), shard.group,
                         shard.count)
        metrics["grad_norm"] = global_norm(grads)
        if grad_stats:
            metrics["grad_stats"] = {
                name.replace(".", "/"): five_numbers(g)
                for (name, _), g in zip(model.named_parameters(), grads)
                if g.ndim in (2, 4)}
        tx.apply(params, grads, state.opt_state)
        if ema_decay > 0.0:
            if state.ema_params is None:
                raise ValueError("ema_decay > 0 but state.ema_params is None: "
                                 "seed it before the first step")
            t = np.float32(state.step)
            d = float(min(np.float32(ema_decay),
                          (np.float32(1.0) + t) / (np.float32(10.0) + t)))
            ema = list(state.ema_params.values())
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, [p.detach() for p in params],
                                alpha=1.0 - d)
        state.step += 1
        return state, metrics

    return train_step


_QUANTILES = np.asarray([0.0, 0.25, 0.5, 0.75, 1.0], np.float32)


def five_numbers(g: torch.Tensor) -> torch.Tensor:
    """[min, p25, p50, p75, max] of a tensor's values, float32, as
    ``jnp.percentile(..., [0, 25, 50, 75, 100])`` (linear interpolation
    between the two nearest ranks). Sorts, since ``torch.quantile``
    refuses more than 2^24 elements; the ranks are fixed by the size, so
    nothing is read back to the host."""
    v = torch.sort(g.detach().float().flatten()).values
    q = _QUANTILES * np.float32(v.numel() - 1)
    lo, hi = np.floor(q), np.ceil(q)
    w = q - lo
    return torch.stack([v[int(a)] * float(np.float32(1.0) - b)
                        + v[int(c)] * float(b)
                        for a, c, b in zip(lo, hi, w)])


def build_eval_step(model):
    """Returns ``eval_step(state, noisy) -> outputs[0]``: the finest-scale
    denoised NHWC float32 batch of ``noisy`` [B, H, W, C] float32, the
    model in inference mode with the state's params."""

    def eval_step(state: TrainState, noisy: torch.Tensor) -> torch.Tensor:
        if state.model is not model:
            raise ValueError("the state holds another model than the step "
                             "was built for")
        with torch.no_grad():
            outputs = model(nchw(noisy), train=False)
        return nhwc(outputs[0]).float()

    return eval_step
