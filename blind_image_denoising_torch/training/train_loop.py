"""The training loop (counterpart of
``blind_image_denoising_tpu/training/train_loop.py``):

1. load the config and save the as-run copy (``config.json``);
2. build the dataset, the losses, the optimizer and the hydra (params
   float32, compute in ``tpu.compute_dtype``);
3. restore the latest checkpoint, or load fine-tune weights from an
   artifact directory (``params.msgpack``) or a donor checkpoint (its EMA
   when it has one); seed or drop the weight EMA (``train.ema``);
4. per epoch: the deep-supervision weights, the host pipeline behind
   the device prefetch, and per batch the train step (the stats variant
   with ``grad_stats`` on visualization steps); the metrics of a step are
   copied off the device without waiting and read after the next step is
   queued; on visualization steps the noise sweep on the packaged
   evaluation images at σ ∈ {0, 20, 40, 60, 80} (with the EMA weights
   when tracked), weight statistics and figures; a checkpoint every
   ``checkpoint_every`` steps and per epoch; SIGTERM / SIGINT checkpoint
   and stop without advancing the epoch;
5. after each finished epoch (a ``total_steps`` exit counts as one) and
   every ``train.prune.every_epochs`` epochs, the params and the EMA
   pruned on the host (``pruning.py``), so the export, which prefers the
   EMA, keeps the zeros; the epoch's checkpoint holds the pruned state.

Entry point: :func:`train_loop`, on the card unless ``device="cpu"``.
Under ``dataset.apply_degradations`` the config's degradation keys
reach the train step (rotation and the chain of ``ops/degradations.py``,
the restoration recipe); ``train.distillation`` gives the step a frozen
teacher (``training/distill.py``).

Several processes (``parallel/multihost.initialize`` first, one rank a
device): ``dataset.batch_size`` is the GLOBAL batch; the ranks at one
position along the batch axes (``dcn`` × ``data``) decode the same file
shard at ``batch_size / positions``, each step taking the batch of the
first rank of its spatial group (a broadcast: the decode threads order
crops as they finish), and train under the mesh of ``tpu.mesh`` (JAX's
checks and messages; ``parallel/mesh.py``'s data-parallel step). With
``tpu.mesh.spatial_training`` and spatial > 1 the step also splits each
crop's rows over the 'spatial' ranks (``shard_train_step(spatial=True)``);
without it the spatial ranks replicate the step on the same rows, as
JAX's spatial devices do. The primary rank alone writes
``config.json``, the checkpoints (a barrier follows each save),
``metrics.jsonl``, the figures, the noise sweep's records and the
profile; every rank restores; the pruned weights are broadcast from the
primary.
"""

import contextlib
import json
import logging
import math
import os
import signal
import time
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..config import load_config, save_config
from ..constants import TOTAL_LOSS_STR
from ..data.dataset import dataset_builder
from ..data import prefetch
from ..images import load_evaluation_images
from ..inference.export import resolve_device
from ..models.hydra import model_builder
from ..ops.losses import mae, psnr
from ..ops.noise import corrupt_batch_fixed_std
from ..parallel import multihost
from ..parallel.mesh import (batch_axes, broadcast_over, create_mesh,
                             replicate_sharding, shard_train_step)
from ..pruning import prune_function_builder, prune_params
from ..weights import load_msgpack, params_from_flax
from .checkpoint import CheckpointManager
from .distill import build_teacher
from .losses import loss_function_builder
from .metrics import MetricsWriter
from .optimizer import deep_supervision_schedule_builder, optimizer_builder
from .train_state import TrainState, create_train_state, param_count
from .train_step import build_eval_step, build_train_step

logger = logging.getLogger("blind_image_denoising_torch")

EVAL_NOISE_STDS = (0.0, 20.0, 40.0, 60.0, 80.0)

_NEUTRAL_DEGRADATIONS = {
    "random_rotate": 0.0, "use_random_blur": False, "use_jpeg_noise": False,
    "quantization": -1, "inpaint_drop_rate": 0.0, "degradation_prob": 0.5,
    "degradation_chain_prob": 1.0}


def resolve_degradation_options(dataset_config: Dict) -> Dict:
    """The five degradation keys of a ``dataset`` section (plus their two
    gates) as ``build_train_step`` keyword arguments. They are live only
    under ``dataset.apply_degradations``: every packaged config carries
    values the reference parses but never applies, so without the flag
    they resolve to the neutral values and the run trains the reference
    task."""
    resolved = {
        "random_rotate": float(dataset_config.get("random_rotate") or 0.0),
        "use_random_blur": bool(dataset_config.get("random_blur", False)),
        "use_jpeg_noise": bool(dataset_config.get("use_jpeg_noise", False)),
        "quantization": int(dataset_config.get("quantization") or -1),
        "inpaint_drop_rate": float(
            dataset_config.get("inpaint_drop_rate") or 0.0),
        "degradation_prob": float(
            dataset_config.get("degradation_prob", 0.5)),
        "degradation_chain_prob": float(
            dataset_config.get("degradation_chain_prob", 1.0)),
    }
    active = sorted(k for k, v in resolved.items()
                    if v != _NEUTRAL_DEGRADATIONS[k]
                    and not (k == "quantization" and v <= 1))
    if not bool(dataset_config.get("apply_degradations", False)):
        if active:
            logger.info(
                "dataset config sets %s but dataset.apply_degradations is "
                "not true — inert, matching the reference's behavior; set "
                "\"apply_degradations\": true to train the restoration task",
                ", ".join(active))
        return dict(_NEUTRAL_DEGRADATIONS)
    if active:
        logger.info("on-device degradation chain ACTIVE: %s",
                    ", ".join(active))
    return resolved


def _build_mesh(tpu_config: Dict, batch_size: int, n_proc: int):
    """(the mesh of ``tpu.mesh`` over the process group's ranks, one
    device a rank, with the JAX loop's clamp, checks and messages;
    whether the step is spatially sharded)."""
    mesh_cfg = tpu_config.get("mesh", {"data": -1})
    spatial = int(mesh_cfg.get("spatial", 1))
    dcn = max(1, int(mesh_cfg.get("dcn", 1)))
    data = mesh_cfg.get("data", -1)
    n_dev = n_proc
    if data == -1:
        data = n_dev // (spatial * dcn)
    if batch_size % dcn:
        raise ValueError(f"batch_size {batch_size} not divisible by "
                         f"dcn={dcn} slices")
    # clamp so the ('dcn','data')-sharded batch divides evenly
    data = math.gcd(int(data), batch_size // dcn)
    if n_proc > 1 and dcn * data * spatial != n_dev:
        raise ValueError(
            f"multi-host mesh dcn={dcn} x data={data} x spatial={spatial} "
            f"covers {dcn * data * spatial} of {n_dev} global "
            f"devices (data was clamped to divide batch_size={batch_size}); "
            f"every process must own mesh devices — use a global "
            f"batch_size divisible by "
            f"{n_dev // (spatial * dcn) * dcn} (so 'data' can "
            f"span all devices), or raise tpu.mesh.spatial/dcn so "
            f"dcn*data*spatial covers all {n_dev} devices")
    if dcn * data * spatial < n_dev:
        logger.warning(
            f"mesh dcn={dcn} x data={data} x spatial={spatial} uses "
            f"{dcn * data * spatial} of {n_dev} devices "
            f"(data clamped to divide batch_size={batch_size}); use a "
            f"batch_size divisible by "
            f"{n_dev // (spatial * dcn) * dcn} to engage "
            f"every device")
    mesh = create_mesh(data=data, spatial=spatial, dcn=dcn)
    # tpu.mesh.spatial_training: each crop's rows also split over the
    # 'spatial' ranks inside the step; the spatial ranks of a batch shard
    # read the same rows (the dataset is sharded by the batch axes)
    spatial_training = bool(mesh_cfg.get("spatial_training", False)) \
        and spatial > 1
    if bool(mesh_cfg.get("spatial_training", False)) and not spatial_training:
        logger.warning(
            "tpu.mesh.spatial_training requested but NOT active "
            f"(spatial={spatial}) — it needs spatial > 1; the step will "
            "run without H sharding")
    logger.info(f"mesh: {dict(mesh.shape)} over {n_dev} devices"
                + (f" ({multihost.backend()})" if n_proc > 1 else "")
                + (" (spatially-sharded training)" if spatial_training
                   else ""))
    return mesh, spatial_training


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without the host waiting for the device:
    through pinned memory with a non-blocking copy on the card."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class _PendingMetrics:
    """A step's metrics on their way to the host: stacked into one device
    tensor, copied into pinned memory without waiting, and read (one
    wait on the copy's event) after the next step is queued."""

    def __init__(self, step: int, epoch: int, metrics: Dict):
        self.step, self.epoch = step, epoch
        grad_stats = metrics.pop("grad_stats", None) or {}
        self.names = list(metrics)
        self.stat_names = list(grad_stats)
        flat = torch.cat([torch.stack([metrics[k].float().reshape(())
                                       for k in self.names])]
                         + [grad_stats[k] for k in self.stat_names])
        if flat.is_cuda:
            self.host = torch.empty(flat.shape, dtype=flat.dtype,
                                    pin_memory=True)
            self.host.copy_(flat, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record()
        else:
            self.host, self.done = flat, None

    def read(self):
        """(scalars, grad_stats) as host floats / numpy arrays."""
        if self.done is not None:
            self.done.synchronize()
        values = self.host.numpy()
        n = len(self.names)
        scalars = {k: float(v) for k, v in zip(self.names, values[:n])}
        stats = {k: values[n + 5 * i:n + 5 * i + 5].copy()
                 for i, k in enumerate(self.stat_names)}
        return scalars, stats


@contextlib.contextmanager
def _params_from(model: torch.nn.Module, tensors: Optional[Dict]):
    """Within the block the model's params hold ``tensors`` (a name →
    tensor dict such as ``ema_params``; None: the params themselves)."""
    if tensors is None:
        yield
        return
    params = dict(model.named_parameters())
    saved = {n: p.data for n, p in params.items()}
    for n, p in params.items():
        p.data = tensors[n]
    try:
        yield
    finally:
        for n, p in params.items():
            p.data = saved[n]


def _load_finetune_weights(state: TrainState, weights_directory) -> None:
    """Fine-tune start: the params (and batch statistics, where it has
    them) of an exported artifact directory (``params.msgpack``), or of
    another run's latest checkpoint, its EMA when it tracked one, with
    the checkpoint's batch statistics."""
    artifact = Path(str(weights_directory)) / "params.msgpack"
    if artifact.is_file():
        tree = load_msgpack(artifact)
        # an artifact without batch_stats leaves the batch norms' running
        # statistics at their initial values, as in JAX
        missing, unexpected = state.model.load_state_dict(params_from_flax(
            tree if "params" in tree else {"params": tree}), strict=False)
        buffers = {n for n, _ in state.model.named_buffers()}
        if unexpected or set(missing) - buffers:
            raise ValueError(f"artifact {artifact} does not fit the model: "
                             f"missing {sorted(set(missing) - buffers)}, "
                             f"unexpected {sorted(unexpected)}")
        logger.info(f"loaded fine-tune weights from artifact {artifact}")
        return
    donor = CheckpointManager(str(weights_directory), max_to_keep=1)
    step = donor.latest_step()
    if step is None:
        raise ValueError(f"no params.msgpack and no checkpoint in "
                         f"[{weights_directory}]")
    ckpt = donor.read(step)
    weights = dict(ckpt["model"])
    if ckpt["ema_params"] is not None:
        weights.update(ckpt["ema_params"])
    state.model.load_state_dict(weights, strict=True)
    logger.info(f"loaded fine-tune weights from {weights_directory}"
                + (" (EMA)" if ckpt["ema_params"] is not None else ""))


def train_loop(
        pipeline_config: Union[str, Dict, Path],
        checkpoint_directory: Union[str, Path],
        weights_directory: Union[str, Path, None] = None,
        total_steps_override: Optional[int] = None,
        *, device=None) -> TrainState:
    """Train from a pipeline config into ``checkpoint_directory``
    (checkpoints, ``config.json``, ``metrics.jsonl``, TensorBoard events,
    ``profile/`` when ``train.profile_at_step`` is set), resuming from its
    latest checkpoint. ``weights_directory``: fine-tune start (see
    :func:`_load_finetune_weights`) when no checkpoint exists.
    ``device``: None is the card (raises without one); ``"cpu"`` runs on
    the CPU. Returns the final state."""
    dev = resolve_device(device)
    config = load_config(pipeline_config)

    ckpt_dir = Path(str(checkpoint_directory))
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    primary = multihost.is_primary()
    if primary:
        save_config(config, os.path.join(str(ckpt_dir), "config.json"))

    train_config = config["train"]
    dataset_config = config["dataset"]
    tpu_config = config.get("tpu", {})

    # several processes: batch_size is the GLOBAL batch; the ranks of one
    # position along the batch axes (a spatial group) decode the same file
    # shard, at batch_size over the positions
    n_proc = multihost.process_count()
    batch_size = int(dataset_config["batch_size"])
    mesh, spatial_training = _build_mesh(tpu_config, batch_size, n_proc)
    shared_rows = n_proc > 1 and mesh.shape.get("spatial", 1) > 1
    if n_proc > 1:
        position, positions = mesh.index(batch_axes(mesh))
        if batch_size % positions:
            raise ValueError(
                f"global batch_size {batch_size} not divisible by "
                f"{positions} batch shards")
        if dataset_config.get("inputs") and not dataset_config.get("repeat"):
            # per-rank file shards give different batch counts an epoch,
            # and a rank that runs one extra step leaves its peers'
            # collectives without participants: a deadlock
            raise ValueError(
                "multi-host training requires dataset.repeat=true with "
                "train.total_steps (epoch-bounded per-host file shards "
                "desynchronize the cross-host step count)")
        dataset_config = dict(dataset_config,
                              batch_size=batch_size // positions,
                              process_count=positions,
                              process_index=position)

    dataset = dataset_builder(dataset_config)
    loss_fns = loss_function_builder(config["loss"])
    tx, lr_schedule = optimizer_builder(train_config["optimizer"])
    compute_dtype = tpu_config.get("compute_dtype", "float32")
    dtype = torch.bfloat16 if compute_dtype == "bfloat16" else None
    hydra = model_builder(config["model"], dtype=dtype).hydra
    state = create_train_state(hydra, tx, seed=0, device=dev)
    no_outputs = hydra.no_outputs
    logger.info(f"hydra built: {param_count(state) / 1e3:.1f}k params, "
                f"{no_outputs} output scales")

    manager = CheckpointManager(
        str(ckpt_dir), max_to_keep=train_config.get("checkpoints_to_keep", 3))
    state = manager.restore(state)

    if weights_directory is not None and state.step == 0:
        try:
            _load_finetune_weights(state, weights_directory)
        except (OSError, ValueError, RuntimeError, KeyError) as e:
            logger.warning(f"fine-tune weight load failed ({e}); "
                           f"training from scratch")

    ema_decay = float(train_config.get("ema", 0.0))
    if not 0.0 <= ema_decay < 1.0:
        raise ValueError(f"train.ema must be in [0, 1), got {ema_decay}")
    if ema_decay > 0.0:
        if state.ema_params is None or state.step == 0:
            # a fresh run, fine-tuned weights, or a resume from a
            # checkpoint without an EMA: the average starts at the params
            state.ema_params = {n: p.detach().clone()
                                for n, p in state.params.items()}
        logger.info(f"weight EMA on (decay {ema_decay}, num_updates ramp)")
    elif state.ema_params is not None:
        state.ema_params = None
        logger.info("dropping checkpointed ema_params (train.ema is 0)")

    grad_accum = max(1, int(train_config.get("gpu_batches_per_step", 1)))
    visualization_every = train_config.get("visualization_every", 1000)
    grad_stats = bool(train_config.get("grad_stats",
                                       visualization_every > 0))

    teacher_fn, distill_opts = None, {}
    if train_config.get("distillation"):
        teacher_fn, distill_opts = build_teacher(
            train_config["distillation"], device=dev)

    degradations = resolve_degradation_options(dataset_config)

    def make_step(with_stats: bool):
        return build_train_step(
            hydra, tx, loss_fns, no_outputs=no_outputs,
            additive_noise=dataset_config.get("additional_noise"),
            multiplicative_noise=dataset_config.get("multiplicative_noise"),
            noise_sampling=dataset_config.get("noise_sampling", "uniform"),
            random_left_right=dataset_config.get("random_left_right", True),
            random_up_down=dataset_config.get("random_up_down", True),
            round_values=dataset_config.get("round_values", True),
            grad_accum=grad_accum,
            remat=train_config.get("remat", False),
            use_pallas_noise=tpu_config.get("pallas_noise", False),
            grad_stats=with_stats, teacher_fn=teacher_fn,
            distill_weight=distill_opts.get("weight", 1.0),
            distill_gt_weight=distill_opts.get("gt_weight", 1.0),
            ema_decay=ema_decay, **degradations)

    # the hot step computes no percentiles; the stats variant runs only on
    # the steps whose gradients feed the figures
    train_step = shard_train_step(make_step(False), mesh,
                                  spatial=spatial_training)
    stats_step = (shard_train_step(make_step(True), mesh,
                                   spatial=spatial_training)
                  if grad_stats else None)
    eval_step = build_eval_step(hydra)
    ds_schedule = deep_supervision_schedule_builder(
        train_config.get("deep_supervision", {"type": "linear_low_to_high"}),
        no_outputs=no_outputs)

    eval_batch = (multihost.replicate(
        replicate_sharding(mesh),
        np.asarray(load_evaluation_images(512), np.float32), dev)
        if train_config.get("use_test_images", True) else None)
    writer = MetricsWriter(str(ckpt_dir), enabled=primary)
    writer.text(0, "config", json.dumps(config, indent=2))
    writer.warm()
    if multihost.is_initialized():
        # every rank aligned, and the backend's communicator up, before the
        # first training collective
        multihost.sync("pre_train")

    epochs = train_config.get("epochs", 1)
    total_steps = train_config.get("total_steps", -1)
    if total_steps_override is not None:
        total_steps = total_steps_override
    checkpoint_every = train_config.get("checkpoint_every", -1)
    log_every = max(1, int(train_config.get("log_every", 1)))
    profile_at = train_config.get("profile_at_step", -1)
    repeat_stream = bool(dataset_config.get("repeat", False))

    # the random streams restart from the step, so a resume is seeded as
    # the JAX loop's PRNGKey(step + 1)
    state.generator.manual_seed(state.step + 1)
    state.host_generator.manual_seed(state.step + 1)
    host_step = state.step
    pending: Optional[_PendingMetrics] = None
    last_grad_stats = None
    clock = {"t": time.time(), "step": state.step, "progress": state.step,
             "refresh": -1}

    def process_metrics(p: _PendingMetrics):
        nonlocal last_grad_stats
        scalars, stats = p.read()
        if stats:
            last_grad_stats = stats
        scalars["learning_rate"] = float(lr_schedule(p.step))
        scalars["epoch"] = p.epoch
        now = time.time()
        if now > clock["t"]:
            scalars["steps_per_second"] = \
                (p.step - clock["step"]) / (now - clock["t"])
        clock["t"], clock["step"] = now, p.step
        writer.scalars(p.step, scalars)
        if p.step - clock["progress"] >= 100:
            clock["progress"] = p.step
            logger.info(f"step {p.step}: total "
                        f"{scalars.get(TOTAL_LOSS_STR, float('nan')):.3f} "
                        f"mae0 "
                        f"{scalars.get('scale_0/mae_loss', float('nan')):.3f}")

    preempted = {"flag": False}

    def on_signal(signum, frame):
        logger.warning(f"signal {signum}: checkpointing and stopping")
        preempted["flag"] = True

    prev_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, on_signal)
        except ValueError:              # not the main thread
            pass

    finished = False
    try:
        # epochs -1: epochless (until total_steps or a signal); epochs 0
        # with total_steps > 0: step-bounded and epochless
        epochless = epochs == -1 or (epochs == 0 and total_steps > 0)
        while not finished and (epochless or state.epoch < epochs):
            epoch = state.epoch
            if epochs not in (-1, 0):
                pct_done = epoch / float(epochs)
            elif total_steps > 0:
                pct_done = min(1.0, state.step / float(total_steps))
            else:
                pct_done = 0.0
            weights = np.asarray(ds_schedule(pct_done), np.float32)
            depth_weights = _to_device(weights, dev)
            logger.info(f"epoch {epoch}: deep-supervision weights "
                        f"{np.round(weights, 3).tolist()}")
            batches = prefetch.device_prefetch(
                prefetch.GroupedBatches(dataset.training, grad_accum),
                device=dev, prefetch=2,
                # lossless: the step rounds its inputs
                transfer_dtype=(np.uint8 if dataset_config.get(
                    "round_values", True) else None))
            try:
                for batch in batches:
                    if shared_rows:
                        # the spatial ranks decode the same files, but the
                        # decode threads queue crops as they finish: the
                        # first spatial rank's batch is every one's
                        broadcast_over(mesh, "spatial", batch)
                    # endless streams never finish an epoch: refresh the
                    # ramp from the step every 100 steps
                    if (total_steps > 0
                            and host_step - clock["refresh"] >= 100
                            and (repeat_stream or epochs in (-1, 0))):
                        clock["refresh"] = host_step
                        weights = np.asarray(ds_schedule(min(
                            1.0, host_step / float(total_steps))), np.float32)
                        depth_weights = _to_device(weights, dev)
                    is_viz_step = (eval_batch is not None
                                   and visualization_every > 0
                                   and (host_step + 1)
                                   % visualization_every == 0)
                    step_fn = stats_step if (stats_step is not None
                                             and is_viz_step) else train_step
                    if (profile_at > 0 and host_step + 1 == profile_at
                            and primary):
                        from .profiling import trace
                        with trace(os.path.join(str(ckpt_dir), "profile")):
                            state, metrics = step_fn(
                                state, batch, depth_weights=depth_weights)
                            if dev.type == "cuda":
                                torch.cuda.synchronize(dev)
                    else:
                        state, metrics = step_fn(
                            state, batch, depth_weights=depth_weights)
                    host_step += 1
                    step = host_step
                    # the previous logged step's metrics: their copy ran
                    # behind that step and is read now, with this step
                    # already queued
                    if pending is not None:
                        process_metrics(pending)
                        pending = None
                    if step % log_every == 0 or is_viz_step:
                        pending = _PendingMetrics(step, epoch, metrics)

                    # the sweep and the figures are the primary's: their
                    # writes are no-ops elsewhere and they hold no
                    # collective
                    if (eval_batch is not None and visualization_every > 0
                            and step % visualization_every == 0
                            and primary):
                        if pending is not None:
                            process_metrics(pending)
                            pending = None
                        # evaluate the weights that ship: the EMA when
                        # tracked
                        with _params_from(hydra, state.ema_params):
                            _noise_sweep_eval(
                                eval_step, state, eval_batch, writer, step,
                                max_images=int(train_config.get(
                                    "visualization_number", 4)))
                        _weight_stats(state, writer, step)
                        _weight_figures(state, writer, step)
                        _gradient_figures(last_grad_stats, writer, step)

                    if checkpoint_every > 0 and step % checkpoint_every == 0:
                        manager.save(state, force=True)

                    if preempted["flag"] or (total_steps > 0
                                             and step >= total_steps):
                        finished = True
                        break
            finally:
                batches.close()
                if pending is not None:
                    process_metrics(pending)
                    pending = None

            pruned = False
            if not preempted["flag"]:
                # a signal mid-epoch must not advance the epoch: the
                # resume continues inside it (nor prune); a total_steps
                # exit counts the epoch complete
                state.epoch += 1
                pruned = _maybe_prune(state, train_config.get("prune"))
            # a checkpoint of this step written before the prune is
            # replaced, so a resume starts from the pruned weights
            manager.save(state, force=True, replace=pruned)
    finally:
        manager.save(state, force=True)
        manager.wait()
        writer.close()
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
    return state


def _maybe_prune(state: TrainState, prune_config: Optional[Dict]) -> bool:
    """Prune the params and the EMA in place when ``train.prune`` asks
    for it at this epoch; True when it did."""
    if not prune_config or prune_config.get("strategy", "NONE") == "NONE" \
            or state.epoch % int(prune_config.get("every_epochs", 1)):
        return False
    prune_fn = prune_function_builder(prune_config)
    with torch.no_grad():
        for tensors in (state.params, state.ema_params):
            if tensors is None:
                continue
            # the primary's pruned weights are every rank's
            pruned = multihost.broadcast_from_primary(
                prune_params(tensors, prune_fn))
            for name, t in tensors.items():
                t.copy_(pruned[name])
    logger.info(f"epoch {state.epoch}: pruned weights "
                f"({prune_config.get('strategy')})")
    return True


def _noise_sweep_eval(eval_step, state: TrainState, eval_batch: torch.Tensor,
                      writer: MetricsWriter, step: int,
                      max_images: int = 4) -> None:
    """The fixed-image sweep at σ ∈ ``EVAL_NOISE_STDS``: MAE and PSNR of
    the denoised batch against the clean one, the error and noise
    histograms, and image grids of at most ``max_images``. The noise comes
    from a generator seeded 0 at every σ, as JAX uses one key."""
    clean = eval_batch.cpu().numpy()
    for std in EVAL_NOISE_STDS:
        if std > 0:
            gen = torch.Generator(device=eval_batch.device).manual_seed(0)
            noisy = corrupt_batch_fixed_std(gen, eval_batch, std=std)
        else:
            noisy = eval_batch
        denoised = eval_step(state, noisy)
        writer.scalars(step, {
            f"eval/mae_noise_{int(std)}": float(mae(eval_batch, denoised)),
            f"eval/psnr_noise_{int(std)}": float(psnr(eval_batch, denoised)),
        })
        denoised = denoised.cpu().numpy()
        error = denoised - clean
        writer.histogram(step, f"eval/error_noise_{int(std)}", error)
        if std > 0:
            writer.histogram(step, f"eval/noise_{int(std)}",
                             noisy.cpu().numpy() - clean)
        writer.images(step, f"eval/denoised_noise_{int(std)}",
                      denoised[:max_images])
        if std == EVAL_NOISE_STDS[1]:
            writer.images(step, "eval/noisy",
                          noisy[:max_images].cpu().numpy())
            writer.images(step, "eval/error",
                          np.clip(np.abs(error[:max_images]) * 4.0, 0, 255))


def _weight_figures(state: TrainState, writer: MetricsWriter, step: int):
    """Weight boxplot and histogram heatmap, where matplotlib imports."""
    from ..visualize import weights_boxplot, weights_heatmap
    fig = weights_boxplot(state.params)
    if fig is not None:
        writer.figure(step, "weights/boxplot", fig)
    fig = weights_heatmap(state.params)
    if fig is not None:
        writer.figure(step, "weights/heatmap", fig)


def _gradient_figures(grad_stats, writer: MetricsWriter, step: int):
    """Gradient boxplot and per-tensor medians from the five-number
    summaries of the stats step."""
    if not grad_stats:
        return
    from ..visualize import boxplot_from_stats
    fig = boxplot_from_stats(grad_stats, title="gradients")
    if fig is not None:
        writer.figure(step, "gradients/boxplot", fig)
    writer.scalars(step, {f"gradients/{path}/p50": float(q[2])
                          for path, q in grad_stats.items()})


def _weight_stats(state: TrainState, writer: MetricsWriter, step: int):
    """RMS of every kernel (by flax path) and of all params together."""
    flat = {n.replace(".", "/"): p.detach().float().cpu().numpy()
            for n, p in state.params.items()}
    stats = {f"weights/{path}/rms": float(np.sqrt(np.mean(w ** 2)))
             for path, w in flat.items() if "kernel" in path}
    all_w = np.concatenate([w.ravel() for w in flat.values()]) \
        if flat else np.zeros(1)
    stats["weights/global_rms"] = float(np.sqrt(np.mean(all_w ** 2)))
    writer.scalars(step, stats)
