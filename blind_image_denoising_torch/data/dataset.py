"""Config-driven training dataset (counterpart of
``blind_image_denoising_tpu/data/dataset.py``, the same code): discovery
→ round-robin multi-dataset merge → threaded decode → random crops →
shuffle → batch. It yields clean float32 [B, H, W, C] batches in
[0, 255]; flips and noise run on the device inside the train step.

The seeding is the JAX package's (``random.Random`` per epoch and per
decode worker, ``np.random.default_rng`` for the synthetic stream), so a
seed gives the same batches; with more than one decode worker the order
in which workers take files, and so which worker's generator crops which
file, depends on the threads' timing, in JAX as here.
"""

import logging
import queue
import random
import threading
from collections import namedtuple
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..parallel import multihost
from .file_operations import (
    image_filenames, load_image, merge_iterators, shard_files_for_process)

logger = logging.getLogger("blind_image_denoising_torch")

DatasetResults = namedtuple(
    "DatasetResults",
    ["config", "batch_size", "input_shape", "training", "testing"])


def random_crops(image: np.ndarray, crop_size, no_crops: int,
                 rng: random.Random,
                 min_crop_std: float = 0.0,
                 scale_range=None) -> List[np.ndarray]:
    """``no_crops`` random HxW crops (reference utilities.py:466-561 uses
    crop_and_resize with random boxes; plain random windows are equivalent
    for same-size crops). Images smaller than the crop are edge-padded.

    ``min_crop_std`` > 0 rejects near-constant crops (sky, borders): they
    carry no denoising signal and their vanishing variance explodes the
    gradients of bias-free normalization layers. A few re-draws are
    attempted before accepting whatever comes.

    ``scale_range=(lo, hi)`` enables scale-jittered crops: each crop
    samples a window of crop_size·s (s ~ U[lo, hi], clamped to the image)
    and bilinearly resizes it to crop_size — the capability the
    reference's crop_and_resize boxes allow via x_range/y_range
    (utilities.py:505-511; its dataset pipeline leaves them at the
    fixed-size defaults)."""
    ch, cw = int(crop_size[0]), int(crop_size[1])
    h, w = image.shape[:2]
    if h < ch or w < cw:
        pad_h, pad_w = max(0, ch - h), max(0, cw - w)
        # edge padding: 'reflect' raises when the pad exceeds dim-1 (tiny
        # thumbnails vs large crops)
        image = np.pad(image, ((0, pad_h), (0, pad_w), (0, 0)), mode="edge")
        h, w = image.shape[:2]
    use_scale = (scale_range is not None
                 and (scale_range[0] != 1.0 or scale_range[1] != 1.0))
    crops = []
    for _ in range(no_crops):
        crop = None
        for _attempt in range(4 if min_crop_std > 0 else 1):
            if use_scale:
                s = rng.uniform(float(scale_range[0]), float(scale_range[1]))
                wh = min(h, max(1, int(round(ch * s))))
                ww = min(w, max(1, int(round(cw * s))))
            else:
                wh, ww = ch, cw
            y = rng.randint(0, h - wh)
            x = rng.randint(0, w - ww)
            crop = image[y:y + wh, x:x + ww]
            if (wh, ww) != (ch, cw):
                crop = _resize_bilinear(crop, ch, cw)
            if min_crop_std <= 0 or crop.std() >= min_crop_std:
                break
        crops.append(crop)
    return crops


def _resize_bilinear(image: np.ndarray, th: int, tw: int) -> np.ndarray:
    """Bilinear HWC resize via PIL, preserving float range."""
    from PIL import Image
    chans = [np.asarray(
        Image.fromarray(image[:, :, c].astype(np.float32), mode="F")
        .resize((tw, th), Image.BILINEAR))
        for c in range(image.shape[2])]
    return np.stack(chans, axis=-1).astype(image.dtype)


class _EpochIterable:
    """One pass over all files per iteration, reshuffled each epoch and
    decoded by a thread pool with bounded prefetch.

    ``files`` may be a list of paths or a list of per-dataset path lists;
    multiple datasets are merged ROUND-ROBIN each epoch (each shuffled
    independently, then interleaved 1:1 until exhaustion) — the reference's
    multi-input mixing semantics (file_operations.py:21-96): small datasets
    are oversampled relative to their size early in the epoch rather than
    drowned by large ones."""

    # small datasets get their decoded images cached in RAM — re-decoding
    # the same files every epoch would leave the device idle
    CACHE_LIMIT_BYTES = 2 << 30

    def __init__(self, files: Sequence, batch_size: int, crop_size,
                 no_crops_per_image: int, num_channels: int,
                 seed: int = 0, num_workers: int = 8,
                 prefetch_batches: int = 4,
                 min_crop_std: float = 0.0,
                 repeat: bool = False,
                 scale_range=None):
        if files and isinstance(files[0], (list, tuple)):
            self._file_groups = [list(g) for g in files if g]
        else:
            self._file_groups = [list(files)] if files else []
        self._batch_size = batch_size
        self._crop_size = crop_size
        self._no_crops = no_crops_per_image
        self._channels = num_channels
        self._seed = seed
        self._epoch = 0
        self._workers = num_workers
        self._prefetch = prefetch_batches
        self._min_crop_std = min_crop_std
        self._repeat = repeat
        self._scale_range = scale_range
        self._cache: dict = {}
        self._cache_bytes = 0
        self._cache_full = False

    def _epoch_order(self, rng: random.Random) -> List[str]:
        """Shuffle each dataset independently, then round-robin merge."""
        groups = [list(g) for g in self._file_groups]
        for g in groups:
            rng.shuffle(g)
        if len(groups) == 1:
            return groups[0]
        return list(merge_iterators(*groups))

    def __iter__(self) -> Iterator[np.ndarray]:
        self._epoch += 1
        rng = random.Random(self._seed + self._epoch)
        files = self._epoch_order(rng)

        out_q: "queue.Queue" = queue.Queue(
            maxsize=self._prefetch * self._batch_size + self._batch_size)
        stop = threading.Event()
        state = {"it": iter(files), "round": 0}
        lock = threading.Lock()

        def next_path():
            # repeat mode: reshuffle and loop forever (the reference's
            # per-epoch re-iteration costs a pipeline restart; production
            # multi-epoch runs stream continuously instead)
            with lock:
                path = next(state["it"], None)
                if path is None and self._repeat:
                    state["round"] += 1
                    round_rng = random.Random(
                        (self._seed, self._epoch, state["round"]).__hash__())
                    state["it"] = iter(self._epoch_order(round_rng))
                    path = next(state["it"], None)
                return path

        def worker(worker_id: int):
            wrng = random.Random(
                (self._seed, self._epoch, worker_id).__hash__())
            try:
                while not stop.is_set():
                    path = next_path()
                    if path is None:
                        return
                    try:
                        img = self._cache.get(path)
                        if img is None:
                            img = load_image(path,
                                             num_channels=self._channels,
                                             dtype=np.float32)
                            # bookkeeping under the lock: racing unlocked
                            # += from N workers loses updates and lets the
                            # cache overshoot its byte limit
                            with lock:
                                if not self._cache_full:
                                    self._cache[path] = img
                                    self._cache_bytes += img.nbytes
                                    if (self._cache_bytes
                                            > self.CACHE_LIMIT_BYTES):
                                        self._cache_full = True
                        crops = random_crops(img, self._crop_size,
                                             self._no_crops, wrng,
                                             min_crop_std=self._min_crop_std,
                                             scale_range=self._scale_range)
                    except Exception as e:  # corrupt/undersized file: skip
                        logger.warning(f"skipping [{path}]: {e}")
                        continue
                    for crop in crops:
                        out_q.put(np.ascontiguousarray(crop))
            finally:
                # the end sentinel must arrive even if this worker dies,
                # or the consumer blocks forever waiting for it
                out_q.put(None)

        threads = [threading.Thread(target=worker, args=(i,), daemon=True)
                   for i in range(self._workers)]
        for t in threads:
            t.start()

        try:
            done_workers = 0
            buf: List[np.ndarray] = []
            while done_workers < self._workers:
                item = out_q.get()
                if item is None:
                    done_workers += 1
                    continue
                buf.append(item)
                if len(buf) >= self._batch_size:
                    rng.shuffle(buf)
                    yield np.stack(buf[: self._batch_size], axis=0)
                    buf = buf[self._batch_size:]
            # drop remainder (reference batches with drop_remainder=True)
        finally:
            stop.set()
            # unblock workers stuck in out_q.put() on the bounded queue
            # (early consumer exit, e.g. total_steps reached), then join —
            # otherwise 8 threads + a queue of crops leak per aborted epoch
            for t in threads:
                while t.is_alive():
                    try:
                        while True:
                            out_q.get_nowait()
                    except queue.Empty:
                        pass
                    t.join(timeout=0.05)


class SyntheticDataset:
    """Deterministic synthetic image stream for tests/benchmarks when no
    dataset directories exist: smooth random gradients + shapes, [0, 255]."""

    def __init__(self, batch_size: int, crop_size, num_channels: int = 3,
                 batches_per_epoch: int = 16, seed: int = 0,
                 repeat: bool = False):
        self._bs = batch_size
        self._hw = (int(crop_size[0]), int(crop_size[1]))
        self._c = num_channels
        self._n = batches_per_epoch
        self._seed = seed
        # repeat mode: one endless stream — the epoch loop never restarts
        # the pipeline (same contract as _EpochIterable repeat)
        self._repeat = repeat

    def __iter__(self):
        rng = np.random.default_rng(self._seed)
        h, w = self._hw
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        count = 0
        while self._repeat or count < self._n:
            count += 1
            batch = np.empty((self._bs, h, w, self._c), np.float32)
            for b in range(self._bs):
                fx, fy = rng.uniform(0.5, 4.0, 2)
                phase = rng.uniform(0, 2 * np.pi, 2)
                base = (np.sin(2 * np.pi * fx * xx / w + phase[0])
                        + np.cos(2 * np.pi * fy * yy / h + phase[1]))
                img = (base - base.min()) / max(float(np.ptp(base)), 1e-6)
                for c in range(self._c):
                    gain = rng.uniform(0.6, 1.0)
                    batch[b, :, :, c] = np.round(img * 255.0 * gain)
            yield batch


def dataset_builder(config: Dict) -> DatasetResults:
    """Build the training data stream from a ``dataset`` config section.
    Image directories with no decodable image leave the synthetic
    stream, as in the JAX package. ``process_count`` / ``process_index``
    in the config select a per-process file shard (default: the process
    group's)."""
    batch_size = config["batch_size"]
    input_shape = list(config["input_shape"])
    color_mode = (config.get("color_mode", "rgb") or "rgb").strip().lower()
    num_channels = {"rgb": 3, "rgba": 4, "grayscale": 1}[color_mode]
    no_crops = max(1, int(config.get("no_crops_per_image", 1)))
    crop_size = (input_shape[0], input_shape[1])

    directories = [i["directory"] for i in config.get("inputs", [])]
    file_groups: List[List[str]] = []
    for d in directories:
        found = image_filenames(d)
        logger.info(f"dataset dir [{d}]: {len(found)} images")
        if found:
            file_groups.append(found)

    # several processes: each rank decodes a disjoint per-dataset file
    # shard; the config keys override the process group's (tests, manual
    # launches)
    proc_count = config.get("process_count")
    proc_index = config.get("process_index")
    proc_count = int(multihost.process_count() if proc_count is None
                     else proc_count)
    proc_index = int(multihost.process_index() if proc_index is None
                     else proc_index)
    if proc_count > 1:
        file_groups = shard_files_for_process(file_groups, proc_index,
                                              proc_count)
        logger.info(f"process {proc_index}/{proc_count}: "
                    f"{sum(len(g) for g in file_groups)} files after "
                    f"sharding")

    if file_groups:
        training = _EpochIterable(
            file_groups, batch_size=batch_size, crop_size=crop_size,
            no_crops_per_image=no_crops, num_channels=num_channels,
            min_crop_std=float(config.get("min_crop_std", 0.0)),
            repeat=bool(config.get("repeat", False)),
            scale_range=config.get("crop_scale_range"))
    else:
        logger.warning("no dataset images found; using synthetic stream")
        training = SyntheticDataset(batch_size, crop_size, num_channels,
                                    repeat=bool(config.get("repeat", False)))

    return DatasetResults(
        config=config,
        batch_size=batch_size,
        input_shape=input_shape,
        training=training,
        testing=None)
