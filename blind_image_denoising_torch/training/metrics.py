"""Training observability: a JSONL metrics log and, where
``torch.utils.tensorboard`` imports, TensorBoard (counterpart of
``blind_image_denoising_tpu/training/metrics.py``).

``metrics.jsonl`` (one ``{"step", "time", <name>: value}`` object per
line, appended and flushed per record) is the primary sink; TensorBoard
gets the same scalars plus text, images, figures and histograms. Values
arrive on the host: the train loop copies a step's metrics off the
device itself.
"""

import json
import logging
import os
import time
from typing import Dict

import numpy as np

logger = logging.getLogger("blind_image_denoising_torch")


class MetricsWriter:
    def __init__(self, directory: str, enabled: bool = True):
        """``enabled=False`` turns every write into a no-op."""
        self._enabled = enabled
        self._file = None
        self._tb = None
        self._tb_dir = directory
        self._tb_tried = False
        self._pending_text = []
        if not enabled:
            return
        os.makedirs(directory, exist_ok=True)
        self._path = os.path.join(directory, "metrics.jsonl")
        self._file = open(self._path, "a")

    @property
    def _tensorboard(self):
        """The TensorBoard writer, created on first use (its import is
        slow); None where it does not import."""
        if not self._tb_tried:
            self._tb_tried = True
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=self._tb_dir)
            except ImportError:
                logger.info("tensorboard writer unavailable; JSONL only")
            if self._tb is not None:
                for step, tag, content in self._pending_text:
                    self._tb.add_text(tag, content, step)
            self._pending_text.clear()
        return self._tb

    def warm(self):
        """Pay the TensorBoard import now, not inside the step loop."""
        if self._enabled:
            _ = self._tensorboard

    def scalars(self, step: int, values: Dict[str, float],
                prefix: str = ""):
        if not self._enabled:
            return
        rec = {"step": int(step), "time": time.time()}
        tb = self._tensorboard
        for k, v in values.items():
            key = f"{prefix}{k}" if prefix else k
            rec[key] = float(np.asarray(v))
            if tb is not None:
                tb.add_scalar(key, rec[key], int(step))
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()

    def text(self, step: int, tag: str, content: str):
        if not self._enabled:
            return
        if not self._tb_tried:
            # queued until another write creates the TensorBoard writer
            self._pending_text.append((int(step), tag, content))
            return
        if self._tb is not None:
            self._tb.add_text(tag, content, int(step))

    def images(self, step: int, tag: str, batch: np.ndarray):
        """[B, H, W, C] float in [0, 255]."""
        tb = self._tensorboard if self._enabled else None
        if tb is None:
            return
        imgs = np.clip(np.asarray(batch), 0, 255).astype(np.uint8)
        tb.add_images(tag, imgs, int(step), dataformats="NHWC")

    def figure(self, step: int, tag: str, fig):
        tb = self._tensorboard if self._enabled else None
        if tb is not None:
            tb.add_figure(tag, fig, int(step))

    def histogram(self, step: int, tag: str, values: np.ndarray,
                  max_samples: int = 100_000):
        """Value distribution: the histogram to TensorBoard (subsampled
        to ``max_samples``), its [1, 25, 50, 75, 99] percentiles to the
        JSONL log."""
        if not self._enabled:
            return
        flat = np.asarray(values).ravel()
        if flat.size > max_samples:
            flat = flat[:: flat.size // max_samples + 1]
        tb = self._tensorboard
        if tb is not None:
            tb.add_histogram(tag, flat, int(step))
        p = np.percentile(flat, [1, 25, 50, 75, 99])
        self.scalars(step, {f"{tag}/p{q}": float(v)
                            for q, v in zip((1, 25, 50, 75, 99), p)})

    def close(self):
        if self._file is not None:
            self._file.close()
        if self._pending_text:
            # a run that wrote only text must not drop it
            _ = self._tensorboard
        if self._tb is not None:
            self._tb.close()
