"""Profiling and step timing (counterpart of
``blind_image_denoising_tpu/training/profiling.py``):

* :func:`trace` — ``torch.profiler`` over the enclosed block (CPU and,
  on the card, CUDA activity), written to a directory as a Chrome trace
  (``trace.json``) plus ``summary.json``: the block's host-clock span,
  the device's busy time (the sum of the trace's kernel durations), its
  idle share, the number of kernels and the seconds the export took;
* :func:`annotate` — a named range (``torch.profiler.record_function``);
* :class:`StepTimer` — steps/s and images/s (per device) between calls.
"""

import contextlib
import json
import logging
import os
import time
from typing import Optional

import torch

logger = logging.getLogger("blind_image_denoising_torch")


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block into ``log_dir``. The block should end
    with the device idle (the train loop synchronizes inside it), so the
    span covers the work it queued."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    logger.info(f"profiler trace started → {log_dir}")
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield prof
        wall_us = (time.perf_counter() - t0) * 1e6
    t0 = time.perf_counter()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    # the device's busy time from the trace's kernel events (much faster
    # than key_averages() over a step's ~28,000 kernels)
    with open(path) as f:
        kernels = [e for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"]
    busy_us = float(sum(e.get("dur", 0.0) for e in kernels))
    summary = dict(wall_us=wall_us, device_busy_us=busy_us,
                   idle_share=(1.0 - busy_us / wall_us) if busy_us else None,
                   kernels=len(kernels), export_s=time.perf_counter() - t0)
    with open(os.path.join(log_dir, "summary.json"), "w") as f:
        json.dump(summary, f)
    logger.info(f"profiler trace written → {log_dir}: {summary}")


def annotate(name: str):
    """A named range visible in the trace timeline."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Steps/s and images/s over the span since the previous update."""

    def __init__(self, images_per_step: int, n_devices: Optional[int] = None):
        self._images = images_per_step
        self._devices = n_devices or max(1, torch.cuda.device_count())
        self._t0 = time.perf_counter()
        self._steps0 = None

    def update(self, step: int) -> dict:
        now = time.perf_counter()
        if self._steps0 is None:
            self._steps0, self._t0 = step, now
            return {}
        dt = max(now - self._t0, 1e-9)
        dsteps = step - self._steps0
        self._steps0, self._t0 = step, now
        sps = dsteps / dt
        return {
            "steps_per_second": sps,
            "images_per_second": sps * self._images,
            "images_per_second_per_device": sps * self._images
            / self._devices,
        }
