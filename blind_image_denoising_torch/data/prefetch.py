"""Host → device prefetch (counterpart of
``blind_image_denoising_tpu/data/prefetch.py``): overlap batch assembly
and the host → device copy with device compute.

On the card a producer thread fills pinned host buffers and copies each
into a fresh device tensor with ``non_blocking=True`` on a side CUDA
stream; the batch is handed over with the copy's event, which the
consumer's stream waits on before it uses the batch, so the training
thread never waits for a copy on the host. A pinned buffer is refilled
only after the event of its previous copy has completed. On the CPU the
batches are handed over as tensors, in the same order.
"""

import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

THREAD_NAME = "bid-device-prefetch"


class GroupedBatches:
    """Group ``grad_accum`` pipeline batches into one super-batch
    (host-side concat), re-iterable per epoch."""

    def __init__(self, dataset_iterable, grad_accum: int):
        self._ds = dataset_iterable
        self._n = max(1, grad_accum)

    def __iter__(self):
        buf = []
        it = iter(self._ds)
        try:
            for batch in it:
                buf.append(batch)
                if len(buf) == self._n:
                    yield np.concatenate(buf, axis=0) \
                        if self._n > 1 else buf[0]
                    buf = []
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()


class _PinnedRing:
    """Pinned host buffers reused round-robin; each remembers the event of
    the last copy out of it and is refilled only once that completed."""

    def __init__(self, n: int):
        self._n, self._bufs, self._i = n, {}, 0

    def take(self, shape, dtype: torch.dtype):
        ring = self._bufs.setdefault((tuple(shape), dtype), [
            [torch.empty(shape, dtype=dtype, pin_memory=True), None]
            for _ in range(self._n)])
        slot = ring[self._i % self._n]
        self._i += 1
        if slot[1] is not None:
            slot[1].synchronize()
        return slot


def device_prefetch(iterable: Iterable, device=None, prefetch: int = 2,
                    transfer_dtype=None) -> "DevicePrefetch":
    """Device-resident batches of a host iterable of numpy arrays.

    ``device``: the torch device the batches go to. ``prefetch``: batches
    in flight. ``transfer_dtype=np.uint8`` rounds and clips on the host
    and ships uint8 (a quarter of the bytes), lossless whenever the train
    step rounds its inputs anyway (``dataset.round_values``); the step
    widens to float32 on the device. ``close()`` stops the producer
    thread and the upstream pipeline."""
    return DevicePrefetch(iterable, device, prefetch, transfer_dtype)


class DevicePrefetch:
    """The iterator :func:`device_prefetch` returns."""

    def __init__(self, iterable: Iterable, device=None, prefetch: int = 2,
                 transfer_dtype=None):
        self._iterable = iterable
        self._device = torch.device("cpu" if device is None else device)
        self._transfer_dtype = transfer_dtype
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._end = object()
        self._ring = self._stream = None
        if self._device.type == "cuda":
            if self._device.index is None:
                self._device = torch.device("cuda",
                                            torch.cuda.current_device())
            self._ring = _PinnedRing(prefetch + 2)
            self._stream = torch.cuda.Stream(self._device)
        self.thread = threading.Thread(target=self._produce, daemon=True,
                                       name=THREAD_NAME)
        self.thread.start()

    def _put(self, item) -> bool:
        # bounded put that gives up once the consumer is gone
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _to_device(self, item: np.ndarray):
        if self._transfer_dtype is not None:
            item = np.clip(np.round(item), 0, 255).astype(self._transfer_dtype)
        host = torch.from_numpy(np.ascontiguousarray(item))
        if self._ring is None:
            return host.to(self._device), None
        slot = self._ring.take(host.shape, host.dtype)
        slot[0].copy_(host)
        with torch.cuda.stream(self._stream):
            dev = torch.empty(host.shape, dtype=host.dtype,
                              device=self._device)
            dev.copy_(slot[0], non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        slot[1] = done
        return dev, done

    def _produce(self):
        it = iter(self._iterable)
        try:
            if self._ring is not None:
                torch.cuda.set_device(self._device)
            for item in it:
                if self._stop.is_set() or not self._put(
                        self._to_device(item)):
                    break
            self._put(self._end)
        except BaseException as e:          # surfaced in the consumer
            self._put(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    def __iter__(self) -> Iterator[torch.Tensor]:
        return self

    def __next__(self) -> torch.Tensor:
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is self._end:
            self.close()
            raise StopIteration
        if isinstance(item, BaseException):
            self.close()
            raise item
        batch, done = item
        if done is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(done)
            # the batch was allocated on the side stream: keep its memory
            # from being reused there until this stream is done with it
            batch.record_stream(stream)
        return batch

    def close(self, timeout: Optional[float] = 5.0) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout)
