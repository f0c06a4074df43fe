"""Serving frontend: request batching over a loaded denoiser (counterpart
of ``blind_image_denoising_tpu/serving.py``).

* :class:`BatchingDenoiser` — thread-safe micro-batcher: concurrent
  callers' single images are grouped (same shape) into one device batch,
  up to ``max_batch`` or ``max_wait_ms``, and answered one by one.
* :func:`main` — a minimal stdlib HTTP server (``python -m
  blind_image_denoising_torch.serving --model <name-or-dir>``): POST a
  PNG/JPEG body to ``/denoise`` → PNG response; GET ``/healthz`` → ok.
  It needs PIL for the image codecs.

Only same-shape requests batch together; mixed traffic forms one batch
per shape. With a :class:`~.inference.denoiser.Denoiser` the batcher is a
two-stage pipeline: one thread forms a batch, enqueues it on the card
(``Denoiser.dispatch``) and starts its copy back into pinned memory
(``HostCopy``), all without a host sync; a second thread waits for each
batch's copy and answers its callers, so batch N+1 is uploaded and
computed while batch N comes back.
"""

import argparse
import collections
import io
import logging
import queue
import sys
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from .inference.denoiser import HostCopy
from .ops.padding import next_power_of_2

logger = logging.getLogger("blind_image_denoising_torch")


class _Pending:
    __slots__ = ("image", "event", "result", "error")

    def __init__(self, image):
        self.image = image
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class BatchingDenoiser:
    """Groups concurrent single-image requests into device batches.

    ``denoiser``: any callable taking uint8 [B, H, W, C] → [B, H, W, C]
    (e.g. ``bidt.load_model(...)``); one with a ``dispatch`` method is
    pipelined (module docstring). ``pipeline_depth``: dispatched batches
    that may wait between the two stages. ``pad_batches`` rounds every
    batch up to a power-of-two bucket (clamped to ``max_batch``),
    repeating its last image and discarding the extra outputs, so a
    shape meets at most log2(max_batch) + 2 batch sizes.
    """

    def __init__(self, denoiser: Callable, max_batch: int = 32,
                 max_wait_ms: float = 5.0, pad_batches: bool = True,
                 pipeline_depth: int = 2):
        self._denoiser = denoiser
        self._max_batch = int(max_batch)
        self._max_wait = float(max_wait_ms) / 1e3
        self._depth = max(1, int(pipeline_depth))
        self._inflight: "queue.Queue" = queue.Queue(maxsize=self._depth)
        self._pad_batches = bool(pad_batches)
        self._q: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        # requests deferred from earlier rounds, oldest first: the next
        # round batches the OLDEST waiter's shape, so a minority shape is
        # not starved by sustained majority-shape traffic
        self._backlog: "collections.deque[_Pending]" = collections.deque()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._fetcher = threading.Thread(target=self._fetch_loop,
                                         daemon=True)
        self._worker.start()
        self._fetcher.start()

    def close(self):
        """Stop the workers and fail any still-queued requests (callers
        blocked in __call__ get a RuntimeError instead of hanging)."""
        self._stop.set()
        self._q.put(None)   # wake the dispatcher if blocked on get()
        self._worker.join(timeout=10.0)
        self._inflight.put(None)   # wake the fetcher after the dispatcher
        self._fetcher.join(timeout=10.0)
        self._fail_pending(RuntimeError("BatchingDenoiser is closed"))

    def _fail_pending(self, err: BaseException) -> None:
        pending = list(self._backlog)
        self._backlog.clear()
        while True:
            try:
                p = self._q.get_nowait()
            except queue.Empty:
                break
            if p is not None:
                pending.append(p)
        while True:
            try:
                item = self._inflight.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                pending.extend(item[0])
        for p in pending:
            p.error = err
            p.event.set()

    def warm(self, shape) -> None:
        """Run every batch bucket once for one image shape [H, W, C]: the
        first call of a shape builds the kernels and picks cuDNN's
        algorithms, which a serving process pays at start-up."""
        sizes = []
        b = 1
        while b < self._max_batch:
            sizes.append(b)
            b *= 2
        # _run clamps every bucket to max_batch, so a non-power-of-two
        # max_batch is itself a reachable bucket size
        sizes.append(self._max_batch)
        for b in sizes:
            self._denoiser(np.zeros((b,) + tuple(shape), np.uint8))

    def __call__(self, image: np.ndarray) -> np.ndarray:
        """image: uint8 [H, W, C]; blocks until the batch containing it
        has been denoised."""
        if self._stop.is_set():
            raise RuntimeError("BatchingDenoiser is closed")
        p = _Pending(np.asarray(image))
        self._q.put(p)
        # periodic liveness check: a request enqueued concurrently with
        # close() could otherwise miss the drain and wait forever
        while not p.event.wait(timeout=1.0):
            if self._stop.is_set() and not self._worker.is_alive():
                self._fail_pending(
                    RuntimeError("BatchingDenoiser is closed"))
                if not p.event.is_set():
                    raise RuntimeError("BatchingDenoiser is closed")
        if p.error is not None:
            raise p.error
        return p.result

    # ---- dispatch stage --------------------------------------------------

    def _take_matching(self, batch, shape) -> None:
        """Move backlog entries matching ``shape`` into ``batch``, keeping
        the arrival order of everything left behind."""
        kept = collections.deque()
        while self._backlog:
            p = self._backlog.popleft()
            if len(batch) < self._max_batch and p.image.shape == shape:
                batch.append(p)
            else:
                kept.append(p)
        self._backlog = kept

    def _collect(self):
        """One batch of same-shape requests. The oldest waiting request's
        shape wins the round; other shapes stay in the backlog in arrival
        order for the next round."""
        if not self._backlog:
            try:
                p = self._q.get(timeout=0.2)
            except queue.Empty:
                return None
            if p is None:   # close() sentinel
                return None
            self._backlog.append(p)
        first = self._backlog.popleft()
        batch = [first]
        shape = first.image.shape
        t0 = time.monotonic()
        while len(batch) < self._max_batch:
            self._take_matching(batch, shape)
            if len(batch) >= self._max_batch:
                break
            remaining = self._max_wait - (time.monotonic() - t0)
            if remaining <= 0:
                break
            try:
                p = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if p is None:
                break
            self._backlog.append(p)
        return batch

    def _run(self):
        """Form batches and enqueue them: with ``dispatch`` the batch is
        enqueued on the device and its copy back started here, without a
        host sync; a plain callable runs in the fetch stage instead."""
        dispatch = getattr(self._denoiser, "dispatch", None)
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            try:
                stacked = np.stack([p.image for p in batch], axis=0)
                n = stacked.shape[0]
                if self._pad_batches and n > 1:
                    # the ladder warm() runs: powers of two clamped to
                    # max_batch
                    bucket = min(next_power_of_2(n), self._max_batch)
                    if bucket > n:
                        fill = np.repeat(stacked[-1:], bucket - n, axis=0)
                        stacked = np.concatenate([stacked, fill], axis=0)
                if dispatch is not None:
                    pending = dispatch(stacked)
                    if isinstance(pending, torch.Tensor):
                        pending = HostCopy(pending)
                else:
                    pending = stacked
            except BaseException as e:  # deliver the failure to callers
                for p in batch:
                    p.error = e
                    p.event.set()
                continue
            # blocks when `pipeline_depth` batches are already waiting:
            # the backpressure that bounds device and host memory
            self._inflight.put((batch, pending))

    # ---- fetch stage -----------------------------------------------------

    def _fetch_loop(self):
        """Bring each in-flight batch back to the host and answer its
        requests."""
        dispatch = getattr(self._denoiser, "dispatch", None)
        while True:
            item = self._inflight.get()
            if item is None:
                return
            batch, pending = item
            try:
                out = np.asarray(pending) if dispatch is not None \
                    else np.asarray(self._denoiser(pending))
                for i, p in enumerate(batch):
                    p.result = out[i]
            except BaseException as e:
                for p in batch:
                    p.error = e
            finally:
                for p in batch:
                    p.event.set()


# ---- stdlib HTTP endpoint ------------------------------------------------

def _make_handler(batcher: BatchingDenoiser):
    from http.server import BaseHTTPRequestHandler
    from PIL import Image

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through our logger
            logger.info("serving: " + fmt % args)

        def do_GET(self):
            if self.path == "/healthz":
                body = b"ok"
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path != "/denoise":
                self.send_error(404)
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                img = Image.open(io.BytesIO(self.rfile.read(n))).convert("RGB")
                out = batcher(np.asarray(img, np.uint8))
                buf = io.BytesIO()
                Image.fromarray(out).save(buf, format="PNG")
                body = buf.getvalue()
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except Exception as e:
                logger.warning(f"serving error: {e}")
                self.send_error(400, str(e))

    return Handler


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="batched denoising server")
    parser.add_argument("--model", required=True,
                        help="registry name or artifact directory")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", default=8000, type=int)
    parser.add_argument("--max-batch", default=32, type=int)
    parser.add_argument("--max-wait-ms", default=5.0, type=float)
    parser.add_argument("--pipeline-depth", default=2, type=int,
                        help="dispatched batches waiting between the "
                             "dispatch and fetch stages")
    parser.add_argument("--device", default=None,
                        help="torch device; default the card ('cpu' to run "
                             "on the CPU)")
    parser.add_argument("--quant", action="store_true",
                        help="serve the artifact's int8 path (needs "
                             "quant.msgpack)")
    parser.add_argument("--dtype", default=None, type=str,
                        choices=("float32", "bfloat16"),
                        help="serving compute dtype; default the artifact's "
                             "own tpu.compute_dtype (pipeline.json)")
    parser.add_argument("--warm-shape", default=None, type=str,
                        help="run every batch bucket once at start-up for "
                             "an expected image shape, e.g. '256,256,3'")
    parser.add_argument("--blend", nargs="?", const=True, default=None,
                        help="noise-adaptive input blending: bare flag "
                             "requires the artifact's blend.json, or pass "
                             "a table path; default serves a shipped table")
    parser.add_argument("--no-blend", dest="blend", action="store_false",
                        help="disable blending even if the artifact ships "
                             "blend.json")
    args = parser.parse_args(argv)

    import blind_image_denoising_torch as bidt
    from http.server import ThreadingHTTPServer

    batcher = BatchingDenoiser(bidt.load_model(args.model, quant=args.quant,
                                               dtype=args.dtype,
                                               blend=args.blend,
                                               device=args.device),
                               max_batch=args.max_batch,
                               max_wait_ms=args.max_wait_ms,
                               pipeline_depth=args.pipeline_depth)
    if args.warm_shape:
        shape = tuple(int(v) for v in args.warm_shape.split(","))
        logger.info(f"warming batch buckets for shape {shape}")
        batcher.warm(shape)
    server = ThreadingHTTPServer((args.host, args.port),
                                 _make_handler(batcher))
    logger.info(f"serving {args.model} on {args.host}:{args.port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        batcher.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
