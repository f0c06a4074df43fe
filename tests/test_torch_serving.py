"""The port's serving frontend (``blind_image_denoising_torch/serving.py``)
through the eight cases of ``tests/test_serving.py``: micro-batching,
mixed shapes and errors, the HTTP endpoint (PIL encodes the images),
``warm``'s buckets, the backlog order, ``close``, a TTA ``Denoiser``
behind the batcher answering as it does alone, and the dispatch/fetch
pipeline overlapping batches. Plus the port's own: a ``Denoiser``'s
device tensors come back through ``HostCopy``, and buckets repeat the
last image."""

import io
import threading
import urllib.request

import numpy as np
import pytest

from blind_image_denoising_torch.serving import BatchingDenoiser


class _RecordingDenoiser:
    """Identity 'model' that records the batch sizes it was called with."""

    def __init__(self):
        self.batch_sizes = []
        self.lock = threading.Lock()

    def __call__(self, batch):
        with self.lock:
            self.batch_sizes.append(batch.shape[0])
        return batch + 1  # visible transformation


def test_batching_groups_concurrent_requests():
    model = _RecordingDenoiser()
    b = BatchingDenoiser(model, max_batch=8, max_wait_ms=50.0)
    try:
        imgs = [np.full((8, 8, 3), i, np.uint8) for i in range(8)]
        results = [None] * 8

        def call(i):
            results[i] = b(imgs[i])

        threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, r in enumerate(results):
            np.testing.assert_array_equal(r, imgs[i] + 1)
        # concurrency actually batched: fewer calls than requests
        assert sum(model.batch_sizes) == 8
        assert len(model.batch_sizes) < 8
    finally:
        b.close()


def test_batching_mixed_shapes_and_errors():
    model = _RecordingDenoiser()
    b = BatchingDenoiser(model, max_batch=4, max_wait_ms=20.0)
    try:
        a = b(np.zeros((8, 8, 3), np.uint8))
        c = b(np.zeros((16, 8, 3), np.uint8))
        assert a.shape == (8, 8, 3) and c.shape == (16, 8, 3)
    finally:
        b.close()

    def broken(batch):
        raise RuntimeError("device on fire")

    b2 = BatchingDenoiser(broken, max_batch=2, max_wait_ms=5.0)
    try:
        with pytest.raises(RuntimeError, match="device on fire"):
            b2(np.zeros((4, 4, 3), np.uint8))
    finally:
        b2.close()


def test_http_endpoint_roundtrip():
    from http.server import ThreadingHTTPServer
    from PIL import Image
    from blind_image_denoising_torch.serving import _make_handler

    model = _RecordingDenoiser()
    batcher = BatchingDenoiser(model, max_batch=4, max_wait_ms=5.0)
    server = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(batcher))
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            assert r.read() == b"ok"

        img = np.random.default_rng(0).integers(0, 200, (12, 10, 3), np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/denoise", data=buf.getvalue(),
            method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            out = np.asarray(Image.open(io.BytesIO(r.read())))
        np.testing.assert_array_equal(out, img + 1)

        # malformed body → 400, server stays alive
        bad = urllib.request.Request(
            f"http://127.0.0.1:{port}/denoise", data=b"junk", method="POST")
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(bad, timeout=10)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            assert r.read() == b"ok"
    finally:
        server.shutdown()
        batcher.close()


def test_warm_covers_non_pow2_max_batch():
    """warm() must precompile every bucket _run can form — including
    max_batch itself when it is not a power of two (run-time bucket
    clamping makes it reachable)."""
    model = _RecordingDenoiser()
    b = BatchingDenoiser(model, max_batch=3)
    try:
        b.warm((8, 8, 3))
        assert model.batch_sizes == [1, 2, 3]
    finally:
        b.close()


def test_minority_shape_not_starved_by_majority_flood():
    """The oldest waiter's shape wins each round: one 16x16 request
    submitted during a sustained 8x8 flood must complete long before the
    flood ends (a requeue-at-tail policy would starve it)."""
    import time

    def slow_model(batch):
        time.sleep(0.02)
        return batch

    b = BatchingDenoiser(slow_model, max_batch=4, max_wait_ms=5.0)
    stop = threading.Event()

    def flood():
        while not stop.is_set():
            try:
                b(np.zeros((8, 8, 3), np.uint8))
            except RuntimeError:
                return

    floods = [threading.Thread(target=flood) for _ in range(6)]
    try:
        for t in floods:
            t.start()
        time.sleep(0.1)   # flood established
        t0 = time.monotonic()
        out = b(np.zeros((16, 16, 3), np.uint8))
        latency = time.monotonic() - t0
        assert out.shape == (16, 16, 3)
        # generous bound: one or two rounds of 4x slow batches, not the
        # length of the flood
        assert latency < 2.0, latency
    finally:
        stop.set()
        for t in floods:
            t.join(timeout=5)
        b.close()


def test_close_unblocks_queued_callers():
    """close() must never strand a caller: every request issued before
    close() either completes (the pipelined batcher drains batches it
    already dispatched) or fails with a clean
    RuntimeError; calls after close() raise immediately."""
    import time

    release = threading.Event()

    def gated_model(batch):
        release.wait(timeout=5)
        return batch

    b = BatchingDenoiser(gated_model, max_batch=1, max_wait_ms=1.0,
                         pipeline_depth=1)
    outcomes = []

    def call():
        try:
            outcomes.append(("ok", b(np.zeros((8, 8, 3), np.uint8))))
        except BaseException as e:
            outcomes.append(("err", e))

    # first request occupies the fetch stage inside gated_model; the
    # rest fill the pipeline / queue behind it
    t1 = threading.Thread(target=call)
    t1.start()
    time.sleep(0.1)
    queued = [threading.Thread(target=call) for _ in range(3)]
    for t in queued:
        t.start()
    time.sleep(0.1)

    closer = threading.Thread(target=b.close)
    closer.start()
    time.sleep(0.1)
    release.set()   # let the gated batches finish
    closer.join(timeout=15)
    t1.join(timeout=5)
    for t in queued:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in queued), "queued caller stranded"
    assert len(outcomes) == 4
    for kind, val in outcomes:
        if kind == "ok":
            assert val.shape == (8, 8, 3)
        else:
            assert isinstance(val, RuntimeError)

    with pytest.raises(RuntimeError, match="closed"):
        b(np.zeros((8, 8, 3), np.uint8))


def test_batching_over_tta_denoiser_exact():
    """The batcher composes with a real TTA Denoiser: batched answers are
    bitwise the TTA ensemble's single-request answers (the batch goes
    through ``dispatch`` and comes back through ``HostCopy``)."""
    import copy
    import jax
    from conftest import TINY_RESNET_MODEL, tiny_resnet_hydra
    from blind_image_denoising_torch.inference.denoiser import Denoiser
    from blind_image_denoising_torch.models.hydra import model_builder

    _, variables = tiny_resnet_hydra()
    tta = Denoiser(model_builder(copy.deepcopy(TINY_RESNET_MODEL)).hydra,
                   jax.tree_util.tree_map(np.asarray, variables),
                   pad_mode="multiple", pad_multiple=16, tta=True,
                   device="cpu")
    b = BatchingDenoiser(tta, max_batch=4, max_wait_ms=20.0)
    imgs = [np.random.default_rng(i).integers(0, 256, (24, 24, 3),
                                              dtype=np.uint8)
            for i in range(4)]
    results = [None] * 4
    threads = [threading.Thread(
        target=lambda i=i: results.__setitem__(i, b(imgs[i])))
        for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    b.close()
    for img, got in zip(imgs, results):
        np.testing.assert_array_equal(got, tta(img))


def test_pipeline_overlaps_dispatched_batches():
    """With a dispatch-capable denoiser (the Denoiser seam), the batcher
    keeps `pipeline_depth` batches in flight: N batches of device time T
    complete in ~T + N*epsilon wall, not N*T (a synchronous batcher's
    serial floor). Fake device: dispatch() starts the work on a thread,
    np.asarray() joins it — the same enqueue/force split the real
    Denoiser's dispatch and HostCopy give."""
    import time

    T = 0.15

    class _Handle:
        def __init__(self, batch):
            self._out = None

            def work():
                time.sleep(T)
                self._out = batch

            self._t = threading.Thread(target=work)
            self._t.start()

        def __array__(self, dtype=None, copy=None):
            self._t.join()
            return self._out

    class _FakeDeviceDenoiser:
        def dispatch(self, batch):
            return _Handle(batch)

        def __call__(self, batch):
            return np.asarray(self.dispatch(batch))

    b = BatchingDenoiser(_FakeDeviceDenoiser(), max_batch=1,
                         max_wait_ms=0.5, pipeline_depth=4)
    try:
        n = 4
        results = [None] * n
        threads = [threading.Thread(
            target=lambda i=i: results.__setitem__(
                i, b(np.full((4, 4, 3), i, np.uint8)))) for i in range(n)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        wall = time.monotonic() - t0
        for i, r in enumerate(results):
            assert r is not None and int(r[0, 0, 0]) == i
        # serial floor is n*T = 0.6 s; pipelined should be ~T plus
        # scheduling slack. 2.5*T is a generous single-core bound.
        assert wall < 2.5 * T, f"no overlap: {n} batches took {wall:.3f}s"
    finally:
        b.close()


def test_buckets_repeat_the_last_image_and_drop_its_answers():
    """Three concurrent requests form a bucket of 4: the denoiser sees
    the last image twice, and each caller gets its own answer."""
    model = _RecordingDenoiser()
    seen = []

    def recording(batch):
        seen.append(batch.copy())
        return model(batch)

    b = BatchingDenoiser(recording, max_batch=8, max_wait_ms=200.0)
    try:
        imgs = [np.full((4, 4, 3), 10 * i, np.uint8) for i in range(3)]
        results = [None] * 3
        threads = [threading.Thread(
            target=lambda i=i: results.__setitem__(i, b(imgs[i])))
            for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        assert [x.shape[0] for x in seen] == [4]
        np.testing.assert_array_equal(seen[0][3], seen[0][2])
        for img, r in zip(imgs, results):
            np.testing.assert_array_equal(r, img + 1)
    finally:
        b.close()
