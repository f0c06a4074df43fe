"""The port's input pipeline (``blind_image_denoising_torch/data``) against
the JAX package's, on the CPU, on image files the tests write.

* ``load_image``: bit-equal to JAX's (``np.array_equal``) through the
  native decoder and through PIL, for PNG and JPEG, 1 / 3 / 4 channels,
  with and without resize-with-pad and normalize; the native decoder is
  built under ``blind_image_denoising_torch/_build/``.
* ``image_filenames``, ``merge_iterators``,
  ``image_filenames_generator``, ``shard_files_for_process`` and
  ``load_corner_crops``: equal results.
* ``random_crops``: the same crops (bit-equal) for the same
  ``random.Random`` seed, with ``min_crop_std`` rejections and
  ``crop_scale_range`` resizes.
* ``dataset_builder(...).training``: one epoch (or, with ``repeat``, a
  fixed number of batches) bit-equal to JAX's, in order, on two
  directories merged round-robin. With more than one decode worker the
  order in which the threads take files decides which worker's generator
  crops which file, in JAX as here, so the comparison runs both
  pipelines with one decode worker. ``SyntheticDataset`` bit-equal.
* ``GroupedBatches`` + ``device_prefetch`` on the CPU: the same batches
  in order; the uint8 transfer is lossless on rounded batches; ``close``
  stops the producer thread within its timeout.
"""

import random
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from blind_image_denoising_tpu.data import dataset as jax_dataset
from blind_image_denoising_tpu.data import file_operations as jax_files
from blind_image_denoising_tpu.data import native_decode as jax_native
from blind_image_denoising_tpu.data import prefetch as jax_prefetch
from blind_image_denoising_torch.data import dataset, file_operations
from blind_image_denoising_torch.data import native_decode, prefetch


def _write_images(directory, n, seed, sizes=((40, 90), (40, 90)),
                  fmt="png"):
    rng = np.random.default_rng(seed)
    directory.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        h, w = (int(rng.integers(*sizes[0])), int(rng.integers(*sizes[1])))
        # smooth fields with edges, so min_crop_std has something to reject
        yy, xx = np.mgrid[0:h, 0:w]
        base = 127 + 100 * np.sin(xx / rng.uniform(3, 20)
                                  + yy / rng.uniform(3, 20))
        img = np.clip(base[..., None] + rng.normal(0, 8, (h, w, 3)), 0, 255)
        if i % 3 == 0:
            img[: h // 2] = 200.0             # a flat region
        Image.fromarray(img.astype(np.uint8)).save(directory / f"im_{i}.{fmt}")
    return directory


@pytest.fixture(scope="module")
def two_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    a = _write_images(root / "a", 5, 0)
    b = _write_images(root / "b" / "nested", 3, 1, fmt="jpg")
    return str(root / "a"), str(root / "b")


def test_native_decoder_builds_under_build_dir():
    assert native_decode.available()
    path = native_decode._library_path()
    assert path.is_file()
    assert path.parent.parent == native_decode.BUILD_DIR
    assert native_decode.BUILD_DIR.name == "_build"


@pytest.mark.parametrize("fmt", ["png", "jpg"])
@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("route", ["native", "pil", "resize"])
@pytest.mark.parametrize("normalize", [False, True])
def test_load_image_matches_jax(tmp_path, monkeypatch, fmt, channels, route,
                                normalize):
    src = _write_images(tmp_path, 1, 7, sizes=((33, 34), (57, 58)),
                        fmt=fmt) / f"im_0.{fmt}"
    if route == "pil":
        monkeypatch.setattr(native_decode, "decode", lambda *a, **k: None)
        monkeypatch.setattr(jax_native, "decode", lambda *a, **k: None)
    size = (40, 30) if route == "resize" else None
    kw = dict(image_size=size, num_channels=channels, normalize=normalize)
    got = file_operations.load_image(src, **kw)
    ref = jax_files.load_image(src, **kw)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got, ref)
    if route == "native":
        assert native_decode.decode(src, channels) is not None
    got = file_operations.load_image(src, expand_dims=True, dtype=np.uint8,
                                     num_channels=channels)
    assert np.array_equal(got, jax_files.load_image(
        src, expand_dims=True, dtype=np.uint8, num_channels=channels))


def test_file_listing_and_merging_match_jax(two_dirs):
    a, b = two_dirs
    root = str(__import__("pathlib").Path(a).parent)
    assert file_operations.image_filenames(root) == \
        jax_files.image_filenames(root)
    assert list(file_operations.image_filenames_generator([a, b])) == \
        list(jax_files.image_filenames_generator([a, b]))
    seqs = ([1, 2, 3, 4], "ab", [], (9,))
    assert list(file_operations.merge_iterators(*seqs)) == \
        list(jax_files.merge_iterators(*seqs))
    groups = [list(range(7)), list("abcde")]
    for index, count in ((0, 1), (0, 3), (2, 3)):
        assert file_operations.shard_files_for_process(groups, index, count) \
            == jax_files.shard_files_for_process(groups, index, count)
    with pytest.raises(ValueError):
        file_operations.shard_files_for_process(groups, 3, 3)
    crops = file_operations.load_corner_crops(a, 40, 40)
    assert np.array_equal(crops, jax_files.load_corner_crops(a, 40, 40))


@pytest.mark.parametrize("min_std,scale", [(0.0, None), (30.0, None),
                                           (0.0, (0.6, 1.4)),
                                           (25.0, (0.8, 1.2))])
def test_random_crops_match_jax(min_std, scale):
    rng = np.random.default_rng(3)
    img = np.round(rng.uniform(0, 255, (70, 50, 3))).astype(np.float32)
    img[:35] = 17.0
    for shape in (img, img[:20, :20]):      # the second is edge-padded
        got = dataset.random_crops(shape, (32, 32), 6, random.Random(5),
                                   min_crop_std=min_std, scale_range=scale)
        ref = jax_dataset.random_crops(shape, (32, 32), 6, random.Random(5),
                                       min_crop_std=min_std,
                                       scale_range=scale)
        assert len(got) == len(ref) == 6
        for g, r in zip(got, ref):
            assert g.shape == (32, 32, 3) and np.array_equal(g, r)


def _epoch(builder, config, n=None):
    training = builder(config).training
    if hasattr(training, "_workers"):
        training._workers = 1
    out = []
    for batch in training:
        out.append(batch)
        if n is not None and len(out) == n:
            break
    return out


@pytest.mark.parametrize("extra", [
    {}, {"repeat": True}, {"crop_scale_range": [0.75, 1.25]},
    {"min_crop_std": 20.0, "no_crops_per_image": 3}])
def test_dataset_epoch_matches_jax(two_dirs, extra):
    a, b = two_dirs
    config = dict({"batch_size": 2, "input_shape": [24, 24, 3],
                   "no_crops_per_image": 2,
                   "inputs": [{"directory": a}, {"directory": b}]}, **extra)
    n = 12 if extra.get("repeat") else None    # past one epoch's 8
    got = _epoch(dataset.dataset_builder, config, n)
    ref = _epoch(jax_dataset.dataset_builder, config, n)
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (2, 24, 24, 3) and np.array_equal(g, r)
    # a second epoch is reshuffled, in both
    training = dataset.dataset_builder(config).training
    training._workers = 1
    first, second = next(iter(training)), next(iter(training))
    assert not np.array_equal(first, second)


def test_synthetic_dataset_matches_jax():
    config = {"batch_size": 3, "input_shape": [20, 28, 3], "inputs": []}
    got = list(dataset.dataset_builder(config).training)
    ref = list(jax_dataset.dataset_builder(config).training)
    assert len(got) == len(ref) == 16
    assert all(np.array_equal(g, r) for g, r in zip(got, ref))


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == prefetch.THREAD_NAME and t.is_alive()]


def test_grouped_prefetch_matches_jax_on_cpu():
    rng = np.random.default_rng(4)
    batches = [rng.uniform(0, 255, (2, 8, 8, 3)).astype(np.float32)
               for _ in range(7)]
    ref = [np.asarray(b) for b in jax_prefetch.device_prefetch(
        jax_prefetch.GroupedBatches(batches, 3))]
    got = prefetch.device_prefetch(prefetch.GroupedBatches(batches, 3),
                                   device="cpu")
    got = [b.numpy() for b in got]
    assert len(got) == len(ref) == 2
    assert all(g.shape == (6, 8, 8, 3) and np.array_equal(g, r)
               for g, r in zip(got, ref))
    # uint8 transfer: lossless on rounded batches, as JAX's
    rounded = [np.round(b) for b in batches]
    got = list(prefetch.device_prefetch(rounded, device="cpu",
                                        transfer_dtype=np.uint8))
    ref = list(jax_prefetch.device_prefetch(rounded,
                                            transfer_dtype=np.uint8))
    for g, r, b in zip(got, ref, rounded):
        assert g.dtype == torch.uint8
        assert np.array_equal(g.numpy(), np.asarray(r))
        assert np.array_equal(g.numpy().astype(np.float32), b)


def test_prefetch_close_stops_the_thread():
    def endless():
        while True:
            yield np.zeros((1, 4, 4, 3), np.float32)

    it = prefetch.device_prefetch(endless(), device="cpu", prefetch=2)
    for _ in range(3):
        next(it)
    assert it.thread.is_alive()
    it.close(timeout=5.0)
    assert not it.thread.is_alive()
    assert it.thread not in _prefetch_threads()
    with pytest.raises(StopIteration):
        next(it)


def test_prefetch_surfaces_producer_errors():
    def failing():
        yield np.zeros((1, 2, 2, 3), np.float32)
        raise OSError("disk gone")

    it = prefetch.device_prefetch(failing(), device="cpu")
    next(it)
    with pytest.raises(OSError, match="disk gone"):
        next(it)
    assert not it.thread.is_alive()
