"""Filesystem traversal and image IO (counterpart of
``blind_image_denoising_tpu/data/file_operations.py``): recursive image
discovery, round-robin merging of several dataset directories, and a
decode-to-numpy loader, with the same results bit for bit.

JPEG and PNG files decode through the port's native worker
(``data/native_decode.py``) when it builds; everything else, and every
resize-with-pad, goes through PIL, as in the JAX package.
"""

import logging
import os
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

logger = logging.getLogger("blind_image_denoising_torch")

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".ppm", ".webp")


def image_filenames(directory: Union[str, Path]) -> List[str]:
    """Recursively list image files under a directory, sorted."""
    results: List[str] = []
    for root, _, files in os.walk(str(directory)):
        for f in files:
            if f.lower().endswith(IMAGE_EXTENSIONS):
                results.append(os.path.join(root, f))
    results.sort()
    return results


def merge_iterators(*iterators: Iterator) -> Iterator:
    """Round-robin merge, dropping exhausted iterators."""
    alive = [iter(it) for it in iterators]
    while alive:
        still = []
        for it in alive:
            try:
                yield next(it)
                still.append(it)
            except StopIteration:
                pass
        alive = still


def image_filenames_generator(
        directories: Sequence[Union[str, Path]]) -> Iterator[str]:
    """Round-robin stream of image paths over several dataset
    directories."""
    listings = []
    for d in directories:
        files = image_filenames(d)
        if not files:
            logger.warning(f"no images found under [{d}]")
        listings.append(iter(files))
    return merge_iterators(*listings)


def load_image(
        path: Union[str, Path],
        image_size: Optional[Tuple[int, int]] = None,
        num_channels: int = 3,
        expand_dims: bool = False,
        normalize: bool = False,
        dtype=np.float32) -> np.ndarray:
    """Decode an image to numpy HWC.

    ``image_size`` resizes-with-pad to (H, W) keeping the aspect ratio
    (PIL bilinear, centred on a black canvas). ``normalize`` maps to
    [-0.5, 0.5]; otherwise values stay in [0, 255]. Without
    ``image_size``, JPEG and PNG go through the native decoder when it is
    available; anything it cannot handle falls back to PIL."""
    if image_size is None:
        from . import native_decode
        native = native_decode.decode(path, num_channels=num_channels)
        if native is not None:
            x = np.asarray(native, dtype=dtype)
            if normalize:
                x = np.clip(x, 0.0, 255.0) / 255.0 - 0.5
            if expand_dims:
                x = x[None, ...]
            return x

    from PIL import Image

    img = Image.open(str(path))
    mode = {1: "L", 3: "RGB", 4: "RGBA"}.get(num_channels)
    if mode is None:
        raise ValueError(f"unsupported num_channels [{num_channels}]")
    img = img.convert(mode)

    if image_size is not None:
        th, tw = int(image_size[0]), int(image_size[1])
        scale = min(th / img.height, tw / img.width)
        nh = max(1, round(img.height * scale))
        nw = max(1, round(img.width * scale))
        img = img.resize((nw, nh), Image.BILINEAR)
        canvas = Image.new(img.mode, (tw, th))
        canvas.paste(img, ((tw - nw) // 2, (th - nh) // 2))
        img = canvas

    x = np.asarray(img, dtype=dtype)
    if x.ndim == 2:
        x = x[:, :, None]
    if normalize:
        x = np.clip(x, 0.0, 255.0) / 255.0 - 0.5
    if expand_dims:
        x = x[None, ...]
    return x


def load_corner_crops(directory: Union[str, Path], height: int = 256,
                      width: int = 256) -> np.ndarray:
    """Top-left ``[height, width]`` crops of every image in ``directory``
    large enough to supply one, stacked [N, height, width, 3] float32 in
    [0, 255] (fixed crops, no resampling)."""
    crops = []
    for path in image_filenames(directory):
        img = load_image(path, num_channels=3)
        if img.shape[0] >= height and img.shape[1] >= width:
            crops.append(img[:height, :width])
    if not crops:
        raise ValueError(
            f"no images of at least {height}x{width} in [{directory}]")
    return np.stack(crops, axis=0).astype(np.float32)


def shard_files_for_process(file_groups, process_index: int,
                            process_count: int):
    """Disjoint per-process file shards: each dataset's listing is dealt
    round-robin by index, so every process sees ~1/process_count of every
    dataset and no two decode the same file."""
    if process_count <= 1:
        return [list(g) for g in file_groups]
    if not 0 <= process_index < process_count:
        raise ValueError(
            f"process_index {process_index} not in [0, {process_count})")
    return [list(g[process_index::process_count]) for g in file_groups]
