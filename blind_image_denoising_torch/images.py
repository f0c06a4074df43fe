"""The packaged evaluation images (counterpart of
``blind_image_denoising_tpu/images/__init__.py``): four deterministic
synthetic 512×512 scenes with photographic statistics (dead-leaves
occlusions with power-law radii, pink-noise texture, a pink-noise cloud,
a sky over leaves), generated by the same numpy code from the same
seeds, so they equal the JAX package's bit for bit.

The JAX package's override paths take precedence, in its order:
image files in ``BID_TPU_EVAL_IMAGES_DIR``, else image files dropped
into its ``images`` directory; the first four decode through
``data.file_operations.load_image`` (resized with pad to the size).
"""

import glob
import os
import pathlib
from typing import List

import numpy as np

ENV_DIR = "BID_TPU_EVAL_IMAGES_DIR"
_EXTS = ("*.png", "*.jpg", "*.jpeg", "*.bmp")
_JAX_IMAGES_DIR = (pathlib.Path(__file__).resolve().parent.parent
                   / "blind_image_denoising_tpu" / "images")


def _glob_images(directory) -> List[str]:
    return sorted(sum((glob.glob(os.path.join(str(directory), e))
                       for e in _EXTS), []))


def _pink_noise(rng: np.random.Generator, size: int,
                beta: float = 1.0) -> np.ndarray:
    """[size, size] zero-mean 1/f^beta ("pink") noise field, unit std."""
    white = rng.normal(0.0, 1.0, (size, size)).astype(np.float32)
    spec = np.fft.rfft2(white)
    fy = np.fft.fftfreq(size)[:, None]
    fx = np.fft.rfftfreq(size)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    spec *= f ** (-beta)
    spec[0, 0] = 0.0
    field = np.fft.irfft2(spec, s=(size, size)).astype(np.float32)
    return field / max(float(field.std()), 1e-8)


def _power_law_radii(rng: np.random.Generator, n: int,
                     r_min: float, r_max: float,
                     alpha: float = 3.0) -> np.ndarray:
    """n radii with p(r) ∝ r^-alpha on [r_min, r_max] (inverse CDF)."""
    u = rng.uniform(0.0, 1.0, n)
    a1 = 1.0 - alpha
    return (r_min ** a1 + u * (r_max ** a1 - r_min ** a1)) ** (1.0 / a1)


def _dead_leaves(rng: np.random.Generator, size: int,
                 n_leaves: int = 1500, shading: float = 0.25,
                 texture: float = 0.0) -> np.ndarray:
    """[size, size, 3] float dead-leaves scene in [0, 1]: opaque disks
    with power-law radii painted back to front, per-leaf linear shading
    and optional pink texture."""
    img = np.empty((size, size, 3), np.float32)
    img[:] = rng.uniform(0.15, 0.85, 3).astype(np.float32)
    radii = _power_law_radii(rng, n_leaves, size * 0.012, size * 0.45)
    centers = rng.uniform(0, size, (n_leaves, 2)).astype(np.float32)
    lum = rng.uniform(0.08, 0.92, n_leaves).astype(np.float32)
    chroma = rng.uniform(-0.12, 0.12, (n_leaves, 3)).astype(np.float32)
    angles = rng.uniform(0, 2 * np.pi, n_leaves).astype(np.float32)
    tex_field = _pink_noise(rng, size) if texture > 0 else None
    for i in range(n_leaves):
        r, (cy, cx) = float(radii[i]), centers[i]
        y0, y1 = max(0, int(cy - r)), min(size, int(cy + r) + 1)
        x0, x1 = max(0, int(cx - r)), min(size, int(cx + r) + 1)
        if y0 >= y1 or x0 >= x1:
            continue
        yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
        mask = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        if not mask.any():
            continue
        shade = ((yy - cy) * np.sin(angles[i])
                 + (xx - cx) * np.cos(angles[i])) / max(r, 1.0)
        val = lum[i] * (1.0 + shading * shade)
        if tex_field is not None:
            val = val + texture * tex_field[y0:y1, x0:x1]
        leaf = val[..., None] + chroma[i]
        region = img[y0:y1, x0:x1]
        region[mask] = np.clip(leaf, 0.0, 1.0)[mask]
    return img


def _synthetic(idx: int, size: int = 512) -> np.ndarray:
    """Deterministic synthetic eval image #idx, uint8 HWC RGB."""
    rng = np.random.default_rng(1000 + idx)
    if idx == 0:      # dead leaves, clean shading
        img = _dead_leaves(rng, size, n_leaves=1800, shading=0.3)
    elif idx == 1:    # dead leaves + in-leaf pink texture
        img = _dead_leaves(rng, size, n_leaves=1200, shading=0.2,
                           texture=0.12)
    elif idx == 2:    # multiscale pink-noise cloud
        base = _pink_noise(rng, size, beta=1.4)
        detail = _pink_noise(rng, size, beta=0.8)
        lum = 0.5 + 0.22 * base + 0.06 * detail
        tint = np.array([0.03, 0.0, -0.03], np.float32)
        img = np.clip(lum[..., None] + tint * base[..., None], 0, 1)
    else:             # sky gradient over textured dead leaves
        img = _dead_leaves(rng, size, n_leaves=900, shading=0.25,
                           texture=0.1)
        yy = np.mgrid[0:size, 0:size][0].astype(np.float32) / size
        horizon = 0.38 + 0.04 * _pink_noise(rng, size)[0, :size]
        sky_t = np.clip((horizon[None, :] - yy) * 14.0, 0.0, 1.0)
        sky = (0.85 - 0.35 * yy)[..., None] * np.array(
            [0.95, 0.97, 1.0], np.float32)
        img = sky_t[..., None] * sky + (1.0 - sky_t[..., None]) * img
    return np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)


def discover_evaluation_paths() -> List[str]:
    """Image files that override the synthetic set: those in
    ``BID_TPU_EVAL_IMAGES_DIR`` when it names a directory with images,
    else those in the JAX package's ``images`` directory."""
    env_dir = os.environ.get(ENV_DIR)
    if env_dir:
        found = _glob_images(env_dir)
        if found:
            return found
    return _glob_images(_JAX_IMAGES_DIR)


def load_evaluation_images(size: int = 512) -> np.ndarray:
    """[4, size, size, 3] float32 eval batch in [0, 255]."""
    paths = discover_evaluation_paths()
    if paths:
        from .data.file_operations import load_image
        imgs = [load_image(p, image_size=(size, size), num_channels=3)
                for p in paths[:4]]
        return np.stack(imgs, axis=0).astype(np.float32)
    return np.stack([_synthetic(i, size) for i in range(4)],
                    axis=0).astype(np.float32)
