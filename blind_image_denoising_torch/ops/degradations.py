"""On-device image degradations (counterpart of
``blind_image_denoising_tpu/ops/degradations.py``), in plain PyTorch on
[B, H, W, C] float32 batches in [0, 255], on the batch's device.

* ``rotate_batch`` / ``random_rotate_batch``: per-sample bilinear
  rotation about the centre ``((h − 1)/2, (w − 1)/2)`` with half-sample
  reflection at the borders, which is ``map_coordinates(order=1,
  mode="reflect")``: the inverse map gives each output pixel its source
  coordinates, and the four neighbours are gathered at reflected integer
  indices and summed in JAX's order.
* ``separable_blur_batch`` / ``random_blur``: a 7-tap Gaussian per
  sample, edge padding, taps summed in JAX's order, weights renormalized
  over the taps, σ floored at 1e-3.
* The angles' cosine and sine and the blur weights (a few numbers per
  sample) are computed in float64 and rounded once to float32, so the
  card and the CPU agree on them to the bit; JAX computes them in
  float32, one rounding away.
* ``jpeg_artifacts`` / ``random_jpeg``: 8×8 orthonormal DCT, Annex-K
  tables scaled by the quality as libjpeg does (in float32), rounding of
  each coefficient (half to even, as ``jnp.round``), inverse DCT, in
  YCbCr for three channels. On the card the products run in exact
  float32 (``ops/precision.exact_float32``): TF32 would move
  ``coef / q`` across a .5 and round it the other way.
* ``quantize_batch`` / ``random_quantize``: posterize to multiples of q.
* ``inpaint_dropout``: a per-pixel hole mask shared by the channels.
* ``degrade_batch``: blur → noise (``ops/noise.corrupt_batch``, not
  rounded) → JPEG → posterize → holes → rounding, with the per-sample
  gate ``degradation_prob`` on each op and the master gate
  ``chain_prob`` whose failing samples get the noise alone, from the
  same noise draw as the chain's noise step.

Every draw comes from the ``torch.Generator`` the caller passes, on the
batch's device; gates are ``torch.where`` on drawn flags, so nothing
here waits for the device. The streams are the port's own: a draw
matches JAX's in distribution, and each deterministic op matches it in
value.
"""

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .noise import batch_rand, corrupt_batch
from .precision import exact_float32

# ---------------------------------------------------------------------------
# rotation (geometric: applied to the clean batch, like flips)
# ---------------------------------------------------------------------------


def _reflect_index(index: torch.Tensor, size: int) -> torch.Tensor:
    """scipy's half-sample ``reflect`` of integer indices into [0, size):
    ``map_coordinates``' index fixer, with floor division and modulo."""
    n = 2 * size + 1
    s = n - 1
    mirrored = torch.abs(torch.remainder(2 * index + 1 + s, 2 * s) - s)
    return torch.div(mirrored - 1, 2, rounding_mode="floor")


def rotate_batch(batch: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate each sample of [B, H, W, C] by ``angles`` [B] radians
    (counter-clockwise in image coordinates) about its centre, bilinear,
    half-sample reflection at the borders."""
    b, h, w, c = batch.shape
    dev = batch.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    # the cosine and sine in float64, rounded once to float32: the card's
    # and the CPU's float32 sin / cos may differ in the last bit, which
    # the distance from the centre and the image's edges magnify
    a = angles.reshape(-1, 1, 1).double()
    cos, sin = torch.cos(a).float(), torch.sin(a).float()
    # inverse map: the source coordinates that land on each output pixel
    ys = cos * (yy - cy) - sin * (xx - cx) + cy
    xs = sin * (yy - cy) + cos * (xx - cx) + cx

    def nodes(coord, size):
        lower = torch.floor(coord)
        upper_w = coord - lower
        index = lower.to(torch.int64)
        return [(_reflect_index(index, size), 1 - upper_w),
                (_reflect_index(index + 1, size), upper_w)]

    flat = batch.reshape(b, h * w, c)
    out = None
    for iy, wy in nodes(ys, h):
        for ix, wx in nodes(xs, w):
            idx = (iy * w + ix).reshape(b, h * w, 1).expand(b, h * w, c)
            term = (wy * wx).reshape(b, h * w, 1) * torch.gather(flat, 1, idx)
            out = term if out is None else out + term
    return out.reshape(b, h, w, c).to(batch.dtype)


def random_rotate_batch(generator: torch.Generator, batch: torch.Tensor,
                        max_angle: float) -> torch.Tensor:
    """Rotation augmentation: per-sample angle ~ U[−max_angle,
    +max_angle] radians (``dataset.random_rotate``)."""
    a = float(max_angle)
    u = batch_rand((batch.shape[0],), generator, batch.device)
    return rotate_batch(batch, -a + 2.0 * a * u)


# ---------------------------------------------------------------------------
# blur
# ---------------------------------------------------------------------------


def separable_blur_batch(batch: torch.Tensor, sigmas: torch.Tensor,
                         taps: int = 7) -> torch.Tensor:
    """Per-sample separable Gaussian blur of [B, H, W, C] with ``sigmas``
    [B]: ``taps`` shifted and weighted adds per axis on the edge-padded
    batch, the weights renormalized over the taps."""
    r = (taps - 1) // 2
    dev = batch.device
    # the weights in float64, rounded once to float32 (the card's float32
    # exp may differ from the CPU's in the last bit)
    off = torch.arange(taps, dtype=torch.float64, device=dev) - r
    sig = torch.clamp(sigmas.reshape(-1, 1).float(), min=1e-3).double()
    wts = torch.exp(-0.5 * (off[None, :] / sig) ** 2)
    wts = (wts / torch.sum(wts, dim=1, keepdim=True)).float()   # [B, taps]

    def pass_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
        n = x.shape[axis]
        edge = torch.clamp(torch.arange(-r, n + r, device=dev), 0, n - 1)
        xp = x.index_select(axis, edge)
        out = torch.zeros_like(x)
        for k in range(taps):
            out = out + wts[:, k, None, None, None] * xp.narrow(axis, k, n)
        return out

    return pass_axis(pass_axis(batch, 1), 2)


def random_blur(generator: torch.Generator, batch: torch.Tensor,
                sigma_range: Tuple[float, float] = (0.1, 2.0),
                prob: float = 0.5, taps: int = 7) -> torch.Tensor:
    """With probability ``prob`` per sample, Gaussian blur at σ ~
    U[sigma_range] (``dataset.random_blur``)."""
    b, dev = batch.shape[0], batch.device
    flags = batch_rand((b, 1, 1, 1), generator, dev) < prob
    lo, hi = float(sigma_range[0]), float(sigma_range[1])
    sig = lo + (hi - lo) * batch_rand((b,), generator, dev)
    return torch.where(flags, separable_blur_batch(batch, sig, taps), batch)


# ---------------------------------------------------------------------------
# JPEG artifacts
# ---------------------------------------------------------------------------

# ITU-T T.81 Annex K.1 reference quantization tables
_JPEG_LUMA_Q = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], np.float32)

_JPEG_CHROMA_Q = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99]], np.float32)


_CONSTANTS = {}


def _constant(array: np.ndarray, device) -> torch.Tensor:
    """A float32 constant table on ``device``, copied there once. On the
    card the copy goes through pinned memory without blocking, so a train
    step that makes the first copy still does not wait for the device."""
    device = torch.device(device)
    array = np.ascontiguousarray(array, np.float32)
    key = (array.shape, array.tobytes(), str(device))
    if key not in _CONSTANTS:
        t = torch.from_numpy(array.copy())
        _CONSTANTS[key] = (t.pin_memory().to(device, non_blocking=True)
                           if device.type == "cuda" else t.to(device))
    return _CONSTANTS[key]


def _dct8() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix, whose scaling equals the JPEG
    spec's, so the Annex-K tables apply to its coefficients directly."""
    k = np.arange(8)
    d = np.sqrt(2.0 / 8.0) * np.cos(
        np.pi * (2 * k[None, :] + 1) * k[:, None] / 16.0)
    d[0] *= 1.0 / np.sqrt(2.0)
    return d.astype(np.float32)


def _quality_scaled_table(base: np.ndarray,
                          quality: torch.Tensor) -> torch.Tensor:
    """libjpeg quality scaling in float32: entries ``floor((base·S +
    50)/100)`` clipped to [1, 255], S = 5000/Q below 50, else 200 − 2Q.
    ``quality`` [B] → tables [B, 8, 8]."""
    q = torch.clamp(quality.float(), 1.0, 100.0)
    scale = torch.where(q < 50.0, 5000.0 / q, 200.0 - 2.0 * q)
    base_t = _constant(base, q.device)
    tbl = torch.floor((base_t[None] * scale[:, None, None] + 50.0) / 100.0)
    return torch.clamp(tbl, 1.0, 255.0)


def _jpeg_channel(x: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """DCT, quantize and reconstruct one plane batch: x [B, H, W]
    (level-shifted, H and W multiples of 8), tbl [B, 8, 8]."""
    b, h, w = x.shape
    d = _constant(_dct8(), x.device)
    blocks = x.reshape(b, h // 8, 8, w // 8, 8)
    coef = torch.einsum("ui,bhiwj,vj->bhuwv", d, blocks, d)
    qt = tbl[:, None, :, None, :]
    coef = torch.round(coef / qt) * qt
    rec = torch.einsum("ui,bhuwv,vj->bhiwj", d, coef, d)
    return rec.reshape(b, h, w)


def jpeg_artifacts(batch: torch.Tensor, quality: torch.Tensor) -> torch.Tensor:
    """JPEG compression distortion of [B, H, W, C] in [0, 255] at a
    per-sample ``quality`` [B] in [1, 100]: the input clipped to
    [0, 255], 8×8 block DCT, the luma table on Y (and on every plane of
    a batch without three channels), the chroma table on Cb and Cr,
    inverse DCT, clipped. H and W that are not multiples of 8 are
    edge-padded and cropped back. Entropy coding (lossless) and chroma
    subsampling are left out, as in JAX."""
    b, h, w, c = batch.shape
    ph, pw = (-h) % 8, (-w) % 8
    x = torch.clamp(batch, 0.0, 255.0).float()
    if ph or pw:
        rows = torch.clamp(torch.arange(h + ph, device=x.device), max=h - 1)
        cols = torch.clamp(torch.arange(w + pw, device=x.device), max=w - 1)
        x = x.index_select(1, rows).index_select(2, cols)
    with exact_float32(x.is_cuda):
        tbl_l = _quality_scaled_table(_JPEG_LUMA_Q, quality)
        if c == 3:
            tbl_c = _quality_scaled_table(_JPEG_CHROMA_Q, quality)
            r, g, bl = x[..., 0], x[..., 1], x[..., 2]
            y = 0.299 * r + 0.587 * g + 0.114 * bl
            cb = -0.168736 * r - 0.331264 * g + 0.5 * bl + 128.0
            cr = 0.5 * r - 0.418688 * g - 0.081312 * bl + 128.0
            y = _jpeg_channel(y - 128.0, tbl_l) + 128.0
            cb = _jpeg_channel(cb - 128.0, tbl_c) + 128.0
            cr = _jpeg_channel(cr - 128.0, tbl_c) + 128.0
            out = torch.stack([
                y + 1.402 * (cr - 128.0),
                y - 0.344136 * (cb - 128.0) - 0.714136 * (cr - 128.0),
                y + 1.772 * (cb - 128.0)], dim=-1)
        else:
            out = torch.stack([_jpeg_channel(x[..., i] - 128.0, tbl_l) + 128.0
                               for i in range(c)], dim=-1)
    out = torch.clamp(out, 0.0, 255.0)
    if ph or pw:
        out = out[:, :h, :w, :]
    return out.to(batch.dtype)


def random_jpeg(generator: torch.Generator, batch: torch.Tensor,
                quality_range: Tuple[float, float] = (25.0, 75.0),
                prob: float = 0.5) -> torch.Tensor:
    """With probability ``prob`` per sample, JPEG at quality ~
    U[quality_range] (``dataset.use_jpeg_noise``)."""
    b, dev = batch.shape[0], batch.device
    flags = batch_rand((b, 1, 1, 1), generator, dev) < prob
    lo, hi = float(quality_range[0]), float(quality_range[1])
    quality = lo + (hi - lo) * batch_rand((b,), generator, dev)
    return torch.where(flags, jpeg_artifacts(batch, quality), batch)


# ---------------------------------------------------------------------------
# bit-depth quantization, inpainting holes
# ---------------------------------------------------------------------------


def quantize_batch(batch: torch.Tensor, q: float) -> torch.Tensor:
    """Posterize to multiples of ``q`` (``dataset.quantization``)."""
    return torch.round(batch / q) * q


def random_quantize(generator: torch.Generator, batch: torch.Tensor,
                    q: float, prob: float = 0.5) -> torch.Tensor:
    """Posterize with probability ``prob`` per sample."""
    flags = batch_rand((batch.shape[0], 1, 1, 1), generator,
                       batch.device) < prob
    return torch.where(flags, quantize_batch(batch, float(q)), batch)


def inpaint_dropout(generator: Optional[torch.Generator], batch: torch.Tensor,
                    drop_rate: float, prob: float = 1.0,
                    keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zero a Bernoulli(``drop_rate``) per-pixel hole mask shared across
    channels (``dataset.inpaint_drop_rate``). ``keep``: a given [B, H, W,
    1] bool mask of the pixels kept, instead of a drawn one. ``prob``
    gates the holes per sample; at 1.0 every sample gets them."""
    b, h, w, _ = batch.shape
    if keep is None:
        keep = batch_rand((b, h, w, 1), generator,
                          batch.device) >= float(drop_rate)
    holed = torch.where(keep, batch, torch.zeros_like(batch))
    if prob >= 1.0:
        return holed
    flags = batch_rand((b, 1, 1, 1), generator, batch.device) < prob
    return torch.where(flags, holed, batch)


# ---------------------------------------------------------------------------
# the full chain
# ---------------------------------------------------------------------------


def degrade_batch(
        generator: torch.Generator,
        clean: torch.Tensor,
        additive_noise: Optional[Sequence[float]] = None,
        multiplicative_noise: Optional[Sequence[float]] = None,
        noise_sampling: str = "uniform",
        round_values: bool = True,
        use_random_blur: bool = False,
        blur_sigma_range: Tuple[float, float] = (0.1, 2.0),
        use_jpeg_noise: bool = False,
        jpeg_quality_range: Tuple[float, float] = (25.0, 75.0),
        quantization: int = -1,
        inpaint_drop_rate: float = 0.0,
        degradation_prob: float = 0.5,
        chain_prob: float = 1.0) -> torch.Tensor:
    """The corruption chain in the physical pipeline's order: blur →
    noise (``corrupt_batch``, unrounded) → JPEG (on the clipped signal)
    → posterize → holes → rounding. ``clean`` is not modified.

    ``degradation_prob`` is the per-sample gate of each extended op (the
    noise keeps its own 50/50 gates). ``chain_prob`` < 1 is a master gate
    above them: the samples that fail it get only the noise, from the
    generator restored to its state before the chain's noise step, so it
    is the chain's own noise draw on the clean batch; the generator then
    continues from where the chain left it."""
    p = float(degradation_prob)
    noise_kw = dict(additive_noise=additive_noise,
                    multiplicative_noise=multiplicative_noise,
                    round_values=False, noise_sampling=noise_sampling)
    noisy = clean
    if use_random_blur:
        noisy = random_blur(generator, noisy, sigma_range=blur_sigma_range,
                            prob=p)
    c = float(chain_prob)
    before_noise = generator.get_state() if c < 1.0 else None
    noisy = corrupt_batch(generator, noisy, **noise_kw)
    if use_jpeg_noise:
        noisy = random_jpeg(generator, noisy,
                            quality_range=jpeg_quality_range, prob=p)
    if quantization and quantization > 1:
        noisy = random_quantize(generator, noisy, float(quantization), prob=p)
    if inpaint_drop_rate and inpaint_drop_rate > 0.0:
        noisy = inpaint_dropout(generator, noisy, float(inpaint_drop_rate),
                                prob=p)
    if c < 1.0:
        after_chain = generator.get_state()
        generator.set_state(before_noise)
        noise_only = corrupt_batch(generator, clean, **noise_kw)
        generator.set_state(after_chain)
        flags = batch_rand((clean.shape[0], 1, 1, 1), generator,
                           clean.device) < c
        noisy = torch.where(flags, noisy, noise_only)
    if round_values:
        noisy = torch.round(noisy)
    return noisy
