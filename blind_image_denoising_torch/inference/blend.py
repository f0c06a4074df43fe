"""Noise-adaptive input blending (counterpart of
``blind_image_denoising_tpu/inference/blend.py``: ``BlendTable`` and
``calibrate_blend``).

``output = alpha · model(x) + (1 − alpha) · x`` with alpha from a
per-artifact calibrated piecewise-linear curve of the blind noise
estimate ``sigma_hat`` (``ops/noise_estimate.py``). Three kinds of
table, each a ``blend.json`` that either package writes and reads:

* global: one ``alpha`` curve;
* two-band (``alpha_low``): the input and the output split by the
  depthwise Gaussian (``band_kernel`` / ``band_nsig`` in the table's
  meta) into a low band and the rest, each blended by its own curve;
* adaptive (``coef``): the per-image weight
  ``alpha_i = max(alpha_floor(s_i), clip(C(s_i) · N · s_i² / ||y_i − x_i||², 0, 1))``
  — the flagship's ``blend.json`` is such a table.

Interpolation clamps at both ends like ``jnp.interp``. The per-image
``||y − x||²`` is summed in float64, so it does not depend on the order
of the pixels: a flipped image gets the same weight, and the rounded
TTA output stays equivariant (JAX sums in float32). Calibration
corrupts the clean frames with the port's ``corrupt_batch_fixed_std``
(another random stream than JAX's) and solves the same MAE problems.
"""

import json
import logging
import os
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..ops.gaussian import gaussian_blur
from ..ops.noise import corrupt_batch_fixed_std
from ..ops.noise_estimate import estimate_sigma
from ..ops.precision import exact_float32

logger = logging.getLogger("blind_image_denoising_torch")

BLEND_FILE = "blend.json"
ESTIMATOR = "immerkaer_median_v1"
# the two-band split's low-pass: depthwise Gaussian, the GaussianFilter
# layer's defaults
BAND_KERNEL = 5
BAND_NSIG = 2.0


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp``: piecewise-linear through (xp, fp), ends clamped."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().float().cpu()
    return np.asarray(v, np.float32)


class BlendTable:
    """Piecewise-linear alpha(sigma_hat), optionally with a second
    ``alpha_low`` curve (two-band) or ``coef`` knots (per-image
    adaptive weight)."""

    def __init__(self, sigma_knots: Sequence[float],
                 alpha_knots: Sequence[float],
                 alpha_low_knots: Optional[Sequence[float]] = None,
                 coef_knots: Optional[Sequence[float]] = None,
                 meta: Optional[Dict] = None):
        s = np.asarray(sigma_knots, np.float32)
        a = np.asarray(alpha_knots, np.float32)
        if s.ndim != 1 or s.shape != a.shape or s.size < 2:
            raise ValueError(
                f"blend table needs matching 1-D knot arrays of >=2 "
                f"entries, got sigma {s.shape} alpha {a.shape}")
        al = None
        if alpha_low_knots is not None:
            al = np.asarray(alpha_low_knots, np.float32)
            if al.shape != s.shape:
                raise ValueError(f"alpha_low knots {al.shape} must match "
                                 f"sigma_hat knots {s.shape}")
        co = None
        if coef_knots is not None:
            co = np.asarray(coef_knots, np.float32)
            if co.shape != s.shape:
                raise ValueError(f"coef knots {co.shape} must match "
                                 f"sigma_hat knots {s.shape}")
            if np.any(co < 0.0):
                raise ValueError("coef knots must be >= 0")
        order = np.argsort(s, kind="stable")
        s, a = s[order], a[order]
        al = al[order] if al is not None else None
        co = co[order] if co is not None else None
        if np.any((a < 0.0) | (a > 1.0)) or (
                al is not None and np.any((al < 0.0) | (al > 1.0))):
            raise ValueError("alpha knots must lie in [0, 1]")
        self.sigma_knots, self.alpha_knots = s, a
        self.alpha_low_knots, self.coef_knots = al, co
        self.meta = dict(meta or {})
        self._on_device: Dict = {}
        est = self.meta.setdefault("estimator", ESTIMATOR)
        if est != ESTIMATOR:
            raise ValueError(
                f"blend table calibrated for estimator [{est}]; this build "
                f"serves [{ESTIMATOR}]")

    @classmethod
    def from_any(cls, spec: Union["BlendTable", Dict, str]) -> "BlendTable":
        if isinstance(spec, BlendTable):
            return spec
        if isinstance(spec, dict):
            return cls(spec["sigma_hat"], spec["alpha"],
                       alpha_low_knots=spec.get("alpha_low"),
                       coef_knots=spec.get("coef"),
                       meta={k: v for k, v in spec.items()
                             if k not in ("sigma_hat", "alpha", "alpha_low",
                                          "coef")})
        if isinstance(spec, (str, os.PathLike)):
            path = str(spec)
            if os.path.isdir(path):
                path = os.path.join(path, BLEND_FILE)
            with open(path, "r") as f:
                return cls.from_any(json.load(f))
        raise TypeError(f"cannot build a BlendTable from {type(spec)!r}")

    def to_dict(self) -> Dict:
        d = dict(self.meta)
        d["sigma_hat"] = [float(v) for v in self.sigma_knots]
        d["alpha"] = [float(v) for v in self.alpha_knots]
        if self.alpha_low_knots is not None:
            d["alpha_low"] = [float(v) for v in self.alpha_low_knots]
        if self.coef_knots is not None:
            d["coef"] = [float(v) for v in self.coef_knots]
        return d

    def save(self, path: str) -> str:
        """Write the table as JSON to ``path`` (a directory gets
        ``blend.json``); returns the file's path."""
        if os.path.isdir(path):
            path = os.path.join(path, BLEND_FILE)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)
        logger.info(f"wrote blend table to [{path}]")
        return path

    def _knots(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """The ``name`` knots as a float32 tensor on ``like``'s device,
        uploaded once per device: a copy from host memory at every
        request would wait for the device."""
        key = (name, like.device)
        if key not in self._on_device:
            self._on_device[key] = torch.as_tensor(
                getattr(self, name), dtype=torch.float32, device=like.device)
        return self._on_device[key]

    def alpha(self, sigma_hat: torch.Tensor) -> torch.Tensor:
        """alpha (the high band's in a two-band table) at sigma_hat."""
        return interp(sigma_hat, self._knots("sigma_knots", sigma_hat),
                      self._knots("alpha_knots", sigma_hat))

    def alpha_low(self, sigma_hat: torch.Tensor) -> torch.Tensor:
        if self.alpha_low_knots is None:
            return self.alpha(sigma_hat)
        return interp(sigma_hat, self._knots("sigma_knots", sigma_hat),
                      self._knots("alpha_low_knots", sigma_hat))

    def band_split(self, x: torch.Tensor) -> torch.Tensor:
        """The table's low band of NHWC x (the same op at calibration and
        at serving; kernel and nsig travel in meta), in float32 without
        TF32."""
        k = int(self.meta.get("band_kernel", BAND_KERNEL))
        nsig = float(self.meta.get("band_nsig", BAND_NSIG))
        with exact_float32(x.is_cuda):
            return gaussian_blur(x, (k, k), (nsig, nsig))

    def apply(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Blend model output y toward input x by the calibrated
        per-image weight(s). x, y: [B, H, W, C] float32 in [0, 255]."""
        s_hat = estimate_sigma(x)
        shape = (-1,) + (1,) * (y.ndim - 1)
        if self.coef_knots is not None:
            d = (y - x).float()
            n_px = float(np.prod(d.shape[1:]))
            dd = torch.sum(torch.square(d.double()),
                           dim=tuple(range(1, d.ndim))).float()
            c = interp(s_hat, self._knots("sigma_knots", s_hat),
                       self._knots("coef_knots", s_hat))
            r = n_px * torch.square(s_hat) / torch.clamp(dd, min=1e-6)
            a = torch.maximum(self.alpha(s_hat), torch.clamp(c * r, 0.0, 1.0))
            a = a.reshape(shape).to(y.dtype)
            return a * y + (1.0 - a) * x
        a = self.alpha(s_hat).reshape(shape).to(y.dtype)
        if self.alpha_low_knots is None:
            return a * y + (1.0 - a) * x
        al = self.alpha_low(s_hat).reshape(shape).to(y.dtype)
        lx, ly = self.band_split(x), self.band_split(y)
        return (al * ly + (1.0 - al) * lx
                + a * (y - ly) + (1.0 - a) * (x - lx))


def _optimal_alpha(err_in: np.ndarray, err_out: np.ndarray,
                   grid: int) -> float:
    """argmin over alpha in [0, 1] of mean |a·err_out + (1−a)·err_in|,
    by direct search on a grid (the objective is convex in alpha)."""
    alphas = np.linspace(0.0, 1.0, grid, dtype=np.float32)
    best_a, best_m = 0.0, np.inf
    for a in alphas:
        m = float(np.abs(a * err_out + (1.0 - a) * err_in).mean())
        if m < best_m:
            best_a, best_m = float(a), m
    return best_a


def _optimal_alpha2(err_in: np.ndarray, d_low: np.ndarray,
                    d_high: np.ndarray, grid: int):
    """argmin over (alpha_low, alpha_high) in [0, 1]² of
    mean |err_in + a_l·d_low + a_h·d_high| (the two-band blend's error).
    A coarse grid seeds a window that re-centres on its own argmin until
    the argmin is interior (or at the box's edge), then halves down to
    the grid's resolution."""
    def sweep(als, ahs):
        best = (0.0, 0.0, np.inf)
        for al in als:
            base = err_in + al * d_low
            for ah in ahs:
                m = float(np.abs(base + ah * d_high).mean())
                if m < best[2]:
                    best = (float(al), float(ah), m)
        return best

    def window(center, half, step):
        lo = np.clip(center - half, 0.0, 1.0)
        hi = np.clip(center + half, 0.0, 1.0)
        # arange's endpoint slack can overshoot hi: clip back into the box
        return np.clip(np.arange(lo, hi + step / 2, step,
                                 dtype=np.float32), 0.0, 1.0)

    coarse = np.linspace(0.0, 1.0, 21, dtype=np.float32)   # 0.05 steps
    al, ah, m = sweep(coarse, coarse)
    target = 1.0 / max(grid - 1, 1)
    half, step = 0.05, 0.05
    for _ in range(64):  # bounded walk: 64 re-centres span [0,1] twice
        als, ahs = window(al, half, step), window(ah, half, step)
        al, ah, m = sweep(als, ahs)
        on_edge = ((al in (als[0], als[-1]) and 0.0 < al < 1.0) or
                   (ah in (ahs[0], ahs[-1]) and 0.0 < ah < 1.0))
        if on_edge:
            continue          # the valley extends past the window
        if step <= target:
            break             # interior at the target resolution
        half, step = half / 2, max(step / 2, target)
    return al, ah, m


def _adaptive_level(err_in: np.ndarray, err_out: np.ndarray,
                    s_hat_i: np.ndarray, alpha_grid: int,
                    mae_model: float):
    """The (floor g, coef C) pair minimizing the calibration MAE of
    alpha_i = max(g, clip(C · r_i, 0, 1)), r_i = N·s_i²/||d_i||²; pinned
    to (1, 0), the raw model, when it buys less than 0.005 MAE."""
    d = err_out - err_in                               # = y - x
    n_px = float(np.prod(d.shape[1:]))
    dd = np.maximum((d * d).sum(axis=(1, 2, 3)), 1e-6)
    r_i = n_px * s_hat_i ** 2 / dd
    # per-image MAE as a function of alpha on the grid, then the joint
    # search is table lookups
    agrid = np.linspace(0.0, 1.0, alpha_grid, dtype=np.float32)
    mae_tab = np.stack([
        np.abs(err_in[j][None] + agrid[:, None, None, None]
               * d[j][None]).mean(axis=(1, 2, 3))
        for j in range(d.shape[0])])                   # [B, grid]
    best = (0.0, 0.0, np.inf)
    for g in np.linspace(0.0, 1.0, 51):
        for cand in np.linspace(0.0, 3.0, 61):
            a_i = np.maximum(g, np.clip(cand * r_i, 0.0, 1.0))
            idx = np.round(a_i * (alpha_grid - 1)).astype(int)
            m = float(mae_tab[np.arange(len(idx)), idx].mean())
            if m < best[2]:
                best = (float(g), float(cand), m)
    g, c, m = best
    if m >= mae_model - 0.005:
        g, c = 1.0, 0.0
    return g, c, m, float(r_i.mean())


def calibrate_blend(
        float_forward: Callable,
        images: np.ndarray,
        stds: Sequence[float] = (0, 1, 2, 3, 5, 8, 12, 16, 20, 25,
                                 30, 40, 50, 65, 80),
        seed: int = 0,
        alpha_grid: int = 101,
        bands: int = 1,
        band_kernel: int = BAND_KERNEL,
        band_nsig: float = BAND_NSIG,
        adaptive: bool = False) -> BlendTable:
    """Calibrate alpha(sigma_hat) for one artifact.

    float_forward: the Denoiser's ``float_forward`` (or any callable from
    a float32 [N, H, W, C] numpy batch to the denoised batch, numpy or
    torch). images: [N, H, W, C] float32 CLEAN frames in [0, 255].

    Per std (sorted, deduplicated): corrupt with the ±2σ truncated
    normal (``corrupt_batch_fixed_std``, a CPU ``torch.Generator``
    seeded from (seed, level)), record the mean sigma_hat and the
    MAE-optimal alpha. ``bands=2`` fits independent low- and high-band
    curves; ``adaptive=True`` fits the per-image mode's floor and coef
    per level (single-band only)."""
    if bands not in (1, 2):
        raise ValueError(f"bands must be 1 or 2, got {bands}")
    if adaptive and bands != 1:
        raise ValueError("adaptive mode is single-band")
    clean = np.asarray(images, np.float32)
    sig_knots, a_knots, al_knots, co_knots, records = [], [], [], [], []
    for i, std in enumerate(sorted(set(float(s) for s in stds))):
        if std > 0:
            gen = torch.Generator().manual_seed(seed * 1_000_003 + i)
            noisy = np.clip(corrupt_batch_fixed_std(
                gen, torch.from_numpy(clean), std=std).numpy(), 0, 255)
        else:
            noisy = clean
        s_hat_i = estimate_sigma(torch.from_numpy(noisy)).numpy()
        s_hat = float(s_hat_i.mean())
        den = _numpy(float_forward(noisy))
        err_in, err_out = noisy - clean, den - clean
        rec = {"std": std, "sigma_hat": s_hat,
               "mae_noisy": float(np.abs(err_in).mean()),
               "mae_model": float(np.abs(err_out).mean())}
        al = None
        if adaptive:
            a, c, m, r_mean = _adaptive_level(err_in, err_out, s_hat_i,
                                              alpha_grid, rec["mae_model"])
            co_knots.append(c)
            rec.update(mae_blend=m, coef=c, alpha_floor=a, r_mean=r_mean)
        elif bands == 1:
            a = _optimal_alpha(err_in, err_out, alpha_grid)
        else:
            d = err_out - err_in
            d_low = gaussian_blur(torch.from_numpy(d), (band_kernel,
                                                        band_kernel),
                                  (band_nsig, band_nsig)).numpy()
            al, a, m = _optimal_alpha2(err_in, d_low, d - d_low, alpha_grid)
            rec["mae_blend"] = m
            al_knots.append(al)
        sig_knots.append(s_hat)
        a_knots.append(a)
        rec["alpha"] = a
        if al is not None:
            rec["alpha_low"] = al
        records.append(rec)
        logger.info(
            f"calibrate std {std:g}: sigma_hat {s_hat:.2f} alpha* {a:.2f}"
            + (f" alpha_low* {al:.2f} mae {rec['mae_blend']:.3f}"
               if al is not None else "")
            + (f" coef* {rec['coef']:.2f} mae {rec['mae_blend']:.3f}"
               if adaptive else ""))
    meta = {"estimator": ESTIMATOR, "alpha_grid": alpha_grid, "seed": seed,
            "n_images": int(clean.shape[0]),
            "image_hw": list(clean.shape[1:3]), "levels": records}
    if bands == 2:
        meta["band_kernel"] = int(band_kernel)
        meta["band_nsig"] = float(band_nsig)
    return BlendTable(sig_knots, a_knots,
                      alpha_low_knots=al_knots if bands == 2 else None,
                      coef_knots=co_knots if adaptive else None,
                      meta=meta)
