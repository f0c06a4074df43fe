"""Noise-adaptive input blending (counterpart of
``blind_image_denoising_tpu/inference/blend.py`` ``BlendTable``, serving
side).

``output = alpha · model(x) + (1 − alpha) · x`` with alpha from a
per-artifact calibrated piecewise-linear curve of the blind noise
estimate ``sigma_hat`` (``ops/noise_estimate.py``). Tables with a
``coef`` array serve the per-image adaptive weight
``alpha_i = max(alpha_floor(s_i), clip(C(s_i) · N · s_i² / ||y_i − x_i||², 0, 1))``
— the flagship's ``blend.json`` is such a table. Interpolation clamps at
both ends like ``jnp.interp``. Calibration stays in the JAX package;
two-band (``alpha_low``) tables are not ported yet (ROADMAP Queue 1
item 10).
"""

import json
import os
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..ops.noise_estimate import estimate_sigma

BLEND_FILE = "blend.json"
ESTIMATOR = "immerkaer_median_v1"


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


class BlendTable:
    """Piecewise-linear alpha(sigma_hat), optionally with ``coef`` knots
    for the per-image adaptive weight."""

    def __init__(self, sigma_knots: Sequence[float],
                 alpha_knots: Sequence[float],
                 alpha_low_knots: Optional[Sequence[float]] = None,
                 coef_knots: Optional[Sequence[float]] = None,
                 meta: Optional[Dict] = None):
        if alpha_low_knots is not None:
            raise NotImplementedError(
                "two-band (alpha_low) blend tables are not ported yet "
                "(ROADMAP Queue 1 item 10)")
        s = np.asarray(sigma_knots, np.float32)
        a = np.asarray(alpha_knots, np.float32)
        if s.ndim != 1 or s.shape != a.shape or s.size < 2:
            raise ValueError(
                f"blend table needs matching 1-D knot arrays of >=2 "
                f"entries, got sigma {s.shape} alpha {a.shape}")
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
        co = co[order] if co is not None else None
        if np.any((a < 0.0) | (a > 1.0)):
            raise ValueError("alpha knots must lie in [0, 1]")
        self.sigma_knots, self.alpha_knots, self.coef_knots = s, a, co
        self.meta = dict(meta or {})
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

    def _knots(self, knots: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(knots, dtype=torch.float32, device=like.device)

    def alpha(self, sigma_hat: torch.Tensor) -> torch.Tensor:
        return interp(sigma_hat, self._knots(self.sigma_knots, sigma_hat),
                      self._knots(self.alpha_knots, sigma_hat))

    def apply(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Blend model output y toward input x by the calibrated
        per-image weight. x, y: [B, H, W, C] float32 in [0, 255]."""
        s_hat = estimate_sigma(x)
        shape = (-1,) + (1,) * (y.ndim - 1)
        if self.coef_knots is not None:
            d = (y - x).float()
            n_px = float(np.prod(d.shape[1:]))
            dd = torch.sum(torch.square(d), dim=tuple(range(1, d.ndim)))
            c = interp(s_hat, self._knots(self.sigma_knots, s_hat),
                       self._knots(self.coef_knots, s_hat))
            r = n_px * torch.square(s_hat) / torch.clamp(dd, min=1e-6)
            a = torch.maximum(self.alpha(s_hat), torch.clamp(c * r, 0.0, 1.0))
        else:
            a = self.alpha(s_hat)
        a = a.reshape(shape).to(y.dtype)
        return a * y + (1.0 - a) * x
