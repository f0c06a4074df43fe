"""Kernel regularization penalties (counterpart of
``blind_image_denoising_tpu/ops/regularizers.py``): pure functions
``w -> scalar`` built by :func:`builder` from the config strings and
dicts the JAX package reads.

Layouts are the port's: conv kernels OIHW ``[O, I, kh, kw]`` and the
ConvNext unit's 1×1 matrices ``[out, in]``. :func:`reshape_to_2d` turns
both into ``[out, everything else]``, the JAX function's matrix up to a
column permutation, which leaves ``W·Wᵀ`` unchanged.
"""

from collections.abc import Mapping
from typing import Callable, Dict, List, Union

import numpy as np
import torch
from torch import nn

DEFAULT_KERAS_L1 = 0.01
DEFAULT_KERAS_L2 = 0.01

RegFn = Callable[[torch.Tensor], torch.Tensor]


def reshape_to_2d(w: torch.Tensor) -> torch.Tensor:
    """Kernel → ``[out_channels, rest]``."""
    if w.ndim == 4:
        return w.reshape(w.shape[0], -1)
    return w


def _wt_x_w(w: torch.Tensor) -> torch.Tensor:
    wt = reshape_to_2d(w)
    return wt @ wt.t()


def l1(w: torch.Tensor, coefficient: float = DEFAULT_KERAS_L1) -> torch.Tensor:
    return coefficient * torch.sum(torch.abs(w))


def l2(w: torch.Tensor, coefficient: float = DEFAULT_KERAS_L2) -> torch.Tensor:
    return coefficient * torch.sum(torch.square(w))


def l1l2(w: torch.Tensor, l1_coefficient: float = DEFAULT_KERAS_L1,
         l2_coefficient: float = DEFAULT_KERAS_L2) -> torch.Tensor:
    return l1(w, l1_coefficient) + l2(w, l2_coefficient)


def soft_orthogonal(w: torch.Tensor, lambda_coefficient: float = 1.0,
                    l1_coefficient: float = 0.01,
                    l2_coefficient: float = 0.0) -> torch.Tensor:
    """λ·||off-diag(W Wᵀ)||_F² + L1/L2 on the off-diagonal."""
    wtw = _wt_x_w(w)
    masked = wtw * (1.0 - torch.eye(wtw.shape[0], dtype=wtw.dtype,
                                    device=wtw.device))
    result = torch.zeros((), dtype=w.dtype, device=w.device)
    if lambda_coefficient > 0.0:
        result = result + lambda_coefficient * torch.sum(torch.square(masked))
    if l1_coefficient > 0.0:
        result = result + l1(masked, l1_coefficient)
    if l2_coefficient > 0.0:
        result = result + l2(masked, l2_coefficient)
    return result


def soft_orthonormal(w: torch.Tensor, lambda_coefficient: float = 1.0,
                     l1_coefficient: float = 0.001,
                     l2_coefficient: float = 0.0) -> torch.Tensor:
    """λ·||W Wᵀ − I||_F² + L1/L2 on W Wᵀ."""
    wtw = _wt_x_w(w)
    eye = torch.eye(wtw.shape[0], dtype=wtw.dtype, device=wtw.device)
    result = torch.zeros((), dtype=w.dtype, device=w.device)
    if lambda_coefficient > 0.0:
        result = result + lambda_coefficient * torch.sum(
            torch.square(wtw - eye))
    if l1_coefficient > 0.0:
        result = result + l1(wtw, l1_coefficient)
    if l2_coefficient > 0.0:
        result = result + l2(wtw, l2_coefficient)
    return result


def _center_mask(kh: int, kw: int) -> np.ndarray:
    """Center-peaked spatial mask in [0, 1]: 1 at the kernel centre,
    falling towards the edges."""
    ys = np.linspace(-1.0, 1.0, kh) if kh > 1 else np.zeros((1,))
    xs = np.linspace(-1.0, 1.0, kw) if kw > 1 else np.zeros((1,))
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    return np.exp(-(yy ** 2 + xx ** 2) / 0.5).astype(np.float32)


def erf(w: torch.Tensor, l1_coefficient: float = 0.025,
        l2_coefficient: float = 0.0) -> torch.Tensor:
    """ERF regularizer: L1/L2 of the kernel weighted by the centre mask
    over its spatial dims (OIHW: dims 2 and 3); plain L1/L2 for a matrix."""
    if w.ndim != 4:
        return l1l2(w, l1_coefficient, l2_coefficient)
    mask = torch.as_tensor(_center_mask(w.shape[2], w.shape[3]),
                           dtype=w.dtype, device=w.device)
    result = torch.zeros((), dtype=w.dtype, device=w.device)
    if l1_coefficient > 0.0:
        result = result + l1_coefficient * torch.sum(torch.abs(w) * mask)
    if l2_coefficient > 0.0:
        result = result + l2_coefficient * torch.sum(torch.square(w) * mask)
    return result


def _builder_helper(config: Union[str, Dict, Callable]) -> RegFn:
    if callable(config):
        return config
    if isinstance(config, str):
        reg_type, params = config, {}
    elif isinstance(config, Mapping):
        reg_type, params = config.get("type"), dict(config.get("config", {}))
    else:
        raise ValueError(f"don't know how to handle config [{config}]")
    if not isinstance(reg_type, str) or not reg_type.strip():
        raise ValueError(f"invalid regularization type [{reg_type}]")
    key = reg_type.strip().lower()
    if key == "l1":
        c = params.get("l1", DEFAULT_KERAS_L1)
        return lambda w: l1(w, c)
    if key == "l2":
        c = params.get("l2", DEFAULT_KERAS_L2)
        return lambda w: l2(w, c)
    if key == "l1l2":
        c1 = params.get("l1", DEFAULT_KERAS_L1)
        c2 = params.get("l2", DEFAULT_KERAS_L2)
        return lambda w: l1l2(w, c1, c2)
    fns = {"soft_orthonormal": soft_orthonormal,
           "soft_orthogonal": soft_orthogonal, "erf": erf}
    if key in fns:
        return lambda w: fns[key](w, **params)
    raise ValueError(f"unknown regularization type [{reg_type}]")


def builder(config: Union[str, Dict, List]) -> RegFn:
    """A single or summed regularization function from a config string,
    dict or list of them."""
    if config is None:
        raise ValueError("config cannot be None")
    if isinstance(config, (list, tuple)):
        fns = [_builder_helper(c) for c in config]
        return lambda w: sum(fn(w) for fn in fns)
    return _builder_helper(config)


def soft_ortho_spec(orthonormal: bool) -> Dict:
    """The soft-orthonormal/orthogonal spec the ConvNext units and the
    attention convs use, with the JAX package's default coefficients."""
    return {"type": "soft_orthonormal" if orthonormal else "soft_orthogonal",
            "config": {"lambda_coefficient": 0.01, "l1_coefficient": 0.0,
                       "l2_coefficient": 1e-4}}


def regularization_loss(model: nn.Module) -> torch.Tensor:
    """The sum of every submodule's ``penalty()`` in float32 — the
    counterpart of summing the JAX model's sown ``losses`` collection
    (``training/losses.py`` ``sum_losses_collection``)."""
    terms = [m.penalty() for m in model.modules() if hasattr(m, "penalty")]
    terms = [t for t in terms if t is not None]
    if not terms:
        p = next(model.parameters(), None)
        return torch.zeros((), device=None if p is None else p.device)
    return torch.stack([t.float() for t in terms]).sum()
