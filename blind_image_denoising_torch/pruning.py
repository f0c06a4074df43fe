"""Post-hoc weight pruning (counterpart of
``blind_image_denoising_tpu/pruning.py``).

Strategies: NONE, MINIMUM_THRESHOLD (zero small weights),
MINIMUM_THRESHOLD_BIFURCATE (re-randomize small weights from a seeded
generator, then re-threshold), MINIMUM_THRESHOLD_SHRINKAGE (shrink, then
threshold), PCA_PROJECTION (the low-rank PCA reconstruction at a target
explained variance, by an economic SVD) and DROP_BOTTOM (zero the bottom
fraction by magnitude). They are the JAX module's numpy code, so the
same arrays give the same values, bit for bit.

The strategies act on flax-layout kernels: 4-D HWIO ``kernel`` leaves,
which PCA_PROJECTION reshapes to (H·W·I, O). The port keeps OIHW kernels
and a ConvNext unit's 1×1 weights as [out, in] matrices, so
:func:`prune_params` on the port's tensors goes through
``weights.flax_from_params`` → prune → ``weights.params_from_flax``: the
pruned set and the layout are JAX's by construction. It runs on the host
(``train.prune`` prunes once per epoch)."""

import logging
import re
from enum import Enum
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .weights import flax_from_params, params_from_flax

logger = logging.getLogger("blind_image_denoising_torch")

PruneFn = Callable[[np.ndarray], np.ndarray]


class PruneStrategy(Enum):
    NONE = 0
    MINIMUM_THRESHOLD = 1
    MINIMUM_THRESHOLD_BIFURCATE = 2
    MINIMUM_THRESHOLD_SHRINKAGE = 3
    PCA_PROJECTION = 4
    DROP_BOTTOM = 5

    @staticmethod
    def from_string(type_str: str) -> "PruneStrategy":
        if type_str is None or not isinstance(type_str, str) \
                or not type_str.strip():
            raise ValueError(f"invalid prune strategy [{type_str}]")
        return PruneStrategy[type_str.strip().upper()]

    def to_string(self) -> str:
        return self.name


def _kernel_to_matrix(w: np.ndarray):
    """HWIO kernel → (H·W·I, O) matrix and its shape."""
    return w.reshape(-1, w.shape[-1]), w.shape


def prune_strategy_helper(strategy: PruneStrategy, **kwargs) -> PruneFn:
    if strategy == PruneStrategy.NONE:
        return lambda x: x

    if strategy == PruneStrategy.MINIMUM_THRESHOLD:
        t = kwargs["minimum_threshold"]

        def fn(x):
            y = x.copy()
            y[np.abs(y) < t] = 0.0
            return y
        return fn

    if strategy == PruneStrategy.MINIMUM_THRESHOLD_BIFURCATE:
        t = kwargs["minimum_threshold"]
        seed = kwargs.get("seed", 0)

        def fn(x):
            rng = np.random.default_rng(seed)
            y = x.copy()
            mask = np.abs(y) < t
            y[mask] = rng.uniform(-2.0 * t, 2.0 * t, size=mask.sum())
            y[np.abs(y) < t] = 0.0
            return y
        return fn

    if strategy == PruneStrategy.MINIMUM_THRESHOLD_SHRINKAGE:
        t = kwargs["minimum_threshold"]
        shrinkage = kwargs["shrinkage"]
        st = kwargs["shrinkage_threshold"]

        def fn(x):
            y = x.copy()
            mask = np.abs(y) < st
            y[mask] *= shrinkage
            y[np.abs(y) < t] = 0.0
            return y
        return fn

    if strategy == PruneStrategy.PCA_PROJECTION:
        variance = kwargs["variance"]   # target explained-variance ratio
        scale = kwargs.get("scale", True)

        def fn(x):
            if x.ndim < 2:
                return x
            mat, shape = _kernel_to_matrix(x)
            mu, sd = 0.0, 1.0
            if scale:
                mu, sd = mat.mean(), mat.std() + 1e-12
                mat = (mat - mu) / sd
            col_mean = mat.mean(axis=0, keepdims=True)
            centered = mat - col_mean
            u, s, vt = np.linalg.svd(centered, full_matrices=False)
            explained = (s ** 2) / max((s ** 2).sum(), 1e-12)
            k = int(np.searchsorted(np.cumsum(explained), variance) + 1)
            k = min(k, len(s))
            recon = (u[:, :k] * s[:k]) @ vt[:k] + col_mean
            if scale:
                recon = recon * sd + mu
            return recon.reshape(shape).astype(x.dtype)
        return fn

    if strategy == PruneStrategy.DROP_BOTTOM:
        percentage = kwargs["percentage"]

        def fn(x):
            y = x.copy()
            flat = np.sort(np.abs(y), axis=None)
            idx = min(len(flat) - 1, int(round(len(flat) * percentage)))
            y[np.abs(y) < flat[idx]] = 0.0
            return y
        return fn

    raise ValueError(f"invalid strategy [{strategy}]")


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """``flax.traverse_util.flatten_dict(tree, sep="/")``."""
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            flat.update(_flatten(val, path + "/"))
        else:
            flat[path] = val
    return flat


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, val in flat.items():
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val
    return tree


def _is_state_dict(params) -> bool:
    return bool(params) and all(isinstance(v, torch.Tensor)
                                for v in params.values())


def _flax_params(params) -> Dict:
    """A flax params tree from a flax tree or the port's name → tensor
    dict."""
    if _is_state_dict(params):
        return flax_from_params(params).get("params", {})
    return params


def get_conv_weights(params, path_pattern: str = "kernel"
                     ) -> List[np.ndarray]:
    """The 4-D conv kernels (flax HWIO) of a params tree or of the port's
    name → tensor dict whose flax path matches ``path_pattern``."""
    pat = re.compile(path_pattern)
    return [np.asarray(w) for path, w in _flatten(_flax_params(params)).items()
            if pat.search(path) and np.ndim(w) == 4]


def prune_params(params, prune_fn: PruneFn, path_pattern: str = "kernel"):
    """``prune_fn`` on every 4-D conv kernel whose flax path matches
    ``path_pattern``. ``params``: a flax params tree (numpy leaves; a new
    tree returns) or the port's name → tensor dict (``state.params``,
    ``state.ema_params``; a new dict of float32 CPU tensors under the
    same names returns, the pruned kernels in the port's layout)."""
    port = _is_state_dict(params)
    flat = _flatten(_flax_params(params))
    pat = re.compile(path_pattern)
    out = {}
    pruned_count = 0
    for path, w in flat.items():
        if pat.search(path) and np.ndim(w) == 4:
            out[path] = prune_fn(np.asarray(w))
            pruned_count += 1
        else:
            out[path] = w
    logger.info(f"pruned {pruned_count} conv kernels")
    tree = _unflatten(out)
    return params_from_flax(tree) if port else tree


def prune_function_builder(config: Optional[Dict]) -> PruneFn:
    """Config ``{"strategy": NAME, "config": {...}}`` → prune fn."""
    if config is None or not config:
        return prune_strategy_helper(PruneStrategy.NONE)
    strategy = PruneStrategy.from_string(config.get("strategy", "NONE"))
    params = dict(config.get("config", {}))
    return prune_strategy_helper(strategy, **params)
