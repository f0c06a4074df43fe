"""Figures for training observability (counterpart of
``blind_image_denoising_tpu/visualize.py``): an image collage, boxplots
of named value distributions, weight boxplots and a per-layer weight
histogram heatmap, rendered with matplotlib (Agg) for the metrics
writer. Each figure function returns None where matplotlib does not
import, so headless training never needs it.

Params are a ``{name: tensor}`` mapping such as ``TrainState.params``;
names are shown as flax paths (``a/b/kernel``).
"""

import logging
from typing import Dict

import numpy as np

logger = logging.getLogger("blind_image_denoising_torch")


def _mpl():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError as e:
        logger.warning(f"matplotlib unavailable: {e}")
        return None


def collage(images_batch: np.ndarray) -> np.ndarray:
    """[B, H, W, C] → one tiled image, ⌈√B⌉ columns."""
    b = images_batch.shape[0]
    cols = int(np.ceil(np.sqrt(b)))
    rows = int(np.ceil(b / cols))
    _, h, w, c = images_batch.shape
    canvas = np.zeros((rows * h, cols * w, c), images_batch.dtype)
    for i in range(b):
        r, k = divmod(i, cols)
        canvas[r * h:(r + 1) * h, k * w:(k + 1) * w] = images_batch[i]
    return canvas


def _flatten_named(params, keep_ndim=None) -> Dict[str, np.ndarray]:
    out = {}
    for name, w in params.items():
        w = w.detach().float().cpu().numpy()
        if keep_ndim is None or w.ndim in keep_ndim:
            out[name.replace(".", "/")] = w.ravel()
    return out


def boxplot_figure(named_values: Dict[str, np.ndarray], title: str,
                   max_entries: int = 40):
    """Boxplot of the value distribution of each named tensor."""
    plt = _mpl()
    if plt is None:
        return None
    names = list(named_values)[:max_entries]
    data = [named_values[n] for n in names]
    fig, ax = plt.subplots(figsize=(max(6, len(names) * 0.4), 6))
    ax.boxplot(data, showfliers=False)
    ax.set_xticklabels([n.split("/")[-2] if "/" in n else n for n in names],
                       rotation=90, fontsize=6)
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    return fig


def weights_boxplot(params, title: str = "weights"):
    return boxplot_figure(_flatten_named(params, keep_ndim={2, 4}), title)


def weights_heatmap(params, bins: int = 51, value_range=(-0.5, 0.5)):
    """Per-layer weight histogram heatmap."""
    plt = _mpl()
    if plt is None:
        return None
    named = _flatten_named(params, keep_ndim={2, 4})
    if not named:
        return None
    hists = []
    for w in named.values():
        h, _ = np.histogram(w, bins=bins, range=value_range)
        hists.append(h / max(h.max(), 1))
    mat = np.stack(hists, axis=0)
    fig, ax = plt.subplots(figsize=(8, max(4, len(hists) * 0.15)))
    ax.imshow(mat, aspect="auto", cmap="viridis",
              extent=[value_range[0], value_range[1], len(hists), 0])
    ax.set_xlabel("weight value")
    ax.set_ylabel("layer index")
    ax.set_title("per-layer weight histograms")
    fig.tight_layout()
    return fig


def boxplot_from_stats(stats: Dict[str, np.ndarray],
                       title: str = "gradients", max_entries: int = 40):
    """Boxplot from precomputed five-number summaries ``{name: [min, p25,
    p50, p75, max]}`` (the train step's ``grad_stats``: only the
    summaries leave the device)."""
    plt = _mpl()
    if plt is None or not stats:
        return None
    names = list(stats)[:max_entries]
    boxes = []
    for n in names:
        lo, q1, med, q3, hi = [float(v) for v in np.asarray(stats[n])]
        boxes.append(dict(label=n.split("/")[-2] if "/" in n else n,
                          whislo=lo, q1=q1, med=med, q3=q3, whishi=hi,
                          fliers=[]))
    fig, ax = plt.subplots(figsize=(max(6, len(names) * 0.4), 6))
    ax.bxp(boxes, showfliers=False)
    ax.tick_params(axis="x", rotation=90, labelsize=6)
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    return fig
