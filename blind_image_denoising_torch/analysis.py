"""Bias-free interpretability analysis (counterpart of
``blind_image_denoising_tpu/analysis.py``): exact adaptive filters,
net-bias maps and the scale-equivariance measurement.

A denoiser without additive constants is scale-equivariant,
``f(a·x) = a·f(x)``, and exactly locally linear, ``f(x) = A(x)·x``, so
each output pixel is a weighted mask over the input pixels (the
bias-free denoising paper, arXiv:1906.05478). The pixel-domain model is
affine around the value range's center ``c`` (the normalizer maps
``x → x/255 − 0.5``), so homogeneity holds in ``d = x − c``; the tanh
head, value clipping and any gates or attention leave a small measured
net bias, which every tool returns.

* :func:`adaptive_filters`: one reverse-mode pass per output pixel over
  one shared forward (``retain_graph``) gives the exact Jacobian row of
  that pixel. JAX vmaps the cotangent rows; the port loops, since a
  kernel wrapper cannot take a batched tensor.
* :func:`net_bias_map`: one forward-mode pass (``torch.autograd.
  forward_ad``) in the direction ``x − c`` gives ``J(x)·(x − c)`` for
  the whole image at about the cost of two forwards, and the net-bias
  map ``b(x) = f(x) − c − J(x)·(x − c)``. Through the port's models the
  tangent runs the ConvNext units' PyTorch branch and the K2 kernel's
  ``jvp`` (the forward kernel on the tangent). A callable without a
  forward mode, such as a ``torch.autograd.Function`` with no ``jvp``,
  takes the reverse-over-reverse fallback, as JAX's custom-VJP layers
  do; an error the fallback cannot get past re-raises the original.
* :func:`scale_equivariance`: ``f(c + a·d) − c`` against
  ``a·(f(c + d) − c)`` for contractive factors, plain forwards.

A forward from :func:`forward_from_denoiser` runs on the Denoiser's
device; any other callable receives CPU tensors.
"""

import logging
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.autograd import forward_ad

logger = logging.getLogger("blind_image_denoising_torch")

#: pixel-domain center of the default [0, 255] value range — the point the
#: normalizer maps to 0, around which a bias-free network is positively
#: homogeneous
DEFAULT_CENTER = 127.5


def forward_from_denoiser(denoiser) -> Callable[[torch.Tensor],
                                                torch.Tensor]:
    """A differentiable single-image float forward ``f: [H, W, C] float
    in [0, 255] → [H, W, C] float32`` (``Denoiser.float_forward``) from
    the port's :class:`Denoiser`, carrying its ``device``. Anything else
    raises ``TypeError``."""
    from .inference.denoiser import Denoiser
    if not isinstance(denoiser, Denoiser):
        raise TypeError(
            "analysis needs a native-graph Denoiser (a params.msgpack "
            "artifact); other callables are not differentiable")

    def forward(x):
        return denoiser.float_forward(x)

    forward.device = denoiser.device
    return forward


def _input(forward, image) -> torch.Tensor:
    x = np.asarray(image, np.float32)
    if x.ndim != 3:
        raise ValueError(f"image must be [H, W, C], got {x.shape}")
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        getattr(forward, "device", "cpu"))


class FilterResult(NamedTuple):
    """Adaptive filters at a set of output pixels.

    filters:   [N, H, W, C] — exact Jacobian rows a_p ("weighted mask")
    outputs:   [N] — the denoised value f(x)[p] at each pixel
    bias:      [N] — net bias b_p = f(x)[p] − c − ⟨a_p, x − c⟩
    weight_sum:[N] — Σ a_p (≈1 when the output is a weighted average)
    denoised:  [H, W, C] — the full denoised image f(x)
    pixels:    the (row, col) list analyzed
    """
    filters: np.ndarray
    outputs: np.ndarray
    bias: np.ndarray
    weight_sum: np.ndarray
    denoised: np.ndarray
    pixels: Sequence[Tuple[int, int]]


def adaptive_filters(
        forward: Callable,
        image: np.ndarray,
        pixels: Sequence[Tuple[int, int]],
        channel: Optional[int] = None,
        center: float = DEFAULT_CENTER) -> FilterResult:
    """Exact adaptive-filter rows of the Jacobian of ``forward`` at
    ``image`` for each output pixel in ``pixels``. ``channel=None``
    analyzes the channel-mean output (one mask per pixel); an int selects
    that output channel (negative counts from the end)."""
    x = _input(forward, image)
    h, w = x.shape[:2]
    for (r, c) in pixels:
        if not (0 <= int(r) < h and 0 <= int(c) < w):
            raise ValueError(f"pixel ({r}, {c}) outside image {h}x{w}")
    x.requires_grad_(True)
    with torch.enable_grad():
        y = forward(x)
    n_ch = y.shape[-1]
    if channel is not None:
        channel = int(channel)
        if -n_ch <= channel < 0:
            channel += n_ch    # NumPy-style negative indexing
        if not (0 <= channel < n_ch):
            raise ValueError(f"channel {channel} outside output with "
                             f"{n_ch} channels")
    rows = [int(p[0]) for p in pixels]
    cols = [int(p[1]) for p in pixels]
    filters = []
    for i, (r, c) in enumerate(zip(rows, cols)):
        ct = torch.zeros_like(y)
        if channel is None:
            ct[r, c, :] = 1.0 / n_ch
        else:
            ct[r, c, channel] = 1.0
        filters.append(torch.autograd.grad(
            y, x, ct, retain_graph=i + 1 < len(rows))[0])
    x, y = x.detach(), y.detach()
    filters = (torch.stack(filters) if filters
               else x.new_zeros((0,) + tuple(x.shape)))
    picked = y[rows, cols, :]
    outputs = picked.mean(dim=-1) if channel is None else picked[:, channel]
    inner = torch.sum(filters * (x - center)[None], dim=(1, 2, 3))
    weight_sum = torch.sum(filters, dim=(1, 2, 3))
    bias = outputs - center - inner
    return FilterResult(
        filters=filters.cpu().numpy(),
        outputs=outputs.cpu().numpy(),
        bias=bias.cpu().numpy(),
        weight_sum=weight_sum.cpu().numpy(),
        denoised=y.cpu().numpy(),
        pixels=list(pixels),
    )


def _reverse_over_reverse(forward: Callable, x: torch.Tensor,
                          v: torch.Tensor):
    """(f(x), J(x)·v) by two reverse passes: with L(u) = ⟨Jᵀu, v⟩,
    ∇_u L = J·v."""
    xx = x.detach().requires_grad_(True)
    with torch.enable_grad():
        y = forward(xx)
        u = torch.zeros_like(y, requires_grad=True)
        (g,) = torch.autograd.grad(y, xx, u, create_graph=True)
        (jv,) = torch.autograd.grad(torch.sum(g * v), u)
    return y.detach(), jv


def net_bias_map(
        forward: Callable,
        image: np.ndarray,
        center: float = DEFAULT_CENTER) -> Tuple[np.ndarray, np.ndarray]:
    """The net-bias map of the whole image at once, ``b(x) = f(x) − c −
    J(x)·(x − c)``, from one forward-mode pass in the direction of the
    centered input (for a positively homogeneous map ``J(x)·(x − c)``
    equals ``f(x) − c``, Euler's identity, so ``b ≡ 0``).

    Returns ``(denoised, bias_map)``, both [H, W, C] float32."""
    x = _input(forward, image)
    v = x - center
    try:
        with forward_ad.dual_level():
            y, jdx = forward_ad.unpack_dual(forward(
                forward_ad.make_dual(x, v)))
        y = y.detach()
        if jdx is None:                 # the output ignores the input
            jdx = torch.zeros_like(y)
    except Exception as e:
        # no forward mode (a torch.autograd.Function without a jvp):
        # attempt the reverse-over-reverse transpose instead of matching
        # the error's wording; an error of the forward itself fails there
        # too and the original is re-raised, so nothing is masked
        try:
            y, jdx = _reverse_over_reverse(forward, x, v)
        except Exception:
            raise e
        logger.info("forward mode unsupported (a Function without jvp?); "
                    "used the double-vjp transpose for the bias map")
    bias = y - center - jdx
    return y.cpu().numpy(), bias.cpu().numpy()


def scale_equivariance(
        forward: Callable,
        image: np.ndarray,
        alphas: Sequence[float] = (0.25, 0.5, 0.75),
        center: float = DEFAULT_CENTER) -> list:
    """Measure ``f(c + a·d) − c ≈ a·(f(c + d) − c)`` for ``d = x − c``.

    Contractive ``alphas ≤ 1`` by default so the scaled input stays
    inside the value range (the normalizer clips outside it, which would
    confound the measurement). Returns one record per alpha with the
    relative L1 error."""
    x = _input(forward, image)
    d = x - center
    records = []
    with torch.no_grad():
        base = forward(x) - center
        for a in alphas:
            a = float(a)
            scaled = forward(center + a * d) - center
            target = a * base
            denom = float(torch.abs(target).mean()) + 1e-8
            err = float(torch.abs(scaled - target).mean())
            records.append({"alpha": a, "rel_error": err / denom,
                            "abs_error": err})
    return records


def filter_mass_within(filters: np.ndarray,
                       pixels: Sequence[Tuple[int, int]],
                       radius: int) -> np.ndarray:
    """Fraction of each filter's absolute mass inside a square window of
    ``radius`` around its pixel."""
    out = []
    for a, (r, c) in zip(filters, pixels):
        total = np.abs(a).sum()
        h, w = a.shape[:2]
        win = a[max(0, r - radius):min(h, r + radius + 1),
                max(0, c - radius):min(w, c + radius + 1)]
        out.append(float(np.abs(win).sum() / max(total, 1e-12)))
    return np.asarray(out)


def grid_pixels(shape: Tuple[int, int], n: int = 2,
                margin: float = 0.25) -> list:
    """An n×n grid of analysis pixels inset by ``margin`` from the
    borders — the CLI's default probe set."""
    h, w = shape
    rs = np.linspace(margin * h, (1 - margin) * h, n).round().astype(int)
    cs = np.linspace(margin * w, (1 - margin) * w, n).round().astype(int)
    return [(int(r), int(c)) for r in rs for c in cs]


def filter_figure(image: np.ndarray, result: FilterResult,
                  window: int = 33, mass_radius: int = 8):
    """The input with the probed pixels marked, beside each pixel's
    adaptive-filter mask (channel-summed, zoomed to ``window``²,
    diverging colormap centered at zero). A matplotlib figure, or None
    without matplotlib."""
    from .visualize import _mpl
    plt = _mpl()
    if plt is None:
        return None
    n = len(result.pixels)
    fig, axes = plt.subplots(1, n + 1, figsize=(3 * (n + 1), 3.4))
    axes = np.atleast_1d(axes)
    img = np.clip(np.asarray(image), 0, 255).astype(np.uint8)
    axes[0].imshow(img if img.shape[-1] != 1 else img[..., 0],
                   cmap=None if img.shape[-1] != 1 else "gray")
    for (r, c) in result.pixels:
        axes[0].plot(c, r, "r+", markersize=10, markeredgewidth=2)
    axes[0].set_title("input + probe pixels")
    axes[0].axis("off")
    half = window // 2
    mass = filter_mass_within(result.filters, result.pixels, mass_radius)
    h, w = image.shape[:2]
    for i, ((r, c), a) in enumerate(zip(result.pixels, result.filters)):
        mask = a.sum(axis=-1)
        r0, c0 = max(0, r - half), max(0, c - half)
        crop = mask[r0:min(h, r + half + 1), c0:min(w, c + half + 1)]
        vmax = max(float(np.abs(crop).max()), 1e-12)
        ax = axes[i + 1]
        ax.imshow(crop, cmap="RdBu_r", vmin=-vmax, vmax=vmax)
        ax.plot(c - c0, r - r0, "k+", markersize=8)
        ax.set_title(f"({r},{c}) Σw={result.weight_sum[i]:.2f}\n"
                     f"b={result.bias[i]:.2f} "
                     f"mass(r≤{mass_radius})={mass[i]:.2f}", fontsize=8)
        ax.axis("off")
    fig.tight_layout()
    return fig


def bias_map_figure(image: np.ndarray, denoised: np.ndarray,
                    bias: np.ndarray):
    """Input / denoised / net-bias-map triptych, or None without
    matplotlib."""
    from .visualize import _mpl
    plt = _mpl()
    if plt is None:
        return None
    fig, axes = plt.subplots(1, 3, figsize=(10.5, 3.6))
    for ax, (img, title) in zip(axes, [
            (image, "input"), (denoised, "denoised"),
            (bias, "net bias b(x)")]):
        arr = np.asarray(img)
        if title == "net bias b(x)":
            mag = arr.mean(axis=-1)
            vmax = max(float(np.abs(mag).max()), 1e-12)
            im = ax.imshow(mag, cmap="RdBu_r", vmin=-vmax, vmax=vmax)
            fig.colorbar(im, ax=ax, fraction=0.046)
        else:
            u8 = np.clip(arr, 0, 255).astype(np.uint8)
            ax.imshow(u8 if u8.shape[-1] != 1 else u8[..., 0],
                      cmap=None if u8.shape[-1] != 1 else "gray")
        ax.set_title(title)
        ax.axis("off")
    fig.tight_layout()
    return fig


def analyze(denoiser, image: np.ndarray,
            pixels: Optional[Sequence[Tuple[int, int]]] = None,
            channel: Optional[int] = None,
            alphas: Sequence[float] = (0.25, 0.5, 0.75),
            mass_radius: int = 8,
            center: float = DEFAULT_CENTER) -> tuple:
    """The whole battery on one image: ``(report, FilterResult, denoised,
    bias_map)``, ``report`` JSON-serializable (the CLI's engine)."""
    forward = forward_from_denoiser(denoiser)
    image = np.asarray(image, np.float32)
    if pixels is None:
        pixels = grid_pixels(image.shape[:2])

    denoised, bias_map = net_bias_map(forward, image, center=center)
    res = adaptive_filters(forward, image, pixels, channel=channel,
                           center=center)
    equiv = scale_equivariance(forward, image, alphas=alphas,
                               center=center)
    mass = filter_mass_within(res.filters, res.pixels, mass_radius)

    resid = np.abs(denoised - center).mean()
    report = {
        "net_bias": {
            "mean_abs": float(np.abs(bias_map).mean()),
            "max_abs": float(np.abs(bias_map).max()),
            # |b| relative to the centered output magnitude — the paper's
            # "bias is negligible" check as a number
            "rel_to_output": float(np.abs(bias_map).mean()
                                   / max(resid, 1e-12)),
        },
        "scale_equivariance": equiv,
        "filters": [
            {"pixel": [int(r), int(c)],
             "output": float(res.outputs[i]),
             "bias": float(res.bias[i]),
             "weight_sum": float(res.weight_sum[i]),
             f"mass_within_{mass_radius}px": float(mass[i])}
            for i, (r, c) in enumerate(res.pixels)
        ],
    }
    return report, res, denoised, bias_map


__all__ = [
    "DEFAULT_CENTER", "FilterResult", "forward_from_denoiser",
    "adaptive_filters", "net_bias_map", "scale_equivariance",
    "filter_mass_within", "grid_pixels", "filter_figure",
    "bias_map_figure", "analyze",
]
