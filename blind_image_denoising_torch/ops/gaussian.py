"""Gaussian kernels and the depthwise Gaussian blur (counterpart of
``blind_image_denoising_tpu/ops/gaussian.py``).

The kernel is built in float64 (linspace grid over ±nsig, unit sigma,
normalized) and cast to the input's dtype; the blur is a depthwise conv
with XLA SAME zero padding (not count-aware). The blur takes NHWC
tensors, as the JAX function does.
"""

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from .quant import conv_nchw


@lru_cache(maxsize=None)
def _gaussian_kernel_2d_np(size: Tuple[int, int],
                           nsig: Tuple[float, float]) -> np.ndarray:
    kern1d = [np.linspace(start=-abs(nsig[i]), stop=abs(nsig[i]),
                          num=size[i], endpoint=True, dtype=np.float64)
              for i in range(2)]
    x, y = np.meshgrid(kern1d[0], kern1d[1], indexing="ij")
    g = np.exp(-(x * x + y * y) / 2.0)
    return g / g.sum()


def gaussian_kernel_2d(size=(5, 5), nsig=(2.0, 2.0),
                       dtype=np.float32) -> np.ndarray:
    """2D normalized Gaussian grid, [size[0], size[1]]."""
    return _gaussian_kernel_2d_np(tuple(size), tuple(
        float(n) for n in nsig)).astype(dtype)


def depthwise_gaussian_kernel(channels: int, kernel_size=(5, 5),
                              nsig=(2.0, 2.0),
                              dtype=np.float32) -> np.ndarray:
    """HWIO depthwise kernel [kh, kw, 1, channels], the JAX layout."""
    g = gaussian_kernel_2d(kernel_size, nsig, dtype)
    return np.ascontiguousarray(np.broadcast_to(
        g[:, :, None, None], tuple(kernel_size) + (1, channels)))


def gaussian_blur(x: torch.Tensor, kernel_size=(5, 5), nsig=None,
                  strides=(1, 1), padding: str = "SAME") -> torch.Tensor:
    """Depthwise Gaussian blur of NHWC x; ``nsig`` None is
    ((kh-1)/2, (kw-1)/2)."""
    if nsig is None:
        nsig = ((kernel_size[0] - 1) / 2.0, (kernel_size[1] - 1) / 2.0)
    c = x.shape[-1]
    g = torch.from_numpy(gaussian_kernel_2d(tuple(kernel_size), tuple(nsig),
                                            np.float64))
    kernel = g.to(x.dtype).to(x.device).expand(c, 1, *g.shape).contiguous()
    y = conv_nchw(x.permute(0, 3, 1, 2), kernel, tuple(strides), padding,
                  c)
    return y.permute(0, 2, 3, 1)
