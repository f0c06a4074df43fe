"""Gaussian kernels and the depthwise Gaussian blur (counterpart of
``blind_image_denoising_tpu/ops/gaussian.py``).

The kernel is built in float64 (linspace grid over ±nsig, unit sigma,
normalized) and cast to the input's dtype; the blur is a depthwise conv
with XLA SAME zero padding (not count-aware). The blur takes NHWC
tensors, as the JAX function does; each device keeps its kernels, so a
forward on the card copies nothing from the host.
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


# the depthwise kernels on their devices, made once: a copy from host
# memory in a forward would wait for the device (a train step's teacher
# runs v5.6's blurs)
_DEVICE_KERNELS = {}


def _device_kernel(c: int, size: Tuple[int, int], nsig: Tuple[float, float],
                   dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """[c, 1, kh, kw] in ``dtype`` on ``device``: the float64 grid cast,
    then moved."""
    key = (c, size, nsig, dtype, device)
    kernel = _DEVICE_KERNELS.get(key)
    if kernel is None:
        # a plain tensor even when first made under inference_mode, so a
        # later forward under autograd may save it for its backward
        with torch.inference_mode(False):
            g = torch.from_numpy(gaussian_kernel_2d(size, nsig, np.float64))
            kernel = g.to(dtype).expand(c, 1, *g.shape).contiguous().to(
                device)
        _DEVICE_KERNELS[key] = kernel
    return kernel


def gaussian_blur(x: torch.Tensor, kernel_size=(5, 5), nsig=None,
                  strides=(1, 1), padding: str = "SAME") -> torch.Tensor:
    """Depthwise Gaussian blur of NHWC x; ``nsig`` None is
    ((kh-1)/2, (kw-1)/2)."""
    if nsig is None:
        nsig = ((kernel_size[0] - 1) / 2.0, (kernel_size[1] - 1) / 2.0)
    c = x.shape[-1]
    kernel = _device_kernel(c, tuple(kernel_size),
                            tuple(float(n) for n in nsig), x.dtype, x.device)
    y = conv_nchw(x.permute(0, 3, 1, 2), kernel, tuple(strides), padding,
                  c)
    return y.permute(0, 2, 3, 1)
