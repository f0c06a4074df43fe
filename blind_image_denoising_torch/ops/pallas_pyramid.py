"""Laplacian band split: ``band = x − A·x``, ``smooth = A·x``.

Counterpart of ``blind_image_denoising_tpu/ops/pallas_pyramid.py``
``laplacian_band_smooth_pallas`` (Pallas body ``_band_smooth_kernel``),
which the flagship encoder computes at levels 0 and 1
(``models/unet_laplacian.py`` ``avg_pool_same`` + subtract). ``A`` is the
count-aware SAME k×k stride-1 box mean: XLA's SAME padding puts the
extra row and column of an even window on the HIGH side, and the divide
counts only the in-image taps.

CUDA kernel (``csrc/band_smooth.cu``): one pass, one thread per 16-byte
vector of channels of one pixel (NHWC). Each thread sums its k² taps in
float32 (the neighbours' loads hit L1/L2), multiplies by the reciprocal
of the in-image tap count — computed from the pixel index, not read
from a table — and writes both outputs. It is bound by memory: it must
read x once and write band and smooth once, 3·B·H·W·C·bytes against
the H100's 3.35 TB/s; it does ~k² + 2 operations per element, far
below the ridge. It is CUDA C++ rather than Triton only so that both of
the port's kernels build the same way, into one ``nvcc``-built library
(``ops/cuda_build.py``), with no extra dependency. The JAX module's host-side reciprocal table and row-padded
``[H, W·C]`` layout served the TPU's 128-lane tiling and are not carried
over.

``band_smooth`` takes NHWC tensors like the JAX function. A tensor on
the CPU goes through :func:`band_smooth_plain`, the same arithmetic in
plain PyTorch; a CUDA tensor launches the kernel or raises.
"""

from typing import Tuple

import torch

from . import cuda_build

# kernel launches made by band_smooth (the plain path does not count)
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def band_smooth_plain(x: torch.Tensor,
                      kernel_size: int = 2) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Plain PyTorch version of the kernel, in its order of operations:
    float32 tap sum (rows outer, columns inner, out-of-image taps add
    zero), times the float32 reciprocal of the in-image tap count, then
    ``band = x − smooth``; both outputs cast to the input dtype."""
    b, h, w, c = x.shape
    k = int(kernel_size)
    lo = (k - 1) // 2
    xf = x.float()
    xp = torch.nn.functional.pad(xf, (0, 0, lo, k - 1 - lo, lo, k - 1 - lo))
    acc = torch.zeros_like(xf)
    for dy in range(k):
        for dx in range(k):
            acc = acc + xp[:, dy:dy + h, dx:dx + w, :]
    rows = _valid_taps(h, k, lo, x.device)
    cols = _valid_taps(w, k, lo, x.device)
    inv = 1.0 / (rows[:, None] * cols[None, :])
    smooth = acc * inv[None, :, :, None]
    band = xf - smooth
    return band.to(x.dtype), smooth.to(x.dtype)


def _valid_taps(n: int, k: int, lo: int, device) -> torch.Tensor:
    """In-image taps of a window starting at i − lo, for each i < n."""
    i = torch.arange(n, device=device)
    first = torch.clamp(i - lo, min=0)
    last = torch.clamp(i - lo + k, max=n)
    return (last - first).float()


def band_smooth(x: torch.Tensor,
                kernel_size: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, H, W, C] → (band, smooth), both [B, H, W, C] in x's dtype."""
    global launches
    if x.ndim != 4:
        raise ValueError(f"band_smooth takes [B, H, W, C], got {x.shape}")
    if x.device.type == "cpu":
        return band_smooth_plain(x, kernel_size)
    if x.device.type != "cuda":
        raise ValueError(f"band_smooth: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"band_smooth kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    b, h, w, c = x.shape
    vec = 16 // x.element_size()
    if c % vec:
        raise ValueError(f"band_smooth kernel needs C divisible by {vec} "
                         f"for {x.dtype}, got C={c}")
    x = x.contiguous()
    band, smooth = torch.empty_like(x), torch.empty_like(x)
    if x.numel() == 0:
        return band, smooth
    lib = cuda_build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.bid_band_smooth(
            x.data_ptr(), band.data_ptr(), smooth.data_ptr(),
            b, h, w, c, int(kernel_size), _DTYPE_CODES[x.dtype], stream)
    cuda_build.check(lib, rc, "band_smooth kernel")
    launches += 1
    return band, smooth
