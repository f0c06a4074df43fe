"""Float32 that is float32 on the card, and the forward-mode test the
kernel wrappers share.

PyTorch's defaults let cuDNN run float32 convolutions on TF32 tensor
cores (``torch.backends.cudnn.allow_tf32 = True``), which round each
input to a 10-bit mantissa, and a caller may switch TF32 on for matmuls
too. JAX's float32 does neither, so the port's float32 forwards run
inside :func:`exact_float32`, which turns both off for its block and
restores the caller's settings afterwards. No global flag is left
changed, and bf16 compute is not affected.
"""

import contextlib

import torch
from torch.autograd import forward_ad


@contextlib.contextmanager
def exact_float32(enabled: bool = True):
    """Within the block, float32 convolutions and matmuls run without
    TF32. ``enabled=False`` makes it a no-op (a bf16 or CPU forward)."""
    if not enabled:
        yield
        return
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = False
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def has_tangent(x: torch.Tensor) -> bool:
    """Whether x carries a forward-mode tangent (a dual tensor of
    ``torch.autograd.forward_ad``). Such a tensor has ``requires_grad``
    False, so a test of that alone would hand it to a kernel that drops
    the tangent."""
    return forward_ad.unpack_dual(x).tangent is not None
