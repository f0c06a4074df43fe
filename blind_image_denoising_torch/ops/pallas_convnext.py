"""One ConvNext residual unit at inference, fused into one kernel:

    t   = LayerNorm(depthwise_KxK(x))      # f32 statistics, eps 1e-3, scale only
    h   = leaky_relu(W2 · t, 0.1)          # 1×1, C → E = 4C
    p   = W3 · h                           # 1×1, E → C
    out = x + gain · p                     # gain = tanh(relu(1 + w)), + skip

Counterpart of ``blind_image_denoising_tpu/ops/pallas_convnext.py``
``fused_convnext_block`` (Pallas body ``_block_kernel``, float I/O mode)
and of its oracle ``convnext_block_reference``. The flagship runs it 10
times per forward: at (C, K) = (32, 3) four times at full resolution and
(64, 5) six times at half resolution.

CUDA kernel (``csrc/convnext_block.cu``). Per pixel the unit does about
2K²C + 16C² operations against 2·C·bytes of I/O: ≈ 17 k operations per
128 B at (32, 3) in bf16 and ≈ 69 k per 256 B at (64, 5), so it sits
below or near the H100's 295 operations-per-byte ridge only if the two
1×1 products run on the tensor cores. Design:
* a block owns a tile of output pixels of one image and walks over tiles
  (persistent blocks), so W2, W3 and the depthwise weights are staged
  into shared memory once per block (64 KB of bf16 at C = 64, above the
  48 KB default, hence the dynamic shared-memory attribute);
* the input tile plus its (K−1)/2 halo is copied into shared memory with
  zeros outside the image (SAME padding on all four borders);
* one thread per pixel computes the depthwise K×K sum and the LayerNorm
  in float32 and stores ``t`` as bf16;
* each warp then runs the two products for 16 pixels at a time with
  ``mma.sync`` m16n8k16 (bf16 operands, float32 accumulation); the
  expansion's accumulators become the projection's A operand in
  registers, in chunks of 64 of the E channels, so ``h`` never leaves
  the registers;
* the epilogue adds ``x + gain·p`` in float32 and writes the tile with
  16-byte stores.
In float32 mode (``dtype="float32"`` serving) every operation is float32
on the CUDA cores, one thread per pixel. The JAX kernel's padded-row
channels-first layout and column masks served the TPU's lane tiling and
are not carried over; the int8 I/O mode is not ported yet (ROADMAP
Queue 2, K1).

``convnext_block`` takes NHWC tensors like the JAX oracle. A tensor on
the CPU goes through :func:`convnext_block_plain`, the same arithmetic
and rounding points in plain PyTorch; a CUDA tensor launches the kernel
or raises.
"""

import torch
import torch.nn.functional as F

from ..constants import DEFAULT_LN_EPSILON
from . import cuda_build

# kernel launches made by convnext_block (the plain path does not count)
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (C, K) instantiated in csrc/convnext_block.cu; E = 4C
KERNEL_SHAPES = frozenset({(32, 3), (64, 5)})


def _round_bf16(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).float()


def convnext_block_plain(x, dw, ln_scale, w2, w3, gain, slope: float = 0.1):
    """Plain PyTorch version of the kernel. x: [B, H, W, C] float32 or
    bfloat16. In bfloat16 the products see bf16 operands (``t``, ``h``
    and the weights rounded to bf16) with float32 sums, as the tensor
    cores do; everything else is float32. Returns x's dtype."""
    b, h, w, c = x.shape
    k = dw.shape[-1]
    pad = k // 2
    bf16 = x.dtype == torch.bfloat16
    xf = x.float()
    xp = F.pad(xf, (0, 0, pad, pad, pad, pad))
    dwf = dw.float().reshape(c, k, k)
    acc = torch.zeros_like(xf)
    for dy in range(k):
        for dx in range(k):
            acc = acc + xp[:, dy:dy + h, dx:dx + w, :] * dwf[:, dy, dx]
    mean = acc.mean(dim=-1, keepdim=True)
    cent = acc - mean
    var = (cent * cent).mean(dim=-1, keepdim=True)
    t = cent * torch.rsqrt(var + DEFAULT_LN_EPSILON) * ln_scale.float()
    w2f, w3f = w2.float(), w3.float()
    if bf16:
        t, w2f, w3f = _round_bf16(t), _round_bf16(w2f), _round_bf16(w3f)
    hid = F.leaky_relu(t @ w2f.t(), slope)
    if bf16:
        hid = _round_bf16(hid)
    p = hid @ w3f.t()
    return (xf + gain.float() * p).to(x.dtype)


def convnext_block(x, dw, ln_scale, w2, w3, gain, slope: float = 0.1):
    """One fused ConvNext residual unit. x: [B, H, W, C] float32/bfloat16;
    dw: [C, 1, K, K] or [C, K, K] depthwise kernel; ln_scale: [C];
    w2: [E, C]; w3: [C, E]; gain: [C], the activated
    tanh(relu(1 + w)). Returns [B, H, W, C] in x's dtype."""
    global launches
    if x.ndim != 4:
        raise ValueError(f"convnext_block takes [B, H, W, C], got {x.shape}")
    if x.device.type == "cpu":
        return convnext_block_plain(x, dw, ln_scale, w2, w3, gain, slope)
    if x.device.type != "cuda":
        raise ValueError(f"convnext_block: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"convnext_block kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    b, h, w, c = x.shape
    k = dw.shape[-1]
    e = w2.shape[0]
    if (c, k) not in KERNEL_SHAPES or e != 4 * c:
        raise NotImplementedError(
            f"convnext_block kernel is built for (C, K) in "
            f"{sorted(KERNEL_SHAPES)} with E = 4C, got C={c} K={k} E={e}")
    if (tuple(w2.shape) != (e, c) or tuple(w3.shape) != (c, e)
            or dw.numel() != c * k * k or ln_scale.numel() != c
            or gain.numel() != c):
        raise ValueError("convnext_block: weight shapes do not match x")
    tensors = (dw, ln_scale, w2, w3, gain)
    if any(t.device != x.device for t in tensors):
        raise ValueError("convnext_block: weights must be on x's device")
    x = x.contiguous()
    dw_f = dw.reshape(c, k * k).float().contiguous()
    ln_f = ln_scale.float().contiguous()
    gain_f = gain.float().contiguous()
    w2_io = w2.to(x.dtype).contiguous()
    w3_io = w3.to(x.dtype).contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = cuda_build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.bid_convnext_block(
            x.data_ptr(), out.data_ptr(), dw_f.data_ptr(), ln_f.data_ptr(),
            w2_io.data_ptr(), w3_io.data_ptr(), gain_f.data_ptr(),
            b, h, w, c, k, _DTYPE_CODES[x.dtype], float(slope), stream)
    cuda_build.check(lib, rc, "convnext_block kernel")
    launches += 1
    return out
