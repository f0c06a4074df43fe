"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and ``nvcc`` and skips without
them. Run on a machine with the card (this file imports no JAX, so the
JAX-only ``conftest.py`` is bypassed):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: float32 outputs agree to 1e-5 for the band split (same
arithmetic, same order) and 1e-3 for the ConvNext unit (the kernel sums
in another order than the plain matmuls); bfloat16 band-split outputs to
one bf16 ulp of the output and ConvNext-unit outputs to 0.05, or one bf16
ulp where the output is large enough (|out| >= 8) for one ulp to exceed
0.05: the kernel sums the products in another order than the plain
matmuls, which can flip the final bf16 rounding.
"""

import numpy as np
import pytest
import torch

from blind_image_denoising_torch.ops import (cuda_build, pallas_convnext,
                                             pallas_pyramid)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 numbers at |v| (8 significant bits)."""
    a = v.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def test_kernels_build(dev):
    path = cuda_build.build(verbose=True)
    assert path.is_file()
    cuda_build.library()


@pytest.mark.parametrize("shape", [(2, 64, 64, 32), (1, 37, 53, 64),
                                   (8, 256, 256, 32)])
@pytest.mark.parametrize("k", [2, 3, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_smooth_kernel_matches_plain(dev, shape, k, dtype):
    g = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(shape, generator=g).to(dev, dtype)
    before = pallas_pyramid.launches
    band, smooth = pallas_pyramid.band_smooth(x, k)
    torch.cuda.synchronize()
    assert pallas_pyramid.launches == before + 1
    band_p, smooth_p = pallas_pyramid.band_smooth_plain(x, k)
    for got, ref in ((band, band_p), (smooth, smooth_p)):
        assert got.dtype == dtype and got.shape == x.shape
        err = (got.float() - ref.float()).abs()
        if dtype == torch.float32:
            assert float(err.max()) <= 1e-5
        else:
            assert bool((err <= _bf16_ulp(ref)).all())


def _unit_weights(c, k, dev, seed=0):
    rng = np.random.default_rng(seed)
    e = 4 * c
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa
    return dict(
        dw=t(rng.normal(0, 0.3, (c, 1, k, k))),
        ln_scale=t(rng.uniform(0.5, 1.5, (c,))),
        w2=t(rng.normal(0, 1.0 / np.sqrt(c), (e, c))),
        w3=t(rng.normal(0, 1.0 / np.sqrt(e), (c, e))),
        gain=t(rng.uniform(0.3, 0.9, (c,))))


@pytest.mark.parametrize("ck", sorted(pallas_convnext.KERNEL_SHAPES))
@pytest.mark.parametrize("hw", [(16, 64), (13, 45)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_convnext_kernel_matches_plain(dev, ck, hw, dtype):
    c, k = ck
    w = _unit_weights(c, k, dev)
    g = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randn((2, hw[0], hw[1], c), generator=g).to(dev, dtype)
    before = pallas_convnext.launches
    got = pallas_convnext.convnext_block(x, **w)
    torch.cuda.synchronize()
    assert pallas_convnext.launches == before + 1
    ref = pallas_convnext.convnext_block_plain(x, **w)
    assert got.dtype == dtype and got.shape == x.shape
    diff = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-3
    else:
        tol = torch.clamp(_bf16_ulp(ref), min=0.05)
        assert bool((diff <= tol).all()), float(diff.max())


def test_convnext_kernel_rejects_unbuilt_shape(dev):
    w = _unit_weights(16, 3, dev)
    x = torch.zeros((1, 8, 8, 16), device=dev)
    with pytest.raises(NotImplementedError):
        pallas_convnext.convnext_block(x, **w)


def test_flagship_f32_serving_on_card_matches_cpu(dev):
    """dtype="float32" serving runs K1's CUDA-core path and K2 in f32 on
    the card; with TF32 off it must agree with the CPU plain path to one
    gray level, exactly on >= 99% of pixels."""
    import blind_image_denoising_torch as bidt
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:100, 0:90].astype(np.float32)
    clean = np.stack([yy * 2.0, xx * 2.5, (yy + xx) * 1.2], -1)[None]
    img = np.clip(np.round(clean + rng.normal(0, 15, (2, 100, 90, 3))),
                  0, 255).astype(np.uint8)
    card = bidt.load_model("unet_laplacian_v6_tpu_scratch", dtype="float32")
    cpu = bidt.load_model("unet_laplacian_v6_tpu_scratch", device="cpu",
                          dtype="float32")
    k1, k2 = pallas_convnext.launches, pallas_pyramid.launches
    got = card(img)
    assert (pallas_convnext.launches - k1, pallas_pyramid.launches - k2) \
        == (10, 2)
    diff = np.abs(got.astype(int) - cpu(img).astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
