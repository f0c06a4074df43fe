"""The port's training noise against the JAX package, on the CPU.

* Philox4x32-10 (``ops/pallas_noise.philox4x32_10``, the generator the
  CUDA kernel K3 carries) against a scalar Python Philox written here and
  against Random123's known answers.
* K3's plain version ``corrupt_batch_plain`` (what ``corrupt_noise`` runs
  on a CPU tensor): deterministic per seed, different across seeds,
  integer output, the mean of a constant-128 batch kept within 1.0, and
  a configuration without noise rounds only.
* Distribution: K3's plain version, the port's exact ``corrupt_batch``
  and JAX ``ops/noise.corrupt_batch`` on the same 128-sample batch each
  noise about half the samples of each kind (0.5 ± 0.15), give
  per-sample residual stds inside the configured σ range (residual std /
  0.8796, the std of a ±2-truncated normal, within 10% of [lo, hi]) and
  keep |noise| ≤ 2σ + 0.5.
* The JAX Pallas K3 itself can only be held by its contract on the CPU:
  in interpret mode its PRNG returns zeros (tests/test_pallas_kernels.py),
  so its statistics exist only on a TPU. Here: its no-noise path against
  the port's, and its shape in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blind_image_denoising_tpu.ops.noise import (
    corrupt_batch as jax_corrupt_batch, random_flips as jax_random_flips)
from blind_image_denoising_tpu.ops.pallas_noise import corrupt_batch_pallas
from blind_image_denoising_torch.ops import noise, pallas_noise

TRUNC_STD = 0.87962566103423978
M32 = 0xFFFFFFFF


def _scalar_philox(c, k):
    """Philox4x32-10 on Python ints (Random123)."""
    c, k = list(c), list(k)
    for r in range(10):
        if r:
            k = [(k[0] + 0x9E3779B9) & M32, (k[1] + 0xBB67AE85) & M32]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & M32, (p0 >> 32) ^ c[3] ^ k[1],
             p0 & M32]
    return c


def _philox_torch(c, k):
    t = [torch.tensor([v], dtype=torch.int64) for v in c]
    return [int(v) for v in pallas_noise.philox4x32_10(t, k)]


@pytest.mark.parametrize("counter,key,expected", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((M32,) * 4, (M32, M32), (0x408f276d, 0x41c83b0e, 0xa20bc7c6,
                              0x6d5451fd)),
])
def test_philox_known_answers(counter, key, expected):
    assert tuple(_philox_torch(counter, key)) == expected
    assert tuple(_scalar_philox(counter, key)) == expected


def test_philox_matches_scalar_reference():
    rng = np.random.default_rng(0)
    for _ in range(64):
        c = [int(v) for v in rng.integers(0, 2 ** 32, 4, dtype=np.uint64)]
        k = tuple(int(v) for v in rng.integers(0, 2 ** 32, 2,
                                               dtype=np.uint64))
        assert _philox_torch(c, k) == _scalar_philox(c, k)


def _constant(b=8, h=32, w=32, v=128.0):
    return torch.full((b, h, w, 3), v)


def test_plain_deterministic_integer_mean_kept():
    x = _constant(16)
    kw = dict(additive_noise=[5, 20], multiplicative_noise=[0.05, 0.1])
    y = pallas_noise.corrupt_batch_plain(42, x, **kw)
    assert torch.equal(y, torch.round(y))
    assert abs(float(y.mean()) - 128.0) < 1.0
    assert torch.equal(y, pallas_noise.corrupt_batch_plain(42, x, **kw))
    assert not torch.equal(y, pallas_noise.corrupt_batch_plain(43, x, **kw))
    assert float(y.reshape(16, -1).std(dim=1).max()) > 0
    # the wrapper takes the plain path on a CPU tensor and counts nothing
    before = pallas_noise.launches
    assert torch.equal(pallas_noise.corrupt_noise(42, x, **kw), y)
    assert pallas_noise.launches == before


def test_no_noise_config_rounds_only():
    x = torch.full((2, 16, 16, 3), 100.5)
    y = pallas_noise.corrupt_batch_plain(0, x)
    torch.testing.assert_close(y, torch.full_like(x, 100.0), rtol=0, atol=0)
    ref = corrupt_batch_pallas(0, jnp.asarray(x.numpy()), additive_noise=None,
                               multiplicative_noise=None)
    np.testing.assert_array_equal(y.numpy(), np.asarray(ref))


def test_jax_pallas_kernel_contract_in_interpret_mode():
    from jax.experimental.pallas import tpu as pltpu
    x = jnp.full((2, 32, 16, 3), 128.0, jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        y = corrupt_batch_pallas(1, x, additive_noise=[5, 10])
    assert np.asarray(y).shape == (2, 32, 16, 3)


def test_sample_params_shared_by_every_element():
    """The per-sample header is one Philox stream: the flags say which
    samples changed, and the stds lie in their ranges."""
    x = _constant(32, 8, 8)
    y, p = pallas_noise.corrupt_batch_plain(
        5, x, additive_noise=[5, 40], multiplicative_noise=[0.05, 0.1],
        round_values=False, return_params=True)
    changed = (y != x).reshape(32, -1).any(dim=1)
    assert torch.equal(changed, (p[:, 0] > 0) | (p[:, 2] > 0))
    assert bool(((p[:, 1] >= 0.05) & (p[:, 1] <= 0.1)).all())
    assert bool(((p[:, 3] >= 5) & (p[:, 3] <= 40)).all())


def _jax(x, kind, lo, hi):
    key = jax.random.PRNGKey(3)
    arg = {"additive_noise" if kind == "add" else "multiplicative_noise":
           [lo, hi]}
    return np.asarray(jax_corrupt_batch(key, jnp.asarray(x), **arg))


def _port_exact(x, kind, lo, hi):
    g = torch.Generator().manual_seed(3)
    arg = {"additive_noise" if kind == "add" else "multiplicative_noise":
           [lo, hi]}
    return noise.corrupt_batch(g, torch.from_numpy(x), **arg).numpy()


def _port_k3(x, kind, lo, hi):
    arg = {"additive_noise" if kind == "add" else "multiplicative_noise":
           [lo, hi]}
    return pallas_noise.corrupt_batch_plain(3, torch.from_numpy(x),
                                            **arg).numpy()


@pytest.mark.parametrize("impl", [_jax, _port_exact, _port_k3],
                         ids=["jax", "port_exact", "port_k3_plain"])
@pytest.mark.parametrize("kind,lo,hi", [("add", 5.0, 40.0),
                                        ("mul", 0.05, 0.1)])
def test_noise_statistics(impl, kind, lo, hi):
    x = np.full((128, 24, 24, 3), 128.0, np.float32)
    y = impl(x, kind, lo, hi)
    res = (y - x).reshape(128, -1)
    scale = 1.0 if kind == "add" else 128.0
    noised = res.std(axis=1) > 0.5
    assert abs(noised.mean() - 0.5) <= 0.15
    sigma = res[noised].std(axis=1) / TRUNC_STD / scale
    assert sigma.min() >= 0.9 * lo and sigma.max() <= 1.1 * hi
    assert np.abs(res).max() <= 2.0 * hi * scale + 0.5


def test_k3_noise_shape_against_exact_truncated_normal():
    """K3's redraw-then-clip normal against the exact ±2 truncated
    normal: the same std within 2%, and at most 0.5% of draws on the
    clip."""
    _, z_mul, _, z_add = pallas_noise.normal_draws_plain(9, 4, 50_000)
    exact = noise.truncated_normal((200_000,), torch.Generator().manual_seed(9))
    for z in (z_mul.flatten(), z_add.flatten()):
        assert float(z.abs().max()) <= 2.0
        assert abs(float(z.std()) / TRUNC_STD - 1.0) < 0.02
        assert float((z.abs() == 2.0).float().mean()) < 0.005
    assert abs(float(exact.std()) / TRUNC_STD - 1.0) < 0.02
    assert abs(float(exact.mean())) < 0.01


def test_random_flips_per_sample():
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 255, (64, 5, 7, 3)).astype(np.float32))
    y = noise.random_flips(torch.Generator().manual_seed(0), x)
    yj = np.asarray(jax_random_flips(jax.random.PRNGKey(0),
                                     jnp.asarray(x.numpy())))
    for out in (y.numpy(), yj):
        kinds = []
        for i in range(64):
            cands = [x[i].numpy(), x[i].flip(1).numpy(), x[i].flip(0).numpy(),
                     x[i].flip(0).flip(1).numpy()]
            kinds.append(next(j for j, c in enumerate(cands)
                              if np.array_equal(out[i], c)))
        assert len(set(kinds)) == 4          # all four flip combinations
