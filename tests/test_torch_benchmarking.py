"""``blind_image_denoising_torch/benchmarking.py`` against the JAX package's
``benchmarking.py``, on the CPU: the least-squares fit, the chained-slope
timing under one fake clock, the roofline check at one bandwidth, the
byte count of a small chain counted by hand, and the kernels' bounds as
PERF.md's table of kernels states them (to its 4 decimals)."""

import numpy as np
import pytest
import torch

from blind_image_denoising_torch import benchmarking as bm
from blind_image_denoising_tpu import benchmarking as jbm


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lstsq_slope_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ks = sorted(rng.choice(np.arange(1, 60), size=3 + seed, replace=False))
    ts = [0.002 + 0.0013 * k + rng.normal(0, 1e-4) for k in ks]
    got, want = bm.lstsq_slope(ks, ts), jbm.lstsq_slope(ks, ts)
    np.testing.assert_allclose(got, want, rtol=0, atol=0)


def test_lstsq_slope_of_a_flat_set_matches_jax():
    """No spread in t (ss_tot = 0): R² is 1 in both."""
    ks, ts = [5, 15, 30], [0.25, 0.25, 0.25]
    got = bm.lstsq_slope(ks, ts)
    assert got == jbm.lstsq_slope(ks, ts)
    assert got[2] == 1.0


class _FakeClock:
    """``time`` with a ``perf_counter`` that steps through a seeded
    sequence of readings."""

    def __init__(self, seed):
        rng = np.random.default_rng(seed)
        self._t = np.cumsum(rng.uniform(1e-3, 1e-2, 1000)).tolist()

    def perf_counter(self):
        return self._t.pop(0)


def test_time_chain_slope_matches_jax_under_one_fake_clock(monkeypatch):
    """The same readings give the same dict: unit_s, the spread of the
    per-repeat slopes, R² and every sample; each k's chain is made once,
    warmed once and then read ``reps`` times through ``float``."""
    made = {"torch": [], "jax": []}

    def chain_maker(who):
        def make_chain(k):
            made[who].append(k)
            return lambda a, b: torch.tensor(float(k * a + b))
        return make_chain

    monkeypatch.setattr(bm, "time", _FakeClock(7))
    got = bm.time_chain_slope(chain_maker("torch"), (2.0, 1.0),
                              k_values=(30, 5, 15), reps=4)
    monkeypatch.setattr(jbm, "time", _FakeClock(7))
    want = jbm.time_chain_slope(chain_maker("jax"), (2.0, 1.0),
                                k_values=(30, 5, 15), reps=4)
    assert got == want
    assert made["torch"] == made["jax"] == [5, 15, 30]
    assert set(got) == {"unit_s", "slope_spread_s", "r2", "times"}
    assert bm.DEFAULT_K_VALUES == jbm.DEFAULT_K_VALUES == (5, 15, 30)


@pytest.mark.parametrize("module", [bm, jbm], ids=["torch", "jax"])
def test_time_chain_slope_refuses_two_k_values_or_two_repeats(module):
    def make_chain(k):
        return lambda: torch.tensor(1.0)

    with pytest.raises(ValueError):
        module.time_chain_slope(make_chain, (), k_values=(5, 15), reps=5)
    with pytest.raises(ValueError):
        module.time_chain_slope(make_chain, (), k_values=(5, 15, 30),
                                reps=2)


@pytest.mark.parametrize("unit_s, nbytes", [(1e-3, 2e9), (1e-3, 4e9),
                                            (2.5e-4, 1e6), (0.0, 1e6)])
def test_roofline_check_matches_jax(unit_s, nbytes):
    bw = 3.35e12
    assert bm.roofline_check(unit_s, nbytes, bw) == jbm.roofline_check(
        unit_s, nbytes, bw)
    assert bm.ROOFLINE_TOLERANCE == jbm.ROOFLINE_TOLERANCE == 1.10
    assert bm.H100_HBM_BYTES_PER_S == 3.35e12
    assert bm.roofline_check(unit_s, nbytes) == bm.roofline_check(
        unit_s, nbytes, 3.35e12)


def test_cost_bytes_of_an_elementwise_chain_is_counted_by_hand():
    """(x·2 + 1).sum() on 1000 floats: the multiply and the add each read
    4000 bytes and write 4000, the sum reads 4000 and writes 4; the views
    and the allocation move nothing; a kernel's report adds its bytes."""
    x = torch.randn(1000)

    def chain(v):
        torch.empty_like(v)
        return (v.view(10, 100).t() * 2 + 1).sum()

    assert bm.cost_bytes(chain, x) == 8000 + 8000 + 4004
    assert bm.cost_bytes(lambda v: (v * 2 + 1).sum(), x) == 20004
    assert bm.cost_bytes(lambda: bm.add_kernel_bytes(123)) == 123
    assert not bm.byte_counters


# PERF.md §6's bounds (ms to 4 decimals, and what sets them)
K1_BOUNDS = [((8, 256, 256, 32, 3, torch.bfloat16), 0.0200, "bytes"),
             ((8, 128, 128, 64, 5, torch.bfloat16), 0.0100, "bytes"),
             ((32, 256, 256, 32, 5, torch.bfloat16), 0.0801, "bytes"),
             ((32, 256, 256, 32, 5, torch.int8), 0.0641, "operations"),
             ((32, 128, 128, 64, 5, torch.int8), 0.0347, "operations"),
             ((8, 256, 256, 32, 3, torch.float32), 0.0521, "operations"),
             ((8, 64, 64, 128, 5, torch.bfloat16), 0.0087, "operations"),
             ((32, 128, 128, 48, 5, torch.bfloat16), 0.0301, "bytes"),
             ((8, 128, 128, 48, 5, torch.float32), 0.0293, "operations"),
             ((8, 256, 256, 32, 7, torch.bfloat16), 0.0275, "operations"),
             ((8, 16, 16, 512, 5, torch.bfloat16), 0.0087, "operations"),
             ((8, 8, 8, 1024, 5, torch.float32), 0.0521, "operations")]


@pytest.mark.parametrize("args, ms, by", K1_BOUNDS)
def test_convnext_bound_gives_perf_md_bounds(args, ms, by):
    got, got_by = bm.convnext_bound_ms(*args)
    assert round(got, 4) == ms and got_by == by
    # E defaults to 4C
    assert bm.convnext_bound_ms(*args, e=4 * args[3]) == (got, got_by)


def test_convnext_bound_cuda_cores_and_any_k_and_e():
    """float32 on the CUDA cores (PERF.md's bracket): (32, 3) 8×256²
    0.1357; E enters the products and the weights' bytes; K = 9's taps
    the CUDA cores' operations."""
    assert round(bm.convnext_bound_ms(8, 256, 256, 32, 3, torch.float32,
                                      cuda_cores=True)[0], 4) == 0.1357
    half = bm.convnext_bound_ms(8, 8, 8, 1024, 5, torch.float32, e=2048)
    assert round(half[0], 4) == 0.0260 and half[1] == "operations"
    k9, by = bm.convnext_bound_ms(8, 256, 256, 32, 9, torch.bfloat16)
    assert by == "operations" and k9 > bm.convnext_bound_ms(
        8, 256, 256, 32, 7, torch.bfloat16)[0]
    # the general route moves t and h once each way besides
    assert bm.convnext_bytes(1, 4, 4, 8, 3, torch.bfloat16, e=16,
                             general=True) == bm.convnext_bytes(
        1, 4, 4, 8, 3, torch.bfloat16, e=16) + 2 * 16 * (8 + 16) * 2


@pytest.mark.parametrize("args, kw, ms", [
    ((8, 256, 256, 32, 2, torch.bfloat16), {}, 0.0300),
    ((8, 128, 128, 64, 2, torch.bfloat16), {}, 0.0150),
    ((16, 64, 64, 64, 2, torch.bfloat16), {"backward": True}, 0.0075),
    ((8, 256, 256, 32, 2, torch.bfloat16), {"split": True}, 0.0225),
    ((8, 32, 32, 108, 2, torch.bfloat16), {"split": True}, 0.0012)])
def test_band_bound_gives_perf_md_bounds(args, kw, ms):
    got, by = bm.band_bound_ms(*args, **kw)
    assert round(got, 4) == ms and by == "bytes"


def test_noise_bound_gives_perf_md_bounds():
    """K3 16×128²×3 f32 0.0019 (bytes: the train step's samples do not
    all draw a noise) and 4×256²×3 0.0019 (operations, every sample's
    noise on)."""
    ms, by, _ = bm.noise_bound_ms(128 * 128 * 3, [1] * 8 + [0] * 8)
    assert round(ms, 4) == 0.0019 and by == "bytes"
    ms, by, parts = bm.noise_bound_ms(256 * 256 * 3, [1, 1, 1, 1])
    assert round(ms, 4) == 0.0019 and by == "operations"
    assert set(parts) == {"bytes", "integer", "mufu"}
