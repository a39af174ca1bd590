"""The port's LCG PRNG and packed-bitmap helpers against the JAX package,
bit for bit (``summerset_tpu_torch/ops/prng.py``,
``summerset_tpu_torch/utils/bitmap.py``).  Inputs come from numpy seeds;
uint32 lanes are compared through their int32 reinterpretation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from summerset_tpu.ops import prng as jprng
from summerset_tpu.utils import bitmap as jbitmap
from summerset_tpu_torch.ops import prng as tprng
from summerset_tpu_torch.utils import bitmap as tbitmap


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _states(seed, shape=(4, 5, 6)):
    """uint32 LCG states, every one with the high bit set or not by the
    numpy draw (about half have it)."""
    rng = np.random.default_rng(seed)
    st = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
    st.reshape(-1)[0] |= np.uint32(0x80000000)
    return st


@pytest.mark.parametrize("seed", [0, 17, 23, 0x7FFFFFFF, 0xDEADBEEF])
@pytest.mark.parametrize("shape", [(8, 5), (3, 5, 5), (1,)])
def test_seed_state(seed, shape):
    want = np.asarray(jprng.seed_state(seed, shape))
    got = tprng.seed_state(seed, shape, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("lo,hi", [(30, 60), (0, 2), (0, 4), (5, 9), (3, 3)])
def test_uniform_int_stream(lo, hi):
    js = jnp.asarray(_states(lo * 7 + hi))
    ts = torch.from_numpy(_states(lo * 7 + hi).view(np.int32))
    assert (_u32(ts) >= 0x80000000).any(), "no state with the high bit set"
    for _ in range(6):
        js, jd = jprng.uniform_int(js, lo, hi)
        ts, td = tprng.uniform_int(ts, lo, hi)
        np.testing.assert_array_equal(_u32(ts), np.asarray(js))
        assert td.dtype == torch.int32
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_uniform_unit_bitwise():
    js = jnp.asarray(_states(99, (16, 5, 5)))
    ts = torch.from_numpy(_states(99, (16, 5, 5)).view(np.int32))
    for _ in range(5):
        js, ju = jprng.uniform_unit(js)
        ts, tu = tprng.uniform_unit(ts)
        np.testing.assert_array_equal(_u32(ts), np.asarray(js))
        assert tu.dtype == torch.float32
        # the draw feeds the drop mask: bit-identical float32s
        np.testing.assert_array_equal(
            tu.numpy().view(np.uint32), np.asarray(ju).view(np.uint32)
        )
        for rate in (0.05, 0.2, 0.5):
            np.testing.assert_array_equal(
                (tu >= float(np.float32(rate))).numpy(),
                np.asarray(ju >= rate),
            )


def test_popcount_all_bit_patterns():
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    vals[:6] = [0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x55555555]
    want = np.asarray(jbitmap.popcount(jnp.asarray(vals)))
    got = tbitmap.popcount(torch.from_numpy(vals.view(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_bit_helpers():
    rng = np.random.default_rng(6)
    lane = rng.integers(0, 1 << 31, size=(8, 5), dtype=np.int64).astype(np.uint32)
    idx = rng.integers(0, 31, size=(8, 5)).astype(np.int32)
    tl = torch.from_numpy(lane.view(np.int32))
    ti = torch.from_numpy(idx)
    jl, ji = jnp.asarray(lane), jnp.asarray(idx)
    np.testing.assert_array_equal(
        _u32(tbitmap.bit_set(tl, ti)), np.asarray(jbitmap.bit_set(jl, ji)))
    np.testing.assert_array_equal(
        _u32(tbitmap.bit_clear(tl, ti)),
        np.asarray(jbitmap.bit_clear(jl, ji)))
    np.testing.assert_array_equal(
        tbitmap.bit_get(tl, ti).numpy(),
        np.asarray(jbitmap.bit_get(jl, ji)))
    for pop in (1, 5, 31, 32):
        assert (tbitmap.bits_full(pop) & 0xFFFFFFFF) == int(
            jbitmap.bits_full(pop))
