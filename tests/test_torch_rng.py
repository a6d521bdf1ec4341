"""The port's RNG streams (logipathtracer_tpu_torch/ops/rng.py) against
the JAX package's, bit for bit: parity hash, Threefry, masked advances,
pixel seeds, including the wraparound states 0 and 2^32 - 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from logipathtracer_tpu.ops import rng as jrng
from logipathtracer_tpu_torch.ops import rng as trng

EDGE = np.array([[0, 0], [0xFFFFFFFF, 0xFFFFFFFF], [0, 0xFFFFFFFF],
                 [0xFFFFFFFF, 0], [1, 0xFFFFFFFE], [0x80000000, 0x7FFFFFFF]],
                np.uint32)


def _states(n=4096, seed=0):
    r = np.random.default_rng(seed)
    s = r.integers(0, 2 ** 32, (n, 2), dtype=np.uint64).astype(np.uint32)
    return np.concatenate([EDGE, s])


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("kind", ["parity", "threefry"])
def test_draw_sequence_bit_exact(kind):
    jdraw = jrng.rand_parity if kind == "parity" else jrng.rand_threefry
    tdraw = trng.rand_parity if kind == "parity" else trng.rand_threefry
    js = jnp.asarray(_states())
    ts = _t(_states())
    for _ in range(8):
        jv, js = jdraw(js)
        tv, ts = tdraw(ts)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ts.numpy(),
                                      np.asarray(js).astype(np.int64))
    assert tv.dtype == torch.float32


@pytest.mark.parametrize("parity", [True, False])
def test_masked_draws_bit_exact(parity):
    st = _states(1024, seed=1)
    mask = np.random.default_rng(2).random(st.shape[0]) < 0.5
    jv, js = jrng.get_rand(parity)(jnp.asarray(st), jnp.asarray(mask))
    tv, ts = trng.get_rand(parity)(_t(st), torch.from_numpy(mask))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    # Unmasked lanes keep their state.
    np.testing.assert_array_equal(ts.numpy()[~mask], st[~mask])


@pytest.mark.parametrize("parity", [True, False])
def test_seed_from_pixel_bit_exact(parity):
    r = np.random.default_rng(3)
    ubo = r.integers(0, 2 ** 32, (2048, 2), dtype=np.uint64).astype(
        np.uint32)
    ubo[:4] = EDGE[:4]
    pix = r.integers(0, 4096, (2048, 2)).astype(np.float32)
    pix[:2] = [[0, 0], [4095, 4095]]
    j = jrng.seed_from_pixel(jnp.asarray(ubo), jnp.asarray(pix),
                             parity=parity)
    t = trng.seed_from_pixel(_t(ubo), torch.from_numpy(pix), parity=parity)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(np.int64))


def test_u32_to_f32_rounding():
    """Over 2^16 random states the int64 -> f32 conversion rounds as the
    reference's u32 -> f32 cast does (rng.py:70); no draw exceeds 1."""
    st = _states(1 << 16, seed=4)
    jv, _ = jrng.rand_parity(jnp.asarray(st))
    tv, _ = trng.rand_parity(_t(st))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert float(tv.max()) <= 1.0
