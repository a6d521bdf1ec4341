"""The port's frustum prepass (logipathtracer_tpu_torch/ops/frustum.py and
``build_cluster_worklists`` of ops/kernels/stream_cluster.py) against the
JAX package's ``ops/frustum.py`` and ``stream_cluster.py``.

Criteria: the [tiles, C] frustum mask equals the JAX mask exactly on
random, octant-pure, all-parked and t_max pools; the cluster worklists
(chunk_gate 0 and 4) fire the JAX sets with the same counts, and every
fired set holds the exact per-ray union (a cluster some live ray of the
tile passes is never culled)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from logipathtracer_tpu.ops import frustum as jfr
from logipathtracer_tpu.ops.pallas import stream_cluster as jsc
from logipathtracer_tpu_torch.ops import frustum as tfr
from logipathtracer_tpu_torch.ops.kernels import compact_intersect as tci
from logipathtracer_tpu_torch.ops.kernels import stream_cluster as tsc

TILE = 128
R = 1024


def _boxes(seed, n=48):
    """Random world AABBs, two of them dead (min > max)."""
    r = np.random.default_rng(seed)
    cmin = r.uniform(-10, 9, (n, 3)).astype(np.float32)
    cmax = cmin + r.uniform(0.2, 2.0, (n, 3)).astype(np.float32)
    cmin[[5, 17]], cmax[[5, 17]] = cmax[[5, 17]], cmin[[5, 17]].copy()
    return cmin, cmax


def _pool(kind, seed=0):
    """rays8 [8, R] of one pool kind, and its t_max row where it has one."""
    r = np.random.default_rng(seed)
    o = r.uniform(-12, 12, (R, 3)).astype(np.float32)
    d = r.standard_normal((R, 3)).astype(np.float32)
    tmax = None
    if kind == "octant":
        # Sorted pools are octant-pure per tile: one sign pattern a tile.
        signs = np.array([[1 if k & 4 else -1, 1 if k & 2 else -1,
                           1 if k & 1 else -1] for k in range(8)], np.float32)
        d = np.abs(d) * np.repeat(signs, R // 8, axis=0)
        o = (o * 0.1 + r.uniform(-8, 8, (R // TILE, 1, 3))
             .repeat(TILE, 0).reshape(R, 3)).astype(np.float32)
    elif kind == "parked":
        o[R // 2 + 5:] = 1e30      # a part-parked tile, then parked tiles
        d[R // 2 + 5:] = 1.0
    elif kind == "tmax":
        tmax = r.uniform(0.5, 8.0, R).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays8 = np.zeros((8, R), np.float32)
    rays8[0:3] = o.T
    rays8[3:6] = d.T
    if tmax is not None:
        rays8[6] = tmax
    return rays8, tmax


def _exact_union(rays8, cmin, cmax, best):
    """[tiles, C] bool: some live ray of the tile passes the cluster's
    world slab with t below its best (numpy, per ray)."""
    o = rays8[0:3].T[:, None, :]
    inv = (1.0 / rays8[3:6]).T[:, None, :]
    with np.errstate(invalid="ignore", over="ignore"):
        n = (cmin[None] - o) * inv
        f = (cmax[None] - o) * inv
    t0 = np.minimum(n, f).max(axis=2)
    t1 = np.maximum(n, f).min(axis=2)
    ok = (t0 <= t1) & (((t0 > 0) & (t0 < best[:, None]))
                       | ((t0 <= 0) & (t1 > 0)))
    ok &= (np.abs(rays8[0:3]).max(axis=0) < 1e29)[:, None]
    ok &= ~(cmin > cmax).any(axis=1)[None]
    return ok.reshape(-1, TILE, cmin.shape[0]).any(axis=1)


@pytest.mark.parametrize("kind", ["random", "octant", "parked", "tmax"])
def test_frustum_mask_matches_jax(kind):
    cmin, cmax = _boxes(1)
    rays8, tmax = _pool(kind)
    hint_j = None if tmax is None else jnp.asarray(rays8[6])
    hint_t = None if tmax is None else torch.from_numpy(rays8[6])
    ref = np.asarray(jfr.frustum_cluster_mask(
        jnp.asarray(rays8), jnp.asarray(cmin), jnp.asarray(cmax), TILE,
        best_hint=hint_j))
    got = tfr.frustum_cluster_mask(
        torch.from_numpy(rays8), torch.from_numpy(cmin),
        torch.from_numpy(cmax), TILE, best_hint=hint_t).numpy()
    np.testing.assert_array_equal(got, ref)
    best = np.full(R, tci.BIG, np.float32) if tmax is None else tmax
    exact = _exact_union(rays8, cmin, cmax, best)
    assert (got | ~exact).all()            # conservative
    assert exact.any() and not got[:, [5, 17]].any()
    if kind == "parked":
        assert not got[R // 2 // TILE + 1:].any()    # all-parked tiles
        assert got[R // 2 // TILE].any()             # part-parked tile


def test_tile_ray_bounds_match_jax():
    rays8, _ = _pool("parked")
    ref = jfr.tile_ray_bounds(jnp.asarray(rays8), TILE)
    got = tfr.tile_ray_bounds(torch.from_numpy(rays8), TILE)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("chunk_gate", [0, 4])
@pytest.mark.parametrize("kind", ["octant", "tmax"])
def test_cluster_worklists_match_jax(kind, chunk_gate):
    cmin, cmax = _boxes(2, n=45)     # 45: chunk_gate 4 pads three slots
    rays8, tmax = _pool(kind, seed=3)
    has_tmax = tmax is not None
    wlj, wnj = jsc.build_cluster_worklists(
        jnp.asarray(cmin), jnp.asarray(cmax), jnp.asarray(rays8), TILE,
        has_tmax=has_tmax, chunk_gate=chunk_gate)
    wlt, wnt = tsc.build_cluster_worklists(
        torch.from_numpy(cmin), torch.from_numpy(cmax),
        torch.from_numpy(rays8), TILE, has_tmax=has_tmax,
        chunk_gate=chunk_gate)
    assert wlt.dtype == wnt.dtype == torch.int32
    wlj, wnj = np.asarray(wlj), np.asarray(wnj)
    np.testing.assert_array_equal(wnt.numpy(), wnj)
    best = tmax if has_tmax else np.full(R, tci.BIG, np.float32)
    exact = _exact_union(rays8, cmin, cmax, best)
    for i, n in enumerate(wnt.tolist()):
        fired = set(wlt[i, :n].tolist())
        assert fired == set(wlj[i, :n].tolist())
        assert set(np.flatnonzero(exact[i])) <= fired
        # Every cluster stands once in a tile's order.
        assert sorted(wlt[i].tolist()) == list(range(cmin.shape[0]))
    assert wnt.sum() > 0
