"""The early exit of the sub-tile visit (csrc/closest_hit.cuh
``subtile_slot``, K6's cap = 0 body and K8) on the CPU.

A lane leaves a slot once its u is rejected (u < 0 or u > 1; a NaN u is
not rejected), unless the slot's kInf could still be accepted: kInf >
eps and kInf < best, a best that is still an infinite t_max.  The slot's
t is then kInf, so leaving changes nothing.  A plain-torch model of the
slot loop — the sequential acceptance over ``compact_intersect._mt``'s
t, 32 lanes a warp — runs with and without the exit on seeded rays with
axis-aligned and NaN directions, parked lanes, degenerate triangles,
repeated triangles (t ties across slots) and lanes whose best is +inf,
0 or NaN: the exit changes no (best, slot), whole warps leave slots, and
a rule that let a best = +inf lane leave too would change the answer."""

import numpy as np
import pytest
import torch

from logipathtracer_tpu_torch.ops.intersect import INF
from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci

EPS = 1e-4


def _case(seed, n=1024, s=64):
    """(lo, ld, trib, best0): n rays from in and around [-1, 1]^3, sorted
    by direction so that warps are coherent, against one cluster of s
    triangles in that box."""
    r = np.random.default_rng(seed)
    o = r.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = d[np.argsort(np.arctan2(d[:, 1], d[:, 0]))]
    axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    d[:64] = axes[r.integers(0, 6, 64)]              # 1/0 = inf
    d[64:72, 1] = np.nan                             # NaN directions
    o[72:96] = 1e30                                  # parked lanes
    d[72:96] = 1.0
    tri = np.zeros((9, s), np.float32)
    tri[0:3] = r.uniform(-1, 1, (3, s))
    tri[3:9] = r.uniform(-0.6, 0.6, (6, s))
    tri[:, 9] = tri[:, 5]                            # ties across slots
    tri[:, 20] = tri[:, 5]
    tri[3:6, 1] = 0.0                                # det = 1/0
    tri[6:9, 2] = tri[3:6, 2]                        # e2 = e1: det = 0
    tri[3:9, 3] = 0.0                                # a point
    best0 = r.uniform(0.1, 5.0, n).astype(np.float32)
    best0[::8] = np.inf
    best0[64:68] = np.inf                            # NaN rays, best inf
    best0[5::97] = 0.0
    best0[7::101] = np.nan
    t = torch.from_numpy
    return list(t(o.T.copy())), list(t(d.T.copy())), t(tri), t(best0)


def _leave(u, best):
    """The exit's rule: u rejected and kInf not acceptable."""
    return ((u < 0.0) | (u > 1.0)) & ~((INF > EPS) & (INF < best))


def _leave_ignoring_best(u, best):
    """A wrong rule: u rejected, whatever the best."""
    return (u < 0.0) | (u > 1.0)


def _slot_loop(lo, ld, trib, best0, leave=None):
    """The sub-tile visit's slot loop for every lane: slot by slot, a lane
    that does not leave accepts t > eps strictly closer than its best.
    Returns (best, slot, [n, S] bool of the (lane, slot) pairs left)."""
    t_all = ci._mt(lo, ld, trib)
    u = ci._mt_u(lo, ld, trib)[4]
    n, s = t_all.shape
    best = best0.clone()
    slot = torch.full((n,), -1, dtype=torch.int64)
    left = torch.zeros((n, s), dtype=torch.bool)
    for j in range(s):
        if leave is not None:
            left[:, j] = leave(u[:, j], best)
        t = t_all[:, j]
        acc = ~left[:, j] & (t > EPS) & (t < best)
        best = torch.where(acc, t, best)
        slot = torch.where(acc, j, slot)
    return best, slot, left


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_early_exit_changes_nothing(seed):
    lo, ld, trib, best0 = _case(seed)
    best, slot, _ = _slot_loop(lo, ld, trib, best0)
    best_x, slot_x, left = _slot_loop(lo, ld, trib, best0, _leave)
    torch.testing.assert_close(best_x, best, rtol=0, atol=0,
                               equal_nan=True)    # NaN bests stay NaN
    assert torch.equal(slot, slot_x)
    # Each case holds every edge: a hit, an infinite best that took a
    # miss's kInf, NaN rays that accept nothing.
    assert bool((slot >= 0).any()) and bool((best == INF).any())
    assert bool((slot[64:72] == -1).all())
    # The exit saves work where a whole warp of 32 lanes leaves a slot.
    warps = left.reshape(-1, 32, left.shape[1]).all(dim=1)
    assert 0.02 < float(warps.float().mean()) < 0.98
    # Leaving a lane whose best is +inf would drop its kInf acceptance.
    best_w, slot_w, _ = _slot_loop(lo, ld, trib, best0, _leave_ignoring_best)
    wrong = slot_w != slot
    assert bool(wrong.any())
    assert bool(torch.isinf(best0[wrong]).all())
