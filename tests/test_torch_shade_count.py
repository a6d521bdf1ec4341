"""K2's count pass (tools/harness.py) on the CPU, at a small size: what
it records of each lane of a ``shade_plain`` call (its walk's orders,
lobe, light sample, roulette draw), the operations it derives from
them at the per-piece costs ``K2_OPS`` states, the walk's warp
efficiency on hand-built pools, K2's pools of the main paths, and the
timing tool's ``shade`` command, which needs a card."""

import numpy as np
import pytest
import torch

from logipathtracer_tpu_torch import RenderConfig
from logipathtracer_tpu_torch.ops.kernels import shade as sk
from logipathtracer_tpu_torch.ops.kernels._build import COUNTS
from logipathtracer_tpu_torch.tools import harness, kernel_times

CFG = RenderConfig(width=32, height=32, pool_size=1024, compact_tile=256)
M32 = (1 << 32) - 1


@pytest.fixture(scope="module")
def pools():
    return harness.shade_pools("cpu", CFG)


def _counted(args, kw):
    with harness.shade_counted() as calls:
        out = sk.shade_plain(*args, **kw)
    assert len(calls) == 1
    return out, harness.shade_work(calls[0])


@pytest.mark.parametrize("name", ["bounce", "bounce threefry", "tex+nee"])
def test_count_pass_orders_are_the_walks_draws(pools, name):
    """Each draw advances a lane's first RNG word by one, so the words
    before and after shade_plain count its draws: the lobe pick, three
    for a light sample, per order the height draw, two micro-normal
    draws and the lobe's tail past the height test, and the roulette."""
    args, kw = pools[name]
    out, work = _counted(args, kw)
    drawn = (out[5][:, 0] - args[6][:, 0]) & M32
    tail = torch.tensor(harness.TAIL_DRAWS)[work["lobe"]]
    assert torch.equal(
        drawn, work["live"] + 3 * work["nee"] + work["orders"]
        + (2 + tail) * work["steps"] + work["rr"])
    assert torch.equal(drawn, work["draws"])
    live = work["live"].bool()
    # every hit lane walks: order 0 never leaves the surface from above
    assert bool((work["orders"][live] >= 1).all())
    assert not bool(work["orders"][~live].any())
    assert bool((work["steps"][live] < work["orders"][live]).logical_or(
        work["orders"][live] == kw["max_order"]).all())
    assert torch.equal(work["miss"].bool(),
                       args[5] & (args[8] >= sk.INF))
    assert set(work["lobe"][live].tolist()) == {0, 1, 2}
    if "light_tris" in kw:
        assert torch.equal(work["nee"].bool(), live & (work["lobe"] == 0))
        assert 0 < int(work["eval_on"].sum()) <= int(work["nee"].sum())


def test_count_pass_leaves_the_plain_version_alone(pools):
    args, kw = pools["tex+nee"]
    ref = sk.shade_plain(*args, **kw)
    got, _ = _counted(args, kw)
    assert all(torch.equal(a, b) for a, b in zip(ref, got))
    # the wrapped functions are restored
    from logipathtracer_tpu_torch.ops import bsdf, rng
    assert sk.get_rand is rng.get_rand
    assert bsdf.heitz_sample.__module__ == bsdf.__name__


def _work(**cols):
    n = len(cols["live"])
    work = {k: torch.zeros(n, dtype=torch.int64) for k in (
        "miss", "live", "lobe", "orders", "steps", "nee", "eval_on",
        "eval_steps", "rr", "draws")}
    work.update({k: torch.tensor(v, dtype=torch.int64)
                 for k, v in cols.items()})
    work.update(n_lights=cols.get("n_lights", 0), parity=True)
    return work


def test_operations_follow_the_stated_costs():
    """A dead lane, a miss, and one hit lane per lobe, each walk written
    out by hand: 2 orders of which 1 step (diffuse), 3 and 2 (metallic),
    2 and 1 (transmission, roulette drawn)."""
    k = harness.K2_OPS
    lobe = [0, 0, 0, 1, 2]
    orders, steps = [0, 0, 2, 3, 2], [0, 0, 1, 2, 1]
    rr = [0, 0, 0, 0, 1]
    tail = [2, 0, 1]
    draws = [0, 0] + [1 + o + (2 + tail[lb]) * s + r for lb, o, s, r in
                      zip(lobe[2:], orders[2:], steps[2:], rr[2:])]
    work = _work(miss=[0, 1, 0, 0, 0], live=[0, 0, 1, 1, 1], lobe=lobe,
                 orders=orders, steps=steps, rr=rr, draws=draws)
    hit = k["hit"] + k["epilogue"]
    want = (k["miss"] + 3 * hit + k["trans"]
            + 7 * k["height"] + 4 * k["vndf"]
            + k["tail"][0] + 2 * k["tail"][1] + k["tail"][2]
            + k["rr"] + sum(draws) * k["draw"][True])
    assert harness.shade_ops(work) == want
    work["parity"] = False
    assert harness.shade_ops(work) == (
        want + sum(draws) * (k["draw"][False] - k["draw"][True]))


def test_operations_of_a_light_sample():
    """NEE with 5 lights: the binary search takes 3 iterations; a lane
    with the hook on pays it on each of its 2 diffuse steps and carries
    a contribution."""
    k = harness.K2_OPS
    work = _work(live=[1, 1], lobe=[0, 1], orders=[3, 2], steps=[2, 1],
                 nee=[1, 0], eval_on=[1, 0], eval_steps=[2, 0],
                 draws=[1 + 3 + 3 + 4 * 2, 1 + 2 + 2], n_lights=5)
    want = (2 * (k["hit"] + k["epilogue"] + k["nee_hit"])
            + k["nee_lane"] + 3 * k["search_step"] + k["nee_epilogue"]
            + 2 * k["eval"] + k["contrib"] + 5 * k["height"]
            + 3 * k["vndf"] + 2 * k["tail"][0] + k["tail"][1]
            + 20 * k["draw"][True])
    assert harness.shade_ops(work) == want


def test_walk_efficiency_of_hand_built_pools():
    # Two warps, all diffuse: one lane of each walks 5 orders, the others
    # 1.  One thread a lane: each warp pays 32 x 5.
    orders = np.ones(64, np.int64)
    orders[[0, 32]] = 5
    lobe = np.zeros(64, np.int64)
    total = 62 + 10
    assert harness.walk_efficiency(orders, lobe) == (total / 320,
                                                     total / 320)
    # Lobes apart: a warp of 16 diffuse and 16 metallic lanes, 2 orders
    # each, pays both branches: 32 x (2 + 2).
    orders = np.full(32, 2, np.int64)
    lobe = np.repeat([0, 1], 16)
    assert harness.walk_efficiency(orders, lobe) == (64 / 64, 64 / 128)
    # All three lobes in one warp, their longest walks 3, 1 and 4: the
    # warp pays 32 x 4, or 32 x (3 + 1 + 4) with the lobes apart.
    orders = np.tile([3, 1, 4, 1], 8)
    lobe = np.tile([0, 1, 2, 2], 8)
    assert harness.walk_efficiency(orders, lobe) == (72 / 128, 72 / 256)
    # A last warp of 8 lanes is padded with lanes that walk no order.
    orders = np.concatenate([np.full(32, 1, np.int64),
                             np.full(8, 2, np.int64)])
    assert harness.walk_efficiency(orders, np.zeros(40, np.int64)) == (
        48 / 96, 48 / 96)
    # Dead and missed lanes walk no order, and a warp of them pays none.
    orders = np.concatenate([np.zeros(32, np.int64),
                             np.full(32, 2, np.int64)])
    assert harness.walk_efficiency(orders, np.zeros(64, np.int64)) == (
        1.0, 1.0)
    assert harness.walk_efficiency(np.zeros(8, np.int64),
                                   np.zeros(8, np.int64)) == (1.0, 1.0)


def test_shade_pools_are_the_main_paths(pools):
    """Five pools of the main paths' K2 calls, each a full frame's lanes,
    with the modes they run: parity and Threefry draws, textures with
    NEE, the megakernel's whole frame at its fifth bounce, the
    tri_sel-class scene."""
    assert list(pools) == ["bounce", "bounce threefry", "tex+nee",
                           "megakernel", "tri_sel"]
    for name, (args, kw) in pools.items():
        assert args[1].shape == (1024, 3)
        assert kw["parity"] == (name != "bounce threefry")
        assert ("mat" in kw) == ("light_tris" in kw) == (name == "tex+nee")
        before = COUNTS["shade"].plain_calls
        out = sk.shade(*args, **kw)
        assert COUNTS["shade"].plain_calls == before + 1
        assert len(out) == (11 if name == "tex+nee" else 6)
    assert pools["tri_sel"][0][0].shape[0] <= 512
    args = pools["megakernel"][0]
    assert bool(args[7].eq(4).all())             # the fifth bounce
    assert 0 < int(args[5].sum()) < 1024         # dead lanes among them


def test_shade_times_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        kernel_times.main(["shade"])
