"""tools/harness.py and tools/kernel_times.py on the CPU, at a small
size: the harness's pools are the main path's (2^10 rays here: camera
rays, a bounce pool with parked dead lanes, NEE shadow rays with t_max),
its runner drives the entry points K1, K4-K7 with their front ends
(on the CPU their plain versions), and the timing tool refuses to run
without a card."""

import pytest
import torch

from logipathtracer_tpu_torch import RenderConfig, compile_scene
from logipathtracer_tpu_torch.ops.kernels import cluster_intersect as k6
from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
from logipathtracer_tpu_torch.ops.kernels import stream_cluster as k4
from logipathtracer_tpu_torch.ops.kernels._build import COUNTS
from logipathtracer_tpu_torch.scene.procedural import (make_box_scene,
                                                       make_outside_scene)
from logipathtracer_tpu_torch.tools import harness, kernel_times

CFG = RenderConfig(width=32, height=32, pool_size=1024, stream_tile=1024,
                   compact_tile=256)


@pytest.fixture(scope="module")
def outside():
    return compile_scene(
        make_outside_scene(objects=8, n_materials=8, tri_budget=8000),
        RenderConfig(cluster_size=512))


def test_pools_are_the_main_paths(outside):
    pools = harness.pools(outside, CFG.replace(intersect="stream"),
                              "cpu", 1024)
    assert sorted(pools) == ["bounce", "primary", "shadow"]
    for name, (rays8, kw) in pools.items():
        assert rays8.shape == (8, 1024) and rays8.dtype == torch.float32
        assert kw == ({} if name != "shadow" else
                      dict(has_tmax=True, any_hit=True))
    parked = pools["bounce"][0][0] >= 1e29
    assert 0 < int(parked.sum()) < 1024          # dead lanes parked
    t_max = pools["shadow"][0][6]
    assert bool(torch.isfinite(t_max).all()) and float(t_max.min()) > 0


# kind -> (its entry in COUNTS; tile; whether the list is every cluster /
# chunk)
KINDS = {
    "K4": ("stream_cluster", 1024, False),
    "K5": ("worklist_chunk", 1024, False),
    "K6[cap>0]": ("octant_chunk", 1024, True),
    "K7": ("compact_order", 256, True),
}


@pytest.fixture(scope="module")
def box():
    return compile_scene(make_box_scene(spheres=2, subdiv=3))


@pytest.mark.parametrize("kind", list(KINDS))
def test_runner_drives_the_streamed_entry_points(outside, box, kind):
    """K4, K5 and K6 (cap > 0) on the outside class, K7 on the box, each
    on its main path's primary pool."""
    name, tile, every = KINDS[kind]
    calls = lambda: (COUNTS[name].plain_calls, COUNTS[name].launches)
    host, cfg = ((box, CFG.replace(compact_worklist=False)) if kind == "K7"
                 else (outside, CFG.replace(intersect="stream")))
    scene = host.to("cpu")
    rays8 = harness.pools(host, cfg, "cpu", tile)["primary"][0]
    kernel, plain, inputs, wn = harness.runner(kind, scene, rays8, tile)
    before = calls()
    got = kernel()
    assert calls() == (before[0] + 1, before[1])  # the CPU's plain version
    ref = plain()
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert inputs[0] is rays8 and wn.shape == (1024 // tile,)
    if every:       # every cluster (K7) or chunk (K6, all tiles live)
        n = scene.cl_tris.shape[0]
        assert (wn == (n if kind == "K7" else -(-n // 16))).all()
    assert int(wn.min()) > 0
    assert float((got[1] >= 0).float().mean()) > 0.2


def test_runner_drives_k1():
    box = compile_scene(make_box_scene(spheres=2, subdiv=3))
    rays8 = harness.pools(box, CFG, "cpu", 256)["primary"][0]
    kernel, _, _, wn = harness.runner("K1", box.to("cpu"), rays8, 256)
    before = COUNTS["compact_intersect"].plain_calls
    t, tri, _ = kernel()
    assert COUNTS["compact_intersect"].plain_calls == before + 1
    assert wn.shape == (4,)
    assert float((tri >= 0).float().mean()) > 0.5


def test_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        kernel_times.main(["isect"])


def _one_cluster_pool(s=128):
    """One cluster (identity object, box z in [1.9, 2.1]; every slot the
    triangle (0, 0, 2) + u x + v y) and 256 rays from z = 0: ray 5
    (sub-tile 0) looks up +z through the box, every other ray down -z,
    so exactly one ray of sub-tile 0 and none of sub-tile 1 passes the
    cluster's slab.  Rays 64-127 start at x = 2, so their u (2) is
    rejected in every slot; the others' (0.25) is not."""
    tris = torch.zeros((1, 9, s), dtype=torch.float32)
    tris[0, 2] = 2.0                                  # v0 on z = 2
    tris[0, 3] = 1.0                                  # e1 = +x
    tris[0, 7] = 1.0                                  # e2 = +y
    meta = torch.tensor([[0, 0]], dtype=torch.int32)
    inv = torch.tensor([[1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0]],
                       dtype=torch.float32)
    aabb = torch.tensor([[-1, -1, 1.9, 1, 1, 2.1, 0, 0]],
                        dtype=torch.float32)
    o = torch.full((256, 3), 0.25)
    o[:, 2] = 0.0
    o[64:128, 0] = 2.0
    d = torch.zeros((256, 3))
    d[:, 2] = -1.0
    d[5, 2] = 1.0
    rays8, _ = ci.pack_rays8(o, d, 256)
    return rays8, (meta, inv, aabb, tris)


def _counted_bound(kind, rays8, tables, early_exit=False):
    """The count pass over one plain call of ``kind`` on a 256-ray tile
    (``early_exit``: the sub-tile visit's), and chip_smoke.isect_bound of
    it."""
    import chip_smoke
    from types import SimpleNamespace
    meta, inv, aabb, tris = tables
    order = torch.zeros((8, 1), dtype=torch.int32)
    oct_ = ci.tile_octants(rays8, 256)
    if kind == "K8":
        args = (rays8, oct_, order, meta, inv, aabb, tris, 256, 1e-4)
        call = lambda: k6.dense_sweep_intersect_plain(*args)
    elif kind == "K7":
        args = (rays8, oct_, order, meta, inv, aabb, tris, 256, 1e-4)
        call = lambda: ci.compact_order_intersect_plain(*args)
    else:
        bounds = ci.padded_chunk_bounds(meta, aabb, torch.eye(4)[None], 1)
        live = torch.ones(1, dtype=torch.int32)
        args = (rays8, oct_, order, live, torch.cat(bounds, 1), meta, inv,
                aabb, tris, 256, 1, 1e-4)
        cap = 0 if kind == "K6[cap=0]" else 32
        call = lambda: k6.octant_chunk_intersect_plain(*args, cap=cap)
    stage = (dict(block=128, prefetch=False, early_exit=early_exit)
             if kind in chip_smoke.SUBTILE
             else dict(block=256, prefetch=chip_smoke.COMPACTED[kind]))
    with harness.isect_counted(**stage) as work:
        _, tri, _ = call()
    assert tri.tolist() == [-1] * 5 + [0] + [-1] * 250
    inputs = args[:7] if kind in ("K7", "K8") else args[:9]
    scene = SimpleNamespace(cl_tris=tris)
    return work, chip_smoke.isect_bound(work, scene, inputs, 256), inputs


@pytest.mark.parametrize("kind", ["K8", "K6[cap=0]", "K7", "K6[cap>0]"])
def test_count_pass_charges_the_sub_tile_contract(kind):
    """The count pass over a hand-built pool whose gated lanes are known:
    one ray of sub-tile 0 passes, none of sub-tile 1.  K8 and K6's cap = 0
    body run the triangle test on every ray of sub-tile 0 (128 lanes x S
    slots), the compacted visits (K7, K6's cap > 0 body) on the one ray
    that passes; isect_bound charges each that many tests."""
    import chip_smoke
    rays8, tables = _one_cluster_pool()
    s = tables[3].shape[2]
    work, b, inputs = _counted_bound(kind, rays8, tables)
    subtile = kind in chip_smoke.SUBTILE
    # K8 and K7 slab-test every ray; K6's member test runs within the
    # block-wide chunk gate: the 128 rays of sub-tile 0 (a 128-ray block
    # with cap = 0), all 256 of the 256-ray block with cap > 0.
    slab = {"K6[cap=0]": 128, "K6[cap>0]": 256}.get(kind, 256)
    assert work["slab"] == slab
    assert work["own"] == 1
    assert work["subtile"] == (128 if subtile else 0)
    assert work["tested"] == (128 if subtile else 1)
    if subtile:
        assert (work["listed"], work["passed"], work["staged"]) == (
            1 if kind == "K6[cap=0]" else 2, 1, 1)
    n_bytes = chip_smoke.nbytes(*inputs) + 12 * 256
    ops = slab * harness.SLAB_OPS + work["tested"] * s * harness.MT_OPS
    assert b == chip_smoke.bound(ops, n_bytes)
    # The sub-tile contract makes these kernels operations-bound here; the
    # compacted visits' one tested lane leaves them bytes-bound, as the
    # own-pass count always did.
    assert b[1] == ("operations" if subtile else "bytes")


@pytest.mark.parametrize("kind", ["K8", "K6[cap=0]"])
def test_count_pass_early_exit(kind):
    """With the sub-tile visit's early exit the count pass charges
    MT_U_OPS for every (lane, slot) test of the gated sub-tile and the
    rest of the test only where u is not rejected: the 64 rays of
    sub-tile 0 whose u is 0.25, in all S slots."""
    import chip_smoke
    rays8, tables = _one_cluster_pool()
    s = tables[3].shape[2]
    work, b, inputs = _counted_bound(kind, rays8, tables, early_exit=True)
    assert work["tested"] == 128 and work["rest"] == 64 * s
    ops = (work["slab"] * harness.SLAB_OPS
           + 128 * s * harness.MT_U_OPS
           + 64 * s * (harness.MT_OPS - harness.MT_U_OPS))
    assert b == chip_smoke.bound(ops, chip_smoke.nbytes(*inputs) + 12 * 256)


def test_count_pass_k4_groups():
    """K4's triangle test by 32-slot groups in the count pass: one
    cluster (S = 128) whose slots 0-31 hold the triangle of
    ``_one_cluster_pool`` and 32-39 a triangle far off, the rest zero, so
    two of its four groups hold real slots.  The one ray that passes the
    cluster's slab tests both boxes (never the two empty groups), passes
    group 0's alone and tests its 32 slots; isect_bound charges SLAB_OPS a
    box and MT_OPS a tested slot."""
    import chip_smoke
    rays8, (meta, inv, aabb, tris) = _one_cluster_pool()
    tris[0, :, 40:] = 0.0
    tris[0, 0:3, 32:40] = 50.0
    wl = torch.zeros((1, 1), dtype=torch.int32)
    wn = torch.ones(1, dtype=torch.int32)
    args = (rays8, wl, wn, meta, inv, aabb, tris, 256, 1e-4)
    with harness.isect_counted(block=256, groups=True) as work:
        _, tri, _ = k4.stream_cl_intersect_plain(*args)
    assert tri.tolist() == [-1] * 5 + [0] + [-1] * 250
    assert (work["own"], work["tested"]) == (1, 1)
    assert (work["group_tests"], work["group_passed"],
            work["group_slots"]) == (2, 1, 32)
    assert "0.5000 passed; 32.0 slots tested a queued ray" in \
        harness.group_line(work)
    from types import SimpleNamespace
    b = chip_smoke.isect_bound(work, SimpleNamespace(cl_tris=tris), args[:7],
                               256)
    ops = (256 + 2) * harness.SLAB_OPS + 32 * harness.MT_OPS
    assert b == chip_smoke.bound(ops, chip_smoke.nbytes(*args[:7]) + 12 * 256)
    with harness.isect_counted(block=256) as work:
        k4.stream_cl_intersect_plain(*args)
    assert work["group_tests"] is None
    assert harness.group_line(work) == "no group test"


def _grid_scene():
    """A hand-built resident scene for K1: one object (identity), two
    clusters of S = 128 slots, each a 8 x 6 grid of unit squares (two
    triangles a square, slot 2k + j the k-th square in row-major order,
    so that 32-slot group g holds rows 2g, 2g + 1), cluster 0 on the
    plane z = 2 and cluster 1 on z = 3; slots 96-127 are zero, so each
    cluster has 3 groups that hold real slots."""
    from types import SimpleNamespace
    tris = torch.zeros((2, 9, 128), dtype=torch.float32)
    for c, z in enumerate((2.0, 3.0)):
        for k in range(48):
            x, y = k % 8, k // 8
            tris[c, :, 2 * k] = torch.tensor([x, y, z, 1, 0, 0, 0, 1, 0])
            tris[c, :, 2 * k + 1] = torch.tensor(
                [x + 1, y + 1, z, -1, 0, 0, 0, -1, 0])
    eye = torch.eye(4)[None]
    return SimpleNamespace(
        cl_meta=torch.tensor([[0, 0], [0, 128]], dtype=torch.int32),
        cl_aabb=torch.tensor([[0, 0, 2, 8, 6, 2, 0, 0],
                              [0, 0, 3, 8, 6, 3, 0, 0]],
                             dtype=torch.float32),
        cl_tris=tris, obj_world=eye, obj_world_inv=eye, num_objects=1)


def test_count_pass_k1_groups():
    """K1's triangle test by 32-slot groups in the count pass over
    ``runner("K1")``'s plain call on a hand-built scene (``_grid_scene``):
    rays up +z from z = 0 under the grid, half of them tilted.  Every
    queued ray tests the boxes of the 3 groups that hold real slots (own
    passes x 3, never the empty fourth), passes fewer, and tests at most
    32 slots a passed group; isect_ops charges SLAB_OPS a box and MT_OPS
    a tested slot."""
    scene = _grid_scene()
    g = torch.Generator().manual_seed(5)
    o = torch.rand((1024, 3), generator=g) * torch.tensor([7.8, 5.8, 0.0]) \
        + torch.tensor([0.1, 0.1, 0.0])
    d = torch.zeros((1024, 3))
    d[:, 2] = 1.0
    d[512:, :2] = torch.rand((512, 2), generator=g) * 0.4 - 0.2
    rays8, _ = ci.pack_rays8(o, d, 256)
    kernel, plain, _, wn = harness.runner("K1", scene, rays8, 256)
    assert wn.tolist() == [2] * 4
    with harness.isect_counted(block=256, groups=True) as work:
        t, tri, _ = plain()
    assert torch.equal(t, kernel()[0])          # the CPU: the plain version
    assert bool((tri[:512] >= 0).all()) and bool((tri[:512] < 96).all())
    assert float((tri >= 0).float().mean()) > 0.8
    own = work["own"]
    assert own >= 512 and work["tested"] == own
    assert work["group_tests"] == 3 * own
    assert own <= work["group_passed"] < work["group_tests"]
    assert work["group_slots"] <= 32 * work["group_passed"]
    assert work["group_slots"] < 96 * own
    assert f"{3.0:.2f} a queued ray" in harness.group_line(work)
    assert harness.isect_ops(work, 128) == (
        (work["slab"] + work["group_tests"]) * harness.SLAB_OPS
        + work["group_slots"] * harness.MT_OPS)
