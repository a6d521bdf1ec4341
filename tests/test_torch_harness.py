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


# kind -> (its counts: plain calls, launches; tile; whether the list is
# every cluster / chunk)
COUNTS = {
    "K4": (lambda: (k4.plain_calls, k4.launches), 1024, False),
    "K5": (lambda: (ci.worklist_plain_calls, ci.worklist_launches), 1024,
           False),
    "K6[cap>0]": (lambda: (k6.plain_calls, k6.launches), 1024, True),
    "K7": (lambda: (ci.order_plain_calls, ci.order_launches), 256, True),
}


@pytest.fixture(scope="module")
def box():
    return compile_scene(make_box_scene(spheres=2, subdiv=3))


@pytest.mark.parametrize("kind", list(COUNTS))
def test_runner_drives_the_streamed_entry_points(outside, box, kind):
    """K4, K5 and K6 (cap > 0) on the outside class, K7 on the box, each
    on its main path's primary pool."""
    calls, tile, every = COUNTS[kind]
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
    before = ci.plain_calls
    t, tri, _ = kernel()
    assert ci.plain_calls == before + 1 and wn.shape == (4,)
    assert float((tri >= 0).float().mean()) > 0.5


def test_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        kernel_times.main(["isect"])
