"""The wavefront loop's static-shape body and its stage cache on the CPU
(render/wavefront.py, render/graph.py), at small shapes, without JAX:

  * rung invariance: a session with the window ladders forced to the
    whole pool, with the pool's halvings down to the tile and with
    every whole-tile rung gives equal accumulators (``torch.equal``), equal
    rays, iterations and shadow rays, on the flagship box, NEE on the
    textured box, the outside class and the scheduling knobs;
  * no host read inside stage A or B: both run with ``Tensor.item``,
    ``tolist``, ``__bool__``, ``__int__``, ``__float__``, ``__index__``,
    ``nonzero``, ``cpu`` and ``numpy`` raising, except inside the
    kernels' wrappers (on the card: one kernel launch each; their plain
    versions here are host loops);
  * the stage cache, with a stand-in for the CUDA graphs whose replay
    runs the captured call again: camera, field of view, host seeds and
    step(n) sizes reuse one body and its stages, while config, frame,
    pool and slab do not; a changed field of view renders what a fresh
    render at that field of view renders, bit for bit;
  * an in-place pool reset equals a fresh pool, at the same addresses;
  * the ladders and the camera constants' bits.

The static body against the JAX package is test_torch_graph_loop_jax.py;
graph against eager on the card is tests/test_torch_cuda.py."""

import contextlib
import math

import numpy as np
import pytest
import torch

from logipathtracer_tpu_torch import compile_scene
from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.ops import camera
from logipathtracer_tpu_torch.ops.kernels import cluster_intersect as k6
from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
from logipathtracer_tpu_torch.ops.kernels import shade as sk
from logipathtracer_tpu_torch.ops.kernels import stream_cluster as k4
from logipathtracer_tpu_torch.render import graph, wavefront
from logipathtracer_tpu_torch.render.progressive import ProgressiveRenderer
from logipathtracer_tpu_torch.scene.procedural import (make_box_scene,
                                                       make_outside_scene)

# 32x32 frame, 1024-lane pool of 128-ray tiles: eight tiles, so every
# ladder has rungs below the pool.
BOX = dict(width=32, height=32, max_depth=4, compact_tile=128,
           pool_size=1024)
CASES = {
    "flagship": (lambda: make_box_scene(spheres=2, subdiv=3), {}),
    "nee_textured": (lambda: make_box_scene(spheres=2, subdiv=3,
                                            textured=True), dict(nee=True)),
    "outside": (lambda: make_outside_scene(objects=8, n_materials=8,
                                           tri_budget=8000),
                dict(cluster_size=512, stream_tile=128, intersect="stream")),
    "lazy_regen": (lambda: make_box_scene(spheres=2, subdiv=3),
                   dict(lazy_regen=2)),
    "sort_every": (lambda: make_box_scene(spheres=2, subdiv=3),
                   dict(sort_every=2)),
}
_SCENES = {}


def _scene(name):
    make, kw = CASES[name]
    cfg = RenderConfig(**BOX, **kw)
    key = (name, cfg.cluster_size)
    if key not in _SCENES:
        _SCENES[key] = compile_scene(make(), cfg, use_native=False)
    return _SCENES[key], cfg


def _every_tile(p, tile, fractions, floor, clamp):
    return list(range(tile, p, tile)) + [p]


LADDERS = {
    "pool": dict(REGEN_FLOOR=1 << 30, TRACE_FLOOR=1 << 30),
    "halvings": dict(REGEN_FLOOR=1, TRACE_FLOOR=1),
    "every_tile": dict(ladder=_every_tile),
}


def _session(host, cfg, monkeypatch, ladder):
    with monkeypatch.context() as m:
        for k, v in LADDERS[ladder].items():
            m.setattr(wavefront, k, v)
        r = ProgressiveRenderer(host, cfg, host_seed=5, device="cpu")
        r.step(1)
        r.step(1)
        r.rotate(1, 0.05)           # in-place pool reset, then more
        r.step(1)
        rad = r._frame_sum().clone()
    return (rad, r.total_rays, r.last_iterations,
            int(r._wf_state["shadow_rays"]), r._wf_state["_windows"])


@pytest.fixture(autouse=True)
def _record_windows(monkeypatch):
    """Record each iteration's (regen, trace) windows on the renderer's
    pool state, to show which rungs a session took."""
    plan = wavefront._Body.plan

    def recording(self, counts, drain, sorted_now):
        out = plan(self, counts, drain, sorted_now)
        self.st.setdefault("_windows", set()).add(out[1:3])
        return out
    monkeypatch.setattr(wavefront._Body, "plan", recording)


@pytest.mark.parametrize("name", sorted(CASES))
def test_rung_invariance(name, monkeypatch):
    host, cfg = _scene(name)
    runs = {lad: _session(host, cfg, monkeypatch, lad) for lad in LADDERS}
    ref = runs["pool"]
    p = cfg.pool_size
    # Forced to the pool, every window is the pool; every whole tile as
    # a rung gives narrower ones.
    assert {w for pair in ref[4] for w in pair} <= {0, p}
    assert any(0 < w < p for pair in runs["every_tile"][4] for w in pair)
    for lad in ("halvings", "every_tile"):
        got = runs[lad]
        assert torch.equal(got[0], ref[0]), lad
        assert got[1:4] == ref[1:4], lad
    assert ref[1] > 0 and float(ref[0].mean()) > 0.0
    if cfg.nee:
        assert ref[3] > 0


_GUARDED = ("item", "tolist", "__bool__", "__int__", "__float__",
            "__index__", "nonzero", "cpu", "numpy")
# Kernel wrappers (one launch each on the card): the guard is lifted
# inside them, where the plain versions' host loops run on the CPU.
_KERNELS = ((ci, "build_chunk_worklists"), (ci, "compact_wl_intersect"),
            (ci, "compact_order_intersect"), (ci, "worklist_chunk_intersect"),
            (k4, "stream_cl_intersect"), (k6, "octant_chunk_intersect"),
            (k6, "dense_sweep_intersect"), (sk, "shade"),
            (wavefront, "flush_sorted"))


@contextlib.contextmanager
def no_host_reads(monkeypatch):
    """Inside ``_Body.stage_a`` and ``_Body.stage_b`` (outside the kernel
    wrappers) every host read raises.  Yields the stage call counts."""
    depth = {"stage": 0, "kernel": 0}
    calls = {"stage_a": 0, "stage_b": 0}

    def guard(name, orig):
        def f(self, *a, **kw):
            if depth["stage"] and not depth["kernel"]:
                raise AssertionError(f"host read Tensor.{name} in a stage")
            return orig(self, *a, **kw)
        return f

    def lift(orig):
        def f(*a, **kw):
            depth["kernel"] += 1
            try:
                return orig(*a, **kw)
            finally:
                depth["kernel"] -= 1
        return f

    def stage(name, orig):
        def f(self, *a, **kw):
            calls[name] += 1
            depth["stage"] += 1
            try:
                return orig(self, *a, **kw)
            finally:
                depth["stage"] -= 1
        return f

    with monkeypatch.context() as m:
        for name in _GUARDED:
            m.setattr(torch.Tensor, name, guard(name,
                                                getattr(torch.Tensor, name)))
        for mod, name in _KERNELS:
            m.setattr(mod, name, lift(getattr(mod, name)))
        for name in calls:
            m.setattr(wavefront._Body, name,
                      stage(name, getattr(wavefront._Body, name)))
        yield calls


@pytest.mark.parametrize("knobs", [
    ("flagship", {}), ("nee_textured", {}), ("outside", {}),
    ("lazy_regen", {}), ("sort_every", {}),
    ("flagship", dict(sort_rays=False))], ids=lambda k: k[0] + (
        "-unsorted" if k[1] else ""))
def test_stages_read_no_host(knobs, monkeypatch):
    """A session (chunks and a drain) and a single-shot frame, with the
    ladder at tile granularity, every stage under the guard."""
    name, extra = knobs
    host, cfg = _scene(name)
    cfg = cfg.replace(**extra)
    monkeypatch.setattr(wavefront, "REGEN_FLOOR", 1)
    monkeypatch.setattr(wavefront, "TRACE_FLOOR", 1)
    r = ProgressiveRenderer(host, cfg, host_seed=2, device="cpu")
    with no_host_reads(monkeypatch) as calls:
        r.step(1)
        rad = r._frame_sum()
        cam = torch.from_numpy(r.camera_world)
        img, rays, it = wavefront.render_wavefront(
            r.scene, cfg, cam, r.fov_y, torch.tensor([[3, 4]]), pool=512)
    assert calls["stage_a"] == calls["stage_b"] > r.last_iterations > 0
    assert float(rad.mean()) > 0.0 and rays > 0 and it > 0


class FakeGraphs(graph.GraphCache):
    """The stage cache with a stand-in for CUDA graphs: a capture runs
    the call (the warm-up), a replay runs it again."""

    def __init__(self):
        self._kept = {}
        self.captures = self.replays = 0

    def capture(self, fn, warm_up=True):
        if warm_up:
            fn()
        self.captures += 1
        cache = self

        class Stage:
            def replay(self):
                fn()
                cache.replays += 1
        return Stage()


@pytest.fixture
def fake_graphs(monkeypatch):
    fake = FakeGraphs()
    monkeypatch.setattr(wavefront, "uses_graphs",
                        lambda cfg, scene, dev, eager=False: not eager)
    monkeypatch.setattr(wavefront, "graph_cache", lambda scene: fake)
    return fake


def test_cache_key_ignores_camera_fov_seeds_and_sizes(fake_graphs,
                                                      monkeypatch):
    monkeypatch.setattr(wavefront, "SEED_CAPACITY", 2)
    host, cfg = _scene("flagship")
    r = ProgressiveRenderer(host, cfg, host_seed=1, device="cpu")
    r.step(1)
    r.step(2)
    r.radiance()                # drain: the same body, no regen window
    assert len(fake_graphs._kept) == 1
    (body,) = fake_graphs._kept.values()
    stages = dict(body.stages)
    # Once a stage B ran regen and trace, every window of the ladder is
    # captured.
    assert {("B", True, r, t) for r, t in body._windows(True)} <= set(stages)
    st = r._wf_state
    ptrs = [st[k].data_ptr() for k in wavefront._LANE_KEYS]
    r.rotate(1, 0.1)
    r.set_camera(r.camera_world, fov_y=0.7)
    r.step(2)
    assert len(fake_graphs._kept) == 1 and r._wf_state is st
    assert [st[k].data_ptr() for k in wavefront._LANE_KEYS] == ptrs
    # Stages already captured are replayed, not captured again.
    assert all(body.stages[k] is v for k, v in stages.items())
    assert fake_graphs.replays > 0
    # More samples than the seed buffer holds: it grows, the pool's
    # stages are captured again.
    r.step(wavefront.SEED_CAPACITY + 1)
    assert body.seeds.shape[0] == wavefront.SEED_CAPACITY + 1
    assert not any(body.stages.get(k) is v for k, v in stages.items())


def test_cache_key_splits_config_frame_pool_and_slab(fake_graphs):
    host, cfg = _scene("flagship")
    scene = host.to("cpu")
    cam = torch.from_numpy(np.asarray(host.cameras[0].world_matrix,
                                      np.float32))
    seeds = torch.tensor([[7, 9]])
    for kw in (dict(), dict(cfg=cfg.replace(max_depth=3)), dict(pool=512),
               dict(y0=0, rows=16), dict(y0=16, rows=16)):
        run_cfg = kw.pop("cfg", cfg)
        for fov in (0.6, 0.8):
            wavefront.render_wavefront(scene, run_cfg, cam, fov, seeds, **kw)
    # One kept pool and one body per (config, pool, slab): fields of view
    # share them.
    pools = [k for k in fake_graphs._kept if k[0] == "render_wavefront"]
    assert len(pools) == 5
    assert len(fake_graphs._kept) == 10


def test_changed_fov_renders_as_fresh(fake_graphs):
    host, cfg = _scene("nee_textured")
    scene = host.to("cpu")
    cam = torch.from_numpy(np.asarray(host.cameras[0].world_matrix,
                                      np.float32))
    seeds = torch.tensor([[11, 13]])
    wavefront.render_wavefront(scene, cfg, cam, 0.5, seeds)
    moved = cam.clone()
    moved[:3, 3] += 0.1
    got = wavefront.render_wavefront(scene, cfg, moved, 0.9, seeds)
    assert fake_graphs.replays > 0
    fresh = wavefront.render_wavefront(scene, cfg, moved, 0.9, seeds,
                                       _eager=True)
    assert torch.equal(got[0], fresh[0]) and got[1:] == fresh[1:]


def test_pool_reset_equals_fresh():
    host, cfg = _scene("flagship")
    r = ProgressiveRenderer(host, cfg, host_seed=4, device="cpu")
    r.step(1)
    st = r._wf_state
    ptrs = {k: v.data_ptr() for k, v in st.items()
            if isinstance(v, torch.Tensor)}
    assert st["host_it"] > 0 and bool(st["pending"].any())
    wavefront.reset_pool_state(st)
    fresh = wavefront.wavefront_pool_state(st["pixid"].shape[0],
                                           st["accum"].shape[0])
    assert set(fresh) <= set(st)
    for k, v in fresh.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(st[k], v) and st[k].dtype == v.dtype, k
            assert st[k].data_ptr() == ptrs[k], k
        else:
            assert st[k] == v, k
    # A camera move resets the session's pool in place.
    r.step(1)
    r.rotate(0, 0.1)
    r.step(1)
    assert r._wf_state is st and r.sample_count == 1


def test_ladders_mirror_jax():
    lad = wavefront.ladder
    p = 1 << 20
    assert lad(p, 4096, (16, 8, 4, 2), 1 << 15, True) == [
        1 << 16, 1 << 17, 1 << 18, 1 << 19, 1 << 20]
    assert lad(p, 4096, (4, 2), 1 << 17, False) == [1 << 18, 1 << 19, p]
    # The 480x270 preview: whole tiles, the pool itself last.
    assert lad(129600, 4096, (16, 8, 4, 2), 1 << 15, True) == [
        32768, 65536, 129600]
    assert lad(129600, 4096, (4, 2), 1 << 17, False) == [129600]
    # The port's ladders: every halving of the pool, a superset of JAX's
    # rungs, regen down to REGEN_FLOOR, the trace down to one tile.
    halves = wavefront.halvings(p)
    assert lad(p, 4096, halves, wavefront.REGEN_FLOOR, True) == [
        1 << k for k in range(15, 21)]
    assert lad(p, 4096, halves, wavefront.TRACE_FLOOR, False) == [
        1 << k for k in range(12, 21)]
    halves = wavefront.halvings(129600)
    assert lad(129600, 4096, halves, wavefront.REGEN_FLOOR, True) == [
        32768, 65536, 129600]
    assert lad(129600, 4096, halves, wavefront.TRACE_FLOOR, False) == [
        4096, 8192, 16384, 32768, 65536, 129600]


def test_camera_constants_keep_bits():
    rng = np.random.default_rng(0)
    pxy = torch.from_numpy(rng.uniform(0, 64, (512, 2)).astype(np.float32))
    seed = torch.from_numpy(rng.integers(0, 2 ** 32, (512, 2)))
    cam = torch.from_numpy(rng.normal(size=(4, 4)).astype(np.float32))
    fov = 0.7853981633974483
    plain = camera.generate_ray(cam, fov, pxy, (64, 48), seed)
    consts = camera.camera_constants(fov, (64, 48), "cpu")
    got = camera.generate_ray(cam, None, pxy, None, seed, consts=consts)
    for a, b in zip(plain, got):
        assert torch.equal(a, b)
    assert consts[1].dtype == torch.float32
    assert math.isclose(float(consts[1]), math.tan(fov / 2), rel_tol=1e-6)
