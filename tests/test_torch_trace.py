"""The port's own tracing (utils/trace.py) on the CPU, without JAX:

  * the eager loop's host syncs by site are exact: one count read an
    iteration, and per call the uploads, the ray fold, the drain's
    pending test, the syncs and the frame and radiance reads;
  * ``window()`` scoping, the ring's bound, and the stopwatch's
    arithmetic on a pool's slots and shadow rays (cumulative, kept
    through a camera reset, stage B's last slots taken with the next
    call);
  * no slots and no stamp on the CPU;
  * the ``lpt.*`` spans under a CPU ``torch.profiler``, and no range
    without one.

The stopwatch on the card is tests/test_torch_cuda.py."""

import time

import pytest
import torch

from logipathtracer_tpu_torch import compile_scene
from logipathtracer_tpu_torch.cli.webview import _HostFrame
from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.ops.kernels import _build
from logipathtracer_tpu_torch.render import wavefront
from logipathtracer_tpu_torch.render.progressive import ProgressiveRenderer
from logipathtracer_tpu_torch.scene.procedural import make_box_scene
from logipathtracer_tpu_torch.utils import trace

CFG = RenderConfig(width=16, height=16, max_depth=3, compact_tile=128,
                   pool_size=256)


@pytest.fixture(scope="module")
def scene():
    return compile_scene(make_box_scene(spheres=2, subdiv=1), CFG,
                         use_native=False)


def _syncs(t0):
    w = trace.window(t0)
    return w["iterations"], {s: n for s, n in w["host_syncs"].items() if n}


def test_host_syncs_by_site_are_exact(scene, monkeypatch):
    r = ProgressiveRenderer(scene, CFG, host_seed=1, device="cpu")
    # Nothing is stamped off the card.
    monkeypatch.setattr(_build, "launch", None)
    t0 = trace.mark()
    r.step(2)
    it, got = _syncs(t0)
    assert it == r.last_iterations > 0
    assert got == {"count_read": it, "upload": 3, "fold": 1, "sync": 1}

    t0 = trace.mark()
    r.radiance()
    it, got = _syncs(t0)
    assert it == r.last_iterations > 0
    assert got == {"count_read": it, "drain": 1, "fold": 1, "sync": 1,
                   "radiance": 1}

    # The viewer's frame: no closing sync in the step, then the drain and
    # the frame's copy; a camera move changes nothing of it.
    r.rotate(1, 0.05)
    t0 = trace.mark()
    r.step_nosync(1)
    it_step = r.last_iterations
    _HostFrame(r.image_u8()).numpy()
    it, got = _syncs(t0)
    assert it == it_step + r.last_iterations
    assert got == {"count_read": it, "upload": 3, "fold": 2, "drain": 1,
                   "sync": 1, "frame": 1}

    # The single shot: one upload (the field of view) and its fold.
    cam = torch.from_numpy(r.camera_world)
    t0 = trace.mark()
    _, _, it_shot = wavefront.render_wavefront(
        r.scene, CFG, cam, r.fov_y, torch.tensor([[3, 4]]), pool=128)
    it, got = _syncs(t0)
    assert it == it_shot > 0
    assert got == {"count_read": it, "upload": 1, "fold": 1}


def _pool(seen=(0,) * len(trace.SLOTS)):
    return {"host_it": 0, "slots_seen": list(seen) if seen else None,
            "shadow_seen": 0, "clusters_seen": 0}


def _call(tr, st, iterations, slots, shadow=0, clusters=0):
    """A call of ``iterations`` whose last count read brought the
    cumulative ``slots``, ``shadow`` rays and shadow ``clusters``."""
    st["host_it"] = iterations
    st["counts_read"] = [7, 8, 9, *slots, shadow, clusters, 123456]
    tr.loop_call(st)
    return tr._times[(tr._n - 1) % len(tr._times)]


def test_window_scoping_and_slots():
    tr = trace.Trace(ring=8)
    st = _pool()
    t_a = _call(tr, st, 2, [10, 1, 5, 20, 3, 4, 6], 100, 11)
    t_b = _call(tr, st, 3, [25, 2, 9, 50, 7, 10, 16], 250, 26)
    tr.host_sync("fold")
    # A camera reset keeps the slots, the shadow rays and the shadow
    # clusters: the next read goes on from them.
    t_c = _call(tr, st, 1, [30, 3, 10, 60, 9, 12, 20], 300, 31)
    w = tr.window(t_a, t_c)
    assert w["iterations"] == 4
    assert w["host_syncs"]["count_read"] == 4
    assert w["host_syncs"]["fold"] == 1
    assert w["slots_ns"] == {"stage_a": 20, "gap": 2, "regen": 5,
                             "intersect": 40, "tex": 6, "shade": 8,
                             "shadow": 14}
    assert w["shadow_rays"] == 200
    assert w["shadow_clusters"] == 20
    assert tr.window(t_b, t_b)["iterations"] == 0
    assert "slots_ns" not in tr.window(t_b, t_b)
    # Before the first record: from zero; up to now: the counters.
    assert tr.window(0.0, t_a)["slots_ns"]["stage_a"] == 10
    tr.host_sync("frame")
    assert tr.window(t_c)["host_syncs"]["frame"] == 1
    assert tr.window(t_c, t_c)["host_syncs"]["frame"] == 0
    # A window that mixes timed and untimed iterations shows no slots.
    cpu = _pool(seen=None)
    t_d = _call(tr, cpu, 5, [0] * len(trace.SLOTS), 40, 7)
    assert "slots_ns" not in tr.window(t_a, t_d)
    assert tr.window(t_c, t_d)["iterations"] == 5
    # Shadow rays and shadow clusters are counted off the card too.
    assert tr.window(t_c, t_d)["shadow_rays"] == 40
    assert tr.window(t_c, t_d)["shadow_clusters"] == 7


def test_ring_bound():
    tr = trace.Trace(ring=4)
    st = _pool(seen=None)
    times = [_call(tr, st, 1, [0] * len(trace.SLOTS)) for _ in range(10)]
    assert tr._n == 10
    # The ring holds the last four records: a window from an older one
    # cannot be read, one from a kept record can.
    assert tr.window(times[5], times[9]) is None
    assert tr.window(times[6], times[9])["iterations"] == 3
    assert tr.window(times[7])["iterations"] == 2
    assert tr.window(0.0) is None
    assert tr.window(time.perf_counter())["iterations"] == 0


def test_pool_reset_keeps_the_slots():
    st = wavefront.wavefront_pool_state(8, 4)
    assert st["counts"].shape == (trace.WIDTH,) and st["slots_seen"] is None
    st["counts"].copy_(torch.arange(1, trace.WIDTH + 1))
    wavefront.reset_pool_state(st)
    assert st["counts"].tolist() == [0] * trace.COUNTS + list(
        range(trace.COUNTS + 1, trace.WIDTH + 1))


def test_no_slots_on_the_cpu(scene):
    r = ProgressiveRenderer(scene, CFG, host_seed=2, device="cpu")
    t0 = trace.mark()
    r.step(1)
    r.image_u8()
    w = trace.window(t0)
    assert w["iterations"] > 0 and "slots_ns" not in w
    got = trace.per_iteration(w)
    assert set(got) == {"host_syncs_per_iteration"}
    assert trace.per_iteration(trace.window(time.perf_counter())) == {}


def test_spans_under_the_profiler(scene, monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    r = ProgressiveRenderer(scene, CFG, host_seed=3, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.step(1)
        r.image_u8()
    names = {e.name for e in prof.events()}
    assert {"lpt.step", "lpt.count_read", "lpt.drain",
            "lpt.image"} <= names

    # Without a profiler a span opens no range and stores nothing.
    def refused(name):
        raise AssertionError(f"record_function({name!r}) without a "
                             "profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    assert trace.span("step") is trace.span("count_read")
    r.step(1)
    r.image_u8()


def test_counters_under_threads():
    """The mesh's worker threads count at once: no update is lost."""
    import sys
    import threading
    tr = trace.Trace(ring=64)
    n_threads, n = 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            st = _pool()
            for k in range(n):
                tr.host_sync("fold")
                _call(tr, st, 1, [k + 1] * len(trace.SLOTS), k + 1, k + 1)
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    total = n_threads * n
    assert tr._n == total
    assert tr._cum[0] == total
    assert tr._cum[2 + trace.SITES.index("fold")] == total
    assert tr._cum[2 + trace.SITES.index("count_read")] == total
    # Each pool's slots, shadow rays and shadow clusters went 0 -> n in
    # steps of one.
    assert tr._cum[2 + len(trace.SITES):] == [total] * (len(trace.SLOTS)
                                                        + 2)
    # The ring holds the last 64 records in time order.
    k = tr._n % 64
    times = list(tr._times[k:]) + list(tr._times[:k])
    assert times == sorted(times)
    assert tr.window(times[0])["iterations"] == 63
