"""The launch-count registry (``ops/kernels/_build.py`` ``COUNTS``) on
the CPU: every entry has a wrapper here, each wrapper counts its plain
version's call in its own entry and in no other, and a recording puts back what a
block counted and returns it as a delta that ``add`` (a graph replay)
adds again."""

import collections
import sys
import threading

import pytest
import torch

from logipathtracer_tpu_torch import RenderConfig, compile_scene
from logipathtracer_tpu_torch.ops.kernels import _build
from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
from logipathtracer_tpu_torch.ops.kernels import flush, shade, tex_prologue
from logipathtracer_tpu_torch.ops.kernels._build import COUNTS
from logipathtracer_tpu_torch.ops.traverse import scene_cluster_bounds
from logipathtracer_tpu_torch.render import graph
from logipathtracer_tpu_torch.scene.procedural import make_box_scene
from logipathtracer_tpu_torch.tools import harness

TILE = 256
CFG = RenderConfig(width=16, height=16, pool_size=TILE, max_depth=3,
                   compact_tile=TILE, sweep_tile=TILE)


@pytest.fixture(scope="module")
def frame():
    """A bounce pool of the textured box with its hits, on the CPU:
    (scene, pool, t, obj, tri, rays8)."""
    host = compile_scene(make_box_scene(spheres=1, subdiv=2, textured=True),
                         CFG)
    scene, pool, t, obj, tri = harness.tex_pool(host, CFG, "cpu")
    rays8 = ci.pack_rays8(pool["origin"], pool["direction"], TILE)[0]
    return scene, pool, t, obj, tri, rays8


def _kernel(kind):
    return lambda f: harness.runner(kind, f[0], f[5], TILE)[0]


def _shade(f, fn, **drop):
    scene, pool, t, _, tri, _ = f
    args, kw = harness.shade_args(scene, CFG, pool, t, tri, parity=False)
    for k in drop:
        kw.pop(k)
    return lambda: fn(*args, **kw)


# Registered name -> a call of its wrapper on the frame, prepared: its
# inputs (worklists, tables) are made before the counts are read.
CALLS = {
    "compact_intersect": _kernel("K1"),
    "worklist_prepass": lambda f: lambda: ci.build_chunk_worklists(
        *scene_cluster_bounds(f[0]), f[5], TILE),
    "stream_cluster": _kernel("K4"),
    "worklist_chunk": _kernel("K5"),
    "octant_chunk": _kernel("K6[cap>0]"),
    "compact_order": _kernel("K7"),
    "dense_sweep": _kernel("K8"),
    "shade": lambda f: _shade(f, shade.shade),
    "shade_basic": lambda f: _shade(f, shade.shade_basic, max_order=0),
    "flush": lambda f: lambda: flush.flush_sorted(
        torch.zeros(16, 3), *harness.make_tail(16, 64, 40, "cpu")),
    "tex_prologue": lambda f: lambda: tex_prologue.tex_prologue(
        f[0], CFG, f[1]["origin"], f[1]["direction"], f[2], f[3], f[4],
        alive=f[1]["alive"]),
}


@pytest.fixture
def put_back():
    """Put back what the test counts: other tests in the process read
    absolute counts (a CPU run launches nothing)."""
    with _build.recording():
        yield


def _values():
    return {name: (c.launches, c.plain_calls, dict(c.modes))
            for name, c in COUNTS.items()}


def test_every_entry_has_a_call():
    """The registry is complete at import, and each entry is driven
    below."""
    assert set(CALLS) == set(COUNTS)


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_plain_call_counts_in_its_own_entry(frame, name):
    """The wrapper's CPU call takes its plain version: one plain call in
    its own entry, no launch, and no other entry moves."""
    call = CALLS[name](frame)
    before = _values()
    call()
    after = _values()
    n, p, m = before[name]
    assert after.pop(name) == (n, p + 1, m)
    before.pop(name)
    assert after == before


def test_recording_puts_back_and_returns_the_delta(frame, put_back):
    """Counts a block adds (a direct count and a wrapper's) are put back
    and returned; adding the delta twice adds them twice."""
    _build.launched("shade", "base")        # modes to put back
    before = _values()
    with _build.recording() as delta:
        _build.launched("shade", "tex")
        _build.launched("shade", "tex")
        CALLS["flush"](frame)()
        assert COUNTS["shade"].launches == before["shade"][0] + 2
    assert _values() == before
    assert delta == {"shade": (2, 0, collections.Counter(tex=2)),
                     "flush": (0, 1, collections.Counter())}
    _build.add(delta)
    _build.add(delta)
    after = _values()
    n, p, m = before["shade"]
    assert after["shade"] == (n + 4, p, dict(m, tex=m.get("tex", 0) + 4))
    assert after["flush"][1] == before["flush"][1] + 2
    assert {k: v for k, v in after.items() if k not in ("shade", "flush")} \
        == {k: v for k, v in before.items() if k not in ("shade", "flush")}


def test_recording_counts_no_module_constant(monkeypatch):
    """A module's integer constant that changes in a recording is
    neither counted nor put back."""
    boxes, rays = ci.MAX_BOXES, ci.MT_RAYS
    with _build.recording() as delta:
        monkeypatch.setattr(ci, "MAX_BOXES", boxes + 1)
        monkeypatch.setattr(ci, "MT_RAYS", rays * 2)
    assert delta == {}
    assert (ci.MAX_BOXES, ci.MT_RAYS) == (boxes + 1, rays * 2)


def test_recording_holds_other_threads_counts():
    """A recording holds COUNT_LOCK: another thread's count waits for the
    block's end, so it is neither recorded nor put back."""
    before = COUNTS["flush"].plain_calls
    other = threading.Thread(target=_build.plain, args=("flush",))
    with _build.recording() as delta:
        other.start()
        other.join(0.2)
        assert other.is_alive()
    other.join()
    assert delta == {}
    assert COUNTS["flush"].plain_calls == before + 1


def test_counts_from_many_threads_lose_nothing():
    """Threads counting at once (the mesh's workers) while one records:
    no count is lost, and the recordings take none of the others'."""
    threads, calls = 16, 500
    before = COUNTS["flush"].plain_calls, COUNTS["shade"].launches
    deltas = []

    def count():
        for _ in range(calls):
            _build.plain("flush")

    def record():
        for _ in range(calls):
            with _build.recording() as delta:
                _build.launched("shade")
            deltas.append(delta)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=count) for _ in range(threads)]
        workers.append(threading.Thread(target=record))
        for w in workers:
            w.start()
        for w in workers:
            w.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert (COUNTS["flush"].plain_calls, COUNTS["shade"].launches) == (
        before[0] + threads * calls, before[1])
    assert all(d == {"shade": (1, 0, collections.Counter())} for d in deltas)
    assert len(deltas) == calls


def test_captured_stage_replay_adds_its_delta(put_back):
    """``CapturedStage.replay`` replays the graph, adds its capture's
    delta and counts the replay in its cache."""

    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    class Cache:
        replays = 0

    cache = Cache()
    delta = {"compact_intersect": (1, 0, collections.Counter(closest=1)),
             "shade_basic": (0, 1, collections.Counter())}
    stage = graph.CapturedStage(Graph(), delta, cache)
    before = _values()
    stage.replay()
    stage.replay()
    after = _values()
    n, p, m = before["compact_intersect"]
    assert after["compact_intersect"] == (
        n + 2, p, dict(m, closest=m.get("closest", 0) + 2))
    assert after["shade_basic"][1] == before["shade_basic"][1] + 2
    assert (Graph.replays, cache.replays) == (2, 2)
