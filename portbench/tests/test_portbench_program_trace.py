"""The readers of the program's own tracing (``program_trace.py`` and
the twelve metrics on it): each on a synthetic window of the program's
trace, None without the program's trace module or off the card, and
``host_syncs_per_iteration`` on a tiny traced CPU run, where it equals
what the traffic's calls imply."""

import os
import sys
import types

import pytest

from portbench import harness, program_trace
from portbench.tests import tiny

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOT_METRICS = {"stage_a_ms": "stage_a", "regen_ms": "regen",
                "intersect_ms": "intersect", "shade_ms": "shade",
                "loop_gap_ms": "gap"}
KINDS = ("viewer", "render")


def _read(name, ctx):
    return harness.load_module(os.path.join(HERE, "metrics", name + ".py"),
                               "m_" + name).read(ctx)


def _ctx():
    clock = harness.Clock()
    clock.t0, clock.t1 = 10.0, 12.0
    return types.SimpleNamespace(clock=clock)


@pytest.fixture
def program_window(monkeypatch):
    """The program's ``trace.window`` answering with a synthetic window
    of 200 iterations; the calls it got are in ``calls``."""
    from logipathtracer_tpu_torch.utils import trace
    win = {"iterations": 200,
           "host_syncs": {"count_read": 200, "fold": 20, "drain": 10,
                          "sync": 10, "radiance": 0, "frame": 10,
                          "upload": 30},
           "slots_ns": {"stage_a": 200e6, "gap": 20e6, "regen": 100e6,
                        "intersect": 300e6, "shade": 50e6}}
    calls = []

    def fake(t0, t1=None):
        calls.append((t0, t1))
        return win
    monkeypatch.setattr(trace, "window", fake)
    return types.SimpleNamespace(win=win, calls=calls)


def test_every_reader_on_a_window(program_window):
    ctx = _ctx()
    want = {"stage_a_ms": 1.0, "regen_ms": 0.5, "intersect_ms": 1.5,
            "shade_ms": 0.25, "loop_gap_ms": 0.1}
    for kind in KINDS:
        for m, v in want.items():
            assert _read(f"{m}.{kind}", ctx) == pytest.approx(v), m
        assert _read("host_syncs_per_iteration." + kind,
                     ctx) == pytest.approx(280 / 200)
    # The measured window alone, never the profiled extension.
    assert set(program_window.calls) == {(10.0, 12.0)}


def test_no_slots_off_the_card(program_window):
    del program_window.win["slots_ns"]
    ctx = _ctx()
    for kind in KINDS:
        for m in SLOT_METRICS:
            assert _read(f"{m}.{kind}", ctx) is None
        assert _read("host_syncs_per_iteration." + kind, ctx) is not None
    program_window.win["iterations"] = 0
    assert _read("host_syncs_per_iteration.render", ctx) is None


def test_none_without_the_trace_module(monkeypatch):
    """An earlier program has no ``utils/trace.py``: every reader finds
    nothing, and none raises."""
    import logipathtracer_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "logipathtracer_tpu_torch.utils.trace",
                        None)
    assert program_trace.window(_ctx()) is None
    for kind in KINDS:
        for m in [*SLOT_METRICS, "host_syncs_per_iteration"]:
            assert _read(f"{m}.{kind}", _ctx()) is None


# Host syncs the port makes for each frame or render of the traffic,
# besides one count read an iteration: step: 3 uploads (camera, seeds,
# field of view) and the ray fold (a render's step also syncs);
# image_u8: the drain's pending test, its ray fold and sync; a viewer
# frame's pinned copy.  The viewer reads frame N after it submitted
# frame N + 1, so its window holds one read less than drains.
SITES = {"box_1080p.render": dict(upload=3, fold=2, drain=1, sync=2),
         "box_1080p.converge": dict(upload=3, fold=2, drain=1, sync=1,
                                    frame=1)}


@pytest.mark.parametrize("workload", sorted(SITES))
def test_host_syncs_on_a_tiny_traced_run(workload, monkeypatch):
    orig, seen = program_trace.window, []

    def window(ctx):
        seen.append(orig(ctx))
        return seen[-1]
    monkeypatch.setattr(program_trace, "window", window)
    res = harness.run(workload, 2 ** 33 + 9, 0.5, True, device="cpu",
                      overrides=tiny.overrides(workload))
    assert res["correct"], res["checks"]
    kind = "render" if workload.endswith("render") else "viewer"
    got = res["metrics"]
    assert not {f"{m}.{kind}" for m in SLOT_METRICS} & set(got)
    w = seen[-1]
    assert "slots_ns" not in w
    it, syncs = w["iterations"], w["host_syncs"]
    calls = syncs["drain"]
    assert it > calls > 0 and syncs["count_read"] == it
    want = {s: n * calls for s, n in SITES[workload].items()}
    if "frame" in want:
        want["frame"] -= 1
    assert {s: n for s, n in syncs.items() if n} == {
        "count_read": it, **want}
    assert got["host_syncs_per_iteration." + kind]["value"] == \
        pytest.approx((it + sum(want.values())) / it)
