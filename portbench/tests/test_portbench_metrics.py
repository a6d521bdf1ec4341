"""Every metric reader's arithmetic, the trace reduction and the
roofline formulas, on a small recorded trace and counts."""

import json
import os
import types

import pytest

from portbench import harness, peaks, readers, trace
from portbench.trace import Spans

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _events():
    """A 1000 us window: kernels at 100-300 (intersect), 250-400
    (overlapping: shade), a memcpy at 600-700; host spans step 0-500,
    present 500-1000."""
    x = dict(ph="X")
    return [
        dict(x, name="pb.window", cat="user_annotation", ts=0, dur=1000),
        dict(x, name="pb.step", cat="user_annotation", ts=0, dur=500),
        dict(x, name="pb.present", cat="user_annotation", ts=500, dur=500),
        dict(x, name="void compact_list_kernel<false>(float const*)",
             cat="kernel", ts=100, dur=200),
        dict(x, name="shade_kernel(Args)", cat="kernel", ts=250, dur=150),
        dict(x, name="Memcpy DtoH", cat="gpu_memcpy", ts=600, dur=100),
        dict(x, name="aten::add", cat="cpu_op", ts=10, dur=5),
    ]


def test_summarize():
    s = trace.summarize(_events())
    assert s["window_s"] == pytest.approx(1e-3)
    # union: 100-400 and 600-700
    assert s["busy_s"] == pytest.approx(400e-6)
    assert s["idle_total_s"] == pytest.approx(600e-6)
    labels = sorted((round(v * 1e6), k) for k, v in s["idle_gaps"])
    assert labels == [(100, "step"), (200, "step"), (300, "present")]
    assert s["kernel_n"]["gpu_memcpy"] == 1
    assert s["device_ops"][0][0].startswith("void compact_list_kernel")


def test_kernel_name_matching():
    assert peaks.matches("void compact_list_kernel<false>(float const*)",
                         peaks.INTERSECT_CALLS)
    assert not peaks.matches("worklist_chunk_kernel", ("worklist_kernel",))
    assert peaks.matches("worklist_chunk_kernel(float*)",
                         peaks.INTERSECT_CALLS)
    assert not peaks.matches("shade_kernel", peaks.INTERSECT_KERNELS)


def test_roofline_formulas():
    # 1e6 rays, 4 calls over 1000 triangles: bytes 36e6 + 144e3, ops
    # 116e6 -> bytes bound.
    b = peaks.intersect_bound(1e6, 4, 1000)
    assert b == pytest.approx((36e6 + 4 * 1000 * 36) / 3.35e12)
    assert peaks.LANE_IN_BYTES == 77 and peaks.LANE_OUT_BYTES == 65
    s = peaks.shade_bound(1e6, 2, 10)
    assert s == pytest.approx((142e6 + 2 * 10 * 128) / 3.35e12)
    assert peaks.bound(67e12, 0) == pytest.approx(1.0)


def _ctx(profile=True):
    spans = Spans()
    spans.seconds.update(present=0.3, copy=0.1, step=1.0)
    clock = harness.Clock()
    clock.t0, clock.t1 = 10.0, 12.0
    clock.intervals = [0.01] * 19 + [0.1]
    prof = None
    if profile:
        prof = trace.summarize(_events())
        prof["count"] = {"rays": 2e6}
    return types.SimpleNamespace(
        count={"frames": 20, "samples": 40, "iterations": 100,
               "rays": 5e6}, window={"replays": 200, "captures": 0},
        clock=clock, spans=spans, setup_s=9.5, profile=prof,
        triangles=1000, objects=10)


def _read(name, ctx):
    return harness.load_module(os.path.join(HERE, "metrics", name + ".py"),
                               "m_" + name).read(ctx)


def test_every_reader():
    ctx = _ctx()
    assert _read("samples_per_s", ctx) == pytest.approx(20.0)
    assert _read("frames_per_s", ctx) == pytest.approx(10.0)
    assert _read("setup_s", ctx) == 9.5
    assert _read("frame_ms_p95", ctx) == pytest.approx(
        readers.p95_ms(ctx.clock.intervals))
    assert 10.0 < _read("frame_ms_p95", ctx) < 100.0
    assert _read("present_ms", ctx) == pytest.approx(20.0)
    assert _read("iterations_per_sample", ctx) == pytest.approx(2.5)
    assert _read("iterations_per_frame", ctx) == pytest.approx(5)
    for k in ("viewer", "render"):
        assert _read("iteration_ms." + k, ctx) == pytest.approx(20.0)
        assert _read("graph_replays_per_iteration." + k,
                     ctx) == pytest.approx(2.0)
        assert _read("device_idle_share." + k, ctx) == pytest.approx(60.0)
        # 2e6 rays in the profile; intersect kernels 200 us, one call.
        assert _read("intersect_roofline." + k, ctx) == pytest.approx(
            100 * peaks.intersect_bound(2e6, 1, 1000) / 200e-6)
        assert _read("shade_roofline." + k, ctx) == pytest.approx(
            100 * peaks.shade_bound(2e6, 1, 10) / 150e-6)


def test_readers_without_a_trace_return_nothing():
    ctx = _ctx(profile=False)
    for m in ("intersect_roofline.render", "shade_roofline.viewer",
              "device_idle_share.render"):
        assert _read(m, ctx) is None
    ctx.count = {"frames": 0, "samples": 0, "iterations": 0, "rays": 0}
    for m in ("samples_per_s", "frames_per_s", "iteration_ms.viewer",
              "present_ms", "iterations_per_sample"):
        assert _read(m, ctx) is None


def test_every_metric_has_a_reader():
    bench = json.load(open(os.path.join(os.path.dirname(HERE),
                                        "BENCHMARK.json")))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(HERE, "metrics",
                                           m["name"] + ".py")), m["name"]
