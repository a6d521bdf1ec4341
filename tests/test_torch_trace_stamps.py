"""The stopwatch's stamps inside the shade step (utils/trace.py,
render/megakernel.py ``shade_step``), on the CPU with ``trace.stamp``
recording the slot names each iteration passes it:

  * untextured without NEE, an iteration stamps what it stamped before
    the shade step was split: stage A, the gap, regen, the intersect
    and the shade, and nothing more;
  * textured with NEE, the intersect is followed by the texture
    prologue's ``tex``, K2's ``shade``, the shadow rays' ``shadow`` and
    the closing ``shade``;
  * the megakernel's ``trace_rays`` stamps nothing;
  * the window carries the shadow rays the pool's device counter
    counted, through the count read the loop makes anyway: the host
    syncs by site are those of an untextured scene without NEE;
  * the window and the pool carry the (tile, box) pairs the shadow rays'
    worklist prepass fired, the sum of its ``wn`` on the streamed route
    (``build_cluster_worklists`` before K4) and on the resident one
    (``build_chunk_worklists`` before K1), and the counter changes no
    answer, shadow-ray count or host sync."""

import pytest
import torch

from logipathtracer_tpu_torch import compile_scene
from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
from logipathtracer_tpu_torch.ops.kernels import stream_cluster as k4
from logipathtracer_tpu_torch.render import megakernel
from logipathtracer_tpu_torch.render.progressive import ProgressiveRenderer
from logipathtracer_tpu_torch.scene.procedural import (make_box_scene,
                                                       make_outside_scene)
from logipathtracer_tpu_torch.utils import trace

BASE = dict(width=16, height=16, max_depth=3, compact_tile=128,
            pool_size=256)
PLAIN = ("stage_a", "gap", "regen", "intersect", "shade")
TEX_NEE = ("stage_a", "gap", "regen", "intersect", "tex", "shade",
           "shadow", "shade")


@pytest.fixture(scope="module")
def scenes():
    cfg = RenderConfig(**BASE)
    return {textured: compile_scene(make_box_scene(spheres=2, subdiv=1,
                                                   textured=textured),
                                    cfg, use_native=False)
            for textured in (False, True)}


@pytest.fixture(scope="module")
def outside():
    """A small streamed scene with emitters: 512-triangle clusters, the
    frustum prepass and K4's plain version."""
    cfg = RenderConfig(cluster_size=512)
    return compile_scene(make_outside_scene(objects=8, n_materials=8,
                                            tri_budget=8000), cfg)


@pytest.fixture
def stamps(monkeypatch):
    """The slot names ``trace.stamp`` is given, in order (None: the
    restart at the top of stage A)."""
    got = []
    monkeypatch.setattr(trace, "stamp", lambda counts, slot: got.append(slot))
    return got


def _iterations(stamps):
    """The recorded stamps split into iterations at stage A's restart."""
    its = []
    for s in stamps:
        if s is None:
            its.append([])
        else:
            its[-1].append(s)
    return [tuple(it) for it in its]


@pytest.mark.parametrize("textured,nee,want", [
    (False, False, PLAIN), (True, True, TEX_NEE),
    (True, False, ("stage_a", "gap", "regen", "intersect", "tex", "shade")),
    (False, True, ("stage_a", "gap", "regen", "intersect", "shade",
                   "shadow", "shade"))],
    ids=["plain", "tex_nee", "tex", "nee"])
def test_stamps_of_an_iteration(scenes, stamps, textured, nee, want):
    cfg = RenderConfig(**BASE, nee=nee)
    r = ProgressiveRenderer(scenes[textured], cfg, host_seed=4,
                            device="cpu")
    r.step(2)
    r.radiance()
    its = _iterations(stamps)
    traced = [it for it in its if "intersect" in it]
    assert traced and all(it == want for it in traced), set(its)
    # An iteration with nothing to trace stops after regen.
    assert all(it == want[:3] for it in its if "intersect" not in it)


def test_megakernel_stamps_nothing(scenes, stamps):
    cfg = RenderConfig(**BASE, nee=True)
    scene = scenes[True].to("cpu")
    o = torch.zeros((64, 3))
    o[:, 2] = 5.0
    d = torch.zeros((64, 3))
    d[:, 2] = -1.0
    d[:, 0] = torch.linspace(-0.3, 0.3, 64)
    d = d / d.norm(dim=1, keepdim=True)
    seed = torch.arange(128, dtype=torch.int64).reshape(64, 2)
    radiance, _, rays = megakernel.trace_rays(scene, cfg, o, d, seed)
    assert int(rays) > 0 and float(radiance.sum()) > 0.0
    assert stamps == []


def _syncs(w):
    return {s: n for s, n in w["host_syncs"].items() if n}


def test_window_counts_the_shadow_rays(scenes):
    cfg = RenderConfig(**BASE, nee=True)
    r = ProgressiveRenderer(scenes[True], cfg, host_seed=6, device="cpu")
    t0 = trace.mark()
    r.step(2)
    step = trace.window(t0)
    it = step["iterations"]
    assert _syncs(step) == {"count_read": it, "upload": 3, "fold": 1,
                            "sync": 1}
    t1 = trace.mark()
    r.radiance()
    drain = trace.window(t1)
    assert _syncs(drain) == {"count_read": drain["iterations"], "drain": 1,
                             "fold": 1, "sync": 1, "radiance": 1}
    # The drain's last iteration traces nothing, so its count read has
    # brought every shadow ray the pool's counter holds.
    w = trace.window(t0)
    shadow = int(r._wf_state["shadow_rays"])
    assert shadow > 0 and w["shadow_rays"] == shadow
    # Without NEE the counter stays at zero.
    r = ProgressiveRenderer(scenes[True], RenderConfig(**BASE), host_seed=6,
                            device="cpu")
    t0 = trace.mark()
    r.step(1)
    r.radiance()
    assert trace.window(t0)["shadow_rays"] == 0


@pytest.fixture
def one_thread():
    """The plain prepass and K4 run many small tensor ops: one intra-op
    thread, so that these cases stay quick when several test processes
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fired(monkeypatch):
    """The sum of ``wn`` of every worklist prepass call with t_max (the
    shadow rays'), recorded by wrapping both prepass functions."""
    seen = []
    for mod, name in ((k4, "build_cluster_worklists"),
                      (ci, "build_chunk_worklists")):
        def wrapped(*args, _orig=getattr(mod, name), _name=name, **kw):
            wl, wn = _orig(*args, **kw)
            if kw.get("has_tmax"):
                seen.append((_name, int(wn.sum())))
            return wl, wn
        monkeypatch.setattr(mod, name, wrapped)
    return seen


def _route(route, scenes, outside):
    if route == "stream":
        return outside, RenderConfig(**dict(BASE, compact_tile=256),
                                     nee=True, intersect="stream",
                                     stream_tile=256, cluster_size=512)
    return scenes[True], RenderConfig(**BASE, nee=True)


@pytest.mark.parametrize("route", ["resident", "stream"])
def test_window_counts_the_shadow_clusters(scenes, outside, route,
                                           monkeypatch, one_thread):
    seen = _fired(monkeypatch)
    scene, cfg = _route(route, scenes, outside)
    r = ProgressiveRenderer(scene, cfg, host_seed=6, device="cpu")
    t0 = trace.mark()
    r.step(2)
    r.radiance()
    w = trace.window(t0)
    prepass = ("build_cluster_worklists" if route == "stream"
               else "build_chunk_worklists")
    assert seen and {name for name, _ in seen} == {prepass}
    fired = sum(n for _, n in seen)
    assert w["shadow_clusters"] == int(r._wf_state["shadow_clusters"]) \
        == fired > 0
    # Each shadow call fires at least one pair per tile with a ray.
    assert fired >= len(seen)


@pytest.mark.parametrize("route", ["resident", "stream"])
def test_shadow_clusters_change_nothing_else(scenes, outside, route,
                                             monkeypatch, one_thread):
    """The same renders with the counter's column withheld from the
    prepass: equal radiance, rays, iterations, shadow rays and host
    syncs by site; only the counter differs."""
    scene, cfg = _route(route, scenes, outside)

    def render():
        r = ProgressiveRenderer(scene, cfg, host_seed=8, device="cpu")
        t0 = trace.mark()
        r.step(2)
        img = r.radiance()
        w = trace.window(t0)
        return img, r.total_rays, w

    img, rays, w = render()
    monkeypatch.setattr(trace, "shadow_clusters", lambda counts: None)
    img0, rays0, w0 = render()
    assert (img == img0).all() and rays == rays0
    assert w0["shadow_clusters"] == 0 < w["shadow_clusters"]
    for k in ("iterations", "shadow_rays", "host_syncs"):
        assert w[k] == w0[k], k
