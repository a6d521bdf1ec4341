"""The PBR deployment (``box_nee_tex_1080p``): its scene generator's
maps (kinds, sizes, wraps, filters, contents, uvs), its atlas at full
size (over the quad atlas's cap, so the four-gather route), the three
readers of the program's shade-step trace (None on a window without
their slot or counter, as an earlier program gives, values on one with
them), and a tiny traced CPU run of the cell through the harness."""

import json
import os
import sys
import types

import numpy as np
import pytest

from portbench import harness
from portbench.scenes import box_pbr
from portbench.scenes.common import LINEAR, REPEAT, TEXTURE_SLOTS
from portbench.tests import tiny

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "box_nee_tex_1080p.render"
MAPS = ("base_color_texture", "metallic_roughness_texture",
        "normal_texture")


def _config():
    return json.load(open(os.path.join(HERE, "configs",
                                       "box_nee_tex_1080p.json")))


def _read(name, ctx):
    return harness.load_module(os.path.join(HERE, "metrics", name + ".py"),
                               "m_" + name).read(ctx)


def test_map_kinds_sizes_wraps_and_filters():
    desc = box_pbr.make(spheres=3, subdiv=1, tex_size=256, uv_repeat=2.0)
    slots = {m.name: {k for k in TEXTURE_SLOTS if getattr(m, k) >= 0}
             for m in desc.materials}
    assert slots.pop("light") == {"emissive_texture"}
    assert len(slots) == 4 and all(s == set(MAPS) for s in slots.values())
    used = sorted(getattr(m, k) for m in desc.materials
                  for k in TEXTURE_SLOTS if getattr(m, k) >= 0)
    assert used == list(range(len(desc.textures))) == list(range(13))
    for t in desc.textures:
        assert t.pixels.shape == (256, 256, 4)
        assert t.pixels.dtype == np.uint8
        assert (t.wrap_s, t.wrap_t) == (REPEAT, REPEAT)
        assert (t.mag_filter, t.min_filter) == (LINEAR, LINEAR)
        assert (t.pixels[..., 3] == 255).all()
    for m in desc.materials[:1] + desc.materials[2:]:
        mr = desc.textures[m.metallic_roughness_texture].pixels
        assert mr[..., 1].min() >= 48
        n = desc.textures[m.normal_texture].pixels[..., :3] / 127.5 - 1.0
        assert n[..., 2].min() > 0.5
        assert np.abs(np.linalg.norm(n, axis=-1) - 1).max() < 0.02
        # Coherent: neighbouring texels differ far less than random ones.
        base = desc.textures[m.base_color_texture].pixels[..., :3] / 255.0
        step = np.abs(np.diff(base, axis=1)).mean()
        flat = base.reshape(-1, 3)
        pairs = np.abs(flat - flat[::-1]).mean()
        assert step < 0.25 * pairs
    # The walls tile their maps, the lamp keeps [0, 1], the spheres wrap.
    uvs = {n.name: n.primitives[0].uvs for n in desc.mesh_nodes}
    assert uvs["floor"].max() == 2.0 and uvs["lamp"].max() == 1.0
    assert uvs["sphere0"].max() > 1.0
    again = box_pbr.make(spheres=3, subdiv=1, tex_size=256, uv_repeat=2.0)
    assert all((a.pixels == b.pixels).all()
               for a, b in zip(desc.textures, again.textures))


def test_full_size_atlas_is_over_the_quad_cap():
    """The configuration's texture set: 34 maps of 1024^2, 35,651,584
    texels, 142,606,336 bytes as the port's packed atlas, which is over
    the quad atlas's cap, so the port takes the four-gather route."""
    from logipathtracer_tpu_torch.scene import compile as sc
    args = _config()["scene"]["args"]
    desc = box_pbr.make(**args)
    assert len(desc.textures) == 34
    texels = sum(t.pixels.shape[0] * t.pixels.shape[1]
                 for t in desc.textures)
    assert texels == 35_651_584
    atlas, table, _, _ = sc._pack_textures(
        types.SimpleNamespace(textures=desc.textures), 1)
    assert atlas.dtype == np.uint32 and atlas.size == texels
    assert atlas.nbytes == 142_606_336 > 4 * sc._QUAD_MAX_TEXELS
    assert sc._build_quad_atlas(atlas, table) is None
    assumed = " ".join(_config()["assumed"])
    assert "35,651,584 texels" in assumed and "142,606,336 bytes" in assumed


@pytest.fixture
def program_window(monkeypatch):
    """The program's ``trace.window`` answering with a synthetic window
    of 200 iterations, with the shade step's slots and counter."""
    from logipathtracer_tpu_torch.utils import trace
    win = {"iterations": 200,
           "host_syncs": {"count_read": 200},
           "shadow_rays": 100_000_000,
           "slots_ns": {"stage_a": 200e6, "gap": 20e6, "regen": 100e6,
                        "intersect": 300e6, "tex": 400e6, "shade": 50e6,
                        "shadow": 160e6}}
    monkeypatch.setattr(trace, "window", lambda t0, t1=None: win)
    return win


def _ctx():
    clock = harness.Clock()
    clock.t0, clock.t1 = 10.0, 12.0
    return types.SimpleNamespace(clock=clock)


def test_readers_on_a_window(program_window):
    ctx = _ctx()
    assert _read("tex_ms.render", ctx) == pytest.approx(2.0)
    assert _read("shadow_ms.render", ctx) == pytest.approx(0.8)
    assert _read("shadow_rays_per_iteration.render",
                 ctx) == pytest.approx(500_000)
    assert _read("shade_ms.render", ctx) == pytest.approx(0.25)


def test_readers_none_without_slot_or_counter(program_window):
    """An earlier program's window: the five slots and no counter."""
    for k in ("tex", "shadow"):
        del program_window["slots_ns"][k]
    del program_window["shadow_rays"]
    ctx = _ctx()
    for m in ("tex_ms.render", "shadow_ms.render",
              "shadow_rays_per_iteration.render"):
        assert _read(m, ctx) is None
    # Off the card: the counter without the slots.
    program_window["shadow_rays"] = 10
    del program_window["slots_ns"]
    assert _read("tex_ms.render", ctx) is None
    assert _read("shadow_rays_per_iteration.render",
                 ctx) == pytest.approx(0.05)
    program_window["iterations"] = 0
    assert _read("shadow_rays_per_iteration.render", ctx) is None


def test_readers_none_without_the_trace_module(monkeypatch):
    import logipathtracer_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "logipathtracer_tpu_torch.utils.trace",
                        None)
    for m in ("tex_ms.render", "shadow_ms.render",
              "shadow_rays_per_iteration.render"):
        assert _read(m, _ctx()) is None


def _tiny(**kw):
    ov = tiny.overrides(CELL)
    ov["scene_args"]["tex_size"] = 32
    return harness.run(CELL, 2 ** 33 + 19, 0.5, kw.pop("trace", False),
                       device="cpu", overrides=ov, **kw)


def test_tiny_traced_run_is_correct():
    res = _tiny(trace=True)
    assert res["correct"], res["checks"]
    assert res["checks"]["radiance_bad"]["value"] == 0.0
    assert res["checks"]["frame_bad"]["value"] == 0.0
    got = res["metrics"]
    # No stopwatch on the CPU; the shadow-ray counter is there.
    assert "tex_ms.render" not in got and "shadow_ms.render" not in got
    assert got["shadow_rays_per_iteration.render"]["value"] > 0


def test_tiny_control_is_not_correct():
    res = _tiny(control=True)
    assert not res["correct"], res["checks"]
