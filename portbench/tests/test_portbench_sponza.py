"""The Sponza-class deployment (``sponza_nee_tex_1080p``) and the single
shot (``box_1080p.render_single_shot``): the atrium generator is
deterministic from its seed, at full size holds Sponza's triangle count
(within 1%), 25 PBR materials beside the sky's and 76 maps, and is
beyond the resident budget, so ``auto`` streams it; its atlas is over
the quad atlas's cap and int32-addressable; the shadow-cluster reader
is None on a window without the counter and a value with it; tiny
traced CPU runs of both cells through the harness are correct and
their bfloat16 controls are not; the single shot's traffic counts each
iteration once."""

import json
import math
import os
import types

import numpy as np
import pytest

from portbench import harness
from portbench.scenes import sponza
from portbench.scenes.common import LINEAR, REPEAT, TEXTURE_SLOTS, Texture
from portbench.tests import tiny

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPONZA = "sponza_nee_tex_1080p.render"
SINGLE = "box_1080p.render_single_shot"
MAPS = {"base_color_texture", "metallic_roughness_texture",
        "normal_texture"}


def _config():
    return json.load(open(os.path.join(HERE, "configs",
                                       "sponza_nee_tex_1080p.json")))


@pytest.fixture(scope="module")
def full():
    """The configuration's scene with 16^2 maps: the geometry does not
    depend on the maps' size."""
    args = dict(_config()["scene"]["args"], tex_size=16)
    return sponza.make(**args)


def _arrays(desc):
    out = []
    for n in desc.mesh_nodes:
        out.append(n.world_matrix)
        for p in n.primitives:
            out += [p.positions, p.normals, p.uvs]
    return out + [t.pixels for t in desc.textures]


def test_generator_is_deterministic_from_its_seed():
    a, b, c = (sponza.make(seed=s, tex_size=16, tri_budget=3000)
               for s in (3, 3, 4))
    assert all(np.array_equal(x, y) for x, y in zip(_arrays(a), _arrays(b)))
    assert not all(np.array_equal(x, y) for x, y in zip(_arrays(a),
                                                        _arrays(c)))
    # The maps' size moves no vertex.
    d = sponza.make(seed=3, tex_size=32, tri_budget=3000)
    assert all(np.array_equal(p.positions, q.positions)
               for m, n in zip(a.mesh_nodes, d.mesh_nodes)
               for p, q in zip(m.primitives, n.primitives))


def test_full_size_counts(full):
    assert abs(full.triangle_count - 262_267) <= 0.01 * 262_267
    assert full.triangle_count == 262_260
    assert 100 <= len(full.mesh_nodes) == 154
    assert all(len(n.primitives) == 1 for n in full.mesh_nodes)
    slots = {m.name: {k for k in TEXTURE_SLOTS if getattr(m, k) >= 0}
             for m in full.materials}
    assert slots.pop("sky") == {"emissive_texture"}
    assert len(slots) == 25 and all(s == MAPS for s in slots.values())
    assert set(slots) == set(sponza.KINDS)
    assert len(full.textures) == 76
    used = sorted(getattr(m, k) for m in full.materials
                  for k in TEXTURE_SLOTS if getattr(m, k) >= 0)
    assert used == list(range(76))
    for t in full.textures:
        assert (t.wrap_s, t.wrap_t) == (REPEAT, REPEAT)
        assert (t.mag_filter, t.min_filter) == (LINEAR, LINEAR)
    # One emitter, no transmission, metal only on the metals.
    emit = [m.name for m in full.materials if m.emissive_factor.max() > 0]
    assert emit == ["sky"]
    assert all(m.transmission_factor == 0 for m in full.materials)
    assert {m.name for m in full.materials if m.metallic_factor > 0} == \
        {"chain", "flagpole"}
    counts = sponza.part_counts(full)
    assert sum(counts.values()) == full.triangle_count
    assert counts["sky"] == 512
    for n in full.mesh_nodes:
        for p in n.primitives:
            assert np.isfinite(p.positions).all() and np.isfinite(
                p.uvs).all()
            assert np.abs(np.linalg.norm(p.normals, axis=-1) - 1).max() \
                < 1e-4
    assumed = " ".join(_config()["assumed"])
    assert "262,260 triangles" in assumed and "154 mesh primitives" in \
        assumed and "76 maps" in assumed


def test_full_size_is_streamed(full):
    """At its least, ceil(T / 256) clusters of 256, the atrium is over
    the resident budget, so ``auto`` takes the streamed route."""
    from logipathtracer_tpu_torch.config import RenderConfig
    from logipathtracer_tpu_torch.render.megakernel import \
        resident_sweep_fits
    c = math.ceil(full.triangle_count / 256)
    objects = sum(len(n.primitives) for n in full.mesh_nodes)
    cfg = RenderConfig(**{k: v for k, v in _config()["render"].items()
                          if k in RenderConfig.__dataclass_fields__})
    assert c * 16 * 256 * 4 > 10 * 2 ** 20
    assert not resident_sweep_fits(c, 256, objects, cfg)


def test_full_size_atlas_is_four_gather_and_int32_addressed():
    """76 maps of 1024^2: 79,691,776 texels, 318,767,104 bytes as the
    port's packed atlas, over the quad atlas's cap (the four-gather
    route), every texel's index within int32."""
    from logipathtracer_tpu_torch.scene import compile as sc
    px = np.zeros((1024, 1024, 4), np.uint8)
    textures = [Texture(pixels=px) for _ in range(76)]
    atlas, table, _, _ = sc._pack_textures(
        types.SimpleNamespace(textures=textures), 1)
    assert atlas.dtype == np.uint32 and atlas.size == 79_691_776
    assert atlas.nbytes == 318_767_104 > 4 * sc._QUAD_MAX_TEXELS
    assert sc._build_quad_atlas(atlas, table) is None
    aw = atlas.shape[1]
    last = (table[:, 1] + table[:, 3] - 1).astype(np.int64) * aw + \
        table[:, 0] + table[:, 2] - 1
    assert last.max() == atlas.size - 1 < 2 ** 31
    assumed = " ".join(_config()["assumed"])
    assert "79,691,776 texels" in assumed and "318,767,104 bytes" in assumed


def _read(ctx):
    return harness.load_module(
        os.path.join(HERE, "metrics",
                     "shadow_clusters_per_iteration.render.py"),
        "m_clusters").read(ctx)


def test_shadow_clusters_reader(monkeypatch):
    from logipathtracer_tpu_torch.utils import trace
    win = {"iterations": 200, "host_syncs": {"count_read": 200},
           "shadow_rays": 1000, "shadow_clusters": 5000}
    monkeypatch.setattr(trace, "window", lambda t0, t1=None: win)
    clock = harness.Clock()
    clock.t0, clock.t1 = 1.0, 2.0
    ctx = types.SimpleNamespace(clock=clock)
    assert _read(ctx) == pytest.approx(25.0)
    # An earlier program's window: no counter.
    del win["shadow_clusters"]
    assert _read(ctx) is None
    win["shadow_clusters"], win["iterations"] = 10, 0
    assert _read(ctx) is None


def _sponza_overrides():
    """The tiny atrium on the CPU, forced onto the streamed route."""
    return {"scene_args": {"tex_size": 16, "tri_budget": 3000},
            "render": {"width": 32, "height": 18, "pool_size": 1024,
                       "stream_tile": 256, "intersect": "stream",
                       "cluster_size": 512},
            "preview": {"scale": 1, "depth": 4},
            "traffic": {"spp": 2, "check": {"renders": 2, "pixels": 24}}}


def _single_overrides():
    ov = tiny.overrides("box_1080p.render")
    ov["traffic"] = {"spp": 3, "check": {"renders": 2, "pixels": 24}}
    return ov


CASES = {SPONZA: _sponza_overrides, SINGLE: _single_overrides}


@pytest.mark.parametrize("workload", sorted(CASES))
def test_tiny_traced_run_is_correct(workload):
    res = harness.run(workload, 2 ** 33 + 29, 0.5, True, device="cpu",
                      overrides=CASES[workload]())
    assert res["correct"], res["checks"]
    assert res["checks"]["radiance_bad"]["value"] == 0.0
    assert res["checks"]["frame_bad"]["value"] == 0.0
    got = res["metrics"]
    assert got["iterations_per_sample"]["value"] > 1
    if workload == SPONZA:
        assert got["shadow_rays_per_iteration.render"]["value"] > 0
        assert got["shadow_clusters_per_iteration.render"]["value"] > 0
    else:
        assert "shadow_clusters_per_iteration.render" not in got


@pytest.mark.parametrize("workload", sorted(CASES))
def test_tiny_control_is_not_correct(workload):
    res = harness.run(workload, 2 ** 33 + 31, 0.5, False, device="cpu",
                      overrides=CASES[workload](), control=True)
    assert not res["correct"], res["checks"]


def test_single_shot_counts_each_iteration_once():
    """The single shot's renders run every iteration in ``step``: the
    cell's count (the warm-up's render and the window's) equals the
    program's own over the run, where ``Render._render`` alone would
    count the step's twice; no pool is carried over, so nothing is
    drained."""
    from logipathtracer_tpu_torch.utils import trace
    t0 = trace.mark()
    res = harness.run(SINGLE, 2 ** 33 + 37, 0.5, True, device="cpu",
                      overrides=_single_overrides())
    assert res["correct"], res["checks"]
    w = trace.window(t0)
    counted = res["metrics"]["iterations_per_sample"]["value"] * 3 * \
        res["attempted"]
    assert counted == pytest.approx(w["iterations"]) and counted > 0
    assert w["host_syncs"]["drain"] == 0
