"""Kernels K1-K8 against their plain versions on the card, at small
shapes, in every mode (the intersect kernels' t_max / any-hit shadow
queries, K6's cap 0 and cap > 0 bodies, K8's sub-tile body, K2 with
textures and NEE), and the render on the card against the CPU, the
wavefront and the megakernel on each route.  Marked ``cuda``: they need
an NVIDIA card with nvcc and skip elsewhere.  On the card (which has no JAX, imported by the suite's
conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` repeats the comparison at the main path's shapes."""

import numpy as np
import pytest
import torch

from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
from logipathtracer_tpu_torch.ops.kernels import flush, shade
from logipathtracer_tpu_torch.ops.traverse import scene_cluster_bounds

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.fixture
def scene(dev):
    from logipathtracer_tpu_torch import compile_scene
    from logipathtracer_tpu_torch.scene.procedural import make_box_scene
    return compile_scene(make_box_scene(spheres=2, subdiv=3)).to(dev)


def _rays(n, dev, seed=0):
    r = np.random.default_rng(seed)
    o = r.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    d[n // 2:n // 2 + n // 8] = axes[r.integers(0, 6, n // 8)]  # 1/0 = inf
    o[n // 2 + n // 4:] = 1e30          # a parked tail
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


def test_k1_matches_plain(scene, dev):
    o, d = _rays(4096, dev)
    tile = 1024
    rays8, _ = ci.pack_rays8(o, d, tile)
    wl, wn = ci.build_chunk_worklists(*scene_cluster_bounds(scene), rays8,
                                      tile)
    inv = scene.obj_world_inv[:, :3, :4].reshape(-1, 12).contiguous()
    args = (rays8, wl, wn, scene.cl_meta, inv, scene.cl_aabb, scene.cl_tris,
            tile, 1e-4)
    n0 = ci.launches
    got = ci.compact_wl_intersect(*args)
    assert ci.launches == n0 + 1
    ref = ci.compact_wl_intersect_plain(*args)
    ci.hits_agree([x.cpu() for x in ref], [x.cpu() for x in got])


def test_k1_any_hit_matches_plain(scene, dev):
    """Shadow queries: the visibility predicate t < t_max agrees on every
    lane, with and without any-hit."""
    o, d = _rays(4096, dev)
    r = np.random.default_rng(4)
    t_max = torch.from_numpy(r.uniform(0.05, 4.0, 4096).astype(
        np.float32)).to(dev)
    tile = 1024
    rays8, _ = ci.pack_rays8(o, d, tile, t_max=t_max)
    wl, wn = ci.build_chunk_worklists(*scene_cluster_bounds(scene), rays8,
                                      tile, has_tmax=True)
    inv = scene.obj_world_inv[:, :3, :4].reshape(-1, 12).contiguous()
    args = (rays8, wl, wn, scene.cl_meta, inv, scene.cl_aabb, scene.cl_tris,
            tile, 1e-4)
    for any_hit in (False, True):
        n0 = ci.mode_launches["any_hit" if any_hit else "tmax"]
        got = ci.compact_wl_intersect(*args, has_tmax=True, any_hit=any_hit)
        assert ci.mode_launches["any_hit" if any_hit else "tmax"] == n0 + 1
        ref = ci.compact_wl_intersect_plain(*args, has_tmax=True,
                                            any_hit=any_hit)
        blocked = got[0] < t_max
        assert torch.equal(blocked, ref[0] < t_max)
        assert 0 < int(blocked.sum()) < 4096
        if not any_hit:
            ci.hits_agree([x.cpu() for x in ref], [x.cpu() for x in got])


@pytest.mark.parametrize("parity", [True, False])
def test_k2_tex_nee_matches_plain(dev, parity):
    """K2 with material overrides, a normal map and NEE against its plain
    version, on a textured box's camera rays."""
    from logipathtracer_tpu_torch import compile_scene
    from logipathtracer_tpu_torch.config import RenderConfig
    from logipathtracer_tpu_torch.ops.traverse import intersect_scene_sweep
    from logipathtracer_tpu_torch.scene.procedural import make_box_scene
    sc = compile_scene(make_box_scene(spheres=2, subdiv=3,
                                      textured=True)).to(dev)
    n = 4096
    o, d = _rays(n, dev, seed=5)
    o[n // 2 + n // 4:] = 0.0           # no parked tail: every lane shades
    t, _, tri = intersect_scene_sweep(sc, o, d, tile=1024)
    r = np.random.default_rng(6)
    g = lambda a: torch.from_numpy(a).to(dev)
    nm = g(r.normal(size=(n, 3)).astype(np.float32))
    nm = nm / nm.norm(dim=-1, keepdim=True)
    mat = g(np.concatenate([r.random((n, 7)), r.random((n, 3)) * 0.9],
                           1).astype(np.float32))
    args = (sc.tri_shade, o, d, g(r.random((n, 3)).astype(np.float32)),
            g((0.2 + r.random((n, 3))).astype(np.float32)),
            g(r.random(n) < 0.9),
            g(r.integers(0, 2 ** 32, (n, 2), dtype=np.int64)),
            g(r.integers(0, 8, n).astype(np.int32)), t, tri)
    cfg = RenderConfig()
    kw = dict(env=0.2, rr_threshold=0.5, rr_bounces=2, max_order=16,
              parity=parity, mat=mat, ff_mapped=nm,
              has_nmap=g(r.random(n) < 0.5), light_tris=sc.light_tris,
              light_cdf=sc.light_cdf,
              prev_pdf=g((r.random(n) * 0.3).astype(np.float32)),
              nee_mis=cfg.nee_mis, total_light_area=sc.total_light_area)
    n0 = shade.mode_launches["tex+nee"]
    got = shade.shade(*args, **kw)
    assert shade.mode_launches["tex+nee"] == n0 + 1 and len(got) == 11
    ref = shade.shade_plain(*args, **kw)
    shade.shade_agreement([x.cpu() for x in ref], [x.cpu() for x in got])
    assert bool((got[9] != 1.0).any())   # some lanes sampled a light


@pytest.mark.parametrize("parity", [True, False])
def test_k2_matches_plain(scene, dev, parity):
    from logipathtracer_tpu_torch.ops.traverse import intersect_scene_sweep
    n = 4096
    o, d = _rays(n, dev, seed=1)
    t, _, tri = intersect_scene_sweep(scene, o, d, tile=1024)
    r = np.random.default_rng(2)
    g = lambda a: torch.from_numpy(a).to(dev)
    args = (scene.tri_shade, o, d, g(r.random((n, 3)).astype(np.float32)),
            g((0.2 + r.random((n, 3))).astype(np.float32)),
            g(r.random(n) < 0.9),
            g(r.integers(0, 2 ** 32, (n, 2), dtype=np.int64)),
            g(r.integers(0, 8, n).astype(np.int32)), t, tri)
    kw = dict(env=0.2, rr_threshold=0.5, rr_bounces=2, max_order=16,
              parity=parity)
    got = shade.shade(*args, **kw)
    ref = shade.shade_plain(*args, **kw)
    shade.shade_agreement([x.cpu() for x in ref], [x.cpu() for x in got])


def test_k3_matches_plain_and_repeats_exactly(dev):
    r = np.random.default_rng(3)
    npix, rows, retired = 4096, 8192, 3000
    pix = np.concatenate([np.full(rows - retired, -1, np.int32),
                          np.sort(r.integers(0, npix, retired))
                          .astype(np.int32)])
    acc = torch.from_numpy(r.random((rows, 3)).astype(np.float32)).to(dev)
    pix = torch.from_numpy(pix).to(dev)
    base = torch.from_numpy(r.random((npix, 3)).astype(np.float32)).to(dev)
    a = flush.flush_sorted(base.clone(), pix, acc)
    b = flush.flush_sorted(base.clone(), pix, acc)
    p = flush.flush_sorted_plain(base.clone(), pix, acc)
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.cpu().numpy(), p.cpu().numpy(), rtol=1e-6,
                               atol=1e-6)


def test_wrappers_check_inputs(scene, dev):
    with pytest.raises(ValueError, match="dtype"):
        flush.flush_sorted(torch.zeros((8, 3), device=dev),
                           torch.zeros(4, dtype=torch.int64, device=dev),
                           torch.zeros((4, 3), device=dev))


@pytest.mark.parametrize("knob", [
    {}, dict(parity_rng=False), dict(sort_rays=False), dict(lazy_regen=2),
    dict(pool_size=1000, compact_tile=256),
    dict(nee=True, scene="textured"),
    dict(nee=True, parity_rng=False, scene="textured"),
    dict(mip_levels=4, scene="nearest")])
def test_render_card_matches_cpu(dev, knob):
    """The whole slice on the card against the CPU (plain versions),
    including the configurations off the flagship path: NEE on the
    textured box, and a textured box with mips and a NEAREST sampler."""
    from logipathtracer_tpu_torch import (ProgressiveRenderer, RenderConfig,
                                          compile_scene)
    from logipathtracer_tpu_torch.scene.procedural import make_box_scene
    knob = dict(knob)
    kind = knob.pop("scene", "plain")
    cfg = RenderConfig(width=32, height=32, pool_size=1024,
                       compact_tile=256).replace(**knob)
    gltf = make_box_scene(spheres=2, subdiv=3, textured=kind != "plain")
    if kind == "nearest":
        gltf.textures[0].mag_filter = 9728
        gltf.textures[0].min_filter = 9728
    host = compile_scene(gltf, cfg)
    assert kind != "nearest" or (host.has_nearest and host.mip_levels > 1)
    rads = []
    for device in (dev, "cpu"):
        r = ProgressiveRenderer(host, cfg, host_seed=5, device=device)
        r.step(2)
        r.step(1)
        rads.append((r.radiance(), r.total_rays))
    (a, ra), (b, rb) = rads
    close = np.isclose(a, b, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() >= 0.995
    assert ra == rb


_OUTSIDE = {}


def _outside_host():
    """The small outside-class scene of the streamed path (113 clusters
    of 512 triangles), compiled once."""
    if "scene" not in _OUTSIDE:
        from logipathtracer_tpu_torch import RenderConfig, compile_scene
        from logipathtracer_tpu_torch.scene.procedural import \
            make_outside_scene
        _OUTSIDE["scene"] = compile_scene(
            make_outside_scene(objects=8, n_materials=8, tri_budget=8000),
            RenderConfig(cluster_size=512))
    return _OUTSIDE["scene"]


@pytest.fixture
def outside(dev):
    return _outside_host().to(dev)


def _outside_rays(n, dev, seed=8):
    r = np.random.default_rng(seed)
    o = np.stack([r.uniform(-30, 30, n), r.uniform(0.5, 6.0, n),
                  r.uniform(-30, 30, n)], 1).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    d[n // 2:n // 2 + n // 8] = axes[r.integers(0, 6, n // 8)]
    o[n - n // 4 - 100:] = 1e30         # a part-parked tile, then parked
    d[n - n // 4 - 100:] = 1.0
    t_max = r.uniform(0.5, 40.0, n).astype(np.float32)
    return (torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
            torch.from_numpy(t_max).to(dev))


def _stream_call(kernel, scene, rays8, tile, plain, **kw):
    """One streamed kernel or its plain version on a packed pool, with
    the front end the main path gives it."""
    from logipathtracer_tpu_torch.ops.kernels import cluster_intersect as k6
    from logipathtracer_tpu_torch.ops.kernels import stream_cluster as k4
    from logipathtracer_tpu_torch.ops.traverse import scene_chunk_bounds
    inv = scene.obj_world_inv[:, :3, :4].reshape(-1, 12).contiguous()
    tables = (scene.cl_meta, inv, scene.cl_aabb, scene.cl_tris)
    has_tmax = kw.get("has_tmax", False)
    if kernel == "k4":
        wl, wn = k4.build_cluster_worklists(*scene_cluster_bounds(scene),
                                            rays8, tile, has_tmax=has_tmax)
        fn = k4.stream_cl_intersect_plain if plain else k4.stream_cl_intersect
        return fn(rays8, wl, wn, *tables, tile, 1e-4, **kw)
    bounds = scene_chunk_bounds(scene, 16)
    chunk_aabb = torch.cat(bounds, 1).contiguous()
    if kernel == "k5":
        wl, wn = ci.build_chunk_worklists(*bounds, rays8, tile,
                                          has_tmax=has_tmax)
        fn = (ci.worklist_chunk_intersect_plain if plain
              else ci.worklist_chunk_intersect)
        return fn(rays8, wl, wn, chunk_aabb, *tables, tile, 16, 1e-4, **kw)
    oct_, live = k6.tile_front(rays8, tile)
    order = k6.octant_chunk_order(*bounds)
    fn = (k6.octant_chunk_intersect_plain if plain
          else k6.octant_chunk_intersect)
    return fn(rays8, oct_, order, live, chunk_aabb, *tables, tile, 16, 1e-4,
              cap=0 if kernel == "k6_cap0" else 32, **kw)


@pytest.mark.parametrize("kernel", ["k4", "k5", "k6", "k6_cap0"])
def test_stream_kernels_match_plain(outside, dev, kernel):
    """K4, K5 and K6 (both bodies) against their plain versions: closest
    hits under hits_agree, and the shadow query's visibility on every
    lane."""
    from logipathtracer_tpu_torch.ops.kernels import cluster_intersect as k6
    from logipathtracer_tpu_torch.ops.kernels import stream_cluster as k4
    o, d, t_max = _outside_rays(4096, dev)
    tile = 1024
    counts = lambda: (k4.launches, ci.worklist_launches, k6.launches)
    rays8, _ = ci.pack_rays8(o, d, tile)
    n0 = sum(counts())
    got = _stream_call(kernel, outside, rays8, tile, plain=False)
    assert sum(counts()) == n0 + 1
    ref = _stream_call(kernel, outside, rays8, tile, plain=True)
    ci.hits_agree([x.cpu() for x in ref], [x.cpu() for x in got])
    assert float((got[1] >= 0).float().mean()) > 0.2
    rays8, _ = ci.pack_rays8(o, d, tile, t_max=t_max)
    kw = dict(has_tmax=True, any_hit=True)
    got = _stream_call(kernel, outside, rays8, tile, plain=False, **kw)
    ref = _stream_call(kernel, outside, rays8, tile, plain=True, **kw)
    blocked = got[0] < t_max
    assert torch.equal(blocked, ref[0] < t_max)
    assert 0 < int(blocked.sum()) < 4096


@pytest.mark.parametrize("route", [
    {}, dict(stream_granularity="chunk"), dict(stream_worklist=False),
    dict(stream_compact=False), dict(nee=True)])
def test_stream_render_card_matches_cpu(dev, route):
    """The streamed path on the card against the CPU, in each routing."""
    from logipathtracer_tpu_torch import ProgressiveRenderer, RenderConfig
    scene = _outside_host()
    cfg = RenderConfig(width=32, height=32, pool_size=1024, stream_tile=1024,
                       intersect="stream", **route)
    rads = []
    for device in (dev, "cpu"):
        r = ProgressiveRenderer(scene, cfg, host_seed=5, device=device)
        r.step(2)
        r.step(1)
        rads.append((r.radiance(), r.total_rays))
    (a, ra), (b, rb) = rads
    close = np.isclose(a, b, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() >= 0.995
    assert ra == rb


def _order_call(kernel, scene, rays8, tile, plain, **kw):
    """K7 or K8 (or its plain version) on a packed pool, with the tile
    octants the main path gives it."""
    from logipathtracer_tpu_torch.ops.kernels import cluster_intersect as k8
    inv = scene.obj_world_inv[:, :3, :4].reshape(-1, 12).contiguous()
    args = (rays8, ci.tile_octants(rays8, tile), scene.cl_order,
            scene.cl_meta, inv, scene.cl_aabb, scene.cl_tris, tile, 1e-4)
    if kernel == "k7":
        fn = ci.compact_order_intersect_plain if plain else \
            ci.compact_order_intersect
    else:
        fn = k8.dense_sweep_intersect_plain if plain else \
            k8.dense_sweep_intersect
    return fn(*args, **kw)


@pytest.mark.parametrize("kernel,tile", [("k7", 4096), ("k8", 1024)])
def test_k7_k8_match_plain(scene, dev, kernel, tile):
    """K7 and K8 against their plain versions: closest hits under
    hits_agree (with a tile whose first ray is parked), and the t_max
    query's visibility on every lane (K7 also with any-hit)."""
    from logipathtracer_tpu_torch.ops.kernels import cluster_intersect as k8
    o, d = _rays(8192, dev, seed=9)
    o[tile:tile + 50] = 1e30                  # a tile led by parked lanes
    d[tile:tile + 50] = 1.0
    counts = lambda: (ci.order_launches, k8.sweep_launches)
    rays8, _ = ci.pack_rays8(o, d, tile)
    n0 = counts()
    got = _order_call(kernel, scene, rays8, tile, plain=False)
    assert counts() == (n0[0] + (kernel == "k7"), n0[1] + (kernel == "k8"))
    ref = _order_call(kernel, scene, rays8, tile, plain=True)
    ci.hits_agree([x.cpu() for x in ref], [x.cpu() for x in got])
    assert float((got[1] >= 0).float().mean()) > 0.2
    t_max = torch.from_numpy(np.random.default_rng(4).uniform(
        0.05, 4.0, 8192).astype(np.float32)).to(dev)
    rays8, _ = ci.pack_rays8(o, d, tile, t_max=t_max)
    for kw in ([dict(has_tmax=True), dict(has_tmax=True, any_hit=True)]
               if kernel == "k7" else [dict(has_tmax=True)]):
        got = _order_call(kernel, scene, rays8, tile, plain=False, **kw)
        ref = _order_call(kernel, scene, rays8, tile, plain=True, **kw)
        blocked = got[0] < t_max
        assert torch.equal(blocked, ref[0] < t_max)
        assert 0 < int(blocked.sum()) < 8192
        if not kw.get("any_hit"):
            ci.hits_agree([x.cpu() for x in ref], [x.cpu() for x in got])


@pytest.mark.parametrize("route", [
    {}, dict(compact_worklist=False), dict(intersect="sweep"),
    dict(intersect="sweep", nee=True, scene="textured"),
    dict(intersect="bvh")])
def test_megakernel_card_matches_cpu(dev, route):
    """The megakernel on the card against the CPU (plain versions) on
    each resident route: K1, K7, K8, K8 with NEE, the BVH walk."""
    from logipathtracer_tpu_torch import (ProgressiveRenderer, RenderConfig,
                                          compile_scene)
    from logipathtracer_tpu_torch.scene.procedural import make_box_scene
    route = dict(route)
    kind = route.pop("scene", "plain")
    cfg = RenderConfig(width=32, height=32, renderer="megakernel",
                       compact_tile=256, sweep_tile=256, **route)
    host = compile_scene(make_box_scene(spheres=2, subdiv=3,
                                        textured=kind != "plain"), cfg)
    rads = []
    for device in (dev, "cpu"):
        r = ProgressiveRenderer(host, cfg, host_seed=5, device=device)
        r.step(2)
        r.step(1)
        rads.append((r.radiance(), r.total_rays))
    (a, ra), (b, rb) = rads
    close = np.isclose(a, b, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() >= 0.995
    assert ra == rb
