"""Kernels K1-K8 and K1's worklist kernel against their plain versions
on the card, at small shapes, in every mode (the intersect kernels'
t_max / any-hit shadow queries, K1 bit for bit and on crafted ties,
K3's edges, K6's cap 0 and cap > 0 bodies, K8's sub-tile body, K2
with textures and NEE), and the render on the card against the CPU, the
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


@pytest.mark.parametrize("has_tmax", [False, True])
@pytest.mark.parametrize("tile", [384, 1024, 4096])
def test_worklist_kernel_matches_plain(scene, dev, tile, has_tmax):
    """The worklist kernel against its plain version: wn and the whole
    of wl equal, on random, axis-aligned and parked rays (a tile of 384
    pads the mean's tree to 512)."""
    o, d = _rays(16384, dev, seed=11)
    t_max = torch.from_numpy(np.random.default_rng(12).uniform(
        0.05, 4.0, 16384).astype(np.float32)).to(dev)
    rays8, _ = ci.pack_rays8(o, d, tile, t_max=t_max if has_tmax else None)
    bounds = scene_cluster_bounds(scene)
    n0 = ci.prepass_launches
    wl, wn = ci.build_chunk_worklists(*bounds, rays8, tile, has_tmax=has_tmax)
    assert ci.prepass_launches == n0 + 1
    wlp, wnp = ci.build_chunk_worklists_plain(*bounds, rays8, tile,
                                              has_tmax=has_tmax)
    assert torch.equal(wn, wnp) and torch.equal(wl, wlp)
    assert int(wn.max()) > 0 and int(wn.min()) == 0


def test_worklist_kernel_chunks_match_plain(outside, dev):
    """K5's chunk worklists (padded chunk slots never fire)."""
    from logipathtracer_tpu_torch.ops.traverse import scene_chunk_bounds
    o, d, t_max = _outside_rays(8192, dev)
    bounds = scene_chunk_bounds(outside, 16)
    for tm in (None, t_max):
        rays8, _ = ci.pack_rays8(o, d, 1024, t_max=tm)
        kw = dict(has_tmax=tm is not None)
        wl, wn = ci.build_chunk_worklists(*bounds, rays8, 1024, **kw)
        wlp, wnp = ci.build_chunk_worklists_plain(*bounds, rays8, 1024, **kw)
        assert torch.equal(wn, wnp) and torch.equal(wl, wlp)
        assert int(wn.max()) > 0


@pytest.mark.parametrize("mode", ["closest", "tmax", "any_hit"])
def test_k1_bit_equal_to_plain(scene, dev, mode):
    """The compacted K1 equals its plain version bit for bit: t, tri
    and obj in closest-hit and t_max mode; t (so the visibility t <
    t_max) on every lane in any-hit mode, where tri is not part of the
    contract."""
    o, d = _rays(8192, dev, seed=13)
    t_max = torch.from_numpy(np.random.default_rng(14).uniform(
        0.05, 4.0, 8192).astype(np.float32)).to(dev)
    tile, has_tmax = 4096, mode != "closest"
    rays8, _ = ci.pack_rays8(o, d, tile, t_max=t_max if has_tmax else None)
    wl, wn = ci.build_chunk_worklists(*scene_cluster_bounds(scene), rays8,
                                      tile, has_tmax=has_tmax)
    inv = scene.obj_world_inv[:, :3, :4].reshape(-1, 12).contiguous()
    args = (rays8, wl, wn, scene.cl_meta, inv, scene.cl_aabb, scene.cl_tris,
            tile, 1e-4)
    kw = dict(has_tmax=has_tmax, any_hit=mode == "any_hit")
    got = ci.compact_wl_intersect(*args, **kw)
    ref = ci.compact_wl_intersect_plain(*args, **kw)
    assert torch.equal(got[0], ref[0])
    if mode != "any_hit":
        assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    hit = got[0] < (t_max if has_tmax else ci.BIG)
    assert 0 < int(hit.sum()) < 8192


def _tie_tables(dev, two_clusters: bool, s: int = 128):
    """One triangle (the z = 2 patch x + y < 0) in slots 5, 9 and 37 of
    cluster 0 (37 shares lane 5 of the 32-slot stride) and, with
    ``two_clusters``, in slot 2 of cluster 1, whose box lies nearer
    along +z; every other slot holds a triangle far off.  One object,
    identity transforms (tests/test_torch_worklist.py holds the same
    case against the JAX package)."""
    tris = np.zeros((2, 9, s), np.float32)
    tris[:, 0:3] = 50.0
    tris[:, 3] = tris[:, 7] = 1.0
    t_tri = np.array([-1, -1, 2, 2, 0, 0, 0, 2, 0], np.float32)
    for slot in (5, 9, 37):
        tris[0, :, slot] = t_tri
    if two_clusters:
        tris[1, :, 2] = t_tri
    g = lambda a: torch.from_numpy(a).to(dev)
    meta = g(np.array([[0, 0], [0, s]], np.int32))
    aabb = g(np.array([[-1, -1, 1.9, 1, 1, 2.1, 0, 0],
                       [-1, -1, 1.8, 1, 1, 2.05, 0, 0]], np.float32))
    inv = g(np.array([[1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0]], np.float32))
    bounds = ci.chunk_world_bounds(meta, aabb, torch.eye(4, device=dev)[None],
                                   2, 2, 1)
    return bounds, (meta, inv, aabb, g(tris))


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("two_clusters", [False, True])
def test_k1_ties_on_card(dev, two_clusters, any_hit):
    """Equal t in several slots and two clusters: the lowest slot of the
    earlier-visited cluster, as the plain version."""
    bounds, tables = _tie_tables(dev, two_clusters)
    r = np.random.default_rng(9)
    o = np.zeros((256, 3), np.float32)
    o[:, :2] = r.uniform(-0.8, -0.1, (256, 2))
    o = torch.from_numpy(o).to(dev)
    d = torch.zeros_like(o)
    d[:, 2] = 1.0
    rays8, _ = ci.pack_rays8(o, d, 128, t_max=torch.full((256,), 3.0,
                                                           device=dev))
    wl, wn = ci.build_chunk_worklists(*bounds, rays8, 128, has_tmax=True)
    assert wl[:, 0].tolist() == [1, 1] and wn.tolist() == [2, 2]
    args = (rays8, wl, wn, *tables, 128, 1e-4)
    kw = dict(has_tmax=True, any_hit=any_hit)
    got = ci.compact_wl_intersect(*args, **kw)
    ref = ci.compact_wl_intersect_plain(*args, **kw)
    assert torch.equal(got[0], ref[0])
    if any_hit:
        assert (got[0] == -ci.BIG).all()
    else:
        assert torch.equal(got[1], ref[1])
        assert (got[1] == (130 if two_clusters else 5)).all()


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


@pytest.mark.parametrize("case", ["unaligned", "ragged", "all_skipped",
                                  "one_run"])
def test_k3_edges_match_plain(dev, case):
    """K3 at its edges: pixel ids not 16-byte aligned, a row count not a
    multiple of 4 (a thread's last row past the end), nothing to flush,
    one run across many blocks and across the grid's stride.
    Bit-identical to the plain version, which adds each pixel's rows in
    the same order, and to a repeat."""
    r = np.random.default_rng(15)
    npix, rows, retired = 4096, 8191, 3000
    if case == "all_skipped":
        retired = 0
    ids = np.sort(r.integers(0, npix, retired)).astype(np.int32)
    if case == "one_run":
        ids[:] = 17
    pix = np.concatenate([np.full(rows + 1 - retired, -1, np.int32), ids])
    pix = torch.from_numpy(pix).to(dev)
    pix = pix[1:] if case == "unaligned" else pix[:rows]
    assert (pix.data_ptr() % 16 != 0) == (case == "unaligned")
    acc = torch.from_numpy(r.random((rows, 3)).astype(np.float32)).to(dev)
    base = torch.from_numpy(r.random((npix, 3)).astype(np.float32)).to(dev)
    a = flush.flush_sorted(base.clone(), pix, acc)
    b = flush.flush_sorted(base.clone(), pix, acc)
    p = flush.flush_sorted_plain(base.clone(), pix, acc)
    assert torch.equal(a, b) and torch.equal(a, p)
    assert torch.equal(a, base) == (case == "all_skipped")


def test_wrappers_check_inputs(scene, dev):
    with pytest.raises(ValueError, match="dtype"):
        flush.flush_sorted(torch.zeros((8, 3), device=dev),
                           torch.zeros(4, dtype=torch.int64, device=dev),
                           torch.zeros((4, 3), device=dev))
    boxes = torch.zeros((ci.MAX_BOXES + 1, 3), device=dev)
    with pytest.raises(ValueError, match="at most"):
        ci.build_chunk_worklists(boxes, boxes,
                                 torch.zeros((8, 1024), device=dev), 1024)


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


def _same(got, ref, any_hit):
    """Bit for bit: t, tri and obj; t alone with any_hit."""
    n = 1 if any_hit else 3
    return all(torch.equal(g, r) for g, r in zip(got[:n], ref[:n]))


@pytest.mark.parametrize("mode", ["closest", "tmax", "any_hit"])
@pytest.mark.parametrize("kernel", ["k4", "k5"])
def test_k4_k5_bit_equal_to_plain(outside, dev, kernel, mode):
    """K4 and K5 (the compacted visit) equal their plain versions bit for
    bit in every mode, on random and axis-aligned rays with a part-parked
    tile and an all-parked tile (wn = 0)."""
    o, d, t_max = _outside_rays(16384, dev)
    tile, has_tmax = 4096, mode != "closest"
    kw = dict(has_tmax=has_tmax, any_hit=mode == "any_hit")
    rays8, _ = ci.pack_rays8(o, d, tile, t_max=t_max if has_tmax else None)
    ref = _stream_call(kernel, outside, rays8, tile, plain=True, **kw)
    got = _stream_call(kernel, outside, rays8, tile, plain=False, **kw)
    assert _same(got, ref, kw["any_hit"])
    hit = got[0] < (t_max if has_tmax else ci.BIG)
    assert 0 < int(hit.sum()) < 12188
    assert not bool(hit[12188:].any())       # the parked lanes


def test_k4_k5_empty_worklists(outside, dev):
    """An all-parked tile lists no cluster (K4) and no chunk (K5)."""
    from logipathtracer_tpu_torch.ops.kernels import stream_cluster as k4
    from logipathtracer_tpu_torch.ops.traverse import scene_chunk_bounds
    o, d, _ = _outside_rays(16384, dev)
    rays8, _ = ci.pack_rays8(o, d, 4096)
    _, wn4 = k4.build_cluster_worklists(*scene_cluster_bounds(outside),
                                        rays8, 4096)
    _, wn5 = ci.build_chunk_worklists(*scene_chunk_bounds(outside, 16), rays8,
                                      4096)
    for wn in (wn4, wn5):
        assert int(wn[3]) == 0 and int(wn[2]) > 0


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("two_clusters", [False, True])
@pytest.mark.parametrize("kernel", ["k4", "k5"])
def test_k4_k5_ties_on_card(dev, kernel, two_clusters, any_hit):
    """test_k1_ties_on_card through K4 and K5 (one cluster a chunk): the
    lowest slot of the earlier-visited cluster, as the plain version."""
    from logipathtracer_tpu_torch.ops.kernels import stream_cluster as k4
    bounds, tables = _tie_tables(dev, two_clusters)
    r = np.random.default_rng(9)
    o = np.zeros((256, 3), np.float32)
    o[:, :2] = r.uniform(-0.8, -0.1, (256, 2))
    o = torch.from_numpy(o).to(dev)
    d = torch.zeros_like(o)
    d[:, 2] = 1.0
    rays8, _ = ci.pack_rays8(o, d, 128, t_max=torch.full((256,), 3.0,
                                                           device=dev))
    kw = dict(has_tmax=True, any_hit=any_hit)
    if kernel == "k4":
        wl, wn = k4.build_cluster_worklists(*bounds, rays8, 128,
                                            has_tmax=True)
        args = (rays8, wl, wn, *tables, 128, 1e-4)
        fn, plain = k4.stream_cl_intersect, k4.stream_cl_intersect_plain
    else:
        wl, wn = ci.build_chunk_worklists(*bounds, rays8, 128, has_tmax=True)
        args = (rays8, wl, wn, torch.cat(bounds, 1).contiguous(), *tables,
                128, 1, 1e-4)
        fn = ci.worklist_chunk_intersect
        plain = ci.worklist_chunk_intersect_plain
    assert wl[:, 0].tolist() == [1, 1] and wn.tolist() == [2, 2]
    ref = plain(*args, **kw)
    got = fn(*args, **kw)
    assert _same(got, ref, any_hit)
    if any_hit:
        assert (got[0] == -ci.BIG).all()
    else:
        assert (got[1] == (130 if two_clusters else 5)).all()


@pytest.mark.parametrize("kernel", ["k4", "k5"])
def test_k4_k5_cluster_size_128(dev, kernel):
    """K4 and K5 bit-equal to their plain versions on clusters of 128
    triangles (S = 128, not 512), closest hit and any-hit."""
    from logipathtracer_tpu_torch import RenderConfig, compile_scene
    from logipathtracer_tpu_torch.scene.procedural import make_outside_scene
    scene = compile_scene(
        make_outside_scene(objects=8, n_materials=8, tri_budget=8000),
        RenderConfig(cluster_size=128)).to(dev)
    assert scene.cl_tris.shape[2] == 128
    o, d, t_max = _outside_rays(8192, dev, seed=21)
    for kw in (dict(), dict(has_tmax=True, any_hit=True)):
        rays8, _ = ci.pack_rays8(o, d, 4096, t_max=t_max if kw else None)
        got = _stream_call(kernel, scene, rays8, 4096, plain=False, **kw)
        ref = _stream_call(kernel, scene, rays8, 4096, plain=True, **kw)
        assert _same(got, ref, bool(kw))
        assert 0 < int((got[0] < (t_max if kw else ci.BIG)).sum()) < 8192


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
