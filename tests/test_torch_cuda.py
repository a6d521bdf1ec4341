"""Kernels K1-K8, K1's worklist kernel and the texture prologue's kernel
against their plain versions on the card, at small shapes, in every mode
(the prologue on each atlas route, wrap, filter and mip path; the
intersect kernels'
t_max / any-hit shadow queries, K1 bit for bit and on crafted ties,
K3's edges, K6's cap 0 and cap > 0 bodies, K8's sub-tile body, K2
in every mode with both RNGs on its edges: mixed lobes, 16-order walks,
dead and missed blocks, odd lane counts, 600 lights, and sincosf's
bits), and the render on the card against the CPU, the wavefront and
the megakernel on each route, ``render_wavefront``'s slabs and the
device mesh, and at shapes with the traits of the default 1920x1080
configuration; and the render on the card against the JAX package's
own goldens (tests/goldens/).  Marked ``cuda``: they need
an NVIDIA card with nvcc and skip elsewhere.  On the card (which has no JAX, imported by the suite's
conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` repeats the comparison at the main path's shapes."""

import collections

import numpy as np
import pytest
import torch

from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
from logipathtracer_tpu_torch.ops.kernels import flush, shade
from logipathtracer_tpu_torch.ops.kernels._build import COUNTS
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
    n0 = COUNTS["compact_intersect"].launches
    got = ci.compact_wl_intersect(*args)
    assert COUNTS["compact_intersect"].launches == n0 + 1
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
    n0 = COUNTS["worklist_prepass"].launches
    wl, wn = ci.build_chunk_worklists(*bounds, rays8, tile, has_tmax=has_tmax)
    assert COUNTS["worklist_prepass"].launches == n0 + 1
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
    modes = COUNTS["compact_intersect"].modes
    for any_hit in (False, True):
        mode = "any_hit" if any_hit else "tmax"
        n0 = modes[mode]
        got = ci.compact_wl_intersect(*args, has_tmax=True, any_hit=any_hit)
        assert modes[mode] == n0 + 1
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
    n0 = COUNTS["shade"].modes["tex+nee"]
    got = shade.shade(*args, **kw)
    assert COUNTS["shade"].modes["tex+nee"] == n0 + 1 and len(got) == 11
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


# K2 on a synthetic table: a triangle on the plane z = 0 (identity
# transforms, tilted vertex normals) per material — diffuse, metallic,
# glass (ior 1.5) and a diffuse emitter — and rays from either side.
K2_MATERIALS = ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                (0.0, 0.0, 2.0))    # metallic, transmission, emission


def _k2_table(dev, rough):
    rows = []
    for (met, trans, emit), r in zip(K2_MATERIALS, rough):
        ts, os_ = np.zeros(32, np.float32), np.zeros(32, np.float32)
        ts[0:9] = [0, 0, 1, 0.1, 0, 1, 0, 0.1, 1]
        ts[15:24] = [-2, -2, 0, 6, -2, 0, -2, 6, 0]
        os_[0:9] = np.eye(3).ravel()
        os_[9:21] = np.hstack([np.eye(3), np.zeros((3, 1))]).ravel()
        os_[21:28] = [0.8, 0.5, 0.03, 1.0, emit, emit, emit]
        os_[28:32] = [met, r, trans, 1.5]
        rows.append(np.concatenate([ts, os_]))
    return torch.from_numpy(np.stack(rows)).to(dev)


def _k2_call(dev, n, mode, parity, seed=0, rough=(0.9, 0.3, 0.2, 0.5),
             tri=None, lights=3):
    """(args, kwargs) of K2 on n lanes of the synthetic table in mode
    base, tex, nee or tex+nee: lanes cycle through the materials (every
    warp holds all three lobes), 10% dead, 10% missing, a quarter below
    the plane (inside the glass)."""
    r = np.random.default_rng(seed)
    g = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    side = np.where(r.random(n) < 0.25, -1.0, 1.0)
    o = np.stack([r.uniform(-0.5, 0.5, n), r.uniform(-0.5, 0.5, n),
                  side], 1).astype(np.float32)
    d = np.stack([r.normal(0, 0.4, n), r.normal(0, 0.4, n), -side],
                 1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = (1.0 / np.abs(d[:, 2])).astype(np.float32)
    t[r.random(n) < 0.1] = 3.4e38                      # misses
    tri = (np.arange(n) % 4 if tri is None else tri).astype(np.int32)
    args = (_k2_table(dev, rough), g(o), g(d),
            g(r.random((n, 3)).astype(np.float32) * 0.1),
            g((0.2 + r.random((n, 3))).astype(np.float32)),
            g(r.random(n) < 0.9),
            g(r.integers(0, 2 ** 32, (n, 2), dtype=np.int64)),
            g(r.integers(0, 8, n).astype(np.int32)), g(t), g(tri))
    kw = dict(env=0.2, rr_threshold=0.5, rr_bounces=2, max_order=16,
              parity=parity)
    if "tex" in mode:
        met_tr = np.array([m[:2] for m in K2_MATERIALS])[tri % 3]
        mat = np.concatenate([
            r.random((n, 4)), r.random((n, 3)) * (tri[:, None] == 3),
            met_tr[:, :1], np.asarray(rough, np.float32)[tri][:, None],
            met_tr[:, 1:]], 1).astype(np.float32)
        nm = np.stack([r.normal(0, 0.2, n), r.normal(0, 0.2, n),
                       side], 1).astype(np.float32)
        nm /= np.linalg.norm(nm, axis=1, keepdims=True)
        kw.update(mat=g(mat), ff_mapped=g(nm), has_nmap=g(r.random(n) < 0.5))
    if "nee" in mode:
        lt = np.zeros((lights, 16), np.float32)
        lt[:, 0:3] = np.stack([r.uniform(-2, 1, lights),
                               r.uniform(-2, 1, lights),
                               r.uniform(1.5, 3, lights)], 1)
        lt[:, 3:6] = r.uniform(0.1, 1, (lights, 3)) * [1, 0, 0.1]
        lt[:, 6:9] = r.uniform(0.1, 1, (lights, 3)) * [0, 1, 0.1]
        lt[:, 9:12] = r.uniform(1, 5, (lights, 3))
        area = 0.5 * np.linalg.norm(np.cross(lt[:, 3:6], lt[:, 6:9]), axis=1)
        cdf = (np.cumsum(area) / area.sum()).astype(np.float32)
        cdf[-1] = 1.0
        pdf = (r.random(n) * 0.3).astype(np.float32)
        pdf[r.random(n) < 0.3] = 0.0
        kw.update(light_tris=g(lt), light_cdf=g(cdf), prev_pdf=g(pdf),
                  nee_mis=True, total_light_area=float(area.sum()))
    return args, kw


def _k2_long_call(dev, mode, parity):
    """Lanes whose walks take all 16 orders, found by the count pass
    over 2^16 candidates on the rough table (diffuse and metallic 2.0,
    glass 1.0), with a thousand of the others among them."""
    from logipathtracer_tpu_torch.tools import harness
    rough = (2.0, 2.0, 1.0, 2.0)
    n = 1 << 16
    args, kw = _k2_call(dev, n, mode, parity, seed=11, rough=rough,
                        tri=np.arange(n) % 3)
    with harness.shade_counted() as calls:
        shade.shade_plain(*args, **kw)
    work = harness.shade_work(calls[0])
    long_ = work["orders"] == 16
    keep = long_.clone()
    keep[:1000] = True
    idx = keep.nonzero().squeeze(1)
    lobe, steps = work["lobe"][idx], work["steps"][idx]
    assert bool(((lobe == 0) & (steps == 16)).any())   # exhausted diffuse
    assert bool(((lobe == 1) & long_[idx]).any())
    assert bool(((lobe == 2) & long_[idx]).any())
    take = lambda x: x[idx].contiguous()
    args = (args[0], *(take(x) for x in args[1:]))
    kw = {k: take(v) if isinstance(v, torch.Tensor) and
          k not in ("light_tris", "light_cdf") else v for k, v in kw.items()}
    return args, kw


def _k2_check(args, kw, mode):
    n0 = COUNTS["shade"].modes[mode]
    got = shade.shade(*args, **kw)
    torch.cuda.synchronize()
    assert COUNTS["shade"].modes[mode] == n0 + 1
    ref = shade.shade_plain(*args, **kw)
    shade.shade_agreement([x.cpu() for x in ref], [x.cpu() for x in got])
    return got


@pytest.mark.parametrize("parity", [True, False])
@pytest.mark.parametrize("mode", ["base", "tex", "nee", "tex+nee"])
@pytest.mark.parametrize("case", ["mixed", "long", "dead_and_miss_blocks",
                                  "R=1", "R=31", "R=1000"])
def test_k2_edges_match_plain(dev, case, mode, parity):
    """K2 against its plain version in every mode and with both RNGs: a
    warp mixing the three lobes, walks of all 16 orders (an exhausted
    diffuse walk among them), a block of dead lanes and one of misses
    (neither reads tri_shade), one lane, 31, and a count that is no
    multiple of the block."""
    if case == "long":
        args, kw = _k2_long_call(dev, mode, parity)
    else:
        n = {"R=1": 1, "R=31": 31, "R=1000": 1000}.get(case, 4096)
        args, kw = _k2_call(dev, n, mode, parity)
        if case == "dead_and_miss_blocks":
            args[5][:256] = False                # a block of dead lanes
            args[5][256:512] = True              # a block of misses
            args[8][256:512] = 3.4e38
    got = _k2_check(args, kw, mode)
    if case == "dead_and_miss_blocks":
        for k in range(4):                       # copied through
            assert torch.equal(got[k][:256], args[1 + k][:256])
        assert torch.equal(got[2][256:512], args[4][256:512] * 0.2)
        assert not bool(got[4][:512].any())
    if case == "mixed":
        assert 0 < int(got[4].sum()) < 4096


@pytest.mark.parametrize("parity", [True, False])
@pytest.mark.parametrize("mode", ["nee", "tex+nee"])
def test_k2_many_lights_match_plain(dev, mode, parity):
    """NEE over 600 lights: K2's binary search over the light table in
    global memory has no cap on the lights."""
    args, kw = _k2_call(dev, 4096, mode, parity, lights=600)
    got = _k2_check(args, kw, mode)
    assert bool((got[9] != 1.0).any())          # lanes sampled a light


def test_k2_sincosf_bits(dev):
    """K2 takes sincosf where the walk needs the sine and cosine of one
    angle; on every float it gives the bits of sinf and cosf."""
    assert shade.sincos_mismatches(dev) == 0


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


# The texture prologue's routes: atlas ("packed" RGBA8 or "f32"), quad
# atlas asked for, wrap mode, NEAREST samplers, mip levels, normal map,
# slots (base colour, emission, metallic-roughness, transmission, normal).
_TEX = dict(atlas="packed", quad=False, wrap="repeat", nearest=False,
            mips=1, normal=True, slots=(0, 1, 2, 3))
TEX_PROLOGUE_CASES = {
    "packed-4gather-repeat": {},
    "packed-4gather-clamp": dict(wrap="clamp"),
    "packed-4gather-mirror": dict(wrap="mirror"),
    "packed-quad-repeat": dict(quad=True),
    "packed-quad-clamp": dict(quad=True, wrap="clamp"),
    "f32-repeat": dict(atlas="f32"),
    "f32-clamp": dict(atlas="f32", wrap="clamp"),
    "f32-mirror": dict(atlas="f32", wrap="mirror"),
    "nearest-4gather": dict(nearest=True, wrap="mirror"),
    "nearest-quad": dict(nearest=True, quad=True, wrap="clamp"),
    "nearest-f32": dict(nearest=True, atlas="f32"),
    "mips": dict(mips=4),
    "mips-nearest-clamp": dict(mips=4, nearest=True, wrap="clamp"),
    "no-normal-map": dict(normal=False),
    "slot-subset": dict(slots=(0, 2), normal=False),
    "slot-subset-normal": dict(slots=(2,), quad=True),
}


def _tex_prologue_scene(case):
    """A textured box for one case (host scene, RenderConfig): the walls
    carry every asked slot, with uvs stretched to [-1.3, 2.4] so that
    taps wrap past both edges; the lamp an emissive map; the first
    sphere a base-colour map alone; the other none (texture id -1)."""
    from logipathtracer_tpu_torch import RenderConfig, compile_scene
    from logipathtracer_tpu_torch.scene.gltf import TextureData
    from logipathtracer_tpu_torch.scene.procedural import make_box_scene
    c = dict(_TEX, **TEX_PROLOGUE_CASES[case])
    wrap = {"repeat": 10497, "clamp": 33071, "mirror": 33648}[c["wrap"]]
    rng = np.random.default_rng(11)
    gltf = make_box_scene(spheres=2, subdiv=2)
    sizes = [(8, 8), (5, 7), (16, 16), (6, 9), (8, 8)]
    gltf.textures = []
    for k, (h, w) in enumerate(sizes):
        px = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
        if c["atlas"] == "f32":
            px = px.astype(np.float32)
        # NEAREST on every other map: both filters in one launch.
        filt = 9728 if c["nearest"] and k % 2 == 0 else 9729
        gltf.textures.append(TextureData(pixels=px, wrap_s=wrap, wrap_t=wrap,
                                         mag_filter=filt, min_filter=filt))
    names = ("base_color_texture", "emissive_texture",
             "metallic_roughness_texture", "transmission_texture",
             "normal_texture")
    walls, lamp, sphere = gltf.materials[0], gltf.materials[1], \
        gltf.materials[2]
    for k in c["slots"] + ((4,) if c["normal"] else ()):
        setattr(walls, names[k], k)
    if 1 in c["slots"]:
        lamp.emissive_texture = 1
    if 0 in c["slots"]:
        sphere.base_color_texture = 0
    walls.transmission_factor = 0.7
    for node in gltf.mesh_nodes:
        for p in node.primitives:
            if p.uvs is not None and p.material == 0:
                p.uvs = (p.uvs * 3.7 - 1.3).astype(np.float32)
    cfg = RenderConfig(mip_levels=c["mips"], tex_quad=c["quad"],
                       mip_spread=0.05)
    host = compile_scene(gltf, cfg)
    used = tuple(k in c["slots"] or (k == 4 and c["normal"])
                 for k in range(5))
    assert host.tex_slots == used
    assert (host.tex_quad is not None) == (c["quad"] and c["atlas"] ==
                                           "packed" and c["mips"] == 1
                                           and c["wrap"] != "mirror")
    assert (host.tex_atlas.ndim == 2) == (c["atlas"] == "packed"
                                          and c["mips"] == 1)
    assert host.has_nearest == c["nearest"] and host.mip_levels == c["mips"]
    return host, cfg


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("case", sorted(TEX_PROLOGUE_CASES))
def test_tex_prologue_bit_equal_to_plain(dev, case):
    """The texture prologue's kernel against its plain version on the
    card, bit for bit on the lanes K2 reads: with ``alive``, the live
    lanes (and zeros on the others), without it every hit lane."""
    from logipathtracer_tpu_torch.ops.intersect import INF
    from logipathtracer_tpu_torch.ops.kernels import tex_prologue as tp
    from logipathtracer_tpu_torch.ops.traverse import intersect_scene_sweep
    from logipathtracer_tpu_torch.tools.harness import tex_agreement
    host, cfg = _tex_prologue_scene(case)
    sc = host.to(dev)
    n = 8192
    o, d = _rays(n, dev, seed=7)          # a parked tail: misses
    t, obj, tri = intersect_scene_sweep(sc, o, d, tile=1024)
    alive = torch.from_numpy(
        np.random.default_rng(8).random(n) < 0.8).to(dev)
    live = alive & (t < INF)
    assert 0 < int(live.sum()) < n
    args = (sc, cfg, o, d, t, obj, tri)
    c = COUNTS["tex_prologue"]
    n0, p0 = c.launches, c.plain_calls
    got = tp.tex_prologue(*args, alive=alive)
    assert (c.launches, c.plain_calls) == (n0 + 1, p0)
    ref = tp.prologue_plain(*args)
    assert (got[1] is None) == (ref[1] is None) == (not sc.tex_slots[4])
    mat = got[0]
    assert torch.equal(_bits(mat[live]), _bits(ref[0][live]))
    assert not mat[~live].any()
    if ref[1] is not None:
        has = ref[2] & live
        assert torch.equal(got[2], has)
        assert torch.equal(_bits(got[1][has]), _bits(ref[1][has]))
        assert not got[1][~has].any()
    assert tex_agreement(got, ref, live) == (True, 0.0)
    # The taps read real texels: the floor's roughness varies.
    floor = live & (obj == 0)
    assert float(mat[floor, 8].std()) > 0.01
    hit = t < INF
    got = tp.tex_prologue(*args)
    assert torch.equal(_bits(got[0][hit]), _bits(ref[0][hit]))
    assert not got[0][~hit].any()
    if ref[1] is not None:
        has = ref[2] & hit
        assert torch.equal(got[2], has)
        assert torch.equal(_bits(got[1][has]), _bits(ref[1][has]))


def test_tex_prologue_checks_inputs(dev):
    """On CUDA tensors the prologue launches its kernel or raises: inputs
    it does not take never fall back to the plain version."""
    import dataclasses

    from logipathtracer_tpu_torch.ops.kernels import tex_prologue as tp
    from logipathtracer_tpu_torch.ops.traverse import intersect_scene_sweep
    host, cfg = _tex_prologue_scene("packed-quad-repeat")
    sc = host.to(dev)
    o, d = _rays(1024, dev, seed=9)
    t, obj, tri = intersect_scene_sweep(sc, o, d, tile=1024)
    p0 = COUNTS["tex_prologue"].plain_calls
    bad = [((sc, cfg, o, d, t.double(), obj, tri), "dtype"),
           ((sc, cfg, o[:, :2].contiguous(), d, t, obj, tri), "shape"),
           ((sc, cfg, o, d, t, obj, tri[:512]), "shape"),
           ((dataclasses.replace(sc, mip_levels=4), cfg, o, d, t, obj, tri),
            "mip chains"),
           ((dataclasses.replace(sc, tex_atlas=sc.tex_quad.float()), cfg, o,
             d, t, obj, tri), "quad atlas")]
    for args, what in bad:
        with pytest.raises(ValueError, match=what):
            tp.tex_prologue(*args)
    assert COUNTS["tex_prologue"].plain_calls == p0


def test_tex_prologue_on_the_main_path(dev, tmp_path):
    """A 64x64 NEE render of the PBR benchmark's scene (its generator at
    small maps) on the card: every textured shade step runs the kernel,
    in the graph form and eagerly, the plain version never; both forms
    give the same radiance."""
    from logipathtracer_tpu_torch import (ProgressiveRenderer, RenderConfig,
                                          compile_scene, load_gltf)
    from portbench.scenes import box_pbr
    from portbench.scenes.glb import write_glb
    path = write_glb(box_pbr.make(spheres=3, subdiv=1, tex_size=64),
                     str(tmp_path / "pbr.glb"))
    cfg = RenderConfig(width=64, height=64, nee=True, pool_size=4096,
                       compact_tile=256)
    host = compile_scene(load_gltf(path), cfg)
    assert host.has_textures and host.tex_slots == (True, True, True,
                                                    False, True)
    rads = []
    tp, k2 = COUNTS["tex_prologue"], COUNTS["shade"]
    for eager in (False, True):
        r = ProgressiveRenderer(host, cfg, host_seed=3, device=dev)
        r._eager = eager
        n0, p0 = tp.launches, tp.plain_calls
        k0, s0 = k2.modes["tex+nee"], k2.plain_calls
        r.step(2)
        launched = tp.launches - n0
        assert launched > 0
        assert launched == k2.modes["tex+nee"] - k0
        assert (tp.plain_calls, k2.plain_calls) == (p0, s0)
        rads.append(r.radiance())
    np.testing.assert_array_equal(rads[0], rads[1])


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
    hits under hits_agree (K6's cap = 0 body bit for bit), and the shadow
    query's visibility on every lane (the cap = 0 body, which ignores
    any_hit, bit for bit)."""
    o, d, t_max = _outside_rays(4096, dev)
    tile = 1024
    counts = lambda: tuple(COUNTS[k].launches for k in (
        "stream_cluster", "worklist_chunk", "octant_chunk"))
    rays8, _ = ci.pack_rays8(o, d, tile)
    n0 = sum(counts())
    got = _stream_call(kernel, outside, rays8, tile, plain=False)
    assert sum(counts()) == n0 + 1
    ref = _stream_call(kernel, outside, rays8, tile, plain=True)
    ci.hits_agree([x.cpu() for x in ref], [x.cpu() for x in got])
    assert kernel != "k6_cap0" or _same(got, ref, False)
    assert float((got[1] >= 0).float().mean()) > 0.2
    rays8, _ = ci.pack_rays8(o, d, tile, t_max=t_max)
    kw = dict(has_tmax=True, any_hit=True)
    got = _stream_call(kernel, outside, rays8, tile, plain=False, **kw)
    ref = _stream_call(kernel, outside, rays8, tile, plain=True, **kw)
    blocked = got[0] < t_max
    assert torch.equal(blocked, ref[0] < t_max)
    assert kernel != "k6_cap0" or _same(got, ref, False)
    assert 0 < int(blocked.sum()) < 4096


def _same(got, ref, any_hit):
    """Bit for bit: t, tri and obj; t alone with any_hit."""
    n = 1 if any_hit else 3
    return all(torch.equal(g, r) for g, r in zip(got[:n], ref[:n]))


def _compacted_call(kernel, scene, rays8, tile, plain, **kw):
    """K4, K5 or K6's cap > 0 body (``_stream_call``), or K7
    (``_order_call``)."""
    if kernel == "k7":
        return _order_call(kernel, scene, rays8, tile, plain, **kw)
    return _stream_call(kernel, scene, rays8, tile, plain, **kw)


@pytest.mark.parametrize("mode", ["closest", "tmax", "any_hit"])
@pytest.mark.parametrize("kernel", ["k4", "k5", "k6", "k7"])
def test_k4_k5_bit_equal_to_plain(request, dev, kernel, mode):
    """K4, K5, K6's cap > 0 body and K7 (the compacted visit) equal their
    plain versions bit for bit in every mode, on random and axis-aligned
    rays with parked lanes: K4-K6 on the outside class with a part-parked
    tile and an all-parked tile (wn = 0, live = 0), K7 on the box with a
    tile led by parked lanes (octant 7) and an all-parked tile."""
    from logipathtracer_tpu_torch.ops.kernels import cluster_intersect as k6
    tile, has_tmax = 4096, mode != "closest"
    kw = dict(has_tmax=has_tmax, any_hit=mode == "any_hit")
    if kernel == "k7":
        scene = request.getfixturevalue("scene")
        o, d = _rays(16384, dev, seed=15)
        o[tile:tile + 50] = 1e30
        d[tile:tile + 50] = 1.0
        t_max = torch.from_numpy(np.random.default_rng(16).uniform(
            0.05, 4.0, 16384).astype(np.float32)).to(dev)
    else:
        scene = request.getfixturevalue("outside")
        o, d, t_max = _outside_rays(16384, dev)
    parked = o[:, 0] >= 1e29
    rays8, _ = ci.pack_rays8(o, d, tile, t_max=t_max if has_tmax else None)
    if kernel == "k6":
        assert k6.tile_front(rays8, tile)[1].tolist() == [1, 1, 1, 0]
    if kernel == "k7":
        assert int(ci.tile_octants(rays8, tile)[1]) == 7
    ref = _compacted_call(kernel, scene, rays8, tile, True, **kw)
    got = _compacted_call(kernel, scene, rays8, tile, False, **kw)
    assert _same(got, ref, kw["any_hit"])
    hit = got[0] < (t_max if has_tmax else ci.BIG)
    assert 0 < int(hit.sum()) < int((~parked).sum())
    assert not bool(hit[parked].any())
    assert bool(parked[-tile:].all())          # an all-parked tile


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
@pytest.mark.parametrize("kernel", ["k4", "k5", "k6", "k7", "k6_cap0", "k8"])
def test_k4_k5_ties_on_card(dev, kernel, two_clusters, any_hit):
    """test_k1_ties_on_card through K4, K5 and K6's two bodies (one
    cluster a chunk; each visits the nearer cluster first), K7 and K8 (in
    the order cluster 0, 1): the lowest slot of the earlier-visited
    cluster, as the plain version.  K6's cap = 0 body and K8 ignore
    any_hit: the closest hit under t_max."""
    from logipathtracer_tpu_torch.ops.kernels import cluster_intersect as k6
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
        assert wl[:, 0].tolist() == [1, 1] and wn.tolist() == [2, 2]
    elif kernel == "k5":
        wl, wn = ci.build_chunk_worklists(*bounds, rays8, 128, has_tmax=True)
        args = (rays8, wl, wn, torch.cat(bounds, 1).contiguous(), *tables,
                128, 1, 1e-4)
        fn = ci.worklist_chunk_intersect
        plain = ci.worklist_chunk_intersect_plain
        assert wl[:, 0].tolist() == [1, 1] and wn.tolist() == [2, 2]
    elif kernel in ("k6", "k6_cap0"):
        oct_, live = k6.tile_front(rays8, 128)
        order = k6.octant_chunk_order(*bounds)
        args = (rays8, oct_, order, live, torch.cat(bounds, 1).contiguous(),
                *tables, 128, 1, 1e-4)
        fn, plain = k6.octant_chunk_intersect, k6.octant_chunk_intersect_plain
        kw["cap"] = 32 if kernel == "k6" else 0
        assert order[oct_.long()].tolist() == [[1, 0]] * 2
        assert live.tolist() == [1, 1]
    elif kernel == "k8":
        order = torch.tensor([[0, 1]] * 8, dtype=torch.int32, device=dev)
        args = (rays8, ci.tile_octants(rays8, 128), order, *tables, 128,
                1e-4)
        fn, plain = k6.dense_sweep_intersect, k6.dense_sweep_intersect_plain
        kw = dict(has_tmax=True)
    else:
        order = torch.tensor([[0, 1]] * 8, dtype=torch.int32, device=dev)
        args = (rays8, ci.tile_octants(rays8, 128), order, *tables, 128,
                1e-4)
        fn = ci.compact_order_intersect
        plain = ci.compact_order_intersect_plain
    ref = plain(*args, **kw)
    got = fn(*args, **kw)
    parked = any_hit and kernel not in ("k6_cap0", "k8")
    assert _same(got, ref, parked)
    if parked:
        assert (got[0] == -ci.BIG).all()
    else:
        nearer_first = two_clusters and kernel not in ("k7", "k8")
        assert (got[1] == (130 if nearer_first else 5)).all()
        assert (got[0] == 2.0).all()


@pytest.mark.parametrize("kernel", ["k4", "k5", "k6", "k7"])
def test_k4_k5_cluster_size_128(dev, kernel):
    """K4, K5, K6's cap > 0 body and K7 bit-equal to their plain versions
    on clusters of 128 triangles (S = 128, not 512; a multiple of 4, as
    K5's and K6's cp.async prefetch needs), closest hit and any-hit."""
    from logipathtracer_tpu_torch import RenderConfig, compile_scene
    from logipathtracer_tpu_torch.scene.procedural import make_outside_scene
    scene = compile_scene(
        make_outside_scene(objects=8, n_materials=8, tri_budget=8000),
        RenderConfig(cluster_size=128)).to(dev)
    assert scene.cl_tris.shape[2] == 128
    o, d, t_max = _outside_rays(8192, dev, seed=21)
    for kw in (dict(), dict(has_tmax=True, any_hit=True)):
        rays8, _ = ci.pack_rays8(o, d, 4096, t_max=t_max if kw else None)
        got = _compacted_call(kernel, scene, rays8, 4096, False, **kw)
        ref = _compacted_call(kernel, scene, rays8, 4096, True, **kw)
        assert _same(got, ref, bool(kw))
        assert 0 < int((got[0] < (t_max if kw else ci.BIG)).sum()) < 8192


def _grid_tables(dev, s=128):
    """One flat, axis-aligned cluster: an 8 x 8 grid of unit squares on
    the plane z = 2 (x, y in [0, 8]), two triangles each, slot 2k + j the
    k-th square in row-major order, so that 32-slot group g holds rows
    2g, 2g + 1: every hit lies on its group box's z faces and a hit on a
    grid line on an x or y face.  One object, identity transform."""
    tris = np.zeros((1, 9, s), np.float32)
    for k in range(64):
        x, y = k % 8, k // 8
        for j, (v0, e1, e2) in enumerate((((x, y), (1, 0), (0, 1)),
                                          ((x + 1, y + 1), (-1, 0),
                                           (0, -1)))):
            tris[0, :, 2 * k + j] = [v0[0], v0[1], 2, e1[0], e1[1], 0,
                                     e2[0], e2[1], 0]
    g = lambda a: torch.from_numpy(a).to(dev)
    meta = g(np.array([[0, 0]], np.int32))
    aabb = g(np.array([[0, 0, 2, 8, 8, 2, 0, 0]], np.float32))
    inv = g(np.array([[1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0]], np.float32))
    bounds = ci.chunk_world_bounds(meta, aabb, torch.eye(4, device=dev)[None],
                                   1, 1, 1)
    return bounds, (meta, inv, aabb, g(tris))


def _group_edge_case(case, dev):
    """(bounds or None, tables or None, origin, direction, t_max) of K4's
    group edge cases: "grid", rays up +z at the grid lines inside the
    cluster's box and their crossings (on the group boxes' faces), at
    random points and tilted;
    "ground", rays down onto the outside scene's ground quad (a cluster
    of 2 real triangles, flat in y) at its edges, corners and inside."""
    r = np.random.default_rng(31)
    n = 1024
    if case == "grid":
        bounds, tables = _grid_tables(dev)
        xy = r.integers(1, 16, (n, 2)).astype(np.float32) / 2
        xy[n // 2:] = r.uniform(-0.5, 8.5, (n // 2, 2))
        o = np.concatenate([xy, np.zeros((n, 1), np.float32)], 1)
        d = np.tile(np.float32([0, 0, 1]), (n, 1))
        d[3 * n // 4:, :2] = r.uniform(-0.3, 0.3, (n // 4, 2))
        t_max = r.uniform(1.0, 3.0, n).astype(np.float32)
    else:
        bounds = tables = None
        xz = r.integers(-2, 3, (n, 2)).astype(np.float32) * 15.0  # edges
        xz[n // 2:] = r.uniform(-31, 31, (n // 2, 2))
        target = np.stack([xz[:, 0], np.zeros(n, np.float32), xz[:, 1]], 1)
        o = target + r.uniform(-3, 3, (n, 3)).astype(np.float32)
        o[:, 1] = r.uniform(40.0, 60.0, n)      # above every sphere
        o[:n // 4, [0, 2]] = target[:n // 4][:, [0, 2]]  # straight down
        d = target - o
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        t_max = r.uniform(30.0, 80.0, n).astype(np.float32)
    g = lambda a: torch.from_numpy(np.ascontiguousarray(a,
                                                        np.float32)).to(dev)
    return bounds, tables, g(o), g(d), g(t_max)


@pytest.mark.parametrize("mode", ["closest", "tmax", "any_hit"])
@pytest.mark.parametrize("case", ["primary", "bounce", "shadow", "ground",
                                  "grid"])
def test_k4_groups_bit_equal_to_plain(dev, case, mode):
    """K4's triangle test by 32-slot groups equals the plain version bit
    for bit (t, tri and obj; t alone with any-hit): on the small outside
    scene's main-path pools (camera rays, the bounce pool after a step,
    NEE shadow rays), on its ground quad (one cluster of 2 real
    triangles, hits on its flat box's faces, edges and corners) and on a
    flat axis-aligned grid whose hits lie on its group boxes' faces."""
    from logipathtracer_tpu_torch import RenderConfig
    from logipathtracer_tpu_torch.ops.kernels import stream_cluster as k4
    from logipathtracer_tpu_torch.tools import harness
    kw = dict(has_tmax=mode != "closest", any_hit=mode == "any_hit")
    tile = 1024
    if case in ("primary", "bounce", "shadow"):
        cfg = RenderConfig(width=64, height=64, pool_size=4096,
                           stream_tile=tile, intersect="stream")
        if "pools" not in _OUTSIDE:
            _OUTSIDE["pools"] = harness.pools(_outside_host(), cfg, dev,
                                              tile)
        rays8 = _OUTSIDE["pools"][case][0].clone()
        if kw["has_tmax"] and case != "shadow":
            t_max = torch.from_numpy(np.random.default_rng(32).uniform(
                0.5, 40.0, rays8.shape[1]).astype(np.float32)).to(dev)
            rays8[6] = torch.where(rays8[0] < 1e29, t_max, ci.INF)
        scene = _outside_host().to(dev)
        bounds, tables = scene_cluster_bounds(scene), harness.scene_tables(
            scene)
    else:
        bounds, tables, o, d, t_max = _group_edge_case(case, dev)
        if case == "ground":
            scene = _outside_host().to(dev)
            bounds, tables = scene_cluster_bounds(scene), \
                harness.scene_tables(scene)
        rays8, _ = ci.pack_rays8(o, d, tile,
                                 t_max=t_max if kw["has_tmax"] else None)
    wl, wn = k4.build_cluster_worklists(*bounds, rays8, tile,
                                        has_tmax=kw["has_tmax"])
    args = (rays8, wl, wn, *tables, tile, 1e-4)
    groups = ci.cluster_groups(*tables)
    n0 = COUNTS["stream_cluster"].launches
    got = k4.stream_cl_intersect(*args, groups=groups, **kw)
    assert COUNTS["stream_cluster"].launches == n0 + 1
    ref = k4.stream_cl_intersect_plain(*args, **kw)
    assert _same(got, ref, kw["any_hit"])
    live = rays8[0] < 1e29
    hit = got[0] < (rays8[6] if kw["has_tmax"] else ci.BIG)
    assert 0 < int(hit.sum()) <= int(live.sum())
    if case == "ground":        # the ground's cluster: 2 triangles
        counts = (tables[3] != 0).any(dim=1).sum(dim=1)
        assert int(counts.min()) == 2 and int(groups[1].min()) == 1
        assert int(hit.sum()) > len(hit) // 4
    if case == "grid" and mode == "closest":
        assert bool(hit[:512].all())            # every grid point is hit


_BOX = {}


@pytest.mark.parametrize("mode", ["closest", "tmax", "any_hit"])
@pytest.mark.parametrize("case", ["primary", "bounce", "shadow", "ground",
                                  "grid"])
def test_k1_groups_bit_equal_to_plain(dev, case, mode):
    """K1's triangle test by 32-slot groups equals the plain version bit
    for bit (t, tri and obj; t alone with any-hit): on the benchmark's
    box class's main-path pools (camera rays, the bounce pool after a
    step, NEE shadow rays), on the outside scene's ground quad (one
    cluster of one group of 2 real slots, hits on its flat box's faces,
    edges and corners) and on a flat axis-aligned grid whose hits lie on
    its group boxes' faces."""
    from logipathtracer_tpu_torch import RenderConfig, compile_scene
    from logipathtracer_tpu_torch.ops.traverse import scene_cluster_groups
    from logipathtracer_tpu_torch.scene.procedural import make_box_scene
    from logipathtracer_tpu_torch.tools import harness
    kw = dict(has_tmax=mode != "closest", any_hit=mode == "any_hit")
    tile = 1024
    groups = None
    if case in ("primary", "bounce", "shadow"):
        if "host" not in _BOX:
            _BOX["host"] = compile_scene(make_box_scene(spheres=10,
                                                        subdiv=3))
            cfg = RenderConfig(width=64, height=64, pool_size=4096,
                               compact_tile=tile)
            _BOX["pools"] = harness.pools(_BOX["host"], cfg, dev, tile)
        rays8 = _BOX["pools"][case][0].clone()
        if kw["has_tmax"] and case != "shadow":
            t_max = torch.from_numpy(np.random.default_rng(33).uniform(
                0.5, 40.0, rays8.shape[1]).astype(np.float32)).to(dev)
            rays8[6] = torch.where(rays8[0] < 1e29, t_max, ci.INF)
        scene = _BOX["host"].to(dev)
        bounds, tables = scene_cluster_bounds(scene), harness.scene_tables(
            scene)
        groups = scene_cluster_groups(scene)
    else:
        bounds, tables, o, d, t_max = _group_edge_case(case, dev)
        if case == "ground":
            scene = _outside_host().to(dev)
            bounds, tables = scene_cluster_bounds(scene), \
                harness.scene_tables(scene)
        rays8, _ = ci.pack_rays8(o, d, tile,
                                 t_max=t_max if kw["has_tmax"] else None)
    wl, wn = ci.build_chunk_worklists(*bounds, rays8, tile,
                                      has_tmax=kw["has_tmax"])
    args = (rays8, wl, wn, *tables, tile, 1e-4)
    n0 = COUNTS["compact_intersect"].launches
    got = ci.compact_wl_intersect(*args, groups=groups, **kw)
    assert COUNTS["compact_intersect"].launches == n0 + 1
    ref = ci.compact_wl_intersect_plain(*args, **kw)
    assert _same(got, ref, kw["any_hit"])
    live = rays8[0] < 1e29
    hit = got[0] < (rays8[6] if kw["has_tmax"] else ci.BIG)
    assert 0 < int(hit.sum()) <= int(live.sum())
    gn = ci.cluster_groups(*tables)[1]
    if case == "ground":        # the ground's cluster: 2 triangles
        counts = (tables[3] != 0).any(dim=1).sum(dim=1)
        assert int(counts.min()) == 2 and int(gn.min()) == 1
        assert int(hit.sum()) > len(hit) // 4
    if case == "grid" and mode == "closest":
        assert bool(hit[:512].all())            # every grid point is hit
    if case == "primary":       # sparse clusters: groups are culled
        assert int(gn.min()) == 1 and int(gn.max()) < tables[3].shape[2] // 32


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
    hits_agree (with a tile whose first ray is parked; K8 bit for bit),
    and the t_max query's visibility on every lane (K7 also with
    any-hit)."""
    o, d = _rays(8192, dev, seed=9)
    o[tile:tile + 50] = 1e30                  # a tile led by parked lanes
    d[tile:tile + 50] = 1.0
    counts = lambda: (COUNTS["compact_order"].launches,
                      COUNTS["dense_sweep"].launches)
    rays8, _ = ci.pack_rays8(o, d, tile)
    n0 = counts()
    got = _order_call(kernel, scene, rays8, tile, plain=False)
    assert counts() == (n0[0] + (kernel == "k7"), n0[1] + (kernel == "k8"))
    ref = _order_call(kernel, scene, rays8, tile, plain=True)
    ci.hits_agree([x.cpu() for x in ref], [x.cpu() for x in got])
    assert kernel != "k8" or _same(got, ref, False)
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
            assert kernel != "k8" or _same(got, ref, False)


def _degenerate(scene):
    """The scene with slots 1-3 of every cluster degenerate where they
    lie: e1 = 0 (det = 1/0), e2 = e1 (det = 0) and a point (e1 = e2 =
    0)."""
    tris = scene.cl_tris.clone()
    tris[:, 3:6, 1] = 0.0
    tris[:, 6:9, 2] = tris[:, 3:6, 2]
    tris[:, 3:9, 3] = 0.0
    import dataclasses
    return dataclasses.replace(scene, cl_tris=tris.contiguous())


def _subtile_edge_rays(n, dev, seed, spread, centre, second, t_scale):
    """n rays with every edge of the sub-tile visit: axis-aligned (1/0 =
    inf) and NaN directions, parked lanes (origin 1e30) and a parked
    tail, and two sub-tiles of the first tile looking from ``centre``
    along +x and about ``second`` (so that they gate different clusters);
    t_max random in (0, t_scale) with +inf (some with NaN directions), 0
    and NaN lanes."""
    r = np.random.default_rng(seed)
    o = (centre + r.uniform(-spread, spread, (n, 3))).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o[0:256] = centre
    d[0:128] = (1.0, 0.0, 0.0)
    d[128:256] = second + r.uniform(-0.05, 0.05, (128, 3))
    axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    d[300:400] = axes[r.integers(0, 6, 100)]
    d[400:410, 0] = np.nan
    d[600:640, :] = np.nan
    o[700:760] = 1e30
    o[n - n // 4:] = 1e30
    d[n - n // 4:] = 1.0
    t_max = r.uniform(0.01, t_scale, n).astype(np.float32)
    t_max[0:64] = np.inf
    t_max[500:540] = np.inf
    d[520:530] = np.nan                 # NaN t in every slot: no hit
    t_max[540:545] = 0.0
    t_max[545:550] = np.nan
    as_t = lambda a: torch.from_numpy(a).to(dev)
    return as_t(o), as_t(d), as_t(t_max)


@pytest.mark.parametrize("has_tmax", [False, True])
@pytest.mark.parametrize("kernel", ["k6_cap0", "k8"])
def test_subtile_visit_edges_bit_equal_to_plain(request, dev, kernel,
                                                has_tmax):
    """K6's cap = 0 body and K8 (the sub-tile visit) equal their plain
    versions bit for bit — t, tri and obj — with and without t_max, on a
    pool with axis-aligned and NaN directions, parked lanes, degenerate
    triangles, t_max = +inf lanes (a miss accepts kInf at slot 0), and
    two sub-tiles of one tile that gate different clusters."""
    if kernel == "k8":
        scene = _degenerate(request.getfixturevalue("scene"))
        centre, second, spread, t_scale = 0.0, (-1, 0, 0), 0.8, 4.0
    else:
        scene = _degenerate(request.getfixturevalue("outside"))
        centre, second, spread, t_scale = (0, 2, 0), (0, -1, 0), 25.0, 40.0
    n, tile = 8192, 1024
    o, d, t_max = _subtile_edge_rays(n, dev, 31, spread, np.array(
        centre, np.float32), np.array(second, np.float32), t_scale)
    rays8, _ = ci.pack_rays8(o, d, tile, t_max=t_max if has_tmax else None)
    kw = dict(has_tmax=has_tmax)
    call = _order_call if kernel == "k8" else _stream_call
    got = call(kernel, scene, rays8, tile, False, **kw)
    ref = call(kernel, scene, rays8, tile, True, **kw)
    assert _same(got, ref, False)
    tri = got[1].cpu()
    a, b = set(tri[0:128].tolist()) - {-1}, set(tri[128:256].tolist()) - {-1}
    assert a and b and not a & b       # the two sub-tiles hit apart
    hit = got[1] >= 0
    assert 0 < int(hit.sum()) < n
    assert not bool(hit[n - n // 4:].any())
    if has_tmax:        # a lane of a gated sub-tile under an infinite
        inf = torch.isinf(t_max) & hit      # t_max hits, kInf at worst
        assert bool(inf[0:64].any()) and bool((got[0][inf] <= 3.4e38).all())


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


@pytest.mark.parametrize("renderer", ["wavefront", "megakernel"])
@pytest.mark.parametrize("nee", [False, True])
def test_basic_route_launches_no_k2(dev, nee, renderer):
    """The basic BSDF on the card: the worklist kernel and K1 (with NEE
    also in its any-hit mode) and, in the wavefront, K3 launch; K2 never
    does, nor any plain version; the basic route shades.  The radiance
    matches the CPU render under the pixel rule with equal ray counts."""
    from logipathtracer_tpu_torch import (ProgressiveRenderer, RenderConfig,
                                          compile_scene)
    from logipathtracer_tpu_torch.scene.procedural import make_box_scene
    cfg = RenderConfig(width=32, height=32, pool_size=1024,
                       compact_tile=256, use_microfacet=False, nee=nee,
                       renderer=renderer)
    host = compile_scene(make_box_scene(spheres=2, subdiv=3), cfg)
    k1, wl, k2, k3 = (COUNTS[k] for k in (
        "compact_intersect", "worklist_prepass", "shade", "flush"))
    plain = lambda: tuple(c.plain_calls for c in (k1, wl, k2, k3))
    before = dict(k1=k1.launches, wl=wl.launches,
                  any_hit=k1.modes["any_hit"], k3=k3.launches,
                  k2=k2.launches, basic=COUNTS["shade_basic"].plain_calls,
                  plain=plain())
    r = ProgressiveRenderer(host, cfg, host_seed=5, device=dev)
    r.step(2)
    r.step(1)
    a = r.radiance()
    assert k1.launches > before["k1"] and wl.launches > before["wl"]
    assert (k1.modes["any_hit"] > before["any_hit"]) == nee
    assert (k3.launches > before["k3"]) == (renderer == "wavefront")
    assert k2.launches == before["k2"]
    assert COUNTS["shade_basic"].plain_calls > before["basic"]
    assert plain() == before["plain"]
    c = ProgressiveRenderer(host, cfg, host_seed=5, device="cpu")
    c.step(2)
    c.step(1)
    close = np.isclose(a, c.radiance(), rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() >= 0.995
    assert r.total_rays == c.total_rays


def test_cli_basic_render_card_matches_cpu(dev, tmp_path, capsys):
    """``render --basic`` through the command line at 64x64 on the card
    against ``--cpu``: the pixel rule, equal spp and total_rays."""
    import json

    from logipathtracer_tpu_torch.cli.main import main
    from logipathtracer_tpu_torch.scene.procedural import make_box_scene
    from logipathtracer_tpu_torch.tools.glb import write_glb
    glb = write_glb(make_box_scene(spheres=2, subdiv=3),
                    str(tmp_path / "box.glb"))
    out = {}
    for name, extra in (("card", []), ("cpu", ["--cpu"])):
        npz = str(tmp_path / f"{name}.npz")
        assert main(["render", glb, "--width", "64", "--height", "64",
                     "--spp", "3", "--basic", "--radiance", npz, "-o",
                     str(tmp_path / f"{name}.png"), *extra]) == 0
        report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        out[name] = (report, np.load(npz)["radiance"])
    (rg, a), (rc, b) = out["card"], out["cpu"]
    assert rg["spp"] == rc["spp"] == 3
    assert rg["total_rays"] == rc["total_rays"] > 0
    close = np.isclose(a, b, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() >= 0.995


@pytest.mark.parametrize("nee", [False, True])
def test_render_wavefront_and_mesh_on_card(dev, nee):
    """render_wavefront's 32-row slabs equal its 64x64 frame bit for bit
    on the card, the frame meets the pixel rule against the CPU's with
    equal rays and iterations, and a (1, 2) mesh on the card equals the
    single-shot session with the same host seed bit for bit."""
    from logipathtracer_tpu_torch import (MeshRenderer, ProgressiveRenderer,
                                          RenderConfig, compile_scene,
                                          render_wavefront)
    from logipathtracer_tpu_torch.parallel.mesh import make_mesh
    from logipathtracer_tpu_torch.scene.procedural import make_box_scene
    host = compile_scene(make_box_scene(spheres=2, subdiv=3, textured=nee))
    cfg = RenderConfig(width=64, height=64, compact_tile=256, nee=nee,
                       pool_size=4096, pool_carryover=False)
    cam = host.cameras[0]
    world = torch.from_numpy(np.asarray(cam.world_matrix, np.float32))
    seeds = torch.tensor([[12345, 678]])
    out = {}
    for d in (dev, torch.device("cpu")):
        args = (host.to(d), cfg, world.to(d), float(cam.yfov), seeds.to(d))
        out[d.type] = render_wavefront(*args)
        if d == dev:
            n0 = COUNTS["compact_intersect"].launches
            parts = [render_wavefront(*args, y0=y0, rows=32)
                     for y0 in (0, 32)]
            assert COUNTS["compact_intersect"].launches > n0
            assert torch.equal(torch.cat([p[0] for p in parts]),
                               out["cuda"][0])
            assert sum(p[1] for p in parts) == out["cuda"][1]
    (card, rays, it), (cpu, rays_cpu, it_cpu) = out["cuda"], out["cpu"]
    close = np.isclose(card.cpu().numpy(), cpu.numpy(), rtol=1e-4,
                       atol=1e-6).all(-1)
    assert close.mean() >= 0.995
    assert rays == rays_cpu and it == it_cpu
    session = ProgressiveRenderer(host, cfg, host_seed=4, device=dev)
    mesh = MeshRenderer(host, cfg, make_mesh([dev] * 2, samples=1, tiles=2),
                        host_seed=4)
    for _ in range(2):
        session.step(1)
        mesh.step()
    np.testing.assert_array_equal(mesh.radiance(), session.radiance())
    assert mesh.total_rays == session.total_rays


@pytest.mark.parametrize("name", ["box_textured_64x64_2spp",
                                  "outside_64x64_2spp"])
def test_card_matches_jax_goldens(dev, name):
    """The card against the reference itself: the JAX package's golden
    radiance (tests/goldens/, specs restated in test_torch_goldens.py),
    rendered on the card with the golden's host seed and sample count,
    on >= 99.5% of pixels (rtol 1e-4, atol 1e-6)."""
    from test_torch_goldens import FRAC, close_frac, render_golden
    rad, data = render_golden(name, dev)
    frac = close_frac(rad, data["radiance"])
    assert frac >= FRAC, f"{name}: {frac:.5f} of pixels close"


@pytest.mark.parametrize("fields", [
    dict(width=48, height=27, compact_tile=256),
    dict(width=40, height=24, compact_tile=256, pool_size=512),
    dict(width=48, height=27, compact_tile=256, renderer="megakernel"),
    dict(width=24, height=14, compact_tile=256, render_scale=2),
], ids=["unblocked", "small_pool", "megakernel", "render_scale"])
def test_default_traits_card_matches_cpu(dev, fields):
    """The card against the CPU at shapes with the traits of the default
    1920x1080 configuration (tests/test_torch_default_shape.py): row-major
    pixels, a padded tail tile, a pool smaller than the frame, a camera
    move with paths in flight, render_scale=2 through image() (and its
    render-size radiance).  Only there is the tonemapped image compared:
    elsewhere its dark channels, where 1 - exp(-x) cancels, turn the
    device exp's last bit into more than rtol 1e-4."""
    from logipathtracer_tpu_torch import (ProgressiveRenderer, RenderConfig,
                                          compile_scene)
    from logipathtracer_tpu_torch.scene.procedural import make_box_scene
    host = compile_scene(make_box_scene(spheres=2, subdiv=3))
    cfg = RenderConfig(max_depth=5, **fields)
    out = []
    for d in (dev, "cpu"):
        r = ProgressiveRenderer(host, cfg, host_seed=3, device=d)
        r.step(2)
        r.rotate(1, 0.05)
        r.step(1)
        r.step(1)
        out.append((r.image().cpu().numpy(), r.radiance(), r.total_rays))
    (img, rad, rays), (img_c, rad_c, rays_c) = out
    pairs = [(rad, rad_c)] + ([(img, img_c)] if cfg.render_scale > 1 else [])
    for a, b in pairs:
        close = np.isclose(a, b, rtol=1e-4, atol=1e-6).all(-1)
        assert close.mean() >= 0.995
    assert rays == rays_c


# The wavefront loop through its captured CUDA graphs (render/graph.py)
# against its eager form on the card: (scene, RenderConfig fields).
GRAPH_ROUTES = {
    "flagship": ("box", {}),
    "nee_textured": ("textured", dict(nee=True)),
    "outside_k4": ("outside", dict(cluster_size=512, stream_tile=1024,
                                   intersect="stream")),
    "outside_k5": ("outside", dict(cluster_size=512, stream_tile=1024,
                                   intersect="stream",
                                   stream_granularity="chunk")),
    "outside_k6": ("outside", dict(cluster_size=512, stream_tile=1024,
                                   intersect="stream", stream_worklist=False,
                                   nee=True)),
    "outside_k6_cap0": ("outside", dict(cluster_size=512, stream_tile=1024,
                                        intersect="stream",
                                        stream_compact=False)),
    "k7": ("box", dict(compact_worklist=False)),
    "basic": ("box", dict(use_microfacet=False, nee=True)),
    "sort_every": ("box", dict(sort_every=2)),
    "unsorted": ("box", dict(sort_rays=False)),
    "lazy_regen": ("box", dict(lazy_regen=2)),
}


def _graph_scene(kind):
    from logipathtracer_tpu_torch import RenderConfig, compile_scene
    from logipathtracer_tpu_torch.scene.procedural import (
        make_box_scene, make_outside_scene)
    if kind == "outside":
        return compile_scene(make_outside_scene(objects=8, n_materials=8,
                                                tri_budget=8000),
                             RenderConfig(cluster_size=512))
    return compile_scene(make_box_scene(spheres=2, subdiv=3,
                                        textured=kind == "textured"))


def _counts():
    """Every entry's counts, its modes copied."""
    return {(name, f): (collections.Counter(c.modes) if f == "modes"
                        else getattr(c, f))
            for name, c in COUNTS.items()
            for f in ("launches", "plain_calls", "modes")}


@pytest.mark.parametrize("route", sorted(GRAPH_ROUTES))
def test_graph_loop_bit_equal_to_eager(dev, route, monkeypatch):
    """A session (step(2), a camera move, step(1), step(3) past the seed
    buffer, the drain) through the captured stages equals the eager form
    bit for bit: the frame sums, the rays and iterations, the launch
    counters (a replay adds what its capture launched), the trace's
    iterations and host syncs by site, and no plain version; each
    iteration is one stage-A and one stage-B replay, the ladder at tile
    granularity so several windows are captured."""
    from logipathtracer_tpu_torch import ProgressiveRenderer, RenderConfig
    from logipathtracer_tpu_torch.render import wavefront
    from logipathtracer_tpu_torch.render.graph import graph_cache
    from logipathtracer_tpu_torch.utils import trace
    monkeypatch.setattr(wavefront, "REGEN_FLOOR", 1)
    monkeypatch.setattr(wavefront, "TRACE_FLOOR", 1)
    monkeypatch.setattr(wavefront, "SEED_CAPACITY", 2)
    kind, fields = GRAPH_ROUTES[route]
    host = _graph_scene(kind)
    cfg = RenderConfig(width=128, height=64, compact_tile=1024,
                       pool_size=8192, max_depth=6, **fields)
    out = []
    for eager in (True, False):
        r = ProgressiveRenderer(host, cfg, host_seed=9, device=dev)
        r._eager = eager
        before = _counts()
        t0 = trace.mark()
        iters = []
        for move, n in ((False, 2), (True, 1), (False, 3)):
            if move:
                r.rotate(1, 0.05)
            r.step(n)
            iters.append(r.last_iterations)
        frame = r._frame_sum().clone()
        iters.append(r.last_iterations)
        after = _counts()
        delta = {k: after[k] - before[k] for k in after if k in before}
        w = trace.window(t0)
        assert w["iterations"] == sum(iters) and "slots_ns" in w
        out.append((frame, r.total_rays, iters, delta,
                    w["host_syncs"]))
        if not eager:
            cache = graph_cache(r.scene)
            assert cache.replays > 0 and cache.captures > 2
            assert cache.warm_ups + cache.replays == 2 * sum(iters)
    (fe, re_, ie, de, se), (fg, rg, ig, dg, sg) = out
    assert torch.equal(fe, fg)
    assert (re_, ie) == (rg, ig)
    assert de == dg
    assert se == sg
    assert not any(v for (name, f), v in dg.items()
                   if f == "plain_calls" and COUNTS[name].kernel)


def test_graph_replays_two_stages_per_iteration(dev):
    """After the first chunk has captured its stages, a chunk of the same
    shape is replays only, two per iteration, and a moved camera and
    field of view capture nothing new."""
    from logipathtracer_tpu_torch import ProgressiveRenderer, RenderConfig
    from logipathtracer_tpu_torch.render.graph import graph_cache
    host = _graph_scene("box")
    cfg = RenderConfig(width=128, height=64, compact_tile=1024,
                       pool_size=8192, max_depth=6)
    r = ProgressiveRenderer(host, cfg, host_seed=1, device=dev)
    for _ in range(3):
        r.step(2)
    cache = graph_cache(r.scene)
    seen = (cache.captures, cache.replays)
    st = r._wf_state
    r.set_camera(r.camera_world, fov_y=r.fov_y * 0.8)
    r.step(1)
    r.step(2)
    r.step(2)
    n = r.last_iterations
    assert r._wf_state is st
    assert cache.replays - seen[1] >= 2 * n
    assert cache.captures - seen[0] <= 4


def test_stopwatch_on_the_card(dev):
    """The stopwatch's stamps, captured into the stage graphs: after
    the stages are captured, every slot of a path that runs is positive
    over a few calls (``tex`` and ``shadow`` stay 0 on this untextured
    scene without NEE) and their sum is no more than the calls' wall
    time; the stamps add no replay (two an iteration), no capture and no
    count read (one an iteration, the only ``tolist``)."""
    import time

    from logipathtracer_tpu_torch import ProgressiveRenderer, RenderConfig
    from logipathtracer_tpu_torch.render.graph import graph_cache
    from logipathtracer_tpu_torch.utils import trace
    cfg = RenderConfig(width=128, height=64, compact_tile=1024,
                       pool_size=8192, max_depth=6)
    r = ProgressiveRenderer(_graph_scene("box"), cfg, host_seed=3,
                            device=dev)
    r.step(2)
    r.radiance()
    cache = graph_cache(r.scene)
    seen = (cache.captures, cache.replays)
    reads = []
    tolist = torch.Tensor.tolist

    def counted(self):
        reads.append(self.numel())
        return tolist(self)
    torch.cuda.synchronize(dev)
    t0 = trace.mark()
    wall0 = time.perf_counter()
    torch.Tensor.tolist = counted
    try:
        for _ in range(3):
            r.step(2)
        r.radiance()
    finally:
        torch.Tensor.tolist = tolist
    wall = time.perf_counter() - wall0
    w = trace.window(t0)
    it = w["iterations"]
    assert it > 0 and w["host_syncs"]["count_read"] == it
    assert reads == [trace.WIDTH] * it
    slots = w["slots_ns"]
    assert slots["tex"] == slots["shadow"] == 0, slots
    assert all(v > 0 for k, v in slots.items()
               if k not in ("tex", "shadow")), slots
    assert sum(slots.values()) <= wall * 1e9
    assert cache.captures == seen[0]
    assert cache.replays - seen[1] == 2 * it
    got = trace.per_iteration(w)
    assert set(got["stage_ms"]) == set(trace.SLOTS)


def test_stopwatch_splits_the_shade_step_on_the_card(dev):
    """On a textured scene with NEE the shade step's stamps, captured
    with the stages, time the texture prologue (``tex``) and the shadow
    rays (``shadow``) apart from K2 and the copy-backs (``shade``); the
    window's shadow rays equal the pool's device counter after a drain,
    and the count read stays the only read (one an iteration)."""
    from logipathtracer_tpu_torch import ProgressiveRenderer, RenderConfig
    from logipathtracer_tpu_torch.utils import trace
    cfg = RenderConfig(width=128, height=64, compact_tile=1024,
                       pool_size=8192, max_depth=6, nee=True)
    r = ProgressiveRenderer(_graph_scene("textured"), cfg, host_seed=3,
                            device=dev)
    r.step(2)
    r.radiance()
    torch.cuda.synchronize(dev)
    shadow0 = int(r._wf_state["shadow_rays"])
    reads = []
    tolist = torch.Tensor.tolist

    def counted(self):
        reads.append(self.numel())
        return tolist(self)
    t0 = trace.mark()
    torch.Tensor.tolist = counted
    try:
        r.step(2)
        r.radiance()
    finally:
        torch.Tensor.tolist = tolist
    w = trace.window(t0)
    it = w["iterations"]
    assert it > 0 and reads == [trace.WIDTH] * it
    assert all(v > 0 for v in w["slots_ns"].values()), w["slots_ns"]
    shadow = int(r._wf_state["shadow_rays"])
    assert w["shadow_rays"] == shadow - shadow0 > 0


def test_shadow_clusters_replayed_equal_eager(dev):
    """On one streamed NEE pool (frustum prepass and K4 in any-hit mode)
    the shadow-cluster counter after the captured stages' replays equals
    the eager loop's, in the window and in the pool's column, beside
    equal shadow rays and host syncs by site; the count read stays the
    only read."""
    from logipathtracer_tpu_torch import ProgressiveRenderer, RenderConfig
    from logipathtracer_tpu_torch.render.graph import graph_cache
    from logipathtracer_tpu_torch.utils import trace
    cfg = RenderConfig(width=128, height=64, pool_size=8192, max_depth=6,
                       nee=True, cluster_size=512, stream_tile=1024,
                       intersect="stream")
    host = _graph_scene("outside")
    out = []
    for eager in (True, False):
        r = ProgressiveRenderer(host, cfg, host_seed=5, device=dev)
        r._eager = eager
        before = COUNTS["stream_cluster"].modes["any_hit"]
        t0 = trace.mark()
        r.step(3)
        r.radiance()
        w = trace.window(t0)
        assert COUNTS["stream_cluster"].modes["any_hit"] > before
        out.append((w["shadow_clusters"],
                    int(r._wf_state["shadow_clusters"]), w["shadow_rays"],
                    w["host_syncs"], w["iterations"]))
        if not eager:
            assert graph_cache(r.scene).replays > 0
    assert out[0] == out[1]
    assert out[0][0] == out[0][1] > 0


def test_graph_cache_freed_with_its_renderer(dev):
    """A renderer's scene copy, its graph cache, pool and graphs go when
    the renderer goes, without a garbage collection (no reference
    cycle holds the graphs' memory)."""
    import gc
    import weakref

    from logipathtracer_tpu_torch import ProgressiveRenderer, RenderConfig
    from logipathtracer_tpu_torch.render.graph import graph_cache
    r = ProgressiveRenderer(_graph_scene("box"),
                            RenderConfig(width=128, height=64,
                                         compact_tile=1024, pool_size=8192),
                            host_seed=1, device=dev)
    r.step(2)
    r.radiance()
    refs = (weakref.ref(r.scene), weakref.ref(graph_cache(r.scene)),
            weakref.ref(r._wf_state["accum"]))
    gc.disable()
    try:
        del r
        assert all(ref() is None for ref in refs)
    finally:
        gc.enable()


def test_graph_capture_failure_raises(dev, monkeypatch):
    """A stage that reads the host cannot be captured: the capture raises
    and nothing runs the eager loop in its place."""
    from logipathtracer_tpu_torch import ProgressiveRenderer, RenderConfig
    from logipathtracer_tpu_torch.render import wavefront
    stage_a = wavefront._Body.stage_a

    def reading(self, mode):
        stage_a(self, mode)
        self.st["alive"].sum().item()
    monkeypatch.setattr(wavefront._Body, "stage_a", reading)
    r = ProgressiveRenderer(_graph_scene("box"),
                            RenderConfig(width=64, height=64,
                                         compact_tile=1024, pool_size=4096),
                            host_seed=1, device=dev)
    with pytest.raises(RuntimeError):
        r.step(1)
