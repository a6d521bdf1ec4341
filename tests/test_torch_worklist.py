"""The worklist prepass of kernel K1 (``build_chunk_worklists`` in
logipathtracer_tpu_torch/ops/kernels/compact_intersect.py) and K1's tie
rules, on the CPU.

- The plain version, whose tile mean direction is a fixed pairwise tree
  (the worklist kernel's order), against the JAX package's XLA prepass:
  ``wn`` exact and the same order per tile, with and without t_max, on
  parked tiles and axis-aligned directions.  The order may differ from
  JAX's only where two keys tie to the last ulps (JAX sums the mean in
  its own order).
- The same plain version against its earlier ``.mean`` form: the same
  order except on such ties.
- A crafted scene with one triangle in several slots of two clusters:
  the plain K1 and the JAX interpret kernel keep the lowest slot and the
  earlier-visited cluster, in closest-hit and in any-hit mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from logipathtracer_tpu.ops.pallas import compact_intersect as jci
from logipathtracer_tpu.scene.compile import compile_scene
from logipathtracer_tpu.scene.procedural import make_box_scene
from logipathtracer_tpu_torch.ops import traverse as ttrav
from logipathtracer_tpu_torch.ops.kernels import compact_intersect as tci
from logipathtracer_tpu_torch.scene.types import SceneSoA

TILE = 256


@pytest.fixture(scope="module")
def bounds():
    """The box scene's per-cluster world AABBs, as the port computes
    them; both prepasses are fed these very floats."""
    jscene = compile_scene(make_box_scene(spheres=2, subdiv=3),
                           use_native=False)
    return ttrav.scene_cluster_bounds(SceneSoA.from_numpy(jscene).to("cpu"))


def _rays(kind, n, seed):
    r = np.random.default_rng(seed)
    o = r.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if kind == "axis":
        axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
        d = axes[r.integers(0, 6, n)]
    if kind == "parked":            # whole tiles and a part tile parked
        o[n // 2 + 100:] = 1e30
        d[n // 2 + 100:] = 1.0
    if kind == "camera":            # coherent tiles: a narrow cone
        d = np.array([0.2, -0.1, -1.0]) + 0.15 * r.normal(size=(n, 3))
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
            np.float32)
    t_max = r.uniform(0.05, 4.0, n).astype(np.float32)
    return o, d, t_max


@pytest.mark.parametrize("has_tmax", [False, True])
@pytest.mark.parametrize("kind", ["random", "parked", "axis"])
def test_plain_worklist_matches_jax(bounds, kind, has_tmax):
    o, d, t_max = _rays(kind, 1200, seed=3)
    rays8, _ = tci.pack_rays8(torch.from_numpy(o), torch.from_numpy(d), TILE,
                              t_max=torch.from_numpy(t_max) if has_tmax
                              else None)
    before = tci.prepass_plain_calls
    launched = tci.prepass_launches
    wl, wn = tci.build_chunk_worklists(*bounds, rays8, TILE,
                                       has_tmax=has_tmax)
    assert tci.prepass_plain_calls == before + 1
    assert tci.prepass_launches == launched
    wlj, wnj = jci.build_chunk_worklists(
        *(jnp.asarray(b.numpy()) for b in bounds), jnp.asarray(rays8.numpy()),
        TILE, has_tmax=has_tmax)
    np.testing.assert_array_equal(wn.numpy(), np.asarray(wnj))
    assert_order_but_ties(wl, torch.from_numpy(np.array(wlj)), wn, bounds,
                          rays8, TILE)
    assert int(wn.max()) > 0
    if kind == "parked":
        assert (wn[-2:] == 0).all() and int(wn[2]) > 0   # the part tile


def assert_order_but_ties(wl, wl_ref, wn, bounds, rays8, tile):
    """wl equals wl_ref on each tile's first wn entries, entry by entry,
    except where the two entries' keys (the tile mean direction dotted
    with the centroid) lie within a few ulps of the terms they are
    summed from: such keys tie, and another summation order of the mean
    may swap them.  Returns the number of tiles equal throughout."""
    bmin, bmax = bounds
    md = tci.tile_mean_dir(rays8, tile).T.double()          # [T, 3]
    cen = (0.5 * (bmin + bmax)).double()                     # [C, 3]
    key = md @ cen.T
    scale = md.abs() @ cen.abs().T                           # sum of |terms|
    same = 0
    for i, n in enumerate(wn.tolist()):
        a, b = wl[i, :n].tolist(), wl_ref[i, :n].tolist()
        assert sorted(a) == sorted(b), i
        if a == b:
            same += 1
            continue
        for x, y in zip(a, b):
            if x != y:          # swapped: their keys tie to a few ulps
                tol = 8 * 2.0 ** -24 * float(max(scale[i, x], scale[i, y]))
                assert abs(float(key[i, x] - key[i, y])) <= tol, (i, x, y)
    return same


def _mean_order(fired, bmin, bmax, rays8, tile):
    """The earlier form of the plain ordering: the mean by ``.mean``."""
    tiles = rays8.shape[1] // tile
    centroid = 0.5 * (bmin + bmax)
    md = rays8[3:6].reshape(3, tiles, tile).mean(dim=2)
    key = (md[0][:, None] * centroid[:, 0][None]
           + md[1][:, None] * centroid[:, 1][None]
           + md[2][:, None] * centroid[:, 2][None])
    key = torch.where(fired, key, float("inf"))
    return torch.argsort(key, dim=1, stable=True).to(torch.int32)


@pytest.mark.parametrize("tile", [256, 384, 4096])
def test_tree_mean_order_matches_mean_form(bounds, tile):
    """The fixed-tree order against the ``.mean`` order on coherent and
    random tiles: the same except where two fired keys lie within a few
    ulps of the terms they are summed from."""
    bmin, bmax = bounds
    o, d, _ = _rays("camera", 4 * 4096, seed=5)
    o2, d2, _ = _rays("random", 4 * 4096, seed=6)
    rays8, _ = tci.pack_rays8(torch.from_numpy(np.concatenate([o, o2])),
                              torch.from_numpy(np.concatenate([d, d2])), tile)
    fired = tci.fired_chunks(bmin, bmax, rays8, tile)
    wl, wn = tci._order_fired(fired, bmin, bmax, rays8, tile)
    wl_mean = _mean_order(fired, bmin, bmax, rays8, tile)
    np.testing.assert_array_equal(wn.numpy(), fired.sum(1).numpy())
    same = assert_order_but_ties(wl, wl_mean, wn, bounds, rays8, tile)
    assert same >= 0.9 * wn.shape[0]

def tie_case(two_clusters: bool, s: int = 128):
    """One triangle T (the z = 2 plane patch) in slots 5, 9 and 37 of
    cluster 0 (slot 37 shares lane 5 of a 32-lane stride) and, with
    ``two_clusters``, in slot 2 of cluster 1, whose box lies nearer along
    +z so the worklist visits it first; every other slot holds a
    triangle far off.  One object, identity transforms.  Returns numpy
    (cl_meta, cl_inv, cl_order, cl_aabb, cl_tris, obj_world)."""
    tris = np.zeros((2, 9, s), np.float32)
    tris[:, 0:3] = 50.0                                 # far off
    tris[:, 3] = 1.0
    tris[:, 7] = 1.0
    t_tri = np.array([-1, -1, 2, 2, 0, 0, 0, 2, 0], np.float32)
    for slot in (5, 9, 37):
        tris[0, :, slot] = t_tri
    if two_clusters:
        tris[1, :, 2] = t_tri
    meta = np.array([[0, 0], [0, s]], np.int32)
    inv = np.array([[1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0]], np.float32)
    aabb = np.array([[-1, -1, 1.9, 1, 1, 2.1, 0, 0],
                     [-1, -1, 1.8, 1, 1, 2.05, 0, 0]], np.float32)
    order = np.tile(np.arange(2, dtype=np.int32), (8, 1))
    world = np.eye(4, dtype=np.float32)[None]
    return meta, inv, order, aabb, tris, world


def tie_rays(n: int = 256):
    """Rays straight up +z from under T; t_max 3 (T blocks them)."""
    r = np.random.default_rng(9)
    o = np.zeros((n, 3), np.float32)
    o[:, :2] = r.uniform(-0.8, -0.1, (n, 2))     # inside T: x + y < 0
    d = np.tile(np.array([0, 0, 1], np.float32), (n, 1))
    return o, d, np.full(n, 3.0, np.float32)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("two_clusters", [False, True])
def test_k1_ties_keep_lowest_slot_and_earlier_cluster(two_clusters,
                                                      any_hit):
    meta, inv, order, aabb, tris, world = tie_case(two_clusters)
    o, d, t_max = tie_rays()
    tile = 128
    rays8, _ = tci.pack_rays8(torch.from_numpy(o), torch.from_numpy(d), tile,
                              t_max=torch.from_numpy(t_max) if any_hit
                              else None)
    g = torch.from_numpy
    bmin, bmax = tci.chunk_world_bounds(g(meta), g(aabb), g(world), 2, 2, 1)
    wl, wn = tci.build_chunk_worklists(bmin, bmax, rays8, tile,
                                       has_tmax=any_hit)
    assert wn.tolist() == [2, 2]
    assert wl[:, 0].tolist() == [1, 1]              # the nearer box first
    t, tri, obj = tci.compact_wl_intersect(
        rays8, wl, wn, g(meta), g(inv), g(aabb), g(tris), tile, 1e-4,
        has_tmax=any_hit, any_hit=any_hit)
    want = 128 + 2 if two_clusters else 5
    assert (obj == 0).all()
    if any_hit:
        assert (t == np.float32(-tci.BIG)).all()
    else:
        assert (tri == want).all() and (t == 2.0).all()
    tj, trj, oj = jci.cluster_intersect_compact(
        jnp.asarray(meta), jnp.asarray(inv), jnp.asarray(order),
        jnp.asarray(aabb), jnp.asarray(tris), jnp.asarray(rays8.numpy()),
        tile=tile, eps=1e-4, interpret=True, has_tmax=any_hit,
        worklist=True, obj_world=jnp.asarray(world), any_hit=any_hit)
    np.testing.assert_array_equal(t.numpy(), np.asarray(tj))
    if not any_hit:
        np.testing.assert_array_equal(tri.numpy(), np.asarray(trj))
        np.testing.assert_array_equal(obj.numpy(), np.asarray(oj))


def test_worklist_wrapper_rejects_other_devices(bounds):
    rays8 = torch.zeros((8, TILE), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tci.build_chunk_worklists(bounds[0].to("meta"), bounds[1].to("meta"),
                                  rays8, TILE)
