"""The plain versions of the resident sweeps without worklists — kernel K7
(``compact_intersect.compact_order_intersect``) and kernel K8
(``cluster_intersect.dense_sweep_intersect``) — and the port of the jnp
twin against the JAX package on the CPU: K7 against
``cluster_intersect_compact(worklist=False, interpret=True)``, K8 against
``cluster_intersect_pallas(interpret=True)`` and ``cluster_intersect_jnp``,
on ``make_box_scene(spheres=2, subdiv=3)`` compiled by both packages,
with random, camera and axis-aligned rays and a pool whose second tile
starts with parked lanes (its octant comes from a parked ray).

Tolerance: ``hits_agree`` (tests/test_compact.py:35-43: t within rtol
2e-6 / atol 1e-6; tri/obj differ only on t ties), like with like (K7
with the JAX compact kernel, K8 with the JAX sweep kernel: the visit
orders differ between routes, so coplanar ties may too).  Shadow queries
must give the same visibility t < t_max on every lane.  K8's own rules
(best t from INF or the unclamped t_max, the triangle test per 128-ray
sub-tile, t unmasked without t_max) are held against the JAX kernel on a
sheet whose cluster box was cut in half."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from logipathtracer_tpu.ops.camera import generate_ray as jax_generate_ray
from logipathtracer_tpu.ops.pallas.cluster_intersect import \
    cluster_intersect_pallas as jax_pallas
from logipathtracer_tpu.ops.rng import seed_from_pixel as jax_seed
from logipathtracer_tpu.ops.traverse import intersect_scene_sweep
from logipathtracer_tpu.scene.compile import compile_scene as jax_compile
from logipathtracer_tpu.scene.procedural import make_box_scene as jax_box
from logipathtracer_tpu_torch.ops import traverse as ttrav
from logipathtracer_tpu_torch.ops.kernels import cluster_intersect as tk8
from logipathtracer_tpu_torch.ops.kernels import compact_intersect as tci
from logipathtracer_tpu_torch.ops.kernels._build import COUNTS
from logipathtracer_tpu_torch.scene.compile import compile_scene
from logipathtracer_tpu_torch.scene.procedural import make_box_scene

TILE = 256


@pytest.fixture(scope="module")
def scenes():
    jscene = jax_compile(jax_box(spheres=2, subdiv=3), use_native=False)
    tscene = compile_scene(make_box_scene(spheres=2, subdiv=3),
                           use_native=False).to("cpu")
    np.testing.assert_array_equal(tscene.cl_order.numpy(), jscene.cl_order)
    np.testing.assert_array_equal(tscene.cl_tris.numpy(), jscene.cl_tris)
    return jscene, tscene


def _random_rays(n, seed):
    r = np.random.default_rng(seed)
    o = r.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _camera_rays(jscene, n=768):
    cam = jscene.cameras[0]
    ys, xs = np.meshgrid(np.arange(32, dtype=np.float32),
                         np.arange(32, dtype=np.float32), indexing="ij")
    pix = jnp.asarray(np.stack([xs, ys], -1).reshape(-1, 2)[:n])
    seed = jax_seed(jnp.asarray([48271, 16807], jnp.uint32), pix)
    o, d, _ = jax_generate_ray(jnp.asarray(cam.world_matrix),
                               jnp.float32(cam.yfov), pix, (32, 32), seed)
    return np.array(o), np.array(d)


def _parked_front(n, seed):
    """Random rays whose second tile starts with 40 lanes parked as the
    megakernel parks dead lanes (origin 1e30, direction (1, 1, 1)), and
    whose last tile is parked whole."""
    o, d = _random_rays(n, seed)
    o[TILE:TILE + 40] = 1e30
    d[TILE:TILE + 40] = 1.0
    o[n - TILE:] = 1e30
    d[n - TILE:] = 1.0
    return o, d


def _axis_rays(n, seed):
    o, _ = _random_rays(n, seed)
    axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    return o, axes[np.random.default_rng(seed).integers(0, 6, n)]


RAYS = {
    "axis": lambda js: _axis_rays(512, 4),
    "camera": _camera_rays,
    "parked": lambda js: _parked_front(768, 1),
    "random": lambda js: _random_rays(512, 0),
}

# (JAX backend, port backend, the kernel whose plain calls it counts)
ROUTES = {
    "k7": ("compact_interpret", dict(backend="compact", worklist=False),
           "compact_order"),
    "k8": ("interpret", dict(backend="pallas"), "dense_sweep"),
    "jnp": ("jnp", dict(backend="jnp"), None),
}


def _port(tscene, route, o, d, **kw):
    _, port_kw, name = ROUTES[route]
    before = COUNTS[name].plain_calls if name else 0
    t, obj, tri = ttrav.intersect_scene_sweep(
        tscene, torch.from_numpy(o), torch.from_numpy(d), tile=TILE,
        **port_kw, **kw)
    if name:
        assert COUNTS[name].plain_calls == before + 1
    assert (COUNTS["compact_order"].launches,
            COUNTS["dense_sweep"].launches) == (0, 0)
    return t.numpy(), tri.numpy(), obj.numpy()


def _jax(jscene, route, o, d, **kw):
    t, obj, tri = intersect_scene_sweep(
        jscene, jnp.asarray(o), jnp.asarray(d), tile=TILE,
        backend=ROUTES[route][0], **kw)
    return np.asarray(t), np.asarray(tri), np.asarray(obj)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("kind", sorted(RAYS))
def test_plain_sweeps_match_jax(scenes, kind, route):
    jscene, tscene = scenes
    o, d = RAYS[kind](jscene)
    got = _port(tscene, route, o, d)
    tci.hits_agree(_jax(jscene, route, o, d), got)
    assert (got[1] >= 0).mean() > 0.2            # the rays hit something
    if kind == "parked":
        park = o[:, 0] > 1e29
        assert (got[1][park] == -1).all() and (got[0][park] >= 3e38).all()


def test_plain_k8_matches_jax_jnp_twin(scenes):
    """K8's closest hits are the dense twin's (every ray against every
    triangle), up to t ties."""
    jscene, tscene = scenes
    o, d = _camera_rays(jscene)
    tci.hits_agree(_jax(jscene, "jnp", o, d), _port(tscene, "k8", o, d))


def _shadow_rays(jscene, n=768, seed=0):
    """Shadow queries toward random points on the light from random points
    in the box and above its ceiling; a quarter of the lanes carry the
    parked query of a lane without a light sample."""
    r = np.random.default_rng(seed)
    o = r.uniform(-1.9, 1.9, (n, 3)).astype(np.float32)
    o[:, 1] = r.uniform(-1.9, 2.8, n)
    lt = np.asarray(jscene.light_tris)
    row = lt[r.integers(0, lt.shape[0], n)]
    su = np.sqrt(r.random(n)).astype(np.float32)[:, None]
    b = r.random(n).astype(np.float32)[:, None]
    lp = row[:, 0:3] + (1 - su) * row[:, 3:6] + b * su * row[:, 6:9]
    dist = np.linalg.norm(lp - o, axis=-1).astype(np.float32)
    d = ((lp - o) / dist[:, None]).astype(np.float32)
    t_max = (dist * np.float32(0.999)).astype(np.float32)
    o[3 * n // 4:] = 1e30
    d[3 * n // 4:] = (0.0, 0.0, 1.0)
    t_max[3 * n // 4:] = 1.0
    return o, d, t_max


@pytest.mark.parametrize("route,any_hit", [("k7", False), ("k7", True),
                                           ("k8", False), ("jnp", False)])
def test_plain_sweeps_tmax_match_jax(scenes, route, any_hit):
    jscene, tscene = scenes
    o, d, t_max = _shadow_rays(jscene)
    ref = _jax(jscene, route, o, d, t_max=jnp.asarray(t_max),
               any_hit=any_hit)
    got = _port(tscene, route, o, d, t_max=torch.from_numpy(t_max),
                any_hit=any_hit)
    blocked = got[0] < t_max
    np.testing.assert_array_equal(blocked, ref[0] < t_max)
    assert 0.02 < blocked[:576].mean() < 0.98      # both outcomes occur
    assert not blocked[576:].any()
    if any_hit:
        # Blocked lanes are parked at -BIG in both packages.
        np.testing.assert_array_equal(got[0][blocked], ref[0][blocked])
        assert (got[0][blocked] == np.float32(-tci.BIG)).all()
    else:
        tci.hits_agree(ref, got)
        assert (got[0][~blocked] >= 3e38).all()   # no hit before t_max: INF


def _sheet_scene():
    """One object, three clusters of 4 slots: a 20 x 20 sheet at z = 5
    (two triangles) whose cluster AABB is cut to x <= 0 — as if it held
    only the sheet's left half — and two empty clusters; every octant
    visits them in index order."""
    s = 4
    tris = np.zeros((3, 9, s), np.float32)
    v = np.array([[[-10, -10, 5], [10, -10, 5], [10, 10, 5]],
                  [[-10, -10, 5], [10, 10, 5], [-10, 10, 5]]], np.float32)
    for k in range(2):
        tris[0, 0:3, k] = v[k, 0]
        tris[0, 3:6, k] = v[k, 1] - v[k, 0]
        tris[0, 6:9, k] = v[k, 2] - v[k, 0]
    tris[0, :, 2:] = tris[0, :, 0:1]        # padded slots repeat slot 0
    tris[1:] = tris[0:1, :, 0:1]
    aabb = np.zeros((3, 8), np.float32)
    aabb[:, 0:6] = (-10, -10, 4.9, 0, 10, 5.1)
    meta = np.array([[0, 0], [0, s], [0, 2 * s]], np.int32)
    inv = np.eye(4, dtype=np.float32)[:3].reshape(1, 12)
    order = np.tile(np.arange(3, dtype=np.int32), (8, 1))
    return meta, inv, order, aabb, tris


def _sheet_rays():
    """Two 128-ray sub-tiles looking up +z: the first mixes rays inside
    (x < 0) and outside (x > 0) the cut AABB, the second has only rays
    outside.  Every 8th ray's direction is scaled to 1e-31, so its hit
    lies at t ~ 5e31, beyond the 1e30 sentinel of K1's contract."""
    r = np.random.default_rng(7)
    n = 256
    rays8 = np.zeros((8, n), np.float32)
    rays8[0, :128] = r.uniform(-9, 9, 128)
    rays8[0, 128:] = r.uniform(0.5, 9, 128)
    rays8[1] = r.uniform(-9, 9, n)
    rays8[5] = 1.0
    rays8[5, ::8] = 1e-31
    rays8[6] = 1e35
    return rays8


@pytest.mark.parametrize("has_tmax", [False, True])
def test_k8_subtile_contract(has_tmax):
    """K8's rules against the JAX kernel, one by one, on the cut sheet;
    K7 (K1's contract) on the same sheet for contrast."""
    meta, inv, order, aabb, tris = _sheet_scene()
    rays8 = _sheet_rays()
    ref = jax_pallas(*(jnp.asarray(a) for a in (meta, inv, order, aabb,
                                                tris, rays8)),
                     tile=256, interpret=True, has_tmax=has_tmax)
    tt = [torch.from_numpy(a) for a in (meta, inv, order, aabb, tris, rays8)]
    got = [x.numpy() for x in tk8.cluster_intersect_pallas(
        *tt, tile=256, has_tmax=has_tmax)]
    tci.hits_agree([np.asarray(x) for x in ref], got)
    t8, tri8 = got[0], got[1]
    far = np.zeros(256, bool)
    far[::8] = True
    # Every ray of a sub-tile with a slab pass runs the triangle test: the
    # first sub-tile's rays outside the cut AABB hit the sheet too; the
    # second sub-tile, with no pass, hits nothing.
    assert (tri8[:128] >= 0).all() and (tri8[128:] == -1).all()
    # Best t starts at INF (or the unclamped t_max 1e35): hits far beyond
    # 1e30 count.
    assert (t8[:128][far[:128]] > 1e31).all()
    np.testing.assert_allclose(t8[:128][~far[:128]], 5.0, rtol=1e-5)
    assert (t8[128:] >= 3e38).all()          # a miss is INF either way
    # K7: only the rays inside the cut AABB, and no hit at or beyond 1e30.
    m, i, o, a, tr, r8 = tt
    k7 = tci.compact_order_intersect(r8, tci.tile_octants(r8, 256), o, m, i,
                                     a, tr, 256, 1e-4, has_tmax=has_tmax)
    inside = rays8[0] <= 0.0
    assert inside[:128].any() and not inside[:128].all()
    assert ((k7[1].numpy() >= 0) == (inside & ~far)).all()


def test_tile_octant_from_first_ray():
    """The octant belongs to the tile and comes from its first ray: a
    parked lane (1, 1, 1) gives 7, a pad ray (0, 0, 1) gives 1."""
    o = torch.zeros((300, 3))
    d = torch.tensor([-1.0, -1.0, -1.0]).expand(300, 3).clone()
    o[256:260] = 1e30
    d[256:260] = 1.0
    rays8, r = tci.pack_rays8(o, d, 128)
    assert r == 300 and rays8.shape[1] == 384
    assert tci.tile_octants(rays8, 128).tolist() == [0, 0, 7]
    pad8 = torch.zeros((8, 256))
    pad8[5] = 1.0                            # pack_rays8's pad direction
    assert tci.tile_octants(pad8, 128).tolist() == [1, 1]
