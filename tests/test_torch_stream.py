"""The plain versions of the streamed-scene kernels K4, K5 and K6
(logipathtracer_tpu_torch/ops/kernels/stream_cluster.py,
compact_intersect.py, cluster_intersect.py) against the JAX package's
streamed sweep in interpret mode (``intersect_scene_stream(backend=
"interpret")``, the JAX package's own CPU twin of its worklist stream
kernels), on a small outside-class scene: ``make_outside_scene(objects=8,
n_materials=8, tri_budget=8000)`` compiled at cluster_size 512 (113
clusters, 8 chunks of 16).

K4, K5 and K6 at cap 32 hold K1's per-ray contract and are compared
with the JAX kernel at cap 32; K6 at cap 0 with the JAX kernel at cap 0.
Tolerances: ``hits_agree`` (tests/test_compact.py:35-43: t within rtol
2e-6 / atol 1e-6, tri/obj differing only on t ties); shadow queries must
give the same visibility t < t_max on every lane.  The cap 0 body's own
contract (best t from INF or the unclamped t_max, the triangle test per
128-ray sub-tile, any_hit ignored) is held against the JAX kernel on a
scene built to show each rule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from logipathtracer_tpu.config import RenderConfig as JaxConfig
from logipathtracer_tpu.ops.camera import generate_ray as jax_generate_ray
from logipathtracer_tpu.ops.pallas.cluster_intersect import \
    cluster_intersect_stream as jax_stream
from logipathtracer_tpu.ops.rng import seed_from_pixel as jax_seed
from logipathtracer_tpu.ops.traverse import intersect_scene_stream
from logipathtracer_tpu.scene.compile import compile_scene
from logipathtracer_tpu.scene.procedural import make_outside_scene
from logipathtracer_tpu_torch.ops import traverse as ttrav
from logipathtracer_tpu_torch.ops.kernels import cluster_intersect as tk6
from logipathtracer_tpu_torch.ops.kernels import compact_intersect as tci
from logipathtracer_tpu_torch.ops.kernels._build import COUNTS
from logipathtracer_tpu_torch.scene.types import SceneSoA

TILE = 512
N = 1024


@pytest.fixture(scope="module")
def scenes():
    jscene = compile_scene(
        make_outside_scene(objects=8, n_materials=8, tri_budget=8000),
        JaxConfig(cluster_size=512), use_native=False)
    assert jscene.cl_tris.shape == (113, 9, 512) and jscene.num_lights > 0
    return jscene, SceneSoA.from_numpy(jscene).to("cpu")


def _random_rays(seed):
    r = np.random.default_rng(seed)
    o = np.stack([r.uniform(-30, 30, N), r.uniform(0.5, 6.0, N),
                  r.uniform(-30, 30, N)], 1).astype(np.float32)
    d = r.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _camera_rays(jscene):
    cam = jscene.cameras[0]
    ys, xs = np.meshgrid(np.arange(32, dtype=np.float32),
                         np.arange(32, dtype=np.float32), indexing="ij")
    pix = jnp.asarray(np.stack([xs, ys], -1).reshape(-1, 2))
    seed = jax_seed(jnp.asarray([48271, 16807], jnp.uint32), pix)
    o, d, _ = jax_generate_ray(jnp.asarray(cam.world_matrix),
                               jnp.float32(cam.yfov), pix, (32, 32), seed)
    return np.array(o), np.array(d)


def _parked(jscene):
    """Camera rays with a parked tail: a part-parked tile, then a tile
    whose every lane is parked (K6's dead-tile flag)."""
    o, d = _camera_rays(jscene)
    o[400:] = 1e30
    d[400:] = 1.0
    return o, d


POOLS = {"random": lambda js: _random_rays(0), "camera": _camera_rays,
         "parked": _parked}


@pytest.fixture(scope="module")
def jax_hits(scenes):
    """The JAX interpret kernel's answers, per pool and cap."""
    jscene, _ = scenes
    out = {}
    for kind, make in POOLS.items():
        o, d = make(jscene)
        for cap in (32, 0):
            t, obj, tri = intersect_scene_stream(
                jscene, jnp.asarray(o), jnp.asarray(d), tile=TILE,
                backend="interpret", cap=cap)
            out[kind, cap] = (o, d, (np.asarray(t), np.asarray(tri),
                                     np.asarray(obj)))
    return out


def _port(kernel, tscene, o, d, **kw):
    """(t, tri, obj) of one port entry point; checks it took the plain
    version once and launched no kernel."""
    name, fn, extra = {
        "k4": ("stream_cluster", ttrav.intersect_scene_cluster_wl, {}),
        "k5": ("worklist_chunk", ttrav.intersect_scene_worklist, {}),
        "k6": ("octant_chunk", ttrav.intersect_scene_stream, dict(cap=32)),
        "k6_cap0": ("octant_chunk", ttrav.intersect_scene_stream,
                    dict(cap=0)),
    }[kernel]
    before = COUNTS[name].plain_calls
    t, obj, tri = fn(tscene, torch.from_numpy(o), torch.from_numpy(d),
                     tile=TILE, **extra, **kw)
    assert COUNTS[name].plain_calls == before + 1
    assert all(COUNTS[k].launches == 0 for k in (
        "stream_cluster", "worklist_chunk", "octant_chunk"))
    return t.numpy(), tri.numpy(), obj.numpy()


@pytest.mark.parametrize("kernel", ["k4", "k5", "k6", "k6_cap0"])
@pytest.mark.parametrize("kind", sorted(POOLS))
def test_plain_stream_kernels_match_jax(scenes, jax_hits, kind, kernel):
    _, tscene = scenes
    o, d, ref = jax_hits[kind, 0 if kernel == "k6_cap0" else 32]
    got = _port(kernel, tscene, o, d)
    tci.hits_agree(ref, got)
    assert (got[1] >= 0).mean() > 0.2        # the rays hit something
    if kind == "parked":
        assert (got[1][400:] == -1).all() and (got[0][400:] >= 3e38).all()


def _shadow_rays(jscene, seed=5):
    """Shadow queries toward random points on the emissive triangles,
    t_max just short of them; a quarter of the lanes carry the parked
    query of a lane without a light sample."""
    r = np.random.default_rng(seed)
    o = np.stack([r.uniform(-30, 30, N), r.uniform(0.2, 8.0, N),
                  r.uniform(-30, 30, N)], 1).astype(np.float32)
    lt = np.asarray(jscene.light_tris)
    row = lt[r.integers(0, lt.shape[0], N)]
    su = np.sqrt(r.random(N)).astype(np.float32)[:, None]
    b = r.random(N).astype(np.float32)[:, None]
    lp = row[:, 0:3] + (1 - su) * row[:, 3:6] + b * su * row[:, 6:9]
    dist = np.linalg.norm(lp - o, axis=-1).astype(np.float32)
    d = ((lp - o) / dist[:, None]).astype(np.float32)
    t_max = (dist * np.float32(0.999)).astype(np.float32)
    o[3 * N // 4:] = 1e30
    d[3 * N // 4:] = (0.0, 0.0, 1.0)
    t_max[3 * N // 4:] = 1.0
    return o, d, t_max


@pytest.fixture(scope="module")
def jax_shadow(scenes):
    jscene, _ = scenes
    o, d, t_max = _shadow_rays(jscene)
    out = {}
    for cap in (32, 0):
        t, obj, tri = intersect_scene_stream(
            jscene, jnp.asarray(o), jnp.asarray(d), tile=TILE,
            backend="interpret", cap=cap, t_max=jnp.asarray(t_max),
            any_hit=True)
        out[cap] = (np.asarray(t), np.asarray(tri), np.asarray(obj))
    return (o, d, t_max), out


@pytest.mark.parametrize("kernel", ["k4", "k5", "k6", "k6_cap0"])
def test_plain_stream_shadow_visibility(scenes, jax_shadow, kernel):
    """t_max + any_hit: the same visibility as the JAX kernel on every
    lane; blocked lanes parked at -BIG where the contract parks them."""
    _, tscene = scenes
    (o, d, t_max), ref = jax_shadow
    cap = 0 if kernel == "k6_cap0" else 32
    got = _port(kernel, tscene, o, d, t_max=torch.from_numpy(t_max),
                any_hit=True)
    blocked = got[0] < t_max
    np.testing.assert_array_equal(blocked, ref[cap][0] < t_max)
    assert 0.02 < blocked[:3 * N // 4].mean() < 0.98
    assert not blocked[3 * N // 4:].any()
    if cap:
        assert (got[0][blocked] == np.float32(-tci.BIG)).all()
    else:
        # any_hit is ignored by the cap 0 body: blocked lanes carry their
        # closest hit, the JAX kernel's triangle up to t ties.
        assert (got[0][blocked] > 0).all() and (got[1][blocked] >= 0).all()
        same = got[1] == ref[0][1]
        assert same.mean() > 0.99


def _sheet_scene():
    """One object, three clusters of 4 slots: a 20 x 20 sheet at z = 5
    (two triangles) whose cluster AABB is cut to x <= 0 — as if it held
    only the sheet's left half — and two empty clusters."""
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
    world = np.eye(4, dtype=np.float32)[None]
    return meta, inv, aabb, tris, world


def _sheet_rays():
    """Two 128-ray sub-tiles looking up +z: the first mixes rays inside
    (x < 0) and outside (x > 0) the cut AABB, the second has only rays
    outside.  Every 8th ray's direction is scaled to 1e-31, so its hit
    lies at t ~ 5e31, beyond the 1e30 sentinel of K1's contract."""
    r = np.random.default_rng(7)
    n = 256
    o = np.zeros((n, 3), np.float32)
    o[:128, 0] = r.uniform(-9, 9, 128)
    o[128:, 0] = r.uniform(0.5, 9, 128)
    o[:, 1] = r.uniform(-9, 9, n)
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = 1.0
    d[::8, 2] = 1e-31
    rays8 = np.zeros((8, n), np.float32)
    rays8[0:3] = o.T
    rays8[3:6] = d.T
    rays8[6] = 1e35
    return rays8


@pytest.mark.parametrize("has_tmax", [False, True])
def test_cap0_body_contract(has_tmax):
    """K6's cap 0 body against the JAX kernel, rule by rule."""
    meta, inv, aabb, tris, world = _sheet_scene()
    rays8 = _sheet_rays()
    args = (meta, inv, aabb, tris, world, rays8)
    kw = dict(tile=256, chunk=2, eps=1e-4, has_tmax=has_tmax)
    outs = {}
    for cap in (0, 32):
        ref = jax_stream(*(jnp.asarray(a) for a in args), interpret=True,
                         cap=cap, **kw)
        got = tk6.cluster_intersect_stream(
            *(torch.from_numpy(a) for a in args), cap=cap, **kw)
        outs[cap] = [x.numpy() for x in got]
        tci.hits_agree([np.asarray(x) for x in ref], outs[cap])
    t0, tri0 = outs[0][0], outs[0][1]
    far = np.zeros(256, bool)
    far[::8] = True
    # The triangle test runs for every ray of a sub-tile with a slab
    # pass: the first sub-tile's rays outside the cut AABB hit the sheet
    # too; the second sub-tile, with no pass, hits nothing.
    assert (tri0[:128] >= 0).all() and (tri0[128:] == -1).all()
    # Best t starts at INF (or the unclamped t_max 1e35): the hits far
    # beyond 1e30 count.
    assert (t0[:128][far[:128]] > 1e31).all()
    np.testing.assert_allclose(t0[:128][~far[:128]], 5.0, rtol=1e-5)
    # K1's contract (cap 32): only the rays inside the cut AABB, and no
    # hit at or beyond 1e30.
    inside = rays8[0] <= 0.0
    assert inside[:128].any() and not inside[:128].all()
    assert ((outs[32][1] >= 0) == (inside & ~far)).all()
    # any_hit is ignored by the cap 0 body.
    got = tk6.cluster_intersect_stream(*(torch.from_numpy(a) for a in args),
                                       cap=0, any_hit=True, **kw)
    for a, b in zip(got, outs[0]):
        np.testing.assert_array_equal(a.numpy(), b)
