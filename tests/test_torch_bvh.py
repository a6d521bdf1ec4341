"""The port's BVH stack walk (``ops/traverse.py::intersect_scene``) and
brute-force oracle (``intersect_bruteforce``) against the JAX package's,
on ``make_box_scene(spheres=2, subdiv=3)`` compiled by both packages,
with random, camera, axis-aligned and parked rays, with and without
``t_max``.  Tolerance: ``hits_agree`` (t within rtol 2e-6 / atol 1e-6;
tri/obj differ only on t ties); with ``t_max`` the same visibility
t < t_max on every lane."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from logipathtracer_tpu.ops import traverse as jtrav
from logipathtracer_tpu.scene.compile import compile_scene as jax_compile
from logipathtracer_tpu.scene.procedural import make_box_scene as jax_box
from logipathtracer_tpu_torch.ops import traverse as ttrav
from logipathtracer_tpu_torch.ops.kernels.compact_intersect import hits_agree
from logipathtracer_tpu_torch.scene.compile import compile_scene
from logipathtracer_tpu_torch.scene.procedural import make_box_scene


@pytest.fixture(scope="module")
def scenes():
    jscene = jax_compile(jax_box(spheres=2, subdiv=3), use_native=False)
    tscene = compile_scene(make_box_scene(spheres=2, subdiv=3),
                           use_native=False).to("cpu")
    for f in ("fused_min", "fused_max", "fused_meta", "vtx_pos"):
        np.testing.assert_array_equal(getattr(tscene, f).numpy(),
                                      getattr(jscene, f))
    return jscene, tscene


def _rays(kind, n=384, seed=0):
    r = np.random.default_rng(seed)
    o = r.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if kind == "axis":
        axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
        d = axes[r.integers(0, 6, n)]
    elif kind == "outside":
        # From outside the box toward its inside (the camera's view).
        o = (r.normal(size=(n, 3)) * 0.3 + (0.0, 0.5, 6.0)).astype(np.float32)
        tgt = r.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
        d = tgt - o
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
    elif kind == "parked":
        o[n // 2:] = 1e30
        d[n // 2:] = 1.0
    return o, d


def _both(fn_name, jscene, tscene, o, d, **kw):
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    tj, oj, rj = getattr(jtrav, fn_name)(jscene, jnp.asarray(o),
                                         jnp.asarray(d), **jkw)
    tt, ot, rt = getattr(ttrav, fn_name)(tscene, torch.from_numpy(o),
                                         torch.from_numpy(d), **tkw)
    return ((np.asarray(tj), np.asarray(rj), np.asarray(oj)),
            (tt.numpy(), rt.numpy(), ot.numpy()))


@pytest.mark.parametrize("kind", ["axis", "outside", "parked", "random"])
def test_bvh_walk_matches_jax(scenes, kind):
    jscene, tscene = scenes
    o, d = _rays(kind)
    ref, got = _both("intersect_scene", jscene, tscene, o, d)
    hits_agree(ref, got)
    assert (got[1] >= 0).mean() > 0.2
    if kind == "parked":
        assert (got[1][192:] == -1).all() and (got[0][192:] >= 3e38).all()


@pytest.mark.parametrize("kind", ["outside", "random"])
def test_bruteforce_matches_jax_and_walk(scenes, kind):
    jscene, tscene = scenes
    o, d = _rays(kind, n=128, seed=3)
    ref, got = _both("intersect_bruteforce", jscene, tscene, o, d)
    hits_agree(ref, got)
    walk = ttrav.intersect_scene(tscene, torch.from_numpy(o),
                                 torch.from_numpy(d))
    hits_agree(got, [x.numpy() for x in (walk[0], walk[2], walk[1])])


@pytest.mark.parametrize("any_hit", [False, True])
def test_bvh_walk_tmax_matches_jax(scenes, any_hit):
    """t_max: only hits closer than it count, a miss is INF; any_hit is
    ignored by the walk in both packages."""
    jscene, tscene = scenes
    o, d = _rays("random", seed=5)
    t_max = np.random.default_rng(6).uniform(0.1, 4.0, o.shape[0]).astype(
        np.float32)
    ref, got = _both("intersect_scene", jscene, tscene, o, d, t_max=t_max)
    tt, _, rt = ttrav.intersect_scene(tscene, torch.from_numpy(o),
                                      torch.from_numpy(d),
                                      t_max=torch.from_numpy(t_max),
                                      any_hit=any_hit)
    np.testing.assert_array_equal(tt.numpy(), got[0])
    blocked = got[0] < t_max
    np.testing.assert_array_equal(blocked, ref[0] < t_max)
    assert 0.1 < blocked.mean() < 0.9
    hits_agree(ref, got)
    assert (got[0][~blocked] >= 3e38).all()
