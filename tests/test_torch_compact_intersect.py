"""The plain version of kernel K1 (logipathtracer_tpu_torch/ops/kernels/
compact_intersect.py) and its worklist prepass against the JAX
package's compact worklist sweep in interpret mode
(``intersect_scene_sweep(backend="compact_interpret", worklist=True)``),
on random rays, camera rays and pools with parked lanes.  Tolerance:
the rule of tests/test_compact.py:35-43 (t within rtol 2e-6 / atol
1e-6; tri/obj differ only on t ties)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from logipathtracer_tpu.ops.camera import generate_ray as jax_generate_ray
from logipathtracer_tpu.ops.pallas import compact_intersect as jci
from logipathtracer_tpu.ops.pallas.cluster_intersect import \
    chunk_world_bounds as jax_bounds
from logipathtracer_tpu.ops.rng import seed_from_pixel as jax_seed
from logipathtracer_tpu.ops.traverse import _pack_rays8, intersect_scene_sweep
from logipathtracer_tpu.scene.compile import compile_scene
from logipathtracer_tpu.scene.procedural import make_box_scene
from logipathtracer_tpu_torch.ops import traverse as ttrav
from logipathtracer_tpu_torch.ops.kernels import compact_intersect as tci
from logipathtracer_tpu_torch.scene.types import SceneSoA

TILE = 256


@pytest.fixture(scope="module")
def scenes():
    jscene = compile_scene(make_box_scene(spheres=2, subdiv=3),
                           use_native=False)
    return jscene, SceneSoA.from_numpy(jscene).to("cpu")


def _random_rays(n, seed):
    r = np.random.default_rng(seed)
    o = r.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _camera_rays(jscene, n):
    cam = jscene.cameras[0]
    w = h = 32
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    pix = jnp.asarray(np.stack([xs, ys], -1).reshape(-1, 2)[:n])
    seed = jax_seed(jnp.asarray([48271, 16807], jnp.uint32), pix)
    o, d, _ = jax_generate_ray(jnp.asarray(cam.world_matrix),
                               jnp.float32(cam.yfov), pix, (w, h), seed)
    return np.array(o), np.array(d)


def _parked(n, seed):
    """A sorted pool: live random rays first, then lanes parked at the
    1e30 origin the wavefront uses for dead lanes."""
    o, d = _random_rays(n, seed)
    o[n // 2:] = 1e30
    d[n // 2:] = 1.0
    return o, d


def _axis_rays(n, seed):
    """Axis-aligned directions: the slab's 1/0 = inf reciprocals."""
    o, _ = _random_rays(n, seed)
    axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    d = axes[np.random.default_rng(seed).integers(0, 6, n)]
    return o, d


RAYS = {
    "axis": lambda js: _axis_rays(384, 4),
    "random": lambda js: _random_rays(512, 0),
    "camera": lambda js: _camera_rays(js, 768),
    "parked": lambda js: _parked(640, 1),
}


@pytest.mark.parametrize("kind", sorted(RAYS))
def test_plain_k1_matches_jax_interpret(scenes, kind):
    jscene, tscene = scenes
    o, d = RAYS[kind](jscene)
    tj, oj, rj = intersect_scene_sweep(
        jscene, jnp.asarray(o), jnp.asarray(d), backend="compact_interpret",
        tile=TILE, worklist=True)
    before = tci.plain_calls
    tt, ot, rt = ttrav.intersect_scene_sweep(
        tscene, torch.from_numpy(o), torch.from_numpy(d), tile=TILE)
    assert tci.plain_calls == before + 1 and tci.launches == 0
    tci.hits_agree((tj, rj, oj), (tt, rt, ot))
    assert (np.asarray(rt) >= 0).mean() > 0.2   # the rays hit something
    if kind == "parked":
        assert (np.asarray(rt)[len(o) // 2:] == -1).all()


def test_worklist_prepass_matches_jax(scenes):
    jscene, tscene = scenes
    o, d = _random_rays(1024, 2)
    o[700:] = 1e30          # parked tiles fire nothing
    rays8_j, _ = _pack_rays8(jnp.asarray(o), jnp.asarray(d), TILE, None,
                             False)
    rays8_t, _ = tci.pack_rays8(torch.from_numpy(o), torch.from_numpy(d),
                                TILE)
    np.testing.assert_array_equal(rays8_t.numpy(), np.asarray(rays8_j))
    c = jscene.cl_tris.shape[0]
    bj = jax_bounds(jnp.asarray(jscene.cl_meta), jnp.asarray(jscene.cl_aabb),
                    jnp.asarray(jscene.obj_world), c, c, 1)
    bt = ttrav.scene_cluster_bounds(tscene)
    for a, b in zip(bj, bt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)
    wlj, wnj = jci.build_chunk_worklists(bj[0], bj[1], rays8_j, TILE)
    wlt, wnt = tci.build_chunk_worklists(bt[0], bt[1], rays8_t, TILE)
    np.testing.assert_array_equal(wnt.numpy(), np.asarray(wnj))
    assert int(wnt[-1]) == 0
    for i, n in enumerate(wnt.tolist()):
        # Same fired set; the front-to-back order may differ only where
        # two clusters' keys tie to the last ulp.
        assert set(wlt[i, :n].tolist()) == set(np.asarray(wlj)[i, :n])


def test_unported_modes_raise(scenes):
    _, tscene = scenes
    o, d = (torch.from_numpy(x) for x in _random_rays(8, 3))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttrav.intersect_scene_sweep(tscene, o, d, backend="pallas")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttrav.intersect_scene_sweep(tscene, o, d, worklist=False)
    with pytest.raises(NotImplementedError, match="NEE"):
        ttrav.intersect_scene_sweep(tscene, o, d, t_max=torch.ones(8))
