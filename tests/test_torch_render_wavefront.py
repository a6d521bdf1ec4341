"""The port's single-shot wavefront, ``render_wavefront`` (S samples of a
row slab in one fresh pool, plain K1-K3 on the CPU), against the JAX
package's ``render_wavefront`` on ``make_box_scene(spheres=2,
subdiv=3)`` at 32x32 with a 512-lane pool: the full frame NEE off and
on (textured); its slabs in test_torch_render_wavefront_slab.py.  The
JAX side runs its compact intersect in interpret mode.  Within the
port, slabs of either layout tile back into the full frame.
``ProgressiveRenderer(pool_carryover=False)`` renders each ``step()``
through it, as the JAX package's does.

Criteria (tests/test_wavefront.py:36-37): >= 99.5% of pixels
isclose(rtol=1e-4, atol=1e-6), equal traced-ray counts and equal
iteration counts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from logipathtracer_tpu.config import RenderConfig as JaxConfig
from logipathtracer_tpu.render.progressive import \
    ProgressiveRenderer as JaxRenderer
from logipathtracer_tpu.render.wavefront import \
    render_wavefront as jax_render_wavefront
from logipathtracer_tpu.scene.compile import compile_scene
from logipathtracer_tpu.scene.procedural import make_box_scene
from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.ops.kernels._build import COUNTS
from logipathtracer_tpu_torch.render.progressive import ProgressiveRenderer
from logipathtracer_tpu_torch.render.wavefront import render_wavefront
from logipathtracer_tpu_torch.scene.types import SceneSoA

# pool_carryover=False: render_wavefront ignores it, and the JAX
# session's render_wavefront then shares its compile with the frame's.
FIELDS = dict(width=32, height=32, max_depth=10, renderer="wavefront",
              intersect="compact_interpret", compact_tile=256,
              pool_size=512, pool_carryover=False)
POOL = 512
SEEDS = np.array([[12345, 678], [999, 4242]], np.int64)


def _close_frac(a, b):
    return np.isclose(a, b, rtol=1e-4, atol=1e-6).all(axis=-1).mean()


def box_scenes(**kw):
    jscene = compile_scene(make_box_scene(spheres=2, subdiv=3, **kw),
                           use_native=False)
    return jscene, SceneSoA.from_numpy(jscene).to("cpu")


@pytest.fixture(scope="module")
def scenes():
    return box_scenes()


def _jax(jscene, fields, seeds, **kw):
    cam = jscene.cameras[0]
    img, rays, it = jax_render_wavefront(
        jscene, JaxConfig(**fields), jnp.asarray(cam.world_matrix),
        jnp.float32(cam.yfov), jnp.asarray(seeds, jnp.uint32), pool=POOL,
        **kw)
    return np.asarray(img), int(rays), int(it)


def _port(scene, fields, seeds, **kw):
    cam = scene.cameras[0]
    img, rays, it = render_wavefront(
        scene, RenderConfig(**fields),
        torch.from_numpy(np.asarray(cam.world_matrix, np.float32)),
        float(cam.yfov), torch.from_numpy(np.asarray(seeds)), pool=POOL,
        **kw)
    assert isinstance(rays, int) and isinstance(it, int)
    return img, rays, it


@pytest.mark.parametrize("nee", [False, True])
def test_full_frame_matches_jax(scenes, nee):
    jscene, scene = box_scenes(textured=True) if nee else scenes
    fields = dict(FIELDS, nee=nee)
    calls = {k: COUNTS[k].plain_calls
             for k in ("compact_intersect", "shade", "flush")}
    img, rays, it = _port(scene, fields, SEEDS)
    ref, ref_rays, ref_it = _jax(jscene, fields, SEEDS)
    assert img.shape == (32, 32, 3) and img.device.type == "cpu"
    frac = _close_frac(img.numpy(), ref)
    assert frac >= 0.995, f"{frac:.4f} of pixels close"
    assert rays == ref_rays and it == ref_it
    assert img.mean() > 0.01
    # The plain versions of K1, K2 and K3 ran.
    assert all(COUNTS[k].plain_calls > n for k, n in calls.items())


@pytest.mark.parametrize("n_seeds", [1, 2])
def test_slabs_tile_the_frame(scenes, n_seeds):
    """Pixel streams are keyed by absolute coordinates: slabs of either
    layout concatenate to the full frame, bit for bit with one seed (each
    pixel's sum holds one path), within the JAX package's own rule
    (tests/test_wavefront.py:181-182) with two; the rays add up."""
    _, scene = scenes
    seeds = SEEDS[:n_seeds]
    full, rays, _ = _port(scene, FIELDS, seeds)
    for cuts in ((0, 16, 32), (0, 20, 32)):
        parts = [_port(scene, FIELDS, seeds, y0=a, rows=b - a)
                 for a, b in zip(cuts, cuts[1:])]
        tiled = torch.cat([p[0] for p in parts])
        assert sum(p[1] for p in parts) == rays
        if n_seeds == 1:
            assert torch.equal(tiled, full)
        else:
            np.testing.assert_allclose(tiled.numpy(), full.numpy(),
                                       rtol=1e-5, atol=1e-6)


def test_single_shot_session_matches_jax(scenes):
    """ProgressiveRenderer(pool_carryover=False): each step() is one
    render_wavefront, its iterations in last_iterations."""
    jscene, _ = scenes
    jr = JaxRenderer(jscene, JaxConfig(**FIELDS), host_seed=3)
    tr = ProgressiveRenderer(jscene, RenderConfig(**FIELDS), host_seed=3,
                             device="cpu")
    for _ in range(2):
        jr.step(2)
        tr.step(2)
        assert tr.last_iterations == jr.last_iterations > 0
        assert tr.total_rays == jr.total_rays
        assert tr._wf_state is None     # nothing left in flight
    assert tr.sample_count == jr.sample_count == 4
    frac = _close_frac(tr.radiance(), jr.radiance())
    assert frac >= 0.995, f"{frac:.4f} of pixels close"
