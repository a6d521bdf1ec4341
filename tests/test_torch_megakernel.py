"""The port's lockstep megakernel renderer (``render/megakernel.py``:
``render_sample`` → ``render_rows`` → ``trace_rays``) against the JAX
package's ``render_sample`` on the CPU, at 32x16, max_depth 4, on every
resident intersect route: here the BVH walk, the compact worklist sweep
(K1) and the compact sweep without worklists (K7) — each the plain
version, the JAX kernel in interpret mode; the dense sweep (K8), its jnp
twin and the textured + NEE path in test_torch_megakernel_sweep.py.
Also: a row slab of ``render_rows`` equals those rows of
``render_sample`` (absolute-coordinate RNG streams).

Criterion (tests/test_wavefront.py:36-37): >= 99.5% of pixels
isclose(rtol=1e-4, atol=1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from logipathtracer_tpu.config import RenderConfig as JaxConfig
from logipathtracer_tpu.render.megakernel import \
    render_sample as jax_render_sample
from logipathtracer_tpu.scene.compile import compile_scene
from logipathtracer_tpu.scene.procedural import make_box_scene
from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.ops.kernels._build import COUNTS
from logipathtracer_tpu_torch.render import megakernel as tmk
from logipathtracer_tpu_torch.scene.types import SceneSoA

FIELDS = dict(width=32, height=16, max_depth=4, renderer="megakernel",
              compact_tile=256, sweep_tile=256)
SEED = (5, 7)

# route -> (config fields, the kernel whose plain calls the route must
# advance)
ROUTES = {
    "bvh": (dict(intersect="bvh"), None),
    "k1": (dict(intersect="compact_interpret"), "compact_intersect"),
    "k7": (dict(intersect="compact_interpret", compact_worklist=False),
           "compact_order"),
    "k8": (dict(intersect="sweep_interpret"), "dense_sweep"),
    "sweep_jnp": (dict(intersect="sweep_jnp"), None),
}


def _close_frac(a, b):
    return np.isclose(a, b, rtol=1e-4, atol=1e-6).all(axis=-1).mean()


def box_scenes(**kw):
    jscene = compile_scene(make_box_scene(spheres=2, subdiv=3, **kw),
                           use_native=False)
    return jscene, SceneSoA.from_numpy(jscene).to("cpu")


@pytest.fixture(scope="module")
def scenes():
    return box_scenes()


def _cam(scene):
    cam = scene.cameras[0]
    return cam.world_matrix, float(cam.yfov)


def _jax_image(jscene, fields):
    world, fov = _cam(jscene)
    return np.asarray(jax_render_sample(
        jscene, JaxConfig(**fields), jnp.asarray(world), jnp.float32(fov),
        jnp.asarray(SEED, jnp.uint32)))


def _port_image(tscene, fields):
    world, fov = _cam(tscene)
    return tmk.render_sample(tscene, RenderConfig(**fields),
                             torch.from_numpy(np.asarray(world)), fov,
                             torch.tensor(SEED)).numpy()


def check_route(scenes, route, **extra):
    """render_sample of the port against the JAX package's on one route
    (ROUTES), with ``extra`` config fields."""
    jscene, tscene = scenes
    fields, counter = ROUTES[route]
    fields = dict(FIELDS, **fields, **extra)
    before = COUNTS[counter].plain_calls if counter else 0
    img = _port_image(tscene, fields)
    if counter and not fields.get("nee"):
        # One intersect per bounce.
        assert COUNTS[counter].plain_calls == before + FIELDS["max_depth"]
    assert img.shape == (16, 32, 3) and np.isfinite(img).all()
    frac = _close_frac(img, _jax_image(jscene, fields))
    assert frac >= 0.995, f"{frac:.4f} of pixels close"
    assert img.mean() > 0.01
    return img


@pytest.mark.parametrize("route", ["bvh", "k1", "k7"])
def test_render_sample_matches_jax(scenes, route):
    check_route(scenes, route)


def test_render_rows_slab_equals_frame(scenes):
    """Rows [8, 16) rendered alone equal those rows of the full frame:
    pixel RNG streams are keyed by absolute coordinates, and an 8-row
    slab keeps whole 8 x 32 pixel blocks."""
    _, tscene = scenes
    fields = dict(FIELDS, intersect="compact_interpret")
    cfg = RenderConfig(**fields)
    world, fov = _cam(tscene)
    cam = torch.from_numpy(np.asarray(world))
    full = tmk.render_sample(tscene, cfg, cam, fov, torch.tensor(SEED))
    slab, rays = tmk.render_rows(tscene, cfg, cam, fov, torch.tensor(SEED),
                                 8, 8)
    assert slab.shape == (8, 32, 3)
    np.testing.assert_array_equal(slab.numpy(), full[8:].numpy())
    assert rays.dtype == torch.int64 and 256 <= int(rays) <= 256 * 4
    assert tmk._block_shape(cfg, 8, 32, tscene) == (8, 32)
    assert tmk._block_shape(cfg, 12, 32, tscene) is None
