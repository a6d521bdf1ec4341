"""The port's streamed-scene path end to end on the CPU:
``ProgressiveRenderer`` with ``intersect="stream"`` on a small
outside-class scene (``make_outside_scene(objects=8, n_materials=8,
tri_budget=8000)``, cluster_size 512: 113 clusters, beyond no budget
here but routed as a scene beyond it would be) against the JAX
package's ``ProgressiveRenderer`` with ``intersect="stream_interpret"``
(its streamed kernel in interpret mode), at 32x32, max_depth 10, a
1024-lane pool, ``stream_tile=1024``, two step(2) chunks.

The port runs each routing of the stream branch: the default config
takes the frustum cluster worklists (plain K4), ``stream_granularity=
"chunk"`` the chunk worklists (plain K5), ``stream_worklist=False`` the
octant chunk sweep (plain K6).  The NEE path is in
test_torch_stream_nee.py.

Criteria (tests/test_wavefront.py:36-37): >= 99.5% of pixels
isclose(rtol=1e-4, atol=1e-6), equal sample and traced-ray counts."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from logipathtracer_tpu.config import RenderConfig as JaxConfig
from logipathtracer_tpu.render.progressive import \
    ProgressiveRenderer as JaxRenderer
from logipathtracer_tpu.scene.compile import compile_scene
from logipathtracer_tpu.scene.procedural import make_outside_scene
from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.ops.kernels._build import COUNTS
from logipathtracer_tpu_torch.render.megakernel import (pick_intersect,
                                                        resolve_intersect_mode)
from logipathtracer_tpu_torch.render.progressive import ProgressiveRenderer

FIELDS = dict(width=32, height=32, max_depth=10, renderer="wavefront",
              pool_size=1024, stream_tile=1024, cluster_size=512)
HOST_SEED = 3

# The three routings of the stream branch, and the kernel whose plain
# calls each must move.
ROUTES = {
    "cluster": ({}, "stream_cluster"),
    "chunk": (dict(stream_granularity="chunk"), "worklist_chunk"),
    "no_worklist": (dict(stream_worklist=False), "octant_chunk"),
}


def outside_scene(nee: bool):
    return compile_scene(
        make_outside_scene(objects=8, n_materials=8, tri_budget=8000),
        JaxConfig(**FIELDS, nee=nee), use_native=False)


def render_both(jscene, nee: bool):
    """The JAX reference render and a function rendering the port with
    one routing: (radiance, total rays, plain calls of the route's kernel,
    K1 plain calls)."""
    jr = JaxRenderer(jscene, JaxConfig(**FIELDS, nee=nee,
                                       intersect="stream_interpret"),
                     host_seed=HOST_SEED)
    jr.step(2)
    jr.step(2)

    def port(route):
        kw, name = ROUTES[route]
        before = (COUNTS[name].plain_calls,
                  COUNTS["compact_intersect"].plain_calls)
        tr = ProgressiveRenderer(
            jscene, RenderConfig(**FIELDS, nee=nee, intersect="stream", **kw),
            host_seed=HOST_SEED, device="cpu")
        tr.step(2)
        tr.step(2)
        assert tr.sample_count == 4
        return (tr.radiance(), tr.total_rays,
                COUNTS[name].plain_calls - before[0],
                COUNTS["compact_intersect"].plain_calls - before[1])
    return (np.asarray(jr.radiance()), jr.total_rays), port


def check_route(ref, got):
    (jrad, jrays), (rad, rays, calls, k1_calls) = ref, got
    close = np.isclose(rad, jrad, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() >= 0.995, f"{close.mean():.4f} of pixels close"
    assert rays == jrays
    assert calls > 0 and k1_calls == 0      # the route's kernel, never K1
    assert rad.mean() > 0.01 and np.isfinite(rad).all()


@pytest.fixture(scope="module")
def renders():
    return render_both(outside_scene(nee=False), nee=False)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_stream_render_matches_jax(renders, route):
    ref, port = renders
    check_route(ref, port(route))


def test_stream_routing():
    """The JAX routing of the stream branch (megakernel.py:157-185), and
    a scene beyond the resident budget — the outside class's 1,233
    clusters of 512 triangles in 51 objects — resolves to 'stream'."""
    big = SimpleNamespace(cl_tris=torch.zeros(1).expand(1233, 9, 512),
                          num_objects=51)
    assert resolve_intersect_mode(RenderConfig(), big) == "stream"
    assert resolve_intersect_mode(RenderConfig(intersect="sweep"),
                                  big) == "stream"
    for kw, name in ((dict(), "intersect_scene_cluster_wl"),
                     (dict(stream_granularity="chunk"),
                      "intersect_scene_worklist"),
                     (dict(stream_worklist=False), "intersect_scene_stream"),
                     (dict(stream_compact=False), "intersect_scene_stream"),
                     (dict(intersect="stream_interpret"),
                      "intersect_scene_stream")):
        isect = pick_intersect(RenderConfig(**kw), big)
        assert name in isect.__code__.co_names, (kw, name)
