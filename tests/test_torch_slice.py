"""The port's main path end to end on the CPU: ``ProgressiveRenderer``
(wavefront pool carried over between chunks, compact worklist intersect,
fused shade, sorted flush — the plain versions of K1-K3) against the
JAX package's ``ProgressiveRenderer`` with the same configuration in
interpret mode, at 32x32, max_depth 10, two step(2) chunks.

Criteria (tests/test_wavefront.py:36-37): >= 99.5% of pixels
isclose(rtol=1e-4, atol=1e-6), equal sample counts, equal traced-ray
counts.  A checkpoint written by either package restores in the other.
"""

import numpy as np
import pytest
import torch

from logipathtracer_tpu.config import RenderConfig as JaxConfig
from logipathtracer_tpu.render.progressive import \
    ProgressiveRenderer as JaxRenderer
from logipathtracer_tpu.scene.compile import compile_scene
from logipathtracer_tpu.scene.procedural import make_box_scene
from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.ops.kernels._build import COUNTS
from logipathtracer_tpu_torch.render.progressive import ProgressiveRenderer

FIELDS = dict(width=32, height=32, max_depth=10, renderer="wavefront",
              intersect="compact_interpret", compact_worklist=True,
              compact_tile=256, pool_size=1024)
HOST_SEED = 3


def _close_frac(a, b):
    return np.isclose(a, b, rtol=1e-4, atol=1e-6).all(axis=-1).mean()


@pytest.fixture(scope="module")
def renders():
    jscene = compile_scene(make_box_scene(spheres=2, subdiv=3),
                           use_native=False)
    jr = JaxRenderer(jscene, JaxConfig(**FIELDS), host_seed=HOST_SEED)
    calls = {k: COUNTS[k].plain_calls
             for k in ("compact_intersect", "shade", "flush")}
    tr = ProgressiveRenderer(jscene, RenderConfig(**FIELDS),
                             host_seed=HOST_SEED, device="cpu")
    for r in (jr, tr):
        r.step(2)
        r.step(2)
    out = dict(jscene=jscene, jax=jr, port=tr,
               jax_rad=jr.radiance(), port_rad=tr.radiance(),
               calls={k: COUNTS[k].plain_calls - n
                      for k, n in calls.items()})
    return out


def test_radiance_matches_jax(renders):
    frac = _close_frac(renders["port_rad"], renders["jax_rad"])
    assert frac >= 0.995, f"{frac:.4f} of pixels close"
    assert renders["port_rad"].mean() > 0.01


def test_counts_match_jax(renders):
    jr, tr = renders["jax"], renders["port"]
    assert tr.sample_count == jr.sample_count == 4
    assert tr.total_rays == jr.total_rays
    # The main path ran every stage through the kernels' wrappers.
    assert all(n > 0 for n in renders["calls"].values())


def test_image_matches_jax(renders):
    img = renders["port"].image()
    u8 = renders["port"].image_u8()
    assert img.shape == (32, 32, 3) and u8.shape == (32, 32, 4)
    assert u8.dtype == torch.uint8 and bool((u8[..., 3] == 255).all())
    ref = np.asarray(renders["jax"].image())
    close = np.isclose(img.numpy(), ref, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() >= 0.995


def test_checkpoints_restore_across_packages(renders, tmp_path):
    jscene, jr, tr = renders["jscene"], renders["jax"], renders["port"]
    path = str(tmp_path / "jax_ckpt")
    jr.checkpoint(path)
    fresh = ProgressiveRenderer(jscene, RenderConfig(**FIELDS),
                                host_seed=99, device="cpu")
    fresh.restore(path)
    np.testing.assert_array_equal(fresh.radiance(), renders["jax_rad"])
    assert fresh.sample_count == jr.sample_count
    assert fresh.total_rays == jr.total_rays
    np.testing.assert_array_equal(fresh.camera_world, jr.camera_world)
    assert (fresh._host_rng.bit_generator.state["state"]
            == jr._host_rng.bit_generator.state["state"])
    # Rendering on from the restored state continues the JAX session.
    jr2 = JaxRenderer(jscene, JaxConfig(**FIELDS))
    jr2.restore(path)
    fresh.step(2)
    jr2.step(2)
    assert _close_frac(fresh.radiance(), jr2.radiance()) >= 0.995
    # And a checkpoint of the port restores in the JAX package.
    port_path = str(tmp_path / "port_ckpt")
    tr.checkpoint(port_path)
    back = JaxRenderer(jscene, JaxConfig(**FIELDS), host_seed=1)
    back.restore(port_path)
    np.testing.assert_array_equal(back.radiance(), renders["port_rad"])


@pytest.mark.parametrize("knob", [dict(sort_rays=False), dict(sort_every=2),
                                  dict(lazy_regen=2),
                                  dict(pool_carryover=False)])
def test_scheduling_knobs_keep_radiance(renders, knob):
    """sort_rays / sort_every / lazy_regen / pool_carryover change when
    maintenance runs, never a work item's radiance."""
    r = ProgressiveRenderer(renders["jscene"],
                            RenderConfig(**FIELDS).replace(**knob),
                            host_seed=HOST_SEED, device="cpu")
    r.step(2)
    r.step(2)
    assert _close_frac(r.radiance(), renders["port_rad"]) >= 0.995
    assert r.total_rays == renders["port"].total_rays


def test_camera_moves_match_jax(renders):
    jr = JaxRenderer(renders["jscene"], JaxConfig(**FIELDS))
    tr = ProgressiveRenderer(renders["jscene"], RenderConfig(**FIELDS),
                             device="cpu")
    for r in (jr, tr):
        r.translate(0, 0.25)
        r.rotate(1, 0.1)
        r.rotate(0, -0.05)
    np.testing.assert_array_equal(tr.camera_world, jr.camera_world)
    tr.set_camera(np.eye(4), fov_y=0.5)
    assert tr.fov_y == 0.5 and tr._dirty


def test_unported_configs_raise(renders):
    js = renders["jscene"]
    # The basic BSDF is ported: it constructs and renders through its
    # own route, K2's plain twin never.
    calls = (COUNTS["shade_basic"].plain_calls, COUNTS["shade"].plain_calls)
    basic = ProgressiveRenderer(js, RenderConfig(**FIELDS).replace(
        use_microfacet=False, max_depth=3), host_seed=HOST_SEED,
        device="cpu")
    basic.step(1)
    rad = basic.radiance()
    assert np.isfinite(rad).all() and rad.mean() > 0.01
    assert COUNTS["shade_basic"].plain_calls > calls[0]
    assert COUNTS["shade"].plain_calls == calls[1]
    # The megakernel, the BVH walk, K7 and K8 are ported: each constructs,
    # and so does every routing of the streamed intersect.
    for kw in (dict(renderer="megakernel"), dict(intersect="bvh"),
               dict(compact_worklist=False), dict(intersect="sweep"),
               dict(intersect="sweep_jnp"),
               dict(renderer="megakernel", intersect="sweep", nee=True),
               dict(intersect="stream"), dict(intersect="stream_interpret"),
               dict(intersect="stream", stream_granularity="chunk"),
               dict(intersect="stream", stream_worklist=False),
               dict(intersect="stream", stream_compact=False)):
        ProgressiveRenderer(js, RenderConfig(**FIELDS).replace(**kw),
                            device="cpu")
    # More than one device is MeshRenderer's, which the package exports
    # lazily beside render_wavefront.
    with pytest.raises(NotImplementedError, match="multi-device"):
        ProgressiveRenderer(js, RenderConfig(**FIELDS),
                            device=["cpu", "cpu"])
    import logipathtracer_tpu_torch as lpt
    from logipathtracer_tpu_torch.parallel.mesh import MeshRenderer
    from logipathtracer_tpu_torch.render.wavefront import render_wavefront
    assert lpt.MeshRenderer is MeshRenderer
    assert lpt.render_wavefront is render_wavefront
    assert {"MeshRenderer", "render_wavefront"} <= set(lpt.__all__)


def test_step_nosync_and_rates(renders):
    """step_nosync renders exactly what step renders; the rates count
    the session's samples and rays."""
    a = ProgressiveRenderer(renders["jscene"], RenderConfig(**FIELDS),
                            host_seed=HOST_SEED, device="cpu")
    b = ProgressiveRenderer(renders["jscene"], RenderConfig(**FIELDS),
                            host_seed=HOST_SEED, device="cpu")
    a.step(2)
    b.step_nosync(2)
    np.testing.assert_array_equal(a.radiance(), b.radiance())
    assert a.total_rays == b.total_rays > 0
    assert a.samples_per_sec() > 0 and a.mrays_per_sec() > 0
    a.reset()
    a.step(1)
    assert a.sample_count == 1
