"""The megakernel render session on the CPU against the JAX package:
``accumulate_sample`` (reset, then accumulate) and
``ProgressiveRenderer(renderer="megakernel")`` — ``step(2)`` then
``step(1)`` with the same ``host_seed``, the reset on a camera move,
checkpoint / restore across the two packages — at 32x16, max_depth 4,
through the compact worklist sweep (K1's plain version here, the JAX
kernel in interpret mode).  Criteria (tests/test_wavefront.py:36-37):
>= 99.5% of pixels isclose(rtol=1e-4, atol=1e-6), equal sample and
traced-ray counts.  Also: a renderer built with no ``device=`` where
there is no card raises, naming ``device="cpu"``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from logipathtracer_tpu.config import RenderConfig as JaxConfig
from logipathtracer_tpu.render.megakernel import \
    accumulate_sample as jax_accumulate
from logipathtracer_tpu.render.progressive import \
    ProgressiveRenderer as JaxRenderer
from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.ops.kernels._build import COUNTS
from logipathtracer_tpu_torch.render import megakernel as tmk
from logipathtracer_tpu_torch.render.progressive import ProgressiveRenderer

from test_torch_megakernel import FIELDS, box_scenes

SESSION = dict(FIELDS, intersect="compact_interpret")
HOST_SEED = 3


def _close_frac(a, b):
    return np.isclose(a, b, rtol=1e-4, atol=1e-6).all(axis=-1).mean()


@pytest.fixture(scope="module")
def scenes():
    return box_scenes()


@pytest.fixture(scope="module")
def renders(scenes):
    jscene, tscene = scenes
    jr = JaxRenderer(jscene, JaxConfig(**SESSION), host_seed=HOST_SEED)
    before = COUNTS["compact_intersect"].plain_calls
    tr = ProgressiveRenderer(tscene, RenderConfig(**SESSION),
                             host_seed=HOST_SEED, device="cpu")
    for r in (jr, tr):
        r.step(2)
        r.step(1)
    return dict(jax=jr, port=tr,
                calls=COUNTS["compact_intersect"].plain_calls - before)


def test_accumulate_sample_matches_jax(scenes):
    jscene, tscene = scenes
    cam = jscene.cameras[0]
    world, fov = np.asarray(cam.world_matrix), float(cam.yfov)
    jcfg, tcfg = JaxConfig(**SESSION), RenderConfig(**SESSION)
    jacc = jnp.zeros((16, 32, 3), jnp.float32)
    tacc = torch.full((16, 32, 3), 7.0)        # reset discards it
    for seed, reset in (((11, 13), True), ((17, 19), False)):
        jacc, jrays = jax_accumulate(
            jscene, jcfg, jnp.asarray(world), jnp.float32(fov),
            jnp.asarray(seed, jnp.uint32), jacc, jnp.asarray(reset))
        tacc, trays = tmk.accumulate_sample(
            tscene, tcfg, torch.from_numpy(world), fov, torch.tensor(seed),
            tacc, reset)
        assert int(trays) == int(jrays)
        frac = _close_frac(tacc.numpy(), np.asarray(jacc))
        assert frac >= 0.995, f"{frac:.4f} of pixels close"
    assert tacc.mean() > 0.02


def test_session_matches_jax(renders):
    jr, tr = renders["jax"], renders["port"]
    assert tr.sample_count == jr.sample_count == 3
    assert tr.total_rays == jr.total_rays > 3 * 512
    frac = _close_frac(tr.radiance(), jr.radiance())
    assert frac >= 0.995, f"{frac:.4f} of pixels close"
    # One plain K1 call per bounce of each sample; no pool to drain.
    assert renders["calls"] == 3 * SESSION["max_depth"]
    assert tr._wf_state is None
    img = np.asarray(jr.image())
    assert _close_frac(tr.image().numpy(), img) >= 0.995
    assert tr.samples_per_sec() > 0 and tr.mrays_per_sec() > 0


def test_camera_move_resets_like_jax(scenes):
    jscene, tscene = scenes
    jr = JaxRenderer(jscene, JaxConfig(**SESSION), host_seed=HOST_SEED)
    tr = ProgressiveRenderer(tscene, RenderConfig(**SESSION),
                             host_seed=HOST_SEED, device="cpu")
    for r in (jr, tr):
        r.step(1)
        r.translate(0, 0.2)
        r.step(1)
    assert tr.sample_count == jr.sample_count == 1
    assert tr.total_rays == jr.total_rays
    assert _close_frac(tr.radiance(), jr.radiance()) >= 0.995


def test_checkpoint_restore_across_packages(scenes, renders, tmp_path):
    jscene, tscene = scenes
    jr, tr = renders["jax"], renders["port"]
    path = str(tmp_path / "port_ckpt")
    tr.checkpoint(path)
    back = JaxRenderer(jscene, JaxConfig(**SESSION), host_seed=1)
    back.restore(path)
    np.testing.assert_array_equal(back.radiance(), tr.radiance())
    fresh = ProgressiveRenderer(tscene, RenderConfig(**SESSION),
                                host_seed=99, device="cpu")
    fresh.restore(path)
    assert fresh.sample_count == 3 and fresh.total_rays == tr.total_rays
    # Both continue the same session: one more sample each.
    back.step(1)
    fresh.step_nosync(1)
    assert fresh.sample_count == back.sample_count == 4
    assert fresh.total_rays == back.total_rays
    assert _close_frac(fresh.radiance(), back.radiance()) >= 0.995


def test_accumulate_fn_replaces_accumulate_sample(scenes, renders):
    """``accumulate_fn`` takes accumulate_sample's place, once per sample
    with the reset flag of that sample, as in the JAX package."""
    resets = []

    def accumulate(scene, cfg, cam, fov, seed, accum, reset):
        resets.append(bool(reset))
        return tmk.accumulate_sample(scene, cfg, cam, fov, seed, accum, reset)

    tr = ProgressiveRenderer(scenes[1], RenderConfig(**SESSION),
                             host_seed=HOST_SEED, device="cpu",
                             accumulate_fn=accumulate)
    tr.step(2)
    tr.step(1)
    assert resets == [True, False, False]
    assert tr.total_rays == renders["port"].total_rays
    np.testing.assert_array_equal(tr.radiance(), renders["port"].radiance())


def test_no_card_without_device_raises(scenes, monkeypatch):
    """No quiet CPU fallback: without a card the caller must ask for the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ProgressiveRenderer(scenes[1], RenderConfig(**SESSION))
