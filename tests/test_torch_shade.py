"""The port's shading step (render/megakernel.py::shade_step, on CPU
tensors the plain version of kernel K2) against the JAX package's
``shade_step`` with ``shade="shade_interpret"`` (the Pallas kernel in
interpret mode), plus its building blocks (camera rays, BSDF pieces,
film) against their JAX twins.

Tolerance: ``shade.shade_agreement`` — seeds and alive flags may differ
on at most 0.5% of lanes (a walk that took another branch after a
last-ulp difference between the host libms' log/sin/cos/pow); on the
other lanes the floats meet the JAX package's own kernel-vs-jnp rule
(tests/test_shade_kernel.py:59-72)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from logipathtracer_tpu.config import RenderConfig as JaxConfig
from logipathtracer_tpu.film import image as jimage
from logipathtracer_tpu.ops import bsdf as jbsdf
from logipathtracer_tpu.ops.camera import generate_ray as jax_generate_ray
from logipathtracer_tpu.ops.rng import get_rand as jax_get_rand
from logipathtracer_tpu.ops.rng import seed_from_pixel as jax_seed
from logipathtracer_tpu.ops.traverse import intersect_scene
from logipathtracer_tpu.render.megakernel import shade_step as jax_shade_step
from logipathtracer_tpu.scene.compile import compile_scene
from logipathtracer_tpu.scene.procedural import make_box_scene
from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.film import image as timage
from logipathtracer_tpu_torch.ops import bsdf as tbsdf
from logipathtracer_tpu_torch.ops.camera import generate_ray
from logipathtracer_tpu_torch.ops.kernels import shade as tshade
from logipathtracer_tpu_torch.ops.rng import get_rand, seed_from_pixel
from logipathtracer_tpu_torch.render.megakernel import shade_step
from logipathtracer_tpu_torch.scene.types import SceneSoA

N = 1024


@pytest.fixture(scope="module")
def hit_state():
    """Camera rays of a 32x32 frame and their closest hits (JAX BVH
    walk), with random alive flags and bounce counts."""
    jscene = compile_scene(make_box_scene(spheres=2, subdiv=3),
                           use_native=False)
    cam = jscene.cameras[0]
    ys, xs = np.meshgrid(np.arange(32, dtype=np.float32),
                         np.arange(32, dtype=np.float32), indexing="ij")
    pix = jnp.asarray(np.stack([xs, ys], -1).reshape(-1, 2))
    seed = jax_seed(jnp.asarray([48271, 16807], jnp.uint32), pix)
    origin, direction, seed = jax_generate_ray(
        jnp.asarray(cam.world_matrix), jnp.float32(cam.yfov), pix,
        (32, 32), seed)
    t, obj, tri = intersect_scene(jscene, origin, direction, eps=1e-4)
    r = np.random.default_rng(3)
    state = dict(
        origin=np.array(origin), direction=np.array(direction),
        acc=r.random((N, 3)).astype(np.float32) * 0.1,
        mask=(0.2 + r.random((N, 3))).astype(np.float32),
        alive=r.random(N) < 0.9,
        seed=np.array(seed).astype(np.uint32),
        bounce=r.integers(0, 8, N).astype(np.int32),
        t=np.array(t), obj=np.array(obj), tri=np.array(tri))
    return jscene, SceneSoA.from_numpy(jscene).to("cpu"), state


def _jax_shade(jscene, st, parity, bounce):
    cfg = JaxConfig(width=32, height=32, shade="shade_interpret",
                    shade_tile=256, parity_rng=parity)
    out = jax_shade_step(
        jscene, cfg, jnp.asarray(st["origin"]), jnp.asarray(st["direction"]),
        jnp.asarray(st["acc"]), jnp.asarray(st["mask"]),
        jnp.asarray(st["alive"]), jnp.asarray(st["seed"]), bounce,
        jnp.asarray(st["t"]), jnp.asarray(st["obj"]), jnp.asarray(st["tri"]),
        prev_pdf=jnp.zeros((N,), jnp.float32))
    return [np.asarray(x) for x in out[:6]]


def _port_shade(tscene, st, parity, bounce):
    cfg = RenderConfig(width=32, height=32, parity_rng=parity)
    f = torch.from_numpy
    out = shade_step(
        tscene, cfg, f(st["origin"]), f(st["direction"]), f(st["acc"]),
        f(st["mask"]), f(st["alive"]), f(st["seed"].astype(np.int64)),
        bounce, f(st["t"]), f(st["obj"]), f(st["tri"]))
    return [x.numpy() for x in out[:6]]


@pytest.mark.parametrize("parity", [True, False])
def test_shade_step_matches_jax_kernel(hit_state, parity):
    jscene, tscene, st = hit_state
    ref = _jax_shade(jscene, st, parity, jnp.asarray(st["bounce"]))
    before = tshade.plain_calls
    got = _port_shade(tscene, st, parity, torch.from_numpy(st["bounce"]))
    assert tshade.plain_calls == before + 1 and tshade.launches == 0
    ref[5] = ref[5].astype(np.int64)
    diverged, _ = tshade.shade_agreement(ref, got)
    # The inputs exercise every branch: misses, hits, kills, survivors.
    assert (~got[4] & st["alive"]).any() and got[4].any()


def test_shade_step_scalar_bounce(hit_state):
    jscene, tscene, st = hit_state
    ref = _jax_shade(jscene, st, True, jnp.int32(4))
    got = _port_shade(tscene, st, True, 4)
    ref[5] = ref[5].astype(np.int64)
    tshade.shade_agreement(ref, got)


def test_generate_ray_matches_jax(hit_state):
    jscene, _, _ = hit_state
    cam = jscene.cameras[0]
    r = np.random.default_rng(5)
    pix = r.integers(0, 64, (512, 2)).astype(np.float32)
    ubo = np.array([1234567, 7654321], np.uint32)
    jo, jd, js = jax_generate_ray(
        jnp.asarray(cam.world_matrix), jnp.float32(cam.yfov),
        jnp.asarray(pix), (64, 48),
        jax_seed(jnp.asarray(ubo), jnp.asarray(pix)))
    to, td, ts = generate_ray(
        torch.from_numpy(np.asarray(cam.world_matrix, np.float32)),
        cam.yfov, torch.from_numpy(pix), (64, 48),
        seed_from_pixel(torch.from_numpy(ubo.astype(np.int64)),
                        torch.from_numpy(pix)))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=2e-6,
                               atol=2e-7)


@pytest.mark.parametrize("parity", [True, False])
def test_bsdf_matches_jax(parity):
    r = np.random.default_rng(7)
    n = 2048
    seed = r.integers(0, 2 ** 32, (n, 2), dtype=np.uint64).astype(np.uint32)
    metallic = r.random(n).astype(np.float32)
    transmission = (r.random(n) < 0.3).astype(np.float32)
    active = r.random(n) < 0.9
    jl, js = jbsdf.determine_interaction(
        jnp.asarray(metallic), jnp.asarray(transmission), jnp.asarray(seed),
        jnp.asarray(active), rand=jax_get_rand(parity))
    tl, ts = tbsdf.determine_interaction(
        torch.from_numpy(metallic), torch.from_numpy(transmission),
        torch.from_numpy(seed.astype(np.int64)), torch.from_numpy(active),
        rand=get_rand(parity))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))

    base = r.random((n, 3)).astype(np.float32)
    view = r.normal(size=(n, 3)).astype(np.float32)
    view[:, 2] = np.abs(view[:, 2]) + 0.05
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    rough = (0.05 + r.random(n)).astype(np.float32)
    ior = (1.2 + r.random(n) * 0.5).astype(np.float32)
    outside = r.random(n) < 0.7
    jw, jdir, js2 = jbsdf.heitz_sample(
        jnp.asarray(base), jnp.asarray(view), jnp.asarray(rough),
        jnp.asarray(transmission), jnp.asarray(ior), jnp.asarray(outside),
        jl, js, jnp.asarray(active), rand=jax_get_rand(parity))
    tw, tdir, ts2 = tbsdf.heitz_sample(
        torch.from_numpy(base), torch.from_numpy(view),
        torch.from_numpy(rough), torch.from_numpy(transmission),
        torch.from_numpy(ior), torch.from_numpy(outside), tl, ts,
        torch.from_numpy(active), rand=get_rand(parity))
    same = (ts2.numpy() == np.asarray(js2).astype(np.int64)).all(-1)
    assert same.mean() >= 1.0 - tshade.MAX_DIVERGED
    for a, b in ((jw, tw), (jdir, tdir)):
        np.testing.assert_allclose(b.numpy()[same], np.asarray(a)[same],
                                   rtol=tshade.ALL_RTOL,
                                   atol=tshade.ALL_ATOL)


def test_film_matches_jax():
    r = np.random.default_rng(9)
    accum = (r.random((16, 24, 3)) * 4).astype(np.float32)
    np.testing.assert_allclose(
        timage.tonemap(torch.from_numpy(accum), 3).numpy(),
        np.asarray(jimage.tonemap(jnp.asarray(accum), 3)), rtol=2e-6,
        atol=1e-7)
    c = r.random(1000).astype(np.float32)
    np.testing.assert_allclose(
        timage.srgb_to_linear(torch.from_numpy(c)).numpy(),
        np.asarray(jimage.srgb_to_linear(jnp.asarray(c))), rtol=2e-6,
        atol=1e-8)
    assert timage.rmse(accum, accum + 1.0) == pytest.approx(1.0)


@pytest.mark.parametrize("field,value,item", [
    ("nee", True, "NEE"), ("use_microfacet", False, "basic BSDF")])
def test_unported_shading_raises(hit_state, field, value, item):
    _, tscene, st = hit_state
    cfg = RenderConfig(width=32, height=32).replace(**{field: value})
    with pytest.raises(NotImplementedError, match=item):
        shade_step(tscene, cfg, *[torch.from_numpy(st[k]) for k in (
            "origin", "direction", "acc", "mask", "alive")],
            torch.from_numpy(st["seed"].astype(np.int64)), 0,
            *[torch.from_numpy(st[k]) for k in ("t", "obj", "tri")])
