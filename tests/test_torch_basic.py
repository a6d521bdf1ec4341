"""The port's basic BSDF (``use_microfacet=False``) against the JAX
package: ``ops/bsdf.py::basic_sample`` lane for lane, the shading step
with the basic BSDF (``render/megakernel.py::shade_step`` →
``shade.shade_basic``) against the JAX ``shade_step`` on its jnp path,
NEE off and on, and 32x32 renders on the wavefront and the megakernel,
NEE off and on.

Tolerances: ``basic_sample`` draws a fixed number of rands per lobe, so
every lane's seed equals JAX's bit for bit; its floats meet the rule
tests/test_torch_shade.py holds the Heitz pieces to (shade.ALL_RTOL /
ALL_ATOL).  The shading step follows ``shade.shade_agreement``; the
renders tests/test_wavefront.py:36-37 (>= 99.5% of pixels within rtol
1e-4 / atol 1e-6, equal sample and traced-ray counts)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from logipathtracer_tpu.config import RenderConfig as JaxConfig
from logipathtracer_tpu.ops import bsdf as jbsdf
from logipathtracer_tpu.ops.camera import generate_ray as jax_generate_ray
from logipathtracer_tpu.ops.rng import get_rand as jax_get_rand
from logipathtracer_tpu.ops.rng import seed_from_pixel as jax_seed
from logipathtracer_tpu.ops.traverse import intersect_scene
from logipathtracer_tpu.render import megakernel as jmk
from logipathtracer_tpu.render.progressive import \
    ProgressiveRenderer as JaxRenderer
from logipathtracer_tpu.scene.compile import compile_scene
from logipathtracer_tpu.scene.procedural import make_box_scene
from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.ops import bsdf as tbsdf
from logipathtracer_tpu_torch.ops.kernels import shade as tshade
from logipathtracer_tpu_torch.ops.kernels._build import COUNTS
from logipathtracer_tpu_torch.ops.rng import get_rand
from logipathtracer_tpu_torch.render import megakernel as tmk
from logipathtracer_tpu_torch.render.progressive import ProgressiveRenderer
from logipathtracer_tpu_torch.scene.types import SceneSoA

N = 1024


def _lanes(n=4096, seed=21):
    """basic_sample inputs: the three lobes, ``outside`` both ways, and
    transmission lanes from inside at grazing angles (total internal
    reflection: the refraction is the zero vector)."""
    r = np.random.default_rng(seed)
    base = r.random((n, 3)).astype(np.float32)
    view = r.normal(size=(n, 3)).astype(np.float32)
    view[:, 2] = np.abs(view[:, 2]) + 0.02
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    trans = r.random(n).astype(np.float32)
    ior = (1.1 + r.random(n) * 0.8).astype(np.float32)
    outside = r.random(n) < 0.5
    lobe = r.integers(0, 3, n).astype(np.int32)
    active = r.random(n) < 0.9
    tir = slice(0, 256)
    view[tir] = np.array([0.98, 0.0, 0.2], np.float32) / np.float32(
        np.hypot(0.98, 0.2))
    outside[tir], lobe[tir], active[tir] = False, 2, True
    seed = r.integers(0, 2 ** 32, (n, 2), dtype=np.uint64).astype(np.uint32)
    return base, view, trans, ior, outside, lobe, seed, active


@pytest.mark.parametrize("parity", [True, False])
def test_basic_sample_matches_jax(parity):
    base, view, trans, ior, outside, lobe, seed, active = _lanes()
    jw, jdir, js = jbsdf.basic_sample(
        *(jnp.asarray(x) for x in (base, view, trans, ior, outside, lobe,
                                   seed, active)),
        rand=jax_get_rand(parity))
    f = torch.from_numpy
    tw, tdir, ts = tbsdf.basic_sample(
        f(base), f(view), f(trans), f(ior), f(outside), f(lobe),
        f(seed.astype(np.int64)), f(active), rand=get_rand(parity))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    for a, b in ((jw, tw), (jdir, tdir)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   rtol=tshade.ALL_RTOL,
                                   atol=tshade.ALL_ATOL)
    # Each lobe drew its rands: 2 (diffuse), 0 (metallic), 1 (trans).
    moved = (ts.numpy() != seed.astype(np.int64)).any(-1)
    assert not moved[active & (lobe == 1)].any()
    assert moved[active & (lobe != 1)].all() and not moved[~active].any()


def test_glsl_refract_total_internal_reflection():
    """The refraction of the TIR lanes is the zero vector in both
    packages, and the basic lobe then reflects about -z."""
    base, view, trans, ior, outside, lobe, seed, active = _lanes()
    z = np.zeros_like(view)
    z[:, 2] = 1.0
    nnt = np.where(outside, 1.0 / ior, ior).astype(np.float32)
    j = np.asarray(jbsdf._glsl_refract(jnp.asarray(-view), jnp.asarray(z),
                                       jnp.asarray(nnt)))
    t = tbsdf._glsl_refract(torch.from_numpy(-view), torch.from_numpy(z),
                            torch.from_numpy(nnt)).numpy()
    np.testing.assert_allclose(t, j, rtol=tshade.ALL_RTOL,
                               atol=tshade.ALL_ATOL)
    assert (t[:256] == 0).all() and (np.abs(t[256:]).sum(-1) > 0).any()
    _, tdir, _ = tbsdf.basic_sample(
        *(torch.from_numpy(x) for x in (base, view, trans, ior, outside,
                                        lobe, seed.astype(np.int64),
                                        active)))
    mirror = view[:256] * np.array([-1, -1, 1], np.float32)
    np.testing.assert_allclose(tdir.numpy()[:256], mirror, atol=1e-6)
    np.testing.assert_array_equal(
        tbsdf._reflect(torch.from_numpy(-view), torch.from_numpy(z)).numpy(),
        np.asarray(jbsdf._reflect(jnp.asarray(-view), jnp.asarray(z))))


@pytest.fixture(scope="module")
def box():
    """The untextured box (two spheres, one lamp) for both packages, and
    the closest hits of a 32x32 frame's camera rays with random alive
    flags, bounce counts and prev_pdf."""
    jscene = compile_scene(make_box_scene(spheres=2, subdiv=3),
                           use_native=False)
    assert jscene.num_lights > 0
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
    st = dict(
        origin=np.array(origin), direction=np.array(direction),
        acc=r.random((N, 3)).astype(np.float32) * 0.1,
        mask=(0.2 + r.random((N, 3))).astype(np.float32),
        alive=r.random(N) < 0.9, seed=np.array(seed).astype(np.uint32),
        bounce=r.integers(0, 8, N).astype(np.int32),
        prev_pdf=(r.random(N) * (r.random(N) < 0.5) * 0.3)
        .astype(np.float32),
        t=np.array(t), obj=np.array(obj), tri=np.array(tri))
    return jscene, SceneSoA.from_numpy(jscene).to("cpu"), st


@pytest.mark.parametrize("nee", [False, True])
def test_basic_shade_step_matches_jax(box, nee):
    """shade_step with use_microfacet=False: the port's basic route (and
    with NEE the shadow rays through the plain K1) against the JAX
    ``shade_step(shade="jnp")`` (shadow rays through its BVH walk)."""
    jscene, tscene, st = box
    jcfg = JaxConfig(width=32, height=32, shade="jnp", use_microfacet=False,
                     nee=nee, intersect="bvh")
    ref = jmk.shade_step(
        jscene, jcfg, *(jnp.asarray(st[k]) for k in (
            "origin", "direction", "acc", "mask", "alive", "seed")),
        jnp.asarray(st["bounce"]), *(jnp.asarray(st[k]) for k in (
            "t", "obj", "tri")), prev_pdf=jnp.asarray(st["prev_pdf"]),
        isect=jmk.pick_intersect(jcfg, jscene))
    ref = [np.asarray(x) for x in ref]
    ref[5] = ref[5].astype(np.int64)
    tcfg = RenderConfig(width=32, height=32, use_microfacet=False, nee=nee,
                        compact_tile=256)
    assert tmk.resolve_shade_mode(tcfg, tscene) == "basic"
    calls = lambda: tuple(COUNTS[k].plain_calls for k in (
        "shade_basic", "shade", "compact_intersect"))
    before = calls()
    f = torch.from_numpy
    got = tmk.shade_step(
        tscene, tcfg, *(f(st[k]) for k in ("origin", "direction", "acc",
                                            "mask", "alive")),
        f(st["seed"].astype(np.int64)), f(st["bounce"]),
        *(f(st[k]) for k in ("t", "obj", "tri")),
        prev_pdf=f(st["prev_pdf"]), isect=tmk.pick_intersect(tcfg, tscene))
    got = [x.numpy() for x in got]
    # The basic route ran, K2's plain twin did not; with NEE one shadow
    # query through the plain K1.
    assert calls() == (before[0] + 1, before[1], before[2] + int(nee))
    tshade.shade_agreement(ref[:6], got[:6])
    assert (~got[4] & st["alive"]).any() and got[4].any()
    if nee:
        same = (ref[4] == got[4]) & (ref[5] == got[5]).all(-1)
        np.testing.assert_allclose(got[6][same], ref[6][same],
                                   rtol=tshade.ALL_RTOL,
                                   atol=tshade.ALL_ATOL)
        # Light reached lanes that did not start on an emitter, and the
        # diffuse lanes carry the cos/pi pdf of their sampled direction.
        assert (got[6] > 0).any() and (got[2] > st["acc"] + 1e-6).any()
    else:
        # prev_pdf carries NEE state only: it passes through, as K2's.
        np.testing.assert_array_equal(got[6], st["prev_pdf"])


FIELDS = dict(width=32, height=32, max_depth=10, compact_tile=256,
              pool_size=1024, use_microfacet=False)


@pytest.mark.parametrize("nee", [False, True])
@pytest.mark.parametrize("renderer", ["wavefront", "megakernel"])
def test_basic_render_matches_jax(box, renderer, nee):
    """ProgressiveRenderer with the basic BSDF at 32x32 against the JAX
    package's: the wavefront (two step(2) chunks, the pool carried over)
    and the megakernel (one step(2)), NEE off and on."""
    jscene = box[0]
    fields = dict(FIELDS, renderer=renderer, nee=nee,
                  intersect="compact_interpret")
    chunks = (2, 2) if renderer == "wavefront" else (2,)
    jr = JaxRenderer(jscene, JaxConfig(**fields), host_seed=3)
    before = (COUNTS["shade_basic"].plain_calls, COUNTS["shade"].plain_calls)
    tr = ProgressiveRenderer(jscene, RenderConfig(**fields), host_seed=3,
                             device="cpu")
    for r in (jr, tr):
        for n in chunks:
            r.step(n)
    a, b = tr.radiance(), jr.radiance()
    close = np.isclose(a, b, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() >= 0.995, f"{close.mean():.4f} of pixels close"
    assert tr.sample_count == jr.sample_count == sum(chunks)
    assert tr.total_rays == jr.total_rays
    assert COUNTS["shade_basic"].plain_calls > before[0]
    assert COUNTS["shade"].plain_calls == before[1]
    assert a.mean() > 0.01 and np.isfinite(a).all()
