"""The port's next-event-estimation path against the JAX package: the
plain K2 in its tex + nee mode with its shadow query through the plain
K1 (against the JAX ``shade_step`` with the Pallas kernel in interpret
mode), and the textured NEE slice end to end.  The walk's eval hook is
tested in test_torch_shade.py, the t_max / any-hit queries of K1 in
test_torch_compact_intersect.py.

Tolerances: the shading step follows ``shade.shade_agreement`` (at most
0.5% of lanes may take another branch after a last-ulp libm difference;
the floats of the other lanes meet the JAX package's kernel-vs-jnp
rule), with prev_pdf held to the same rule.  The render follows
tests/test_wavefront.py:36-37 (>= 99.5% of pixels within rtol 1e-4 /
atol 1e-6, equal sample and traced-ray counts)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from logipathtracer_tpu.config import RenderConfig as JaxConfig
from logipathtracer_tpu.ops.camera import generate_ray as jax_generate_ray
from logipathtracer_tpu.ops.rng import seed_from_pixel as jax_seed
from logipathtracer_tpu.ops.traverse import intersect_scene
from logipathtracer_tpu.render import megakernel as jmk
from logipathtracer_tpu.render.progressive import \
    ProgressiveRenderer as JaxRenderer
from logipathtracer_tpu.scene.compile import compile_scene
from logipathtracer_tpu.scene.procedural import make_box_scene
from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.ops.kernels import shade as tshade
from logipathtracer_tpu_torch.ops.kernels._build import COUNTS
from logipathtracer_tpu_torch.render import megakernel as tmk
from logipathtracer_tpu_torch.render.progressive import ProgressiveRenderer
from logipathtracer_tpu_torch.scene.types import SceneSoA

TILE = 256
N = 1024


@pytest.fixture(scope="module")
def box():
    """The textured NEE box (two spheres) for both packages."""
    jscene = compile_scene(make_box_scene(spheres=2, subdiv=3,
                                          textured=True), use_native=False)
    assert jscene.has_textures and jscene.num_lights > 0
    return jscene, SceneSoA.from_numpy(jscene).to("cpu")


def _hit_state(jscene, seed0=3):
    """Camera rays of a 32x32 frame and their closest hits (JAX BVH
    walk), with random alive flags, bounce counts and prev_pdf."""
    cam = jscene.cameras[0]
    ys, xs = np.meshgrid(np.arange(32, dtype=np.float32),
                         np.arange(32, dtype=np.float32), indexing="ij")
    pix = jnp.asarray(np.stack([xs, ys], -1).reshape(-1, 2))
    seed = jax_seed(jnp.asarray([48271, 16807], jnp.uint32), pix)
    origin, direction, seed = jax_generate_ray(
        jnp.asarray(cam.world_matrix), jnp.float32(cam.yfov), pix,
        (32, 32), seed)
    t, obj, tri = intersect_scene(jscene, origin, direction, eps=1e-4)
    r = np.random.default_rng(seed0)
    return dict(
        origin=np.array(origin), direction=np.array(direction),
        acc=r.random((N, 3)).astype(np.float32) * 0.1,
        mask=(0.2 + r.random((N, 3))).astype(np.float32),
        alive=r.random(N) < 0.9, seed=np.array(seed).astype(np.uint32),
        bounce=r.integers(0, 8, N).astype(np.int32),
        prev_pdf=(r.random(N) * (r.random(N) < 0.5) * 0.3)
        .astype(np.float32),
        t=np.array(t), obj=np.array(obj), tri=np.array(tri))


def _shade_both(jscene, tscene, st, parity, mis):
    """JAX shade_step in interpret mode (prologue + Pallas kernel with
    the nee variant, shadow rays through the compact interpret sweep)
    and the port's shade_step on the CPU (plain K2 + plain K1)."""
    jcfg = JaxConfig(width=32, height=32, shade="shade_interpret",
                     shade_tile=256, parity_rng=parity, nee=True,
                     nee_mis=mis, intersect="compact_interpret",
                     compact_tile=TILE)
    ref = jmk.shade_step(
        jscene, jcfg, *(jnp.asarray(st[k]) for k in (
            "origin", "direction", "acc", "mask", "alive", "seed")),
        jnp.asarray(st["bounce"]), *(jnp.asarray(st[k]) for k in (
            "t", "obj", "tri")), prev_pdf=jnp.asarray(st["prev_pdf"]),
        isect=jmk.pick_intersect(jcfg, jscene))
    ref = [np.asarray(x) for x in ref]
    ref[5] = ref[5].astype(np.int64)
    tcfg = RenderConfig(width=32, height=32, parity_rng=parity, nee=True,
                        nee_mis=mis, compact_tile=TILE)
    f = torch.from_numpy
    got = tmk.shade_step(
        tscene, tcfg, *(f(st[k]) for k in ("origin", "direction", "acc",
                                            "mask", "alive")),
        f(st["seed"].astype(np.int64)), f(st["bounce"]),
        *(f(st[k]) for k in ("t", "obj", "tri")),
        prev_pdf=f(st["prev_pdf"]), isect=tmk.pick_intersect(tcfg, tscene))
    return ref, [x.numpy() for x in got]


def _agree_with_pdf(ref, got):
    """shade_agreement on the six state outputs, and prev_pdf' under the
    same float rule on the agreeing lanes."""
    tshade.shade_agreement(ref[:6], got[:6])
    same = (ref[4] == got[4]) & (ref[5] == got[5]).all(-1)
    close = np.isclose(got[6][same], ref[6][same], rtol=tshade.CLOSE_RTOL,
                       atol=tshade.CLOSE_ATOL)
    assert close.mean() >= tshade.CLOSE_FRAC
    np.testing.assert_allclose(got[6][same], ref[6][same],
                               rtol=tshade.ALL_RTOL, atol=tshade.ALL_ATOL)


def _plain_calls():
    """(K2's, K1's) plain-version calls."""
    return COUNTS["shade"].plain_calls, COUNTS["compact_intersect"].plain_calls


# Parity draws with MIS, Threefry draws without: each draw kind and
# each MIS setting once (the JAX interpret kernel costs ~10 s a case).
@pytest.mark.parametrize("parity,mis", [(True, True), (False, False)])
def test_shade_tex_nee_matches_jax_kernel(box, parity, mis):
    jscene, tscene = box
    st = _hit_state(jscene)
    before = _plain_calls()
    ref, got = _shade_both(jscene, tscene, st, parity, mis)
    # One shading step and one shadow query, both plain versions.
    assert _plain_calls() == (before[0] + 1, before[1] + 1)
    _agree_with_pdf(ref, got)
    # NEE ran: some lanes carry a light-sampled pdf, and light reached
    # lanes that did not start on an emitter.
    assert (got[6] > 0).any() and (got[2] > st["acc"] + 1e-6).any()


FIELDS = dict(width=32, height=32, max_depth=10, renderer="wavefront",
              intersect="compact_interpret", compact_worklist=True,
              compact_tile=256, pool_size=1024, nee=True)


def test_slice_nee_textured_matches_jax(box):
    """ProgressiveRenderer, NEE on the textured box, two step(2) chunks
    with the pool carried over, against the JAX package's."""
    jscene, _ = box
    jr = JaxRenderer(jscene, JaxConfig(**FIELDS), host_seed=3)
    calls = _plain_calls()
    tr = ProgressiveRenderer(jscene, RenderConfig(**FIELDS), host_seed=3,
                             device="cpu")
    for r in (jr, tr):
        r.step(2)
        r.step(2)
    a, b = tr.radiance(), jr.radiance()
    close = np.isclose(a, b, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() >= 0.995, f"{close.mean():.4f} of pixels close"
    assert tr.sample_count == jr.sample_count == 4
    # Shadow rays are not counted, as in the JAX package.
    assert tr.total_rays == jr.total_rays
    # Every iteration traced twice: the path rays and the shadow rays.
    n_shade, n_isect = (a - b for a, b in zip(_plain_calls(), calls))
    assert n_shade > 0 and n_isect == 2 * n_shade
    assert a.mean() > 0.01 and np.isfinite(a).all()
