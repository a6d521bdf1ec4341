"""The port's device mesh (``parallel/mesh.py``: ``make_mesh``,
``MeshRenderer``) against the JAX package's on the CPU, ported from
tests/test_parallel.py:32-162 onto ``make_box_scene(spheres=2,
subdiv=3)`` at 16x16, max_depth 4 (that file's tests take the absent
cornell asset).  The port's mesh runs on ``["cpu"] * 4``, JAX's on four
of the eight virtual CPU devices of tests/conftest.py.  Here the
megakernel route and the session (accumulation, reset, checkpoints,
``make_mesh``); the wavefront route in test_torch_parallel_wavefront.py.

Each shard equals the port's single-device render of its seed and rows
bit for bit; the mesh meets the repo's pixel rule against JAX's (>=
99.5% of pixels isclose(rtol=1e-4, atol=1e-6), tests/test_wavefront.py:
36-37).  Rays: the port counts every shard.  JAX's mesh step returns one
ray count per sample slice (``out_specs P("samples")``,
parallel/mesh.py:195), the count of its tile 0, so on a mesh of more
than one tile its ``total_rays`` is the sum over samples of tile 0's
rays; with one tile the two totals are equal."""

import jax
import numpy as np
import pytest
import torch

from logipathtracer_tpu.config import RenderConfig as JaxConfig
from logipathtracer_tpu.parallel.mesh import MeshRenderer as JaxMesh
from logipathtracer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from logipathtracer_tpu.scene.compile import compile_scene
from logipathtracer_tpu.scene.procedural import make_box_scene
from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.parallel.mesh import MeshRenderer, make_mesh
from logipathtracer_tpu_torch.render.megakernel import (render_rows,
                                                        render_sample)
from logipathtracer_tpu_torch.render.progressive import ProgressiveRenderer
from logipathtracer_tpu_torch.render.wavefront import render_wavefront
from logipathtracer_tpu_torch.scene.types import SceneSoA

FIELDS = dict(width=16, height=16, max_depth=4)
SHAPES = [(4, 1), (2, 2), (1, 4)]
HOST_SEED = 21


def _close_frac(a, b):
    return np.isclose(a, b, rtol=1e-4, atol=1e-6).all(axis=-1).mean()


@pytest.fixture(scope="module")
def scenes():
    jscene = compile_scene(make_box_scene(spheres=2, subdiv=3),
                           use_native=False)
    return jscene, SceneSoA.from_numpy(jscene).to("cpu")


def port_mesh(scene, fields, shape, host_seed=HOST_SEED):
    return MeshRenderer(scene, RenderConfig(**fields),
                        make_mesh(["cpu"] * 4, *shape), host_seed=host_seed)


def jax_mesh(jscene, fields, shape, host_seed=HOST_SEED):
    """JAX's mesh renderer; its wavefront walks the BVH, as its own
    test does (tests/test_parallel.py:146-147); its megakernel takes
    the BVH walk off a TPU by default."""
    return JaxMesh(jscene, JaxConfig(**fields, intersect="bvh"),
                   jax_make_mesh(jax.devices()[:4], *shape),
                   host_seed=host_seed)


def single_device(scene, fields, seed):
    """The port's single-device frame of one seed: radiance [H, W, 3]."""
    cfg = RenderConfig(**fields)
    cam = scene.cameras[0]
    world = torch.from_numpy(np.asarray(cam.world_matrix, np.float32))
    seed = torch.from_numpy(np.asarray(seed, np.int64))
    if cfg.renderer == "wavefront":
        img, _, _ = render_wavefront(scene, cfg, world, float(cam.yfov),
                                     seed[None], pool=cfg.pool_size)
        return img
    return render_sample(scene, cfg, world, float(cam.yfov), seed)


def slab_rays(scene, fields, seed, y0, rows):
    """The rays the port's single-device render of a slab traces."""
    cfg = RenderConfig(**fields)
    cam = scene.cameras[0]
    world = torch.from_numpy(np.asarray(cam.world_matrix, np.float32))
    seed = torch.from_numpy(np.asarray(seed, np.int64))
    if cfg.renderer == "wavefront":
        return render_wavefront(scene, cfg, world, float(cam.yfov),
                                seed[None], y0=y0, rows=rows)[1]
    return int(render_rows(scene, cfg, world, float(cam.yfov), seed, y0,
                           rows)[1])


def check_shape(scenes, fields, shape):
    """Shards against the port's single-device frames, bit for bit; the
    mesh against JAX's of the same shape."""
    jscene, scene = scenes
    samples, tiles = shape
    r = port_mesh(scene, fields, shape)
    r.step()
    assert r.sample_count == samples
    seeds = np.random.default_rng(HOST_SEED).integers(
        1, 2 ** 31, (samples, 2), dtype=np.int64)
    rows = 16 // tiles
    for i in range(samples):
        frame = single_device(scene, fields, seeds[i])
        for j in range(tiles):
            assert r.accum[i][j].shape == (rows, 16, 3)
            assert torch.equal(r.accum[i][j],
                               frame[j * rows:(j + 1) * rows])
    rays = {(i, j): slab_rays(scene, fields, seeds[i], j * rows, rows)
            for i in range(samples) for j in range(tiles)}
    assert r.total_rays == sum(rays.values())
    jr = jax_mesh(jscene, fields, shape)
    jr.step()
    frac = _close_frac(r.radiance(), jr.radiance())
    assert frac >= 0.995, f"{frac:.4f} of pixels close"
    assert jr.total_rays == sum(rays[i, 0] for i in range(samples))
    if tiles == 1:
        assert r.total_rays == jr.total_rays
    return r, jr


@pytest.fixture(scope="module")
def mesh22(scenes):
    return check_shape(scenes, dict(FIELDS, renderer="megakernel"), (2, 2))


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_matches_single_device(scenes, mesh22, shape):
    if shape == (2, 2):
        return                         # checked in the fixture
    check_shape(scenes, dict(FIELDS, renderer="megakernel"), shape)


def test_mesh_progressive_accumulation(scenes):
    r = port_mesh(scenes[1], dict(FIELDS, renderer="megakernel"), (2, 2),
                  host_seed=1)
    r.step()
    assert r.sample_count == 2
    first = r.radiance()
    rays = r.total_rays
    r.step(3)                          # two rounds of two samples
    assert r.sample_count == 6 and r.total_rays > rays
    second = r.radiance()
    assert (first != second).any() and np.isfinite(second).all()
    assert r.samples_per_sec() > 0 and r.mrays_per_sec() > 0
    img = r.image()
    assert img.shape == (16, 16, 3) and torch.isfinite(img).all()


def test_mesh_reset(scenes):
    """A camera move restarts accumulation: the next round replaces
    every shard, as a fresh mesh at the moved camera renders it."""
    fields = dict(FIELDS, renderer="megakernel")
    r = port_mesh(scenes[1], fields, (2, 2), host_seed=1)
    r.step()
    r.step()
    assert r.sample_count == 4
    r.translate(2, -0.1)
    r.step()
    assert r.sample_count == 2 and np.isfinite(r.radiance()).all()
    fresh = port_mesh(scenes[1], fields, (2, 2), host_seed=1)
    for _ in range(2):
        fresh._host_rng.integers(1, 2 ** 31, (2, 2), dtype=np.int64)
    fresh.translate(2, -0.1)
    fresh.step()
    np.testing.assert_array_equal(r.radiance(), fresh.radiance())
    assert r.total_rays == fresh.total_rays


def test_checkpoints_across_shapes_and_packages(scenes, mesh22, tmp_path):
    jscene, scene = scenes
    fields = dict(FIELDS, renderer="megakernel")
    r, jr = mesh22
    before = r.radiance()
    ck = str(tmp_path / "mesh22")
    r.checkpoint(ck)
    # Another mesh shape and the single-device session, bit for bit.
    r14 = port_mesh(scene, fields, (1, 4), host_seed=99)
    r14.restore(ck)
    single = ProgressiveRenderer(scene, RenderConfig(**fields),
                                 host_seed=99, device="cpu")
    single.restore(ck)
    for other in (r14, single):
        assert other.sample_count == r.sample_count
        assert other.total_rays == r.total_rays
        np.testing.assert_array_equal(other.radiance(), before)
        assert (other._host_rng.bit_generator.state["state"]
                == r._host_rng.bit_generator.state["state"])
    # Accumulation goes on from the restored sum.
    r14.step()
    assert r14.sample_count == 3 and r14.total_rays > r.total_rays
    # The JAX mesh's checkpoint restores here, and the port's there.
    jck = str(tmp_path / "jax_mesh22")
    jr.checkpoint(jck)
    back = port_mesh(scene, fields, (4, 1), host_seed=5)
    back.restore(jck)
    np.testing.assert_array_equal(back.radiance(), jr.radiance())
    assert back.sample_count == jr.sample_count
    jback = jax_mesh(jscene, fields, (2, 2), host_seed=5)
    jback.restore(ck)
    np.testing.assert_array_equal(np.asarray(jback.radiance()), before)
    assert jback.total_rays == r.total_rays


@pytest.mark.parametrize("samples,tiles", [(None, None), (2, None),
                                           (None, 2), (4, 1), (1, 4)])
def test_make_mesh_shapes(samples, tiles):
    ours = make_mesh(["cpu"] * 4, samples=samples, tiles=tiles)
    ref = jax_make_mesh(jax.devices()[:4], samples=samples, tiles=tiles)
    assert ours.shape == dict(ref.shape)
    assert ours.devices.shape == ref.devices.shape
    assert all(d == torch.device("cpu") for d in ours.devices.flat)


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_mesh()
    with pytest.raises(ValueError, match="needs 6 devices"):
        make_mesh(["cpu"] * 4, samples=3, tiles=2)
