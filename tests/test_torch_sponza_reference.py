"""The Sponza-class deployment's scene (portbench/scenes/sponza.py: an
atrium of about a hundred and fifty mesh primitives, 25 PBR materials
with base-colour, metallic-roughness and normal maps, an emissive sky
panel) through the port's normal path against the benchmark's plain
reference (portbench/refs/pathtrace.py), on the CPU at 64x64 with NEE
and MIS: a tiny atrium written as a .glb, loaded by ``load_gltf``,
compiled and rendered one sample a pixel by ``ProgressiveRenderer`` on
the streamed route (the frustum prepass and K4's plain version, for the
shadow rays in any-hit mode too) through the four-gather atlas that the
full-size scene takes; the reference traces the same paths from the
scene description.  Every pixel keeps to the pixel rule (|a - b| <=
1e-6 + 1e-4 |b|, tests/test_wavefront.py:36-37), and a reference whose
shadow rays ignore occluders misses it."""

import numpy as np
import pytest
import torch

from logipathtracer_tpu_torch import compile_scene, load_gltf
from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.ops.kernels._build import COUNTS
from logipathtracer_tpu_torch.render.progressive import ProgressiveRenderer
from portbench.drivers.common import HostSeeds
from portbench.refs import pathtrace as ref
from portbench.scenes import sponza
from portbench.scenes.glb import write_glb

SIZE = 64
HOST_SEED = 23
RENDER = dict(width=SIZE, height=SIZE, max_depth=10, nee=True, nee_mis=True,
              mip_levels=1, pool_size=SIZE * SIZE, intersect="stream",
              stream_tile=2048, cluster_size=512, tex_quad=False)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small tensor ops: one intra-op thread, so that the file's
    time does not balloon when several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def desc():
    return sponza.make(tex_size=16, tri_budget=3000)


@pytest.fixture(scope="module")
def port(desc, tmp_path_factory):
    """The port's mean radiance [SIZE, SIZE, 3] after one sample, and
    the streamed kernel's launches by mode."""
    path = write_glb(desc, str(tmp_path_factory.mktemp("sponza") / "s.glb"))
    cfg = RenderConfig(**RENDER)
    scene = compile_scene(load_gltf(path), cfg)
    assert scene.tex_slots == (True, True, True, False, True)
    assert scene.tex_quad is None and scene.num_lights > 0
    before = COUNTS["stream_cluster"].plain_calls
    r = ProgressiveRenderer(scene, cfg, host_seed=HOST_SEED, device="cpu")
    r.step(1)
    img = np.asarray(r.radiance())
    assert COUNTS["stream_cluster"].plain_calls > before
    return img


def _reference(desc):
    rs = ref.RefScene(desc, "cpu", torch.float32)
    ys, xs = np.mgrid[0:SIZE, 0:SIZE]
    pix = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.int64)
    ubo = np.repeat(HostSeeds(HOST_SEED).draw(1), pix.shape[0], axis=0)
    cam = desc.cameras[0]
    render = dict(RENDER, env_color=0.2, eps=1e-4, heitz_max_order=16,
                  rr_bounces=2, rr_threshold=0.5)
    v = ref.trace(rs, render, np.asarray(cam.world_matrix, np.float32),
                  float(cam.yfov), torch.from_numpy(ubo),
                  torch.from_numpy(pix))
    return v.numpy().reshape(SIZE, SIZE, 3)


def _kept(got, want) -> np.ndarray:
    return (np.abs(got - want) <= 1e-6 + 1e-4 * np.abs(want)).all(axis=-1)


def test_port_matches_reference(desc, port):
    want = _reference(desc)
    kept = _kept(port, want)
    assert kept.all(), f"{(~kept).sum()} pixels off the rule"
    assert want.mean() > 0.01


def test_shadow_rays_through_occluders_miss(desc, port, monkeypatch):
    def unblocked(rs, o, d, t_lim, want, eps):
        return torch.ones_like(want)
    monkeypatch.setattr(ref, "_visible", unblocked)
    kept = _kept(port, _reference(desc))
    assert kept.mean() < 0.5, kept.mean()
