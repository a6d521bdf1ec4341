"""The PBR deployment's scene (portbench/scenes/box_pbr.py: base-colour,
metallic-roughness and normal maps on every material, an emissive map on
the lamp) through the port's normal path against the benchmark's plain
reference (portbench/refs/pathtrace.py), on the CPU at 64x64 with NEE
and MIS: written as a .glb, loaded by ``load_gltf``, compiled and
rendered one sample a pixel by ``ProgressiveRenderer``, through the
quad atlas and through the four-gather route that the full-size scene
takes (its atlas is over the quad atlas's cap); the reference traces the
same paths from the scene description.  Every pixel keeps to
the pixel rule (|a - b| <= 1e-6 + 1e-4 |b|, tests/test_wavefront.py:
36-37), and a reference whose metallic-roughness tap swaps its channels
misses it."""

import numpy as np
import pytest
import torch

from logipathtracer_tpu_torch import compile_scene, load_gltf
from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.render.progressive import ProgressiveRenderer
from portbench.drivers.common import HostSeeds
from portbench.refs import pathtrace as ref
from portbench.scenes import box_pbr
from portbench.scenes.glb import write_glb

SIZE = 64
HOST_SEED = 17
RENDER = dict(width=SIZE, height=SIZE, max_depth=10, nee=True, nee_mis=True,
              mip_levels=1, pool_size=4096, compact_tile=256)


@pytest.fixture(scope="module")
def desc():
    return box_pbr.make(spheres=2, subdiv=1, tex_size=32)


@pytest.fixture(scope="module", params=[True, False],
                ids=["quad", "four_gather"])
def port(desc, tmp_path_factory, request):
    """The port's mean radiance [SIZE, SIZE, 3] after one sample."""
    path = write_glb(desc, str(tmp_path_factory.mktemp("pbr") / "s.glb"))
    cfg = RenderConfig(**RENDER, tex_quad=request.param)
    scene = compile_scene(load_gltf(path), cfg)
    assert scene.tex_slots == (True, True, True, False, True)
    assert (scene.tex_quad is not None) == request.param
    r = ProgressiveRenderer(scene, cfg, host_seed=HOST_SEED, device="cpu")
    r.step(1)
    return np.asarray(r.radiance())


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


def test_swapped_metallic_roughness_tap_misses(desc, port, monkeypatch):
    tap = ref.tap

    def swapped(rs, slot, *args):
        has, rgba = tap(rs, slot, *args)
        return has, (rgba[:, [0, 2, 1, 3]] if slot == 2 else rgba)
    monkeypatch.setattr(ref, "tap", swapped)
    kept = _kept(port, _reference(desc))
    assert kept.mean() < 0.5, kept.mean()
