"""The frozen reference against the port at 64x64 on the CPU, within
the repository's pixel rule (tests/test_wavefront.py:36-37: at least
99.5% of pixels to rtol 1e-4, atol 1e-6): the port's plain path renders
one sample of every pixel, the reference traces the same paths from
the benchmark's scene description."""

import numpy as np
import pytest
import torch

from portbench.drivers.common import HostSeeds
from portbench.refs import pathtrace as ref
from portbench.scenes import box, maps, outside
from portbench.scenes.glb import write_glb

SIZE = 64


def _port_radiance(scene_desc, render, tmp_path, host_seed):
    from logipathtracer_tpu_torch import compile_scene, load_gltf
    from logipathtracer_tpu_torch.config import RenderConfig
    from logipathtracer_tpu_torch.render.progressive import \
        ProgressiveRenderer
    cfg = RenderConfig(**render)
    scene = compile_scene(load_gltf(write_glb(scene_desc,
                                              str(tmp_path / "s.glb"))),
                          cfg)
    r = ProgressiveRenderer(scene, cfg, host_seed=host_seed, device="cpu")
    r.step(1)
    return r.radiance()


def _ref_radiance(scene_desc, render, host_seed, dtype=torch.float32):
    rs = ref.RefScene(scene_desc, "cpu", dtype)
    ys, xs = np.mgrid[0:SIZE, 0:SIZE]
    pix = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.int64)
    ubo = np.repeat(HostSeeds(host_seed).draw(1), pix.shape[0], axis=0)
    cam = scene_desc.cameras[0]
    r = dict(render, env_color=0.2, eps=1e-4, heitz_max_order=16,
             rr_bounces=2, rr_threshold=0.5)
    v = ref.trace(rs, r, np.asarray(cam.world_matrix, np.float32),
                  float(cam.yfov), torch.from_numpy(ubo),
                  torch.from_numpy(pix))
    return v.to(torch.float32).numpy().reshape(SIZE, SIZE, 3)


def _agree(a, b) -> float:
    ok = np.abs(a - b) <= 1e-6 + 1e-4 * np.abs(b)
    return float(ok.all(axis=-1).mean())


@pytest.mark.parametrize("microfacet", [True, False],
                         ids=["heitz", "basic"])
def test_box_matches_port(tmp_path, microfacet):
    scene = box.make(spheres=4, subdiv=2)
    render = dict(width=SIZE, height=SIZE, max_depth=10,
                  use_microfacet=microfacet, pool_size=4096,
                  compact_tile=256)
    got = _port_radiance(scene, render, tmp_path, 11)
    want = _ref_radiance(scene, render, 11)
    assert _agree(got, want) >= 0.995
    assert want.mean() > 0.01


def test_outside_matches_port(tmp_path):
    scene = outside.make(objects=8, n_materials=8, tri_budget=8000)
    render = dict(width=SIZE, height=SIZE, max_depth=10, pool_size=4096,
                  stream_tile=1024, intersect="stream", cluster_size=512)
    got = _port_radiance(scene, render, tmp_path, 5)
    want = _ref_radiance(scene, render, 5)
    assert _agree(got, want) >= 0.995


@pytest.mark.parametrize("scene,render", [
    ("box", {"nee_mis": True}), ("box", {"nee_mis": False}),
    ("maps", {"nee_mis": True}), ("maps", {"use_microfacet": False}),
    ("maps", {"nee": False})],
    ids=["box-mis", "box-no_mis", "maps-mis", "maps-basic", "maps-no_nee"])
def test_textured_nee_matches_port(tmp_path, scene, render):
    """Texture taps (every slot, wrap and filter in ``maps``), light
    samples, shadow rays and MIS weights against the port's plain path."""
    desc = (box.make(spheres=4, subdiv=2, textured=True) if scene == "box"
            else maps.make(spheres=4, subdiv=2, seed=3))
    render = dict(dict(width=SIZE, height=SIZE, max_depth=10,
                       pool_size=4096, compact_tile=256, nee=True), **render)
    got = _port_radiance(desc, render, tmp_path, 13)
    want = _ref_radiance(desc, render, 13)
    assert _agree(got, want) >= 0.995
    assert want.mean() > 0.01


def test_bfloat16_reference_departs_textured_nee():
    """The control's precision moves most pixels off the rule on the
    textured scene with NEE too."""
    scene = box.make(spheres=4, subdiv=2, textured=True)
    render = dict(width=SIZE, height=SIZE, max_depth=10, nee=True)
    a = _ref_radiance(scene, render, 11)
    b = _ref_radiance(scene, render, 11, torch.bfloat16)
    assert _agree(b, a) < 0.5


def test_bfloat16_reference_departs(tmp_path):
    """The control's precision moves most pixels off the rule."""
    scene = box.make(spheres=4, subdiv=2)
    render = dict(width=SIZE, height=SIZE, max_depth=10)
    a = _ref_radiance(scene, render, 11)
    b = _ref_radiance(scene, render, 11, torch.bfloat16)
    assert _agree(b, a) < 0.5


def test_rng_stream_matches_glsl():
    """The hash stream against its scalar form (random.glsl:9-15)."""
    def scalar(sx, sy):
        m = 0xFFFFFFFF
        sx, sy = (sx + 1) & m, (sy + 1) & m
        qx = (1103515245 * ((sx >> 1) ^ sy)) & m
        qy = (1103515245 * ((sy >> 1) ^ sx)) & m
        n = (1103515245 * (qx ^ (qy >> 3))) & m
        return np.float32(np.float32(n) * np.float32(2.0 ** -32))
    seeds = np.array([[0, 0], [1, 2], [4294967295, 7], [123456, 654321]],
                     np.int64)
    s = ref.Stream(torch.from_numpy(seeds), torch.float32)
    got = s.draw(torch.ones(4, dtype=torch.bool)).numpy()
    want = np.array([scalar(int(a), int(b)) for a, b in seeds])
    np.testing.assert_array_equal(got, want)
