"""Kernels K1-K3 against their plain versions on the card, at small
shapes.  Marked ``cuda``: they need an NVIDIA card with nvcc and skip
elsewhere.  On the card (which has no JAX, imported by the suite's
conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` repeats the comparison at the main path's shapes."""

import numpy as np
import pytest
import torch

from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
from logipathtracer_tpu_torch.ops.kernels import flush, shade
from logipathtracer_tpu_torch.ops.traverse import scene_cluster_bounds

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.fixture
def scene(dev):
    from logipathtracer_tpu_torch import compile_scene
    from logipathtracer_tpu_torch.scene.procedural import make_box_scene
    return compile_scene(make_box_scene(spheres=2, subdiv=3)).to(dev)


def _rays(n, dev, seed=0):
    r = np.random.default_rng(seed)
    o = r.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    d[n // 2:n // 2 + n // 8] = axes[r.integers(0, 6, n // 8)]  # 1/0 = inf
    o[n // 2 + n // 4:] = 1e30          # a parked tail
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


def test_k1_matches_plain(scene, dev):
    o, d = _rays(4096, dev)
    tile = 1024
    rays8, _ = ci.pack_rays8(o, d, tile)
    wl, wn = ci.build_chunk_worklists(*scene_cluster_bounds(scene), rays8,
                                      tile)
    inv = scene.obj_world_inv[:, :3, :4].reshape(-1, 12).contiguous()
    args = (rays8, wl, wn, scene.cl_meta, inv, scene.cl_aabb, scene.cl_tris,
            tile, 1e-4)
    n0 = ci.launches
    got = ci.compact_wl_intersect(*args)
    assert ci.launches == n0 + 1
    ref = ci.compact_wl_intersect_plain(*args)
    ci.hits_agree([x.cpu() for x in ref], [x.cpu() for x in got])


@pytest.mark.parametrize("parity", [True, False])
def test_k2_matches_plain(scene, dev, parity):
    from logipathtracer_tpu_torch.ops.traverse import intersect_scene_sweep
    n = 4096
    o, d = _rays(n, dev, seed=1)
    t, _, tri = intersect_scene_sweep(scene, o, d, tile=1024)
    r = np.random.default_rng(2)
    g = lambda a: torch.from_numpy(a).to(dev)
    args = (scene.tri_shade, o, d, g(r.random((n, 3)).astype(np.float32)),
            g((0.2 + r.random((n, 3))).astype(np.float32)),
            g(r.random(n) < 0.9),
            g(r.integers(0, 2 ** 32, (n, 2), dtype=np.int64)),
            g(r.integers(0, 8, n).astype(np.int32)), t, tri)
    kw = dict(env=0.2, rr_threshold=0.5, rr_bounces=2, max_order=16,
              parity=parity)
    got = shade.shade(*args, **kw)
    ref = shade.shade_plain(*args, **kw)
    shade.shade_agreement([x.cpu() for x in ref], [x.cpu() for x in got])


def test_k3_matches_plain_and_repeats_exactly(dev):
    r = np.random.default_rng(3)
    npix, rows, retired = 4096, 8192, 3000
    pix = np.concatenate([np.full(rows - retired, -1, np.int32),
                          np.sort(r.integers(0, npix, retired))
                          .astype(np.int32)])
    acc = torch.from_numpy(r.random((rows, 3)).astype(np.float32)).to(dev)
    pix = torch.from_numpy(pix).to(dev)
    base = torch.from_numpy(r.random((npix, 3)).astype(np.float32)).to(dev)
    a = flush.flush_sorted(base.clone(), pix, acc)
    b = flush.flush_sorted(base.clone(), pix, acc)
    p = flush.flush_sorted_plain(base.clone(), pix, acc)
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.cpu().numpy(), p.cpu().numpy(), rtol=1e-6,
                               atol=1e-6)


def test_wrappers_check_inputs(scene, dev):
    with pytest.raises(ValueError, match="dtype"):
        flush.flush_sorted(torch.zeros((8, 3), device=dev),
                           torch.zeros(4, dtype=torch.int64, device=dev),
                           torch.zeros((4, 3), device=dev))


@pytest.mark.parametrize("knob", [
    {}, dict(parity_rng=False), dict(sort_rays=False), dict(lazy_regen=2),
    dict(pool_size=1000, compact_tile=256)])
def test_render_card_matches_cpu(dev, knob):
    """The whole slice on the card against the CPU (plain versions),
    including the configurations off the flagship path."""
    from logipathtracer_tpu_torch import (ProgressiveRenderer, RenderConfig,
                                          compile_scene)
    from logipathtracer_tpu_torch.scene.procedural import make_box_scene
    host = compile_scene(make_box_scene(spheres=2, subdiv=3))
    cfg = RenderConfig(width=32, height=32, pool_size=1024,
                       compact_tile=256).replace(**knob)
    rads = []
    for device in (dev, "cpu"):
        r = ProgressiveRenderer(host, cfg, host_seed=5, device=device)
        r.step(2)
        r.step(1)
        rads.append((r.radiance(), r.total_rays))
    (a, ra), (b, rb) = rads
    close = np.isclose(a, b, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() >= 0.995
    assert ra == rb
