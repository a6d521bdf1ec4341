"""The 32-slot groups of K1 and K4 (``ops/kernels/compact_intersect.py``
``cluster_groups``) on the CPU, on a small outside-class scene cut into
128-triangle clusters and on the benchmark's box class (86 clusters of
256): each cluster's count of groups that hold real slots is ceil(count
/ 32), the count taken from the clusters' triangle ranges; every real
slot's three vertices lie inside its group's padded box; and the boxes
of the groups past that count are NaN, whose slab no ray passes.  K1's
wrapper takes them and on the CPU gives its plain version's answer.  The
card holds the kernels that read them to their plain versions
(``tests/test_torch_cuda.py``)."""

import pytest
import torch

from logipathtracer_tpu_torch import RenderConfig, compile_scene
from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
from logipathtracer_tpu_torch.ops.traverse import scene_cluster_bounds
from logipathtracer_tpu_torch.scene.procedural import (make_box_scene,
                                                       make_outside_scene)


def _scene(which):
    if which == "outside":
        return compile_scene(
            make_outside_scene(objects=8, n_materials=8, tri_budget=8000),
            RenderConfig(cluster_size=128)).to("cpu")
    return compile_scene(make_box_scene(spheres=10, subdiv=3)).to("cpu")


@pytest.mark.parametrize("which", ["outside", "box"])
def test_cluster_groups_bound_their_real_slots(which):
    scene = _scene(which)
    inv = scene.obj_world_inv[:, :3, :4].reshape(-1, 12).contiguous()
    tris = scene.cl_tris
    box, n = ci.cluster_groups(scene.cl_meta, inv, scene.cl_aabb, tris)
    c, _, s = tris.shape
    assert box.shape == (c, s // 32, 8) and n.dtype == torch.int32
    # The clusters cut the triangle soup into consecutive ranges.
    base, order = scene.cl_meta[:, 1].long().sort()
    ends = torch.cat([base[1:], torch.tensor([scene.num_triangles])])
    count = torch.empty(c, dtype=torch.long)
    count[order] = ends - base
    assert int(count.min()) == 2                # a quad: ground or lamp
    if which == "box":      # 6 clusters of 1 group, 40 of 5, 40 of 6
        assert torch.bincount(n).tolist() == [0, 6, 0, 0, 0, 40, 40]
    assert torch.equal(n.long(), (count + 31) // 32)
    slot = torch.arange(s)
    g = slot // 32
    real = slot[None] < count[:, None]                       # [C, S]
    v0 = tris[:, 0:3]
    lo = box[:, :, 0:3].transpose(1, 2)[:, :, g]             # [C, 3, S]
    hi = box[:, :, 3:6].transpose(1, 2)[:, :, g]
    for v in (v0, v0 + tris[:, 3:6], v0 + tris[:, 6:9]):
        inside = ((v >= lo) & (v <= hi)).all(dim=1)
        assert bool(inside[real].all())
    assert bool((lo < hi)[real[:, None].expand_as(lo)].all())  # padded
    empty = torch.arange(s // 32)[None] >= n[:, None]
    assert bool(empty.any())
    assert bool(box[..., :6][empty].isnan().all())
    assert bool(torch.isfinite(box[..., :6][~empty]).all())
    # A NaN box fails every slab, from anywhere, in any direction.
    o = torch.randn(3, 64)
    d = torch.randn(3, 64)
    nan_box = list(box[empty][0, :6])
    hit = ci._slab_table(list(o), list(1.0 / d), nan_box,
                         torch.full((64,), ci.BIG))
    assert not bool(hit.any())


@pytest.mark.parametrize("mode", ["closest", "tmax", "any_hit"])
def test_k1_wrapper_takes_groups_on_the_cpu(mode):
    """K1's wrapper with the scene's groups on CPU tensors: its plain
    version's answer, bit for bit (the plain version needs no groups)."""
    scene = _scene("box")
    inv = scene.obj_world_inv[:, :3, :4].reshape(-1, 12).contiguous()
    tables = (scene.cl_meta, inv, scene.cl_aabb, scene.cl_tris)
    g = torch.Generator().manual_seed(7)
    o = torch.rand((2048, 3), generator=g) * 1.6 - 0.8
    d = torch.nn.functional.normalize(torch.randn((2048, 3), generator=g),
                                      dim=1)
    has_tmax = mode != "closest"
    t_max = torch.rand(2048, generator=g) * 4.0 + 0.05
    rays8, _ = ci.pack_rays8(o, d, 1024, t_max=t_max if has_tmax else None)
    wl, wn = ci.build_chunk_worklists(*scene_cluster_bounds(scene), rays8,
                                      1024, has_tmax=has_tmax)
    kw = dict(has_tmax=has_tmax, any_hit=mode == "any_hit")
    args = (rays8, wl, wn, *tables, 1024, 1e-4)
    got = ci.compact_wl_intersect(*args, groups=ci.cluster_groups(*tables),
                                  **kw)
    ref = ci.compact_wl_intersect_plain(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    hit = got[0] < (t_max if has_tmax else ci.BIG)
    assert 0 < int(hit.sum()) < 2048
