"""K4's 32-slot groups (``ops/kernels/stream_cluster.py``
``cluster_groups``) on the CPU, on a small outside-class scene cut into
128-triangle clusters: each cluster's count of groups that hold real
slots is ceil(count / 32), the count taken from the clusters' triangle
ranges; every real slot's three vertices lie inside its group's padded
box; and the boxes of the groups past that count are NaN, whose slab no
ray passes.  The card holds the kernel that reads them to its plain
version (``tests/test_torch_cuda.py``)."""

import torch

from logipathtracer_tpu_torch import RenderConfig, compile_scene
from logipathtracer_tpu_torch.ops.kernels import compact_intersect as ci
from logipathtracer_tpu_torch.ops.kernels import stream_cluster as k4
from logipathtracer_tpu_torch.scene.procedural import make_outside_scene


def test_cluster_groups_bound_their_real_slots():
    scene = compile_scene(
        make_outside_scene(objects=8, n_materials=8, tri_budget=8000),
        RenderConfig(cluster_size=128)).to("cpu")
    inv = scene.obj_world_inv[:, :3, :4].reshape(-1, 12).contiguous()
    tris = scene.cl_tris
    box, n = k4.cluster_groups(scene.cl_meta, inv, scene.cl_aabb, tris)
    c, _, s = tris.shape
    assert box.shape == (c, s // 32, 8) and n.dtype == torch.int32
    # The clusters cut the triangle soup into consecutive ranges.
    base, order = scene.cl_meta[:, 1].long().sort()
    ends = torch.cat([base[1:], torch.tensor([scene.num_triangles])])
    count = torch.empty(c, dtype=torch.long)
    count[order] = ends - base
    assert int(count.min()) == 2                # the ground quad
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
