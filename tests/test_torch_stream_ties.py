"""The tie rules of the streamed-scene kernels K4 and K5 on the CPU: the
crafted case of ``test_torch_worklist.py`` (one triangle at equal t in
slots 5, 9 and 37 of one cluster and, with ``two_clusters``, in slot 2
of a second, nearer cluster) through the plain versions of K4
(``stream_cluster.cluster_intersect_stream_cl``) and K5
(``compact_intersect.cluster_intersect_worklist``, one cluster a chunk so
that its worklist too visits the nearer cluster first), against the JAX
streamed sweep in interpret mode (``cluster_intersect_stream`` at cap
32, the reference ``test_torch_stream.py`` holds both to).  Both keep
the lowest slot of the earlier-visited cluster; in any-hit mode every
lane is blocked and parked at -BIG.  Closest hit: t, tri and obj equal
the reference's; any-hit: t."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from logipathtracer_tpu.ops.pallas.cluster_intersect import \
    cluster_intersect_stream as jax_stream
from logipathtracer_tpu_torch.ops.kernels import compact_intersect as tci
from logipathtracer_tpu_torch.ops.kernels import stream_cluster as tk4
from test_torch_worklist import tie_case, tie_rays

TILE = 256


def _port(kernel, tables, rays8, any_hit):
    kw = dict(tile=TILE, eps=1e-4, has_tmax=any_hit, any_hit=any_hit)
    if kernel == "k4":
        before = tk4.plain_calls
        out = tk4.cluster_intersect_stream_cl(*tables, rays8, **kw)
        assert tk4.plain_calls == before + 1
    else:
        before = tci.worklist_plain_calls
        out = tci.cluster_intersect_worklist(*tables, rays8, chunk=1, **kw)
        assert tci.worklist_plain_calls == before + 1
    return [x.numpy() for x in out]


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("two_clusters", [False, True])
@pytest.mark.parametrize("kernel", ["k4", "k5"])
def test_stream_ties_keep_lowest_slot_and_earlier_cluster(kernel,
                                                          two_clusters,
                                                          any_hit):
    meta, inv, _, aabb, tris, world = tie_case(two_clusters)
    o, d, t_max = tie_rays()
    rays8, _ = tci.pack_rays8(torch.from_numpy(o), torch.from_numpy(d), TILE,
                              t_max=torch.from_numpy(t_max) if any_hit
                              else None)
    tables = [torch.from_numpy(a) for a in (meta, inv, aabb, tris, world)]
    t, tri, obj = _port(kernel, tables, rays8, any_hit)
    assert (obj == 0).all()
    if any_hit:
        assert (t == np.float32(-tci.BIG)).all()
    else:
        assert (tri == (128 + 2 if two_clusters else 5)).all()
        assert (t == 2.0).all()
    ref = jax_stream(*(jnp.asarray(a) for a in (meta, inv, aabb, tris,
                                                world)),
                     jnp.asarray(rays8.numpy()), tile=TILE, chunk=1,
                     eps=1e-4, interpret=True, has_tmax=any_hit, cap=32,
                     any_hit=any_hit)
    np.testing.assert_array_equal(t, np.asarray(ref[0]))
    if not any_hit:
        np.testing.assert_array_equal(tri, np.asarray(ref[1]))
        np.testing.assert_array_equal(obj, np.asarray(ref[2]))
