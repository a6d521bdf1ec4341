"""The tie rules of the compacted-visit kernels K4-K7 on the CPU: the
crafted case of ``test_torch_worklist.py`` (one triangle at equal t in
slots 5, 9 and 37 of one cluster and, with ``two_clusters``, in slot 2
of a second, nearer cluster) through the plain versions of K4
(``stream_cluster.cluster_intersect_stream_cl``), K5
(``compact_intersect.cluster_intersect_worklist``) and K6's cap > 0 body
(``cluster_intersect.cluster_intersect_stream``, cap 32), one cluster a
chunk so that their lists too visit the nearer cluster first, against
the JAX streamed sweep in interpret mode (``cluster_intersect_stream``
at cap 32, the reference ``test_torch_stream.py`` holds them to); and
K7 (``compact_intersect.cluster_intersect_compact(worklist=False)``),
whose order visits cluster 0 first, against the JAX package's
``cluster_intersect_compact(worklist=False)`` in interpret mode.  The
sub-tile visit too: K6's cap = 0 body (``cluster_intersect_stream``,
cap 0, one cluster a chunk: the nearer cluster first) against the JAX
streamed sweep at cap 0, and K8 (``cluster_intersect.
cluster_intersect_pallas``, cluster 0 first) against the JAX package's
``cluster_intersect_pallas`` in interpret mode.  Each keeps the lowest
slot of the earlier-visited cluster; in any-hit mode every lane of the
compacted visits is blocked and parked at -BIG, while the sub-tile
visit ignores any_hit and answers the closest hit under t_max.
Closest hit: t, tri and obj equal the reference's; any-hit: t."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from logipathtracer_tpu.ops.pallas.cluster_intersect import \
    cluster_intersect_pallas as jax_pallas
from logipathtracer_tpu.ops.pallas.cluster_intersect import \
    cluster_intersect_stream as jax_stream
from logipathtracer_tpu.ops.pallas.compact_intersect import \
    cluster_intersect_compact as jax_compact
from logipathtracer_tpu_torch.ops.kernels import cluster_intersect as tk6
from logipathtracer_tpu_torch.ops.kernels import compact_intersect as tci
from logipathtracer_tpu_torch.ops.kernels import stream_cluster as tk4
from logipathtracer_tpu_torch.ops.kernels._build import COUNTS
from test_torch_worklist import tie_case, tie_rays

TILE = 256


def _port(kernel, tables, order, rays8, any_hit):
    kw = dict(tile=TILE, eps=1e-4, has_tmax=any_hit, any_hit=any_hit)
    meta, inv, aabb, tris, world = tables
    if kernel == "k4":
        before = COUNTS["stream_cluster"].plain_calls
        out = tk4.cluster_intersect_stream_cl(*tables, rays8, **kw)
        assert COUNTS["stream_cluster"].plain_calls == before + 1
    elif kernel == "k5":
        before = COUNTS["worklist_chunk"].plain_calls
        out = tci.cluster_intersect_worklist(*tables, rays8, chunk=1, **kw)
        assert COUNTS["worklist_chunk"].plain_calls == before + 1
    elif kernel in ("k6", "k6_cap0"):
        before = COUNTS["octant_chunk"].plain_calls
        out = tk6.cluster_intersect_stream(*tables, rays8, chunk=1,
                                           cap=32 if kernel == "k6" else 0,
                                           **kw)
        assert COUNTS["octant_chunk"].plain_calls == before + 1
    elif kernel == "k8":
        before = COUNTS["dense_sweep"].plain_calls
        out = tk6.cluster_intersect_pallas(meta, inv, order, aabb, tris,
                                           rays8, tile=TILE, eps=1e-4,
                                           has_tmax=any_hit)
        assert COUNTS["dense_sweep"].plain_calls == before + 1
    else:
        before = COUNTS["compact_order"].plain_calls
        out = tci.cluster_intersect_compact(meta, inv, aabb, tris, rays8,
                                            world, worklist=False,
                                            cl_order=order, **kw)
        assert COUNTS["compact_order"].plain_calls == before + 1
    return [x.numpy() for x in out]


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("two_clusters", [False, True])
@pytest.mark.parametrize("kernel", ["k4", "k5", "k6", "k7", "k6_cap0", "k8"])
def test_stream_ties_keep_lowest_slot_and_earlier_cluster(kernel,
                                                          two_clusters,
                                                          any_hit):
    meta, inv, order, aabb, tris, world = tie_case(two_clusters)
    o, d, t_max = tie_rays()
    rays8, _ = tci.pack_rays8(torch.from_numpy(o), torch.from_numpy(d), TILE,
                              t_max=torch.from_numpy(t_max) if any_hit
                              else None)
    tables = [torch.from_numpy(a) for a in (meta, inv, aabb, tris, world)]
    t, tri, obj = _port(kernel, tables, torch.from_numpy(order), rays8,
                        any_hit)
    assert (obj == 0).all()
    parked = any_hit and kernel not in ("k6_cap0", "k8")
    if parked:
        assert (t == np.float32(-tci.BIG)).all()
    else:
        nearer_first = two_clusters and kernel not in ("k7", "k8")
        assert (tri == (128 + 2 if nearer_first else 5)).all()
        assert (t == 2.0).all()
    j = [jnp.asarray(a) for a in (meta, inv, order, aabb, tris, world)]
    r8 = jnp.asarray(rays8.numpy())
    if kernel == "k7":
        ref = jax_compact(j[0], j[1], j[2], j[3], j[4], r8, tile=TILE,
                          eps=1e-4, interpret=True, has_tmax=any_hit,
                          any_hit=any_hit)
    elif kernel == "k8":
        ref = jax_pallas(j[0], j[1], j[2], j[3], j[4], r8, tile=TILE,
                         eps=1e-4, interpret=True, has_tmax=any_hit)
    else:
        ref = jax_stream(j[0], j[1], j[3], j[4], j[5], r8, tile=TILE,
                         chunk=1, eps=1e-4, interpret=True,
                         has_tmax=any_hit,
                         cap=0 if kernel == "k6_cap0" else 32,
                         any_hit=any_hit)
    np.testing.assert_array_equal(t, np.asarray(ref[0]))
    if not parked:
        np.testing.assert_array_equal(tri, np.asarray(ref[1]))
        np.testing.assert_array_equal(obj, np.asarray(ref[2]))
