// Closest-hit intersection over per-tile frustum fired-cluster lists,
// cluster blocks streamed through a shared-memory ring (kernel K4).
//
// Replaces logipathtracer_tpu/ops/pallas/stream_cluster.py::
// cluster_intersect_stream_cl -> _cluster_wl_kernel, the intersect of
// scenes beyond the resident budget.  Its function is K1's (the per-ray
// core of closest_hit.cuh, K1's t_max / any-hit shadow modes
// included); only the worklist differs: each ray tile visits the
// clusters its frustum prepass fired (ops/kernels/stream_cluster.py::
// build_cluster_worklists), front to back.  Miss: t = INF, tri = obj =
// -1; best t starts at min(rays8[6], BIG) with has_tmax, else BIG.
//
// One thread per ray; a block holds `threads` consecutive rays of one
// tile and loops over the tile's list.  The TPU kernel streams each
// cluster's [16, S] block HBM -> VMEM through an NBUF-deep
// make_async_copy ring; here each cluster's 9 x S floats (18 KB at
// S = 512) arrive in a kStages-deep shared-memory ring by cp.async while
// the block tests the clusters before it, and a cluster is tested when
// some ray of the block passes its slab (__syncthreads_or).
// Bound: operations, as for K1 (~30 flops and one divide per
// ray-triangle test, shared-memory broadcasts of the triangles), plus
// the latency of each block load, which the ring hides behind the
// previous clusters' tests.  Every listed cluster is loaded, tested or
// not, as on the TPU.

#include "closest_hit.cuh"

namespace {
constexpr int kStages = 3;  // 3 x 18 KB of shared memory at S = 512
}  // namespace

// The kernel is closest_hit.cuh's cluster_list_kernel (K1's) with a
// kStages-deep cp.async ring.
extern "C" int lpt_stream_cluster_intersect(
    const void* rays8, int R, const void* wl, const void* wn, int C,
    int tile, const void* meta, const void* inv, const void* aabb,
    const void* tris, int S, float eps, int threads, int has_tmax,
    int any_hit, void* t, void* tri, void* obj, void* stream) {
  return lpt::launch_cluster_list<kStages>(
      rays8, R, wl, wn, C, tile, meta, inv, aabb, tris, S, eps, threads,
      has_tmax, any_hit, t, tri, obj, stream);
}
