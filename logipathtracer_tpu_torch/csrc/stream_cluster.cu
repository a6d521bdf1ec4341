// Closest-hit intersection over per-tile frustum fired-cluster lists of
// a streamed scene (kernel K4).
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
// The design is the TPU kernel's own (stream_cluster.py:195-204, the
// hit rays compacted behind pl.when(jnp.any(hit))): a block of `threads`
// consecutive rays of one tile per CUDA block, through closest_hit.cuh's
// compact_visit.  Per listed cluster the rays that pass its slab are
// queued and whole warps test one queued ray each, 32 slots at a time;
// a cluster no ray of the block passes is never read.  The TPU kernel
// streams each cluster's [16, S] block HBM -> VMEM through an NBUF-deep
// make_async_copy ring; here a cluster's 9 x S floats (18 KB at S = 512)
// are read into shared memory once some ray of the block passes its
// slab (a cp.async prefetch a cluster ahead was measured slower,
// PERF.md).  Bound: operations (~52 per ray-triangle test and ~64 per
// ray-cluster slab test, one divide and three reciprocals).  An
// incoherent tile lists most of the scene's clusters (up to 991 of 1,233
// on an outside bounce tile), most of which no ray of a block passes:
// the gates of kBatch clusters share one barrier.
//
// A second, finer cull inside the triangle test: a cluster's slots
// follow its BVH subtree's leaf order, so 32 consecutive slots are
// spatially compact.  A warp that takes a queued ray slab-tests the boxes
// of the cluster's 32-slot groups first, one a lane, and runs
// Moller-Trumbore only on the slots of the groups the ray passes
// (closest_hit.cuh warp_groups); only the groups that hold real slots
// are staged and tested (ops/kernels/stream_cluster.py cluster_groups).
// The same hits, bit for bit.

#include "closest_hit.cuh"

namespace {

using lpt::kBig;
using lpt::kInf;

constexpr int kBatch = 4;  // gates a barrier (PERF.md: 1, 2, 4, 8 measured)

// A block of blockDim.x <= 256 consecutive rays of one `tile`-ray tile
// (a multiple of the block) visits the tile's list wl[ti, :wn[ti]] in
// order.  Launch bounds as K1's (64 registers); shared memory:
// visit_bytes.  gbox [C, G, 8], gn [C]: the clusters' groups
// (lpt::Groups).
__global__ void __launch_bounds__(256, 4)
    visit_list_kernel(const float* __restrict__ rays8, int R,
                      const int* __restrict__ wl, const int* __restrict__ wn,
                      int C, int tile, const int* __restrict__ meta,
                      const float* __restrict__ inv,
                      const float* __restrict__ aabb,
                      const float* __restrict__ tris, int S,
                      const float* __restrict__ gbox,
                      const int* __restrict__ gn, int G, float eps,
                      int has_tmax, int any_hit, float* __restrict__ t_out,
                      int* __restrict__ tri_out,
                      int* __restrict__ obj_out) {
  extern __shared__ __align__(16) float smem[];
  const int nt = blockDim.x;
  const lpt::VisitQueue q = lpt::carve_queue(smem, S, nt, false);
  const int r = blockIdx.x * nt + threadIdx.x;
  const int ti = (blockIdx.x * nt) / tile;
  const lpt::Ray w = lpt::load_ray(rays8, R, r);
  float best = has_tmax ? lpt::nmin(rays8[6 * R + r], kBig) : kBig;
  int btri = -1, bobj = -1;
  const int* list = wl + static_cast<size_t>(ti) * C;
  lpt::compact_visit<false, kBatch, true>(
      [list](int k) { return list[k]; }, wn[ti], q, tris, S, meta, inv,
      aabb, w, eps, any_hit != 0, best, btri, bobj,
      lpt::Groups{gbox, gn, G});
  t_out[r] = btri >= 0 ? best : kInf;
  tri_out[r] = btri;
  obj_out[r] = bobj;
}

}  // namespace

// threads: 128 or 256 rays a block (a divisor of tile).  S a multiple
// of 4 and tris 16-byte aligned.
extern "C" int lpt_stream_cluster_intersect(
    const void* rays8, int R, const void* wl, const void* wn, int C,
    int tile, const void* meta, const void* inv, const void* aabb,
    const void* tris, int S, const void* gbox, const void* gn, int G,
    float eps, int threads, int has_tmax, int any_hit, void* t, void* tri,
    void* obj, void* stream) {
  const size_t smem = lpt::visit_bytes(S, threads, false, kBatch);
  const int e = lpt::prepare(visit_list_kernel, smem);
  if (e) return e;
  visit_list_kernel<<<R / threads, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rays8), R, static_cast<const int*>(wl),
      static_cast<const int*>(wn), C, tile, static_cast<const int*>(meta),
      static_cast<const float*>(inv), static_cast<const float*>(aabb),
      static_cast<const float*>(tris), S, static_cast<const float*>(gbox),
      static_cast<const int*>(gn), G, eps, has_tmax, any_hit,
      static_cast<float*>(t), static_cast<int*>(tri), static_cast<int*>(obj));
  return static_cast<int>(cudaGetLastError());
}
