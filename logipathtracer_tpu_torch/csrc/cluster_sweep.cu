// Closest hit visiting every resident cluster in the front-to-back order
// of the direction octant of each ray tile's first ray: the compact sweep
// without worklists (kernel K7) and the dense resident sweep (kernel K8),
// one entry point over two kernels.
//
// K7 replaces logipathtracer_tpu/ops/pallas/compact_intersect.py::
// cluster_intersect_compact(worklist=False) -> _compact_kernel ->
// _compact_loop: K1's contract (best t from min(t_max, BIG) with
// has_tmax, else BIG; any-hit parking at -BIG; miss t = INF,
// tri = obj = -1; the lowest slot of the earlier-visited cluster wins
// ties) with the visit order cl_order[oct] in place of a worklist, so no
// per-ray prepass runs.  The tile is compact_tile (4096 rays); blocks of
// 256 rays.  Its design is K4's (stream_cluster.cu): closest_hit.cuh's
// compact_visit, the rays of a block that pass a cluster's slab queued
// for whole warps, a cluster no ray of the block passes never read.  K7
// lists every cluster, so most of its gates pass no ray: kBatch of them
// share one barrier.
//
// K8 replaces logipathtracer_tpu/ops/pallas/cluster_intersect.py::
// cluster_intersect_pallas -> _kernel -> _mt_subtile_update: the
// function of K6's cap = 0 body with cl_order in place of chunks — best
// t from INF, or from rays8[6] unclamped with has_tmax; once some ray of
// a 128-ray sub-tile passes a cluster's slab, every ray of the sub-tile
// runs the triangle test; any_hit is ignored; t is the best as it stands
// without has_tmax, INF where no hit was accepted with it.  The tile is
// sweep_tile (1024 rays); blocks of 128 rays, so a block is a sub-tile:
// closest_hit.cuh subtile_visit, its gate the sub-tile gate, taken for
// four clusters a barrier, each gated cluster's block copied by cp.async
// after its gate.  The TPU kernel's tile-wide gate contains the sub-tile
// gate, so it decides nothing more.
//
// The octant belongs to the tile, not to the block: the host side
// computes oct [tiles] from each tile's first ray (a parked lane, with
// direction (1, 1, 1), gives octant 7; a pad ray, (0, 0, 1), octant 1).
// No tile is skipped.  Each cluster's 9 x S floats (9 KB at S = 256)
// reach shared memory only for a block some ray of which passes its
// slab: all 86 blocks of the flagship box sit in L2.  Bound: operations
// (~64 per slab test, ~52 per ray-triangle test of every ray of a gated
// sub-tile).

#include "closest_hit.cuh"

namespace {

using lpt::kBig;
using lpt::kInf;

// K7's form of compact_visit (PERF.md: <false, 4> and <true, 1>
// measured).
constexpr bool kPrefetch = false;
constexpr int kBatch = 4;

// K8's form of subtile_visit (PERF.md: the forms measured): 4 gates a
// barrier, at most 64 registers a thread (8 blocks an SM).
constexpr int kSubtileBatch = 4;
constexpr int kSubtileMinBlocks = 8;

// K7: a block of blockDim.x <= 256 consecutive rays of one `tile`-ray
// tile visits all C clusters order[oct[ti], :].  Launch bounds as K1's
// (64 registers); shared memory: visit_bytes.
__global__ void __launch_bounds__(256, 4)
    order_visit_kernel(const float* __restrict__ rays8, int R,
                       const int* __restrict__ oct,
                       const int* __restrict__ order, int C, int tile,
                       const int* __restrict__ meta,
                       const float* __restrict__ inv,
                       const float* __restrict__ aabb,
                       const float* __restrict__ tris, int S, float eps,
                       int has_tmax, int any_hit, float* __restrict__ t_out,
                       int* __restrict__ tri_out,
                       int* __restrict__ obj_out) {
  extern __shared__ __align__(16) float smem[];
  const int nt = blockDim.x;
  const lpt::VisitQueue q = lpt::carve_queue(smem, S, nt, kPrefetch);
  const int r = blockIdx.x * nt + threadIdx.x;
  const int ti = (blockIdx.x * nt) / tile;
  const lpt::Ray w = lpt::load_ray(rays8, R, r);
  float best = has_tmax ? lpt::nmin(rays8[6 * R + r], kBig) : kBig;
  int btri = -1, bobj = -1;
  const int* ord = order + static_cast<size_t>(oct[ti]) * C;
  lpt::compact_visit<kPrefetch, kBatch>([ord](int k) { return ord[k]; }, C,
                                        q, tris, S, meta, inv, aabb, w, eps,
                                        any_hit != 0, best, btri, bobj);
  t_out[r] = btri >= 0 ? best : kInf;
  tri_out[r] = btri;
  obj_out[r] = bobj;
}

// K8: a block of 128 consecutive rays of one `tile`-ray tile visits all C
// clusters order[oct[ti], :] through the sub-tile visit.  Shared memory:
// subtile_bytes.
__global__ void __launch_bounds__(128, kSubtileMinBlocks)
    cluster_order_kernel(const float* __restrict__ rays8, int R,
                         const int* __restrict__ oct,
                         const int* __restrict__ order, int C, int tile,
                         const int* __restrict__ meta,
                         const float* __restrict__ inv,
                         const float* __restrict__ aabb,
                         const float* __restrict__ tris, int S, float eps,
                         int has_tmax, float* __restrict__ t_out,
                         int* __restrict__ tri_out,
                         int* __restrict__ obj_out) {
  extern __shared__ __align__(16) float stage[];  // [9, S]
  __shared__ int flags[64];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int ti = (blockIdx.x * blockDim.x) / tile;
  const lpt::Ray w = lpt::load_ray(rays8, R, r);
  float best = has_tmax ? rays8[6 * R + r] : kInf;
  int btri = -1, bobj = -1;
  const int* ord = order + static_cast<size_t>(oct[ti]) * C;
  lpt::subtile_visit<kSubtileBatch>(
      [ord](int k) { return ord[k]; }, C, stage, flags, tris, S, meta, inv,
      aabb, w, eps, best, btri, bobj);
  t_out[r] = !has_tmax || btri >= 0 ? best : kInf;
  tri_out[r] = btri;
  obj_out[r] = bobj;
}

}  // namespace

// Per-tile octant oct [tiles], per-octant cluster order [8, C]; subtile
// selects K8 (threads must be 128; any_hit is ignored; S a multiple of 4
// and tris 16-byte aligned), else K7 (threads 128 or 256, a divisor of
// tile).
extern "C" int lpt_cluster_order_intersect(
    const void* rays8, int R, const void* oct, const void* order, int C,
    int tile, const void* meta, const void* inv, const void* aabb,
    const void* tris, int S, float eps, int threads, int subtile,
    int has_tmax, int any_hit, void* t, void* tri, void* obj, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* rays = static_cast<const float*>(rays8);
  const int* oc = static_cast<const int*>(oct);
  const int* ord = static_cast<const int*>(order);
  const int* m = static_cast<const int*>(meta);
  const float* iv = static_cast<const float*>(inv);
  const float* box = static_cast<const float*>(aabb);
  const float* tr = static_cast<const float*>(tris);
  float* t_out = static_cast<float*>(t);
  int* tri_out = static_cast<int*>(tri);
  int* obj_out = static_cast<int*>(obj);
  if (subtile) {
    const size_t smem = lpt::subtile_bytes(S);
    const int e = lpt::prepare(cluster_order_kernel, smem);
    if (e) return e;
    cluster_order_kernel<<<R / threads, threads, smem, st>>>(
        rays, R, oc, ord, C, tile, m, iv, box, tr, S, eps, has_tmax, t_out,
        tri_out, obj_out);
  } else {
    const size_t smem = lpt::visit_bytes(S, threads, kPrefetch, kBatch);
    const int e = lpt::prepare(order_visit_kernel, smem);
    if (e) return e;
    order_visit_kernel<<<R / threads, threads, smem, st>>>(
        rays, R, oc, ord, C, tile, m, iv, box, tr, S, eps, has_tmax, any_hit,
        t_out, tri_out, obj_out);
  }
  return static_cast<int>(cudaGetLastError());
}
