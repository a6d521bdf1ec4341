// Closest-hit intersection over 16-cluster chunks of a streamed scene:
// the chunk worklist sweep (kernel K5) and the (tiles x chunks) octant
// sweep (kernel K6), two entry points over one chunk test.
//
// K5 replaces logipathtracer_tpu/ops/pallas/compact_intersect.py::
// cluster_intersect_worklist -> _worklist_compact_kernel: each ray tile
// visits the chunks its per-ray prepass fired (build_chunk_worklists),
// front to back.  K6 replaces logipathtracer_tpu/ops/pallas/
// cluster_intersect.py::cluster_intersect_stream -> _stream_kernel
// (cap = 0) and compact_intersect.py::_stream_compact_kernel (cap > 0):
// each ray tile visits every chunk in the front-to-back order of the
// direction octant of its first ray; a tile whose every origin x is
// parked (live == 0) visits none.
//
// Per visited chunk, both re-test the chunk's world AABB against the
// world ray with the live best t (_slab); when some ray of the block
// passes, each member cluster c < num_real is visited as in K1 (local
// ray, _slab_inv, Moller-Trumbore; closest_hit.cuh).  K5 and K6's cap > 0
// body visit the members through compact_visit, the TPU kernel's own
// design (the rays that pass a member's slab compacted before the
// triangle tests): the passing rays are queued, whole warps test one
// queued ray each, and a member no ray passes is never read.  K6's
// cap = 0 body visits them through the sub-tile visit (subtile_visit):
// the gates of eight members are published by one barrier, and a
// member's 9 x S floats (18 KB at S = 512) are copied by cp.async only
// once some ray of the block passes its slab (a whole 16-cluster chunk
// is 288 KB, beyond a block's shared memory).
//
// K5 and K6 with cap > 0 keep K1's contract: best t starts at
// min(rays8[6], BIG) with has_tmax, else BIG; any-hit parking; miss
// t = INF, tri = obj = -1.  K6's cap = 0 body is another contract, held
// here by construction: best t starts at INF, or at rays8[6] unclamped
// with has_tmax; a cluster's triangle test runs for every ray of a
// 128-ray sub-tile (this body's block) when some ray of it passes the
// slab, not only for the rays that pass; any_hit is ignored; without
// has_tmax t is the best t as it stands.
//
// The TPU kernels take the chunk test over the whole tile; here it is
// taken over the block's rays.  The two differ only where a ray misses
// a chunk's world box but passes a member cluster's local box, which
// rounding alone can cause.
// Bound: operations, as for K1 (for the cap = 0 body every ray of a
// gated sub-tile runs the triangle test), plus each cluster block's load
// latency, which the prefetch of K5 and K6's cap > 0 body hides behind
// the previous member's tests (the cap = 0 body copies after the gate).

#include "closest_hit.cuh"

namespace {

using lpt::kBig;
using lpt::kInf;

// The cap = 0 body's form of subtile_visit (PERF.md: the forms
// measured): 8 gates a barrier, at most 80 registers a thread (6 blocks
// an SM).
constexpr int kSubtileBatch = 8;
constexpr int kSubtileMinBlocks = 6;

// K5's and K6's (cap > 0) form of compact_visit: the next member staged
// by cp.async a cluster ahead (PERF.md: <true, 1> and <false, 4>
// measured for each).
constexpr bool kPrefetch = true;
constexpr int kBatch = 1;

struct Scene {
  const int* meta;
  const float* inv;
  const float* aabb;
  const float* tris;
  const float* chunk_aabb;  // [NC, 6]: world min xyz, max xyz
  int S, chunk, num_real;
  float eps;
};

// The block-wide test of chunk jc's world box with the live best t,
// uniform over the block.
__device__ __forceinline__ bool chunk_passes(int jc, const Scene& sc,
                                             const lpt::Ray& w, float wix,
                                             float wiy, float wiz,
                                             float best) {
  return __syncthreads_or(
      lpt::slab_inv(w, wix, wiy, wiz, sc.chunk_aabb + 6 * jc, best));
}

// The member clusters of chunk jc below num_real: their count.
__device__ __forceinline__ int chunk_members(int jc, const Scene& sc) {
  return min(sc.chunk, sc.num_real - jc * sc.chunk);
}

// The chunks list[0 .. n) for the block's rays: per chunk the block-wide
// chunk test with the live best, then the members c < num_real through
// compact_visit (list and n block-uniform).
__device__ __forceinline__ void visit_chunks(const int* __restrict__ list,
                                             int n, const Scene& sc,
                                             const lpt::VisitQueue& q,
                                             const lpt::Ray& w, bool any_hit,
                                             float& best, int& btri,
                                             int& bobj) {
  const float wix = 1.0f / w.dx, wiy = 1.0f / w.dy, wiz = 1.0f / w.dz;
  for (int j = 0; j < n; ++j) {
    const int jc = list[j];
    if (!chunk_passes(jc, sc, w, wix, wiy, wiz, best)) continue;
    const int c0 = jc * sc.chunk;
    lpt::compact_visit<kPrefetch, kBatch>(
        [c0](int k) { return c0 + k; }, chunk_members(jc, sc), q, sc.tris,
        sc.S, sc.meta, sc.inv, sc.aabb, w, sc.eps, any_hit, best, btri,
        bobj);
  }
}

// K5: a block of blockDim.x <= 256 rays of one tile visits the tile's
// fired chunks wl[ti, :wn[ti]].  Launch bounds as K1's (64 registers);
// shared memory: visit_bytes.
__global__ void __launch_bounds__(256, 4)
    worklist_chunk_kernel(const float* __restrict__ rays8, int R,
                          const int* __restrict__ wl,
                          const int* __restrict__ wn, int NC, int tile,
                          Scene sc, int has_tmax, int any_hit,
                          float* __restrict__ t_out,
                          int* __restrict__ tri_out,
                          int* __restrict__ obj_out) {
  extern __shared__ __align__(16) float smem[];
  const lpt::VisitQueue q = lpt::carve_queue(smem, sc.S, blockDim.x, kPrefetch);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int ti = (blockIdx.x * blockDim.x) / tile;
  const lpt::Ray w = lpt::load_ray(rays8, R, r);
  float best = has_tmax ? lpt::nmin(rays8[6 * R + r], kBig) : kBig;
  int btri = -1, bobj = -1;
  visit_chunks(wl + static_cast<size_t>(ti) * NC, wn[ti], sc, q, w,
               any_hit != 0, best, btri, bobj);
  t_out[r] = btri >= 0 ? best : kInf;
  tri_out[r] = btri;
  obj_out[r] = bobj;
}

// K6's cap > 0 body: a block of blockDim.x <= 256 rays of one tile visits
// all NC chunks order[oct[ti], :], none when live[ti] == 0.  Launch
// bounds and shared memory as K5's.
__global__ void __launch_bounds__(256, 4)
    octant_compact_kernel(const float* __restrict__ rays8, int R,
                          const int* __restrict__ oct,
                          const int* __restrict__ order,
                          const int* __restrict__ live, int NC, int tile,
                          Scene sc, int has_tmax, int any_hit,
                          float* __restrict__ t_out,
                          int* __restrict__ tri_out,
                          int* __restrict__ obj_out) {
  extern __shared__ __align__(16) float smem[];
  const lpt::VisitQueue q = lpt::carve_queue(smem, sc.S, blockDim.x, kPrefetch);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int ti = (blockIdx.x * blockDim.x) / tile;
  const lpt::Ray w = lpt::load_ray(rays8, R, r);
  float best = has_tmax ? lpt::nmin(rays8[6 * R + r], kBig) : kBig;
  int btri = -1, bobj = -1;
  visit_chunks(order + static_cast<size_t>(oct[ti]) * NC, live[ti] ? NC : 0,
               sc, q, w, any_hit != 0, best, btri, bobj);
  t_out[r] = btri >= 0 ? best : kInf;
  tri_out[r] = btri;
  obj_out[r] = bobj;
}

// K6's cap = 0 body: a block of 128 rays (a sub-tile) of one tile visits
// all NC chunks order[oct[ti], :], none when live[ti] == 0; each chunk's
// members through the sub-tile visit.  Shared memory: subtile_bytes.
__global__ void __launch_bounds__(128, kSubtileMinBlocks)
    octant_chunk_kernel(const float* __restrict__ rays8, int R,
                        const int* __restrict__ oct,
                        const int* __restrict__ order,
                        const int* __restrict__ live, int NC, int tile,
                        Scene sc, int has_tmax, float* __restrict__ t_out,
                        int* __restrict__ tri_out,
                        int* __restrict__ obj_out) {
  extern __shared__ __align__(16) float stage[];  // [9, S]
  __shared__ int flags[64];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int ti = (blockIdx.x * blockDim.x) / tile;
  const lpt::Ray w = lpt::load_ray(rays8, R, r);
  const float wix = 1.0f / w.dx, wiy = 1.0f / w.dy, wiz = 1.0f / w.dz;
  float best = has_tmax ? rays8[6 * R + r] : kInf;
  int btri = -1, bobj = -1;
  if (live[ti]) {
    const int* ord = order + static_cast<size_t>(oct[ti]) * NC;
    for (int j = 0; j < NC; ++j) {
      const int jc = ord[j];
      if (!chunk_passes(jc, sc, w, wix, wiy, wiz, best)) continue;
      const int c0 = jc * sc.chunk;
      lpt::subtile_visit<kSubtileBatch>(
          [c0](int k) { return c0 + k; }, chunk_members(jc, sc), stage,
          flags, sc.tris, sc.S, sc.meta, sc.inv, sc.aabb, w, sc.eps, best,
          btri, bobj);
    }
  }
  t_out[r] = !has_tmax || btri >= 0 ? best : kInf;
  tri_out[r] = btri;
  obj_out[r] = bobj;
}

Scene make_scene(const void* meta, const void* inv, const void* aabb,
                 const void* tris, const void* chunk_aabb, int S, int chunk,
                 int num_real, float eps) {
  return Scene{static_cast<const int*>(meta),
               static_cast<const float*>(inv),
               static_cast<const float*>(aabb),
               static_cast<const float*>(tris),
               static_cast<const float*>(chunk_aabb),
               S, chunk, num_real, eps};
}

}  // namespace

// K5: per-tile fired-chunk lists wl [tiles, NC] / wn [tiles]; threads
// 128 or 256 (the chunk test's block, a divisor of tile).  The prefetch
// needs S a multiple of 4 and tris 16-byte aligned.
extern "C" int lpt_worklist_chunk_intersect(
    const void* rays8, int R, const void* wl, const void* wn, int NC,
    int tile, int chunk, int num_real, const void* chunk_aabb,
    const void* meta, const void* inv, const void* aabb, const void* tris,
    int S, float eps, int threads, int has_tmax, int any_hit, void* t,
    void* tri, void* obj, void* stream) {
  const Scene sc =
      make_scene(meta, inv, aabb, tris, chunk_aabb, S, chunk, num_real, eps);
  const size_t smem = lpt::visit_bytes(S, threads, kPrefetch, kBatch);
  const int e = lpt::prepare(worklist_chunk_kernel, smem);
  if (e) return e;
  worklist_chunk_kernel<<<R / threads, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rays8), R, static_cast<const int*>(wl),
      static_cast<const int*>(wn), NC, tile, sc, has_tmax, any_hit,
      static_cast<float*>(t), static_cast<int*>(tri), static_cast<int*>(obj));
  return static_cast<int>(cudaGetLastError());
}

// K6: per-tile octant oct [tiles], per-octant chunk order [8, NC], live
// flag [tiles]; subtile selects the cap = 0 body (threads must be 128;
// any_hit is ignored), else the cap > 0 body (threads 128 or 256, a
// divisor of tile).  Both stage by cp.async: S a multiple of 4, tris
// 16-byte aligned.
extern "C" int lpt_octant_chunk_intersect(
    const void* rays8, int R, const void* oct, const void* order,
    const void* live, int NC, int tile, int chunk, int num_real,
    const void* chunk_aabb, const void* meta, const void* inv,
    const void* aabb, const void* tris, int S, float eps, int threads,
    int subtile, int has_tmax, int any_hit, void* t, void* tri, void* obj,
    void* stream) {
  const Scene sc =
      make_scene(meta, inv, aabb, tris, chunk_aabb, S, chunk, num_real, eps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* rays = static_cast<const float*>(rays8);
  const int* oc = static_cast<const int*>(oct);
  const int* ord = static_cast<const int*>(order);
  const int* lv = static_cast<const int*>(live);
  float* t_out = static_cast<float*>(t);
  int* tri_out = static_cast<int*>(tri);
  int* obj_out = static_cast<int*>(obj);
  if (subtile) {
    const size_t smem = lpt::subtile_bytes(S);
    const int e = lpt::prepare(octant_chunk_kernel, smem);
    if (e) return e;
    octant_chunk_kernel<<<R / threads, threads, smem, st>>>(
        rays, R, oc, ord, lv, NC, tile, sc, has_tmax, t_out, tri_out,
        obj_out);
  } else {
    const size_t smem = lpt::visit_bytes(S, threads, kPrefetch, kBatch);
    const int e = lpt::prepare(octant_compact_kernel, smem);
    if (e) return e;
    octant_compact_kernel<<<R / threads, threads, smem, st>>>(
        rays, R, oc, ord, lv, NC, tile, sc, has_tmax, any_hit, t_out,
        tri_out, obj_out);
  }
  return static_cast<int>(cudaGetLastError());
}
