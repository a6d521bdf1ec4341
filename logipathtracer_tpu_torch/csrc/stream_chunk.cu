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
// ray, _slab_inv, Moller-Trumbore; closest_hit.cuh).  K5 visits the
// members through compact_visit, the TPU kernel's own design (the rays
// that pass a member's slab compacted before the triangle tests): the
// passing rays are queued, whole warps test one queued ray each, a
// member no ray passes is never read, and the next member that some ray
// may pass is staged by cp.async while the warps test the one before.
// K6 visits them one thread per ray (visit_clusters), each member's
// 9 x S floats staged in a cp.async ring (a whole 16-cluster chunk is
// 288 KB at S = 512, beyond a block's shared memory).
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
// Bound: operations, as for K1, plus each cluster block's load latency,
// which the prefetch (K5) or the ring (K6) hides behind the previous
// member's tests.

#include "closest_hit.cuh"

namespace {

using lpt::kBig;
using lpt::kInf;

constexpr int kStages = 3;

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

// K6's chunk: the chunk test, then the members one thread per ray.
template <bool kSubtile>
__device__ __forceinline__ void visit_chunk(int jc, const Scene& sc,
                                            float* ring, const lpt::Ray& w,
                                            float wix, float wiy, float wiz,
                                            bool any_hit, float& best,
                                            int& btri, int& bobj) {
  if (!chunk_passes(jc, sc, w, wix, wiy, wiz, best)) return;
  const int c0 = jc * sc.chunk;
  lpt::visit_clusters<kStages, kSubtile>(
      [c0](int k) { return c0 + k; }, chunk_members(jc, sc), ring, sc.tris,
      sc.S, sc.meta, sc.inv, sc.aabb, w, sc.eps, any_hit, best, btri, bobj);
}

// K5: a block of blockDim.x <= 256 rays of one tile visits the tile's
// fired chunks, each chunk's members through compact_visit with the
// prefetch (gates batched a barrier were measured slower, PERF.md).
// Launch bounds as K1's (64 registers); shared memory: visit_bytes.
__global__ void __launch_bounds__(256, 4)
    worklist_chunk_kernel(const float* __restrict__ rays8, int R,
                          const int* __restrict__ wl,
                          const int* __restrict__ wn, int NC, int tile,
                          Scene sc, int has_tmax, int any_hit,
                          float* __restrict__ t_out,
                          int* __restrict__ tri_out,
                          int* __restrict__ obj_out) {
  extern __shared__ __align__(16) float smem[];
  const lpt::VisitQueue q = lpt::carve_queue(smem, sc.S, blockDim.x, true);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int ti = (blockIdx.x * blockDim.x) / tile;
  const lpt::Ray w = lpt::load_ray(rays8, R, r);
  const float wix = 1.0f / w.dx, wiy = 1.0f / w.dy, wiz = 1.0f / w.dz;
  float best = has_tmax ? lpt::nmin(rays8[6 * R + r], kBig) : kBig;
  int btri = -1, bobj = -1;
  const int n = wn[ti];
  for (int j = 0; j < n; ++j) {
    const int jc = wl[static_cast<size_t>(ti) * NC + j];
    if (!chunk_passes(jc, sc, w, wix, wiy, wiz, best)) continue;
    const int c0 = jc * sc.chunk;
    lpt::compact_visit<true, 1>(
        [c0](int k) { return c0 + k; }, chunk_members(jc, sc), q, sc.tris,
        sc.S, sc.meta, sc.inv, sc.aabb, w, sc.eps, any_hit != 0, best, btri,
        bobj);
  }
  t_out[r] = btri >= 0 ? best : kInf;
  tri_out[r] = btri;
  obj_out[r] = bobj;
}

template <bool kSubtile>
__global__ void octant_chunk_kernel(const float* __restrict__ rays8, int R,
                                    const int* __restrict__ oct,
                                    const int* __restrict__ order,
                                    const int* __restrict__ live, int NC,
                                    int tile, Scene sc, int has_tmax,
                                    int any_hit, float* __restrict__ t_out,
                                    int* __restrict__ tri_out,
                                    int* __restrict__ obj_out) {
  extern __shared__ __align__(16) float ring[];  // [kStages, 9, S]
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int ti = (blockIdx.x * blockDim.x) / tile;
  const lpt::Ray w = lpt::load_ray(rays8, R, r);
  const float wix = 1.0f / w.dx, wiy = 1.0f / w.dy, wiz = 1.0f / w.dz;
  float best;
  if (kSubtile)
    best = has_tmax ? rays8[6 * R + r] : kInf;
  else
    best = has_tmax ? lpt::nmin(rays8[6 * R + r], kBig) : kBig;
  int btri = -1, bobj = -1;
  if (live[ti]) {
    const int* ord = order + static_cast<size_t>(oct[ti]) * NC;
    for (int j = 0; j < NC; ++j)
      visit_chunk<kSubtile>(ord[j], sc, ring, w, wix, wiy, wiz,
                            !kSubtile && any_hit != 0, best, btri, bobj);
  }
  t_out[r] = (kSubtile && !has_tmax) || btri >= 0 ? best : kInf;
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
  const size_t smem = lpt::visit_bytes(S, threads, true, 1);
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
// flag [tiles]; subtile selects the cap = 0 body (threads must be 128).
extern "C" int lpt_octant_chunk_intersect(
    const void* rays8, int R, const void* oct, const void* order,
    const void* live, int NC, int tile, int chunk, int num_real,
    const void* chunk_aabb, const void* meta, const void* inv,
    const void* aabb, const void* tris, int S, float eps, int threads,
    int subtile, int has_tmax, int any_hit, void* t, void* tri, void* obj,
    void* stream) {
  const size_t smem = lpt::ring_bytes<kStages>(S);
  const Scene sc =
      make_scene(meta, inv, aabb, tris, chunk_aabb, S, chunk, num_real, eps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (subtile) {
    const int e = lpt::prepare(octant_chunk_kernel<true>, smem);
    if (e) return e;
    octant_chunk_kernel<true><<<R / threads, threads, smem, st>>>(
        static_cast<const float*>(rays8), R, static_cast<const int*>(oct),
        static_cast<const int*>(order), static_cast<const int*>(live), NC,
        tile, sc, has_tmax, any_hit, static_cast<float*>(t),
        static_cast<int*>(tri), static_cast<int*>(obj));
  } else {
    const int e = lpt::prepare(octant_chunk_kernel<false>, smem);
    if (e) return e;
    octant_chunk_kernel<false><<<R / threads, threads, smem, st>>>(
        static_cast<const float*>(rays8), R, static_cast<const int*>(oct),
        static_cast<const int*>(order), static_cast<const int*>(live), NC,
        tile, sc, has_tmax, any_hit, static_cast<float*>(t),
        static_cast<int*>(tri), static_cast<int*>(obj));
  }
  return static_cast<int>(cudaGetLastError());
}
