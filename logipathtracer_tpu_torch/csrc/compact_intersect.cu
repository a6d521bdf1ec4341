// Closest-hit intersection over per-tile worklists of fired clusters
// (kernel K1), and the worklists themselves.
//
// Replaces logipathtracer_tpu/ops/pallas/compact_intersect.py::
// cluster_intersect_compact(worklist=True): its XLA prepass
// (build_chunk_worklists, :587-665) and its kernel (_compact_wl_kernel
// -> _compact_loop).  The function, not the TPU mechanics.
//
// The worklist kernel (lpt_build_worklists): one block per ray tile.
// Per ray, the world-space slab against each of the NC boxes, bounded by
// min(t_max, BIG) with has_tmax (the _slab_ok rule, no best > 0 guard),
// ORed over the tile into shared bit words with atomicOr (order-free, so
// exact); a thread skips a box its tile has already fired.  A thread
// holds one ray at a time, and a slab test takes the plain min/max and
// one NaN test in place of NaN-propagating ones (the same decisions).  The tile's
// mean direction is a fixed pairwise tree — adjacent pairs, the tile
// padded with -0.0 to a power of two, then divided by the tile — the
// tree build_chunk_worklists_plain writes out.  Keys (m0*c0 + m1*c1) +
// m2*c2 of the box centroids, +inf for an unfired box; each box's stable
// rank (keys below it, plus equal keys at a lower index, NaN above +inf
// as torch.sort orders it) places it in wl[ti, :], so the whole row
// equals the plain argsort.  wn[ti] counts the fired boxes.  Bound:
// operations, ~28 per (ray, box) slab test; the rank is NC^2 compares
// per tile, small beside it for the resident budget's few hundred
// clusters.
//
// K1 (lpt_compact_wl_intersect): per ray, visit the tile's fired
// clusters in worklist order; transform the ray into the cluster's
// object space; slab-test the cluster AABB against the running best t
// (the _slab_inv decision table with its best_t > 0 guard); on a pass,
// Moller-Trumbore against the cluster's S triangles, accepting t > eps
// and strictly closer than the best, so the lowest slot wins ties (the
// triangle test skips the 32-slot groups whose padded box the ray
// misses, which hold no triangle it could accept).  Miss: t = INF,
// tri = obj = -1.  Shadow queries (next-event estimation): with
// has_tmax the best t starts at min(rays8[6], BIG), so only hits closer
// than t_max count.  With any_hit as well, a lane's
// first accepted hit (lowest slot) parks its best t at -BIG (the TPU
// kernel's compact_intersect.py:243-250): every later slab test fails,
// and t comes out -BIG.  tri/obj are then not closest-hit values; only
// the predicate t < t_max is part of the contract.
//
// K1's design (closest_hit.cuh compact_list_kernel) is the TPU kernel's
// own: the rays of a 256-ray block that pass a cluster's slab are
// compacted — a warp ballot, a prefix, one offset per warp — into a
// shared-memory queue, and whole warps then test one queued ray each
// against the staged block: lane l slab-tests the box of the cluster's
// 32-slot group l (the groups that hold real slots), one ballot gives
// the groups the ray passes, and the warp runs Moller-Trumbore on their
// slots only, lane l on slot 32g + l, with a shuffle reduction to the
// lowest (t, slot) (warp_groups).  Bound: operations (~52 per
// ray-triangle test, one divide; 64 per group box).  A one-thread-per-ray
// visit makes a whole warp run all S tests whenever one lane passes; the
// queue makes the triangle tests proportional to the rays that pass,
// whatever warp they sit in, and the groups keep them to the slots near
// the ray (the padding of a sparse cluster is never tested).  nvcc
// -Xptxas -v (sm_90a, -fmad=false): K1 64 registers under its launch
// bounds (four blocks an SM), no spills; the worklist kernel 32, no
// spills.
//
// The per-ray core (local ray, _slab_inv, Moller-Trumbore, acceptance)
// lives in closest_hit.cuh, shared with K4-K8; it states the rounding
// rules (-fmad=false, IEEE divides, NaN-propagating min/max) that keep
// the slab decisions bit-identical to the plain version.

#include "closest_hit.cuh"

namespace {

using lpt::kBig;
using lpt::nmin;

// torch.sort's order: NaN above +inf, NaNs equal to each other.
__device__ __forceinline__ bool key_less(float a, float b) {
  return a < b || (a == a && b != b);
}
__device__ __forceinline__ bool key_equal(float a, float b) {
  return a == b || (a != a && b != b);
}

// The adjacent-pair tree over a warp's 32 values: lane 0 ends with
// ((v0 + v1) + (v2 + v3)) + ...
__device__ __forceinline__ float warp_tree(float v) {
  for (int s = 1; s < 32; s <<= 1)
    v = v + __shfl_down_sync(0xffffffffu, v, s);
  return v;
}

// One block per tile of `tile` rays (module note).  For the mean, the
// tile is padded to P = blockDim.x * K positions, a power of two, and
// thread t sums the positions t*K .. t*K + K - 1.  Shared memory: NC keys
// and ceil(NC/32) fired words.
template <int K>
__global__ void __launch_bounds__(1024, 2)
    worklist_kernel(const float* __restrict__ bmin,
                    const float* __restrict__ bmax, int NC,
                    const float* __restrict__ rays8, int R, int tile,
                    int has_tmax, int* __restrict__ wl, int* __restrict__ wn) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float warp_sum[3][32];
  __shared__ float mean[3];
  float* key = smem;
  unsigned* fired = reinterpret_cast<unsigned*>(key + NC);
  const int nt = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ti = blockIdx.x;
  const int words = (NC + 31) >> 5;
  for (int i = tid; i < words; i += nt) fired[i] = 0u;

  // The mean direction: the tree over the thread's K positions, then
  // over the warp, then over the warps (padded with -0.0 to 32).
  float sd[3][K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int p = tid * K + j;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      sd[a][j] = p < tile ? rays8[(3 + a) * R + ti * tile + p] : -0.0f;
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int s = 1; s < K; s <<= 1)
#pragma unroll
      for (int j = 0; j + s < K; j += 2 * s)
        sd[a][j] = sd[a][j] + sd[a][j + s];
    const float v = warp_tree(sd[a][0]);
    if (lane == 0) warp_sum[a][warp] = v;
  }
  __syncthreads();  // also publishes the cleared fired words
  if (warp == 0) {
    const int nwarps = nt >> 5;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float v = warp_tree(lane < nwarps ? warp_sum[a][lane] : -0.0f);
      if (lane == 0) mean[a] = v / static_cast<float>(tile);
    }
  }

  // The fired boxes: one ray at a time (32 registers, two blocks an SM),
  // every box its tile has not fired yet.
  volatile unsigned* seen = fired;
  for (int p = tid; p < tile; p += nt) {
    const int r = ti * tile + p;
    const float ox = rays8[0 * R + r], oy = rays8[1 * R + r],
                oz = rays8[2 * R + r];
    const float ix = 1.0f / rays8[3 * R + r], iy = 1.0f / rays8[4 * R + r],
                iz = 1.0f / rays8[5 * R + r];
    const float best = has_tmax ? nmin(rays8[6 * R + r], kBig) : kBig;
    for (int c = 0; c < NC; ++c) {
      if ((seen[c >> 5] >> (c & 31)) & 1u) continue;  // fired already
      const float nx = (bmin[3 * c] - ox) * ix, fx = (bmax[3 * c] - ox) * ix;
      const float ny = (bmin[3 * c + 1] - oy) * iy,
                  fy = (bmax[3 * c + 1] - oy) * iy;
      const float nz = (bmin[3 * c + 2] - oz) * iz,
                  fz = (bmax[3 * c + 2] - oz) * iz;
      // With a NaN among the six, the NaN-propagating t0 fails t0 <= t1:
      // test for it once, then take the plain min/max.
      const bool nan = nx != nx || fx != fx || ny != ny || fy != fy ||
                       nz != nz || fz != fz;
      const float t0 = fmaxf(fmaxf(fminf(nx, fx), fminf(ny, fy)),
                             fminf(nz, fz));
      const float t1 = fminf(fminf(fmaxf(nx, fx), fmaxf(ny, fy)),
                             fmaxf(nz, fz));
      if (!nan && (t0 <= t1) &&
          ((t0 > 0.0f && t0 < best) || (t0 <= 0.0f && t1 > 0.0f)))
        atomicOr(&fired[c >> 5], 1u << (c & 31));
    }
  }
  __syncthreads();

  const float m0 = mean[0], m1 = mean[1], m2 = mean[2];
  for (int c = tid; c < NC; c += nt) {
    const float c0 = 0.5f * (bmin[3 * c] + bmax[3 * c]);
    const float c1 = 0.5f * (bmin[3 * c + 1] + bmax[3 * c + 1]);
    const float c2 = 0.5f * (bmin[3 * c + 2] + bmax[3 * c + 2]);
    const bool f = (fired[c >> 5] >> (c & 31)) & 1u;
    key[c] = f ? (m0 * c0 + m1 * c1) + m2 * c2
               : __int_as_float(0x7f800000);
  }
  __syncthreads();
  int* row = wl + static_cast<size_t>(ti) * NC;
  for (int c = tid; c < NC; c += nt) {
    const float kc = key[c];
    int rank = 0;
    for (int c2 = 0; c2 < NC; ++c2) {
      const float k2 = key[c2];
      rank += key_less(k2, kc) || (c2 < c && key_equal(k2, kc));
    }
    row[rank] = c;
  }
  if (tid == 0) {
    int count = 0;
    for (int i = 0; i < words; ++i) count += __popc(fired[i]);
    wn[ti] = count;
  }
}

template <int K>
int launch_worklists(const float* bmin, const float* bmax, int NC,
                     const float* rays8, int R, int tile, int has_tmax,
                     int* wl, int* wn, int threads, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (NC + (NC + 31) / 32);
  const int e = lpt::prepare(worklist_kernel<K>, smem);
  if (e) return e;
  worklist_kernel<K><<<R / tile, threads, smem, stream>>>(
      bmin, bmax, NC, rays8, R, tile, has_tmax, wl, wn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The worklists of rays8 [8, R] (R a multiple of `tile`, 32 <= tile <=
// 8192) over NC boxes bmin / bmax [NC, 3]: wl [R/tile, NC] i32, wn
// [R/tile] i32.
extern "C" int lpt_build_worklists(const void* bmin, const void* bmax,
                                   int NC, const void* rays8, int R,
                                   int tile, int has_tmax, void* wl,
                                   void* wn, void* stream) {
  int p = 32;
  while (p < tile) p <<= 1;
  const int threads = p < 1024 ? p : 1024;
  const auto* mn = static_cast<const float*>(bmin);
  const auto* mx = static_cast<const float*>(bmax);
  const auto* r8 = static_cast<const float*>(rays8);
  auto* l = static_cast<int*>(wl);
  auto* n = static_cast<int*>(wn);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (p / threads) {
    case 1:
      return launch_worklists<1>(mn, mx, NC, r8, R, tile, has_tmax, l, n,
                                 threads, s);
    case 2:
      return launch_worklists<2>(mn, mx, NC, r8, R, tile, has_tmax, l, n,
                                 threads, s);
    case 4:
      return launch_worklists<4>(mn, mx, NC, r8, R, tile, has_tmax, l, n,
                                 threads, s);
    case 8:
      return launch_worklists<8>(mn, mx, NC, r8, R, tile, has_tmax, l, n,
                                 threads, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K1: closest_hit.cuh's compact_list_kernel.
extern "C" int lpt_compact_wl_intersect(
    const void* rays8, int R, const void* wl, const void* wn, int C,
    int tile, const void* meta, const void* inv, const void* aabb,
    const void* tris, int S, const void* gbox, const void* gn, int G,
    float eps, int threads, int has_tmax, int any_hit, void* t, void* tri,
    void* obj, void* stream) {
  return lpt::launch_compact_list(rays8, R, wl, wn, C, tile, meta, inv, aabb,
                                  tris, S, gbox, gn, G, eps, threads,
                                  has_tmax, any_hit, t, tri, obj, stream);
}
