// The per-ray closest-hit core shared by the intersect kernels K1
// (compact_intersect.cu), K4 (stream_cluster.cu), K5 and K6
// (stream_chunk.cu), K7 and K8 (cluster_sweep.cu).  They compute one
// function with different cluster visit orders; this header holds the
// function, the one-thread-per-ray cluster-visit loop of K6-K8
// (visit_clusters), the per-octant order kernel of K7 and K8
// (cluster_order_kernel), K1's kernel, whose visits queue the rays that
// pass a cluster's slab for whole warps to work through
// (compact_list_kernel), and the same compacted visit for K4 and K5 as
// a device function (compact_visit).
//
// Per ray and visited cluster: transform the ray into the cluster
// object's space; slab-test the cluster AABB against the running best t
// (the _slab_inv decision table of logipathtracer_tpu/ops/pallas/
// cluster_intersect.py, with its best_t > 0 guard); on a pass,
// Moller-Trumbore against the cluster's S triangles ([9, S] component
// rows v0.xyz, e1.xyz, e2.xyz), accepting t > eps and strictly closer
// than the best, so the lowest slot wins ties.  With any_hit the first
// accepted hit parks the best t at -kBig: every later slab test fails.
//
// Sources including this header build with -fmad=false and no fast
// math: every product and sum is rounded as in the plain PyTorch
// versions, divides are IEEE (1/0 = inf for axis-aligned directions),
// and min/max propagate NaN as torch and XLA do, so slab decisions
// match bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace lpt {

constexpr float kInf = 3.4e38f;  // miss t (shaders/common/constants.glsl:9)
constexpr float kBig = 1e30f;    // internal miss sentinel of K1, K4, K5

__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// Ray r of a component-major [8, R] ray block.
__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays8,
                                        int R, int r) {
  return Ray{rays8[0 * R + r], rays8[1 * R + r], rays8[2 * R + r],
             rays8[3 * R + r], rays8[4 * R + r], rays8[5 * R + r]};
}

// The ray in object space: m holds the object's 3x4 inverse rows.
__device__ __forceinline__ Ray local_ray(const float* __restrict__ m,
                                         const Ray& w) {
  return Ray{m[0] * w.ox + m[1] * w.oy + m[2] * w.oz + m[3],
             m[4] * w.ox + m[5] * w.oy + m[6] * w.oz + m[7],
             m[8] * w.ox + m[9] * w.oy + m[10] * w.oz + m[11],
             m[0] * w.dx + m[1] * w.dy + m[2] * w.dz,
             m[4] * w.dx + m[5] * w.dy + m[6] * w.dz,
             m[8] * w.dx + m[9] * w.dy + m[10] * w.dz};
}

// _slab_inv in two steps: the entry and exit t of the ray through the
// AABB (box[0:3] its min corner, box[3:6] its max), then the decision
// against the running best.  The decision only narrows as the best
// falls (a closer hit, or any-hit parking at -kBig): a slab that fails
// against one best fails against every later one.
__device__ __forceinline__ void slab_range(const Ray& l, float ix, float iy,
                                           float iz,
                                           const float* __restrict__ box,
                                           float& t0, float& t1) {
  const float nx = (box[0] - l.ox) * ix, fx = (box[3] - l.ox) * ix;
  const float ny = (box[1] - l.oy) * iy, fy = (box[4] - l.oy) * iy;
  const float nz = (box[2] - l.oz) * iz, fz = (box[5] - l.oz) * iz;
  t0 = nmax(nmax(nmin(nx, fx), nmin(ny, fy)), nmin(nz, fz));
  t1 = nmin(nmin(nmax(nx, fx), nmax(ny, fy)), nmax(nz, fz));
}
// slab_range with one NaN test in place of the NaN-propagating min/max
// (compact_visit's form): a NaN among the six plane distances makes t0
// and t1 NaN, as there; without one the plain min/max give the same
// values.
__device__ __forceinline__ void slab_range_one_nan(
    const Ray& l, float ix, float iy, float iz,
    const float* __restrict__ box, float& t0, float& t1) {
  const float nx = (box[0] - l.ox) * ix, fx = (box[3] - l.ox) * ix;
  const float ny = (box[1] - l.oy) * iy, fy = (box[4] - l.oy) * iy;
  const float nz = (box[2] - l.oz) * iz, fz = (box[5] - l.oz) * iz;
  const bool nan = nx != nx || fx != fx || ny != ny || fy != fy ||
                   nz != nz || fz != fz;
  const float q = __int_as_float(0x7fc00000);
  t0 = nan ? q : fmaxf(fmaxf(fminf(nx, fx), fminf(ny, fy)), fminf(nz, fz));
  t1 = nan ? q : fminf(fminf(fmaxf(nx, fx), fmaxf(ny, fy)), fmaxf(nz, fz));
}
__device__ __forceinline__ bool slab_pass(float t0, float t1, float best) {
  return (t0 <= t1) && ((t0 > 0.0f && t0 < best) ||
                        (t0 <= 0.0f && t1 > 0.0f && best > 0.0f));
}
__device__ __forceinline__ bool slab_inv(const Ray& l, float ix, float iy,
                                         float iz,
                                         const float* __restrict__ box,
                                         float best) {
  float t0, t1;
  slab_range(l, ix, iy, iz, box, t0, t1);
  return slab_pass(t0, t1, best);
}

// Moller-Trumbore of ray l against slot s of a [9, S] cluster block;
// kInf on a barycentric miss.
__device__ __forceinline__ float mt(const float* tri, int S, int s,
                                    const Ray& l) {
  const float v0x = tri[0 * S + s], v0y = tri[1 * S + s],
              v0z = tri[2 * S + s];
  const float e1x = tri[3 * S + s], e1y = tri[4 * S + s],
              e1z = tri[5 * S + s];
  const float e2x = tri[6 * S + s], e2y = tri[7 * S + s],
              e2z = tri[8 * S + s];
  const float px = l.dy * e2z - l.dz * e2y;
  const float py = l.dz * e2x - l.dx * e2z;
  const float pz = l.dx * e2y - l.dy * e2x;
  const float det = 1.0f / (e1x * px + e1y * py + e1z * pz);
  const float tx = l.ox - v0x, ty = l.oy - v0y, tz = l.oz - v0z;
  const float u = (tx * px + ty * py + tz * pz) * det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (l.dx * qx + l.dy * qy + l.dz * qz) * det;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * det;
  return (u < 0.0f || u > 1.0f || v < 0.0f || u + v > 1.0f) ? kInf : t;
}

// The S triangles of one staged cluster against ray l: accept t > eps
// strictly closer than best (lowest slot on ties); any_hit parks best
// at -kBig on the first accepted hit.
__device__ __forceinline__ void closest_in_cluster(
    const float* tri, int S, const Ray& l, float eps, int base, int obj,
    bool any_hit, float& best, int& btri, int& bobj) {
  for (int s = 0; s < S; ++s) {
    const float t = mt(tri, S, s, l);
    if (t > eps && t < best) {
      best = t;
      btri = base + s;
      bobj = obj;
      if (any_hit) {
        best = -kBig;  // blocked: no later test can pass
        break;
      }
    }
  }
}

// ---- staging: cp.async (K4, K5, K6) or plain loads (K1, K7, K8) ---------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Visit n clusters, the k-th being cluster_at(k), for the block's rays,
// one thread per ray (K6, K7, K8).
// Every thread of the block makes the same n trips (n and cluster_at
// are block-uniform), so __syncthreads_or and the shared memory stay
// uniform; any-hit lanes that are blocked keep looping and fail every
// slab.  A cluster is tested when some ray of the block passes its slab
// (the block-uniform __syncthreads_or gate).  Its [9, S] block reaches
// shared memory in one of two ways:
//   kStages == 0 (gate before load, K7, K8): copied into `ring` after
//     the gate passes, so a cluster no ray passes is never read;
//   kStages >= 2 (ring, K6): copied into ring stage k % kStages with
//     cp.async kStages - 1 trips ahead, while the block tests the
//     clusters before it; every listed cluster is loaded, tested or not.
// kSubtile (K6's cap=0 body): every ray of the block runs the triangle
// test, not only the rays whose own slab passed.  ring holds
// ring_bytes<kStages>(S) bytes, 16-byte aligned; with a ring, S is a
// multiple of 4.
template <int kStages, bool kSubtile, class ClusterAt>
__device__ __forceinline__ void visit_clusters(
    ClusterAt cluster_at, int n, float* ring, const float* __restrict__ tris,
    int S, const int* __restrict__ meta, const float* __restrict__ inv,
    const float* __restrict__ aabb, const Ray& w, float eps, bool any_hit,
    float& best, int& btri, int& bobj) {
  static_assert(kStages == 0 || kStages >= 2, "gate-first or a ring");
  const int blk = 9 * S;
  auto issue = [&](int k) {
    const float* src = tris + static_cast<size_t>(cluster_at(k)) * blk;
    float* dst = ring + (k % (kStages > 0 ? kStages : 1)) * blk;
    for (int i = 4 * threadIdx.x; i < blk; i += 4 * blockDim.x)
      cp_async16(dst + i, src + i);
  };
  if constexpr (kStages > 0) {
    for (int k = 0; k < kStages - 1; ++k) {
      if (k < n) issue(k);
      cp_async_commit();
    }
  }
  for (int k = 0; k < n; ++k) {
    if constexpr (kStages > 0) {
      if (k + kStages - 1 < n) issue(k + kStages - 1);
      cp_async_commit();  // possibly empty: keeps the group count uniform
    }
    const int c = cluster_at(k);
    const int obj = meta[2 * c];
    const int base = meta[2 * c + 1];
    const Ray l = local_ray(inv + 12 * obj, w);
    const bool hit = slab_inv(l, 1.0f / l.dx, 1.0f / l.dy, 1.0f / l.dz,
                              aabb + 8 * c, best);
    if constexpr (kStages > 0)
      cp_async_wait<kStages - 1>();  // this thread's copies of cluster k
    if (!__syncthreads_or(hit)) continue;  // also publishes ring copies
    const float* staged = ring;
    if constexpr (kStages > 0) {
      staged = ring + (k % kStages) * blk;
    } else {
      const float* src = tris + static_cast<size_t>(c) * blk;
      for (int i = threadIdx.x; i < blk; i += blockDim.x) ring[i] = src[i];
      __syncthreads();
    }
    if (kSubtile || hit)
      closest_in_cluster(staged, S, l, eps, base, obj,
                         kSubtile ? false : any_hit, best, btri, bobj);
    __syncthreads();  // the staged block is rewritten on a later trip
  }
  if constexpr (kStages > 0) cp_async_wait<0>();
}

// Closest hit visiting every cluster in a per-octant order (K7 with
// kSubtile false, K8 with kSubtile true; gate before load): one thread
// per ray, a block holds blockDim.x consecutive rays of one `tile`-ray
// tile and visits all C clusters order[oct[ti], :].  oct [tiles] is the
// direction octant of each tile's first ray, computed on the host side:
// the octant belongs to the whole tile, not to the block.
// kSubtile false (K7): K1's contract — best t from min(rays8[6], kBig)
// with has_tmax, else kBig; any-hit parking; miss t = kInf.
// kSubtile true (K8, 128-thread blocks = the TPU kernel's 128-ray
// sub-tiles): best t from rays8[6] unclamped with has_tmax, else kInf;
// every ray of the block runs the triangle test once some ray passes the
// slab; any_hit ignored; t is the best as it stands without has_tmax,
// kInf where no hit was accepted with it.
template <bool kSubtile>
__global__ void cluster_order_kernel(const float* __restrict__ rays8, int R,
                                     const int* __restrict__ oct,
                                     const int* __restrict__ order, int C,
                                     int tile, const int* __restrict__ meta,
                                     const float* __restrict__ inv,
                                     const float* __restrict__ aabb,
                                     const float* __restrict__ tris, int S,
                                     float eps, int has_tmax, int any_hit,
                                     float* __restrict__ t_out,
                                     int* __restrict__ tri_out,
                                     int* __restrict__ obj_out) {
  extern __shared__ __align__(16) float ring[];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int ti = (blockIdx.x * blockDim.x) / tile;
  const Ray w = load_ray(rays8, R, r);
  float best;
  if (kSubtile)
    best = has_tmax ? rays8[6 * R + r] : kInf;
  else
    best = has_tmax ? nmin(rays8[6 * R + r], kBig) : kBig;
  int btri = -1, bobj = -1;
  const int* ord = order + static_cast<size_t>(oct[ti]) * C;
  visit_clusters<0, kSubtile>([ord](int k) { return ord[k]; }, C, ring,
                              tris, S, meta, inv, aabb, w, eps, any_hit != 0,
                              best, btri, bobj);
  t_out[r] = (kSubtile && !has_tmax) || btri >= 0 ? best : kInf;
  tri_out[r] = btri;
  obj_out[r] = bobj;
}

// ---- compacted visits (K1, K4, K5) ---------------------------------------

// The triangle test of one queued ray by one warp.  Lane l tests slots
// l, l + 32, ... of the staged [9, S] block (consecutive lanes read
// consecutive words: no bank conflicts).  Closest hit: the lexicographic
// minimum of (t, slot) over t > eps, reduced over the warp with
// shuffles, accepted when t < best — the sequential loop's answer, since
// a strict < against the best keeps the lowest slot of equal t.
// Any-hit: the lowest slot with eps < t < best, found 32 slots at a time
// by a ballot.  Returns the accepted slot (and its t), or -1; every lane
// returns the same.
__device__ __forceinline__ int warp_closest(const float* tri, int S,
                                            const Ray& l, float eps,
                                            float best, bool any_hit,
                                            float& t_hit) {
  const int lane = threadIdx.x & 31;
  if (any_hit) {
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      bool ok = false;
      if (s < S) {
        const float t = mt(tri, S, s, l);
        ok = t > eps && t < best;
      }
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      if (m) return s0 + __ffs(m) - 1;
    }
    return -1;
  }
  float tm = __int_as_float(0x7f800000);  // +inf: never < best
  int sm = 0x7fffffff;
  for (int s = lane; s < S; s += 32) {
    const float t = mt(tri, S, s, l);
    if (t > eps && t < tm) {
      tm = t;
      sm = s;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ot = __shfl_xor_sync(0xffffffffu, tm, o);
    const int os = __shfl_xor_sync(0xffffffffu, sm, o);
    if (ot < tm || (ot == tm && os < sm)) {
      tm = ot;
      sm = os;
    }
  }
  t_hit = tm;
  return tm < best ? sm : -1;
}

// Closest hit over per-tile cluster lists with the rays that pass each
// cluster's slab compacted into a queue (K1).  One thread per ray owns
// its best (t, tri, obj); a block holds blockDim.x consecutive rays of
// one `tile`-ray tile (a multiple of 32) and visits the tile's list
// wl[ti, :wn[ti]] in order.  Per listed cluster:
//   1. every thread transforms its ray and slab-tests the cluster AABB
//      against its running best (as visit_clusters does);
//   2. the passing rays enter a shared-memory queue — a warp ballot, the
//      lane's prefix within it and the warp's offset from the per-warp
//      counts — with their local ray and best, each owner keeping its
//      queue position; nothing passes: next cluster, the triangles
//      never read;
//   3. the cluster's [9, S] block is staged; warps take queued rays in
//      turn and run warp_closest on each;
//   4. each owner reads its queued ray's answer and accepts it.
// The same slab decisions, the same Moller-Trumbore arithmetic and the
// same acceptance rule as the sequential loop: bit-identical results.
// Any-hit parks an accepted lane's best at -kBig, which fails every
// later slab (slab_inv's best > 0 guard), so it is never queued again.
// Shared memory: compact_bytes(S, blockDim.x).  At most 256 threads, 64
// registers each (four blocks an SM): ptxas would take 83 and fit three.
__global__ void __launch_bounds__(256, 4)
    compact_list_kernel(const float* __restrict__ rays8, int R,
                        const int* __restrict__ wl,
                        const int* __restrict__ wn, int C, int tile,
                        const int* __restrict__ meta,
                        const float* __restrict__ inv,
                        const float* __restrict__ aabb,
                        const float* __restrict__ tris, int S, float eps,
                        int has_tmax, int any_hit, float* __restrict__ t_out,
                        int* __restrict__ tri_out,
                        int* __restrict__ obj_out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int warp_count[2][32];  // by trip parity: see the note below
  const int nt = blockDim.x;
  float* staged = smem;              // [9, S]
  float* q_ray = staged + 9 * S;     // [6, nt]: local o.xyz, d.xyz
  float* q_best = q_ray + 6 * nt;    // [nt]
  float* q_t = q_best + nt;          // [nt] accepted t
  int* q_slot = reinterpret_cast<int*>(q_t + nt);  // [nt] slot or -1
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = nt >> 5;
  const int r = blockIdx.x * nt + threadIdx.x;
  const int ti = (blockIdx.x * nt) / tile;
  const Ray w = load_ray(rays8, R, r);
  float best = has_tmax ? nmin(rays8[6 * R + r], kBig) : kBig;
  int btri = -1, bobj = -1;
  const int* list = wl + static_cast<size_t>(ti) * C;
  const int n = wn[ti];
  for (int k = 0; k < n; ++k) {
    const int c = list[k];
    const int obj = meta[2 * c];
    const int base = meta[2 * c + 1];
    const Ray l = local_ray(inv + 12 * obj, w);
    const bool hit = slab_inv(l, 1.0f / l.dx, 1.0f / l.dy, 1.0f / l.dz,
                              aabb + 8 * c, best);
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    // The counts alternate between two rows: a thread that finds an
    // empty queue goes on to the next trip and writes its count while
    // slower threads still read this trip's.
    int* cnt = warp_count[k & 1];
    if (lane == 0) cnt[warp] = __popc(mask);
    __syncthreads();
    int offset = 0, total = 0;
    for (int i = 0; i < nwarps; ++i) {
      const int v = cnt[i];
      offset += i < warp ? v : 0;
      total += v;
    }
    if (total == 0) continue;  // block-uniform
    const int pos = offset + __popc(mask & ((1u << lane) - 1u));
    if (hit) {
      q_ray[0 * nt + pos] = l.ox;
      q_ray[1 * nt + pos] = l.oy;
      q_ray[2 * nt + pos] = l.oz;
      q_ray[3 * nt + pos] = l.dx;
      q_ray[4 * nt + pos] = l.dy;
      q_ray[5 * nt + pos] = l.dz;
      q_best[pos] = best;
    }
    const float* src = tris + static_cast<size_t>(c) * 9 * S;
    for (int i = threadIdx.x; i < 9 * S; i += nt) staged[i] = src[i];
    __syncthreads();
    for (int q = warp; q < total; q += nwarps) {
      const Ray lq{q_ray[0 * nt + q], q_ray[1 * nt + q], q_ray[2 * nt + q],
                   q_ray[3 * nt + q], q_ray[4 * nt + q], q_ray[5 * nt + q]};
      float tq = 0.0f;
      const int slot = warp_closest(staged, S, lq, eps, q_best[q],
                                    any_hit != 0, tq);
      if (lane == 0) {
        q_slot[q] = slot;
        q_t[q] = tq;
      }
    }
    __syncthreads();  // answers published; the queue is rewritten next trip
    if (hit && q_slot[pos] >= 0) {
      best = any_hit ? -kBig : q_t[pos];
      btri = base + q_slot[pos];
      bobj = obj;
    }
  }
  t_out[r] = btri >= 0 ? best : kInf;
  tri_out[r] = btri;
  obj_out[r] = bobj;
}

// The shared memory of compact_visit, carved from a block's dynamic
// shared memory (16-byte aligned): the staged [9, S] cluster block (two
// of them with a prefetch), a queue of one entry per thread (the local
// ray o.xyz, d.xyz, the owner's best, the accepted t and slot) and the
// per-warp pass counts, [2, batch, 32] by gate parity.
struct VisitQueue {
  float* stage;  // [1 or 2, 9, S]
  float* ray;    // [6, nt]
  float* best;   // [nt]
  float* t;      // [nt]
  int* slot;     // [nt]
  int* count;    // [2, batch, 32]
};

__device__ __forceinline__ VisitQueue carve_queue(float* smem, int S,
                                                  int nt, bool prefetch) {
  VisitQueue q;
  q.stage = smem;
  q.ray = smem + (prefetch ? 2 : 1) * 9 * S;
  q.best = q.ray + 6 * nt;
  q.t = q.best + nt;
  q.slot = reinterpret_cast<int*>(q.t + nt);
  q.count = q.slot + nt;
  return q;
}

// Visit n clusters, the k-th being cluster_at(k), with the rays that
// pass each one's slab compacted into a queue (K4, K5; K1's
// compact_list_kernel makes the same visit in a loop of its own).  One
// thread per ray owns its best (t, tri, obj); n and cluster_at are
// block-uniform.  Per cluster:
//   1. every thread slab-tests the cluster AABB against its running
//      best, the best as it stands after the previous cluster;
//   2. the passing rays enter the queue — a warp ballot, the lane's
//      prefix within it and the warp's offset from the per-warp counts —
//      each owner keeping its queue position; nothing passes: next
//      cluster, the triangles never read;
//   3. the cluster's [9, S] block is staged; warps take queued rays in
//      turn and run warp_closest on each;
//   4. each owner reads its queued ray's answer and accepts it.
// The same slab decisions, the same Moller-Trumbore arithmetic and the
// same acceptance rule as the sequential loop: bit-identical results.
// Any-hit parks an accepted lane's best at -kBig, which fails every
// later slab (slab_pass's best > 0 guard), so it is never queued again.
//
// The counts of step 2 cost a barrier.  kBatch > 1 takes step 1 for the
// next kBatch clusters at once, against the best as it stands, and
// publishes their counts with one barrier: the clusters before the
// first one that some ray passes are skipped, and since no best changed
// on them, each was decided against the best after the clusters before
// it; the gate starts again after the cluster the warps tested.
//
// The block is staged in one of two ways:
//   kPrefetch false (gate then load): plain loads once step 2 found the
//     queue not empty;
//   kPrefetch true (kBatch 1): a trip ahead, by cp.async into stage
//     k & 1, while the warps test the cluster before it.  The copy is
//     issued when some ray passes the next cluster's slab against its
//     best before this cluster's update: a superset of the rays that pass
//     against the updated best (the decision only narrows as the best
//     falls), so every cluster the block tests has been copied.  The
//     decision of step 1 is still taken against the updated best.  S is
//     then a multiple of 4 and tris 16-byte aligned.
// A gate publishes its counts with one barrier; a tested cluster adds
// two (block staged and queue written; answers written).  K4 runs it as
// <false, 4>, K5 as <true, 1>: the fastest forms measured on the card
// for each (PERF.md).
template <bool kPrefetch, int kBatch, class ClusterAt>
__device__ __forceinline__ void compact_visit(
    ClusterAt cluster_at, int n, const VisitQueue& q,
    const float* __restrict__ tris, int S, const int* __restrict__ meta,
    const float* __restrict__ inv, const float* __restrict__ aabb,
    const Ray& w, float eps, bool any_hit, float& best, int& btri,
    int& bobj) {
  static_assert(kBatch >= 1 && kBatch <= 32 && (!kPrefetch || kBatch == 1),
                "a batch of up to 32 gates, or a prefetch");
  const int nt = blockDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = nt >> 5;
  const int blk = 9 * S;
  // The local ray and its reciprocals belong to the object, not the
  // cluster: kept while consecutive clusters share the object (obj is
  // block-uniform, so the branch is too).
  int cached = -1;
  float ix = 0.0f, iy = 0.0f, iz = 0.0f;
  Ray lc{};
  auto slab = [&](int c, Ray& l, float& t0, float& t1) {
    const int obj = meta[2 * c];
    if (obj != cached) {
      cached = obj;
      lc = local_ray(inv + 12 * obj, w);
      ix = 1.0f / lc.dx;
      iy = 1.0f / lc.dy;
      iz = 1.0f / lc.dz;
    }
    l = lc;
    slab_range_one_nan(lc, ix, iy, iz, aabb + 8 * c, t0, t1);
  };
  auto issue = [&](int k) {  // cluster k's block into stage k & 1
    const float* src = tris + static_cast<size_t>(cluster_at(k)) * blk;
    float* dst = q.stage + (k & 1) * blk;
    for (int i = 4 * threadIdx.x; i < blk; i += 4 * nt)
      cp_async16(dst + i, src + i);
  };
  float next_t0 = 0.0f, next_t1 = 0.0f;  // the slab of cluster k + 1
  if constexpr (kPrefetch) {
    if (n > 0) {
      Ray l;
      slab(cluster_at(0), l, next_t0, next_t1);
      if (__syncthreads_or(slab_pass(next_t0, next_t1, best))) issue(0);
    }
    cp_async_commit();
  }
  int gates = 0;  // the parity of the count rows
  for (int k = 0; k < n;) {
    // Step 1 for clusters k .. k + g - 1: bit i of `bits` for k + i.
    const int g = min(kBatch, n - k);
    unsigned bits = 0;
    bool ahead = false;  // may pass cluster k + 1 (kPrefetch)
    Ray lk;              // the local ray of cluster k (kBatch 1)
    if constexpr (kPrefetch) {
      bits = slab_pass(next_t0, next_t1, best);
      if (k + 1 < n) {
        slab(cluster_at(k + 1), lk, next_t0, next_t1);
        ahead = slab_pass(next_t0, next_t1, best);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (i < g) {
          float t0, t1;
          slab(cluster_at(k + i), lk, t0, t1);
          bits |= slab_pass(t0, t1, best) ? 1u << i : 0u;
        }
      }
    }
    // The counts alternate between two rows: a thread that finds every
    // queue empty goes on to the next gate and writes its counts while
    // slower threads still read this gate's.  Bit 6 flags a warp with a
    // ray ahead.
    int* cnt = q.count + 32 * kBatch * (gates++ & 1);
    unsigned mask = 0;  // the warp's passes of cluster k (kBatch 1)
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (i < g) {
        const unsigned m = __ballot_sync(0xffffffffu, (bits >> i) & 1u);
        int flag = 0;
        if constexpr (kPrefetch)
          flag = __ballot_sync(0xffffffffu, ahead) ? 64 : 0;
        if (lane == 0) cnt[32 * i + warp] = __popc(m) | flag;
        if (i == 0) mask = m;
      }
    }
    __syncthreads();
    int first = g, total = 0, offset = 0, any_ahead = 0;
    for (int i = 0; i < g && first == g; ++i) {
      int sum = 0, before = 0;
      for (int j = 0; j < nwarps; ++j) {
        const int v = cnt[32 * i + j];
        before += j < warp ? (v & 63) : 0;
        sum += v & 63;
        any_ahead |= v & 64;
      }
      if (sum) {
        first = i;
        total = sum;
        offset = before;
      }
    }
    if constexpr (kPrefetch) {
      cp_async_wait<1>();  // this thread's copy into stage (k + 1) & 1 landed
      if (any_ahead) issue(k + 1);
      cp_async_commit();  // possibly empty: keeps the group count uniform
    }
    k += first;
    if (first == g) continue;  // block-uniform: nothing passes
    // Steps 2-4 for cluster k.
    const int c = cluster_at(k);
    const bool hit = (bits >> first) & 1u;
    if constexpr (kBatch > 1) mask = __ballot_sync(0xffffffffu, hit);
    const int pos = offset + __popc(mask & ((1u << lane) - 1u));
    if (hit) {
      if constexpr (kPrefetch || kBatch > 1)
        lk = local_ray(inv + 12 * meta[2 * c], w);
      q.ray[0 * nt + pos] = lk.ox;
      q.ray[1 * nt + pos] = lk.oy;
      q.ray[2 * nt + pos] = lk.oz;
      q.ray[3 * nt + pos] = lk.dx;
      q.ray[4 * nt + pos] = lk.dy;
      q.ray[5 * nt + pos] = lk.dz;
      q.best[pos] = best;
    }
    const float* staged = q.stage;
    if constexpr (kPrefetch) {
      cp_async_wait<1>();  // this thread's copy of cluster k landed
      staged = q.stage + (k & 1) * blk;
    } else {
      const float* src = tris + static_cast<size_t>(c) * blk;
      for (int i = threadIdx.x; i < blk; i += nt) q.stage[i] = src[i];
    }
    __syncthreads();
    for (int j = warp; j < total; j += nwarps) {
      const Ray lq{q.ray[0 * nt + j], q.ray[1 * nt + j], q.ray[2 * nt + j],
                   q.ray[3 * nt + j], q.ray[4 * nt + j], q.ray[5 * nt + j]};
      float tq = 0.0f;
      const int slot = warp_closest(staged, S, lq, eps, q.best[j], any_hit,
                                    tq);
      if (lane == 0) {
        q.slot[j] = slot;
        q.t[j] = tq;
      }
    }
    __syncthreads();  // answers published; the queue is rewritten next trip
    if (hit && q.slot[pos] >= 0) {
      best = any_hit ? -kBig : q.t[pos];
      btri = meta[2 * c + 1] + q.slot[pos];
      bobj = meta[2 * c];
    }
    ++k;
  }
  if constexpr (kPrefetch) cp_async_wait<0>();
}

// ---- host side ------------------------------------------------------------

// Dynamic shared memory of compact_list_kernel: the staged [9, S] block
// and a queue of `threads` entries (6 ray floats, best, t, slot).
inline size_t compact_bytes(int S, int threads) {
  return sizeof(float) * (9 * static_cast<size_t>(S) +
                          9 * static_cast<size_t>(threads));
}
// Dynamic shared memory of compact_visit (VisitQueue).
inline size_t visit_bytes(int S, int threads, bool prefetch, int batch) {
  return sizeof(float) * ((prefetch ? 2 : 1) * 9 * static_cast<size_t>(S) +
                          9 * static_cast<size_t>(threads) + 64 * batch);
}

// Dynamic shared memory of visit_clusters: one [9, S] block, or kStages.
template <int kStages>
inline size_t ring_bytes(int S) {
  return sizeof(float) * (kStages > 0 ? kStages : 1) * 9 *
         static_cast<size_t>(S);
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <class Kernel>
inline int prepare(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// Launch compact_list_kernel on `stream`; the C entry point of K1
// (void* arguments, cudaGetLastError() returned).
inline int launch_compact_list(const void* rays8, int R, const void* wl,
                               const void* wn, int C, int tile,
                               const void* meta, const void* inv,
                               const void* aabb, const void* tris, int S,
                               float eps, int threads, int has_tmax,
                               int any_hit, void* t, void* tri, void* obj,
                               void* stream) {
  const size_t smem = compact_bytes(S, threads);
  const int e = prepare(compact_list_kernel, smem);
  if (e) return e;
  compact_list_kernel<<<R / threads, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rays8), R, static_cast<const int*>(wl),
      static_cast<const int*>(wn), C, tile, static_cast<const int*>(meta),
      static_cast<const float*>(inv), static_cast<const float*>(aabb),
      static_cast<const float*>(tris), S, eps, has_tmax, any_hit,
      static_cast<float*>(t), static_cast<int*>(tri), static_cast<int*>(obj));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lpt
