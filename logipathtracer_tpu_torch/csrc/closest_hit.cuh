// The per-ray closest-hit core shared by the intersect kernels K1
// (compact_intersect.cu), K4 (stream_cluster.cu), K5 and K6
// (stream_chunk.cu), K7 and K8 (cluster_sweep.cu).  They compute one
// function with different cluster visit orders; this header holds the
// function, the one cluster-visit loop they all run (visit_clusters),
// the per-tile cluster-list kernel that K1 and K4 instantiate
// (cluster_list_kernel) and the per-octant order kernel of K7 and K8
// (cluster_order_kernel).
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

// _slab_inv: box[0:3] is the AABB's min corner, box[3:6] its max.
__device__ __forceinline__ bool slab_inv(const Ray& l, float ix, float iy,
                                         float iz,
                                         const float* __restrict__ box,
                                         float best) {
  const float nx = (box[0] - l.ox) * ix, fx = (box[3] - l.ox) * ix;
  const float ny = (box[1] - l.oy) * iy, fy = (box[4] - l.oy) * iy;
  const float nz = (box[2] - l.oz) * iz, fz = (box[5] - l.oz) * iz;
  const float t0 = nmax(nmax(nmin(nx, fx), nmin(ny, fy)), nmin(nz, fz));
  const float t1 = nmin(nmin(nmax(nx, fx), nmax(ny, fy)), nmax(nz, fz));
  return (t0 <= t1) && ((t0 > 0.0f && t0 < best) ||
                        (t0 <= 0.0f && t1 > 0.0f && best > 0.0f));
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

// ---- staging: cp.async ring (K4, K5, K6) or gate before load (K1) -------

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

// Visit n clusters, the k-th being cluster_at(k), for the block's rays.
// Every thread of the block makes the same n trips (n and cluster_at
// are block-uniform), so __syncthreads_or and the shared memory stay
// uniform; any-hit lanes that are blocked keep looping and fail every
// slab.  A cluster is tested when some ray of the block passes its slab
// (the block-uniform __syncthreads_or gate).  Its [9, S] block reaches
// shared memory in one of two ways:
//   kStages == 0 (gate before load, K1): copied into `ring` after the
//     gate passes, so a cluster no ray passes is never read;
//   kStages >= 2 (ring, K4-K6): copied into ring stage k % kStages with
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

// Closest hit over per-tile cluster lists (K1 with kStages == 0, K4 with
// a ring): one thread per ray, a block holds blockDim.x consecutive rays
// of one `tile`-ray tile and visits the tile's list wl[ti, :wn[ti]].
// Best t starts at min(rays8[6], kBig) with has_tmax, else kBig; miss:
// t = kInf, tri = obj = -1.
template <int kStages>
__global__ void cluster_list_kernel(const float* __restrict__ rays8, int R,
                                    const int* __restrict__ wl,
                                    const int* __restrict__ wn, int C,
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
  float best = has_tmax ? nmin(rays8[6 * R + r], kBig) : kBig;
  int btri = -1, bobj = -1;
  const int* list = wl + static_cast<size_t>(ti) * C;
  visit_clusters<kStages, false>([list](int k) { return list[k]; }, wn[ti],
                                 ring, tris, S, meta, inv, aabb, w, eps,
                                 any_hit != 0, best, btri, bobj);
  t_out[r] = btri >= 0 ? best : kInf;
  tri_out[r] = btri;
  obj_out[r] = bobj;
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

// ---- host side ------------------------------------------------------------

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

// Launch cluster_list_kernel<kStages> on `stream`; the C entry points of
// K1 and K4 (void* arguments, cudaGetLastError() returned).
template <int kStages>
inline int launch_cluster_list(const void* rays8, int R, const void* wl,
                               const void* wn, int C, int tile,
                               const void* meta, const void* inv,
                               const void* aabb, const void* tris, int S,
                               float eps, int threads, int has_tmax,
                               int any_hit, void* t, void* tri, void* obj,
                               void* stream) {
  const size_t smem = ring_bytes<kStages>(S);
  const int e = prepare(cluster_list_kernel<kStages>, smem);
  if (e) return e;
  cluster_list_kernel<kStages><<<R / threads, threads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rays8), R, static_cast<const int*>(wl),
      static_cast<const int*>(wn), C, tile, static_cast<const int*>(meta),
      static_cast<const float*>(inv), static_cast<const float*>(aabb),
      static_cast<const float*>(tris), S, eps, has_tmax, any_hit,
      static_cast<float*>(t), static_cast<int*>(tri), static_cast<int*>(obj));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lpt
