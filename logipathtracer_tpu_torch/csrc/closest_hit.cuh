// The per-ray closest-hit core shared by the intersect kernels K1
// (compact_intersect.cu), K4 (stream_cluster.cu), K5 and K6
// (stream_chunk.cu), K7 and K8 (cluster_sweep.cu).  They compute one
// function with different cluster visit orders; this header holds the
// function, K1's kernel, whose visits queue the rays that pass a
// cluster's slab for whole warps to work through (compact_list_kernel),
// the same compacted visit for K4-K7 as a device function
// (compact_visit; K1 and K4 take the triangle test by 32-slot groups,
// warp_groups), and the sub-tile visit of K6's cap = 0 body and K8,
// where every ray of a 128-ray block runs a cluster's triangle test once
// one of them passes its slab (subtile_visit).
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
constexpr float kBig = 1e30f;    // internal miss sentinel of K1, K4-K7

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

// One triangle of a cluster block: v0.xyz, e1.xyz, e2.xyz.
struct Tri {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

// Moller-Trumbore in two parts, so that a caller may decide on u before
// the rest: mt_u computes the P vector, 1 / det, the T vector and u;
// mt_t the Q vector, v and t, and returns kInf on a barycentric miss.
struct MtU {
  float det, tx, ty, tz, u;
};
__device__ __forceinline__ MtU mt_u(const Tri& g, const Ray& l) {
  const float px = l.dy * g.e2z - l.dz * g.e2y;
  const float py = l.dz * g.e2x - l.dx * g.e2z;
  const float pz = l.dx * g.e2y - l.dy * g.e2x;
  MtU m;
  m.det = 1.0f / (g.e1x * px + g.e1y * py + g.e1z * pz);
  m.tx = l.ox - g.v0x;
  m.ty = l.oy - g.v0y;
  m.tz = l.oz - g.v0z;
  m.u = (m.tx * px + m.ty * py + m.tz * pz) * m.det;
  return m;
}
__device__ __forceinline__ float mt_t(const Tri& g, const Ray& l,
                                      const MtU& m) {
  const float qx = m.ty * g.e1z - m.tz * g.e1y;
  const float qy = m.tz * g.e1x - m.tx * g.e1z;
  const float qz = m.tx * g.e1y - m.ty * g.e1x;
  const float v = (l.dx * qx + l.dy * qy + l.dz * qz) * m.det;
  const float t = (g.e2x * qx + g.e2y * qy + g.e2z * qz) * m.det;
  return (m.u < 0.0f || m.u > 1.0f || v < 0.0f || m.u + v > 1.0f) ? kInf
                                                                   : t;
}

// Moller-Trumbore of ray l against slot s of a [9, S] cluster block;
// kInf on a barycentric miss.
__device__ __forceinline__ float mt(const float* tri, int S, int s,
                                    const Ray& l) {
  const Tri g{tri[0 * S + s], tri[1 * S + s], tri[2 * S + s],
              tri[3 * S + s], tri[4 * S + s], tri[5 * S + s],
              tri[6 * S + s], tri[7 * S + s], tri[8 * S + s]};
  return mt_t(g, l, mt_u(g, l));
}

// ---- staging: cp.async (K5, K6, K8) or plain loads (K1, K4, K7) ---------

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

// ---- the sub-tile visit (K6's cap = 0 body, K8) ---------------------------

// Slot s of the sub-tile visit for ray l: the triangle test and the
// sequential loop's acceptance (t > eps and strictly closer than the
// best: the lowest slot wins ties), left once u is rejected where that
// changes nothing: a rejected u makes the slot's t kInf, accepted only
// when kInf > eps (inf_eps) and kInf < best, a best that is still an
// infinite t_max.  A NaN u is not rejected.
__device__ __forceinline__ void subtile_slot(const Tri& g, const Ray& l,
                                             float eps, bool inf_eps, int s,
                                             float& best, int& slot) {
  const MtU m = mt_u(g, l);
  if ((m.u < 0.0f || m.u > 1.0f) && !(inf_eps && kInf < best)) return;
  const float t = mt_t(g, l, m);
  if (t > eps && t < best) {
    best = t;
    slot = s;
  }
}

// The S slots of a staged [9, S] block against ray l, four at a time
// from nine 16-byte loads (S a multiple of 4): the accepted slot (its t
// now the best) or -1.
__device__ __forceinline__ int test_staged(const float* st, int S,
                                           const Ray& l, float eps,
                                           bool inf_eps, float& best) {
  const float4* st4 = reinterpret_cast<const float4*>(st);
  const int S4 = S >> 2;
  int slot = -1;
  for (int s4 = 0; s4 < S4; ++s4) {
    float g[9][4];
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const float4 q = st4[j * S4 + s4];
      g[j][0] = q.x;
      g[j][1] = q.y;
      g[j][2] = q.z;
      g[j][3] = q.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      subtile_slot(Tri{g[0][i], g[1][i], g[2][i], g[3][i], g[4][i], g[5][i],
                       g[6][i], g[7][i], g[8][i]},
                   l, eps, inf_eps, 4 * s4 + i, best, slot);
  }
  return slot;
}

// Visit n clusters, the k-th being cluster_at(k), for a block of 128
// rays, one thread a ray: the sub-tile visit of K6's cap = 0 body and K8.
// n and cluster_at are block-uniform.  Once some ray of the block passes
// a cluster's slab against its running best, every ray of the block runs
// the cluster's triangle test over all S slots, not only the rays that
// pass.  Per batch of kBatch clusters k .. k + g - 1:
//   1. every thread decides its slab of each against its running best
//      (bit i for cluster k + i), the local ray and its reciprocals kept
//      while consecutive clusters share an object;
//   2. one barrier publishes the bits, ORed over each warp, in the row of
//      the batch's parity: a thread going on to the next batch writes
//      the other row while slower ones still read this one;
//   3. no ray passes any of them: the next batch.  Else the first
//      cluster some ray passes, f: no best changed on the clusters
//      before it, so each was decided against the best after the ones
//      before it, as the sequential loop decides.  Cluster f's [9, S]
//      block is copied by cp.async (16-byte pieces), a barrier publishes
//      it, and every thread tests the S slots four at a time
//      (test_staged).  The next batch starts after f.
// The stage is rewritten only after the next batch's barrier, which
// every thread reaches after its tests.  A cluster no ray of the block
// passes is never read.  The same slab decisions, the same
// Moller-Trumbore arithmetic and the same acceptance as the sequential
// loop: bit-identical results.  stage holds subtile_bytes(S) bytes,
// 16-byte aligned, S a multiple of 4 and tris 16-byte aligned; flags 64
// ints.
template <int kBatch, class ClusterAt>
__device__ __forceinline__ void subtile_visit(
    ClusterAt cluster_at, int n, float* stage, int* flags,
    const float* __restrict__ tris, int S, const int* __restrict__ meta,
    const float* __restrict__ inv, const float* __restrict__ aabb,
    const Ray& w, float eps, float& best, int& btri, int& bobj) {
  static_assert(kBatch >= 1 && kBatch <= 32, "a batch of 1 to 32 gates");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int blk = 9 * S;
  const bool inf_eps = kInf > eps;
  int cached = -1;
  float ix = 0.0f, iy = 0.0f, iz = 0.0f;
  Ray lc{};
  int batches = 0;
  for (int k = 0; k < n;) {
    const int g = min(kBatch, n - k);
    unsigned bits = 0;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (i < g) {
        const int c = cluster_at(k + i);
        const int obj = meta[2 * c];
        if (obj != cached) {
          cached = obj;
          lc = local_ray(inv + 12 * obj, w);
          ix = 1.0f / lc.dx;
          iy = 1.0f / lc.dy;
          iz = 1.0f / lc.dz;
        }
        float t0, t1;
        slab_range(lc, ix, iy, iz, aabb + 8 * c, t0, t1);
        bits |= slab_pass(t0, t1, best) ? 1u << i : 0u;
      }
    }
    int* f = flags + 32 * (batches++ & 1);
    const unsigned wb = __reduce_or_sync(0xffffffffu, bits);
    if (lane == 0) f[warp] = static_cast<int>(wb);
    __syncthreads();
    unsigned any = 0;
    for (int i = 0; i < nwarps; ++i) any |= static_cast<unsigned>(f[i]);
    if (!any) {  // block-uniform: no ray passes any of the g clusters
      k += g;
      continue;
    }
    k += __ffs(any) - 1;
    const int c = cluster_at(k);
    const float* src = tris + static_cast<size_t>(c) * blk;
    for (int i = 4 * threadIdx.x; i < blk; i += 4 * blockDim.x)
      cp_async16(stage + i, src + i);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int obj = meta[2 * c];
    const Ray l = obj == cached ? lc : local_ray(inv + 12 * obj, w);
    const int slot = test_staged(stage, S, l, eps, inf_eps, best);
    if (slot >= 0) {
      btri = meta[2 * c + 1] + slot;
      bobj = obj;
    }
    ++k;
  }
}

// ---- compacted visits (K1, K4-K7) ----------------------------------------

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

// A cluster's 32-slot groups (K1, K4): box [C, G, 8] f32, G = ceil(S /
// 32), group g's box (min.xyz, max.xyz, pad, pad) bounding v0, v0 + e1
// and v0 + e2 of its real slots 32g .. 32g + 31 in the cluster's object
// space, padded outward; n [C] i32, the groups that hold real slots
// (real slots are a prefix of the cluster, so these are groups 0 ..
// n - 1).  Built by ops/kernels/compact_intersect.py cluster_groups.
struct Groups {
  const float* box;
  const int* n;
  int G;
};

// warp_closest by groups: the triangle test of one queued ray by one
// warp against the n groups of a staged [9, S] block whose boxes
// (box[8 g .. 8 g + 5]) hold its real slots.  Lane l slab-tests the box
// of group g0 + l (32 groups at a time) against the ray's best, one
// ballot gives the groups it passes, and the warp runs Moller-Trumbore
// on their slots only, in ascending group order, lane l on slot 32g + l.
// A slot with eps < t < best lies in a box the ray passes (the boxes are
// padded beyond the rounding of either test), so a group it misses holds
// no slot that could be accepted: the answer is warp_closest's, bit for
// bit.  Closest hit: the lexicographic minimum of (t, slot) over the
// tested slots; any-hit: the lowest accepted slot of the first group
// holding one.  An empty group (g >= n) is never tested: its box is
// never read.
__device__ __forceinline__ int warp_groups(const float* tri, int S,
                                           const float* __restrict__ box,
                                           int n, const Ray& l, float eps,
                                           float best, bool any_hit,
                                           float& t_hit) {
  const int lane = threadIdx.x & 31;
  const float ix = 1.0f / l.dx, iy = 1.0f / l.dy, iz = 1.0f / l.dz;
  float tm = __int_as_float(0x7f800000);  // +inf: never < best
  int sm = 0x7fffffff;
  for (int g0 = 0; g0 < n; g0 += 32) {
    bool pass = false;
    if (g0 + lane < n) {
      float t0, t1;
      slab_range_one_nan(l, ix, iy, iz, box + 8 * (g0 + lane), t0, t1);
      pass = slab_pass(t0, t1, best);
    }
    for (unsigned m = __ballot_sync(0xffffffffu, pass); m; m &= m - 1) {
      const int s0 = 32 * (g0 + __ffs(m) - 1);
      const int s = s0 + lane;
      if (any_hit) {
        bool ok = false;
        if (s < S) {
          const float t = mt(tri, S, s, l);
          ok = t > eps && t < best;
        }
        const unsigned a = __ballot_sync(0xffffffffu, ok);
        if (a) return s0 + __ffs(a) - 1;
      } else if (s < S) {
        const float t = mt(tri, S, s, l);
        if (t > eps && t < tm) {
          tm = t;
          sm = s;
        }
      }
    }
  }
  if (any_hit) return -1;
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
//      against its running best;
//   2. the passing rays enter a shared-memory queue — a warp ballot, the
//      lane's prefix within it and the warp's offset from the per-warp
//      counts — with their local ray and best, each owner keeping its
//      queue position; nothing passes: next cluster, the triangles
//      never read;
//   3. the rows' prefix of the cluster's groups that hold real slots
//      (gn[c] groups of 32 slots) is staged with plain loads; warps take
//      queued rays in turn and run warp_groups on each: the ray's slab
//      against each group's box (gbox), then Moller-Trumbore on the
//      slots of the groups it passes only;
//   4. each owner reads its queued ray's answer and accepts it.
// The same slab decisions, the same Moller-Trumbore arithmetic and the
// same acceptance rule as the sequential loop: bit-identical results
// (warp_groups culls only groups that hold no slot it would accept).
// Any-hit parks an accepted lane's best at -kBig, which fails every
// later slab (slab_inv's best > 0 guard), so it is never queued again.
// Shared memory: compact_bytes(S, blockDim.x).  At most 256 threads, 64
// registers each (four blocks an SM).
__global__ void __launch_bounds__(256, 4)
    compact_list_kernel(const float* __restrict__ rays8, int R,
                        const int* __restrict__ wl,
                        const int* __restrict__ wn, int C, int tile,
                        const int* __restrict__ meta,
                        const float* __restrict__ inv,
                        const float* __restrict__ aabb,
                        const float* __restrict__ tris, int S,
                        const float* __restrict__ gbox,
                        const int* __restrict__ gn, int G, float eps,
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
    const int ng = gn[c];
    const int width = min(S, 32 * ng);  // the real slots' prefix a row
    const float* src = tris + static_cast<size_t>(c) * 9 * S;
    for (int i = threadIdx.x; i < width; i += nt) {
#pragma unroll
      for (int j = 0; j < 9; ++j) staged[j * S + i] = src[j * S + i];
    }
    __syncthreads();
    const float* box = gbox + static_cast<size_t>(c) * 8 * G;
    for (int q = warp; q < total; q += nwarps) {
      const Ray lq{q_ray[0 * nt + q], q_ray[1 * nt + q], q_ray[2 * nt + q],
                   q_ray[3 * nt + q], q_ray[4 * nt + q], q_ray[5 * nt + q]};
      float tq = 0.0f;
      const int slot = warp_groups(staged, S, box, ng, lq, eps, q_best[q],
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
// pass each one's slab compacted into a queue (K4-K7; K1's
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
// kGroups (gate then load, K4): step 3 stages only the rows' prefix of
// the cluster's groups that hold real slots (groups.n; S a multiple of 4
// and tris 16-byte aligned, 16-byte pieces), and the warps run
// warp_groups in place of warp_closest.
// A gate publishes its counts with one barrier; a tested cluster adds
// two (block staged and queue written; answers written).  K4 runs it as
// <false, 4, true>, K5 as <true, 1>, K6 (cap > 0) and K7 as their
// sources say: the fastest forms measured on the card for each
// (PERF.md).
template <bool kPrefetch, int kBatch, bool kGroups = false, class ClusterAt>
__device__ __forceinline__ void compact_visit(
    ClusterAt cluster_at, int n, const VisitQueue& q,
    const float* __restrict__ tris, int S, const int* __restrict__ meta,
    const float* __restrict__ inv, const float* __restrict__ aabb,
    const Ray& w, float eps, bool any_hit, float& best, int& btri,
    int& bobj, const Groups& groups = Groups{}) {
  static_assert(kBatch >= 1 && kBatch <= 32 && (!kPrefetch || kBatch == 1),
                "a batch of up to 32 gates, or a prefetch");
  static_assert(!kPrefetch || !kGroups, "groups stage after the gate");
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
    int ng = 0;  // the cluster's groups that hold real slots (kGroups)
    if constexpr (kPrefetch) {
      cp_async_wait<1>();  // this thread's copy of cluster k landed
      staged = q.stage + (k & 1) * blk;
    } else if constexpr (kGroups) {
      ng = groups.n[c];
      const int w4 = min(S, 32 * ng) >> 2, s4 = S >> 2;  // float4s a row
      const float4* src = reinterpret_cast<const float4*>(
          tris + static_cast<size_t>(c) * blk);
      float4* dst = reinterpret_cast<float4*>(q.stage);
      for (int i = threadIdx.x; i < 9 * w4; i += nt) {
        const int row = i / w4, at = row * s4 + (i - row * w4);
        dst[at] = src[at];
      }
    } else {
      const float* src = tris + static_cast<size_t>(c) * blk;
      for (int i = threadIdx.x; i < blk; i += nt) q.stage[i] = src[i];
    }
    __syncthreads();
    for (int j = warp; j < total; j += nwarps) {
      const Ray lq{q.ray[0 * nt + j], q.ray[1 * nt + j], q.ray[2 * nt + j],
                   q.ray[3 * nt + j], q.ray[4 * nt + j], q.ray[5 * nt + j]};
      float tq = 0.0f;
      int slot;
      if constexpr (kGroups)
        slot = warp_groups(staged, S,
                           groups.box + static_cast<size_t>(c) * 8 * groups.G,
                           ng, lq, eps, q.best[j], any_hit, tq);
      else
        slot = warp_closest(staged, S, lq, eps, q.best[j], any_hit, tq);
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

// Dynamic shared memory of subtile_visit: one [9, S] block.
inline size_t subtile_bytes(int S) {
  return sizeof(float) * 9 * static_cast<size_t>(S);
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
                               const void* gbox, const void* gn, int G,
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
      static_cast<const float*>(tris), S, static_cast<const float*>(gbox),
      static_cast<const int*>(gn), G, eps, has_tmax, any_hit,
      static_cast<float*>(t), static_cast<int*>(tri), static_cast<int*>(obj));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lpt
