// Closest-hit intersection over per-tile worklists of fired clusters
// (kernel K1).
//
// Replaces logipathtracer_tpu/ops/pallas/compact_intersect.py::
// cluster_intersect_compact(worklist=True) -> _compact_wl_kernel.  The
// function, not the TPU mechanics: per ray, visit the tile's fired
// clusters in worklist order; transform the ray into the cluster's
// object space; slab-test the cluster AABB against the running best t
// (the _slab_inv decision table with its best_t > 0 guard); on a pass,
// Moller-Trumbore against the cluster's S triangles, accepting t > eps
// and strictly closer than the best, so the lowest slot wins ties.
// Miss: t = INF, tri = obj = -1.
//
// Shadow queries (next-event estimation): with has_tmax the best t
// starts at min(rays8[6], BIG), so only hits closer than t_max count.
// With any_hit as well, a lane's first accepted hit parks its best t at
// -BIG (the TPU kernel's compact_intersect.py:243-250): every later slab
// test fails, while the thread still takes part in __syncthreads_or, and
// t comes out -BIG.  tri/obj are then not closest-hit values; only the
// predicate t < t_max is part of the contract.
//
// One thread per ray; a block holds `threads` consecutive rays of one
// worklist tile.  A fired cluster's 9 x S triangle floats are staged in
// shared memory only when some ray of the block passes its slab.
// Bound: operations (~30 flops and one divide per ray-triangle test);
// triangle reads are shared-memory broadcasts.  Divergence between rays
// of a warp that pass different clusters is not addressed.
//
// Built with -fmad=false and no fast math: every product and sum is
// rounded as in the plain PyTorch version, divides are IEEE (1/0 = inf
// for axis-aligned directions), and min/max propagate NaN as torch and
// XLA do, so the slab decisions match bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr float kInf = 3.4e38f;
constexpr float kBig = 1e30f;

__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__global__ void compact_wl_kernel(const float* __restrict__ rays8, int R,
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
  extern __shared__ float smem[];  // [9, S]
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int ti = (blockIdx.x * blockDim.x) / tile;
  const float ox = rays8[0 * R + r], oy = rays8[1 * R + r],
              oz = rays8[2 * R + r];
  const float dx = rays8[3 * R + r], dy = rays8[4 * R + r],
              dz = rays8[5 * R + r];
  float best = has_tmax ? nmin(rays8[6 * R + r], kBig) : kBig;
  int btri = -1, bobj = -1;
  const int n = wn[ti];
  for (int k = 0; k < n; ++k) {
    const int c = wl[ti * C + k];
    const int obj = meta[2 * c];
    const int base = meta[2 * c + 1];
    const float* m = inv + 12 * obj;
    const float lox = m[0] * ox + m[1] * oy + m[2] * oz + m[3];
    const float loy = m[4] * ox + m[5] * oy + m[6] * oz + m[7];
    const float loz = m[8] * ox + m[9] * oy + m[10] * oz + m[11];
    const float ldx = m[0] * dx + m[1] * dy + m[2] * dz;
    const float ldy = m[4] * dx + m[5] * dy + m[6] * dz;
    const float ldz = m[8] * dx + m[9] * dy + m[10] * dz;
    const float ix = 1.0f / ldx, iy = 1.0f / ldy, iz = 1.0f / ldz;
    const float* a = aabb + 8 * c;
    const float nx = (a[0] - lox) * ix, fx = (a[3] - lox) * ix;
    const float ny = (a[1] - loy) * iy, fy = (a[4] - loy) * iy;
    const float nz = (a[2] - loz) * iz, fz = (a[5] - loz) * iz;
    const float t0 = nmax(nmax(nmin(nx, fx), nmin(ny, fy)), nmin(nz, fz));
    const float t1 = nmin(nmin(nmax(nx, fx), nmax(ny, fy)), nmax(nz, fz));
    const bool hit = (t0 <= t1) && ((t0 > 0.0f && t0 < best) ||
                                    (t0 <= 0.0f && t1 > 0.0f && best > 0.0f));
    if (!__syncthreads_or(hit)) continue;  // uniform over the block
    const float* src = tris + static_cast<size_t>(c) * 9 * S;
    for (int i = threadIdx.x; i < 9 * S; i += blockDim.x) smem[i] = src[i];
    __syncthreads();
    if (hit) {
      for (int s = 0; s < S; ++s) {
        const float v0x = smem[0 * S + s], v0y = smem[1 * S + s],
                    v0z = smem[2 * S + s];
        const float e1x = smem[3 * S + s], e1y = smem[4 * S + s],
                    e1z = smem[5 * S + s];
        const float e2x = smem[6 * S + s], e2y = smem[7 * S + s],
                    e2z = smem[8 * S + s];
        const float px = ldy * e2z - ldz * e2y;
        const float py = ldz * e2x - ldx * e2z;
        const float pz = ldx * e2y - ldy * e2x;
        const float det = 1.0f / (e1x * px + e1y * py + e1z * pz);
        const float tx = lox - v0x, ty = loy - v0y, tz = loz - v0z;
        const float u = (tx * px + ty * py + tz * pz) * det;
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float v = (ldx * qx + ldy * qy + ldz * qz) * det;
        float t = (e2x * qx + e2y * qy + e2z * qz) * det;
        if (u < 0.0f || u > 1.0f || v < 0.0f || u + v > 1.0f) t = kInf;
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
    __syncthreads();  // smem is rewritten by the next fired cluster
  }
  t_out[r] = btri >= 0 ? best : kInf;
  tri_out[r] = btri;
  obj_out[r] = bobj;
}

}  // namespace

extern "C" int lpt_compact_wl_intersect(
    const void* rays8, int R, const void* wl, const void* wn, int C,
    int tile, const void* meta, const void* inv, const void* aabb,
    const void* tris, int S, float eps, int threads, int has_tmax,
    int any_hit, void* t, void* tri, void* obj, void* stream) {
  const size_t smem = sizeof(float) * 9 * static_cast<size_t>(S);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        compact_wl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  compact_wl_kernel<<<R / threads, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rays8), R, static_cast<const int*>(wl),
      static_cast<const int*>(wn), C, tile, static_cast<const int*>(meta),
      static_cast<const float*>(inv), static_cast<const float*>(aabb),
      static_cast<const float*>(tris), S, eps, has_tmax, any_hit,
      static_cast<float*>(t),
      static_cast<int*>(tri), static_cast<int*>(obj));
  return static_cast<int>(cudaGetLastError());
}
