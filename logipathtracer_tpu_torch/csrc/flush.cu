// Radiance flush (kernel K3): accum[pix[i]] += acc[i] over a pixel-id
// array that is ascending with a -1 prefix (rows to skip).
//
// Replaces logipathtracer_tpu/ops/pallas/flush.py::flush_bins.  The
// thread that starts a run of equal pixel ids adds the run's rows, in
// row order, into that pixel (accum + a0 + a1 + ...).  Runs are
// disjoint, so no two threads write one pixel: no atomics, bit-identical
// repeats.
//
// Bound: bytes (4 B of pixel id per row, 12 B of radiance per retired
// row, a read and a write of each flushed pixel) — a few microseconds,
// so in practice the latency of a few dependent loads.  The design is
// about that latency: a quarter as many threads as rows, each taking
// four rows a grid's width apart (neighbouring threads on neighbouring
// rows), issues all its loads before it adds: the four pixel ids, their
// neighbours' ids (from the next lanes by shuffle, so only a warp's
// edge lanes load), then the running sums and radiance of the runs that
// start at its rows.  Only a run longer than one row reads on, row by
// row.  The -1 prefix, three quarters of a pool whose last quarter
// retires, then costs its pixel ids and no threads of its own.
//
// Built without -fmad=false: there are no products to contract.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows per thread, a grid's width apart

__global__ void flush_runs(float* __restrict__ accum,
                           const int* __restrict__ pix,
                           const float* __restrict__ acc, int rows,
                           int npix) {
  const int stride = gridDim.x * kThreads;
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int q[kRows], before[kRows], after[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = g + k * stride;
    q[k] = i < rows ? pix[i] : -1;
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = g + k * stride;
    const int up = __shfl_up_sync(0xffffffffu, q[k], 1);
    const int down = __shfl_down_sync(0xffffffffu, q[k], 1);
    before[k] = lane > 0 ? up : (i > 0 && i <= rows ? pix[i - 1] : -1);
    after[k] = lane < 31 ? down : (i + 1 < rows ? pix[i + 1] : -1);
  }
  // Every load of the runs that start here, then the sums: the pixels
  // are distinct (one start per run), so the stores cannot feed a load.
  bool start[kRows];
  float s[kRows][3], a[kRows][3];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = g + k * stride;
    start[k] = q[k] >= 0 && q[k] < npix && before[k] != q[k];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s[k][c] = start[k] ? accum[3 * q[k] + c] : 0.0f;
      a[k][c] = start[k] ? acc[3 * i + c] : 0.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (!start[k]) continue;
#pragma unroll
    for (int c = 0; c < 3; ++c) s[k][c] = s[k][c] + a[k][c];
    if (after[k] == q[k]) {  // the run goes on
      for (int j = g + k * stride + 1; j < rows && pix[j] == q[k]; ++j) {
#pragma unroll
        for (int c = 0; c < 3; ++c) s[k][c] = s[k][c] + acc[3 * j + c];
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) accum[3 * q[k] + c] = s[k][c];
  }
}

}  // namespace

extern "C" int lpt_flush_sorted(void* accum, const void* pix,
                                const void* acc, int rows, int npix,
                                void* stream) {
  const int per_block = kThreads * kRows;
  const int blocks = (rows + per_block - 1) / per_block;
  flush_runs<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(accum), static_cast<const int*>(pix),
      static_cast<const float*>(acc), rows, npix);
  return static_cast<int>(cudaGetLastError());
}
