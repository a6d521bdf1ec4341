// Radiance flush (kernel K3): accum[pix[i]] += acc[i] over a pixel-id
// array that is ascending with a -1 prefix (rows to skip).
//
// Replaces logipathtracer_tpu/ops/pallas/flush.py::flush_bins.  One
// thread per row; the thread that starts a run of equal pixel ids adds
// the run's rows, in row order, into that pixel.  Runs are disjoint, so
// no two threads write one pixel: no atomics, bit-identical repeats.
//
// Bound: bytes (16 B per row read, 24 B per flushed pixel); the simple
// design leaves it there.
//
// Built without -fmad=false: there are no products to contract.

#include <cuda_runtime.h>

namespace {

__global__ void flush_runs(float* __restrict__ accum,
                           const int* __restrict__ pix,
                           const float* __restrict__ acc, int rows,
                           int npix) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  int p = pix[i];
  if (p < 0 || p >= npix) return;
  if (i > 0 && pix[i - 1] == p) return;  // not the start of its run
  float a0 = accum[3 * p + 0];
  float a1 = accum[3 * p + 1];
  float a2 = accum[3 * p + 2];
  for (int j = i; j < rows && pix[j] == p; ++j) {
    a0 = a0 + acc[3 * j + 0];
    a1 = a1 + acc[3 * j + 1];
    a2 = a2 + acc[3 * j + 2];
  }
  accum[3 * p + 0] = a0;
  accum[3 * p + 1] = a1;
  accum[3 * p + 2] = a2;
}

}  // namespace

extern "C" int lpt_flush_sorted(void* accum, const void* pix,
                                const void* acc, int rows, int npix,
                                void* stream) {
  const int threads = 256;
  const int blocks = (rows + threads - 1) / threads;
  flush_runs<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(accum), static_cast<const int*>(pix),
      static_cast<const float*>(acc), rows, npix);
  return static_cast<int>(cudaGetLastError());
}
