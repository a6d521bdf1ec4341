// Device stopwatch of the wavefront loop's stages (utils/trace.py).
//
// Replaces no TPU kernel: the JAX package times its loop from the host
// only.  On the card each iteration is two replayed CUDA graphs around
// one host read (render/graph.py), and a host timer or a wrapped Python
// function sees nothing inside a replay.  So one launch of this kernel
// at each stage boundary, captured into the stage graphs with the rest,
// reads the card's global nanosecond timer (%globaltimer, the same on
// every SM) on every replay: it adds the time since the previous stamp
// into one int64 slot of the pool's buffer and stores the new stamp.  A
// negative slot only stores the stamp (the top of a stage A, so that no
// time between stages or calls is counted).
//
// Bound: launch latency.  One thread reads and writes three int64 words;
// a launch costs the gap between two graph nodes, about a microsecond.
// Launches on one stream run in order, so a stamp follows the work
// before it and precedes the work after it.
//
// Built without -fmad=false: there is no arithmetic to contract.

#include <cuda_runtime.h>

namespace {

// buf[slot] += now - buf[prev]; buf[prev] = now (slot < 0: the store
// alone).
__global__ void stamp_kernel(long long* buf, int slot, int prev) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long t = static_cast<long long>(now);
  if (slot >= 0) buf[slot] += t - buf[prev];
  buf[prev] = t;
}

}  // namespace

extern "C" int lpt_stamp(void* buf, int slot, int prev, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(buf), slot, prev);
  return static_cast<int>(cudaGetLastError());
}
