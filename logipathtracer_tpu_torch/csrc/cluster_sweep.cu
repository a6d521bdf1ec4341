// Closest hit visiting every resident cluster in the front-to-back order
// of the direction octant of each ray tile's first ray: the compact sweep
// without worklists (kernel K7) and the dense resident sweep (kernel K8),
// one entry point over closest_hit.cuh's cluster_order_kernel.
//
// K7 replaces logipathtracer_tpu/ops/pallas/compact_intersect.py::
// cluster_intersect_compact(worklist=False) -> _compact_kernel ->
// _compact_loop: K1's contract (best t from min(t_max, BIG) with
// has_tmax, else BIG; any-hit parking at -BIG; miss t = INF,
// tri = obj = -1) with the visit order cl_order[oct] in place of a
// worklist, so no per-ray prepass runs.  The tile is compact_tile (4096
// rays); blocks of 256 rays.
//
// K8 replaces logipathtracer_tpu/ops/pallas/cluster_intersect.py::
// cluster_intersect_pallas -> _kernel -> _mt_subtile_update: the
// function of K6's cap = 0 body with cl_order in place of chunks — best
// t from INF, or from rays8[6] unclamped with has_tmax; once some ray of
// a 128-ray sub-tile passes a cluster's slab, every ray of the sub-tile
// runs the triangle test; any_hit is ignored; t is the best as it stands
// without has_tmax, INF where no hit was accepted with it.  The tile is
// sweep_tile (1024 rays); blocks of 128 rays, so a block is a sub-tile
// and its __syncthreads_or is the sub-tile gate.  The TPU kernel's
// tile-wide gate contains the sub-tile gate, so it decides nothing more.
//
// The octant belongs to the tile, not to the block: the host side
// computes oct [tiles] from each tile's first ray (a parked lane, with
// direction (1, 1, 1), gives octant 7; a pad ray, (0, 0, 1), octant 1).
// No tile is skipped.
//
// Each cluster's 9 x S floats (9 KB at S = 256) are staged in shared
// memory after the block-wide slab gate passes (gate before load, as
// K1): all 86 blocks of the flagship box sit in L2.  Bound: operations
// (~64 per slab test, ~52 per ray-triangle test); K7 slab-tests every
// cluster for every ray, where K1 tests only its tile's worklist.

#include "closest_hit.cuh"

namespace {

template <bool kSubtile>
int launch_order(const void* rays8, int R, const void* oct,
                 const void* order, int C, int tile, const void* meta,
                 const void* inv, const void* aabb, const void* tris, int S,
                 float eps, int threads, int has_tmax, int any_hit, void* t,
                 void* tri, void* obj, void* stream) {
  const size_t smem = lpt::ring_bytes<0>(S);
  const int e = lpt::prepare(lpt::cluster_order_kernel<kSubtile>, smem);
  if (e) return e;
  lpt::cluster_order_kernel<kSubtile><<<R / threads, threads, smem,
                                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rays8), R, static_cast<const int*>(oct),
      static_cast<const int*>(order), C, tile, static_cast<const int*>(meta),
      static_cast<const float*>(inv), static_cast<const float*>(aabb),
      static_cast<const float*>(tris), S, eps, has_tmax, any_hit,
      static_cast<float*>(t), static_cast<int*>(tri), static_cast<int*>(obj));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Per-tile octant oct [tiles], per-octant cluster order [8, C]; subtile
// selects K8's body (threads must be 128), else K7's.
extern "C" int lpt_cluster_order_intersect(
    const void* rays8, int R, const void* oct, const void* order, int C,
    int tile, const void* meta, const void* inv, const void* aabb,
    const void* tris, int S, float eps, int threads, int subtile,
    int has_tmax, int any_hit, void* t, void* tri, void* obj, void* stream) {
  if (subtile)
    return launch_order<true>(rays8, R, oct, order, C, tile, meta, inv, aabb,
                              tris, S, eps, threads, has_tmax, any_hit, t,
                              tri, obj, stream);
  return launch_order<false>(rays8, R, oct, order, C, tile, meta, inv, aabb,
                             tris, S, eps, threads, has_tmax, any_hit, t, tri,
                             obj, stream);
}
