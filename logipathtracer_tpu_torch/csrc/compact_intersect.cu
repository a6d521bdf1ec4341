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
// The per-ray core (local ray, _slab_inv, Moller-Trumbore, acceptance),
// the cluster-visit loop and the kernel live in closest_hit.cuh, shared
// with K4-K6; it states the rounding rules (-fmad=false, IEEE divides,
// NaN-propagating min/max) that keep the slab decisions bit-identical to
// the plain version.

#include "closest_hit.cuh"

// The kernel is closest_hit.cuh's cluster_list_kernel in its gate-before-
// load form (kStages = 0): one [9, S] block of shared memory.
extern "C" int lpt_compact_wl_intersect(
    const void* rays8, int R, const void* wl, const void* wn, int C,
    int tile, const void* meta, const void* inv, const void* aabb,
    const void* tris, int S, float eps, int threads, int has_tmax,
    int any_hit, void* t, void* tri, void* obj, void* stream) {
  return lpt::launch_cluster_list<0>(rays8, R, wl, wn, C, tile, meta, inv,
                                     aabb, tris, S, eps, threads, has_tmax,
                                     any_hit, t, tri, obj, stream);
}
