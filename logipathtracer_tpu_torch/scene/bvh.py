"""Binned-SAH BVH builder (host-side, numpy).

Carried over from the JAX package's module of the same name so that
this package never imports JAX; tests/test_torch_scene.py holds the
two copies to bit-identical output.

Replaces lsg::bvh::BVHBuilder / lsg::bvh::SplitBVHBuilder (SURVEY.md
§2.3; call sites src/PTSceneConverter.cpp:97-98,133-135).  Emits the
reference's node schema exactly (include/PTSceneConverter.hpp:52-59):

  node = { min: vec3, max: vec3, is_leaf: bool, indices: uvec2 }

where for inner nodes ``indices`` holds the two child node indices and
for leaves the primitive range ``[first, last)`` over the *reordered*
primitive array (``prim_order`` gives the permutation; the scene
compiler duplicates triangles into that order, so leaves address
contiguous runs with no index indirection — src/PTSceneConverter.cpp:105-120).

Differences from the reference by design (documented divergence):
  * pure binned SAH with forced splits so every leaf holds at most
    ``leaf_size`` primitives (the traversal kernels unroll a static
    ``leaf_size``-wide triangle test);
  * the root is always node 0; child nodes are emitted depth-first.

A C++ builder with the same ABI can replace this for large scenes (see
native/bvh_builder.cpp); results are interchangeable because traversal
only depends on the schema, not on tree shape.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_TRAVERSAL_COST = 1.0
_ISECT_COST = 1.0


@dataclasses.dataclass
class BVH:
    nodes_min: np.ndarray   # [M, 3] float32
    nodes_max: np.ndarray   # [M, 3] float32
    nodes_meta: np.ndarray  # [M, 3] int32: (is_leaf, a, b)
    prim_order: np.ndarray  # [N] int32 permutation of input primitives
    max_depth: int          # deepest node (root = 0)

    @property
    def num_nodes(self) -> int:
        return self.nodes_min.shape[0]

    @property
    def bounds(self) -> tuple[np.ndarray, np.ndarray]:
        return self.nodes_min[0], self.nodes_max[0]

    def max_stack(self) -> int:
        """Worst-case traversal stack occupancy (push-both-children walk)."""
        # Each level can leave at most one pending sibling on the stack.
        return self.max_depth + 2


def build_bvh(aabb_min: np.ndarray, aabb_max: np.ndarray,
              leaf_size: int = 4, bins: int = 16) -> BVH:
    """Build a 2-wide SAH BVH over primitive AABBs.

    aabb_min/aabb_max: [N, 3] float32.
    """
    n = aabb_min.shape[0]
    assert n > 0, "empty BVH"
    aabb_min = np.asarray(aabb_min, np.float32)
    aabb_max = np.asarray(aabb_max, np.float32)
    centroids = (aabb_min + aabb_max) * 0.5

    nodes_min: list[np.ndarray] = []
    nodes_max: list[np.ndarray] = []
    nodes_meta: list[tuple[int, int, int]] = []
    prim_order: list[np.ndarray] = []
    order_cursor = 0
    max_depth = 0

    # Explicit stack: (prim_ids, node_slot, depth). Children are emitted
    # depth-first after their parent; the parent's meta is patched once
    # child slots are known.
    def alloc_node(ids: np.ndarray) -> int:
        slot = len(nodes_min)
        nodes_min.append(aabb_min[ids].min(axis=0))
        nodes_max.append(aabb_max[ids].max(axis=0))
        nodes_meta.append((0, 0, 0))
        return slot

    root_ids = np.arange(n, dtype=np.int64)
    stack = [(root_ids, alloc_node(root_ids), 0)]

    while stack:
        ids, slot, depth = stack.pop()
        max_depth = max(max_depth, depth)
        count = ids.shape[0]

        split = None
        if count > leaf_size:
            split = _find_split(ids, centroids, aabb_min, aabb_max, bins,
                                count, leaf_size)
        if split is None and count > leaf_size:
            # Degenerate centroids: split by median index.
            half = count // 2
            split = (ids[:half], ids[half:])

        if split is None:
            first = order_cursor
            prim_order.append(ids)
            order_cursor += count
            nodes_meta[slot] = (1, first, order_cursor)
            continue

        left_ids, right_ids = split
        lslot = alloc_node(left_ids)
        rslot = alloc_node(right_ids)
        nodes_meta[slot] = (0, lslot, rslot)
        # Depth-first: process left fully before right (stack: right first).
        stack.append((right_ids, rslot, depth + 1))
        stack.append((left_ids, lslot, depth + 1))

    return BVH(
        nodes_min=np.stack(nodes_min).astype(np.float32),
        nodes_max=np.stack(nodes_max).astype(np.float32),
        nodes_meta=np.asarray(nodes_meta, np.int32),
        prim_order=np.concatenate(prim_order).astype(np.int32),
        max_depth=max_depth,
    )


def _find_split(ids, centroids, aabb_min, aabb_max, bins, count, leaf_size):
    """Binned SAH over all 3 axes. Returns (left_ids, right_ids) or None."""
    c = centroids[ids]
    cmin = c.min(axis=0)
    cmax = c.max(axis=0)
    extent = cmax - cmin

    best = None  # (cost, axis, bin_ids, threshold_bin)
    for axis in range(3):
        if extent[axis] <= 0:
            continue
        scale = bins * (1.0 - 1e-6) / extent[axis]
        b = np.minimum(((c[:, axis] - cmin[axis]) * scale).astype(np.int32),
                       bins - 1)
        # Per-bin counts and bounds.
        counts = np.bincount(b, minlength=bins)
        bin_min = np.full((bins, 3), np.inf, np.float32)
        bin_max = np.full((bins, 3), -np.inf, np.float32)
        np.minimum.at(bin_min, b, aabb_min[ids])
        np.maximum.at(bin_max, b, aabb_max[ids])

        # Prefix/suffix sweeps.
        lmin = np.minimum.accumulate(bin_min, axis=0)
        lmax = np.maximum.accumulate(bin_max, axis=0)
        rmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
        rmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
        lcnt = np.cumsum(counts)
        rcnt = count - lcnt

        def area(mn, mx):
            d = np.maximum(mx - mn, 0)
            return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

        la = area(lmin, lmax)[:-1]
        ra = area(rmin[1:], rmax[1:])
        lc = lcnt[:-1].astype(np.float64)
        rc = rcnt[:-1].astype(np.float64)
        cost = la * lc + ra * rc
        valid = (lc > 0) & (rc > 0)
        if not valid.any():
            continue
        cost = np.where(valid, cost, np.inf)
        k = int(np.argmin(cost))
        if best is None or cost[k] < best[0]:
            best = (cost[k], axis, b, k)

    if best is None:
        return None
    _, axis, b, k = best
    left_mask = b <= k
    return ids[left_mask], ids[~left_mask]


def build_triangle_bvh(tri_pos: np.ndarray, leaf_size: int = 4,
                       bins: int = 16) -> BVH:
    """BVH over a triangle soup [T, 3, 3] (the reference's per-mesh SBVH
    role, src/PTSceneConverter.cpp:97-98)."""
    amin = tri_pos.min(axis=1)
    amax = tri_pos.max(axis=1)
    return build_bvh(amin, amax, leaf_size=leaf_size, bins=bins)


def validate_bvh(bvh: BVH, aabb_min: np.ndarray, aabb_max: np.ndarray) -> None:
    """Structural invariants (the reference has no such checks; SURVEY §4)."""
    n = aabb_min.shape[0]
    seen = np.zeros(n, bool)
    meta = bvh.nodes_meta
    for i in range(bvh.num_nodes):
        is_leaf, a, b = meta[i]
        if is_leaf:
            assert 0 <= a < b <= n, f"bad leaf range [{a},{b}) at node {i}"
            prims = bvh.prim_order[a:b]
            assert not seen[prims].any(), "primitive in two leaves"
            seen[prims] = True
            lo = aabb_min[prims].min(axis=0)
            hi = aabb_max[prims].max(axis=0)
        else:
            assert 0 < a < bvh.num_nodes and 0 < b < bvh.num_nodes
            lo = np.minimum(bvh.nodes_min[a], bvh.nodes_min[b])
            hi = np.maximum(bvh.nodes_max[a], bvh.nodes_max[b])
        assert (bvh.nodes_min[i] <= lo + 1e-5).all(), f"loose min at {i}"
        assert (bvh.nodes_max[i] >= hi - 1e-5).all(), f"loose max at {i}"
    assert seen.all(), "leaves do not cover all primitives"
