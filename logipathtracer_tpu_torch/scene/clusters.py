"""Clustered scene representation for the cluster intersect kernels.

Carried over from the JAX package's module of the same name so that
this package never imports JAX; tests/test_torch_scene.py holds the
two copies to bit-identical output.

This module re-expresses the two-level BVH hierarchy in a cluster
form that the intersect kernels sweep instead of walking the tree:

  * each object's mesh BVH is CUT into *clusters* — subtrees holding at
    most ``cluster_size`` triangles (the compiler picks 256 or 512).
    Because the SAH builder emits leaves in DFS order, every subtree's
    triangles form a contiguous range of the reordered triangle soup,
    so a cluster is (object, tri_start, count, object-space AABB);
  * cluster triangle data is stored component-major and pre-padded:
    [C, 9, 128] float32 with rows (v0.xyz, e1.xyz, e2.xyz) and one
    triangle per lane — a Möller-Trumbore test of a whole cluster
    against a ray tile is a dense [tile, 128] vector op;
  * padded slots are all-zero: their determinant is 0, so MT yields
    inf/NaN t which the acceptance gate rejects (same invariant the
    traversal relies on, ops/intersect.py).

The kernel then sweeps clusters with a *scalar* (uniform) loop —
culling each cluster against the whole ray tile and skipping its
triangle test when no lane can hit — instead of each ray walking its
own path.  Traversal order changes; the min-t result does not.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ClusteredScene:
    """Gather-free intersection arrays (all numpy, converted by callers)."""

    # Per-cluster metadata.
    cl_obj: np.ndarray       # [C] int32 owning object
    cl_tri_base: np.ndarray  # [C] int32 global triangle index of lane 0
    cl_count: np.ndarray     # [C] int32 real triangles (<= cluster_size)
    cl_aabb: np.ndarray      # [C, 8] f32: min.xyz, max.xyz, pad, pad
    # Triangle data, component-major, one lane per triangle.
    cl_tris: np.ndarray      # [C, 9, S] f32 rows: v0.xyz, e1.xyz, e2.xyz
    # Per-object inverse world rows (identity NOT included; clusters
    # always belong to a real object).
    inv_rows: np.ndarray     # [O, 12] f32 (3x4 row-major)
    cluster_size: int

    @property
    def num_clusters(self) -> int:
        return self.cl_obj.shape[0]

    def vmem_bytes(self) -> int:
        return int(self.cl_tris.nbytes + self.cl_aabb.nbytes)


def _subtree_ranges(meta: np.ndarray):
    """For every node: (first_tri, last_tri, tri_count) of its subtree."""
    n = meta.shape[0]
    first = np.zeros(n, np.int64)
    last = np.zeros(n, np.int64)

    def fill(i):
        # Iterative post-order (children before parent).
        stack = [(i, False)]
        order = []
        while stack:
            node, done = stack.pop()
            if done:
                order.append(node)
                continue
            stack.append((node, True))
            if meta[node, 0] == 0:
                stack.append((int(meta[node, 1]), False))
                stack.append((int(meta[node, 2]), False))
        for node in order:
            is_leaf, a, b = meta[node]
            if is_leaf:
                first[node], last[node] = a, b
            else:
                first[node] = min(first[a], first[b])
                last[node] = max(last[a], last[b])

    fill(0)
    return first, last


def build_clusters(scene, cluster_size: int = 128) -> ClusteredScene:
    """Cut each object's mesh BVH into <=cluster_size-triangle clusters.

    scene: SceneSoA (numpy or jnp arrays accepted).
    """
    mesh_meta = np.asarray(scene.mesh_bvh_meta)
    mesh_min = np.asarray(scene.mesh_bvh_min)
    mesh_max = np.asarray(scene.mesh_bvh_max)
    obj_bvh_offset = np.asarray(scene.obj_bvh_offset)
    obj_vtx_offset = np.asarray(scene.obj_vtx_offset)
    vtx_pos = np.asarray(scene.vtx_pos, np.float32)

    clusters = []  # (obj, tri_base_global, count, aabb_min, aabb_max)

    num_objects = scene.num_objects
    # obj_bvh_offset is permuted (BVH leaf order); recover each object's
    # node-slice length by sorting the offsets.
    sorted_offsets = np.sort(obj_bvh_offset.astype(np.int64))
    end_of = {int(off): int(nxt) for off, nxt in zip(
        sorted_offsets, list(sorted_offsets[1:]) + [mesh_meta.shape[0]])}
    for obj in range(num_objects):
        lo = int(obj_bvh_offset[obj])
        hi = end_of[lo]
        # Per-object node slice; child/leaf indices are local.
        meta = mesh_meta[lo:hi]
        first, last = _subtree_ranges(meta)
        count = last - first
        tri_base_g = int(obj_vtx_offset[obj]) // 3

        # DFS cut: take the shallowest subtrees with count <= cluster_size.
        stack = [0]
        while stack:
            node = stack.pop()
            if count[node] <= cluster_size:
                clusters.append((
                    obj, tri_base_g + int(first[node]), int(count[node]),
                    mesh_min[lo + node].copy(), mesh_max[lo + node].copy()))
            else:
                stack.append(int(meta[node, 2]))
                stack.append(int(meta[node, 1]))

    c = len(clusters)
    cl_obj = np.zeros(c, np.int32)
    cl_tri_base = np.zeros(c, np.int32)
    cl_count = np.zeros(c, np.int32)
    cl_aabb = np.zeros((c, 8), np.float32)
    cl_tris = np.zeros((c, 9, cluster_size), np.float32)

    tris = vtx_pos.reshape(-1, 3, 3)
    for i, (obj, base, cnt, amin, amax) in enumerate(clusters):
        cl_obj[i] = obj
        cl_tri_base[i] = base
        cl_count[i] = cnt
        cl_aabb[i, 0:3] = amin
        cl_aabb[i, 3:6] = amax
        block = tris[base:base + cnt]           # [cnt, 3, 3]
        v0 = block[:, 0]
        e1 = block[:, 1] - block[:, 0]
        e2 = block[:, 2] - block[:, 0]
        cl_tris[i, 0:3, :cnt] = v0.T
        cl_tris[i, 3:6, :cnt] = e1.T
        cl_tris[i, 6:9, :cnt] = e2.T

    inv_rows = np.asarray(scene.obj_world_inv,
                          np.float32)[:, :3, :4].reshape(num_objects, 12)

    return ClusteredScene(
        cl_obj=cl_obj, cl_tri_base=cl_tri_base, cl_count=cl_count,
        cl_aabb=cl_aabb, cl_tris=cl_tris, inv_rows=inv_rows,
        cluster_size=cluster_size)


def cluster_stats(cs: ClusteredScene) -> dict:
    fill = cs.cl_count / cs.cluster_size
    return {
        "clusters": cs.num_clusters,
        "mean_fill": float(fill.mean()),
        "min_fill": float(fill.min()),
        "vmem_mb": cs.vmem_bytes() / 2 ** 20,
    }
