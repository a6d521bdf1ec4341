"""The yardstick of the roofline shares: one NVIDIA H100's published
peaks (SXM data sheet, dense, at its 700 W limit) and the work any
implementation of a layer must do for the rays it served, counted from
exact ray counts, so that a share reads the same whatever implements
the layer and cannot pass 100%."""

from __future__ import annotations

import re

PEAK_FLOPS = 67e12      # float32 outside the tensor cores
PEAK_BYTES = 3.35e12    # HBM3

# Intersect: per ray, at least one slab test and one ray-triangle test
# (the operation counts of the repository's kernel bounds), the ray in
# (origin, direction: 6 float32) and the hit out (t, triangle, object).
SLAB_OPS = 64
TRIANGLE_OPS = 52
RAY_BYTES = 24
HIT_BYTES = 12
# A call reads the scene's triangle table once: three float32 vertices.
TRIANGLE_BYTES = 36

# Shade: per shaded lane the pool's lane record in and out, as the pool
# state defines it (render/wavefront.py ``wavefront_pool_state`` and
# K2's arguments): in origin, direction, acc, mask (4 x 12 B), alive
# (1 B), seed (2 x 8 B), bounce (4 B), t (4 B), tri (4 B); out origin,
# direction, acc, mask, alive, seed.
LANE_IN_BYTES = 4 * 12 + 1 + 16 + 4 + 4 + 4
LANE_OUT_BYTES = 4 * 12 + 1 + 16
# A call reads the per-object shading table once: 32 float32 an object.
OBJECT_BYTES = 128

# The profiler's kernel names of each layer.  Intersect calls are the
# kernels that read the triangle table (K1, K4-K8); K1's worklist kernel
# is the layer's prepass, timed with it.
INTERSECT_CALLS = ("compact_list_kernel", "visit_list_kernel",
                   "worklist_chunk_kernel", "octant_compact_kernel",
                   "octant_chunk_kernel", "order_visit_kernel",
                   "cluster_order_kernel")
INTERSECT_KERNELS = INTERSECT_CALLS + ("worklist_kernel",)
SHADE_KERNELS = ("shade_kernel",)


def bound(ops: float, nbytes: float) -> float:
    """The least seconds the card could take."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def matches(kernel_name: str, names) -> bool:
    """Whether a profiler kernel name holds one of ``names`` as a whole
    identifier."""
    return any(re.search(r"(?<![A-Za-z0-9_])" + n + r"(?![A-Za-z0-9_])",
                         kernel_name) for n in names)


def layer_time(kernel_s: dict, kernel_n: dict, names):
    """(device seconds, launches) of the kernels of a layer."""
    t = sum(v for k, v in kernel_s.items() if matches(k, names))
    n = sum(v for k, v in kernel_n.items() if matches(k, names))
    return t, n


def intersect_bound(rays: float, calls: int, triangles: int) -> float:
    return bound(rays * (SLAB_OPS + TRIANGLE_OPS),
                 rays * (RAY_BYTES + HIT_BYTES)
                 + calls * triangles * TRIANGLE_BYTES)


def shade_bound(lanes: float, calls: int, objects: int) -> float:
    return bound(0.0, lanes * (LANE_IN_BYTES + LANE_OUT_BYTES)
                 + calls * objects * OBJECT_BYTES)
