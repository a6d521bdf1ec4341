"""Ray-primitive helpers (the JAX package's ``ops/intersect.py``): the
slab and Möller–Trumbore tests of the BVH walk, barycentric recovery
and the affine transforms, written elementwise so every sum has one
fixed order (no matmul, which on the card could also run in TF32)."""

from __future__ import annotations

import torch

INF = 3.4e38  # shaders/common/constants.glsl:9 (rounds to f32 3.4e38)


def dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def cross3(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def ray_aabb_test(origin, inv_dir, box_min, box_max, best_t):
    """The slab test (rayAABBIntersectTest; the JAX package's
    ``ray_aabb_test``): false
    when t0 > t1; else t0 < best where t0 > 0; else t1 > 0.  min/max
    propagate NaN, as jnp's do."""
    near = (box_min - origin) * inv_dir
    far = (box_max - origin) * inv_dir
    t0 = torch.minimum(near, far).amax(dim=-1)
    t1 = torch.maximum(near, far).amin(dim=-1)
    return torch.where(t0 > t1, False,
                       torch.where(t0 > 0.0, t0 < best_t, t1 > 0.0))


def ray_triangle(origin, direction, v0, v1, v2):
    """Möller–Trumbore (the JAX package's ``ray_triangle``): t, INF on a
    barycentric miss; no backface cull, no determinant epsilon."""
    edge1 = v1 - v0
    edge2 = v2 - v0
    pvec = cross3(direction, edge2)
    det = 1.0 / dot3(edge1, pvec)
    tvec = origin - v0
    u = dot3(tvec, pvec) * det
    qvec = cross3(tvec, edge1)
    v = dot3(direction, qvec) * det
    t = dot3(edge2, qvec) * det
    miss = (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0)
    return torch.where(miss, INF, t)


def barycentric(point, v0, v1, v2):
    """Geometric barycentric recovery (shaders/common/util.glsl:23-41)."""
    ab = v1 - v0
    ac = v2 - v0
    ah = point - v0
    ab_ab = dot3(ab, ab)
    ab_ac = dot3(ab, ac)
    ac_ac = dot3(ac, ac)
    ab_ah = dot3(ab, ah)
    ac_ah = dot3(ac, ah)
    inv_denom = 1.0 / (ab_ab * ac_ac - ab_ac * ab_ac)
    v = (ac_ac * ab_ah - ab_ac * ac_ah) * inv_denom
    w = (ab_ab * ac_ah - ab_ac * ab_ah) * inv_denom
    u = 1.0 - v - w
    return torch.stack([u, v, w], -1)


def matvec3(m, v):
    """mat3 @ vec3 elementwise; m [..., 3, 3], v [..., 3]."""
    return torch.stack([
        m[..., 0, 0] * v[..., 0] + m[..., 0, 1] * v[..., 1]
        + m[..., 0, 2] * v[..., 2],
        m[..., 1, 0] * v[..., 0] + m[..., 1, 1] * v[..., 1]
        + m[..., 1, 2] * v[..., 2],
        m[..., 2, 0] * v[..., 0] + m[..., 2, 1] * v[..., 1]
        + m[..., 2, 2] * v[..., 2],
    ], -1)


def transform_point(m, p):
    """(M @ [p, 1]).xyz for m [..., 4, 4] or [..., 3, 4]."""
    return matvec3(m[..., :3, :3], p) + m[..., :3, 3]


def transform_dir(m, d):
    """mat3(M) @ d, not normalized (path_tracing.comp:137)."""
    return matvec3(m[..., :3, :3], d)
