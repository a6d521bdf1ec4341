"""Ray-primitive helpers the shading step needs (the JAX package's
``ops/intersect.py``): barycentric recovery and the affine transforms,
written elementwise so every sum has one fixed order (no matmul, which
on the card could also run in TF32)."""

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
