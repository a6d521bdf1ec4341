"""Fused shading step per ray (kernel K2, csrc/shade.cu).

Replaces the TPU kernel ``logipathtracer_tpu/ops/pallas/shade.py::
shade_pallas`` (``_kernel`` → ``_shade_tile``) in its gather form, for
untextured, non-NEE Heitz scenes: miss writes the environment (an
assignment, megakernel.py:542-545), emission with the pre-bounce mask,
barycentrics, shading normal, tangent basis, lobe pick, the Heitz walk
of at most ``max_order`` orders, Russian roulette — with the parity or
Threefry draws in the JAX draw order.

The plain version below is the port of the JAX package's jnp shade
path (``render/megakernel.py::shade_step``, the oracle the Pallas
kernel is held to); the CUDA kernel repeats its arithmetic lane by
lane.  The kernel reads each lane's ``tri_shade[tri]`` row itself: no
[82, R] row pack (328 MB at 2^20 lanes).

On the card: one thread per lane; dead lanes copy through, miss lanes
only write the environment.  Bound: operations — the walk's
transcendentals (log, sin, cos, pow per order) and ~600 flops per
order, with heavy divergence between lanes of a warp (lobe, walk
length).  The simple design does nothing about the divergence; the
256-byte row read per lane is small beside it.
"""

from __future__ import annotations

import ctypes

import torch

from logipathtracer_tpu_torch.film.image import srgb_to_linear
from logipathtracer_tpu_torch.ops import bsdf
from logipathtracer_tpu_torch.ops.intersect import (INF, barycentric, cross3,
                                                    dot3, transform_dir,
                                                    transform_point)
from logipathtracer_tpu_torch.ops.kernels import _build
from logipathtracer_tpu_torch.ops.rng import get_rand

launches = 0
plain_calls = 0

SOURCE = "logipathtracer_tpu_torch/csrc/shade.cu"
REPLACES = "logipathtracer_tpu/ops/pallas/shade.py:765"


def _unit_like(v, axis: int):
    u = torch.zeros_like(v)
    u[..., axis] = 1.0
    return u


def _normalize(v):
    return v / torch.sqrt(torch.clamp(dot3(v, v), min=1e-38))[..., None]


def shade_plain(tri_shade, origin, direction, acc, mask, alive, seed,
                bounce, t, tri, *, env: float, rr_threshold: float,
                rr_bounces: int, max_order: int, parity: bool):
    """Plain PyTorch shading step.  Returns (origin, direction, acc,
    mask, alive, seed)."""
    global plain_calls
    plain_calls += 1
    rand = get_rand(parity)
    miss = alive & (t >= INF)
    acc = torch.where(miss[:, None], mask * env, acc)
    alive = alive & ~miss

    ts64 = tri_shade[tri.clamp(min=0).long()]              # [R, 64]
    tshade = ts64[:, 0:32]
    oshade = ts64[:, 32:64]
    world3 = oshade[:, 0:9].reshape(-1, 3, 3)
    inv34 = oshade[:, 9:21].reshape(-1, 3, 4)
    base_color = oshade[:, 21:25]
    emission = oshade[:, 25:28]
    mrti = oshade[:, 28:32]

    o_loc = transform_point(inv34, origin)
    d_loc = transform_dir(inv34, direction)
    pos_w = origin + t[:, None] * direction
    pos_loc = o_loc + t[:, None] * d_loc
    bary = barycentric(pos_loc, tshade[:, 15:18], tshade[:, 18:21],
                       tshade[:, 21:24])

    roughness = torch.clamp(mrti[:, 1], min=0.001)
    metallic = mrti[:, 0]
    transmission = mrti[:, 2]
    ior = mrti[:, 3]
    base_color = srgb_to_linear(base_color)

    lobe, seed = bsdf.determine_interaction(metallic, transmission, seed,
                                            alive, rand=rand)

    n_loc = (bary[:, 0:1] * tshade[:, 0:3] + bary[:, 1:2] * tshade[:, 3:6]
             + bary[:, 2:3] * tshade[:, 6:9])
    n = _normalize(transform_dir(world3, n_loc))
    ndotd = dot3(n, direction)
    ff = torch.where((ndotd < 0.0)[:, None], n, -n)
    pick_y = torch.abs(ff[:, 0]) > 0.1
    axis = torch.where(pick_y[:, None], _unit_like(ff, 1), _unit_like(ff, 0))
    u = _normalize(cross3(axis, ff))
    v = cross3(ff, u)

    acc = acc + torch.where(alive[:, None], mask * emission, 0.0)

    nd = -direction
    view = torch.stack([dot3(nd, u), dot3(nd, v), dot3(nd, ff)], -1)
    outside = dot3(n, nd) > 0.0
    weight, ldir_t, seed = bsdf.heitz_sample(
        base_color[:, :3], view, roughness, transmission, ior, outside,
        lobe, seed, alive, max_order=max_order, rand=rand)

    mask = torch.where(alive[:, None], mask * weight, mask)
    ldir_w = (ldir_t[:, 0:1] * u + ldir_t[:, 1:2] * v + ldir_t[:, 2:3] * ff)
    origin = torch.where(alive[:, None], pos_w, origin)
    direction = torch.where(alive[:, None], ldir_w, direction)

    # Russian roulette (path_tracing.comp:317-323).
    q = torch.amax(mask, dim=-1)
    rr = alive & (q < rr_threshold) & (bounce > rr_bounces)
    r_rr, seed = rand(seed, rr)
    kill = rr & (r_rr > q)
    alive = alive & ~kill
    boost = rr & ~kill
    mask = torch.where(boost[:, None], mask / q[:, None], mask)
    return origin, direction, acc, mask, alive, seed


def shade(tri_shade, origin, direction, acc, mask, alive, seed, bounce, t,
          tri, *, env: float, rr_threshold: float, rr_bounces: int,
          max_order: int, parity: bool):
    """One shading step for R lanes.

    tri_shade [T, 64] f32; origin, direction, acc, mask [R, 3] f32;
    alive [R] bool; seed [R, 2] int64 (u32 words); bounce [R] i32;
    t [R] f32; tri [R] i32.  Returns new (origin, direction, acc, mask,
    alive, seed).  A CPU tensor takes the plain version, a CUDA tensor
    the kernel."""
    global launches
    kw = dict(env=env, rr_threshold=rr_threshold, rr_bounces=rr_bounces,
              max_order=max_order, parity=parity)
    dev = origin.device
    if dev.type == "cpu":
        return shade_plain(tri_shade, origin, direction, acc, mask, alive,
                           seed, bounce, t, tri, **kw)
    if dev.type != "cuda":
        raise ValueError(f"shade: unsupported device {dev}")
    r = origin.shape[0]
    f32 = torch.float32
    _build.require(tri_shade, "tri_shade", f32, (None, 64), dev)
    for name, x in (("origin", origin), ("direction", direction),
                    ("acc", acc), ("mask", mask)):
        _build.require(x, name, f32, (r, 3), dev)
    _build.require(alive, "alive", torch.bool, (r,), dev)
    _build.require(seed, "seed", torch.int64, (r, 2), dev)
    _build.require(bounce, "bounce", torch.int32, (r,), dev)
    _build.require(t, "t", f32, (r,), dev)
    _build.require(tri, "tri", torch.int32, (r,), dev)
    outs = (torch.empty_like(origin), torch.empty_like(direction),
            torch.empty_like(acc), torch.empty_like(mask),
            torch.empty_like(alive), torch.empty_like(seed))
    if r == 0:
        return outs
    lib = _build.load("shade")
    fn = lib.lpt_shade
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 6
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    p = _build.ptr
    _build.check(fn(p(tri_shade), p(origin), p(direction), p(acc), p(mask),
                    p(alive), p(seed), p(bounce), p(t), p(tri), r,
                    *(p(o) for o in outs),
                    float(env), float(rr_threshold), int(rr_bounces),
                    int(max_order), int(bool(parity)),
                    _build.stream_ptr(dev)),
                 "shade kernel")
    launches += 1
    return outs


# Agreement rule between two shading answers (kernel vs plain on the
# card, the port vs the JAX package on the CPU).  A lane whose walk took
# another branch after a last-ulp difference of the libm (log, sin, cos,
# pow) ends with another seed or alive flag; at most MAX_DIVERGED of
# lanes may do so.  On the other lanes the floats must agree as the JAX
# package's own kernel-vs-jnp test requires (tests/test_shade_kernel.py
# :59-72).
MAX_DIVERGED = 0.005
CLOSE_RTOL, CLOSE_ATOL, CLOSE_FRAC = 2e-5, 2e-6, 0.995
ALL_RTOL, ALL_ATOL = 2e-2, 1e-4


def shade_agreement(ref, got):
    """ref, got: (origin, direction, acc, mask, alive, seed) as arrays.
    Raises AssertionError; returns (diverged fraction, max |diff| of the
    floats on agreeing lanes)."""
    import numpy as np
    names = ("origin", "direction", "acc", "mask", "alive", "seed")
    r = {n: np.asarray(x) for n, x in zip(names, ref)}
    g = {n: np.asarray(x) for n, x in zip(names, got)}
    same = ((r["alive"] == g["alive"])
            & (r["seed"].astype(np.int64) == g["seed"].astype(np.int64))
            .all(-1))
    diverged = 1.0 - float(same.mean())
    assert diverged <= MAX_DIVERGED, f"{diverged:.3%} of lanes diverged"
    err = 0.0
    for n in ("origin", "direction", "acc", "mask"):
        a, b = r[n][same], g[n][same]
        close = np.isclose(b, a, rtol=CLOSE_RTOL, atol=CLOSE_ATOL)
        assert close.mean() >= CLOSE_FRAC, \
            f"{n}: {(~close).mean():.3%} mismatched"
        np.testing.assert_allclose(b, a, rtol=ALL_RTOL, atol=ALL_ATOL,
                                   err_msg=n)
        finite = np.isfinite(a) & np.isfinite(b) & (np.abs(a) < 1e29)
        if finite.any():
            err = max(err, float(np.abs(a[finite] - b[finite]).max()))
    return diverged, err
