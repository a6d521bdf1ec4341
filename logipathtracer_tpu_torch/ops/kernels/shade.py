"""Fused shading step per ray (kernel K2, csrc/shade.cu).

Replaces the TPU kernel ``logipathtracer_tpu/ops/pallas/shade.py::
shade_pallas`` (``_kernel`` → ``_shade_tile``) in every variant: miss
writes the environment (an assignment, megakernel.py:542-545), emission
with the pre-bounce mask, barycentrics, shading normal, tangent basis,
lobe pick, the Heitz walk of at most ``max_order`` orders, Russian
roulette — with the parity or Threefry draws in the JAX draw order.
Two optional modes:

  * textures (the TPU kernel's ``tex`` variant, 86 input rows): the
    texture prologue (ops/kernels/tex_prologue.py, its own kernel on
    the card) resolves the taps into per-lane material overrides
    ``mat`` [R, MAT_COLS] (base colour, emission, metallic, roughness,
    transmission) and, with a normal map, the mapped front-face normal
    ``ff_mapped`` [R, 3] where ``has_nmap`` [R].  The roughness in
    ``mat`` is already floored before its texture multiply and is not
    floored again; ``outside`` and the emission MIS weight keep the
    unmapped normal;
  * next-event estimation (the ``nee`` variant, 26 output rows): with
    ``light_tris`` [L, 16] / ``light_cdf`` [L] and ``prev_pdf`` [R],
    diffuse lanes draw r1, r2, r3 after the lobe pick, pick a light
    (searchsorted-left on the cdf, clamped to the last light), sample a
    point on it, and the walk estimates f * cos toward it (the eval
    hook of ops/bsdf.py).  Outputs add prev_pdf' and the shadow query:
    origin, direction, t_lim and the pending contribution, which the
    caller adds where the shadow ray reaches the light.  Lanes without a
    light sample carry the parked query of the TPU kernel (origin 1e30,
    direction +z, t_lim 1, contribution 0).

The TPU kernel's ``tri_sel`` variant (small scenes select their shade
rows in the kernel) is the gather form here: each lane reads its own
``tri_shade[tri]`` row, whatever the scene's size — no [82, R] row pack
(328 MB at 2^20 lanes).

The plain version below is the port of the JAX package's jnp shade
path (``render/megakernel.py::shade_step``, the oracle the Pallas
kernel is held to); the CUDA kernel repeats its arithmetic lane by
lane.  The same sequence with the basic BSDF is ``shade_basic``, the
route of ``use_microfacet=False`` on every device, counted apart
(as ``shade_basic``'s plain calls): the JAX package has no kernel for
it either.

On the card (csrc/shade.cu): one thread a lane.  A dead lane copies
through and a miss writes the environment, neither reading tri_shade; a
hit lane shades whole in registers (its tri_shade row in float4 loads,
the walk, Russian roulette).  Bound: instruction issue (the walk's log,
sin/cos, divides and draws); the counted bound is ``tools/harness.py``
``shade_ops`` (operations) beside the bytes.
"""

from __future__ import annotations

import torch

from logipathtracer_tpu_torch.film.image import srgb_to_linear
from logipathtracer_tpu_torch.ops import bsdf
from logipathtracer_tpu_torch.ops.intersect import (INF, barycentric, cross3,
                                                    dot3, transform_dir,
                                                    transform_point)
from logipathtracer_tpu_torch.ops.kernels import _build
from logipathtracer_tpu_torch.ops.rng import get_rand

SOURCE = "logipathtracer_tpu_torch/csrc/shade.cu"
REPLACES = "logipathtracer_tpu/ops/pallas/shade.py:765"

# Material override columns (the obj_shade slots 21:31 the TPU
# kernel's texture prologue overwrites).
MAT_COLS = 10          # base rgba 0:4, emission 4:7, metallic 7,
#                        roughness 8, transmission 9
PARK = 1e30            # shadow origin of lanes without a light sample
T_LIM_SCALE = 1.0 - 1e-3


def _unit_like(v, axis: int):
    u = torch.zeros_like(v)
    u[..., axis] = 1.0
    return u


def normalize(v):
    return v / torch.sqrt(torch.clamp(dot3(v, v), min=1e-38))[..., None]


def tangent_basis(ff):
    pick_y = torch.abs(ff[:, 0]) > 0.1
    axis = torch.where(pick_y[:, None], _unit_like(ff, 1), _unit_like(ff, 0))
    u = normalize(cross3(axis, ff))
    return u, cross3(ff, u)


def shade_plain(*args, **kw):
    """Plain PyTorch shading step with the Heitz BSDF: K2's plain
    version, with ``shade``'s arguments.  Returns (origin, direction,
    acc, mask, alive, seed), and with a light table (prev_pdf', shadow
    origin, shadow direction, t_lim, contribution) after them."""
    _build.plain("shade")
    return _shade_step(*args, basic=False, **kw)


def shade_basic(*args, **kw):
    """The shading step with the basic BSDF (use_microfacet=False), in
    plain PyTorch on any device: the JAX package shades this BSDF in jnp
    and has no kernel for it.  Arguments and results as ``shade``'s,
    without ``max_order``; with NEE the light sample's f is
    base * max(cos, 0) / pi."""
    _build.plain("shade_basic")
    return _shade_step(*args, max_order=0, basic=True, **kw)


def _shade_step(tri_shade, origin, direction, acc, mask, alive, seed,
                bounce, t, tri, *, env: float, rr_threshold: float,
                rr_bounces: int, max_order: int, parity: bool, basic: bool,
                mat=None, ff_mapped=None, has_nmap=None, light_tris=None,
                light_cdf=None, prev_pdf=None, nee_mis: bool = True,
                total_light_area: float = 0.0):
    """The JAX package's jnp shading sequence, the BSDF step chosen by
    ``basic``: the basic lobes, else the Heitz walk of at most
    ``max_order`` orders."""
    rand = get_rand(parity)
    nee = light_tris is not None
    miss = alive & (t >= INF)
    acc = torch.where(miss[:, None], mask * env, acc)
    alive = alive & ~miss

    ts64 = tri_shade[tri.clamp(min=0).long()]              # [R, 64]
    tshade = ts64[:, 0:32]
    oshade = ts64[:, 32:64]
    world3 = oshade[:, 0:9].reshape(-1, 3, 3)
    inv34 = oshade[:, 9:21].reshape(-1, 3, 4)
    mrti = oshade[:, 28:32]

    o_loc = transform_point(inv34, origin)
    d_loc = transform_dir(inv34, direction)
    pos_w = origin + t[:, None] * direction
    pos_loc = o_loc + t[:, None] * d_loc
    bary = barycentric(pos_loc, tshade[:, 15:18], tshade[:, 18:21],
                       tshade[:, 21:24])

    ior = mrti[:, 3]
    if mat is None:
        base_color = oshade[:, 21:25]
        emission = oshade[:, 25:28]
        metallic = mrti[:, 0]
        roughness = torch.clamp(mrti[:, 1], min=0.001)
        transmission = mrti[:, 2]
    else:
        base_color = mat[:, 0:4]
        emission = mat[:, 4:7]
        metallic = mat[:, 7]
        roughness = mat[:, 8]
        transmission = mat[:, 9]
    base_color = srgb_to_linear(base_color)

    lobe, seed = bsdf.determine_interaction(metallic, transmission, seed,
                                            alive, rand=rand)

    n_loc = (bary[:, 0:1] * tshade[:, 0:3] + bary[:, 1:2] * tshade[:, 3:6]
             + bary[:, 2:3] * tshade[:, 6:9])
    n = normalize(transform_dir(world3, n_loc))
    ndotd = dot3(n, direction)
    ff = torch.where((ndotd < 0.0)[:, None], n, -n)

    # Emission with the pre-bounce mask.  Under NEE + MIS, emission that
    # a BSDF ray from a light-sampled vertex finds carries the balance
    # weight prev_pdf / (prev_pdf + p_light); elsewhere weight 1.
    if nee:
        p_light_hit = t * t / (torch.clamp(torch.abs(ndotd), min=1e-9)
                               * total_light_area)
        is_emitter = torch.amax(emission, dim=-1) > 0.0
        mis_w = (prev_pdf / (prev_pdf + p_light_hit) if nee_mis
                 else torch.zeros_like(prev_pdf))
        w_emit = torch.where((prev_pdf > 0.0) & is_emitter, mis_w, 1.0)
        acc = acc + torch.where(alive[:, None],
                                mask * emission * w_emit[:, None], 0.0)
    else:
        acc = acc + torch.where(alive[:, None], mask * emission, 0.0)

    if ff_mapped is not None:
        ff = torch.where(has_nmap[:, None], ff_mapped, ff)
    u, v = tangent_basis(ff)

    nd = -direction
    view = torch.stack([dot3(nd, u), dot3(nd, v), dot3(nd, ff)], -1)
    outside = dot3(n, nd) > 0.0

    if nee:
        nee_mask = alive & (lobe == bsdf.LOBE_DIFFUSE)
        r1, seed = rand(seed, nee_mask)
        r2, seed = rand(seed, nee_mask)
        r3, seed = rand(seed, nee_mask)
        li = torch.searchsorted(light_cdf, r1).clamp(
            0, light_tris.shape[0] - 1)
        row = light_tris[li]
        lv0, le1, le2, le = row[:, 0:3], row[:, 3:6], row[:, 6:9], \
            row[:, 9:12]
        su = torch.sqrt(r2)
        lp = (lv0 + (1.0 - su)[:, None] * le1 + (r3 * su)[:, None] * le2)
        ldir = lp - torch.where(nee_mask[:, None], pos_w, 0.0)
        dist2 = torch.clamp(dot3(ldir, ldir), min=1e-12)
        dist = torch.sqrt(dist2)
        wl = ldir / dist[:, None]
        ln = cross3(le1, le2)
        ln = ln / torch.clamp(torch.sqrt(dot3(ln, ln)), min=1e-20)[:, None]
        cos_l = torch.abs(dot3(ln, -wl))          # two-sided emitter
        cos_s = dot3(ff, wl)
        wl_t = torch.stack([dot3(wl, u), dot3(wl, v), cos_s], -1)
        p_light = dist2 / (torch.clamp(cos_l, min=1e-9) * total_light_area)
        p_bsdf_l = torch.clamp(cos_s, min=0.0) / bsdf.PI
        w_light = (p_light / (p_light + p_bsdf_l) if nee_mis
                   else torch.ones_like(p_light))
        if basic:
            weight, ldir_t, seed = bsdf.basic_sample(
                base_color[:, :3], view, transmission, ior, outside, lobe,
                seed, alive, rand=rand)
            f_d = (base_color[:, :3] * torch.clamp(cos_s, min=0.0)[:, None]
                   / bsdf.PI)
            geom = cos_s * cos_l * total_light_area / dist2
            contrib = mask * le * f_d * (geom * w_light)[:, None]
        else:
            weight, ldir_t, seed, f_eval = bsdf.heitz_sample(
                base_color[:, :3], view, roughness, transmission, ior,
                outside, lobe, seed, alive, max_order=max_order, rand=rand,
                eval_dir=wl_t, eval_mask=nee_mask)
            # f_eval carries the surface cosine; the light side remains.
            contrib = mask * le * f_eval * (
                cos_l * total_light_area / dist2 * w_light)[:, None]
        use = nee_mask & (cos_s > 0.0)
        contrib = torch.where(use[:, None], contrib, 0.0)
        shadow_o = torch.where(nee_mask[:, None], pos_w, PARK)
        shadow_d = torch.where(nee_mask[:, None], wl, _unit_like(wl, 2))
        t_lim = torch.where(nee_mask, dist * T_LIM_SCALE, 1.0)
        # pdf (cos/pi) of the direction the diffuse lobe sampled: the
        # next vertex's emission MIS input.
        new_pdf = torch.where(
            nee_mask, torch.clamp(ldir_t[:, 2], min=0.0) / bsdf.PI, 0.0)
    elif basic:
        weight, ldir_t, seed = bsdf.basic_sample(
            base_color[:, :3], view, transmission, ior, outside, lobe, seed,
            alive, rand=rand)
    else:
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
    out = (origin, direction, acc, mask, alive, seed)
    if not nee:
        return out
    return out + (torch.where(alive, new_pdf, prev_pdf), shadow_o,
                  shadow_d, t_lim, contrib)


def shade(tri_shade, origin, direction, acc, mask, alive, seed, bounce, t,
          tri, *, env: float, rr_threshold: float, rr_bounces: int,
          max_order: int, parity: bool, mat=None, ff_mapped=None,
          has_nmap=None, light_tris=None, light_cdf=None, prev_pdf=None,
          nee_mis: bool = True, total_light_area: float = 0.0):
    """One shading step for R lanes.

    tri_shade [T, 64] f32; origin, direction, acc, mask [R, 3] f32;
    alive [R] bool; seed [R, 2] int64 (u32 words); bounce [R] i32;
    t [R] f32; tri [R] i32.  Textures: ``mat`` [R, MAT_COLS] f32, and
    ``ff_mapped`` [R, 3] f32 with ``has_nmap`` [R] bool where a normal
    map applies.  NEE: ``light_tris`` [L, 16] f32, ``light_cdf`` [L]
    f32, ``prev_pdf`` [R] f32.  Returns new (origin, direction, acc,
    mask, alive, seed), and with NEE (prev_pdf', shadow origin [R, 3],
    shadow direction [R, 3], t_lim [R], contribution [R, 3]) after them.
    A CPU tensor takes the plain version, a CUDA tensor the kernel."""
    kw = dict(env=env, rr_threshold=rr_threshold, rr_bounces=rr_bounces,
              max_order=max_order, parity=parity)
    opt = dict(mat=mat, ff_mapped=ff_mapped, has_nmap=has_nmap,
               light_tris=light_tris, light_cdf=light_cdf,
               prev_pdf=prev_pdf, nee_mis=nee_mis,
               total_light_area=total_light_area)
    dev = origin.device
    if dev.type == "cpu":
        return shade_plain(tri_shade, origin, direction, acc, mask, alive,
                           seed, bounce, t, tri, **kw, **opt)
    if dev.type != "cuda":
        raise ValueError(f"shade: unsupported device {dev}")
    r = origin.shape[0]
    f32 = torch.float32
    nee = light_tris is not None
    _build.require(tri_shade, "tri_shade", f32, (tri_shade.shape[0], 64),
                   dev)
    if tri_shade.data_ptr() % 16:
        raise ValueError("shade: tri_shade rows must be 16-byte aligned "
                         "(float4 loads)")
    for name, x in (("origin", origin), ("direction", direction),
                    ("acc", acc), ("mask", mask)):
        _build.require(x, name, f32, (r, 3), dev)
    _build.require(alive, "alive", torch.bool, (r,), dev)
    _build.require(seed, "seed", torch.int64, (r, 2), dev)
    _build.require(bounce, "bounce", torch.int32, (r,), dev)
    _build.require(t, "t", f32, (r,), dev)
    _build.require(tri, "tri", torch.int32, (r,), dev)
    if mat is not None:
        _build.require(mat, "mat", f32, (r, MAT_COLS), dev)
    if (ff_mapped is None) != (has_nmap is None):
        raise ValueError("shade: ff_mapped and has_nmap go together")
    if ff_mapped is not None:
        _build.require(ff_mapped, "ff_mapped", f32, (r, 3), dev)
        _build.require(has_nmap, "has_nmap", torch.bool, (r,), dev)
    n_lights, nee_outs = 0, ()
    if nee:
        n_lights = light_tris.shape[0]
        if n_lights == 0 or prev_pdf is None or light_cdf is None:
            raise ValueError("shade: NEE needs lights, light_cdf and "
                             "prev_pdf")
        _build.require(light_tris, "light_tris", f32, (n_lights, 16), dev)
        _build.require(light_cdf, "light_cdf", f32, (n_lights,), dev)
        _build.require(prev_pdf, "prev_pdf", f32, (r,), dev)
    # The float outputs in two allocations, as contiguous views: [R, 3]
    # origin, direction, acc, mask (and with NEE shadow origin, shadow
    # direction, contribution), [R] prev_pdf' and t_lim.
    rows3 = torch.empty((7 if nee else 4, r, 3), dtype=f32,
                        device=dev).unbind(0)
    outs = (*rows3[:4], torch.empty_like(alive), torch.empty_like(seed))
    if nee:
        pdf_out, t_lim = torch.empty((2, r), dtype=f32, device=dev).unbind(0)
        nee_outs = (pdf_out, rows3[4], rows3[5], t_lim, rows3[6])
    if r == 0:
        return outs + nee_outs
    _build.launch("shade", "lpt_shade", tri_shade, origin, direction, acc,
                  mask, alive, seed, bounce, t, tri, r, *outs, float(env),
                  float(rr_threshold), int(rr_bounces), int(max_order),
                  bool(parity), mat, ff_mapped, has_nmap, light_tris,
                  light_cdf, prev_pdf if nee else None, n_lights,
                  *(nee_outs if nee else (None,) * 5), bool(nee_mis),
                  float(total_light_area), _build.stream_ptr(dev))
    _build.launched("shade", "+".join(
        m for m, on in (("tex", mat is not None), ("nee", nee)) if on)
        or "base")
    return outs + nee_outs


def sincos_mismatches(device) -> int:
    """The floats, of all 2^32 bit patterns, whose ``sincosf`` on the
    card differs in a bit from their ``sinf`` or ``cosf``: K2 takes
    ``sincosf`` where it needs both, which changes no bit only if this
    is 0."""
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    _build.launch("shade", "lpt_sincos_probe", bad,
                  _build.stream_ptr(device))
    return int(bad.item())


# Agreement rule between two shading answers (kernel vs plain on the
# card, the port vs the JAX package on the CPU).  A lane whose walk took
# another branch after a last-ulp difference of the libm (log, exp, sin,
# cos, pow) ends with another seed or alive flag; at most MAX_DIVERGED
# of lanes may do so.  On the other lanes the floats must agree as the
# JAX package's own kernel-vs-jnp test requires (tests/test_shade_kernel
# .py:59-72).
MAX_DIVERGED = 0.005
CLOSE_RTOL, CLOSE_ATOL, CLOSE_FRAC = 2e-5, 2e-6, 0.995
ALL_RTOL, ALL_ATOL = 2e-2, 1e-4

NAMES = ("origin", "direction", "acc", "mask", "alive", "seed")
NEE_NAMES = ("prev_pdf", "shadow_origin", "shadow_direction", "t_lim",
             "contrib")


def shade_agreement(ref, got):
    """ref, got: (origin, direction, acc, mask, alive, seed) as arrays,
    optionally followed by the NEE outputs (prev_pdf', shadow origin,
    shadow direction, t_lim, contribution), which are then held to the
    same float rule.  Raises AssertionError; returns (diverged fraction,
    max |diff| of the floats on agreeing lanes)."""
    import numpy as np
    names = NAMES + (NEE_NAMES if len(ref) > len(NAMES) else ())
    assert len(ref) == len(got) == len(names)
    r = {n: np.asarray(x) for n, x in zip(names, ref)}
    g = {n: np.asarray(x) for n, x in zip(names, got)}
    same = ((r["alive"] == g["alive"])
            & (r["seed"].astype(np.int64) == g["seed"].astype(np.int64))
            .all(-1))
    diverged = 1.0 - float(same.mean())
    assert diverged <= MAX_DIVERGED, f"{diverged:.3%} of lanes diverged"
    err = 0.0
    for n in names:
        if n in ("alive", "seed"):
            continue
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
