"""BSDF sampling: the fused Heitz multiple-scattering microfacet walk
and the basic single-scatter lobes (the JAX package's ``ops/bsdf.py``;
shaders/heitz/BSDF.glsl, shaders/basic/BSDF.glsl).

Vectorized masked loop over [...] lanes.  Every iteration draws the
height sample (1 rand) and the VNDF micro-normal (2 rands) on walking
lanes, then the lobe tails (diffuse: 2 concentric-disk rands;
dielectric: 1 Fresnel rand).  Masked draws advance each lane's stream
exactly as the scalar reference does.  Lanes that stopped walking
change nothing, so the loop ends early once no lane walks — the
results equal the JAX package's fixed ``max_order`` trip.

Every sum of three products is written out in one fixed order; the
CUDA shading kernel (csrc/shade.cu) repeats this arithmetic.

lobe ∈ {0: diffuse, 1: metallic, 2: transmission}.  ``basic_sample``
(use_microfacet=False) draws a fixed number of rands per lobe, so its
seeds equal the JAX package's on every lane.
"""

from __future__ import annotations

import torch

from logipathtracer_tpu_torch.ops.intersect import cross3, dot3
from logipathtracer_tpu_torch.ops.rng import rand_parity_masked

PI = 3.141592653589  # shaders/common/constants.glsl:5

LOBE_DIFFUSE = 0
LOBE_METALLIC = 1
LOBE_TRANSMISSION = 2


def determine_interaction(metallic, transmission, seed, active,
                          rand=rand_parity_masked):
    """One-sample lobe selection (heitz/interaction_type.glsl:10-29).
    Returns (lobe int32, seed').  Consumes 1 rand on active lanes."""
    metallic_w = metallic
    transmission_w = (1.0 - metallic) * transmission
    dielectric_w = (1.0 - transmission) * (1.0 - metallic)
    norm = 1.0 / (metallic_w + transmission_w + dielectric_w)
    metallic_w = metallic_w * norm
    transmission_w = transmission_w * norm
    r, seed = rand(seed, active)
    lobe = torch.where(
        r < metallic_w, LOBE_METALLIC,
        torch.where(r < metallic_w + transmission_w, LOBE_TRANSMISSION,
                    LOBE_DIFFUSE))
    return lobe.to(torch.int32), seed


def _normalize(v):
    return v / torch.sqrt(torch.clamp(dot3(v, v), min=1e-38))[..., None]


def _unit(v, axis: int):
    u = torch.zeros_like(v)
    u[..., axis] = 1.0
    return u


def fresnel_dielectric(vdoth, eta):
    """Exact unpolarized dielectric Fresnel (heitz/BSDF.glsl:10-24)."""
    cos_t2 = 1.0 - (1.0 - vdoth * vdoth) / (eta * eta)
    cos_t = torch.sqrt(torch.clamp(cos_t2, min=0.0))
    rs = (vdoth - eta * cos_t) / (vdoth + eta * cos_t)
    rp = (eta * vdoth - cos_t) / (eta * vdoth + cos_t)
    f = 0.5 * (rs * rs + rp * rp)
    return torch.where(cos_t2 <= 0.0, 1.0, f)


def refract_eta(wi, wm, eta):
    """Refraction about a micro-normal (heitz/BSDF.glsl:26-32)."""
    eta = eta[..., None]
    cos_i = dot3(wi, wm)[..., None]
    cos_t2 = 1.0 - (1.0 - cos_i * cos_i) / (eta * eta)
    cos_t = -torch.sqrt(torch.clamp(cos_t2, min=0.0))
    return wm * (cos_i / eta + cos_t) - wi / eta


def sample_vndf(ve, alpha, r1, r2):
    """GGX visible-normal sampling (heitz/BSDF.glsl:41-67)."""
    a = alpha
    vh = _normalize(torch.stack([a * ve[..., 0], a * ve[..., 1],
                                 ve[..., 2]], -1))
    t1 = torch.where((vh[..., 2] < 1.0)[..., None],
                     _normalize(cross3(_unit(vh, 2), vh)), _unit(vh, 0))
    t2 = cross3(vh, t1)
    r = torch.sqrt(r1)
    phi = (2.0 * PI) * r2
    t1c = r * torch.cos(phi)
    t2c = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    t2c = ((1.0 - s) * torch.sqrt(torch.clamp(1.0 - t1c * t1c, min=0.0))
           + s * t2c)
    nz = torch.sqrt(torch.clamp(1.0 - t1c * t1c - t2c * t2c, min=0.0))
    nh = t1c[..., None] * t1 + t2c[..., None] * t2 + nz[..., None] * vh
    return _normalize(torch.stack(
        [a * nh[..., 0], a * nh[..., 1],
         torch.clamp(nh[..., 2], min=0.0)], -1))


def sample_ggx_height(direction, height, alpha, r):
    """Free-path height sampling on the Smith microsurface
    (heitz/BSDF.glsl:72-84)."""
    sx = direction[..., 0] * alpha
    sy = direction[..., 1] * alpha
    sz = direction[..., 2]
    length = torch.sqrt(sx * sx + sy * sy + sz * sz)
    projected = torch.clamp(0.5 * (length - direction[..., 2]), min=1e-7)
    delta = -torch.log(1.0 - r) * direction[..., 2] / projected
    return height + delta


def _concentric_disk(r1, r2):
    """Concentric disk mapping (heitz/BSDF.glsl:218-231)."""
    r1s = torch.where(r1 == 0.0, 1.0, r1)
    r2s = torch.where(r2 == 0.0, 1.0, r2)
    use_r1 = r1 * r1 > r2 * r2
    radius = torch.where(use_r1, r1, r2)
    phi = torch.where(use_r1, (PI / 4.0) * (r2 / r1s),
                      (PI / 2.0) - (r1 / r2s) * (PI / 4.0))
    both_zero = (r1 == 0.0) & (r2 == 0.0)
    radius = torch.where(both_zero, 0.0, radius)
    phi = torch.where(both_zero, 0.0, phi)
    return radius, phi


def heitz_sample(base_color, view_dir, roughness, transmission, ior,
                 outside, lobe, seed, active, max_order: int = 16,
                 rand=rand_parity_masked, eval_dir=None, eval_mask=None):
    """Fused Heitz random walk for all three lobes.

    base_color [..., 3]; view_dir [..., 3] tangent space; roughness,
    transmission, ior [...]; outside, active [...] bool; lobe [...]
    int32; seed [..., 2] int64.

    ``eval_dir`` [..., 3] (tangent space, toward a light sample) and
    ``eval_mask`` [...] bool: the walk also estimates the diffuse lobe's
    BSDF times cosine toward it (the NEE hook): at every scattering
    vertex it adds energy * base * phase(-> eval_dir) * P_escape, with
    the escape probability of the walk's own free-path model.  No extra
    draws.

    Returns (weight [..., 3], light_dir [..., 3] tangent space, seed'),
    and f_eval [..., 3] as a fourth value when ``eval_dir`` is given.
    """
    alpha = roughness * roughness
    is_diff = active & (lobe == LOBE_DIFFUSE)
    is_metal = active & (lobe == LOBE_METALLIC)
    is_trans = active & (lobe == LOBE_TRANSMISSION)

    light_dir = -view_dir
    height = torch.zeros_like(roughness)
    energy = torch.ones_like(base_color)
    ior_out = torch.where(outside, 1.0, ior)
    ior_in = torch.where(outside, ior, 1.0)
    walk_outside = torch.ones_like(outside)
    walking = active

    if eval_dir is not None:
        f_eval = torch.zeros_like(base_color)
        # From height h < 0 a segment toward w leaves the microsurface
        # with P = exp(h * proj(w) / w.z) (the sample_ggx_height model).
        sx = eval_dir[..., 0] * alpha
        sy = eval_dir[..., 1] * alpha
        sz = eval_dir[..., 2]
        proj_l = torch.clamp(
            0.5 * (torch.sqrt(sx * sx + sy * sy + sz * sz) - sz), min=1e-7)
        esc_rate = proj_l / torch.clamp(sz, min=1e-7)

    for _ in range(max_order):
        if not bool(walking.any()):
            break
        below = is_trans & ~walk_outside
        h_dir = torch.where(below[..., None], -light_dir, light_dir)
        h_in = torch.where(below, -height, height)
        r_h, seed = rand(seed, walking)
        h_raw = sample_ggx_height(h_dir, h_in, alpha, r_h)
        h_new = torch.where(below, -h_raw, h_raw)
        left = torch.where(below, h_new < 0.0, h_new > 0.0)
        height = torch.where(walking, h_new, height)
        cont = walking & ~left

        wo = -light_dir
        r1, seed = rand(seed, cont)
        r2, seed = rand(seed, cont)
        micro = sample_vndf(wo, alpha, r1, r2)
        vdoth = dot3(wo, micro)

        vdoth_c = torch.clamp(vdoth, 0.0, 1.0)
        refl_c = 2.0 * micro * vdoth_c[..., None] - wo

        d_mask = cont & is_diff
        du = torch.where((micro[..., 2] < 1.0)[..., None],
                         _normalize(cross3(_unit(micro, 2), micro)),
                         _unit(micro, 0))
        dv = cross3(micro, du)
        rd1, seed = rand(seed, d_mask)
        rd2, seed = rand(seed, d_mask)
        radius, phi = _concentric_disk(2.0 * rd1 - 1.0, 2.0 * rd2 - 1.0)
        dx = radius * torch.cos(phi)
        dy = radius * torch.sin(phi)
        dz = torch.sqrt(torch.clamp(1.0 - dx * dx - dy * dy, min=0.0))
        diff_dir = (dx[..., None] * du + dy[..., None] * dv
                    + dz[..., None] * micro)

        t_mask = cont & is_trans
        eta = torch.where(walk_outside, ior_in / ior_out, ior_out / ior_in)
        fres = fresnel_dielectric(vdoth, eta)
        r_f, seed = rand(seed, t_mask)
        reflect_choice = r_f < fres
        refl_t = 2.0 * micro * vdoth[..., None] - wo
        refr_t = _normalize(refract_eta(wo, micro, eta))
        trans_dir = torch.where(reflect_choice[..., None], refl_t, refr_t)
        walk_outside = torch.where(t_mask & ~reflect_choice,
                                   ~walk_outside, walk_outside)

        if eval_dir is not None:
            # Diffuse phase toward the light through this vertex's
            # micro-normal, times the escape probability from its height.
            phase_l = torch.clamp(dot3(eval_dir, micro), min=0.0) / PI
            esc = torch.exp(torch.clamp(height * esc_rate, max=0.0))
            em = cont & is_diff & eval_mask & (eval_dir[..., 2] > 0.0)
            f_eval = f_eval + torch.where(em, phase_l * esc, 0.0)[
                ..., None] * (energy * base_color)

        new_dir = torch.where(
            is_diff[..., None], diff_dir,
            torch.where(is_trans[..., None], trans_dir, refl_c))
        light_dir = torch.where(cont[..., None], new_dir, light_dir)
        mul = cont & (is_diff | is_metal)
        energy = torch.where(mul[..., None], energy * base_color, energy)
        walking = cont

    # Diffuse exhaustion: zero energy, light (0,0,1)
    # (heitz/BSDF.glsl:269-272); dielectric returns F0 (:208).
    d_ex = is_diff & walking
    energy = torch.where(d_ex[..., None], 0.0, energy)
    light_dir = torch.where(d_ex[..., None], _unit(light_dir, 2), light_dir)
    weight = torch.where(is_trans[..., None], base_color, energy)
    if eval_dir is not None:
        return weight, light_dir, seed, f_eval
    return weight, light_dir, seed


# ---------------------------------------------------------------------------
# Basic single-scatter BSDFs (shaders/basic/BSDF.glsl): the
# use_microfacet=False lobes.
# ---------------------------------------------------------------------------


def _reflect(i, n):
    return i - 2.0 * dot3(n, i)[..., None] * n


def _glsl_refract(i, n, eta):
    """GLSL refract(): the zero vector on total internal reflection."""
    ndoti = dot3(n, i)
    k = 1.0 - eta * eta * (1.0 - ndoti * ndoti)
    refr = (eta[..., None] * i
            - (eta * ndoti + torch.sqrt(torch.clamp(k, min=0.0)))[..., None]
            * n)
    return torch.where((k < 0.0)[..., None], 0.0, refr)


def basic_sample(base_color, view_dir, transmission, ior, outside, lobe,
                 seed, active, rand=rand_parity_masked):
    """Fused basic lobes (basic/BSDF.glsl:3-49; the JAX package's
    ``basic_sample``).

    diffuse: cosine hemisphere (2 rands); metallic: mirror about +z (0
    rands); transmission: Fresnel-weighted reflect or refract (1 rand).
    The reference's Fresnel quirk is kept: nc = 1 and nt = ior at the
    call site, the refraction taken against +z whatever side the ray
    comes from, and the zero vector on total internal reflection.

    Returns (weight [..., 3], light_dir [..., 3] tangent space, seed')."""
    is_diff = active & (lobe == LOBE_DIFFUSE)
    is_trans = active & (lobe == LOBE_TRANSMISSION)
    z_axis = _unit(view_dir, 2)

    # Diffuse (2 rands).
    r1, seed = rand(seed, is_diff)
    r2, seed = rand(seed, is_diff)
    phi = 2.0 * PI * r1
    r2s = torch.sqrt(r2)
    diff_dir = torch.stack([torch.cos(phi) * r2s, torch.sin(phi) * r2s,
                            torch.sqrt(1.0 - r2)], -1)
    diff_w = base_color * diff_dir[..., 2:3]

    # Specular mirror (0 rands).
    spec_dir = _reflect(-view_dir, z_axis)

    # Transmission (1 rand): basicFresnelReflectance(n = ±z, nl = +z,
    # rayDirection = -viewDir, nc = 1, nt = ior), basic/BSDF.glsl:19-49.
    normal = torch.where(outside[..., None], z_axis, -z_axis)
    ray_dir = -view_dir
    nc = torch.ones_like(ior)
    nt = ior
    nnt = torch.where(dot3(ray_dir, normal) < 0.0, nc / nt, nt / nc)
    tdir = _glsl_refract(ray_dir, z_axis, nnt)
    cos_inc = dot3(z_axis, ray_dir)
    cos_tra = dot3(z_axis, tdir)
    coef_para = (nt * cos_inc - nc * cos_tra) / (nt * cos_inc + nc * cos_tra)
    coef_perp = (nc * cos_inc - nt * cos_tra) / (nc * cos_inc + nt * cos_tra)
    re = (coef_para * coef_para + coef_perp * coef_perp) * 0.5
    r_t, seed = rand(seed, is_trans)
    reflect_choice = r_t < re
    trans_dir = torch.where(reflect_choice[..., None],
                            _reflect(-view_dir, normal), tdir)
    trans_w = torch.where(reflect_choice[..., None], 1.0,
                          base_color * transmission[..., None])

    light_dir = torch.where(
        is_diff[..., None], diff_dir,
        torch.where(is_trans[..., None], trans_dir, spec_dir))
    weight = torch.where(
        is_diff[..., None], diff_w,
        torch.where(is_trans[..., None], trans_w, base_color))
    return weight, light_dir, seed
