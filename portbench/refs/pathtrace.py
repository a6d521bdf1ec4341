"""The plain reference: a path tracer of the reference renderer's
semantics (LogiPathTracer ``shaders/path_tracing.comp`` with the Heitz
multiple-scattering BSDF of ``shaders/heitz/BSDF.glsl``, or its basic
BSDF), written in plain PyTorch from the scalar transcription of the
GLSL that the repository's tests hold the JAX package to, vectorised
over independent paths.

It takes the benchmark's scene description (materials, object-space
triangles and normals, world matrices, cameras), never the program's
compiled scene: it inverts each world matrix itself, and its
intersection is its own (each object's world bounding box, then every
triangle of the objects a ray's slab passes, in object space, with the
Moller-Trumbore test, ``t > eps`` and a strict ``<``).  A path is a
(pixel, host seed pair, camera): its stream is the reference's GLSL
hash seeded with ``seed * pixel`` (random.glsl, path_tracing.comp:341),
so a path's radiance depends on nothing else, whatever pool or order a
renderer traces it in.

Texture maps (LOD 0, following the JAX package's ``ops/texture.py``
and the texture prologue of its ``render/megakernel.py``): the hit's uv
from its barycentrics; per texture, its own texels (RGBA8 / 255) tapped
bilinearly at uv * size - 0.5, or at floor(uv * size) where the
sampler's magFilter is NEAREST, through the repeat, clamp or mirror
wrap of each axis.  The maps multiply the factors in the order base
colour, emissive, metallic-roughness (G roughness, B metallic, after
the 0.001 roughness floor), transmission (R); the base colour goes from
sRGB to linear after the multiply, the emission stays as stored; a
normal map (2 x RGB - 1, normalised) turns the front-face normal in the
tangent basis from before the map, and the basis is rebuilt about the
mapped normal, while the inside/outside test keeps the geometric one.

Next-event estimation with multiple importance sampling (``render``
``nee``; the JAX package's ``ops/pallas/shade.py`` NEE blocks and its
jnp twin in ``render/megakernel.py`` ``shade_step``): its own light
table of world-space emissive triangles (positive area, in scene order)
and their area-proportional CDF, picked by searchsorted-left; on every
diffuse lane three draws r1, r2, r3 before the BSDF's, the light point
at square-root barycentrics; a shadow ray through this module's own
intersection, blocked by any hit with eps < t < dist (1 - 1e-3); the
balance heuristic between the light's area pdf and cos/pi (or weight 1
without ``nee_mis``); for the Heitz BSDF the light's f cos estimated
along the sampling walk (phase toward the light times the escape
probability from each vertex's height), for the basic BSDF
base cos / pi; and the complementary weight on emission that a BSDF ray
from a light-sampled vertex finds.

Departures from the source (the GLSL renders neither): mip chains
(``mip_levels`` > 1) are not followed, only LOD 0, which the
configurations keep; textures are sampled one texture at a time from
their own arrays, not from the program's atlas (a layout, not
semantics).

Every float computation runs in ``dtype``: float32 as the configuration
states, or a lower precision for the control.  Sums of three products
are written out in one order, and no matrix product is used (it could
run in TF32 on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.scenes.common import CLAMP, MIRROR, NEAREST, TEXTURE_SLOTS

INF = 3.4e38            # shaders/common/constants.glsl:9
PI = 3.141592653589     # shaders/common/constants.glsl:5
M32 = 0xFFFFFFFF
MUL = 1103515245
INV32 = 2.0 ** -32      # float(0xffffffffu) is 2^32 in f32

LOBE_DIFFUSE, LOBE_METALLIC, LOBE_TRANSMISSION = 0, 1, 2
T_LIM = 1.0 - 1e-3      # a shadow ray's reach, as a share of the light's


# -- the GLSL hash stream (shaders/common/random.glsl:9-15) ---------------

def seed_from_pixel(ubo, pix):
    """ubo.seed * pixel.xy with u32 wraparound; int64 [N, 2] words."""
    a = ubo & M32
    b = pix & M32
    lo = a * (b & 0xFFFF)
    hi = (a * (b >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & M32


class Stream:
    """Per-path u32 state pairs; ``draw(mask)`` advances only ``mask``."""

    def __init__(self, state, dtype):
        self.s = state
        self.dtype = dtype

    def draw(self, mask):
        s = (self.s + 1) & M32
        sx, sy = s[:, 0], s[:, 1]
        qx = (MUL * ((sx >> 1) ^ sy)) & M32
        qy = (MUL * ((sy >> 1) ^ sx)) & M32
        n = (MUL * (qx ^ (qy >> 3))) & M32
        self.s = torch.where(mask[:, None], s, self.s)
        return (n.to(torch.float32) * INV32).to(self.dtype)


# -- vector helpers ---------------------------------------------------------

def dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def normalize(v):
    return v / torch.sqrt(torch.clamp(dot(v, v), min=1e-38))[..., None]


def unit(v, axis):
    u = torch.zeros_like(v)
    u[..., axis] = 1.0
    return u


def mat3_apply(m, v):
    """m [..., 3, >=3] times v [..., 3], row by row in one order."""
    return torch.stack([m[..., r, 0] * v[..., 0] + m[..., r, 1] * v[..., 1]
                        + m[..., r, 2] * v[..., 2] for r in range(3)], -1)


def srgb_to_linear(c):
    return torch.where(c <= 0.04045, c / 12.92,
                       torch.pow((c + 0.055) / 1.055, 2.4))


# -- the scene, as the reference holds it ------------------------------------

class RefScene:
    """Objects (one per mesh primitive) with their world matrix, its
    inverse, object-space triangles, normals and uvs, a padded world
    bounding box and the material's factors and texture slots; the
    textures; the light table.  On ``device`` in ``dtype``."""

    def __init__(self, scene, device, dtype=torch.float32):
        self.device = torch.device(device)
        self.dtype = dtype
        # The miss sentinel, as far as ``dtype`` reaches.
        self.inf = min(INF, float(torch.finfo(dtype).max))
        f = dict(device=self.device, dtype=dtype)
        self.objects = []
        for node in scene.mesh_nodes:
            world = np.asarray(node.world_matrix, np.float32)
            inv = np.linalg.inv(world.astype(np.float64)).astype(np.float32)
            for prim in node.primitives:
                pos = np.asarray(prim.positions, np.float32)
                mat = scene.materials[prim.material]
                wv = (pos.reshape(-1, 3).astype(np.float64)
                      @ world[:3, :3].T.astype(np.float64) + world[:3, 3])
                lo, hi = wv.min(axis=0), wv.max(axis=0)
                pad = 1e-4 * (hi - lo).max() + 1e-4
                v = torch.tensor(pos, **f)
                uv = (np.zeros(pos.shape[:2] + (2,), np.float32)
                      if prim.uvs is None else prim.uvs)
                self.objects.append(dict(
                    uv=torch.tensor(np.asarray(uv, np.float32), **f),
                    tex=[getattr(mat, k) for k in TEXTURE_SLOTS],
                    base_factor=torch.tensor(
                        np.asarray(mat.base_color_factor, np.float32), **f),
                    world=torch.tensor(world, **f),
                    inv=torch.tensor(inv, **f),
                    v=v, n=torch.tensor(np.asarray(prim.normals, np.float32),
                                        **f),
                    v0=v[:, 0], e1=v[:, 1] - v[:, 0], e2=v[:, 2] - v[:, 0],
                    bmin=torch.tensor(lo - pad, **f),
                    bmax=torch.tensor(hi + pad, **f),
                    base=srgb_to_linear(torch.tensor(
                        np.asarray(mat.base_color_factor, np.float32),
                        **f))[:3],
                    emission=torch.tensor(
                        np.asarray(mat.emissive_factor, np.float32), **f),
                    mrti=torch.tensor(np.array(
                        [mat.metallic_factor, mat.roughness_factor,
                         mat.transmission_factor, mat.ior], np.float32),
                        **f)))
        # Per-object tables for the shading gathers.
        self.tri_base = [0]
        for ob in self.objects:
            self.tri_base.append(self.tri_base[-1] + ob["v"].shape[0])
        cat = torch.cat
        self.all_v = cat([ob["v"] for ob in self.objects])
        self.all_n = cat([ob["n"] for ob in self.objects])
        self.world = torch.stack([ob["world"] for ob in self.objects])
        self.inv = torch.stack([ob["inv"] for ob in self.objects])
        self.base = torch.stack([ob["base"] for ob in self.objects])
        self.emission = torch.stack([ob["emission"] for ob in self.objects])
        self.mrti = torch.stack([ob["mrti"] for ob in self.objects])
        self.tri_base_t = torch.tensor(self.tri_base[:-1], device=self.device)
        self.textures = [self._texture(t) for t in scene.textures]
        self.tex = torch.tensor([ob["tex"] for ob in self.objects],
                                dtype=torch.int64, device=self.device)
        self.tex_slots = [bool((self.tex[:, k] >= 0).any())
                          for k in range(len(TEXTURE_SLOTS))]
        self.textured = any(self.tex_slots)
        if self.textured:
            self.all_uv = cat([ob["uv"] for ob in self.objects])
            self.base_factor = torch.stack([ob["base_factor"]
                                            for ob in self.objects])
        self._lights(scene)

    def _texture(self, t) -> dict:
        px = np.asarray(t.pixels, np.uint8)
        h, w = px.shape[:2]
        texels = torch.tensor(px.reshape(-1, 4).astype(np.float32),
                              device=self.device) / 255.0
        return dict(w=w, h=h, texels=texels.to(self.dtype),
                    wrap_s=int(t.wrap_s), wrap_t=int(t.wrap_t),
                    nearest=int(t.mag_filter) == NEAREST)

    def _lights(self, scene):
        """The emissive triangles in world space, in scene order, with
        their area-proportional CDF (numpy float32, as the scene's data
        is), and their total area."""
        rows = []
        for node in scene.mesh_nodes:
            world = np.asarray(node.world_matrix, np.float32)
            for prim in node.primitives:
                emission = np.asarray(
                    scene.materials[prim.material].emissive_factor,
                    np.float32)
                if emission.max() <= 0:
                    continue
                tw = (np.asarray(prim.positions, np.float32)
                      @ world[:3, :3].T + world[:3, 3])
                e1 = tw[:, 1] - tw[:, 0]
                e2 = tw[:, 2] - tw[:, 0]
                area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
                for k in np.nonzero(area > 0)[0]:
                    rows.append(np.concatenate(
                        [tw[k, 0], e1[k], e2[k], emission,
                         area[k:k + 1]]).astype(np.float32))
        self.num_lights = len(rows)
        if not rows:
            return
        table = np.stack(rows)
        areas = table[:, 12]
        self.light_area = float(areas.sum())
        cdf = (np.cumsum(areas) / areas.sum()).astype(np.float32)
        f = dict(device=self.device, dtype=self.dtype)
        self.light_cdf = torch.tensor(cdf, **f)
        self.light_table = torch.tensor(table[:, :12], **f)

    @property
    def triangle_count(self) -> int:
        return self.tri_base[-1]


# -- intersection -------------------------------------------------------------

CHUNK = 1 << 24   # (ray, triangle) pairs tested at once


def _slab(o, inv_d, bmin, bmax, best):
    near = (bmin - o) * inv_d
    far = (bmax - o) * inv_d
    t0 = torch.minimum(near, far).amax(dim=-1)
    t1 = torch.maximum(near, far).amin(dim=-1)
    # Conservative: NaN (a zero direction component on a slab face)
    # keeps the ray.
    return ~((t0 > t1) | (t1 < 0.0) | (t0 > best))


def _moller(ol, dl, v0, e1, e2, inf):
    """t of rays [m, 1] against triangles [1, T]; ``inf`` off the
    triangle."""
    ox, oy, oz = ol[:, 0:1], ol[:, 1:2], ol[:, 2:3]
    dx, dy, dz = dl[:, 0:1], dl[:, 1:2], dl[:, 2:3]
    e1x, e1y, e1z = e1[None, :, 0], e1[None, :, 1], e1[None, :, 2]
    e2x, e2y, e2z = e2[None, :, 0], e2[None, :, 1], e2[None, :, 2]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = 1.0 / (e1x * px + e1y * py + e1z * pz)
    tx = ox - v0[None, :, 0]
    ty = oy - v0[None, :, 1]
    tz = oz - v0[None, :, 2]
    u = (tx * px + ty * py + tz * pz) * det
    del px, py, pz
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    del tx, ty, tz
    v = (dx * qx + dy * qy + dz * qz) * det
    t = (e2x * qx + e2y * qy + e2z * qz) * det
    miss = (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0)
    return torch.where(miss, inf, t)


def intersect(rs: RefScene, o, d, eps, t_max=None):
    """Closest hit of world rays o, d [M, 3]: (t [M], object [M], the
    triangle's index within its object [M]); t = ``rs.inf`` and -1 on a
    miss.  With ``t_max`` [M], only hits with t < t_max count (a miss
    keeps t_max)."""
    m = o.shape[0]
    best = (torch.full((m,), rs.inf, dtype=rs.dtype, device=rs.device)
            if t_max is None else t_max.clone())
    best_obj = torch.full((m,), -1, dtype=torch.int64, device=rs.device)
    best_tri = torch.full((m,), -1, dtype=torch.int64, device=rs.device)
    inv_d = 1.0 / d
    for k, ob in enumerate(rs.objects):
        idx = torch.nonzero(_slab(o, inv_d, ob["bmin"], ob["bmax"], best)
                            ).squeeze(1)
        if idx.numel() == 0:
            continue
        inv = ob["inv"]
        ol = mat3_apply(inv, o[idx]) + inv[:3, 3]
        dl = mat3_apply(inv, d[idx])
        nt = ob["v0"].shape[0]
        tc = min(nt, CHUNK)
        rc = max(1, CHUNK // tc)
        for r0 in range(0, idx.numel(), rc):
            sel = idx[r0:r0 + rc]
            bt = best[sel]
            bo = best_obj[sel]
            btri = best_tri[sel]
            for c0 in range(0, nt, tc):
                t = _moller(ol[r0:r0 + rc], dl[r0:r0 + rc],
                            ob["v0"][c0:c0 + tc], ob["e1"][c0:c0 + tc],
                            ob["e2"][c0:c0 + tc], rs.inf)
                t = torch.where(t > eps, t, rs.inf)
                tmin, arg = torch.min(t, dim=1)
                take = tmin < bt
                bt = torch.where(take, tmin, bt)
                bo = torch.where(take, k, bo)
                btri = torch.where(take, arg + c0, btri)
            best[sel] = bt
            best_obj[sel] = bo
            best_tri[sel] = btri
    return best, best_obj, best_tri


# -- BSDFs (shaders/heitz/BSDF.glsl, shaders/basic/BSDF.glsl) ----------------

def _vndf(ve, alpha, r1, r2):
    vh = normalize(torch.stack([alpha * ve[:, 0], alpha * ve[:, 1],
                                ve[:, 2]], -1))
    t1 = torch.where((vh[:, 2] < 1.0)[:, None],
                     normalize(cross(unit(vh, 2), vh)), unit(vh, 0))
    t2 = cross(vh, t1)
    r = torch.sqrt(r1)
    phi = (2.0 * PI) * r2
    t1c = r * torch.cos(phi)
    t2c = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[:, 2])
    t2c = ((1.0 - s) * torch.sqrt(torch.clamp(1.0 - t1c * t1c, min=0.0))
           + s * t2c)
    nz = torch.sqrt(torch.clamp(1.0 - t1c * t1c - t2c * t2c, min=0.0))
    nh = t1c[:, None] * t1 + t2c[:, None] * t2 + nz[:, None] * vh
    return normalize(torch.stack([alpha * nh[:, 0], alpha * nh[:, 1],
                                  torch.clamp(nh[:, 2], min=0.0)], -1))


def _height(direction, height, alpha, r):
    sx = direction[:, 0] * alpha
    sy = direction[:, 1] * alpha
    sz = direction[:, 2]
    length = torch.sqrt(sx * sx + sy * sy + sz * sz)
    proj = torch.clamp(0.5 * (length - direction[:, 2]), min=1e-7)
    return height + (-torch.log(1.0 - r) * direction[:, 2] / proj)


def _fresnel(vdoth, eta):
    ct2 = 1.0 - (1.0 - vdoth * vdoth) / (eta * eta)
    ct = torch.sqrt(torch.clamp(ct2, min=0.0))
    rs = (vdoth - eta * ct) / (vdoth + eta * ct)
    rp = (eta * vdoth - ct) / (eta * vdoth + ct)
    return torch.where(ct2 <= 0.0, 1.0, 0.5 * (rs * rs + rp * rp))


def _refract(wi, wm, eta):
    ci = dot(wi, wm)[:, None]
    e = eta[:, None]
    ct2 = 1.0 - (1.0 - ci * ci) / (e * e)
    ct = -torch.sqrt(torch.clamp(ct2, min=0.0))
    return wm * (ci / e + ct) - wi / e


def heitz(f0, view, roughness, ior, outside, lobe, rng: Stream, active,
          max_order, eval_dir=None, eval_mask=None):
    """The three Heitz walks at once, each lane drawing in the scalar
    walk's order.  Returns (weight [N, 3], light direction [N, 3],
    tangent space), and with ``eval_dir`` [N, 3] (tangent space) the
    estimate of the diffuse lobe's f cos toward it on ``eval_mask``
    lanes: at each scattering vertex, energy x f0 x the phase toward it
    through the vertex's micro-normal x the escape probability from the
    vertex's height, with no draw of its own."""
    alpha = roughness * roughness
    if eval_dir is not None:
        f_eval = torch.zeros_like(f0)
        ez = eval_dir[:, 2]
        sl = torch.stack([eval_dir[:, 0] * alpha, eval_dir[:, 1] * alpha,
                          ez], -1)
        proj_l = torch.clamp(0.5 * (torch.sqrt(dot(sl, sl)) - ez),
                             min=1e-7)
        esc_rate = proj_l / torch.clamp(ez, min=1e-7)
    is_d = active & (lobe == LOBE_DIFFUSE)
    is_m = active & (lobe == LOBE_METALLIC)
    is_t = active & (lobe == LOBE_TRANSMISSION)
    ld = -view
    height = torch.zeros_like(roughness)
    energy = torch.ones_like(f0)
    ior_out = torch.where(outside, 1.0, ior)
    ior_in = torch.where(outside, ior, 1.0)
    up = torch.ones_like(outside)      # the dielectric walk's side
    walking = active
    for _ in range(max_order):
        if not bool(walking.any()):
            break
        below = is_t & ~up
        r_h = rng.draw(walking)
        h = _height(torch.where(below[:, None], -ld, ld),
                    torch.where(below, -height, height), alpha, r_h)
        h = torch.where(below, -h, h)
        left = torch.where(below, h < 0.0, h > 0.0)
        height = torch.where(walking, h, height)
        cont = walking & ~left

        wo = -ld
        r1 = rng.draw(cont)
        r2 = rng.draw(cont)
        micro = _vndf(wo, alpha, r1, r2)
        vdoth = dot(wo, micro)

        # conductor: reflect about the micro-normal, clamped cosine
        vc = torch.clamp(vdoth, 0.0, 1.0)
        refl_m = 2.0 * micro * vc[:, None] - wo

        # diffuse: a cosine-weighted direction about the micro-normal
        dm = cont & is_d
        du = torch.where((micro[:, 2] < 1.0)[:, None],
                         normalize(cross(unit(micro, 2), micro)),
                         unit(micro, 0))
        dv = cross(micro, du)
        a = 2.0 * rng.draw(dm) - 1.0
        b = 2.0 * rng.draw(dm) - 1.0
        use_a = a * a > b * b
        radius = torch.where(use_a, a, b)
        phi = torch.where(use_a,
                          (PI / 4.0) * (b / torch.where(a == 0.0, 1.0, a)),
                          (PI / 2.0) - (a / torch.where(b == 0.0, 1.0, b))
                          * (PI / 4.0))
        zero = (a == 0.0) & (b == 0.0)
        radius = torch.where(zero, 0.0, radius)
        phi = torch.where(zero, 0.0, phi)
        x = radius * torch.cos(phi)
        y = radius * torch.sin(phi)
        z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
        dif = x[:, None] * du + y[:, None] * dv + z[:, None] * micro

        # dielectric: Fresnel choice between reflection and refraction
        tm = cont & is_t
        eta = torch.where(up, ior_in / ior_out, ior_out / ior_in)
        fr = _fresnel(vdoth, eta)
        refl = rng.draw(tm) < fr
        die = torch.where(refl[:, None], 2.0 * micro * vdoth[:, None] - wo,
                          normalize(_refract(wo, micro, eta)))
        up = torch.where(tm & ~refl, ~up, up)

        if eval_dir is not None:
            phase_l = torch.clamp(dot(eval_dir, micro), min=0.0) / PI
            esc = torch.exp(torch.clamp(height * esc_rate, max=0.0))
            em = cont & is_d & eval_mask & (ez > 0.0)
            f_eval = f_eval + (torch.where(em, phase_l * esc, 0.0)[:, None]
                               * (energy * f0))

        new = torch.where(is_d[:, None], dif,
                          torch.where(is_t[:, None], die, refl_m))
        ld = torch.where(cont[:, None], new, ld)
        energy = torch.where((cont & (is_d | is_m))[:, None], energy * f0,
                             energy)
        walking = cont
    # A diffuse walk that never left returns zero and +z.
    ex = is_d & walking
    energy = torch.where(ex[:, None], 0.0, energy)
    ld = torch.where(ex[:, None], unit(ld, 2), ld)
    weight = torch.where(is_t[:, None], f0, energy)
    if eval_dir is not None:
        return weight, ld, f_eval
    return weight, ld


def _reflect(i, n):
    return i - 2.0 * dot(n, i)[:, None] * n


def basic(f0, view, transmission, ior, outside, lobe, rng: Stream, active):
    """The basic lobes: cosine diffuse (2 draws), mirror (none), Fresnel
    reflect or refract against +z (1 draw; the reference's quirks)."""
    is_d = active & (lobe == LOBE_DIFFUSE)
    is_t = active & (lobe == LOBE_TRANSMISSION)
    z = unit(view, 2)
    r1 = rng.draw(is_d)
    r2 = rng.draw(is_d)
    phi = 2.0 * PI * r1
    r2s = torch.sqrt(r2)
    dif = torch.stack([torch.cos(phi) * r2s, torch.sin(phi) * r2s,
                       torch.sqrt(1.0 - r2)], -1)
    spec = _reflect(-view, z)
    normal = torch.where(outside[:, None], z, -z)
    rd = -view
    nc = torch.ones_like(ior)
    nt = ior
    nnt = torch.where(dot(rd, normal) < 0.0, nc / nt, nt / nc)
    ndoti = dot(z, rd)
    k = 1.0 - nnt * nnt * (1.0 - ndoti * ndoti)
    tdir = (nnt[:, None] * rd
            - (nnt * ndoti + torch.sqrt(torch.clamp(k, min=0.0)))[:, None]
            * z)
    tdir = torch.where((k < 0.0)[:, None], 0.0, tdir)
    ci = dot(z, rd)
    ct = dot(z, tdir)
    cp = (nt * ci - nc * ct) / (nt * ci + nc * ct)
    cs = (nc * ci - nt * ct) / (nc * ci + nt * ct)
    re = (cp * cp + cs * cs) * 0.5
    refl = rng.draw(is_t) < re
    tr_dir = torch.where(refl[:, None], _reflect(-view, normal), tdir)
    tr_w = torch.where(refl[:, None], 1.0, f0 * transmission[:, None])
    ld = torch.where(is_d[:, None], dif,
                     torch.where(is_t[:, None], tr_dir, spec))
    w = torch.where(is_d[:, None], f0 * dif[:, 2:3],
                    torch.where(is_t[:, None], tr_w, f0))
    return w, ld


# -- textures (the JAX package's ops/texture.py, LOD 0) ----------------------

def _wrap(c, size: int, mode: int):
    """Integer texel coordinates through one axis's wrap mode."""
    if mode == CLAMP:
        return torch.clamp(c, 0, size - 1)
    if mode == MIRROR:
        m = torch.remainder(c, 2 * size)
        return torch.where(m < size, m, 2 * size - 1 - m)
    return torch.remainder(c, size)


def sample_texture(tex: dict, uv):
    """One texture's RGBA [M, 4] at uv [M, 2]: GL NEAREST, or bilinear
    about uv * size - 0.5."""
    w, h = tex["w"], tex["h"]

    def fetch(ix, iy):
        px = _wrap(ix, w, tex["wrap_s"])
        py = _wrap(iy, h, tex["wrap_t"])
        return tex["texels"][py * w + px]

    if tex["nearest"]:
        return fetch(torch.floor(uv[:, 0] * w).long(),
                     torch.floor(uv[:, 1] * h).long())
    fx = uv[:, 0] * w - 0.5
    fy = uv[:, 1] * h - 0.5
    ixf = torch.floor(fx)
    iyf = torch.floor(fy)
    ax = (fx - ixf)[:, None]
    ay = (fy - iyf)[:, None]
    ix = ixf.long()
    iy = iyf.long()
    c00 = fetch(ix, iy)
    c10 = fetch(ix + 1, iy)
    c01 = fetch(ix, iy + 1)
    c11 = fetch(ix + 1, iy + 1)
    top = c00 * (1 - ax) + c10 * ax
    bot = c01 * (1 - ax) + c11 * ax
    return top * (1 - ay) + bot * ay


def tap(rs: RefScene, slot: int, objc, uv, active):
    """(has a map [M], its RGBA [M, 4]) of texture slot ``slot`` of each
    lane's object, on ``active`` lanes; RGBA 1 where there is none."""
    tid = torch.where(active, rs.tex[objc, slot], -1)
    out = torch.ones((uv.shape[0], 4), dtype=rs.dtype, device=rs.device)
    for k in torch.unique(tid).tolist():
        if k >= 0:
            sel = torch.nonzero(tid == k).squeeze(1)
            out[sel] = sample_texture(rs.textures[k], uv[sel])
    return tid >= 0, out


def tangent_basis(ff):
    axis = torch.where((torch.abs(ff[:, 0]) > 0.1)[:, None],
                       unit(ff, 1), unit(ff, 0))
    tu = normalize(cross(axis, ff))
    return tu, cross(ff, tu)


# -- paths --------------------------------------------------------------------

def camera_rays(cams, fov_y, width, height, pix, rng: Stream, dtype):
    """Tent-jittered pinhole rays (path_tracing.comp:107-127); cams
    [N, 4, 4] (column vectors, looking down -z), pix [N, 2] (x, y)."""
    dev = pix.device
    res = torch.tensor([width, height], dtype=dtype, device=dev)
    tan_half = torch.tan(torch.tensor(fov_y, dtype=torch.float32) / 2.0
                         ).to(dtype).to(dev)
    on = torch.ones(pix.shape[0], dtype=torch.bool, device=dev)

    def tent(r):
        r = 2.0 * r
        return torch.where(r < 1.0, torch.sqrt(r) - 1.0,
                           1.0 - torch.sqrt(2.0 - r))

    j1 = tent(rng.draw(on))
    j2 = tent(rng.draw(on))
    jitter = torch.stack([j1, j2], -1) / (res * 0.5)
    uv = 2.0 * pix.to(dtype) / res - 1.0 + jitter
    aspect = res[0] / res[1]
    ux = uv[:, 0] * aspect * tan_half
    uy = uv[:, 1] * tan_half
    d = (ux[:, None] * cams[:, :3, 0] + uy[:, None] * cams[:, :3, 1]
         - cams[:, :3, 2])
    nrm = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                     + d[:, 2] * d[:, 2])
    return cams[:, :3, 3].clone(), d / nrm[:, None]


def trace(rs: RefScene, render, cams, fov_y, ubo, pix, block=1 << 16):
    """Radiance [N, 3] of N paths.

    render: the configuration's render settings (width, height,
    max_depth, rr_bounces, rr_threshold, env_color, eps,
    heitz_max_order, use_microfacet, nee, nee_mis); cams [N, 4, 4] or
    [4, 4]; ubo [N, 2] int64 host seed pairs; pix [N, 2] int64 (x, y),
    y counted from the image's bottom row."""
    n = pix.shape[0]
    out = torch.empty((n, 3), dtype=rs.dtype, device=rs.device)
    cams = torch.as_tensor(np.asarray(cams, np.float32)) if not isinstance(
        cams, torch.Tensor) else cams
    cams = cams.to(rs.device, rs.dtype)
    for b0 in range(0, n, block):
        sl = slice(b0, min(n, b0 + block))
        c = cams if cams.dim() == 2 else cams[sl]
        c = c.expand(sl.stop - sl.start, 4, 4) if c.dim() == 2 else c
        out[sl] = _trace_block(rs, render, c, fov_y,
                               ubo[sl].to(rs.device), pix[sl].to(rs.device))
    return out


def _visible(rs: RefScene, o, d, t_lim, want, eps):
    """[M] bool: no hit with eps < t < t_lim along o, d, tested on the
    ``want`` lanes (True elsewhere)."""
    vis = torch.ones_like(want)
    idx = torch.nonzero(want).squeeze(1)
    if idx.numel():
        _, obj, _ = intersect(rs, o[idx], d[idx], eps, t_max=t_lim[idx])
        vis[idx] = obj < 0
    return vis


def _textured(rs: RefScene, objc, g, bu, bv, bw, hit, base_f, emission,
              metallic, roughness, transmission):
    """The maps of slots 0-3 applied to the factors, in the program's
    order; returns (uv, linear base colour [M, 3], emission, metallic,
    roughness, transmission)."""
    uvs = rs.all_uv[g]
    uv = (bu[:, None] * uvs[:, 0] + bv[:, None] * uvs[:, 1]
          + bw[:, None] * uvs[:, 2])
    if rs.tex_slots[0]:
        has, c = tap(rs, 0, objc, uv, hit)
        base_f = torch.where(has[:, None], base_f * c, base_f)
    if rs.tex_slots[1]:
        has, e = tap(rs, 1, objc, uv, hit)
        emission = torch.where(has[:, None], emission * e[:, :3], emission)
    if rs.tex_slots[2]:
        has, mr = tap(rs, 2, objc, uv, hit)
        metallic = torch.where(has, metallic * mr[:, 2], metallic)
        roughness = torch.where(has, roughness * mr[:, 1], roughness)
    if rs.tex_slots[3]:
        has, tt = tap(rs, 3, objc, uv, hit)
        transmission = torch.where(has, transmission * tt[:, 0],
                                   transmission)
    return (uv, srgb_to_linear(base_f)[:, :3], emission, metallic,
            roughness, transmission)


def _trace_block(rs: RefScene, r, cams, fov_y, ubo, pix):
    dt = rs.dtype
    dev = rs.device
    nee = bool(r.get("nee", False)) and rs.num_lights > 0
    mis = bool(r.get("nee_mis", True))
    microfacet = r.get("use_microfacet", True)
    rng = Stream(seed_from_pixel(ubo, pix), dt)
    o, d = camera_rays(cams, fov_y, r["width"], r["height"], pix, rng, dt)
    n = pix.shape[0]
    acc = torch.zeros((n, 3), dtype=dt, device=dev)
    mask = torch.ones((n, 3), dtype=dt, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    # The pdf of a diffuse vertex's BSDF direction where it sampled a
    # light too (0 elsewhere): the weight of the emission that ray finds.
    prev_pdf = torch.zeros(n, dtype=dt, device=dev)
    for bounce in range(r["max_depth"]):
        lanes = torch.nonzero(alive).squeeze(1)
        if lanes.numel() == 0:
            break
        sub = Stream(rng.s[lanes], dt)
        lo, ld_, lm, la = o[lanes], d[lanes], mask[lanes], acc[lanes]
        t, obj, tri = intersect(rs, lo, ld_, r["eps"])
        miss = t >= rs.inf
        la = torch.where(miss[:, None], lm * r["env_color"], la)
        hit = ~miss
        objc = obj.clamp(min=0)
        g = rs.tri_base_t[objc] + tri.clamp(min=0)
        vtx = rs.all_v[g]
        nrm = rs.all_n[g]
        world = rs.world[objc]
        inv = rs.inv[objc]
        ol = mat3_apply(inv, lo) + inv[:, :3, 3]
        dl = mat3_apply(inv, ld_)
        pos_w = lo + t[:, None] * ld_
        pos_l = ol + t[:, None] * dl
        # barycentrics (shaders/common/util.glsl:23-41)
        ab = vtx[:, 1] - vtx[:, 0]
        ac = vtx[:, 2] - vtx[:, 0]
        ah = pos_l - vtx[:, 0]
        ab_ab, ab_ac, ac_ac = dot(ab, ab), dot(ab, ac), dot(ac, ac)
        ab_ah, ac_ah = dot(ab, ah), dot(ac, ah)
        inv_den = 1.0 / (ab_ab * ac_ac - ab_ac * ab_ac)
        bv = (ac_ac * ab_ah - ab_ac * ac_ah) * inv_den
        bw = (ab_ab * ac_ah - ab_ac * ab_ah) * inv_den
        bu = 1.0 - bv - bw

        emission = rs.emission[objc]
        mrti = rs.mrti[objc]
        metallic = mrti[:, 0]
        roughness = torch.clamp(mrti[:, 1], min=0.001)
        transmission = mrti[:, 2]
        ior = mrti[:, 3]
        if rs.textured:
            uv, base, emission, metallic, roughness, transmission = \
                _textured(rs, objc, g, bu, bv, bw, hit, rs.base_factor[objc],
                          emission, metallic, roughness, transmission)
        else:
            base = rs.base[objc]

        # lobe (heitz/interaction_type.glsl:10-29)
        mw = metallic
        tw = (1.0 - metallic) * transmission
        dw = (1.0 - transmission) * (1.0 - metallic)
        norm = 1.0 / (mw + tw + dw)
        mw = mw * norm
        tw = tw * norm
        rl = sub.draw(hit)
        lobe = torch.where(rl < mw, LOBE_METALLIC,
                           torch.where(rl < mw + tw, LOBE_TRANSMISSION,
                                       LOBE_DIFFUSE))

        n_l = (bu[:, None] * nrm[:, 0] + bv[:, None] * nrm[:, 1]
               + bw[:, None] * nrm[:, 2])
        nw = normalize(mat3_apply(world, n_l))
        ndotd = dot(nw, ld_)
        if nee:
            # Emission that a BSDF ray from a light-sampled vertex finds
            # takes the balance weight against the light's area pdf.
            lpp = prev_pdf[lanes]
            p_light_hit = t * t / (torch.clamp(torch.abs(ndotd), min=1e-9)
                                   * rs.light_area)
            mis_w = (lpp / (lpp + p_light_hit) if mis
                     else torch.zeros_like(lpp))
            w_emit = torch.where(
                (lpp > 0.0) & (torch.amax(emission, dim=-1) > 0.0), mis_w,
                1.0)
            la = la + torch.where(hit[:, None],
                                  lm * emission * w_emit[:, None], 0.0)
        else:
            la = la + torch.where(hit[:, None], lm * emission, 0.0)

        ff = torch.where((ndotd < 0.0)[:, None], nw, -nw)
        tu, tv = tangent_basis(ff)
        if rs.tex_slots[4]:
            # The normal map turns ff in the basis from before the map.
            has_n, nmap = tap(rs, 4, objc, uv, hit)
            tn = normalize(nmap[:, :3] * 2.0 - 1.0)
            ffm = normalize(tn[:, 0:1] * tu + tn[:, 1:2] * tv
                            + tn[:, 2:3] * ff)
            ff = torch.where(has_n[:, None], ffm, ff)
            tu, tv = tangent_basis(ff)
        nd = -ld_
        view = torch.stack([dot(nd, tu), dot(nd, tv), dot(nd, ff)], -1)
        outside = dot(nw, nd) > 0.0

        if nee:
            nee_mask = hit & (lobe == LOBE_DIFFUSE)
            r1 = sub.draw(nee_mask)
            r2 = sub.draw(nee_mask)
            r3 = sub.draw(nee_mask)
            li = torch.searchsorted(rs.light_cdf, r1).clamp(
                0, rs.num_lights - 1)
            row = rs.light_table[li]
            lv0, le1, le2, le = (row[:, 0:3], row[:, 3:6], row[:, 6:9],
                                 row[:, 9:12])
            su = torch.sqrt(r2)
            lp = lv0 + (1.0 - su)[:, None] * le1 + (r3 * su)[:, None] * le2
            to_l = lp - pos_w
            dist2 = torch.clamp(dot(to_l, to_l), min=1e-12)
            dist = torch.sqrt(dist2)
            wl = to_l / dist[:, None]
            ln = cross(le1, le2)
            ln = ln / torch.clamp(torch.sqrt(dot(ln, ln)), min=1e-20)[:, None]
            cos_l = torch.abs(dot(ln, -wl))       # two-sided emitter
            cos_s = dot(ff, wl)
            wl_t = torch.stack([dot(wl, tu), dot(wl, tv), cos_s], -1)
            p_light = dist2 / (torch.clamp(cos_l, min=1e-9) * rs.light_area)
            p_bsdf = torch.clamp(cos_s, min=0.0) / PI
            w_light = (p_light / (p_light + p_bsdf) if mis
                       else torch.ones_like(p_light))

        if microfacet and nee:
            w, ldir, f_eval = heitz(base, view, roughness, ior, outside,
                                    lobe, sub, hit, r["heitz_max_order"],
                                    eval_dir=wl_t, eval_mask=nee_mask)
        elif microfacet:
            w, ldir = heitz(base, view, roughness, ior, outside, lobe, sub,
                            hit, r["heitz_max_order"])
        else:
            w, ldir = basic(base, view, transmission, ior, outside, lobe,
                            sub, hit)
        if nee:
            if microfacet:
                # f_eval carries the surface cosine.
                contrib = lm * le * f_eval * (
                    cos_l * rs.light_area / dist2 * w_light)[:, None]
            else:
                f_d = base * torch.clamp(cos_s, min=0.0)[:, None] / PI
                geom = cos_s * cos_l * rs.light_area / dist2
                contrib = lm * le * f_d * (geom * w_light)[:, None]
            use = nee_mask & (cos_s > 0.0)
            use = use & _visible(rs, pos_w, wl, dist * T_LIM, use, r["eps"])
            la = la + torch.where(use[:, None], contrib, 0.0)
            new_pdf = torch.where(
                nee_mask, torch.clamp(ldir[:, 2], min=0.0) / PI, 0.0)
        lm = torch.where(hit[:, None], lm * w, lm)
        new_d = (ldir[:, 0:1] * tu + ldir[:, 1:2] * tv + ldir[:, 2:3] * ff)
        # Russian roulette (path_tracing.comp:317-323)
        q = torch.amax(lm, dim=-1)
        rr = hit & (q < r["rr_threshold"]) & (bounce > r["rr_bounces"])
        kill = rr & (sub.draw(rr) > q)
        lm = torch.where((rr & ~kill)[:, None], lm / q[:, None], lm)
        o[lanes] = torch.where(hit[:, None], pos_w, lo)
        d[lanes] = torch.where(hit[:, None], new_d, ld_)
        mask[lanes] = lm
        acc[lanes] = la
        rng.s[lanes] = sub.s
        alive[lanes] = hit & ~kill
        if nee:
            prev_pdf[lanes] = torch.where(hit & ~kill, new_pdf, lpp)
    return acc


# -- the display transform (shaders/tex_to_quad.frag:21-33) -------------------

def to_u8(accum, samples: int, exposure: float, gamma: float):
    """Radiance sums [..., 3] of ``samples`` samples -> uint8 RGBA."""
    hdr = accum.to(torch.float32) * (1.0 / samples)
    mapped = 1.0 - torch.exp(-hdr * exposure)
    mapped = torch.pow(torch.clamp(mapped, min=0.0), 1.0 / gamma)
    u8 = torch.clamp(mapped * 255.0 + 0.5, 0, 255).to(torch.uint8)
    alpha = torch.full(u8.shape[:-1] + (1,), 255, dtype=torch.uint8,
                       device=u8.device)
    return torch.cat([u8, alpha], -1)
