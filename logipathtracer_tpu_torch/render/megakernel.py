"""Megakernel render step (the JAX package's ``render/megakernel.py``):
every pixel's path carried through ``max_depth`` bounces in lockstep,
one ``accumulate_sample`` per sample — with the shading step, its
texture prologue and NEE shadow tail, the ray sort key and the intersect
backend selection that the wavefront renderer shares.

The step is eager PyTorch; the JAX package's jit and buffer donation
have no counterpart.  Each bounce parks dead lanes, sorts the rays by
coherence key (not for the BVH walk), intersects them through the
resolved backend — K1 (default), K7 (``compact_worklist=False``), K8
(``intersect="sweep"``), the jnp twin or the BVH walk — and shades them
with K2; on CPU tensors each kernel's plain version runs.  The basic
BSDF (``use_microfacet=False``) shades through ``shade.shade_basic``,
plain torch on every device, as the JAX package shades it in jnp.
"""

from __future__ import annotations

import torch

from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.ops.camera import generate_ray
from logipathtracer_tpu_torch.ops.kernels import shade as shade_kernel
from logipathtracer_tpu_torch.ops.kernels import tex_prologue
from logipathtracer_tpu_torch.ops.rng import get_rand, seed_from_pixel
from logipathtracer_tpu_torch.ops.traverse import (
    intersect_scene, intersect_scene_cluster_wl, intersect_scene_stream,
    intersect_scene_sweep, intersect_scene_worklist)
from logipathtracer_tpu_torch.utils import trace as tracing

# Residency budgets of the JAX package's sweep kernels.  The port keeps
# its predicate so both packages compile the same clusters
# (scene/compile.py auto cluster size) and resolve the same intersect
# mode for a scene.
SWEEP_VMEM_BUDGET = 10 * 2 ** 20
SWEEP_SMEM_BUDGET = 512 * 2 ** 10


def _pad128(n: int) -> int:
    return -(-n // 128) * 128


def resident_sweep_fits(c: int, lanes: int, num_objects: int,
                        cfg: RenderConfig, mode: str = "compact") -> bool:
    """Whether a scene of ``c`` clusters x ``lanes`` triangles is in the
    resident class (megakernel.py:78-102, unchanged)."""
    tile = cfg.compact_tile if mode == "compact" else cfg.sweep_tile
    vmem = (c * 16 * lanes * 4
            + num_objects * 16 * tile * 4
            + 8 * tile * 4
            + 6 * tile * 4)
    if mode == "compact":
        vmem += 8 * 128 * cfg.compact_cap * 4
    smem = (18 * _pad128(c) + num_objects * 128) * 4
    return vmem <= SWEEP_VMEM_BUDGET and smem <= SWEEP_SMEM_BUDGET


def resolve_intersect_mode(cfg: RenderConfig, scene=None) -> str:
    """The intersect mode a config resolves to for a scene (megakernel.py:
    105-114): 'auto' and 'compact_interpret' are 'compact', and
    'sweep_interpret' is 'sweep' (the port has no interpret mode); a
    'compact' or 'sweep' scene beyond the resident budget resolves to
    'stream', whatever the JAX package's TPU-only ``_stream_fits`` budget
    would say: its BVH fallback for scenes that miss that budget exists
    only for the TPU's scalar memory.  'auto' stays 'compact' where the
    JAX package takes the BVH walk off the TPU.  'bvh', 'sweep_jnp',
    'stream' and 'stream_interpret' stand as given."""
    mode = cfg.intersect
    if mode in ("auto", "compact_interpret"):
        mode = "compact"
    if mode == "sweep_interpret":
        mode = "sweep"
    if mode in ("compact", "sweep") and scene is not None:
        c, _, lanes = scene.cl_tris.shape
        if not resident_sweep_fits(c, lanes, scene.num_objects, cfg,
                                   mode=mode):
            mode = "stream"
    return mode


def pick_intersect(cfg: RenderConfig, scene=None):
    """The intersect closure for the resolved mode, routed as in the JAX
    package (megakernel.py:117-185): 'compact' is the compact worklist
    sweep (K1) with ``compact_worklist``, else the compact sweep over
    every cluster in octant order (K7); 'sweep' the dense resident sweep
    (K8); 'sweep_jnp' its jnp twin; 'bvh' the BVH stack walk; 'stream'
    with ``stream_worklist`` and a cap > 0 (the ``stream_cap`` of a
    ``stream_compact`` config, else 0) the frustum cluster worklist sweep
    (K4) for ``stream_granularity="cluster"`` and the chunk worklist
    sweep (K5) otherwise; any other 'stream' or 'stream_interpret' config
    the octant chunk sweep (K6) with that cap.  Each kernel runs on CUDA
    tensors and its plain version on CPU ones.  Every closure takes
    ``t_max`` and ``any_hit``, so the NEE shadow rays go through the same
    backend as the path rays; K8, the jnp twin and the BVH walk answer
    closest-hit, which gives the same t < t_max predicate."""
    mode = resolve_intersect_mode(cfg, scene)
    if mode in ("stream", "stream_interpret"):
        cap = cfg.stream_cap if cfg.stream_compact else 0
        if mode == "stream" and cfg.stream_worklist and cap > 0:
            if cfg.stream_granularity == "cluster":
                def isect(s, o, d, eps, t_max=None, any_hit=False):
                    return intersect_scene_cluster_wl(
                        s, o, d, eps=eps, tile=cfg.stream_tile, t_max=t_max,
                        cap=cap, any_hit=any_hit)
                return isect

            def isect(s, o, d, eps, t_max=None, any_hit=False):
                return intersect_scene_worklist(
                    s, o, d, eps=eps, tile=cfg.stream_tile,
                    chunk=cfg.stream_chunk, t_max=t_max, cap=cap,
                    any_hit=any_hit)
            return isect

        def isect(s, o, d, eps, t_max=None, any_hit=False):
            return intersect_scene_stream(
                s, o, d, eps=eps, tile=cfg.stream_tile,
                chunk=cfg.stream_chunk, t_max=t_max, cap=cap,
                any_hit=any_hit)
        return isect
    if mode == "bvh":
        return intersect_scene
    if mode in ("sweep", "sweep_jnp"):
        backend = "pallas" if mode == "sweep" else "jnp"

        def isect(s, o, d, eps, t_max=None, any_hit=False):
            return intersect_scene_sweep(s, o, d, eps=eps,
                                         tile=cfg.sweep_tile,
                                         backend=backend, t_max=t_max)
        return isect
    if mode != "compact":
        raise ValueError(f"unknown intersect mode {mode!r}")

    def isect(s, o, d, eps, t_max=None, any_hit=False):
        return intersect_scene_sweep(s, o, d, eps=eps, tile=cfg.compact_tile,
                                     t_max=t_max,
                                     worklist=cfg.compact_worklist,
                                     any_hit=any_hit)
    return isect


def intersect_tile(cfg: RenderConfig, scene=None) -> int:
    """Rays per kernel tile of the resolved intersect mode — what the
    pixel blocking is sized to (the sweep tile for 'sweep', 'sweep_jnp'
    and 'bvh', as in the JAX package)."""
    mode = resolve_intersect_mode(cfg, scene)
    if mode == "compact":
        return cfg.compact_tile
    if mode in ("stream", "stream_interpret"):
        return cfg.stream_tile
    return cfg.sweep_tile


def ray_sort_key(scene, origin, direction):
    """Direction octant (major) + 5-bit-per-axis Morton code of the
    origin within the scene bounds (megakernel.py:199-226)."""
    lo = scene.world_aabb[0]
    span = torch.clamp(scene.world_aabb[1] - lo, min=1e-9)

    def spread3(x):
        out = torch.zeros_like(x)
        for b in range(5):
            out = out | (((x >> b) & 1) << (3 * b))
        return out

    def quant(i):
        q = (origin[:, i] - lo[i]) / span[i] * 31.0
        # Clamp before the cast: equal to the reference's clip after an
        # int32 cast for every finite q, and defined beyond int32.
        return spread3(torch.clamp(q, 0.0, 31.0).to(torch.int32))

    morton = quant(0) | (quant(1) << 1) | (quant(2) << 2)
    octant = ((direction[:, 0] > 0).to(torch.int32) * 4
              + (direction[:, 1] > 0).to(torch.int32) * 2
              + (direction[:, 2] > 0).to(torch.int32))
    return (octant << 15) | morton


def sorted_intersect(isect, scene, origin, direction, eps):
    """Intersect the rays in sort-key order and un-permute the hits
    (megakernel.py:229-244): a stable sort by ``ray_sort_key``, one
    packed [R, 6] gather, the state kept in pixel order."""
    r = origin.shape[0]
    key = ray_sort_key(scene, origin, direction)
    _, perm = torch.sort(key, stable=True)
    packed = torch.cat([origin, direction], 1)[perm]
    t, obj, tri = isect(scene, packed[:, 0:3], packed[:, 3:6], eps=eps)
    inv_perm = torch.empty_like(perm)
    inv_perm[perm] = torch.arange(r, device=perm.device)
    return t[inv_perm], obj[inv_perm], tri[inv_perm]


def resolve_shade_mode(cfg: RenderConfig, scene=None) -> str:
    """'kernel' for the Heitz BSDF (kernel K2 on CUDA tensors, its plain
    version on CPU ones), for textured and untextured scenes, with or
    without NEE; 'basic' for ``use_microfacet=False``, which shades in
    plain torch on every device (megakernel.py:260-273 sends it to the
    jnp path).  ``cfg.shade`` chooses between TPU implementations and is
    ignored."""
    return "kernel" if cfg.use_microfacet else "basic"


def resolve_tex_prologue(scene, cfg: RenderConfig, origin, direction, t,
                         obj, tri, alive=None):
    """Texture taps for the shading kernel (megakernel.py:276-387): the
    per-lane gathers K2 does not do, through ``tex_prologue`` (the kernel
    on CUDA tensors, its plain version on CPU ones).  The kernel computes
    the lanes that are ``alive`` and hit (None: every lane with a hit)
    and writes zeros on the others; the plain version computes every
    lane.

    Returns (mat [R, MAT_COLS] f32 — base rgba, emission, metallic,
    roughness, transmission — and, when some object has a normal map,
    the mapped front-face normal [R, 3] and has-normal-map [R] bool;
    else None, None)."""
    return tex_prologue.tex_prologue(scene, cfg, origin, direction, t, obj,
                                     tri, alive=alive)


def shade_step(scene, cfg: RenderConfig, origin, direction, acc, mask,
               alive, seed, bounce, t, obj, tri, prev_pdf=None, isect=None,
               counts=None):
    """One shading iteration of the traceRay loop
    (path_tracing.comp:219-323) given the intersection results.
    ``bounce`` may be a python int or a per-lane int32 tensor.

    Textured scenes first run the texture prologue.  The Heitz BSDF
    shades through K2, the basic BSDF through ``shade.shade_basic``
    (the same inputs and outputs).  With ``cfg.nee``, lights in the
    scene and ``isect`` given, the step also samples a light per
    diffuse lane; the shadow rays then go through ``isect`` with t_max
    and any-hit, and the pending contribution is added where the light
    is visible (the post-kernel tail of megakernel.py:484-493).
    ``counts`` (the wavefront pool's trace buffer; None elsewhere) takes,
    on the device and without a host sync, the number of shadow rays
    cast into its shadow-ray column, and the stopwatch's stamps where
    their paths run (utils/trace.py): ``tex`` after the prologue, and
    with NEE ``shade`` after K2 and ``shadow`` after the visibility add.
    Returns (origin, direction, acc, mask, alive, seed, prev_pdf)."""
    basic = resolve_shade_mode(cfg, scene) == "basic"
    r = origin.shape[0]
    if prev_pdf is None:
        prev_pdf = torch.zeros(r, dtype=torch.float32, device=origin.device)
    if not isinstance(bounce, torch.Tensor) or bounce.dim() == 0:
        bounce = torch.full((r,), int(bounce), dtype=torch.int32,
                            device=origin.device)
    nee = bool(cfg.nee and scene.num_lights > 0 and isect is not None)
    opt = {}
    if scene.has_textures:
        mat, ff_mapped, has_nmap = resolve_tex_prologue(
            scene, cfg, origin, direction, t, obj, tri, alive=alive)
        opt.update(mat=mat, ff_mapped=ff_mapped, has_nmap=has_nmap)
        if counts is not None:
            tracing.stamp(counts, "tex")
    if nee:
        opt.update(light_tris=scene.light_tris, light_cdf=scene.light_cdf,
                   prev_pdf=prev_pdf.contiguous(), nee_mis=bool(cfg.nee_mis),
                   total_light_area=float(scene.total_light_area))
    if basic:
        shade = shade_kernel.shade_basic
    else:
        shade = shade_kernel.shade
        opt.update(max_order=int(cfg.heitz_max_order))
    out = shade(
        scene.tri_shade, origin, direction, acc, mask, alive, seed,
        bounce.to(torch.int32), t, tri.to(torch.int32),
        env=float(cfg.env_color), rr_threshold=float(cfg.rr_threshold),
        rr_bounces=int(cfg.rr_bounces), parity=bool(cfg.parity_rng), **opt)
    if not nee:
        # prev_pdf carries NEE state only; it passes through unchanged.
        return (*out, prev_pdf)
    origin, direction, acc, mask, alive, seed, prev_pdf, shadow_o, \
        shadow_d, t_lim, contrib = out
    if counts is not None:
        tracing.stamp(counts, "shade")
    t_s, _, _ = isect(scene, shadow_o, shadow_d, eps=cfg.eps, t_max=t_lim,
                      any_hit=True)
    if counts is not None:
        tracing.count_shadow(counts,
                             (shadow_o[:, 0] != shade_kernel.PARK).sum())
    visible = t_s >= t_lim
    acc = acc + torch.where(visible[:, None], contrib, 0.0)
    if counts is not None:
        tracing.stamp(counts, "shadow")
    return origin, direction, acc, mask, alive, seed, prev_pdf


def trace_rays(scene, cfg: RenderConfig, origin, direction, seed):
    """Path-trace a batch of rays: the traceRay loop (path_tracing.comp:
    211-327; megakernel.py:816-860), every lane through ``max_depth``
    bounces in lockstep.  Each bounce adds its alive count to the ray
    counter (on the device: no host read per bounce), parks dead lanes
    (origin 1e30, direction 1.0) in copies, intersects them — sorted by
    coherence key when ``sort_rays`` is on and the mode is not 'bvh' —
    and shades them with the scalar bounce index; NEE shadow rays go
    through the unsorted closure.

    Returns (radiance [R, 3], seed', rays_traced: an int64 scalar
    tensor)."""
    isect = pick_intersect(cfg, scene)
    use_sort = cfg.sort_rays and resolve_intersect_mode(cfg, scene) != "bvh"
    r = origin.shape[0]
    dev = origin.device
    origin, direction = origin.contiguous(), direction.contiguous()
    acc = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    mask = torch.ones((r, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(r, dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros(r, dtype=torch.float32, device=dev)
    rays_traced = torch.zeros((), dtype=torch.int64, device=dev)
    for bounce in range(cfg.max_depth):
        rays_traced += alive.sum()
        o_i = torch.where(alive[:, None], origin, 1e30)
        d_i = torch.where(alive[:, None], direction, 1.0)
        if use_sort:
            t, obj, tri = sorted_intersect(isect, scene, o_i, d_i, cfg.eps)
        else:
            t, obj, tri = isect(scene, o_i, d_i, eps=cfg.eps)
        origin, direction, acc, mask, alive, seed, prev_pdf = shade_step(
            scene, cfg, origin, direction, acc, mask, alive, seed, bounce,
            t, obj, tri, prev_pdf=prev_pdf, isect=isect)
    return acc, seed, rays_traced


def _block_shape(cfg: RenderConfig, rows: int, w: int, scene=None):
    """Pixel-block shape (bh, bw) so one intersect tile is one compact
    32-wide block (megakernel.py:863-874), or None where it does not
    divide the slab."""
    bw = 32
    bh = intersect_tile(cfg, scene) // bw
    if bh > 0 and rows % bh == 0 and w % bw == 0:
        return bh, bw
    return None


def camera_rays(cfg: RenderConfig, cam_world, fov_y, ubo_seed, pixel_xy):
    """Primary rays and their RNG states for pixels pixel_xy [N, 2] of one
    sample (seed_from_pixel, then generate_ray).  Returns (origin,
    direction, seed)."""
    seed = seed_from_pixel(ubo_seed, pixel_xy, parity=cfg.parity_rng)
    return generate_ray(cam_world, fov_y, pixel_xy,
                        (cfg.render_width, cfg.render_height), seed,
                        rand=get_rand(cfg.parity_rng))


def block_pixels(cfg: RenderConfig, scene, y0: int, rows: int, device):
    """The pixels of the slab [y0, y0 + rows) in the order render_rows
    traces them: block-major where ``_block_shape`` divides the slab,
    row-major otherwise.  Returns (pixel_xy [rows * W, 2] f32 — x, y —,
    the block shape or None)."""
    w = cfg.render_width
    ys, xs = torch.meshgrid(
        torch.arange(rows, dtype=torch.float32, device=device) + float(y0),
        torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    blk = _block_shape(cfg, rows, w, scene)
    if blk is None:
        return torch.stack([xs, ys], -1).reshape(-1, 2), None
    bh, bw = blk

    def to_blocks(a):
        return a.reshape(rows // bh, bh, w // bw, bw).permute(
            0, 2, 1, 3).reshape(-1)
    return torch.stack([to_blocks(xs), to_blocks(ys)], -1), blk


def render_rows(scene, cfg: RenderConfig, cam_world, fov_y, ubo_seed,
                y0: int, rows: int):
    """Render the slab of ``rows`` image rows from absolute row ``y0``
    (megakernel.py:877-917).  Pixel RNG streams are keyed by absolute
    coordinates, so any tiling of the image gives the full frame's
    pixels.  Rays are traced in block-major order (one intersect tile =
    one compact pixel block, ``_block_shape``) and the radiance is put
    back in row order at the end.  cam_world [4, 4] and ubo_seed [2] are
    tensors on the scene's device.

    Returns (radiance [rows, W, 3], rays_traced: an int64 scalar
    tensor)."""
    w = cfg.render_width
    pixel_xy, blk = block_pixels(cfg, scene, y0, rows, cam_world.device)
    origin, direction, seed = camera_rays(cfg, cam_world, fov_y, ubo_seed,
                                          pixel_xy)
    radiance, _, rays = trace_rays(scene, cfg, origin, direction, seed)
    if blk is not None:
        bh, bw = blk
        radiance = radiance.reshape(rows // bh, w // bw, bh, bw, 3).permute(
            0, 2, 1, 3, 4)
    return radiance.reshape(rows, w, 3), rays


def render_sample(scene, cfg: RenderConfig, cam_world, fov_y, ubo_seed):
    """One full-frame sample: [H, W, 3] radiance before accumulation
    (megakernel.py:920-929).  ubo_seed: [2] integer tensor, drawn on the
    host per sample (src/RendererPT.cpp:584-585)."""
    img, _ = render_rows(scene, cfg, cam_world, fov_y, ubo_seed, 0,
                         cfg.render_height)
    return img


def accumulate_sample(scene, cfg: RenderConfig, cam_world, fov_y, ubo_seed,
                      accum, reset: bool):
    """Progressive step (path_tracing.comp:346-351; megakernel.py:
    932-951): render one sample, pixels traced in row-major order, and
    return it as the new accumulator where ``reset``, else ``accum`` plus
    it (a new tensor: ``accum`` is not written).

    Returns (accum' [H, W, 3], rays_traced: an int64 scalar tensor)."""
    h, w = cfg.render_height, cfg.render_width
    dev = cam_world.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    pixel_xy = torch.stack([xs, ys], -1).reshape(-1, 2)
    origin, direction, seed = camera_rays(cfg, cam_world, fov_y, ubo_seed,
                                          pixel_xy)
    radiance, _, rays = trace_rays(scene, cfg, origin, direction, seed)
    sample = radiance.reshape(h, w, 3)
    return (sample if reset else accum + sample), rays
