"""Shading step, ray sort key and backend selection (the parts of the
JAX package's ``render/megakernel.py`` the wavefront renderer uses).

The megakernel renderer itself (``trace_rays``, ``render_rows``,
``render_sample``) is not ported yet (ROADMAP Queue 1: megakernel and
BVH walk).  What the slice does not cover raises NotImplementedError
naming its ROADMAP item; nothing falls back quietly.
"""

from __future__ import annotations

import torch

from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.ops.kernels import shade as shade_kernel
from logipathtracer_tpu_torch.ops.traverse import intersect_scene_sweep

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
    """'compact' for resident-class scenes; scenes beyond the budget
    resolve to 'stream', which is not ported."""
    mode = cfg.intersect
    if mode in ("auto", "compact_interpret"):
        mode = "compact"
    if mode == "compact" and scene is not None:
        c, _, lanes = scene.cl_tris.shape
        if not resident_sweep_fits(c, lanes, scene.num_objects, cfg):
            mode = "stream"
    return mode


def pick_intersect(cfg: RenderConfig, scene=None):
    """The intersect closure for the resolved mode: the compact worklist
    sweep (kernel K1 on CUDA tensors, its plain version on CPU ones)."""
    mode = resolve_intersect_mode(cfg, scene)
    if mode in ("stream", "stream_interpret"):
        raise NotImplementedError(
            "scenes beyond the resident budget stream clusters (kernel K4 "
            "and its frustum prepass), which is not ported (ROADMAP Queue 1: "
            "frustum and stream prepasses; Queue 2: K4, K5)")
    if mode == "bvh":
        raise NotImplementedError(
            "the BVH stack walk is not ported (ROADMAP Queue 1: megakernel "
            "and BVH walk)")
    if mode != "compact":
        raise NotImplementedError(
            f"intersect mode {mode!r} is not ported (ROADMAP Queue 2: K6-K8)")
    if not cfg.compact_worklist:
        raise NotImplementedError(
            "compact_worklist=False (kernel K7) is not ported (ROADMAP "
            "Queue 2: K7)")

    def isect(s, o, d, eps, t_max=None, any_hit=False):
        return intersect_scene_sweep(s, o, d, eps=eps, tile=cfg.compact_tile,
                                     t_max=t_max, any_hit=any_hit)
    return isect


def intersect_tile(cfg: RenderConfig, scene=None) -> int:
    """Rays per worklist tile of the resolved intersect mode — what the
    pixel blocking is sized to."""
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


def resolve_shade_mode(cfg: RenderConfig, scene=None) -> str:
    """Always 'kernel' (kernel K2 on CUDA tensors, its plain version on
    CPU ones) for what the slice covers; raises for what it does not.
    ``cfg.shade`` chooses between TPU implementations and is ignored."""
    if cfg.nee:
        raise NotImplementedError(
            "next-event estimation is not ported (ROADMAP Queue 1: NEE; "
            "Queue 2: K2 nee variant)")
    if not cfg.use_microfacet:
        raise NotImplementedError(
            "use_microfacet=False (the basic BSDF) is not ported (ROADMAP "
            "Queue 1: basic BSDF)")
    if scene is not None and scene.has_textures:
        raise NotImplementedError(
            "textured scenes are not ported (ROADMAP Queue 1: textures; "
            "Queue 2: K2 tex variant)")
    return "kernel"


def shade_step(scene, cfg: RenderConfig, origin, direction, acc, mask,
               alive, seed, bounce, t, obj, tri, prev_pdf=None, isect=None):
    """One shading iteration of the traceRay loop
    (path_tracing.comp:219-323) given the intersection results.
    ``bounce`` may be a python int or a per-lane int32 tensor.
    Returns (origin, direction, acc, mask, alive, seed, prev_pdf)."""
    resolve_shade_mode(cfg, scene)
    r = origin.shape[0]
    if prev_pdf is None:
        prev_pdf = torch.zeros(r, dtype=torch.float32, device=origin.device)
    if not isinstance(bounce, torch.Tensor) or bounce.dim() == 0:
        bounce = torch.full((r,), int(bounce), dtype=torch.int32,
                            device=origin.device)
    out = shade_kernel.shade(
        scene.tri_shade, origin, direction, acc, mask, alive, seed,
        bounce.to(torch.int32), t, tri.to(torch.int32),
        env=float(cfg.env_color), rr_threshold=float(cfg.rr_threshold),
        rr_bounces=int(cfg.rr_bounces), max_order=int(cfg.heitz_max_order),
        parity=bool(cfg.parity_rng))
    # prev_pdf carries NEE state only; it passes through unchanged here.
    return (*out, prev_pdf)
