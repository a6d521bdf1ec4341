"""The texture prologue: per lane, the texture taps that resolve the
material overrides of the shading kernel K2 (``tex_prologue_kernel``,
csrc/tex_prologue.cu).

Replaces no Pallas kernel: the JAX package ran the prologue as XLA,
outside any kernel (``logipathtracer_tpu/render/megakernel.py::
_resolve_tex_prologue``, megakernel.py:276-387).  ``prologue_plain`` is
its port in plain PyTorch.  Material factors multiply in texture order
(base, emissive, metallic-roughness, transmission); the roughness floor
applies BEFORE the texture multiply; the normal map rotates about the
PRE-map tangent basis.  Slots no object textures (scene.tex_slots) are
skipped.

On the card: one thread a lane, in registers; a lane that is not live
(alive and t < INF, K2's test) reads nothing and gets zeros, which K2
never reads.  A live lane's tri_shade row comes in float4 loads, and
every texel load of every slot is issued before the first is used, so
that the taps' DRAM latencies overlap.  Bound: DRAM bytes, the lanes'
own inputs and outputs and four texels of 4 B a tap; the tri_shade and
obj_tex tables stay in L2 and count once a call (``harness.tex_bytes``).
Every route of the plain version runs there:
the packed RGBA8 and the f32 atlas, the quad atlas, each wrap mode, the
NEAREST flags, the trilinear mip path.
"""

from __future__ import annotations

import torch

from logipathtracer_tpu_torch.ops.intersect import (barycentric, dot3,
                                                    transform_dir,
                                                    transform_point)
from logipathtracer_tpu_torch.ops.kernels import _build
from logipathtracer_tpu_torch.ops.kernels import shade as shade_kernel
from logipathtracer_tpu_torch.ops.texture import (sample_atlas,
                                                  sample_atlas_lod)

# Launch counter of the CUDA kernel and call counter of the plain
# version (the main path must run the first and never the second).
launches = 0
plain_calls = 0

SOURCE = "logipathtracer_tpu_torch/csrc/tex_prologue.cu"
REPLACES = ("none: logipathtracer_tpu/render/megakernel.py "
            "_resolve_tex_prologue ran as XLA")
MAT_COLS = shade_kernel.MAT_COLS
NORMAL_SLOT = 4


def prologue_plain(scene, cfg, origin, direction, t, obj, tri):
    """Plain PyTorch prologue: ``tex_prologue``'s arguments and results,
    on every lane, misses included (the JAX package's outputs).  K2
    reads only the live lanes, where the kernel's outputs equal these
    bit for bit."""
    global plain_calls
    with _build.COUNT_LOCK:
        plain_calls += 1
    ts64 = scene.tri_shade[tri.clamp(min=0).long()]        # [R, 64]
    tshade = ts64[:, 0:32]
    oshade = ts64[:, 32:64]
    world3 = oshade[:, 0:9].reshape(-1, 3, 3)
    inv34 = oshade[:, 9:21].reshape(-1, 3, 4)
    pos_loc = (transform_point(inv34, origin)
               + t[:, None] * transform_dir(inv34, direction))
    bary = barycentric(pos_loc, tshade[:, 15:18], tshade[:, 18:21],
                       tshade[:, 21:24])
    uv = (bary[:, 0:1] * tshade[:, 9:11] + bary[:, 1:2] * tshade[:, 11:13]
          + bary[:, 2:3] * tshade[:, 13:15])

    base_color = oshade[:, 21:25]
    emission = oshade[:, 25:28]
    metallic = oshade[:, 28]
    roughness = torch.clamp(oshade[:, 29], min=0.001)
    transmission = oshade[:, 30]

    tex = scene.obj_tex[obj.clamp(min=0).long()]           # [R, 5]
    if scene.mip_levels > 1:
        scale = torch.sqrt(torch.clamp(dot3(world3[:, :, 0],
                                            world3[:, :, 0]), min=1e-20))
        density_w = tshade[:, 24] / scale

    def tap(slot):
        tid = tex[:, slot]
        if scene.mip_levels > 1:
            base = scene.tex_mip_base[tid.clamp(min=0).long()]
            e0 = scene.tex_table[base.long()]
            dim = torch.maximum(e0[:, 2], e0[:, 3]).to(torch.float32)
            footprint = cfg.mip_spread * t * density_w * dim
            lod = torch.log2(torch.clamp(footprint, min=1.0))
            s = sample_atlas_lod(
                scene.tex_atlas, scene.tex_table, scene.tex_mip_base,
                scene.tex_mip_count, tid, uv, lod,
                nearest_aware=scene.has_nearest, quad=scene.tex_quad)
        else:
            s = sample_atlas(scene.tex_atlas, scene.tex_table, tid, uv,
                             nearest_aware=scene.has_nearest,
                             quad=scene.tex_quad)
        return tid >= 0, s

    used = scene.tex_slots
    if used[0]:
        has_c, c = tap(0)
        base_color = torch.where(has_c[:, None], base_color * c, base_color)
    if used[1]:
        has_e, e = tap(1)
        emission = torch.where(has_e[:, None], emission * e[:, :3],
                               emission)
    if used[2]:
        has_mr, mr = tap(2)
        metallic = torch.where(has_mr, metallic * mr[:, 2], metallic)
        roughness = torch.where(has_mr, roughness * mr[:, 1], roughness)
    if used[3]:
        has_t, tt = tap(3)
        transmission = torch.where(has_t, transmission * tt[:, 0],
                                   transmission)
    mat = torch.cat([base_color, emission, metallic[:, None],
                     roughness[:, None], transmission[:, None]], dim=1)
    if not used[NORMAL_SLOT]:
        return mat.contiguous(), None, None

    # Normal map about the pre-map basis (megakernel.py:353-381).
    n_loc = (bary[:, 0:1] * tshade[:, 0:3] + bary[:, 1:2] * tshade[:, 3:6]
             + bary[:, 2:3] * tshade[:, 6:9])
    n = shade_kernel.normalize(transform_dir(world3, n_loc))
    ff = torch.where((dot3(n, direction) < 0.0)[:, None], n, -n)
    u, v = shade_kernel.tangent_basis(ff)
    has_n, nmap = tap(NORMAL_SLOT)
    tn = shade_kernel.normalize(nmap[:, :3] * 2.0 - 1.0)
    ff_mapped = shade_kernel.normalize(tn[:, 0:1] * u + tn[:, 1:2] * v
                                       + tn[:, 2:3] * ff)
    return mat.contiguous(), ff_mapped.contiguous(), has_n.contiguous()


def tex_prologue(scene, cfg, origin, direction, t, obj, tri, alive=None):
    """The texture taps of R lanes for K2.

    origin, direction [R, 3] f32; t [R] f32; obj, tri [R] int; alive [R]
    bool, or None for every lane with a hit.  Returns (mat [R, MAT_COLS]
    f32 — base rgba, emission, metallic, roughness, transmission — and,
    when some object has a normal map, the mapped front-face normal
    [R, 3] f32 and has-normal-map [R] bool; else None, None).  A CPU
    tensor takes the plain version, which computes every lane; a CUDA
    tensor the kernel, which writes zeros on the lanes that are not live
    (K2 reads none of them): a CUDA input the kernel does not take
    raises."""
    global launches
    dev = origin.device
    if dev.type == "cpu":
        return prologue_plain(scene, cfg, origin, direction, t, obj, tri)
    if dev.type != "cuda":
        raise ValueError(f"tex_prologue: unsupported device {dev}")
    r = origin.shape[0]
    f32, i32 = torch.float32, torch.int32
    obj, tri = obj.to(i32), tri.to(i32)
    _build.require(origin, "origin", f32, (r, 3), dev)
    _build.require(direction, "direction", f32, (r, 3), dev)
    _build.require(t, "t", f32, (r,), dev)
    _build.require(obj, "obj", i32, (r,), dev)
    _build.require(tri, "tri", i32, (r,), dev)
    if alive is not None:
        _build.require(alive, "alive", torch.bool, (r,), dev)
    ts = scene.tri_shade
    _build.require(ts, "tri_shade", f32, (ts.shape[0], 64), dev)
    _build.require(scene.obj_tex, "obj_tex", i32,
                   (scene.obj_tex.shape[0], 5), dev)
    table = scene.tex_table
    _build.require(table, "tex_table", i32, (table.shape[0], 8), dev)
    n_tex = scene.tex_mip_base.shape[0]
    _build.require(scene.tex_mip_base, "tex_mip_base", i32, (n_tex,), dev)
    _build.require(scene.tex_mip_count, "tex_mip_count", i32, (n_tex,),
                   dev)
    atlas, quad = scene.tex_atlas, scene.tex_quad
    packed = atlas.dim() == 2
    ah, aw = atlas.shape[0], atlas.shape[1]
    if packed:
        _build.require(atlas, "tex_atlas", i32, (ah, aw), dev)
    else:
        _build.require(atlas, "tex_atlas", f32, (ah, aw, 4), dev)
    if quad is not None:
        if not packed:
            raise ValueError("tex_prologue: a quad atlas needs the packed "
                             "atlas")
        _build.require(quad, "tex_quad", i32, (ah, aw, 4), dev)
    if packed and scene.mip_levels > 1:
        raise ValueError("tex_prologue: mip chains come in the f32 atlas")
    if ah * aw >= 2 ** 31:
        raise ValueError(f"tex_prologue: {ah * aw} texels, over int32 "
                         "indexing")
    for name, x in (("tri_shade", ts), ("tex_table", table),
                    ("tex_atlas", atlas), ("tex_quad", quad)):
        if x is not None and x.data_ptr() % 16:
            raise ValueError(f"tex_prologue: {name} must be 16-byte "
                             "aligned (vector loads)")
    slots = sum(1 << s for s, on in enumerate(scene.tex_slots) if on)
    normal = bool(scene.tex_slots[NORMAL_SLOT])
    mat = torch.empty((r, MAT_COLS), dtype=f32, device=dev)
    ffm = torch.empty((r, 3), dtype=f32, device=dev) if normal else None
    nmap = torch.empty(r, dtype=torch.bool, device=dev) if normal else None
    if r == 0:
        return mat, ffm, nmap
    _build.launch("tex_prologue", "lpt_tex_prologue", ts, scene.obj_tex,
                  atlas, quad, table, scene.tex_mip_base,
                  scene.tex_mip_count, origin, direction, t, obj, tri, alive,
                  r, ah * aw, aw, table.shape[0], n_tex, slots,
                  bool(scene.has_nearest), packed, scene.mip_levels > 1,
                  float(cfg.mip_spread), mat, ffm, nmap,
                  _build.stream_ptr(dev))
    with _build.COUNT_LOCK:
        launches += 1
    return mat, ffm, nmap
