"""Scene SoA: the flattened scene, as numpy on the host and as tensors
on the render device.

The field layout is the JAX package's ``scene/types.py`` one for one
(see that module for what every array holds).  Two differences:

  * ``SceneSoA`` is a plain dataclass: there is no pytree registration,
    so this package never imports JAX;
  * ``to(device)`` commits the arrays once as tensors.  The renderer
    does it at construction and never re-uploads per step (the lesson
    of the JAX package's ``render/progressive.py`` constructor: passing
    host arrays to every render call re-uploads the whole scene).

``SceneSoA.from_numpy`` takes any object with the same attributes —
in particular the JAX package's compiled ``SceneSoA`` — and yields this
package's host scene, so one compiled scene can feed both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


@dataclasses.dataclass(frozen=True, eq=False)
class CameraState:
    """Host-side camera (reference: PathTracerUBO camera fill,
    src/RendererPT.cpp:41-47)."""

    world_matrix: np.ndarray  # [4, 4] float32, column-vector convention
    yfov: float
    name: str = ""


@dataclasses.dataclass
class SceneSoA:
    obj_world: Any        # [O, 4, 4] f32
    obj_world_inv: Any    # [O, 4, 4] f32
    obj_base_color: Any   # [O, 4] f32
    obj_emission: Any     # [O, 3] f32
    obj_mrti: Any         # [O, 4] f32: metallic, roughness, transmission, ior
    obj_tex: Any          # [O, 5] i32
    obj_bvh_offset: Any   # [O] i32
    obj_vtx_offset: Any   # [O] i32

    object_bvh_min: Any   # [No, 3] f32
    object_bvh_max: Any
    object_bvh_meta: Any  # [No, 3] i32
    mesh_bvh_min: Any     # [Nm, 3] f32
    mesh_bvh_max: Any
    mesh_bvh_meta: Any    # [Nm, 3] i32

    vtx_pos: Any          # [V, 3] f32
    vtx_nrm: Any          # [V, 3] f32
    vtx_uv: Any           # [V, 2] f32

    fused_min: Any        # [M, 3] f32
    fused_max: Any        # [M, 3] f32
    fused_meta: Any       # [M, 4] i32

    tex_atlas: Any        # [AH, AW, 4] f32 or [AH, AW] u32
    tex_table: Any        # [NE, 6] i32
    tex_mip_base: Any     # [NT] i32
    tex_mip_count: Any    # [NT] i32

    cl_meta: Any          # [C, 2] i32: obj, tri_base
    cl_aabb: Any          # [C, 8] f32: min.xyz, max.xyz, pad, pad
    cl_order: Any         # [8, C] i32
    cl_tris: Any          # [C, 9, S] f32: v0.xyz, e1.xyz, e2.xyz lanes

    tri_shade: Any        # [T, 64] f32 (cols 32:64 = owning obj_shade row)
    obj_shade: Any        # [O, 32] f32

    world_aabb: Any       # [2, 3] f32

    light_tris: Any       # [L, 16] f32
    light_cdf: Any        # [L] f32

    tex_quad: Any = None  # [AH, AW, 4] u32 or None

    num_objects: int = 0
    num_triangles: int = 0
    max_stack: int = 16
    leaf_width: int = 4
    has_textures: bool = False
    tex_slots: tuple = (True, True, True, True, True)
    has_nearest: bool = False
    mip_levels: int = 1
    num_lights: int = 0
    total_light_area: float = 0.0
    cluster_size: int = 128
    cameras: tuple = ()
    name: str = ""

    _ARRAY_FIELDS = (
        "obj_world", "obj_world_inv", "obj_base_color", "obj_emission",
        "obj_mrti", "obj_tex", "obj_bvh_offset", "obj_vtx_offset",
        "object_bvh_min", "object_bvh_max", "object_bvh_meta",
        "mesh_bvh_min", "mesh_bvh_max", "mesh_bvh_meta",
        "vtx_pos", "vtx_nrm", "vtx_uv",
        "fused_min", "fused_max", "fused_meta",
        "tex_atlas", "tex_table", "tex_mip_base", "tex_mip_count",
        "cl_meta", "cl_aabb", "cl_tris", "cl_order",
        "tri_shade", "obj_shade", "world_aabb",
        "light_tris", "light_cdf", "tex_quad",
    )
    _STATIC_FIELDS = ("num_objects", "num_triangles", "max_stack",
                      "leaf_width", "has_textures", "tex_slots",
                      "has_nearest", "mip_levels", "num_lights",
                      "total_light_area", "cluster_size",
                      "cameras", "name")

    @classmethod
    def from_numpy(cls, other) -> "SceneSoA":
        """Host scene from any object carrying the SoA attributes (e.g.
        the JAX package's compiled scene): arrays become numpy arrays
        of the same dtype and values, cameras this module's
        CameraState."""
        kw = {}
        for f in cls._ARRAY_FIELDS:
            v = getattr(other, f)
            kw[f] = None if v is None else np.asarray(v)
        for f in cls._STATIC_FIELDS:
            kw[f] = getattr(other, f)
        kw["cameras"] = tuple(
            CameraState(np.asarray(c.world_matrix, np.float32),
                        float(c.yfov), str(c.name))
            for c in other.cameras)
        return cls(**kw)

    def to(self, device) -> "SceneSoA":
        """Commit the arrays to ``device`` as tensors (once per
        renderer).  uint32 arrays (packed texture atlases) travel as
        their int32 bit patterns: torch has no full uint32 arithmetic."""
        import torch

        kw = {}
        for f in self._ARRAY_FIELDS:
            v = getattr(self, f)
            if v is None:
                kw[f] = None
                continue
            if isinstance(v, torch.Tensor):
                kw[f] = v.to(device)
                continue
            a = np.ascontiguousarray(v)
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            kw[f] = torch.from_numpy(a).to(device)
        for f in self._STATIC_FIELDS:
            kw[f] = getattr(self, f)
        return SceneSoA(**kw)
