"""Scene compiler: loaded glTF → device SoA.

Carried over from the JAX package's module of the same name so that
this package never imports JAX; tests/test_torch_scene.py holds the
two copies to bit-identical output.

Replacement for PTSceneConverter / RTXSceneConverter
(src/PTSceneConverter.cpp:29-156, src/RTXSceneConverter.cpp:29-89): one
compiler serves both of the reference's backends because without a
hardware acceleration structure — BLAS/TLAS and the software
two-level BVH collapse into the same SoA arrays.

Per submesh ("object", matching the reference's per-submesh
GPUObjectData at src/PTSceneConverter.cpp:63-88):
  * flatten world matrix + inverse and PBR factors,
  * build a SAH BVH over its triangles, reorder triangles into leaf
    order and emit interleaved pos/normal/uv (3 vertices per triangle,
    no index buffer — src/PTSceneConverter.cpp:105-120),
  * record bvh_offset / vertices_offset.

Then build the top-level object BVH over world-space AABBs and permute
the object table into its leaf order (src/PTSceneConverter.cpp:133-142).
Finally derive the fused single-array traversal BVH (see
scene/types.py) and pack textures into an atlas.
"""

from __future__ import annotations

import numpy as np

from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.scene.bvh import BVH, build_bvh, build_triangle_bvh
from logipathtracer_tpu_torch.scene.gltf import Gltf, Material
from logipathtracer_tpu_torch.scene.types import CameraState, SceneSoA


def _transform_aabb(mn: np.ndarray, mx: np.ndarray,
                    m: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """World-space AABB of a transformed AABB (lsg AABB::transform,
    src/PTSceneConverter.cpp:122)."""
    corners = np.stack([
        np.where(np.arange(8) & 1, mx[0], mn[0]),
        np.where(np.arange(8) & 2, mx[1], mn[1]),
        np.where(np.arange(8) & 4, mx[2], mn[2]),
    ], axis=-1)
    world = corners @ m[:3, :3].T + m[:3, 3]
    return world.min(axis=0), world.max(axis=0)


def _default_material() -> Material:
    return Material(name="__default__")


def compile_scene(gltf: Gltf, config: RenderConfig | None = None,
                  use_native: bool = True) -> SceneSoA:
    cfg = config or RenderConfig()

    obj_world = []
    obj_base_color = []
    obj_emission = []
    obj_mrti = []
    obj_tex = []
    obj_bvh_offset = []
    obj_vtx_offset = []
    obj_world_aabb_min = []
    obj_world_aabb_max = []
    mesh_bvhs: list[BVH] = []

    mesh_min_parts = []
    mesh_max_parts = []
    mesh_meta_parts = []
    vtx_pos_parts = []
    vtx_nrm_parts = []
    vtx_uv_parts = []

    mesh_node_cursor = 0
    vtx_cursor = 0
    light_rows = []

    builder = _select_builder(use_native, cfg.bvh_spatial_splits)

    for node in gltf.mesh_nodes:
        world = node.world_matrix.astype(np.float32)
        world_inv = np.linalg.inv(world.astype(np.float64)).astype(np.float32)
        for prim in node.primitives:
            mat = (gltf.materials[prim.material]
                   if 0 <= prim.material < len(gltf.materials)
                   else _default_material())
            tri_pos = prim.positions.astype(np.float32)  # [T, 3, 3]
            bvh = builder(tri_pos, leaf_size=cfg.bvh_leaf_size,
                          bins=cfg.bvh_bins)
            mesh_bvhs.append(bvh)

            order = bvh.prim_order
            mesh_min_parts.append(bvh.nodes_min)
            mesh_max_parts.append(bvh.nodes_max)
            mesh_meta_parts.append(bvh.nodes_meta)
            vtx_pos_parts.append(tri_pos[order].reshape(-1, 3))
            vtx_nrm_parts.append(
                prim.normals.astype(np.float32)[order].reshape(-1, 3))
            if prim.uvs is not None:
                vtx_uv_parts.append(
                    prim.uvs.astype(np.float32)[order].reshape(-1, 2))
            else:
                vtx_uv_parts.append(
                    np.zeros((order.shape[0] * 3, 2), np.float32))

            obj_world.append(world)
            obj_base_color.append(mat.base_color_factor.astype(np.float32))
            obj_emission.append(mat.emissive_factor.astype(np.float32))
            obj_mrti.append(np.array([
                mat.metallic_factor, mat.roughness_factor,
                mat.transmission_factor, mat.ior], np.float32))
            obj_tex.append(np.array([
                mat.base_color_texture, mat.emissive_texture,
                mat.metallic_roughness_texture, mat.transmission_texture,
                mat.normal_texture], np.int32))
            obj_bvh_offset.append(mesh_node_cursor)
            obj_vtx_offset.append(vtx_cursor)

            wmin, wmax = _transform_aabb(bvh.nodes_min[0], bvh.nodes_max[0],
                                         world)
            obj_world_aabb_min.append(wmin.astype(np.float32))
            obj_world_aabb_max.append(wmax.astype(np.float32))

            mesh_node_cursor += bvh.num_nodes
            vtx_cursor += order.shape[0] * 3

            # Emissive-triangle light table (NEE — beyond reference).
            # Built from the PRE-BVH primitive triangles so SBVH spatial
            # splits (which duplicate straddling triangles into vtx_pos)
            # cannot double-count an emitter's area/selection mass.
            emission = mat.emissive_factor.astype(np.float32)
            if emission.max() > 0:
                tw = tri_pos @ world[:3, :3].T + world[:3, 3]
                e1 = tw[:, 1] - tw[:, 0]
                e2 = tw[:, 2] - tw[:, 0]
                area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
                for k in np.nonzero(area > 0)[0]:
                    row = np.zeros(16, np.float32)
                    row[0:3] = tw[k, 0]
                    row[3:6] = e1[k]
                    row[6:9] = e2[k]
                    row[9:12] = emission
                    row[12] = area[k]
                    light_rows.append(row)

    num_objects = len(obj_world)
    assert num_objects > 0, "scene has no renderable geometry"

    # Top-level object BVH over world AABBs; leaf_size=1 so each leaf is
    # exactly one object (the reference allows ranges; single-object
    # leaves let the fused layout splice mesh roots in directly).
    obvh = build_bvh(np.stack(obj_world_aabb_min),
                     np.stack(obj_world_aabb_max), leaf_size=1, bins=cfg.bvh_bins)

    # Permute object table into object-BVH leaf order
    # (src/PTSceneConverter.cpp:140-142).
    perm = obvh.prim_order

    def permute(parts):
        return [parts[i] for i in perm]

    obj_world = np.stack(permute(obj_world))
    obj_world_inv = np.linalg.inv(
        obj_world.astype(np.float64)).astype(np.float32)
    obj_base_color = np.stack(permute(obj_base_color))
    obj_emission = np.stack(permute(obj_emission))
    obj_mrti = np.stack(permute(obj_mrti))
    obj_tex = np.stack(permute(obj_tex))
    obj_bvh_offset = np.asarray(permute(obj_bvh_offset), np.int32)
    obj_vtx_offset = np.asarray(permute(obj_vtx_offset), np.int32)
    mesh_bvhs_perm = permute(mesh_bvhs)

    mesh_bvh_min = np.concatenate(mesh_min_parts)
    mesh_bvh_max = np.concatenate(mesh_max_parts)
    mesh_bvh_meta = np.concatenate(mesh_meta_parts)
    vtx_pos = np.concatenate(vtx_pos_parts)
    vtx_nrm = np.concatenate(vtx_nrm_parts)
    vtx_uv = np.concatenate(vtx_uv_parts)

    fused_min, fused_max, fused_meta, max_stack = _fuse_bvh(
        obvh, mesh_bvhs_perm, obj_bvh_offset, obj_vtx_offset,
        mesh_bvh_min, mesh_bvh_max, mesh_bvh_meta)

    tex_atlas, tex_table, tex_mip_base, tex_mip_count = _pack_textures(
        gltf, cfg.mip_levels)
    tex_quad = (_build_quad_atlas(tex_atlas, tex_table)
                if getattr(cfg, "tex_quad", True) and gltf.textures
                else None)

    # Emissive-triangle table rows were collected pre-BVH in the main
    # loop above (one row per source triangle, SBVH-duplication-proof).
    if light_rows:
        light_tris = np.stack(light_rows)
        areas = light_tris[:, 12]
        total_area = float(areas.sum())
        light_cdf = (np.cumsum(areas) / areas.sum()).astype(np.float32)
    else:
        light_tris = np.zeros((1, 16), np.float32)
        light_cdf = np.ones((1,), np.float32)
        total_area = 0.0

    # Clustered sweep arrays (built from a lightweight stand-in SoA view
    # so clusters.py can run before the SceneSoA exists).
    from logipathtracer_tpu_torch.scene.clusters import build_clusters

    class _View:
        pass

    view = _View()
    view.mesh_bvh_meta = mesh_bvh_meta
    view.mesh_bvh_min = mesh_bvh_min
    view.mesh_bvh_max = mesh_bvh_max
    view.obj_bvh_offset = obj_bvh_offset
    view.obj_vtx_offset = obj_vtx_offset
    view.vtx_pos = vtx_pos
    view.obj_world_inv = obj_world_inv
    view.num_objects = num_objects
    if cfg.cluster_size == 0:
        # Auto: resident-class scenes keep 256-triangle clusters;
        # scenes beyond the resident budget (streamed clusters) take
        # 512.  The rule is the JAX package's, kept so both packages
        # compile the same clusters.
        from logipathtracer_tpu_torch.render.megakernel import \
            resident_sweep_fits
        # Residency is predicted for the intersect mode the render will
        # actually resolve (a 'sweep' config sizes its tiles
        # with sweep_tile, so predicting with compact_tile could pick a
        # cluster size the sweep then can't hold resident).
        mode = ("sweep" if cfg.intersect in ("sweep", "sweep_interpret")
                else "compact")
        clustered = build_clusters(view, cluster_size=256)
        if not resident_sweep_fits(clustered.cl_tris.shape[0], 256,
                                   num_objects, cfg, mode=mode):
            clustered = build_clusters(view, cluster_size=512)
    else:
        clustered = build_clusters(view, cluster_size=cfg.cluster_size)
    cl_meta = np.stack([clustered.cl_obj, clustered.cl_tri_base],
                       axis=1).astype(np.int32)

    # Per-octant front-to-back cluster order: sweeping near clusters
    # first makes the kernel's best_t slab pruning effective (clusters
    # behind the closest hit fail the slab test and skip their MT).
    cl_center_world = np.zeros((cl_meta.shape[0], 3), np.float32)
    for i in range(cl_meta.shape[0]):
        o = int(cl_meta[i, 0])
        center = 0.5 * (clustered.cl_aabb[i, 0:3]
                        + clustered.cl_aabb[i, 3:6])
        m = obj_world[o]
        cl_center_world[i] = m[:3, :3] @ center + m[:3, 3]
    cl_order = np.zeros((8, cl_meta.shape[0]), np.int32)
    for oct_ in range(8):
        sign = np.array([1.0 if oct_ & 4 else -1.0,
                         1.0 if oct_ & 2 else -1.0,
                         1.0 if oct_ & 1 else -1.0], np.float32)
        cl_order[oct_] = np.argsort(cl_center_world @ sign,
                                    kind="stable").astype(np.int32)

    # Packed per-triangle / per-object shade rows (scene/types.py).
    t_count = vtx_pos.shape[0] // 3
    tri_shade = np.zeros((t_count, 32), np.float32)
    tri_shade[:, 0:9] = vtx_nrm.reshape(t_count, 9)
    tri_shade[:, 9:15] = vtx_uv.reshape(t_count, 6)
    tri_shade[:, 15:24] = vtx_pos.reshape(t_count, 9)
    # Row 24: per-triangle texel density sqrt(uv_area / pos_area) in UV
    # units per object-space unit — the ray-cone mip LOD input
    # (cfg.mip_levels > 1; ops/texture.py::sample_atlas_lod).
    p = vtx_pos.reshape(t_count, 3, 3)
    uvt = vtx_uv.reshape(t_count, 3, 2)
    pos_area = 0.5 * np.linalg.norm(
        np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]), axis=-1)
    e1uv = uvt[:, 1] - uvt[:, 0]
    e2uv = uvt[:, 2] - uvt[:, 0]
    uv_area = 0.5 * np.abs(e1uv[:, 0] * e2uv[:, 1]
                           - e1uv[:, 1] * e2uv[:, 0])
    tri_shade[:, 24] = np.sqrt(uv_area / np.maximum(pos_area, 1e-20))
    obj_shade = np.zeros((num_objects, 32), np.float32)
    obj_shade[:, 0:9] = obj_world[:, :3, :3].reshape(num_objects, 9)
    obj_shade[:, 9:21] = obj_world_inv[:, :3, :4].reshape(num_objects, 12)
    obj_shade[:, 21:25] = obj_base_color
    obj_shade[:, 25:28] = obj_emission
    obj_shade[:, 28:32] = obj_mrti
    # Columns 32:64 carry the owning object's obj_shade row, so shading
    # reads ONE [T, 64] row keyed by the hit triangle instead of two
    # rows keyed by (tri, obj).  obj_shade stays as the standalone
    # per-object table for texture shading.
    tri_obj = np.zeros((t_count,), np.int32)
    for o in range(num_objects):
        s = obj_vtx_offset[o] // 3
        n = len(vtx_pos_parts[perm[o]]) // 3
        tri_obj[s:s + n] = o
    tri_shade = np.concatenate([tri_shade, obj_shade[tri_obj]], axis=1)

    cameras = tuple(
        CameraState(world_matrix=c.world_matrix, yfov=c.yfov, name=c.name)
        for c in gltf.cameras)

    return SceneSoA(
        obj_world=obj_world,
        obj_world_inv=obj_world_inv,
        obj_base_color=obj_base_color,
        obj_emission=obj_emission,
        obj_mrti=obj_mrti,
        obj_tex=obj_tex,
        obj_bvh_offset=obj_bvh_offset,
        obj_vtx_offset=obj_vtx_offset,
        object_bvh_min=obvh.nodes_min,
        object_bvh_max=obvh.nodes_max,
        object_bvh_meta=obvh.nodes_meta,
        mesh_bvh_min=mesh_bvh_min,
        mesh_bvh_max=mesh_bvh_max,
        mesh_bvh_meta=mesh_bvh_meta,
        vtx_pos=vtx_pos,
        vtx_nrm=vtx_nrm,
        vtx_uv=vtx_uv,
        fused_min=fused_min,
        fused_max=fused_max,
        fused_meta=fused_meta,
        tex_atlas=tex_atlas,
        tex_table=tex_table,
        tex_mip_base=tex_mip_base,
        tex_mip_count=tex_mip_count,
        tex_quad=tex_quad,
        cl_meta=cl_meta,
        cl_aabb=clustered.cl_aabb,
        cl_tris=clustered.cl_tris,
        cl_order=cl_order,
        tri_shade=tri_shade,
        obj_shade=obj_shade,
        world_aabb=np.stack([np.stack(obj_world_aabb_min).min(axis=0),
                             np.stack(obj_world_aabb_max).max(axis=0)]),
        light_tris=light_tris,
        light_cdf=light_cdf,
        num_lights=len(light_rows),
        total_light_area=total_area,
        num_objects=num_objects,
        num_triangles=vtx_pos.shape[0] // 3,
        max_stack=max_stack,
        cluster_size=clustered.cluster_size,
        leaf_width=int((fused_meta[fused_meta[:, 0] == 1][:, 2]
                        - fused_meta[fused_meta[:, 0] == 1][:, 1]).max()),
        has_textures=bool(gltf.textures),
        # Static per-slot usage: lets texture shading skip the taps of
        # slots no object uses.
        tex_slots=tuple(bool((obj_tex[:, s] >= 0).any())
                        for s in range(obj_tex.shape[1])),
        has_nearest=any(
            getattr(t, "mag_filter", 9729) == 9728
            or getattr(t, "min_filter", 9729) in (9728, 9984, 9986)
            for t in gltf.textures),
        mip_levels=max(int(cfg.mip_levels), 1),
        cameras=cameras,
        name=gltf.name,
    )


def _select_builder(use_native: bool, spatial_splits: bool = True):
    """Mesh-level builder: native SBVH (spatial splits — the quality the
    reference gets from lsg::bvh::SplitBVHBuilder,
    src/PTSceneConverter.cpp:97-98) when the toolchain is present, else
    the numpy binned-SAH builder (same node schema, no splits)."""
    if use_native:
        try:
            from logipathtracer_tpu_torch.scene.bvh_native import (
                build_triangle_bvh_native, build_triangle_sbvh_native,
                native_available)
            if native_available():
                return (build_triangle_sbvh_native if spatial_splits
                        else build_triangle_bvh_native)
        except Exception:
            pass
    return build_triangle_bvh


def _fuse_bvh(obvh: BVH, mesh_bvhs: list[BVH], obj_bvh_offset, obj_vtx_offset,
              mesh_min, mesh_max, mesh_meta):
    """Merge object + mesh BVHs into one node array (see scene/types.py).

    Global ids: object-BVH node i keeps id i; mesh node j of the
    concatenated mesh array gets id No + j.  Object-BVH leaves (exactly
    one object each) are rewritten as inner nodes whose single purpose
    disappears: the parent's child pointer is redirected straight at the
    object's mesh root, so object leaves are dropped from traversal
    (they stay in the array as unreferenced padding to keep ids stable).
    """
    no = obvh.num_nodes
    fused_min = np.concatenate([obvh.nodes_min, mesh_min]).astype(np.float32)
    fused_max = np.concatenate([obvh.nodes_max, mesh_max]).astype(np.float32)
    m_total = fused_min.shape[0]
    fused_meta = np.zeros((m_total, 4), np.int32)
    fused_meta[:, 3] = -1

    # Object-level nodes.
    leaf_to_root = {}  # object-leaf node id -> (mesh root global id, obj)
    for i in range(no):
        is_leaf, a, b = obvh.nodes_meta[i]
        if is_leaf:
            assert b - a == 1, "object BVH must have single-object leaves"
            obj = int(a)  # leaf range [a, a+1) over permuted object table
            root = no + int(obj_bvh_offset[obj])
            leaf_to_root[i] = (root, obj)
        else:
            fused_meta[i] = (0, a, b, -1)

    # Redirect parents of object leaves at mesh roots; replace the leaf's
    # AABB/meta in place too (covers the single-object-scene root case).
    for i in range(no):
        if fused_meta[i, 0] == 0 and i not in leaf_to_root:
            for c in (1, 2):
                child = int(fused_meta[i, c])
                if child in leaf_to_root:
                    fused_meta[i, c] = leaf_to_root[child][0]
    # Object-space AABBs for spliced mesh roots are already present in the
    # mesh section; the world-space object AABB stays on the (now
    # unreferenced) object-leaf slot.

    # Mesh-level nodes: bias child ids, globalize leaf triangle ranges,
    # tag with owning object.
    depth_cap = obvh.max_depth
    for obj, bvh in enumerate(mesh_bvhs):
        nn = bvh.num_nodes
        base = no + int(obj_bvh_offset[obj])
        tri_base = int(obj_vtx_offset[obj]) // 3
        meta = bvh.nodes_meta
        sl = slice(base, base + nn)
        fm = fused_meta[sl]
        is_leaf = meta[:, 0] == 1
        fm[:, 0] = np.where(is_leaf, 1, 0)
        fm[:, 1] = np.where(is_leaf, meta[:, 1] + tri_base, meta[:, 1] + base)
        fm[:, 2] = np.where(is_leaf, meta[:, 2] + tri_base, meta[:, 2] + base)
        fm[:, 3] = obj
        fused_meta[sl] = fm
        depth_cap = max(depth_cap, obvh.max_depth + bvh.max_depth)

    # Worst-case stack: one pending sibling per level of the fused walk.
    max_stack = depth_cap + 2

    # Root handling: traversal starts by pushing node 0. If the whole
    # scene is one object, node 0 is an object leaf -> start at its mesh
    # root instead. Encode by rewriting node 0 as a redirect if needed.
    if 0 in leaf_to_root:
        root, obj = leaf_to_root[0]
        fused_min[0] = fused_min[root]
        fused_max[0] = fused_max[root]
        fused_meta[0] = fused_meta[root]

    # Loud guard: the device walk silently clamps pushes at max_stack-1
    # (ops/traverse.py), so an undersized bound would corrupt results.
    # Verify the exact worst case (pop 1, push 2) on the fused tree.
    need = _exact_stack_need(fused_meta)
    if need > max_stack:
        raise ValueError(
            f"fused BVH needs stack {need} > max_stack {max_stack}; "
            "builder emitted a deeper tree than its depth accounting")
    return fused_min, fused_max, fused_meta, int(max_stack)


def _exact_stack_need(fused_meta: np.ndarray) -> int:
    """Exact peak stack occupancy of the traversal in ops/traverse.py:
    pop one node, push up to two children.  Peak after pushing both
    children of a node with ``pending`` entries below it is pending+2;
    iterative DFS over inner nodes."""
    peak = 1  # root pre-pushed
    stack = [(0, 0)]  # (node, entries pending beneath it when popped)
    seen = set()
    while stack:
        node, pending = stack.pop()
        if node in seen:       # redirected root aliasing
            continue
        seen.add(node)
        kind, a, b, _ = fused_meta[node]
        if kind != 0:
            continue
        peak = max(peak, pending + 2)
        # Children are popped with pending and pending+1 beneath them.
        stack.append((int(b), pending))
        stack.append((int(a), pending + 1))
    return peak


def _pack_textures(gltf: Gltf, mip_levels: int = 1):
    """Shelf-pack all textures into one RGBA atlas.

    The reference binds up to 512 separate sampled images
    (path_tracing.comp:105); here sampling is a gather from this
    atlas (the JAX package's ops/texture.py).

    LOD-0-only scenes (mip_levels == 1) with pure 8-bit sources pack
    the atlas as ONE uint32 per texel (RGBA8, little-endian) — every
    bilinear tap then gathers 4 u32 rows instead of 4x4 f32 rows, and
    the sampler's in-register unpack + /255
    reproduces the f32 values the unpacked atlas stored.  Mip chains
    (box-filtered means, not 8-bit-representable) and non-u8 sources
    keep the [AH, AW, 4] f32 layout.

    mip_levels > 1 (cfg.mip_levels — beyond the reference, which
    samples implicit LOD 0 from compute) appends a 2x2 box-filtered mip
    chain per texture as additional atlas entries; returns per-texture
    (mip_base, mip_count) index arrays into the expanded table.
    """
    mip_levels = max(int(mip_levels), 1)
    if not gltf.textures:
        atlas = np.ones((1, 8, 4), np.float32)
        table = np.zeros((1, 8), np.int32)
        table[0] = (0, 0, 1, 1, 10497, 10497, 0, 0)
        return (atlas, table, np.zeros(1, np.int32), np.ones(1, np.int32))
    packed = (mip_levels == 1
              and all(t.pixels.dtype == np.uint8 for t in gltf.textures))

    # Per-texture mip chains (level 0 = the source image).  Filter
    # flags (glTF sampler magFilter/minFilter — the reference honors
    # them via Vulkan sampler state, src/PTSceneConverter.cpp:335-386):
    # col 6 = NEAREST magnification, col 7 = NEAREST within-level
    # minification (NEAREST / NEAREST_MIPMAP_*).
    entries = []  # (pixels, wrap_s, wrap_t, mag_nearest, min_nearest)
    mip_base = np.zeros(len(gltf.textures), np.int32)
    mip_count = np.zeros(len(gltf.textures), np.int32)
    for i, t in enumerate(gltf.textures):
        mip_base[i] = len(entries)
        img = (t.pixels if packed
               else t.pixels.astype(np.float32) / 255.0)
        mag_n = int(getattr(t, "mag_filter", 9729) == 9728)
        min_n = int(getattr(t, "min_filter", 9729) in (9728, 9984, 9986))
        levels = 0
        while True:
            entries.append((img, t.wrap_s, t.wrap_t, mag_n, min_n))
            levels += 1
            h, w = img.shape[:2]
            if levels >= mip_levels or (h < 2 and w < 2):
                break
            h2, w2 = max(h // 2, 1), max(w // 2, 1)
            img = img[:h2 * 2, :w2 * 2].reshape(
                h2, min(h, 2), w2, min(w, 2), 4).mean(axis=(1, 3))
        mip_count[i] = levels

    # Simple shelf packing, row by row.
    max_w = max(max(e[0].shape[1] for e in entries), 8)
    shelf_x = 0
    shelf_y = 0
    shelf_h = 0
    coords = []
    for img, *_ in entries:
        h, w = img.shape[:2]
        if shelf_x + w > max_w:
            shelf_y += shelf_h
            shelf_x = 0
            shelf_h = 0
        coords.append((shelf_x, shelf_y))
        shelf_x += w
        shelf_h = max(shelf_h, h)
    total_h = shelf_y + shelf_h
    atlas = np.zeros((total_h, max_w, 4),
                     np.uint8 if packed else np.float32)
    table = np.zeros((len(entries), 8), np.int32)
    for i, ((img, ws, wt, mg, mn), (x, y)) in enumerate(
            zip(entries, coords)):
        h, w = img.shape[:2]
        atlas[y:y + h, x:x + w] = img
        table[i] = (x, y, w, h, ws, wt, mg, mn)
    if packed:
        # [AH, AW] u32: r | g<<8 | b<<16 | a<<24 (little-endian view).
        atlas = np.ascontiguousarray(atlas).view(np.uint32)[:, :, 0]
    return atlas, table, mip_base, mip_count


# Quad atlas gates: MIRROR wraps reverse direction under reflection
# (a per-texel packed neighbor cannot encode that), and the 16 B/texel
# quad layout is capped to keep HBM use bounded on texture-heavy
# scenes (16M texels = 256 MB of quad rows).
_QUAD_WRAPS_OK = (10497, 33071)  # REPEAT, CLAMP_TO_EDGE
_QUAD_MAX_TEXELS = 16 * 1024 * 1024


def _build_quad_atlas(atlas, table):
    """[AH, AW, 4] u32 quad atlas: row (y, x) = the texel and its
    +x / +y / +x+y bilinear neighbors with the owning texture's wrap
    applied at pack time.

    A bilinear tap then needs ONE 4-col row gather instead of four
    1-col gathers (ops/texture.py::_bilinear).  The reference needs
    nothing like this: Vulkan samplers filter in fixed-function hardware
    (shaders/path_tracing.comp:244-261).

    Returns None (callers fall back to the 4-gather path) for f32
    atlases (mip chains / non-u8 sources), MIRROR wraps, or atlases
    over the texel cap.
    """
    if atlas.ndim != 2 or atlas.dtype != np.uint32:
        return None
    if atlas.size > _QUAD_MAX_TEXELS:
        return None
    if not all(int(r[4]) in _QUAD_WRAPS_OK and int(r[5]) in _QUAD_WRAPS_OK
               for r in table):
        return None
    quad = np.repeat(atlas[:, :, None], 4, axis=2)
    for x0, y0, w, h, ws, wt, *_ in np.asarray(table, np.int64):
        xs = np.arange(w)
        ys = np.arange(h)
        xn = (xs + 1) % w if ws == 10497 else np.minimum(xs + 1, w - 1)
        yn = (ys + 1) % h if wt == 10497 else np.minimum(ys + 1, h - 1)
        sub = atlas[y0:y0 + h, x0:x0 + w]
        quad[y0:y0 + h, x0:x0 + w, 1] = sub[:, xn]
        quad[y0:y0 + h, x0:x0 + w, 2] = sub[yn, :]
        quad[y0:y0 + h, x0:x0 + w, 3] = sub[np.ix_(yn, xn)]
    return quad
