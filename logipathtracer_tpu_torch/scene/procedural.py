"""Procedural test scenes.

Carried over from the JAX package's module of the same name so that
this package never imports JAX; tests/test_torch_scene.py holds the
two copies to bit-identical output.

The reference ships two assets (cornell_box.gltf, outside.gltf) but
outside.bin is absent from the snapshot (.MISSING_LARGE_BLOBS), so
large-scene benchmarks need synthetic stand-ins of comparable size
(SURVEY.md §6: outside = 51 meshes / 399,949 triangles / 49 materials).
These builders return the same Gltf structure the loader produces, so
they flow through compile_scene unchanged.
"""

from __future__ import annotations

import numpy as np

from logipathtracer_tpu_torch.scene.gltf import (CameraNode, Gltf, Material,
                                           MeshNode, Primitive)


def _look_at(eye, target, up=(0, 1, 0)):
    eye = np.asarray(eye, np.float32)
    fwd = np.asarray(target, np.float32) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float32))
    right /= np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = right
    m[:3, 1] = true_up
    m[:3, 2] = -fwd  # camera looks down -Z (path_tracing.comp:124)
    m[:3, 3] = eye
    return m


def _quad(center, size, axis):
    """Two triangles forming a quad facing +axis."""
    c = np.asarray(center, np.float32)
    u = np.zeros(3, np.float32)
    v = np.zeros(3, np.float32)
    u[(axis + 1) % 3] = size / 2
    v[(axis + 2) % 3] = size / 2
    p = np.array([c - u - v, c + u - v, c + u + v, c - u + v], np.float32)
    tris = np.stack([p[[0, 1, 2]], p[[0, 2, 3]]])
    n = np.zeros(3, np.float32)
    n[axis] = 1.0
    nrm = np.broadcast_to(n, tris.shape).copy()
    uvq = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    uvs = np.stack([uvq[[0, 1, 2]], uvq[[0, 2, 3]]])
    return tris, nrm, uvs


def _icosphere(subdiv: int = 2):
    """Unit icosphere triangle soup."""
    t = (1 + 5 ** 0.5) / 2
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float32)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])
    tris = verts[faces]
    for _ in range(subdiv):
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
        ab = a + b
        bc = b + c
        ca = c + a
        for m in (ab, bc, ca):
            m /= np.linalg.norm(m, axis=1, keepdims=True)
        tris = np.concatenate([
            np.stack([a, ab, ca], 1), np.stack([ab, b, bc], 1),
            np.stack([ca, bc, c], 1), np.stack([ab, bc, ca], 1)])
    return tris.astype(np.float32)


def make_box_scene(spheres: int = 8, subdiv: int = 3,
                   seed: int = 0, name: str = "procedural_box",
                   textured: bool = False) -> Gltf:
    """A cornell-style box with randomly placed PBR icospheres —
    the large-triangle-count stress stand-in for outside.gltf.

    textured=True puts a checker base-color texture on the box walls —
    with nee=True this is the BASELINE config-5 (textured + NEE
    path-tracing) stand-in.
    """
    rng = np.random.default_rng(seed)
    materials = [
        Material(name="white", base_color_factor=np.array(
            [0.8, 0.8, 0.8, 1], np.float32), metallic_factor=0.0,
            roughness_factor=0.3,
            base_color_texture=0 if textured else -1),
        Material(name="light", emissive_factor=np.array(
            [8, 8, 8], np.float32), metallic_factor=0.0,
            roughness_factor=1.0),
    ]
    textures = []
    if textured:
        from logipathtracer_tpu_torch.scene.gltf import TextureData
        checker = np.full((16, 16, 4), 255, np.uint8)
        checker[::2, ::2, :3] = (190, 160, 120)
        checker[1::2, 1::2, :3] = (120, 150, 190)
        textures.append(TextureData(pixels=checker))
    nodes = []

    def add_quad(nm, center, size, axis, mat):
        tris, nrm, uvs = _quad(center, size, axis)
        nodes.append(MeshNode(name=nm, world_matrix=np.eye(4, dtype=np.float32),
                              primitives=[Primitive(tris, nrm, uvs, mat)]))

    s = 4.0
    add_quad("floor", (0, -s / 2, 0), s, 1, 0)
    add_quad("ceiling", (0, s / 2, 0), s, 1, 0)
    add_quad("back", (0, 0, -s / 2), s, 2, 0)
    add_quad("left", (-s / 2, 0, 0), s, 0, 0)
    add_quad("right", (s / 2, 0, 0), s, 0, 0)
    add_quad("lamp", (0, s / 2 - 0.01, 0), s / 4, 1, 1)

    base_sphere = _icosphere(subdiv)
    sphere_n = base_sphere.copy()  # unit sphere: normal == position
    for i in range(spheres):
        mat = Material(
            name=f"m{i}",
            base_color_factor=np.append(
                rng.uniform(0.2, 0.9, 3), 1).astype(np.float32),
            metallic_factor=float(rng.uniform(0, 1) > 0.6),
            roughness_factor=float(rng.uniform(0.05, 0.6)),
            transmission_factor=float(rng.uniform(0, 1) > 0.8),
            ior=1.5)
        materials.append(mat)
        radius = float(rng.uniform(0.2, 0.5))
        pos = rng.uniform(-s / 2 + radius, s / 2 - radius, 3)
        pos[1] = -s / 2 + radius
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] *= radius
        m[:3, 3] = pos
        nodes.append(MeshNode(
            name=f"sphere{i}", world_matrix=m,
            primitives=[Primitive(base_sphere, sphere_n, None,
                                  len(materials) - 1)]))

    cam = CameraNode(name="camera",
                     world_matrix=_look_at((0, 0.3, 5.4), (0, 0, 0)),
                     yfov=0.8)
    return Gltf(mesh_nodes=nodes, cameras=[cam], materials=materials,
                textures=textures, name=name)


def make_triangle_soup(n_tris: int = 400_000, seed: int = 0,
                       name: str = "soup") -> Gltf:
    """Unstructured random triangle soup of outside.gltf scale —
    worst-case BVH build + traversal stress."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (n_tris, 1, 3)).astype(np.float32)
    tris = centers + rng.uniform(-0.12, 0.12, (n_tris, 3, 3)).astype(
        np.float32)
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    fn = np.cross(e1, e2)
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-20)
    nrm = np.repeat(fn[:, None], 3, axis=1).astype(np.float32)
    mat = Material(name="grey", base_color_factor=np.array(
        [0.7, 0.7, 0.7, 1], np.float32), metallic_factor=0.0,
        roughness_factor=0.4)
    node = MeshNode(name="soup", world_matrix=np.eye(4, dtype=np.float32),
                    primitives=[Primitive(tris, nrm, None, 0)])
    cam = CameraNode(name="camera",
                     world_matrix=_look_at((0, 0, 30), (0, 0, 0)),
                     yfov=0.7)
    return Gltf(mesh_nodes=[node], cameras=[cam], materials=[mat],
                textures=[], name=name)


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def make_outside_scene(objects: int = 51, n_materials: int = 49,
                       seed: int = 0, tri_budget: int = 400_000,
                       name: str = "outside_proc") -> Gltf:
    """Outside-class multi-object scene (BASELINE config 3 stand-in).

    The reference's outside.gltf is 51 meshes / 399,949 triangles /
    49 materials / 2 cameras (SURVEY.md §6) but its outside.bin is
    absent from the snapshot, so large-scene benchmarks use this
    procedural equivalent: a ground plane plus ~50 icosphere meshes of
    mixed tessellation scattered over it, each with its OWN world
    matrix (rotation + non-uniform scale — stressing the per-object
    local-ray fills that scale O(objects) per tile in the sweep
    kernels) and one of ``n_materials`` distinct PBR materials
    (including a handful of emissives for the NEE path).  Triangle
    count lands within ~2% of ``tri_budget``.
    """
    rng = np.random.default_rng(seed)
    materials = [Material(name="ground", base_color_factor=np.array(
        [0.45, 0.5, 0.4, 1], np.float32), metallic_factor=0.0,
        roughness_factor=0.8)]
    for i in range(1, n_materials):
        emissive = (i % 17 == 3)  # a few area lights scattered around
        materials.append(Material(
            name=f"m{i}",
            base_color_factor=np.append(
                rng.uniform(0.15, 0.95, 3), 1).astype(np.float32),
            emissive_factor=(rng.uniform(3, 9, 3).astype(np.float32)
                             if emissive else np.zeros(3, np.float32)),
            metallic_factor=float(rng.uniform(0, 1) > 0.7),
            roughness_factor=float(rng.uniform(0.05, 0.9)),
            transmission_factor=float(rng.uniform(0, 1) > 0.9),
            ior=1.5))

    extent = 30.0
    ground, gn, guv = _quad((0.0, 0.0, 0.0), 2 * extent, 1)
    nodes = [MeshNode(name="ground",
                      world_matrix=np.eye(4, dtype=np.float32),
                      primitives=[Primitive(ground, gn, guv, 0)])]

    # Mixed tessellation: a deck of subdiv levels whose mean triangle
    # count hits tri_budget / (objects - 1).
    base = {s: _icosphere(s) for s in (3, 4, 5)}
    counts = {s: base[s].shape[0] for s in base}  # 1280 / 5120 / 20480
    n_mesh = objects - 1
    per = tri_budget / n_mesh
    # Solve a mix of subdiv 4 and 5 (pad with 3s if budget is tiny).
    n5 = max(0, min(n_mesh, round(n_mesh * (per - counts[4])
                                  / (counts[5] - counts[4]))))
    levels = [5] * n5 + [4] * (n_mesh - n5)
    rng.shuffle(levels)

    for i, lvl in enumerate(levels):
        sphere = base[lvl]
        mat = 1 + i % (n_materials - 1)
        sx, sy, sz = rng.uniform(0.6, 2.2, 3)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = _rot_y(rng.uniform(0, 2 * np.pi)) @ np.diag(
            [sx, sy, sz]).astype(np.float32)
        x, z = rng.uniform(-extent, extent, 2)
        m[:3, 3] = (x, sy * (1.0 if rng.uniform() < 0.8
                             else rng.uniform(1.5, 4.0)), z)
        nodes.append(MeshNode(
            name=f"rock{i}", world_matrix=m,
            primitives=[Primitive(sphere, sphere.copy(), None, mat)]))

    cams = [CameraNode(name="camera",
                       world_matrix=_look_at((0, 9, extent * 1.45),
                                             (0, 1, 0)), yfov=0.7),
            CameraNode(name="camera_high",
                       world_matrix=_look_at((extent, 22, extent),
                                             (0, 0, 0)), yfov=0.6)]
    return Gltf(mesh_nodes=nodes, cameras=cams, materials=materials,
                textures=[], name=name)
