"""A cornell-style box with randomly placed PBR icospheres: the stand-in
for the reference's cornell_box.gltf (a frozen copy of the port's
``make_box_scene``; ``textured`` puts its 16x16 checker base-colour
texture on the walls)."""

from __future__ import annotations

import numpy as np

from portbench.scenes.common import (CameraNode, Material, MeshNode,
                                     Primitive, Scene, Texture, icosphere,
                                     look_at, quad)


def make(spheres: int = 8, subdiv: int = 3, seed: int = 0,
         name: str = "procedural_box", textured: bool = False) -> Scene:
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
        checker = np.full((16, 16, 4), 255, np.uint8)
        checker[::2, ::2, :3] = (190, 160, 120)
        checker[1::2, 1::2, :3] = (120, 150, 190)
        textures.append(Texture(pixels=checker))
    nodes = []

    def add_quad(nm, center, size, axis, mat):
        tris, nrm, uvs = quad(center, size, axis)
        nodes.append(MeshNode(name=nm,
                              world_matrix=np.eye(4, dtype=np.float32),
                              primitives=[Primitive(tris, nrm, uvs, mat)]))

    s = 4.0
    add_quad("floor", (0, -s / 2, 0), s, 1, 0)
    add_quad("ceiling", (0, s / 2, 0), s, 1, 0)
    add_quad("back", (0, 0, -s / 2), s, 2, 0)
    add_quad("left", (-s / 2, 0, 0), s, 0, 0)
    add_quad("right", (s / 2, 0, 0), s, 0, 0)
    add_quad("lamp", (0, s / 2 - 0.01, 0), s / 4, 1, 1)

    base_sphere = icosphere(subdiv)
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
                     world_matrix=look_at((0, 0.3, 5.4), (0, 0, 0)),
                     yfov=0.8)
    return Scene(mesh_nodes=nodes, cameras=[cam], materials=materials,
                 name=name, textures=textures)
