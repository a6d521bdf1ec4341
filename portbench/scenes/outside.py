"""The outside-class scene: a ground plane and icosphere rocks of mixed
tessellation, each with its own world matrix and one of
``n_materials`` PBR materials, a few of them emissive: the stand-in for
the reference's outside.gltf, whose outside.bin is absent (a frozen
copy of the port's ``make_outside_scene``)."""

from __future__ import annotations

import numpy as np

from portbench.scenes.common import (CameraNode, Material, MeshNode,
                                     Primitive, Scene, icosphere, look_at,
                                     quad, rot_y)


def make(objects: int = 51, n_materials: int = 49, seed: int = 0,
         tri_budget: int = 400_000, name: str = "outside_proc") -> Scene:
    rng = np.random.default_rng(seed)
    materials = [Material(name="ground", base_color_factor=np.array(
        [0.45, 0.5, 0.4, 1], np.float32), metallic_factor=0.0,
        roughness_factor=0.8)]
    for i in range(1, n_materials):
        emissive = (i % 17 == 3)
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
    ground, gn, guv = quad((0.0, 0.0, 0.0), 2 * extent, 1)
    nodes = [MeshNode(name="ground",
                      world_matrix=np.eye(4, dtype=np.float32),
                      primitives=[Primitive(ground, gn, guv, 0)])]

    base = {s: icosphere(s) for s in (3, 4, 5)}
    counts = {s: base[s].shape[0] for s in base}
    n_mesh = objects - 1
    per = tri_budget / n_mesh
    n5 = max(0, min(n_mesh, round(n_mesh * (per - counts[4])
                                  / (counts[5] - counts[4]))))
    levels = [5] * n5 + [4] * (n_mesh - n5)
    rng.shuffle(levels)

    for i, lvl in enumerate(levels):
        sphere = base[lvl]
        mat = 1 + i % (n_materials - 1)
        sx, sy, sz = rng.uniform(0.6, 2.2, 3)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = rot_y(rng.uniform(0, 2 * np.pi)) @ np.diag(
            [sx, sy, sz]).astype(np.float32)
        x, z = rng.uniform(-extent, extent, 2)
        m[:3, 3] = (x, sy * (1.0 if rng.uniform() < 0.8
                             else rng.uniform(1.5, 4.0)), z)
        nodes.append(MeshNode(
            name=f"rock{i}", world_matrix=m,
            primitives=[Primitive(sphere, sphere.copy(), None, mat)]))

    cams = [CameraNode(name="camera",
                       world_matrix=look_at((0, 9, extent * 1.45),
                                            (0, 1, 0)), yfov=0.7),
            CameraNode(name="camera_high",
                       world_matrix=look_at((extent, 22, extent),
                                            (0, 0, 0)), yfov=0.6)]
    return Scene(mesh_nodes=nodes, cameras=cams, materials=materials,
                 name=name)
