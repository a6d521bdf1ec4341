"""The scene description the benchmark hands to both sides: a frozen
copy of the glTF structure of the port's loader (materials with their
texture slots, RGBA8 textures with their sampler state, de-indexed
triangle primitives, mesh nodes with world matrices, cameras) and the
geometric helpers of its procedural scenes, so that the scene a
configuration names does not change when the program does."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Material:
    name: str = ""
    base_color_factor: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(4, np.float32))
    emissive_factor: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    metallic_factor: float = 1.0
    roughness_factor: float = 1.0
    transmission_factor: float = 0.0
    ior: float = 1.5
    # Indices into Scene.textures (-1: none), the loader's five slots.
    base_color_texture: int = -1
    emissive_texture: int = -1
    metallic_roughness_texture: int = -1
    transmission_texture: int = -1
    normal_texture: int = -1


TEXTURE_SLOTS = ("base_color_texture", "emissive_texture",
                 "metallic_roughness_texture", "transmission_texture",
                 "normal_texture")

# glTF sampler constants.
REPEAT, CLAMP, MIRROR = 10497, 33071, 33648
NEAREST, LINEAR = 9728, 9729


@dataclasses.dataclass
class Texture:
    pixels: np.ndarray         # [H, W, 4] uint8, row 0 at v = 0
    wrap_s: int = REPEAT
    wrap_t: int = REPEAT
    mag_filter: int = LINEAR
    min_filter: int = LINEAR


@dataclasses.dataclass
class Primitive:
    positions: np.ndarray      # [T, 3, 3] float32, object space
    normals: np.ndarray        # [T, 3, 3] float32
    uvs: Optional[np.ndarray]  # [T, 3, 2] float32 or None
    material: int


@dataclasses.dataclass
class MeshNode:
    name: str
    world_matrix: np.ndarray   # [4, 4] float32, column vectors
    primitives: list


@dataclasses.dataclass
class CameraNode:
    name: str
    world_matrix: np.ndarray   # [4, 4] float32; looks down -z
    yfov: float
    znear: float = 0.1
    zfar: float = 100.0


@dataclasses.dataclass
class Scene:
    mesh_nodes: list
    cameras: list
    materials: list
    name: str = "scene"
    textures: list = dataclasses.field(default_factory=list)

    @property
    def triangle_count(self) -> int:
        return sum(p.positions.shape[0] for n in self.mesh_nodes
                   for p in n.primitives)


def look_at(eye, target, up=(0, 1, 0)):
    eye = np.asarray(eye, np.float32)
    fwd = np.asarray(target, np.float32) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float32))
    right /= np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = right
    m[:3, 1] = true_up
    m[:3, 2] = -fwd
    m[:3, 3] = eye
    return m


def quad(center, size, axis):
    """Two triangles forming a quad facing +axis: (positions, normals,
    uvs), each [2, 3, k]."""
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


def icosphere(subdiv: int = 2):
    """Unit icosphere triangle soup [20 * 4**subdiv, 3, 3]."""
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


def rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
