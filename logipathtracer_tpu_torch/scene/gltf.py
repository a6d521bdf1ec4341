"""glTF 2.0 loader.

Carried over from the JAX package's module of the same name so that
this package never imports JAX; tests/test_torch_scene.py holds the
two copies to bit-identical output.

Replaces the reference's lsg::GLTFLoader + scene-graph layer
(SURVEY.md §2.3; call sites src/Main.cpp:16-25,
src/PTSceneConverter.cpp:35-129).  Pure Python + numpy: parses the JSON
document, resolves buffers/bufferViews/accessors, flattens the node
hierarchy into world matrices, and exposes de-indexed triangle
primitives the way lsg's getTrianglePositionAccessor() does.

Supported material model: glTF 2.0 pbrMetallicRoughness + emissiveFactor
plus the ADOBE_materials_thin_transparency extension
(transmissionFactor / ior), which the reference consumes via
lsg::MetallicRoughnessMaterial (src/PTSceneConverter.cpp:68-86).  The
standard KHR_materials_transmission / KHR_materials_ior extensions are
also recognized as aliases.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import struct
from typing import Optional

import numpy as np

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}

_TYPE_COUNTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT2": 4,
    "MAT3": 9,
    "MAT4": 16,
}


@dataclasses.dataclass
class Material:
    """Flattened PBR material (reference: lsg::MetallicRoughnessMaterial)."""

    name: str = ""
    base_color_factor: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(4, np.float32))
    emissive_factor: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    metallic_factor: float = 1.0
    roughness_factor: float = 1.0
    transmission_factor: float = 0.0
    ior: float = 1.5
    # Texture indices into the document's textures[] (-1 = none); the five
    # slots the reference reserves (include/PTSceneConverter.hpp:34-38).
    base_color_texture: int = -1
    emissive_texture: int = -1
    metallic_roughness_texture: int = -1
    transmission_texture: int = -1
    normal_texture: int = -1


@dataclasses.dataclass
class Primitive:
    """One de-indexed triangle primitive (a reference 'submesh')."""

    positions: np.ndarray      # [T, 3, 3] float32, triangle soup
    normals: np.ndarray        # [T, 3, 3] float32
    uvs: Optional[np.ndarray]  # [T, 3, 2] float32 or None
    material: int              # index into Gltf.materials


@dataclasses.dataclass
class MeshNode:
    """A scene-graph node holding geometry, flattened to world space."""

    name: str
    world_matrix: np.ndarray   # [4, 4] float32, column-vector convention
    primitives: list[Primitive]


@dataclasses.dataclass
class CameraNode:
    name: str
    world_matrix: np.ndarray   # [4, 4] float32
    yfov: float
    znear: float = 0.1
    zfar: float = 100.0


@dataclasses.dataclass
class TextureData:
    """Decoded texture image (RGBA8) + sampler state."""

    pixels: np.ndarray         # [H, W, 4] uint8
    wrap_s: int = 10497        # REPEAT
    wrap_t: int = 10497
    mag_filter: int = 9729     # LINEAR (9728 = NEAREST)
    min_filter: int = 9729     # LINEAR / *_MIPMAP_* variants
    srgb_hint: bool = True


@dataclasses.dataclass
class Gltf:
    """Loaded scene: flattened mesh nodes, cameras, materials."""

    mesh_nodes: list[MeshNode]
    cameras: list[CameraNode]
    materials: list[Material]
    textures: list[TextureData]
    name: str = ""

    @property
    def triangle_count(self) -> int:
        return sum(p.positions.shape[0]
                   for n in self.mesh_nodes for p in n.primitives)


def _trs_matrix(node: dict) -> np.ndarray:
    """Node-local transform: column-major M = T @ R @ S (glTF spec)."""
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        s = np.asarray(node["scale"], np.float32)
        m[:3, :3] *= s[None, :]
    if "rotation" in node:
        x, y, z, w = (float(v) for v in node["rotation"])
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ], np.float32)
        m[:3, :3] = r @ m[:3, :3]
    if "translation" in node:
        m[:3, 3] = np.asarray(node["translation"], np.float32)
    return m


def _read_accessor(doc: dict, buffers: list[bytes], idx: int) -> np.ndarray:
    acc = doc["accessors"][idx]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    ncomp = _TYPE_COUNTS[acc["type"]]
    count = acc["count"]
    out = np.zeros((count, ncomp), dtype=dtype)
    if "bufferView" in acc:
        bv = doc["bufferViews"][acc["bufferView"]]
        buf = buffers[bv["buffer"]]
        start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        itemsize = np.dtype(dtype).itemsize
        stride = bv.get("byteStride") or itemsize * ncomp
        if stride == itemsize * ncomp:
            flat = np.frombuffer(buf, dtype=dtype, count=count * ncomp,
                                 offset=start)
            out = flat.reshape(count, ncomp).copy()
        else:
            raw = np.frombuffer(buf, dtype=np.uint8)
            for i in range(count):
                off = start + i * stride
                out[i] = np.frombuffer(raw[off:off + itemsize * ncomp],
                                       dtype=dtype)
    # Sparse accessors (rare) are not needed for the reference scenes.
    if acc.get("normalized") and dtype != np.float32:
        info = np.iinfo(dtype)
        out = (out.astype(np.float32) / info.max).astype(np.float32)
        if info.min < 0:
            # glTF 2.0 signed normalization: max(v / maxval, -1.0), so
            # e.g. int16 -32768 maps to exactly -1.0.
            out = np.maximum(out, np.float32(-1.0))
    if ncomp == 1:
        return out[:, 0]
    return out


def _resolve_buffer(uri: Optional[str], base_dir: str, byte_length: int,
                    glb_bin: Optional[bytes]) -> bytes:
    if uri is None:
        if glb_bin is None:
            raise FileNotFoundError("buffer has no uri and no GLB BIN chunk")
        return glb_bin
    if uri.startswith("data:"):
        return base64.b64decode(uri.split(",", 1)[1])
    path = os.path.join(base_dir, uri)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"glTF external buffer missing: {path} ({byte_length} bytes)")
    with open(path, "rb") as f:
        return f.read()


def _parse_material(mat: dict) -> Material:
    out = Material(name=mat.get("name", ""))
    pbr = mat.get("pbrMetallicRoughness", {})
    if "baseColorFactor" in pbr:
        out.base_color_factor = np.asarray(pbr["baseColorFactor"], np.float32)
    out.metallic_factor = float(pbr.get("metallicFactor", 1.0))
    out.roughness_factor = float(pbr.get("roughnessFactor", 1.0))
    if "baseColorTexture" in pbr:
        out.base_color_texture = pbr["baseColorTexture"]["index"]
    if "metallicRoughnessTexture" in pbr:
        out.metallic_roughness_texture = pbr["metallicRoughnessTexture"]["index"]
    if "emissiveFactor" in mat:
        out.emissive_factor = np.asarray(mat["emissiveFactor"], np.float32)
    if "emissiveTexture" in mat:
        out.emissive_texture = mat["emissiveTexture"]["index"]
    if "normalTexture" in mat:
        out.normal_texture = mat["normalTexture"]["index"]
    ext = mat.get("extensions", {})
    adobe = ext.get("ADOBE_materials_thin_transparency")
    if adobe:
        out.transmission_factor = float(adobe.get("transmissionFactor", 0.0))
        out.ior = float(adobe.get("ior", 1.5))
    khr_t = ext.get("KHR_materials_transmission")
    if khr_t:
        out.transmission_factor = float(khr_t.get("transmissionFactor", 0.0))
        if "transmissionTexture" in khr_t:
            out.transmission_texture = khr_t["transmissionTexture"]["index"]
    khr_i = ext.get("KHR_materials_ior")
    if khr_i:
        out.ior = float(khr_i.get("ior", 1.5))
    return out


def _deindex(doc: dict, buffers: list[bytes], prim: dict) -> Optional[Primitive]:
    attrs = prim["attributes"]
    if "POSITION" not in attrs:
        return None
    pos = _read_accessor(doc, buffers, attrs["POSITION"]).astype(np.float32)
    if "indices" in prim:
        idx = _read_accessor(doc, buffers, prim["indices"]).astype(np.int64)
    else:
        idx = np.arange(pos.shape[0], dtype=np.int64)
    ntri = idx.shape[0] // 3
    idx = idx[:ntri * 3].reshape(ntri, 3)
    tri_pos = pos[idx]  # [T, 3, 3]
    if "NORMAL" in attrs:
        nrm = _read_accessor(doc, buffers, attrs["NORMAL"]).astype(np.float32)
        tri_nrm = nrm[idx]
    else:
        e1 = tri_pos[:, 1] - tri_pos[:, 0]
        e2 = tri_pos[:, 2] - tri_pos[:, 0]
        fn = np.cross(e1, e2)
        fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
        tri_nrm = np.repeat(fn[:, None, :], 3, axis=1).astype(np.float32)
    tri_uv = None
    if "TEXCOORD_0" in attrs:
        uv = _read_accessor(doc, buffers, attrs["TEXCOORD_0"]).astype(np.float32)
        tri_uv = uv[idx]
    return Primitive(positions=tri_pos, normals=tri_nrm, uvs=tri_uv,
                     material=prim.get("material", -1))


def load_gltf(path: str) -> Gltf:
    """Load a .gltf (JSON) or .glb (binary) file into a flattened scene."""
    base_dir = os.path.dirname(os.path.abspath(path))
    glb_bin = None
    with open(path, "rb") as f:
        head = f.read(4)
        f.seek(0)
        if head == b"glTF":
            magic, version, length = struct.unpack("<III", f.read(12))
            doc = None
            while f.tell() < length:
                clen, ctype = struct.unpack("<II", f.read(8))
                data = f.read(clen)
                if ctype == 0x4E4F534A:  # JSON
                    doc = json.loads(data)
                elif ctype == 0x004E4942:  # BIN
                    glb_bin = data
            assert doc is not None, "GLB missing JSON chunk"
        else:
            doc = json.load(open(path))

    buffers = [
        _resolve_buffer(b.get("uri"), base_dir, b.get("byteLength", 0), glb_bin)
        for b in doc.get("buffers", [])
    ]

    materials = [_parse_material(m) for m in doc.get("materials", [])]

    # Flatten the node hierarchy (reference: traverseDown at
    # src/PTSceneConverter.cpp:35-129, world matrices from lsg::Transform).
    nodes = doc.get("nodes", [])
    mesh_nodes: list[MeshNode] = []
    cameras: list[CameraNode] = []

    def visit(node_idx: int, parent_world: np.ndarray):
        node = nodes[node_idx]
        world = (parent_world @ _trs_matrix(node)).astype(np.float32)
        if "camera" in node:
            cam = doc["cameras"][node["camera"]]
            if cam.get("type") == "perspective":
                p = cam.get("perspective", {})
                cameras.append(CameraNode(
                    name=node.get("name", ""),
                    world_matrix=world,
                    yfov=float(p.get("yfov", 0.8)),
                    znear=float(p.get("znear", 0.1)),
                    zfar=float(p.get("zfar", 100.0)),
                ))
        if "mesh" in node:
            mesh = doc["meshes"][node["mesh"]]
            prims = []
            for prim in mesh.get("primitives", []):
                if prim.get("mode", 4) != 4:  # TRIANGLES only
                    continue
                p = _deindex(doc, buffers, prim)
                if p is not None and p.positions.shape[0] > 0:
                    prims.append(p)
            if prims:
                mesh_nodes.append(MeshNode(
                    name=node.get("name", ""), world_matrix=world,
                    primitives=prims))
        for child in node.get("children", []):
            visit(child, world)

    scene_idx = doc.get("scene", 0)
    scene = doc.get("scenes", [{}])[scene_idx]
    for root in scene.get("nodes", []):
        visit(root, np.eye(4, dtype=np.float32))

    textures: list[TextureData] = []
    for tex in doc.get("textures", []):
        img = doc["images"][tex["source"]] if "source" in tex else None
        sampler = (doc.get("samplers", [])[tex["sampler"]]
                   if "sampler" in tex else {})
        pixels = _decode_image(img, buffers, doc, base_dir)
        textures.append(TextureData(
            pixels=pixels,
            wrap_s=sampler.get("wrapS", 10497),
            wrap_t=sampler.get("wrapT", 10497),
            mag_filter=sampler.get("magFilter", 9729),
            min_filter=sampler.get("minFilter", 9729),
        ))

    return Gltf(mesh_nodes=mesh_nodes, cameras=cameras, materials=materials,
                textures=textures,
                name=os.path.splitext(os.path.basename(path))[0])


def _decode_image(img: Optional[dict], buffers: list[bytes], doc: dict,
                  base_dir: str) -> np.ndarray:
    """Decode an embedded/external PNG or JPEG into RGBA8.

    Missing images (no source / absent file) fall back to 1x1 white —
    matching the renderer's untextured default — but an image that is
    PRESENT and fails to decode raises, instead of silently shipping
    white pixels (reference feeds raw asset pixels unconditionally,
    src/PTSceneConverter.cpp:243-389)."""
    if img is None:
        return np.full((1, 1, 4), 255, np.uint8)
    data = None
    if "bufferView" in img:
        bv = doc["bufferViews"][img["bufferView"]]
        buf = buffers[bv["buffer"]]
        off = bv.get("byteOffset", 0)
        data = buf[off:off + bv["byteLength"]]
    elif "uri" in img:
        uri = img["uri"]
        if uri.startswith("data:"):
            data = base64.b64decode(uri.split(",", 1)[1])
        else:
            p = os.path.join(base_dir, uri)
            if os.path.exists(p):
                data = open(p, "rb").read()
    if data is None:
        return np.full((1, 1, 4), 255, np.uint8)
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        from logipathtracer_tpu_torch.film.png import decode_png
        return decode_png(data)
    if data[:2] == b"\xff\xd8":
        from logipathtracer_tpu_torch.film.jpeg import decode_jpeg
        try:
            return decode_jpeg(data)
        except ValueError as decode_err:
            # Progressive/arithmetic JPEGs: fall through to PIL when
            # the environment has it; re-raise the decode error (not
            # the PIL ImportError) otherwise.
            try:
                import io

                from PIL import Image
            except ImportError:
                raise decode_err from None
            arr = np.asarray(
                Image.open(io.BytesIO(data)).convert("RGBA"), np.uint8)
            return arr
    raise ValueError(
        f"unsupported image format (magic {data[:4]!r}) for "
        f"{img.get('uri', img.get('name', '<embedded>'))}")
