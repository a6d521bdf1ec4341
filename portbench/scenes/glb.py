"""Write a ``Scene`` to one binary glTF file (a frozen copy of the port's
``tools/glb.py``): each mesh node's world matrix and primitives
(positions, normals and uvs as de-indexed float32 triangles), each
material's factors (base colour, emission, metallic, roughness,
transmission through KHR_materials_transmission, ior through
KHR_materials_ior) and texture slots, each texture (its RGBA8 image as
a PNG in a bufferView, its sampler) and each camera.  The port's
``load_gltf`` reads it back to the same arrays.  A scene without
textures writes no image, sampler or texture entry."""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np

_FLOAT = 5126
_JSON, _BIN = 0x4E4F534A, 0x004E4942
_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# zlib's fastest level: scene generation counts in the set-up time.
_PNG_LEVEL = 1


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(pixels) -> bytes:
    """RGBA8 pixels [H, W, 4] as an 8-bit RGBA PNG, filter 0 on every
    row, rows in array order."""
    img = np.ascontiguousarray(pixels, np.uint8)
    h, w = img.shape[:2]
    raw = np.zeros((h, 1 + 4 * w), np.uint8)
    raw[:, 1:] = img.reshape(h, 4 * w)
    return (_PNG_SIG
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0,
                                              0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), _PNG_LEVEL))
            + _png_chunk(b"IEND", b""))


def _texture_refs(m, entry: dict):
    """A material's texture references, added to its glTF entry only
    where the slot is set."""
    pbr, ext = entry["pbrMetallicRoughness"], entry["extensions"]
    for slot, where, key in (
            (m.base_color_texture, pbr, "baseColorTexture"),
            (m.metallic_roughness_texture, pbr, "metallicRoughnessTexture"),
            (m.emissive_texture, entry, "emissiveTexture"),
            (m.normal_texture, entry, "normalTexture"),
            (m.transmission_texture, ext["KHR_materials_transmission"],
             "transmissionTexture")):
        if slot >= 0:
            where[key] = {"index": int(slot)}
    return entry


def _floats(a) -> list:
    return [float(x) for x in np.asarray(a, np.float32).reshape(-1)]


def write_glb(scene, path: str) -> str:
    """Serialise ``scene`` into ``path``; returns ``path``."""
    blob = bytearray()
    views, accessors = [], []

    def add(arr, kind: str, bounds: bool = False) -> int:
        arr = np.ascontiguousarray(arr, np.float32)
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": arr.nbytes})
        blob.extend(arr.tobytes())
        acc = {"bufferView": len(views) - 1, "componentType": _FLOAT,
               "count": int(arr.shape[0]), "type": kind}
        if bounds:
            acc["min"] = _floats(arr.min(axis=0))
            acc["max"] = _floats(arr.max(axis=0))
        accessors.append(acc)
        return len(accessors) - 1

    meshes, nodes = [], []
    for node in scene.mesh_nodes:
        prims = []
        for p in node.primitives:
            attrs = {"POSITION": add(p.positions.reshape(-1, 3), "VEC3",
                                     bounds=True),
                     "NORMAL": add(p.normals.reshape(-1, 3), "VEC3")}
            if p.uvs is not None:
                attrs["TEXCOORD_0"] = add(p.uvs.reshape(-1, 2), "VEC2")
            prim = {"attributes": attrs}
            if p.material >= 0:
                prim["material"] = int(p.material)
            prims.append(prim)
        meshes.append({"primitives": prims})
        nodes.append({"name": node.name, "mesh": len(meshes) - 1,
                      "matrix": _floats(np.asarray(node.world_matrix).T)})
    cameras = []
    for cam in scene.cameras:
        cameras.append({"type": "perspective", "perspective": {
            "yfov": float(cam.yfov), "znear": float(cam.znear),
            "zfar": float(cam.zfar)}})
        nodes.append({"name": cam.name, "camera": len(cameras) - 1,
                      "matrix": _floats(np.asarray(cam.world_matrix).T)})
    materials = [_texture_refs(m, {
        "name": m.name,
        "pbrMetallicRoughness": {
            "baseColorFactor": _floats(m.base_color_factor),
            "metallicFactor": float(m.metallic_factor),
            "roughnessFactor": float(m.roughness_factor)},
        "emissiveFactor": _floats(m.emissive_factor),
        "extensions": {
            "KHR_materials_transmission": {
                "transmissionFactor": float(m.transmission_factor)},
            "KHR_materials_ior": {"ior": float(m.ior)}}})
        for m in scene.materials]
    doc = {"asset": {"version": "2.0", "generator": "portbench.scenes.glb"},
           "extensionsUsed": ["KHR_materials_transmission",
                              "KHR_materials_ior"],
           "scene": 0, "scenes": [{"nodes": list(range(len(nodes)))}],
           "nodes": nodes, "meshes": meshes, "materials": materials,
           "cameras": cameras, "accessors": accessors,
           "bufferViews": views}
    if scene.textures:
        images = []
        for tex in scene.textures:
            png = encode_png(tex.pixels)
            views.append({"buffer": 0, "byteOffset": len(blob),
                          "byteLength": len(png)})
            blob.extend(png)
            blob.extend(b"\0" * (-len(blob) % 4))
            images.append({"bufferView": len(views) - 1,
                           "mimeType": "image/png"})
        doc["images"] = images
        doc["samplers"] = [{"magFilter": int(t.mag_filter),
                            "minFilter": int(t.min_filter),
                            "wrapS": int(t.wrap_s), "wrapT": int(t.wrap_t)}
                           for t in scene.textures]
        doc["textures"] = [{"sampler": i, "source": i}
                           for i in range(len(scene.textures))]
    doc["buffers"] = [{"byteLength": len(blob)}]
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    blob.extend(b"\0" * (-len(blob) % 4))
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2,
                            12 + 8 + len(js) + 8 + len(blob)))
        f.write(struct.pack("<II", len(js), _JSON) + js)
        f.write(struct.pack("<II", len(blob), _BIN) + bytes(blob))
    return path
