"""Write a ``Gltf`` (the loader's structure, e.g. a procedural scene of
``scene/procedural.py``) to one binary glTF file.

    from logipathtracer_tpu_torch.tools.glb import write_glb
    write_glb(make_box_scene(spheres=2, subdiv=3), "box.glb")

The command line renders only scene files, so the CLI's tests and
``chip_smoke.py`` write the procedural box with this.  What it keeps:
each mesh node's world matrix and primitives (positions, normals and
uvs as de-indexed float32 triangles), each material's factors
(base colour, emission, metallic, roughness, transmission through
KHR_materials_transmission, ior through KHR_materials_ior) and each
camera.  ``load_gltf`` reads it back to the same arrays.  A scene with
textures raises: images are not written.
"""

from __future__ import annotations

import json
import struct

import numpy as np

_FLOAT = 5126
_JSON, _BIN = 0x4E4F534A, 0x004E4942


def _floats(a) -> list:
    return [float(x) for x in np.asarray(a, np.float32).reshape(-1)]


def write_glb(gltf, path: str) -> str:
    """Serialise ``gltf`` into ``path`` (one .glb); returns ``path``."""
    if gltf.textures or any(
            t >= 0 for m in gltf.materials
            for t in (m.base_color_texture, m.emissive_texture,
                      m.metallic_roughness_texture, m.transmission_texture,
                      m.normal_texture)):
        raise ValueError("write_glb: textures are not written")
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
    for node in gltf.mesh_nodes:
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
    for cam in gltf.cameras:
        cameras.append({"type": "perspective", "perspective": {
            "yfov": float(cam.yfov), "znear": float(cam.znear),
            "zfar": float(cam.zfar)}})
        nodes.append({"name": cam.name, "camera": len(cameras) - 1,
                      "matrix": _floats(np.asarray(cam.world_matrix).T)})
    materials = [{
        "name": m.name,
        "pbrMetallicRoughness": {
            "baseColorFactor": _floats(m.base_color_factor),
            "metallicFactor": float(m.metallic_factor),
            "roughnessFactor": float(m.roughness_factor)},
        "emissiveFactor": _floats(m.emissive_factor),
        "extensions": {
            "KHR_materials_transmission": {
                "transmissionFactor": float(m.transmission_factor)},
            "KHR_materials_ior": {"ior": float(m.ior)}}}
        for m in gltf.materials]
    doc = {"asset": {"version": "2.0",
                     "generator": "logipathtracer_tpu_torch.tools.glb"},
           "extensionsUsed": ["KHR_materials_transmission",
                              "KHR_materials_ior"],
           "scene": 0, "scenes": [{"nodes": list(range(len(nodes)))}],
           "nodes": nodes, "meshes": meshes, "materials": materials,
           "cameras": cameras, "accessors": accessors,
           "bufferViews": views, "buffers": [{"byteLength": len(blob)}]}
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    blob.extend(b"\0" * (-len(blob) % 4))
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2,
                            12 + 8 + len(js) + 8 + len(blob)))
        f.write(struct.pack("<II", len(js), _JSON) + js)
        f.write(struct.pack("<II", len(blob), _BIN) + bytes(blob))
    return path
