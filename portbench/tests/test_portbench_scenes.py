"""The frozen scene generators and glb writer give the same arrays as
the port's ``make_box_scene``, ``make_outside_scene`` and ``write_glb``
at this commit, read back through the port's loader; every texture
slot, wrap mode and filter survives the writer; the scenes of the
existing configurations are written byte for byte as before textures
came."""

import hashlib
import json
import os

import numpy as np
import pytest

from portbench.scenes import box, outside
from portbench.scenes.common import (CLAMP, LINEAR, MIRROR, NEAREST,
                                     REPEAT, TEXTURE_SLOTS, CameraNode,
                                     Material, MeshNode, Primitive, Scene,
                                     Texture, look_at, quad)
from portbench.scenes.glb import write_glb

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(a, b):
    assert len(a.mesh_nodes) == len(b.mesh_nodes)
    for na, nb in zip(a.mesh_nodes, b.mesh_nodes):
        np.testing.assert_array_equal(na.world_matrix, nb.world_matrix)
        for pa, pb in zip(na.primitives, nb.primitives):
            np.testing.assert_array_equal(pa.positions, pb.positions)
            np.testing.assert_array_equal(pa.normals, pb.normals)
            assert pa.material == pb.material
            assert (pa.uvs is None) == (pb.uvs is None)
            if pa.uvs is not None:
                np.testing.assert_array_equal(pa.uvs, pb.uvs)
    assert len(a.materials) == len(b.materials)
    for ma, mb in zip(a.materials, b.materials):
        for f in ("base_color_factor", "emissive_factor"):
            np.testing.assert_array_equal(getattr(ma, f), getattr(mb, f))
        for f in ("metallic_factor", "roughness_factor",
                  "transmission_factor", "ior") + TEXTURE_SLOTS:
            assert getattr(ma, f) == getattr(mb, f)
    assert len(a.textures) == len(b.textures)
    for ta, tb in zip(a.textures, b.textures):
        np.testing.assert_array_equal(ta.pixels, tb.pixels)
        for f in ("wrap_s", "wrap_t", "mag_filter", "min_filter"):
            assert getattr(ta, f) == getattr(tb, f)
    for ca, cb in zip(a.cameras, b.cameras):
        np.testing.assert_array_equal(ca.world_matrix, cb.world_matrix)
        assert ca.yfov == cb.yfov


@pytest.mark.parametrize("which", ["box", "outside", "box_textured"])
def test_generators_match_port(which):
    from logipathtracer_tpu_torch.scene import procedural
    if which == "box":
        ours = box.make(spheres=10, subdiv=3)
        port = procedural.make_box_scene(spheres=10, subdiv=3)
        assert ours.triangle_count == 12812
    elif which == "box_textured":
        ours = box.make(spheres=10, subdiv=3, textured=True)
        port = procedural.make_box_scene(spheres=10, subdiv=3,
                                         textured=True)
        assert len(ours.textures) == 1
    else:
        ours = outside.make()
        port = procedural.make_outside_scene()
        assert ours.triangle_count == 394242
    _same(ours, port)


def test_glb_matches_port_writer(tmp_path):
    from logipathtracer_tpu_torch.scene import procedural
    from logipathtracer_tpu_torch.scene.gltf import load_gltf
    from logipathtracer_tpu_torch.tools.glb import write_glb as port_write
    ours = load_gltf(write_glb(box.make(spheres=3, subdiv=2),
                               str(tmp_path / "a.glb")))
    port = load_gltf(port_write(procedural.make_box_scene(spheres=3,
                                                          subdiv=2),
                                str(tmp_path / "b.glb")))
    _same(ours, port)


@pytest.mark.parametrize("flt", [LINEAR, NEAREST], ids=["linear",
                                                        "nearest"])
@pytest.mark.parametrize("wrap", [REPEAT, CLAMP, MIRROR],
                         ids=["repeat", "clamp", "mirror"])
def test_textures_round_trip(tmp_path, wrap, flt):
    """Each of the five slots on its own material and texture, through
    the writer and the port's loader: pixels, sampler and slot."""
    from logipathtracer_tpu_torch.scene.gltf import load_gltf
    rng = np.random.default_rng(wrap + flt)
    other = {REPEAT: CLAMP, CLAMP: MIRROR, MIRROR: REPEAT}[wrap]
    textures, materials, nodes = [], [], []
    for k, slot in enumerate(TEXTURE_SLOTS):
        h, w = rng.integers(1, 20, 2)
        textures.append(Texture(
            pixels=rng.integers(0, 256, (h, w, 4)).astype(np.uint8),
            wrap_s=wrap, wrap_t=other, mag_filter=flt,
            min_filter=LINEAR + NEAREST - flt))
        materials.append(Material(name=slot, **{slot: k}))
        tris, nrm, uvs = quad((k, 0, 0), 1.0, 2)
        nodes.append(MeshNode(slot, np.eye(4, dtype=np.float32),
                              [Primitive(tris, nrm, uvs, k)]))
    ours = Scene(mesh_nodes=nodes, materials=materials, textures=textures,
                 cameras=[CameraNode("camera", look_at((0, 0, 5), (0, 0, 0)),
                                     0.8)])
    _same(ours, load_gltf(write_glb(ours, str(tmp_path / "t.glb"))))


@pytest.mark.parametrize("config,digest", [
    ("box_1080p",
     "85d1e7e69e9077c221cc8a7a6fbef3c62805118c475f4208d0b0117bf8fc8a51"),
    ("outside_1080p",
     "ff6eeca19c49dcce003969538941bb17d11fc3bba07c314aefe761ab5d2e0374")])
def test_config_glb_bytes_unchanged(tmp_path, config, digest):
    """The .glb each existing configuration writes, pinned by SHA-256 to
    the bytes written before the writer took textures."""
    from portbench.harness import load_module
    sc = json.load(open(os.path.join(HERE, "configs",
                                     config + ".json")))["scene"]
    gen = load_module(os.path.join(HERE, "scenes", sc["generator"] + ".py"),
                      "portbench_scene_" + sc["generator"])
    path = write_glb(gen.make(**sc["args"]), str(tmp_path / "s.glb"))
    assert hashlib.sha256(open(path, "rb").read()).hexdigest() == digest
