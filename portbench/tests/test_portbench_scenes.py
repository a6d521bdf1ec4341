"""The frozen scene generators and glb writer give the same arrays as
the port's ``make_box_scene``, ``make_outside_scene`` and ``write_glb``
at this commit, read back through the port's loader."""

import numpy as np
import pytest

from portbench.scenes import box, outside
from portbench.scenes.glb import write_glb


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
                  "transmission_factor", "ior"):
            assert getattr(ma, f) == getattr(mb, f)
    for ca, cb in zip(a.cameras, b.cameras):
        np.testing.assert_array_equal(ca.world_matrix, cb.world_matrix)
        assert ca.yfov == cb.yfov


@pytest.mark.parametrize("which", ["box", "outside"])
def test_generators_match_port(which):
    from logipathtracer_tpu_torch.scene import procedural
    if which == "box":
        ours = box.make(spheres=10, subdiv=3)
        port = procedural.make_box_scene(spheres=10, subdiv=3)
        assert ours.triangle_count == 12812
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
