"""The port's numpy scene pipeline and config against the JAX package's:
``compile_scene`` must give bit-identical arrays (with the numpy BVH
builder and, where it compiles, the native one), ``RenderConfig`` the
same fields and defaults, and ``SceneSoA.from_numpy`` must carry a JAX
scene over unchanged."""

import dataclasses

import numpy as np
import pytest
import torch

from logipathtracer_tpu.config import RenderConfig as JaxConfig
from logipathtracer_tpu.scene import procedural as jproc
from logipathtracer_tpu.scene.bvh_native import \
    native_available as jax_native
from logipathtracer_tpu.scene.compile import compile_scene as jax_compile
from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.scene import procedural as tproc
from logipathtracer_tpu_torch.scene.bvh_native import \
    native_available as torch_native
from logipathtracer_tpu_torch.scene.compile import compile_scene
from logipathtracer_tpu_torch.scene.types import SceneSoA

SCENES = {
    "box": lambda m: m.make_box_scene(spheres=2, subdiv=3),
    "outside": lambda m: m.make_outside_scene(objects=8, tri_budget=20_000),
}


def _assert_same_scene(a, b):
    for f in SceneSoA._ARRAY_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    for f in SceneSoA._STATIC_FIELDS:
        if f == "cameras":
            ca, cb = getattr(a, f), getattr(b, f)
            assert len(ca) == len(cb)
            for u, v in zip(ca, cb):
                np.testing.assert_array_equal(u.world_matrix, v.world_matrix)
                assert (u.yfov, u.name) == (v.yfov, v.name)
        else:
            assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_compile_scene_bit_identical(name, use_native):
    if use_native and not (jax_native() and torch_native()):
        pytest.skip("native BVH builder does not compile here")
    ref = jax_compile(SCENES[name](jproc), use_native=use_native)
    got = compile_scene(SCENES[name](tproc), use_native=use_native)
    _assert_same_scene(ref, got)


def test_render_config_field_parity():
    jf = dataclasses.fields(JaxConfig)
    tf = dataclasses.fields(RenderConfig)
    assert [f.name for f in tf] == [f.name for f in jf]
    for a, b in zip(jf, tf):
        assert a.default == b.default, a.name
        assert a.type == b.type, a.name
    cfg = RenderConfig(width=64, height=32, render_scale=2)
    assert (cfg.render_width, cfg.render_height) == (128, 64)
    assert cfg.replace(max_depth=3).max_depth == 3


def test_scene_from_numpy_round_trip():
    ref = jax_compile(SCENES["box"](jproc), use_native=False)
    host = SceneSoA.from_numpy(ref)
    _assert_same_scene(ref, host)
    dev = host.to("cpu")
    assert isinstance(dev.cl_tris, torch.Tensor)
    assert dev.cl_tris.device == torch.device("cpu")
    back = SceneSoA.from_numpy(
        dataclasses.replace(dev, **{
            f: (None if getattr(dev, f) is None
                else getattr(dev, f).numpy())
            for f in SceneSoA._ARRAY_FIELDS}))
    _assert_same_scene(ref, back)
