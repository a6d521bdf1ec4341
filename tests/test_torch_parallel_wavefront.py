"""The port's device mesh on its wavefront route: every (sample, tile)
shard renders its rows through ``render_wavefront`` (the JAX package's
tile-parallel wavefront mesh, tests/test_parallel.py:137-162), at 16x16,
max_depth 4, on ``["cpu"] * 4`` — the criteria of test_torch_parallel.py
for the shapes (4, 1), (2, 2) and (1, 4) against JAX's mesh, which walks
the BVH; then the wavefront mesh against the megakernel mesh at the
pixel rule, and ``renderer="auto"``, which takes the wavefront in the
port (the JAX package takes it on a TPU only)."""

import numpy as np
import pytest
import torch

from test_torch_parallel import (FIELDS, SHAPES, _close_frac, check_shape,
                                 port_mesh, scenes)  # noqa: F401

WAVEFRONT = dict(FIELDS, renderer="wavefront")


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_matches_single_device(scenes, shape):
    check_shape(scenes, WAVEFRONT, shape)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_wavefront_mesh_matches_megakernel_mesh(scenes, shape):
    _, scene = scenes
    wf = port_mesh(scene, WAVEFRONT, shape)
    mk = port_mesh(scene, dict(FIELDS, renderer="megakernel"), shape)
    for r in (wf, mk):
        r.step(4)
    assert wf.sample_count == mk.sample_count == 4
    frac = _close_frac(wf.radiance(), mk.radiance())
    assert frac >= 0.995, f"{frac:.4f} divergent pixels"
    assert wf.total_rays == mk.total_rays


def test_auto_takes_the_wavefront(scenes):
    _, scene = scenes
    auto = port_mesh(scene, dict(FIELDS, renderer="auto"), (2, 2))
    wf = port_mesh(scene, WAVEFRONT, (2, 2))
    for r in (auto, wf):
        r.step()
    for i in range(2):
        for j in range(2):
            assert torch.equal(auto.accum[i][j], wf.accum[i][j])
    np.testing.assert_array_equal(auto.radiance(), wf.radiance())
