"""The port's ``render_wavefront`` on row slabs against the JAX
package's on ``make_box_scene(spheres=2, subdiv=3)`` at 32x32, two seeds,
a 512-lane pool (the full frame: test_torch_render_wavefront.py): two
16-row slabs keep the 8x32 block-major pixel layout; a 12-row slab,
which the block height 8 does not divide, falls back to row-major
order with y0 added to each row.  The JAX side walks the BVH, as its
own slab test does (tests/test_wavefront.py:166-184); the port runs
the plain K1.

Criteria (tests/test_wavefront.py:36-37): >= 99.5% of pixels
isclose(rtol=1e-4, atol=1e-6), equal traced-ray counts and equal
iteration counts."""

import pytest

from test_torch_render_wavefront import (FIELDS, SEEDS, _close_frac, _jax,
                                         _port, scenes)  # noqa: F401


@pytest.mark.parametrize("y0,rows", [(0, 16), (16, 16), (4, 12)])
def test_slab_matches_jax(scenes, y0, rows):
    jscene, scene = scenes
    img, rays, it = _port(scene, FIELDS, SEEDS, y0=y0, rows=rows)
    ref, ref_rays, ref_it = _jax(jscene, dict(FIELDS, intersect="bvh"),
                                 SEEDS, y0=y0, rows=rows)
    assert img.shape == (rows, 32, 3)
    frac = _close_frac(img.numpy(), ref)
    assert frac >= 0.995, f"{frac:.4f} of pixels close"
    assert rays == ref_rays and it == ref_it
