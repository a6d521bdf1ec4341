"""The port's megakernel renderer against the JAX package's
``render_sample`` on the dense resident sweep (K8, ``sweep_interpret``
in the JAX package) and its jnp twin, and on the textured box with
next-event estimation (K7, so the shadow rays go through K7's any-hit
mode): as test_torch_megakernel.py, same settings and criterion."""

import pytest

from test_torch_megakernel import box_scenes, check_route


@pytest.fixture(scope="module")
def scenes():
    return box_scenes()


@pytest.mark.parametrize("route", ["k8", "sweep_jnp"])
def test_render_sample_matches_jax(scenes, route):
    check_route(scenes, route)


def test_textured_nee_render_sample_matches_jax():
    tex = box_scenes(textured=True)
    assert tex[0].num_lights > 0 and tex[0].has_textures
    check_route(tex, "k7", nee=True)
