"""The port's streamed-scene path with next-event estimation on the CPU:
as test_torch_stream_slice.py (same scene, settings and criteria), with
``nee=True``, so the shadow rays of every iteration go through the
route's kernel in its t_max / any-hit mode."""

import pytest

from test_torch_stream_slice import ROUTES, check_route, outside_scene, \
    render_both


@pytest.fixture(scope="module")
def renders():
    jscene = outside_scene(nee=True)
    assert jscene.num_lights > 0
    return render_both(jscene, nee=True)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_stream_nee_render_matches_jax(renders, route):
    ref, port = renders
    got = port(route)
    check_route(ref, got)
    # Every iteration traced the path rays and the shadow rays.
    assert got[2] % 2 == 0
