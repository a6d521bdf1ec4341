"""The port against the JAX package with ``render_scale=2`` through
``image()``, at a small shape with the traits of the default
configuration (``test_torch_default_shape.py``): 24x14 shown, 48x28
rendered — row-major pixels (28 rows are no multiple of the 8-row
block of a 256-ray tile) and a 1,344-lane pool of five tiles and a
padded sixth — box-filtered down to 24x14 and tonemapped.  At
1920x1080 the same path renders 3840x2160, 8,294,400 pixel ids through
the flush.

It renders step(2), rotate(1, 0.05), step(2), step(2) with host seed 3
in both packages.  Criteria: >= 99.5% of the image's pixels and of the
rendered radiance's isclose(rtol=1e-4, atol=1e-6), equal sample and
traced-ray counts."""

from test_torch_default_shape import BASE, assert_agree, render_both

from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.render.wavefront import pix_layout


def test_render_scale_image_matches_jax():
    fields = dict(width=24, height=14, render_scale=2)
    cfg = RenderConfig(**dict(BASE, **fields))
    assert (cfg.render_width, cfg.render_height) == (48, 28)
    assert not pix_layout(cfg, None, 28, 48)[0]
    jr, tr, want, got = render_both(fields, image=True)
    assert got.shape == want.shape == (14, 24, 3)
    assert_agree(jr, tr, want, got)
    assert_agree(jr, tr, jr.radiance(), tr.radiance())
