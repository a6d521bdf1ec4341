"""The port against the JAX package at small shapes with the traits of
the default configuration (``test_torch_default_shape.py``): a pool
smaller than the frame, and the megakernel's padded tail tile.

  * the wavefront at 40x24 with a 512-lane pool of 256-ray tiles: 960
    pixels through 512 lanes, so the regen index ``item % npix`` crosses
    a pool refill within every sample, as 2,073,600 pixels do through
    the 2^20-lane pool at 1920x1080; rows are row-major (40 is no
    multiple of the 32-pixel block width);
  * the megakernel at 48x27: 1,296 rays, five 256-ray tiles and a
    padded sixth (at 1920x1080: 506 tiles and a padded 507th).

Each renders step(2), rotate(1, 0.05), step(2), step(2) with host seed
3 in both packages.  Criteria: >= 99.5% of pixels isclose(rtol=1e-4,
atol=1e-6), equal sample and traced-ray counts."""

from test_torch_default_shape import BASE, assert_agree, render_both

from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.render.wavefront import pix_layout


def test_pool_smaller_than_frame_matches_jax():
    fields = dict(width=40, height=24, pool_size=512)
    cfg = RenderConfig(**dict(BASE, **fields))
    assert not pix_layout(cfg, None, 24, 40)[0]
    assert cfg.pool_size < 40 * 24
    assert_agree(*render_both(fields))


def test_megakernel_padded_tail_matches_jax():
    fields = dict(width=48, height=27, renderer="megakernel")
    assert (48 * 27) % BASE["compact_tile"]
    assert_agree(*render_both(fields))
