"""The port against the JAX package at small shapes with the traits of
the system's default configuration (1920x1080, RenderConfig's
defaults; its web preview 480x270), which neither tiles into 32x128
pixel blocks nor fills whole 4096-ray tiles:

  * row-major pixels: ``pix_layout`` blocks only when the rows divide by
    the tile's block height (1080 % 128 = 56);
  * a padded tail tile: ``pack_rays8`` pads the pool (or the
    megakernel's frame) up to a whole tile;
  * a pool smaller than the frame (2^20 lanes for 2,073,600 pixels);
  * a camera move between chunks, which drops a pool with paths in
    flight.

Here: the wavefront at 48x27 with 256-ray tiles (8-row blocks: 27 rows
fall back to row-major; a 1,296-lane pool is 5 tiles and 16 rays).
``test_torch_default_shape_pool.py`` covers the pool smaller than the
frame and the megakernel, ``test_torch_default_shape_scale.py``
``render_scale=2`` through ``image()``.  Each renders step(2),
rotate(1, 0.05), step(2), step(2) with host seed 3 in both packages (the
JAX package through its compact kernel's interpret mode).

Criteria (tests/test_wavefront.py:36-37): >= 99.5% of pixels
isclose(rtol=1e-4, atol=1e-6), equal sample and traced-ray counts.

Also ``tools/interactive.py`` on the CPU at 64x36 with 2 + 2 frames: its
report's keys, and its converged image equal to a plain session's with
the same seeds, camera and calls."""

import json

import numpy as np

from logipathtracer_tpu.config import RenderConfig as JaxConfig
from logipathtracer_tpu.render.progressive import \
    ProgressiveRenderer as JaxRenderer
from logipathtracer_tpu.scene.compile import compile_scene
from logipathtracer_tpu.scene.procedural import make_box_scene
from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.ops.kernels._build import COUNTS
from logipathtracer_tpu_torch.render.progressive import ProgressiveRenderer
from logipathtracer_tpu_torch.render.wavefront import pix_layout

BASE = dict(max_depth=5, renderer="wavefront", intersect="compact_interpret",
            compact_tile=256)
HOST_SEED = 3


def _session(r):
    r.step(2)
    r.rotate(1, 0.05)          # a reset with paths in flight
    r.step(2)
    r.step(2)
    return r


def render_both(fields, image=False):
    """The same session in both packages on the box with two spheres:
    (JAX renderer, port renderer, JAX output, port output), the output
    the mean radiance, or with ``image`` the tonemapped image.  The port
    must run each kernel's wrapper (its plain version, on the CPU)."""
    jscene = compile_scene(make_box_scene(spheres=2, subdiv=3),
                           use_native=False)
    fields = dict(BASE, **fields)
    names = ("compact_intersect", "shade") + (
        ("flush",) if fields["renderer"] == "wavefront" else ())
    calls = {k: COUNTS[k].plain_calls for k in names}
    jr = _session(JaxRenderer(jscene, JaxConfig(**fields),
                              host_seed=HOST_SEED))
    tr = _session(ProgressiveRenderer(jscene, RenderConfig(**fields),
                                      host_seed=HOST_SEED, device="cpu"))
    assert all(COUNTS[k].plain_calls > n for k, n in calls.items())
    if image:
        return jr, tr, np.asarray(jr.image()), tr.image().numpy()
    return jr, tr, jr.radiance(), tr.radiance()


def assert_agree(jr, tr, want, got):
    frac = np.isclose(got, want, rtol=1e-4, atol=1e-6).all(-1).mean()
    assert frac >= 0.995, f"{frac:.4f} of pixels close"
    assert tr.sample_count == jr.sample_count == 4
    assert tr.total_rays == jr.total_rays
    assert np.isfinite(got).all() and got.mean() > 0.01


def test_unblocked_padded_wavefront_matches_jax():
    fields = dict(width=48, height=27)
    cfg = RenderConfig(**dict(BASE, **fields))
    blocked, bh, bw = pix_layout(cfg, None, 27, 48)
    assert not blocked and (bh, bw) == (8, 32)
    assert (48 * 27) % cfg.compact_tile              # a padded tail tile
    assert_agree(*render_both(fields))


REPORT_KEYS = {"scene", "resolution", "preview_resolution", "preview_depth",
               "device", "renderer", "scene_compile_s", "warmup_s",
               "navigate_1spp", "converge_accum", "png_screenshot_s",
               "nav_frames", "acc_frames"}
PHASE_KEYS = {"fps_mean", "fps_best", "frame_ms_median", "samples_per_sec",
              "mrays_per_sec"}


def test_interactive_tool_on_cpu(tmp_path, capsys, monkeypatch):
    from logipathtracer_tpu_torch.film.png import decode_png
    from logipathtracer_tpu_torch.scene.procedural import \
        make_box_scene as port_box
    from logipathtracer_tpu_torch.tools import interactive
    from logipathtracer_tpu_torch.tools.glb import write_glb
    glb = write_glb(port_box(spheres=2, subdiv=3), str(tmp_path / "box.glb"))
    out = str(tmp_path / "session")
    argv = ["--cpu", "--scene", glb, "--width", "64", "--height", "36",
            "--nav-frames", "2", "--acc-frames", "2"]
    report, img = interactive.run(interactive.parse_args(argv
                                                         + ["--out", out]))
    assert report == json.load(open(out + "_report.json"))
    assert set(report) == REPORT_KEYS
    assert (report["resolution"], report["preview_resolution"],
            report["preview_depth"], report["renderer"], report["device"]) \
        == ("64x36", "64x64", 4, "wavefront", "cpu")
    for phase, frames in (("navigate_1spp", "nav_frames"),
                          ("converge_accum", "acc_frames")):
        assert set(report[phase]) == PHASE_KEYS
        assert report[phase]["samples_per_sec"] > 0
        assert report[phase]["mrays_per_sec"] > 0
        assert len(report[frames]) == 2
    png = decode_png(open(out + ".png", "rb").read())
    assert png.shape[:2] == (36, 64) and png[..., :3].max() > 0

    # The converged image equals a plain session's: the full renderer's
    # warm-up frame, the camera turned as far as the navigation turned
    # the preview, then one sample and one image a frame, in turn.
    r = ProgressiveRenderer(interactive.load_scene(glb),
                            RenderConfig(width=64, height=36, max_depth=10),
                            host_seed=interactive.HOST_SEED, device="cpu")
    r.step(1)
    r.image_u8()
    r.rotate(1, interactive.TURN * 2)
    for _ in range(2):
        r.step(1)
        r.image_u8()
    np.testing.assert_array_equal(r.image().numpy(), img)
    assert r.sample_count == 2

    # The command prints the session's report without its frame lists.
    monkeypatch.setattr(interactive, "run", lambda args: (report, img))
    assert interactive.main(argv) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {k: v for k, v in report.items()
                    if k not in ("nav_frames", "acc_frames")}
