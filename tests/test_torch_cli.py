"""The port's command line and the modules it calls, against the JAX
package: ``utils/log.py``, ``film/exr.py`` (bytes equal to JAX's
``encode_exr``), ``film/image.py``'s ``to_uint8`` and
``linear_to_srgb``, ``tools/glb.py::write_glb`` (the procedural box
through a .glb compiles to the same arrays), and ``cli/main.py``:
``render --cpu`` against the JAX CLI in-process on the same .glb,
``compare``, ``view --frames``, ``--profile``, and no CPU fallback
without ``--cpu``.

Criterion for the renders (tests/test_wavefront.py:36-37): >= 99.5% of
pixels isclose(rtol=1e-4, atol=1e-6), equal spp and total_rays."""

import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from logipathtracer_tpu.cli.main import main as jax_main
from logipathtracer_tpu.film import exr as jexr
from logipathtracer_tpu.film import image as jimage
from logipathtracer_tpu.utils.log import get_logger as jax_get_logger
from logipathtracer_tpu_torch import compile_scene, load_gltf
from logipathtracer_tpu_torch.cli.main import main
from logipathtracer_tpu_torch.film import exr as texr
from logipathtracer_tpu_torch.film import image as timage
from logipathtracer_tpu_torch.film.png import decode_png
from logipathtracer_tpu_torch.scene.procedural import make_box_scene
from logipathtracer_tpu_torch.scene.types import SceneSoA
from logipathtracer_tpu_torch.tools.glb import write_glb
from logipathtracer_tpu_torch.utils.log import get_logger

BOX = dict(spheres=2, subdiv=3)


@pytest.fixture(scope="module")
def glb(tmp_path_factory):
    return write_glb(make_box_scene(**BOX),
                     str(tmp_path_factory.mktemp("scene") / "box.glb"))


def test_log_has_its_own_root():
    """The port's loggers hang under ``lpt_torch``: with both packages'
    loggers made, a line of the port's passes one stream handler."""
    jax_get_logger("cli")
    a, b = get_logger("cli"), get_logger("webview")
    assert a.name == "lpt_torch.cli" and b.name == "lpt_torch.webview"
    assert a.getEffectiveLevel() == logging.INFO
    handlers, lg = [], a
    while lg is not None:
        handlers += [h for h in lg.handlers
                     if type(h) is logging.StreamHandler]
        lg = lg.parent if lg.propagate else None
    assert len(handlers) == 1
    assert handlers[0] not in logging.getLogger("lpt").handlers


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (48, 33)])
def test_exr_bytes_match_jax(tmp_path, shape):
    img = (np.random.default_rng(shape[0]).random(shape + (3,)) * 8
           ).astype(np.float32)
    img[0, 0] = (0.0, np.inf, 1e-30)
    data = texr.encode_exr(img)
    assert data == jexr.encode_exr(img)
    texr.write_exr(str(tmp_path / "a.exr"), img)
    assert (tmp_path / "a.exr").read_bytes() == data
    with pytest.raises(ValueError):
        texr.encode_exr(img[..., :2])


def test_to_uint8_and_linear_to_srgb_match_jax():
    r = np.random.default_rng(4)
    img = (r.random((9, 13, 3)) * 1.4 - 0.2).astype(np.float32)
    ref = jimage.to_uint8(img)
    for x in (img, torch.from_numpy(img)):
        got = timage.to_uint8(x)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)
    c = np.concatenate([r.random(2000), [0.0, 0.0031308, 1e-13, 1.0]]
                       ).astype(np.float32)
    np.testing.assert_allclose(
        timage.linear_to_srgb(torch.from_numpy(c)).numpy(),
        np.asarray(jimage.linear_to_srgb(jnp.asarray(c))), rtol=2e-6,
        atol=1e-8)


def test_write_glb_round_trip(glb, tmp_path):
    """A procedural box through a .glb compiles to the same arrays as
    the box itself; a textured scene raises."""
    a = compile_scene(load_gltf(glb))
    b = compile_scene(make_box_scene(**BOX))
    for f in SceneSoA._ARRAY_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert np.asarray(x).dtype == np.asarray(y).dtype, f
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f)
    for f in SceneSoA._STATIC_FIELDS:
        if f == "cameras":
            for u, v in zip(a.cameras, b.cameras, strict=True):
                np.testing.assert_array_equal(u.world_matrix, v.world_matrix)
                assert (u.yfov, u.name) == (v.yfov, v.name)
        elif f != "name":
            assert getattr(a, f) == getattr(b, f), f
    assert a.name == "box"
    with pytest.raises(ValueError, match="textures"):
        write_glb(make_box_scene(spheres=1, subdiv=1, textured=True),
                  str(tmp_path / "t.glb"))


def _report(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def test_render_cpu_matches_jax_cli(glb, tmp_path, capsys):
    """``render --cpu --renderer wavefront`` at 32x32, 2 spp, of both
    packages' CLIs on the same .glb, in-process; then ``compare`` on the
    two radiance files."""
    args = [glb, "--width", "32", "--height", "32", "--spp", "2", "--cpu",
            "--renderer", "wavefront"]
    renders, reports = {}, {}
    for name, fn in (("jax", jax_main), ("port", main)):
        paths = {k: str(tmp_path / f"{name}.{k}")
                 for k in ("npz", "png", "exr")}
        renders[name] = (fn, paths)
        assert fn(["render", *args, "--radiance", paths["npz"], "-o",
                   paths["png"], "--exr", paths["exr"]]) == 0
        reports[name] = _report(capsys)
    j, t = reports["jax"], reports["port"]
    # The port's report adds its trace over the render (utils/trace.py):
    # host syncs an iteration, and no stage times off the card.
    assert set(t) == set(j) | {"trace"}
    assert set(t["trace"]) == {"host_syncs_per_iteration"}
    assert t["trace"]["host_syncs_per_iteration"] > 1.0
    assert t["spp"] == j["spp"] == 2
    assert t["total_rays"] == j["total_rays"] > 0
    assert (t["scene"], t["width"], t["height"]) == ("box", 32, 32)
    jr = np.load(renders["jax"][1]["npz"])
    tr = np.load(renders["port"][1]["npz"])
    assert int(tr["sample_count"]) == int(jr["sample_count"]) == 2
    close = np.isclose(tr["radiance"], jr["radiance"], rtol=1e-4,
                       atol=1e-6).all(-1)
    assert close.mean() >= 0.995, f"{close.mean():.4f} of pixels close"
    png = decode_png(open(renders["port"][1]["png"], "rb").read())
    assert png.shape[:2] == (32, 32) and png[..., :3].max() > 0
    # The EXR holds the radiance the .npz holds, in JAX's layout.
    assert (open(renders["port"][1]["exr"], "rb").read()
            == jexr.encode_exr(tr["radiance"]))

    # compare: the same JSON as the JAX CLI's, and the threshold's exit.
    a, b = renders["jax"][1]["npz"], renders["port"][1]["npz"]
    assert main(["compare", a, b]) == 0
    got = _report(capsys)
    assert jax_main(["compare", a, b]) == 0
    assert got == _report(capsys)
    assert got["shape"] == [32, 32, 3] and got["rmse"] < 0.05
    assert main(["compare", a, b, "--threshold", "-1"]) == 1
    capsys.readouterr()


def test_compare_shape_mismatch(tmp_path, capsys):
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    np.savez(a, radiance=np.zeros((4, 4, 3), np.float32))
    np.savez(b, radiance=np.ones((4, 5, 3), np.float32))
    assert main(["compare", a, b]) == 1
    assert "shape mismatch" in _report(capsys)["error"]
    np.savez(b, radiance=np.ones((4, 4, 3), np.float32))
    assert main(["compare", a, b, "--threshold", "2"]) == 0
    assert _report(capsys)["rmse"] == pytest.approx(1.0)


def test_view_frames_cpu(glb, capsys):
    assert main(["view", glb, "--width", "16", "--height", "8",
                 "--frames", "2", "--cpu", "--basic", "--orbit",
                 "0.01"]) == 0
    out = capsys.readouterr().out
    # The orbit moves the camera after each frame: the last frame
    # restarted the accumulation.
    assert "\x1b[38;2;" in out and "spp 1 " in out
    assert out.count("▀") == 16 * 4


def test_profile_writes_trace(glb, tmp_path, capsys):
    prof = tmp_path / "prof"
    assert main(["render", glb, "--width", "8", "--height", "8", "--spp",
                 "1", "--max-depth", "2", "--cpu", "--profile", str(prof),
                 "-o", str(tmp_path / "p.png")]) == 0
    assert _report(capsys)["spp"] == 1
    traces = list(prof.glob("*.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())


def test_no_cpu_fallback(glb, tmp_path, monkeypatch):
    """Without --cpu the renderer takes the card; without one it raises
    instead of rendering on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main(["render", glb, "--width", "8", "--height", "8", "--spp", "1",
              "-o", str(tmp_path / "x.png")])
    assert not (tmp_path / "x.png").exists()
