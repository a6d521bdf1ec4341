"""The port's web viewer (``cli/webview.py``): the routes, keys, quit
and the preview switch of tests/test_webview.py against a stub
renderer, then with the port's CPU renderer behind it: the display size
sent to the client is (width, height), the size of the published
frames, also at render_scale 2, and the stats carry the trace's host
syncs; and the renderer and its preview share one loaded glTF."""

import json
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from logipathtracer_tpu_torch.cli import main as cli
from logipathtracer_tpu_torch.cli.webview import serve
from logipathtracer_tpu_torch.film.png import decode_png
from logipathtracer_tpu_torch.scene.procedural import make_box_scene
from logipathtracer_tpu_torch.tools.glb import write_glb


class StubRenderer:
    def __init__(self):
        self.sample_count = 0
        self.moves = []
        self.rots = []

    def step(self, n=1):
        time.sleep(0.01)
        self.sample_count += n

    def image(self):
        v = min(self.sample_count * 8, 255) / 255.0
        return np.full((16, 16, 3), v, np.float32)

    def samples_per_sec(self):
        return float(self.sample_count)

    def mrays_per_sec(self):
        return 0.5

    def translate(self, axis, amount):
        self.moves.append((axis, amount))
        self.sample_count = 0  # motion resets accumulation

    def rotate(self, axis, angle):
        self.rots.append((axis, angle))
        self.sample_count = 0


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.read()


def _get_raw(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.read(), dict(r.headers)


def _post(url, body):
    req = urllib.request.Request(url, data=body.encode(), method="POST")
    with urllib.request.urlopen(req, timeout=5) as r:
        return r.read()


def _start(tmp_path, build, **kw):
    """serve(args, build) on a thread; returns (base url, thread, rc)."""
    port_file = tmp_path / "port"
    args = types.SimpleNamespace(host="127.0.0.1", port=0,
                                 port_file=str(port_file), frames=0,
                                 linger=0.0, **kw)
    rc = {}
    t = threading.Thread(target=lambda: rc.setdefault(
        "rc", serve(args, build)), daemon=True)
    t.start()
    for _ in range(200):
        if port_file.exists() and port_file.read_text():
            break
        time.sleep(0.05)
    return f"http://127.0.0.1:{port_file.read_text()}", t, rc


def _quit(base, t):
    try:
        _post(base + "/key", "x")
    except OSError:
        pass  # the test already quit the server
    t.join(timeout=30)


def _wait_frames(base, spp=1, tries=600):
    for _ in range(tries):
        stats = json.loads(_get(base + "/stats"))
        if not stats["compiling"] and stats["spp"] >= spp \
                and stats["frame_gen"] > 0:
            return stats
        time.sleep(0.05)
    raise AssertionError(f"no frame: {stats}")


@pytest.fixture
def viewer(tmp_path):
    stub = StubRenderer()

    def build(a):
        time.sleep(0.05)  # exercise the async-load phase
        return None, None, stub

    base, t, rc = _start(tmp_path, build)
    yield base, stub, t, rc
    _quit(base, t)


def test_webview_raw_route(viewer):
    """/frame.raw serves the uint8 RGBA blit with size headers."""
    base, stub, t, rc = viewer
    _wait_frames(base, spp=2)
    body, headers = _get_raw(base + "/frame.raw")
    w = int(headers["X-Frame-Width"])
    h = int(headers["X-Frame-Height"])
    assert (w, h) == (16, 16)
    assert len(body) == w * h * 4
    arr = np.frombuffer(body, np.uint8).reshape(h, w, 4)
    assert arr[..., 3].min() == 255
    assert arr[..., :3].max() > 0


def test_webview_preview_switch(tmp_path):
    """With a preview renderer (4-tuple build), key frames render on
    the preview and key-free frames return to the full renderer."""
    full, prev = StubRenderer(), StubRenderer()
    prev.image = lambda: np.full((8, 8, 3), 0.5, np.float32)
    base, t, rc = _start(tmp_path, lambda a: (None, None, full, prev))
    try:
        saw_preview = False
        for _ in range(60):
            _post(base + "/key", "j")
            _, headers = _get_raw(base + "/frame.raw")
            if int(headers["X-Frame-Width"]) == 8:
                saw_preview = True
                break
            time.sleep(0.03)
        assert saw_preview
        assert prev.rots and full.rots  # camera mirrored to both
        saw_full = False
        for _ in range(60):
            _, headers = _get_raw(base + "/frame.raw")
            if int(headers["X-Frame-Width"]) == 16:
                saw_full = True
                break
            time.sleep(0.03)
        assert saw_full
    finally:
        _quit(base, t)


def test_webview_routes_and_keys(viewer):
    base, stub, t, rc = viewer
    page = _get(base + "/").decode()
    assert "frame.png" in page and "keydown" in page
    stats = _wait_frames(base, spp=3)
    assert stats["mrays_per_sec"] == 0.5

    img = decode_png(_get(base + "/frame.png"))
    assert img.shape[:2] == (16, 16)
    assert img[..., :3].max() > 0

    # Keys: translate + rotate reach the renderer and reset spp.
    _post(base + "/key", "w")
    _post(base + "/key", "j")
    for _ in range(100):
        if stub.moves and stub.rots:
            break
        time.sleep(0.05)
    assert stub.moves == [(2, -0.05)]
    assert stub.rots == [(1, 0.02)]

    # Unknown routes 404; junk keys are ignored.
    with pytest.raises(urllib.error.HTTPError):
        _get(base + "/nope")
    _post(base + "/key", "z")

    # 'x' quits: serve() returns 0 and the loop stops.
    _post(base + "/key", "x")
    t.join(timeout=10)
    assert not t.is_alive()
    assert rc["rc"] == 0


@pytest.fixture(scope="module")
def glb(tmp_path_factory):
    return write_glb(make_box_scene(spheres=1, subdiv=2),
                     str(tmp_path_factory.mktemp("scene") / "box.glb"))


def _cli_args(glb, **kw):
    ns = dict(scene=glb, width=16, height=16, render_scale=1, spp=1,
              max_depth=3, basic=False, nee=False, mips=1, seed=0, camera=0,
              leaf_size=4, cpu=True, renderer="auto", profile=None,
              preview_scale=1, preview_depth=4, settle_s=0.35,
              spp_per_frame=1)
    ns.update(kw)
    return types.SimpleNamespace(**ns)


def test_display_size_is_the_frame_size(glb, tmp_path):
    """At render_scale 2 the renderer traces 32x32 and publishes 16x16
    frames (image_u8 box-filters them): the client is told 16x16, not
    the render size."""
    built = {}

    def build(a):
        built["v"] = cli._build_web(a)
        return built["v"]

    base, t, rc = _start(tmp_path, build, **vars(_cli_args(
        glb, render_scale=2, spp_per_frame=2)))
    try:
        stats = _wait_frames(base, spp=2)
        body, headers = _get_raw(base + "/frame.raw")
    finally:
        _quit(base, t)
    # Beside samples_per_sec, the trace's last second (utils/trace.py):
    # host syncs an iteration, and no stage times off the card.
    assert stats["host_syncs_per_iteration"] > 1.0
    assert "stage_ms" not in stats
    cfg, _, r = built["v"]
    assert (cfg.render_width, cfg.render_height) == (32, 32)
    assert r.accum.shape[:2] == (32, 32)
    size = {k: int(headers[f"X-{k}"]) for k in (
        "Frame-Width", "Frame-Height", "Display-Width", "Display-Height")}
    assert size == {"Frame-Width": 16, "Frame-Height": 16,
                    "Display-Width": 16, "Display-Height": 16}
    arr = np.frombuffer(body, np.uint8).reshape(16, 16, 4)
    assert arr[..., 3].min() == 255 and arr[..., :3].max() > 0
    assert rc["rc"] == 0
    # The converge frames carried --spp-per-frame samples each.
    assert r.sample_count % 2 == 0 and r.sample_count >= 2


def test_preview_reuses_the_loaded_gltf(glb, monkeypatch):
    """_build_web loads the scene file once: the preview renderer
    compiles the glTF the full-resolution renderer loaded."""
    calls = []
    load = cli.load_gltf

    def counted(path):
        calls.append(path)
        return load(path)

    monkeypatch.setattr(cli, "load_gltf", counted)
    cfg, scene, full, preview = cli._build_web(_cli_args(
        glb, width=128, height=128, preview_scale=2, preview_depth=2))
    assert calls == [glb]
    assert (cfg.width, full.config.max_depth) == (128, 3)
    assert (preview.config.width, preview.config.height) == (64, 64)
    assert preview.config.max_depth == 2
    assert preview.scene.num_triangles == full.scene.num_triangles
