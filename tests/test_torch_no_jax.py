"""The port never imports JAX or the JAX package: in a fresh interpreter
where ``import jax`` fails, importing logipathtracer_tpu_torch (its
command line, web viewer, EXR writer, logger, .glb writer, interactive
session tool, device mesh and CUDA graph cache too) and tiny CPU renders (a session, a
(1, 2) mesh, a 16-row ``render_wavefront`` slab) all work, and no module
of the package (nor ``chip_smoke.py``) has an import of either."""

import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "logipathtracer_tpu_torch"

SCRIPT = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["jaxlib"] = None
import numpy as np
import logipathtracer_tpu_torch as lpt
import logipathtracer_tpu_torch.cli.main
import logipathtracer_tpu_torch.cli.webview
import logipathtracer_tpu_torch.film.exr
import logipathtracer_tpu_torch.tools.glb
import logipathtracer_tpu_torch.render.graph
import logipathtracer_tpu_torch.tools.interactive
import logipathtracer_tpu_torch.utils.log
import torch
from logipathtracer_tpu_torch.parallel.mesh import MeshRenderer, make_mesh
from logipathtracer_tpu_torch.scene.procedural import make_box_scene
scene = lpt.compile_scene(make_box_scene(spheres=1, subdiv=2),
                          use_native=False)
cfg = lpt.RenderConfig(width=16, height=16, max_depth=4, compact_tile=256,
                       pool_size=256)
r = lpt.ProgressiveRenderer(scene, cfg, host_seed=1, device="cpu")
r.step(1)
rad = r.radiance()
assert rad.shape == (16, 16, 3) and np.isfinite(rad).all()
assert rad.mean() > 0
mesh = MeshRenderer(scene, cfg, make_mesh(["cpu"] * 2, samples=1, tiles=2),
                    host_seed=1)
mesh.step()
np.testing.assert_array_equal(mesh.radiance(), rad)
cam = scene.cameras[0]
slab, rays, iters = lpt.render_wavefront(
    scene.to("cpu"), cfg,
    torch.from_numpy(np.asarray(cam.world_matrix, np.float32)),
    float(cam.yfov), torch.tensor([[3, 4]]), y0=0, rows=16)
assert slab.shape == (16, 16, 3) and rays > 0 and iters > 0
bad = [m for m in sys.modules
       if m == "logipathtracer_tpu" or m.startswith("logipathtracer_tpu.")
       or (m.startswith("jax") and sys.modules[m] is not None)]
assert not bad, bad
print("OK", float(rad.mean()))
"""


def test_import_and_render_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")


def test_no_module_imports_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|logipathtracer_tpu)"
                     r"(\.|\s|$)", re.M)
    files = [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]
    scanned = {p.relative_to(PKG).as_posix() for p in files
               if PKG in p.parents}
    for module in ("cli/main.py", "cli/webview.py", "utils/log.py",
                   "film/exr.py", "tools/glb.py", "tools/interactive.py",
                   "parallel/mesh.py", "render/graph.py"):
        assert module in scanned, module
    offenders = [str(p.relative_to(ROOT)) for p in files
                 if pat.search(p.read_text())]
    assert not offenders, offenders
