"""The port never imports JAX or the JAX package: in a fresh interpreter
where ``import jax`` fails, importing logipathtracer_tpu_torch and a
tiny CPU render both work."""

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
    offenders = [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
                 if pat.search(p.read_text())]
    assert not offenders, offenders
