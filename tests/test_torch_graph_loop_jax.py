"""The wavefront loop's static-shape body (two stages around one host
read, windows from the rung ladders: render/wavefront.py ``_Body``)
against the JAX package's ``render_wavefront`` at 32x32, 2 samples, a
512-lane pool, with the port's ladder floors shrunk to the tile so its
regen and trace windows take rungs below the pool: the flagship box,
NEE on the textured box, the outside class (the streamed route, plain
K4) and the scheduling knobs lazy_regen=2, sort_every=2 and
sort_rays=False.  The JAX side runs its kernels in interpret mode.

Criteria (tests/test_wavefront.py:36-37): >= 99.5% of pixels
isclose(rtol=1e-4, atol=1e-6), equal traced-ray counts and equal
iteration counts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from logipathtracer_tpu.config import RenderConfig as JaxConfig
from logipathtracer_tpu.render.wavefront import \
    render_wavefront as jax_render_wavefront
from logipathtracer_tpu.scene.compile import compile_scene
from logipathtracer_tpu.scene.procedural import (make_box_scene,
                                                 make_outside_scene)
from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.render import wavefront
from logipathtracer_tpu_torch.scene.types import SceneSoA

BOX = dict(width=32, height=32, max_depth=10, renderer="wavefront",
           compact_tile=256, pool_size=512)
SEEDS = np.array([[12345, 678], [999, 4242]], np.int64)
POOL = 512

# name: (scene maker, JAX fields, port fields)
CASES = {
    "flagship": (lambda: make_box_scene(spheres=2, subdiv=3),
                 dict(BOX, intersect="compact_interpret"),
                 dict(BOX, intersect="compact")),
    "nee_textured": (lambda: make_box_scene(spheres=2, subdiv=3,
                                            textured=True),
                     dict(BOX, intersect="compact_interpret", nee=True),
                     dict(BOX, intersect="compact", nee=True)),
    "outside": (lambda: make_outside_scene(objects=8, n_materials=8,
                                           tri_budget=8000),
                dict(BOX, cluster_size=512, stream_tile=256,
                     intersect="stream_interpret"),
                dict(BOX, cluster_size=512, stream_tile=256,
                     intersect="stream")),
    "lazy_regen": (lambda: make_box_scene(spheres=2, subdiv=3),
                   dict(BOX, intersect="compact_interpret", lazy_regen=2),
                   dict(BOX, intersect="compact", lazy_regen=2)),
    "sort_every": (lambda: make_box_scene(spheres=2, subdiv=3),
                   dict(BOX, intersect="compact_interpret", sort_every=2),
                   dict(BOX, intersect="compact", sort_every=2)),
    "unsorted": (lambda: make_box_scene(spheres=2, subdiv=3),
                 dict(BOX, intersect="compact_interpret", sort_rays=False),
                 dict(BOX, intersect="compact", sort_rays=False)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_static_body_matches_jax(name, monkeypatch):
    make, jfields, fields = CASES[name]
    jscene = compile_scene(make(), JaxConfig(**jfields), use_native=False)
    cam = jscene.cameras[0]
    ref, ref_rays, ref_it = jax_render_wavefront(
        jscene, JaxConfig(**jfields), jnp.asarray(cam.world_matrix),
        jnp.float32(cam.yfov), jnp.asarray(SEEDS, jnp.uint32), pool=POOL)
    monkeypatch.setattr(wavefront, "REGEN_FLOOR", 256)
    monkeypatch.setattr(wavefront, "TRACE_FLOOR", 256)
    scene = SceneSoA.from_numpy(jscene).to("cpu")
    img, rays, it = wavefront.render_wavefront(
        scene, RenderConfig(**fields),
        torch.from_numpy(np.asarray(cam.world_matrix, np.float32)),
        float(cam.yfov), torch.from_numpy(SEEDS), pool=POOL)
    frac = np.isclose(img.numpy(), np.asarray(ref), rtol=1e-4,
                      atol=1e-6).all(-1).mean()
    assert frac >= 0.995, f"{frac:.4f} of pixels close"
    assert rays == int(ref_rays) and it == int(ref_it)
    assert float(img.mean()) > 0.01
