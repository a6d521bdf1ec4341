"""The stage-split tool (``logipathtracer_tpu_torch.tools.stages``) on
the CPU at a tiny size, on wavefront and megakernel routes: every stage
of the route's iteration (a megakernel sample) is timed,
the stages fit inside the iteration total, and the wrapped functions
are restored afterwards.  Its device parts (busy share, prepass
comparison) need the card and run in a chip call."""

import json

import pytest

from logipathtracer_tpu_torch import compile_scene
from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.ops.kernels import stream_cluster as k4
from logipathtracer_tpu_torch.render import megakernel, wavefront
from logipathtracer_tpu_torch.render.progressive import ProgressiveRenderer
from logipathtracer_tpu_torch.scene.procedural import (make_box_scene,
                                                       make_outside_scene)
from logipathtracer_tpu_torch.tools import stages

WAVEFRONT = ("ray pack", "stage A: sort + gather + K3 flush + counts",
             "stage B: regen", "K2 kernel + wrapper")
MEGAKERNEL = ("sort key", "ray pack", "K2 kernel + wrapper")

# scene, config, the stages its iteration must time
CASES = {
    "outside": (lambda: make_outside_scene(objects=8, n_materials=8,
                                           tri_budget=8000),
                dict(intersect="stream", stream_tile=256, cluster_size=512),
                ("frustum prepass", "K4 kernel") + WAVEFRONT),
    "box": (lambda: make_box_scene(spheres=1, subdiv=2),
            dict(compact_tile=256),
            ("K1 worklist", "K1 kernel") + WAVEFRONT),
    "box-basic": (lambda: make_box_scene(spheres=1, subdiv=2),
                  dict(compact_tile=256, use_microfacet=False),
                  ("K1 worklist", "K1 kernel", "ray pack",
                   "stage A: sort + gather + K3 flush + counts",
                   "stage B: regen", "basic route")),
    "megakernel-k7": (lambda: make_box_scene(spheres=1, subdiv=2),
                      dict(renderer="megakernel", compact_tile=256,
                           compact_worklist=False),
                      ("K7 kernel",) + MEGAKERNEL),
    "megakernel-k8": (lambda: make_box_scene(spheres=1, subdiv=2),
                      dict(renderer="megakernel", intersect="sweep",
                           sweep_tile=256),
                      ("K8 kernel",) + MEGAKERNEL),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_stage_split(name):
    make, kw, route = CASES[name]
    cfg = RenderConfig(width=16, height=16, pool_size=256, max_depth=4, **kw)
    r = ProgressiveRenderer(compile_scene(make(), cfg, use_native=False),
                            cfg, host_seed=0, device="cpu")
    call, stage_a, regen = (wavefront._Body.__dict__[k] for k in
                            ("__call__", "stage_a", "_regen"))
    build, trace = k4.build_cluster_worklists, megakernel.trace_rays
    out = stages.stage_split(r, chunks=(1, 1))
    st = out["stages"]
    assert st["iteration total"][1] == sum(out["iterations"]) > 0
    for k in route:
        assert st[k][1] > 0 and st[k][0] >= 0.0, k
    assert 0.0 <= st["rest"][0] <= st["iteration total"][0]
    # The basic BSDF shades through its own route, never K2.
    assert ("K2 kernel + wrapper" in st) == cfg.use_microfacet
    assert wavefront._Body.__dict__["__call__"] is call
    assert wavefront._Body.__dict__["stage_a"] is stage_a
    assert wavefront._Body.__dict__["_regen"] is regen
    assert r._eager is False
    assert k4.build_cluster_worklists is build
    assert megakernel.trace_rays is trace


def test_main_sets_config_fields(capsys):
    """``--set FIELD=VALUE`` reaches the RenderConfig: max_depth=2 gives
    the megakernel 2 K8 launches per sample."""
    stages.main(["--scene", "box", "--res", "8", "--device", "cpu",
                 "--renderer", "megakernel", "--intersect", "sweep",
                 "--set", "max_depth=2", "--set", "sweep_tile=128"])
    st = json.loads(capsys.readouterr().out)["stages"]
    assert st["stages"]["iteration total"][1] == 4
    assert st["stages"]["K8 kernel"][1] == 8
