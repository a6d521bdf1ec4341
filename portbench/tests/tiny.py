"""Tiny CPU versions of the cells, for the benchmark's own tests: the
same drivers, program and reference on a small scene and frame."""

from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def overrides(workload: str) -> dict:
    """Overrides that shrink ``workload`` to a few seconds on the CPU."""
    bench = json.load(open(os.path.join(os.path.dirname(HERE),
                                        "BENCHMARK.json")))
    wl = {w["name"]: w for w in bench["workloads"]}[workload]
    traffic = json.load(open(os.path.join(HERE, "traffic",
                                          wl["traffic"] + ".json")))
    if wl["config"].startswith("outside"):
        ov = {"scene_args": {"objects": 6, "n_materials": 6,
                             "tri_budget": 3000},
              "render": {"width": 32, "height": 18, "pool_size": 1024,
                         "stream_tile": 1024, "intersect": "stream",
                         "cluster_size": 512}}
    else:
        ov = {"scene_args": {"spheres": 2, "subdiv": 1},
              "render": {"width": 32, "height": 18, "pool_size": 1024,
                         "compact_tile": 256}}
    ov["preview"] = {"scale": 1, "depth": 4}
    if traffic["driver"] == "render":
        ov["traffic"] = {"spp": 3, "check": {"renders": 2, "pixels": 24}}
    elif traffic.get("turn"):
        ov["traffic"] = {"check": {"frame_pixels": 4,
                                   "radiance_pixels": 48}}
    else:
        ov["traffic"] = {"check": {"pixels": 24, "paths": 4096}}
    return ov


# The textured scenes with next-event estimation, as overrides on top of
# the tiny ones: the checker box with and without MIS, and the box with
# every kind of map.
NEE_TEX = {
    "nee_mis": {"scene_args": {"textured": True}, "render": {"nee": True}},
    "nee_no_mis": {"scene_args": {"textured": True},
                   "render": {"nee": True, "nee_mis": False}},
    "maps": {"scene": {"generator": "maps"}, "render": {"nee": True}},
}


def run(workload: str, seed: int = 2 ** 33 + 5, extra: dict | None = None,
        **kw) -> dict:
    """A tiny CPU run of ``workload``; ``extra`` updates its overrides
    key by key (``NEE_TEX``'s, say)."""
    from portbench import harness
    ov = overrides(workload)
    for k, v in (extra or {}).items():
        ov.setdefault(k, {}).update(v)
    return harness.run(workload, seed, kw.pop("seconds", 0.5), False,
                       device="cpu", overrides=ov, **kw)
