"""BENCHMARK.json against the rules its check holds it to: keys, names,
lengths, files, which cells report which metric, and the time a full
check of 24 cells takes."""

import json
import os
import re

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_shape_and_names():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    # 2 + 14 runs a cell, run + 60 s each, 180 s a cell to compile,
    # 1200 s spare, with 24 cells.
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert all(_line(w) for w in b["command"]) and len(b["command"]) <= 32
    for p in b["paths"]:
        assert os.path.isdir(os.path.join(ROOT, p))
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 65536


def test_configs_and_cells():
    b = _bench()
    cfgs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/")
        data = json.load(open(os.path.join(ROOT, c["file"])))
        assert data["reduced"] == c["reduced"]
    used = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in cfgs and w["chips"] == 1 and _line(w["why"])
        used.add(w["config"])
        for sub, ext in (("traffic", w["traffic"]), ("limits", w["name"])):
            assert os.path.exists(os.path.join(HERE, sub, ext + ".json"))
    assert used == cfgs
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_metrics_reported_per_cell():
    b = _bench()
    cells = [w["name"] for w in b["workloads"]]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
        assert m["better"] in ("lower", "higher")
    reports = {c: {n for n, m in e2e.items()
                   if c in m.get("workloads", cells)} for c in cells}
    layers = {}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and _line(m["layer"])
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for c in m.get("workloads", cells):
            assert m["moves"] in reports[c], (m["name"], c)
            layers.setdefault(c, []).append(m["name"])
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"
    for c in cells:
        assert "setup_s" in reports[c] and len(reports[c]) >= 2
        assert layers.get(c)
