"""Each traffic driver drives the port on a tiny configuration on the
CPU through the harness's internal entry, and the check finds the
program correct; with the timed path broken underneath (a frozen step,
half the batch left out, a presented frame altered), or the bfloat16
reference in the program's place (the control), it does not.  One card
has no exchange between chips to leave out."""

import pytest

from portbench import harness
from portbench.tests import tiny

CELLS = ["box_1080p.converge", "outside_1080p.render",
         "box_1080p.navigate", "box_1080p.render"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    res = tiny.run(workload)
    assert res["correct"], res["checks"]
    assert res["checks"]["radiance_bad"]["value"] == 0.0
    assert res["checks"]["frame_bad"]["value"] == 0.0
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) >= {"setup_s"}
    assert not harness.forbidden_modules()


@pytest.mark.parametrize("fault", ["frozen", "half", "altered"])
@pytest.mark.parametrize("workload", ["box_1080p.converge",
                                      "box_1080p.navigate",
                                      "box_1080p.render"])
def test_fault_is_caught(workload, fault):
    res = tiny.run(workload, fault=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    res = tiny.run(workload, control=True)
    assert not res["correct"], res["checks"]


def test_same_seed_same_inputs():
    """The seed fixes the checked pixels and the host seeds: two runs
    of one seed agree on every count the window does not set."""
    a = tiny.run("box_1080p.navigate", seed=7, seconds=0.2)
    b = tiny.run("box_1080p.navigate", seed=7, seconds=0.2)
    assert a["checks"] == b["checks"]


@pytest.mark.parametrize("workload,variant", [
    ("box_1080p.render", "nee_mis"), ("box_1080p.render", "nee_no_mis"),
    ("box_1080p.render", "maps"), ("box_1080p.converge", "nee_mis"),
    ("box_1080p.converge", "maps"), ("box_1080p.navigate", "maps")])
def test_textured_nee_run_is_correct(workload, variant):
    """Textures and NEE through the whole harness: the reference's taps,
    light samples and shadow rays agree with the program's."""
    res = tiny.run(workload, extra=tiny.NEE_TEX[variant])
    assert res["correct"], res["checks"]
    assert res["checks"]["radiance_bad"]["value"] == 0.0
    assert res["checks"]["frame_bad"]["value"] == 0.0


@pytest.mark.parametrize("workload", ["box_1080p.render",
                                      "box_1080p.converge"])
def test_textured_nee_control_is_not_correct(workload):
    res = tiny.run(workload, extra=tiny.NEE_TEX["nee_mis"], control=True)
    assert not res["correct"], res["checks"]
