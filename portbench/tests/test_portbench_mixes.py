"""Each cell's mix runs at a small size on CPU tensors and agrees with the
plain reference; the control (the reference in bfloat16 in the program's
place) fails the cell's limits; and a run with the timed path broken
underneath comes out not correct, for each fault the cell can have."""

import pytest
import torch
from conftest import small

from portbench import calibrate, harness

SPEC = harness.load_spec()
CELLS = [w for w in SPEC["workloads"]]
FAULT_CASES = [(w["name"], f) for w in CELLS for f in calibrate.FAULTS[w["traffic"]]]


def _run(cell, **kw):
    return harness.run_cell(cell["name"], 2**31 + 11, 0.05, 0, device="cpu",
                            overrides=small(cell), spec=SPEC, log=lambda m: None, **kw)


@pytest.mark.parametrize("cell", CELLS, ids=lambda w: w["name"])
def test_mix_agrees_with_the_reference_on_cpu(cell):
    r = _run(cell)
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert r["correct"], r["compared"]
    assert set(r["metrics"]) == {m["name"] for m in harness.metrics_of(SPEC, cell["name"], "end_to_end")}


@pytest.mark.parametrize("cell", CELLS, ids=lambda w: w["name"])
def test_control_fails_the_limits(cell):
    (sound, control) = calibrate.readings(cell["name"], 2**31 + 13, 1, "cpu",
                                          ["sound", "control"], small(cell))
    limits = harness.limits_of(cell["name"])
    assert harness.judge(sound["numbers"], limits)[0], sound
    assert not harness.judge(control["numbers"], limits)[0], control


@pytest.mark.parametrize("cell_name,fault", FAULT_CASES)
def test_a_broken_timed_path_is_not_correct(cell_name, fault):
    cell = harness.cell_of(SPEC, cell_name)
    r = _run(cell, fault=fault)
    assert not r["correct"], r["compared"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS, ids=lambda w: w["name"])
def test_cell_runs_correct_on_the_card_at_a_small_size(cell, card):
    r = harness.run_cell(cell["name"], 2**31 + 17, 0.5, 1, device=card,
                         overrides=small(cell), spec=SPEC, log=lambda m: None)
    assert r["correct"], r["compared"]
    assert r["device"]["busy_s"] > 0
    torch.cuda.empty_cache()
