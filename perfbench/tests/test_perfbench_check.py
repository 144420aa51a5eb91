"""The comparison that decides ``correct``, on the CPU at each cell's
224x224 geometry with widths cut 16-fold and 2 images a step: the
program's run agrees with the reference, and the same comparison fails a
reference a precision lower (bf16; the card's control is TF32) and a run
with the timed path broken underneath."""

import time

import pytest
from conftest import CELLS, cut

from harness import check, runner, spec
from harness.faults import FAULTS

SEED = 2**31 + 12345


def _run(name, faults=(), traced=False):
    cell = cut(spec.cell(name))
    return runner.run(cell, SEED, 0.2, traced, "cpu", time.time(),
                      faults=faults)


@pytest.mark.parametrize("name", CELLS)
def test_cell_agrees_with_the_reference(name):
    out = _run(name)
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-2:] == ["check", "_check_lines"]
    assert set(out["metrics"]) == {m["name"] for m in
                                   spec.cell(name).end_to_end} - {
        "peak_mem_gib"}


@pytest.mark.parametrize("name", CELLS)
def test_bf16_control_fails(name):
    cell = cut(spec.cell(name))
    _, batches = runner.inputs(cell, SEED, "cpu")
    ref = runner.reference(cell, SEED, batches, "cpu")
    low = runner.reference(cell, SEED, batches, "cpu", low="bf16")
    values, _ = check.gaps(low, ref)
    assert not check.verdict(values, cell.limits), values


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_step_is_not_correct(name, fault):
    out = _run(name, faults=(FAULTS[fault],))
    assert not out["correct"], out["check"]


def test_traced_window_times_each_phase_on_the_host():
    out = _run(CELLS[0], traced=True)
    assert out["correct"]
    names = {m["name"] for m in spec.cell(CELLS[0]).per_layer}
    # the profiler's readings need the card; the rest are read here
    assert {"forward_ms", "backward_ms", "host_ms_per_step",
            "mfu"} <= set(out["metrics"]) <= names


def test_gaps_by_worst_leaf():
    ref = {"loss": [2.0, 2.0, 2.0],
           "grad": {"a": 1.0, "b": 2.0, "c": 1e-6},
           "update": {"a": 0.1, "b": 0.2, "c": 0.5}}
    prog = {"loss": [2.0, 2.002, 2.0],
            "grad": {"a": 1.1, "b": 2.0, "c": 0.0},
            "update": {"a": 0.1, "b": 0.2, "c": 9.0}}
    values, where = check.gaps(prog, ref)
    assert values["loss_step1"] == 0.0
    assert values["loss_later"] == pytest.approx(1e-3)
    assert where["loss_later"] == "step 2"
    # leaf a: |1.1 - 1| / max(1, median 1)
    assert values["grad"] == pytest.approx(0.1) and where["grad"] == "a"
    # leaf c moves by weight decay alone: left out of the update
    assert values["update"] == 0.0 and "1 leaves left out" in where["update"]
    prog["loss"][2] = float("nan")
    values, _ = check.gaps(prog, ref)
    assert not check.verdict(values, {"loss_later": 1.0})
