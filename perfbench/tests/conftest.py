"""The benchmark's own tests: ``python -m pytest -q perfbench/tests``.
The harness, the references and the program are imported from this
checkout; the tests marked ``requires_cuda`` skip without a card."""

import copy
import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

#: every cell of BENCHMARK.json, so that a cell added there is tested too
CELLS = tuple(w["name"] for w in
              json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"])


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def full_plan(cell):
    """The plan the program resolves for the cell at the cell's own sizes
    (weights on the CPU, no batch made, no step taken)."""
    import torch
    from harness import spec
    from harness.program import Job
    arch = cell.cfg["arch"]
    p0 = spec.reference(arch).init_params(
        cell.cfg, torch.Generator().manual_seed(0), "cpu")
    return Job(spec.program(arch), cell.cfg, cell.traffic, p0).plan


def cut(cell, factor=16, batch=2):
    """The cell at its 224x224 geometry with every width divided by
    ``factor`` and ``batch`` images a step: a size a CPU test holds.  A
    request that leaves the engine to the planner is pinned to what it
    picks at the cell's own sizes, so that the cut cell runs the engine the
    card runs."""
    cell = copy.copy(cell)
    traffic = copy.deepcopy(cell.traffic)
    if not traffic["plan"].get("engine") or not traffic["plan"].get("n_rows"):
        plan = full_plan(cell)
        traffic["plan"].update(engine=plan.engine, n_rows=plan.n_rows)
    cfg = copy.deepcopy(cell.cfg)
    cfg["stages"] = [[c // factor, n] for c, n in cfg["stages"]]
    if "stem" in cfg:
        cfg["stem"]["cout"] //= factor
    traffic["batch"] = batch
    cell.cfg, cell.traffic = cfg, traffic
    return cell


@pytest.fixture
def cuda():
    """The card, whose cached blocks go back to it after the test: a run
    started in a child process needs the whole card, as on its own."""
    import gc
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    yield torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
