"""Every configuration, cell and metric of BENCHMARK.json loads by name,
and a cell added as files and entries is found with no code edit."""

import json
import shutil

import pytest
from conftest import BENCH, ROOT, full_plan

from harness import spec

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in BENCHMARK["workloads"]])
def test_cell_loads(name):
    cell = spec.cell(name)
    assert cell.cfg["name"] == next(w["config"] for w in
                                    BENCHMARK["workloads"]
                                    if w["name"] == name)
    # loss_later may go uncompared where it does not part the control
    assert {"loss_step1", "grad", "update"} <= set(cell.limits) <= {
        "loss_step1", "loss_later", "grad", "update"}
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert cell.per_layer
    assert spec.reference(cell.cfg["arch"]).flops_per_image(cell.cfg) > 0
    assert spec.program(cell.cfg["arch"]).modules(cell.cfg)


@pytest.mark.parametrize("m", BENCHMARK["end_to_end"] + BENCHMARK["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_loads(m):
    assert callable(spec.metric(m["name"]).read)


def test_config_files_hold_what_benchmark_names():
    for c in BENCHMARK["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) == set(cfg["reduced"])


def test_added_cell_found_without_code(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "vgg16.b32.overlap2", "config": "vgg16",
                           "traffic": "b32.overlap2", "chips": 1,
                           "why": "a cell added as data"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    (tmp_path / "perfbench" / "traffic" / "b32.overlap2.json").write_text(
        json.dumps({"batch": 32, "pool": 3,
                    "plan": {"engine": "overlap", "n_rows": 2}}))
    (tmp_path / "perfbench" / "workloads" / "vgg16.b32.overlap2.json"
     ).write_text(json.dumps({"limits": {"loss_step1": 1e-6, "grad": 1e-4,
                                         "update": 1e-4}}))
    cell = spec.cell("vgg16.b32.overlap2", root=tmp_path)
    assert cell.traffic["batch"] == 32 and cell.root == tmp_path
    assert [m["name"] for m in cell.per_layer] == [
        m["name"] for m in b["per_layer"] if "workloads" not in m]
    assert spec.metric("mfu", tmp_path).__file__.startswith(str(tmp_path))


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        spec.cell("no.such.cell")


@pytest.mark.parametrize("name", [w["name"] for w in BENCHMARK["workloads"]
                                  if not spec.cell(w["name"]).traffic[
                                      "plan"].get("engine")])
def test_budget_pass_plan_fits_its_budget(name):
    cell = spec.cell(name)
    plan = full_plan(cell)
    assert plan.feasible
    assert plan.est_bytes <= cell.traffic["plan"]["budget_gb"] * 2**30
