"""The port's plan audit against the JAX package's.

``repro.analysis.audit`` imports nothing of ``repro.exec``, so its
grouping, table, gate and CLI are compared in this process over the same
records.  ``repro.obs.audit.plan_audit`` takes a ``repro.exec`` plan, which
cannot be imported where ``jax.sharding`` lacks ``TransferToMemoryKind``:
one child process installs a stand-in for it and builds the reference's
records.  Records, tables and exit codes must be equal.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro.analysis import audit as ref_audit
from repro_torch import obs
from repro_torch.analysis import audit
from repro_torch.exec.plan import REFERENCE_NAMES, ExecutionPlan
from repro_torch.obs.audit import live_bytes, plan_audit

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: plans as reference JSON (``ExecutionPlan.to_dict``), each with its
#: measured peak, source and the est_bytes override (None: the plan's)
AUDIT_CASES = [
    ({"engine": "base", "n_rows": 1, "in_shape": [224, 224, 3],
      "batch": 32, "est_bytes": 3840690040,
      "est_bytes_per_device": 3840690040},
     5118742528, "train_step", None),
    ({"engine": "twophase_h", "n_rows": 8, "in_shape": [224, 224, 3],
      "batch": 32, "est_bytes": 1087145848,
      "est_bytes_per_device": 1087145848,
      "residency": {"default": "host", "prefetch_depth": 1,
                    "placements": []}},
     1370482176, "train_step", None),
    ({"engine": "twophase_h", "n_rows": 3, "in_shape": [64, 64, 3],
      "batch": 2, "est_bytes": 3500000, "est_bytes_per_device": 3500000,
      "residency": {"default": "recompute", "prefetch_depth": 2,
                    "placements": [["sd_l1", "host"]]}},
     4200000, "train_step", None),
    ({"engine": "overlap_pallas", "n_rows": 4, "in_shape": [224, 224, 3],
      "batch": 32, "est_bytes": 2812569464, "est_bytes_per_device": 0},
     4295189504, "train_step", None),
    ({"engine": "seq_swa_pallas", "n_rows": 8, "batch": 1,
      "est_bytes": 83886080, "est_bytes_per_device": 83886080,
      "extras": {"seq": 4096, "window": 1024}},
     30000000000, "train_step_lm", 29000000000),
    ({"engine": "base", "n_rows": 1, "batch": 2, "est_bytes": 0,
      "est_bytes_per_device": 0},
     1000, "dryrun", None),
]

CHILD_XLA_FLAGS = ("--xla_cpu_multi_thread_eigen=false "
                   "intra_op_parallelism_threads=1")

AUDIT_CHILD = r'''
import json, sys
import jax, jax.memory, jax.sharding
if not hasattr(jax.sharding, "TransferToMemoryKind"):
    # JAX 0.9 dropped the name repro.exec.rowprog imports; this process only
    jax.sharding.TransferToMemoryKind = lambda kind: (
        jax.memory.Space.Host if "host" in kind else jax.memory.Space.Device)
from repro import obs
from repro.exec.plan import ExecutionPlan
from repro.obs.audit import plan_audit

cases = json.load(open(sys.argv[1]))
out = []
for plan_d, peak, source, est in cases:
    plan = ExecutionPlan.from_dict(dict(plan_d))
    with obs.capture() as s:
        rec = plan_audit(plan, {"peak_bytes": peak, "method": "m"}, source,
                         extra={"arch": "a", "batch": plan.batch},
                         est_bytes=est)
    out.append({"rec": rec, "records": s.tracer.records[1:],
                "metrics": s.metrics.to_dict()})
json.dump(out, open(sys.argv[2], "w"))
'''


def _port_names(x):
    """The reference's backend/engine names as the port spells them."""
    if isinstance(x, str):
        return REFERENCE_NAMES.get(x, x)
    if isinstance(x, dict):
        return {k: _port_names(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_port_names(v) for v in x]
    return x


@pytest.fixture(scope="module")
def ref_audits(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_audit")
    (d / "cases.json").write_text(json.dumps(AUDIT_CASES))
    r = subprocess.run(
        [sys.executable, "-c", AUDIT_CHILD, str(d / "cases.json"),
         str(d / "out.json")], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 JAX_PLATFORMS="cpu", XLA_FLAGS=CHILD_XLA_FLAGS),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads((d / "out.json").read_text())


@pytest.mark.parametrize("i", range(len(AUDIT_CASES)))
def test_plan_audit_equals_reference(ref_audits, i):
    plan_d, peak, source, est = AUDIT_CASES[i]
    plan = ExecutionPlan.from_dict(dict(plan_d))
    with obs.capture() as s:
        rec = plan_audit(plan, {"peak_bytes": peak, "method": "m"}, source,
                         extra={"arch": "a", "batch": plan.batch},
                         est_bytes=est)
    want = _port_names(ref_audits[i])
    assert rec == want["rec"]
    assert s.tracer.records[1:] == want["records"]
    assert s.metrics.to_dict() == want["metrics"]


def test_plan_audit_without_session_returns_the_record():
    plan = ExecutionPlan.from_dict(dict(AUDIT_CASES[0][0]))
    rec = plan_audit(plan, {"peak_bytes": 10}, "train_step")
    assert rec["ratio"] == 10 / 3840690040 and rec["residency"] == "device"


def test_live_bytes_counts_every_tensor():
    tree = {"a": torch.zeros(3, 4), "b": [torch.zeros(2, dtype=torch.int64),
                                          (torch.zeros(5, dtype=torch.bfloat16),
                                           )], "c": 1}
    assert live_bytes(tree) == 48 + 16 + 10
    assert live_bytes([]) == 0


def _records():
    """Audit records as the trainers write them: two VGG groups in band, a
    drifting one, an LM one, a record-only dry run, and one with no
    ratio."""
    def rec(source, engine, n, residency, peak, est, kind=""):
        return {"source": source, "engine": engine, "n_rows": n,
                "residency": residency, "cache_kind": kind,
                "est_bytes_per_device": est,
                "measured": {"peak_bytes": peak,
                             "method": "cuda_max_allocated"},
                "ratio": peak / est if est else None}
    return [
        rec("train_step", "base", 1, "device", 5118742528, 3840690040),
        rec("train_step", "base", 1, "device", 5218742528, 3840690040),
        rec("train_step", "twophase_h", 8, "host,prefetch=1", 1370482176,
            1087145848),
        rec("train_step", "overlap_h", 8, "device", 4500000000, 1000000000),
        rec("train_step_lm", "seq_swa_cuda", 8, "device", 3e10, 2.9e10),
        rec("dryrun", "base", 1, "device", 100, 1),
        rec("train_step", "ckp", 1, "device", 100, 0),
        {"source": "elsewhere", "ratio": 1.0},
    ]


def _write_inputs(tmp_path, records):
    """A trace JSONL holding the records and a train_log envelope holding
    the last one."""
    from repro_torch.obs.trace import Tracer
    tr = Tracer(str(tmp_path / "t.jsonl"), meta={"tool": "train"})
    for r in records[:-1]:
        tr.emit("plan_audit", r.get("source", ""), **r)
        tr.span("fp_row", tick=0)
    tr.close()
    (tmp_path / "train_log.json").write_text(json.dumps(
        {"schema": 1, "steps": [], "plan_audit": records[-1]}))
    (tmp_path / "no_audit.json").write_text(json.dumps(
        {"schema": 1, "steps": [], "plan_audit": None}))
    return [str(tmp_path / "t.jsonl"), str(tmp_path / "train_log.json"),
            str(tmp_path / "no_audit.json")]


def test_load_summarize_table_check_equal_reference(tmp_path):
    records = _records()
    paths = _write_inputs(tmp_path, records[:-2] + [records[-2]])
    loaded = audit.load_records(paths)
    assert loaded == ref_audit.load_records(paths)
    assert len(loaded) == 7
    rows = audit.summarize(loaded)
    assert rows == ref_audit.summarize(loaded)
    assert [audit.group_key(r) for r in loaded] \
        == [ref_audit.group_key(r) for r in loaded]
    assert audit.audit_table(rows) == ref_audit.audit_table(rows)
    problems = audit.check(rows)
    assert problems == ref_audit.check(rows)
    assert len(problems) == 1 and "overlap_h" in problems[0]
    base = [r for r in rows if r["engine"] == "base"
            and r["source"] == "train_step"][0]
    assert base["count"] == 2 and base["ratio_min"] < base["ratio_max"]
    assert audit.TOLERANCES == ref_audit.TOLERANCES
    for b in (None, 0, 1000, 3 * 2**30, 2**50):
        from repro.analysis.report import fmt_bytes
        assert audit.fmt_bytes(b) == fmt_bytes(b)


def _cli(mod, argv, capsys):
    old = sys.argv
    sys.argv = ["audit"] + argv
    try:
        mod.main()
        code = 0
    except SystemExit as e:
        code = e.code
    finally:
        sys.argv = old
    return code, capsys.readouterr().out


@pytest.mark.parametrize("which,check,want", [
    ("all", True, 1),        # one group drifts
    ("all", False, 0),       # report only
    ("in_band", True, 0),    # audit OK
    ("ungated", True, 1),    # nothing gated to check
])
def test_cli_exit_codes_equal_reference(tmp_path, capsys, which, check,
                                        want):
    records = _records()
    chosen = {"all": records,
              "in_band": [r for r in records
                          if r.get("engine") != "overlap_h"],
              "ungated": [r for r in records
                          if r.get("source") in ("dryrun", "elsewhere")]
              }[which]
    paths = _write_inputs(tmp_path, chosen)
    argv = paths + (["--check"] if check else [])
    got = _cli(audit, argv, capsys)
    assert got == _cli(ref_audit, argv, capsys)
    assert got[0] == want
    if which == "in_band" and check:
        assert "audit OK" in got[1]


def test_cli_runs_as_a_module(tmp_path):
    paths = _write_inputs(tmp_path, [r for r in _records()
                                     if r.get("engine") != "overlap_h"])
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis.audit",
                        "--check", *paths], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "audit OK: 3 gated groups within tolerance" in r.stdout


def test_cli_seeds_a_cost_table(tmp_path, capsys):
    from repro_torch.exec.costmodel import CostTable
    paths = _write_inputs(tmp_path, _records())
    out = tmp_path / "cost_table.json"
    code, text = _cli(audit, paths + ["--cost-table-out", str(out)], capsys)
    assert code == 0 and "cost table:" in text
    table = CostTable.load(str(out))
    assert table.sources == ("audit",)
    assert table.ratio("train_step/base/device/-") \
        == round(5218742528 / 3840690040, 6)
