"""Finds what belongs to a cell by the names in ``BENCHMARK.json``:

* ``configs`` entry -> its ``file`` (sizes and optimizer), with the plain
  reference ``perfbench/reference/<arch>.py`` and the program's adapter
  ``perfbench/programs/<arch>.py``;
* ``workloads`` entry -> ``perfbench/traffic/<traffic>.json`` (batch, pool
  and plan request) and ``perfbench/workloads/<name>.json`` (the limits of
  the comparison);
* each metric -> ``perfbench/metrics/<name>.py``, whose ``read(run)``
  returns the value or None when the run holds nothing to read.  ``run``
  holds the cell, the program's ``plan``, ``setup_s``, the ``window``'s
  readings and the traced run's ``profile``; a reader derives what else it
  needs from those (the program's ``obs`` counters stay readable in the
  process).

A later cell, configuration or metric is added as files and entries; no
code here names one."""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[2]


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    name = "perfbench_" + "_".join(path.parts[-3:]).replace(".", "_")
    name = name.replace("/", "_")
    if name in sys.modules and sys.modules[name].__file__ == str(path):
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reference(arch: str):
    return importlib.import_module(f"reference.{arch}")


def program(arch: str):
    return importlib.import_module(f"programs.{arch}")


def metric(name: str, root: Path = ROOT):
    return load_module(root / "perfbench" / "metrics" / f"{name}.py")


def _for_cell(metrics, name, reported=None):
    """The metrics a cell reports: those listing it, and those with no list
    whose ``moves`` metric the cell reports (end-to-end ones with no list
    are reported everywhere)."""
    out = []
    for m in metrics:
        if "workloads" in m:
            if name in m["workloads"]:
                out.append(m)
        elif reported is None or m["moves"] in reported:
            out.append(m)
    return out


def cell(name: str, root: Path = ROOT):
    """Everything a run of the cell ``name`` needs, from the checkout at
    ``root``."""
    b = load_json(root / "BENCHMARK.json")
    entry = next((w for w in b["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: "
                         f"{[w['name'] for w in b['workloads']]}")
    conf = next(c for c in b["configs"] if c["name"] == entry["config"])
    end_to_end = _for_cell(b["end_to_end"], name)
    bench = root / "perfbench"
    return SimpleNamespace(
        name=name, chips=entry["chips"], root=root,
        cfg=load_json(root / conf["file"]),
        traffic=load_json(bench / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(bench / "workloads" / f"{name}.json")["limits"],
        end_to_end=end_to_end,
        per_layer=_for_cell(b["per_layer"], name,
                            {m["name"] for m in end_to_end}),
        run_seconds=b["run_seconds"])
