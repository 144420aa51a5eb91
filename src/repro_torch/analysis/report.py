"""Render the dry-run, roofline and skips tables from the port's dry-run
records (counterpart of ``repro.analysis.report``).

PYTHONPATH=src python -m repro_torch.analysis.report \
    --dir experiments/dryrun_torch

The dry-run table names what was traced: rank 0's peak bytes (arguments
and temporaries) and its share of the card's 80 GB, its FLOPs beside the
analytic model's, its collective bytes, and the trace's wall time.  The
roofline table's analytic columns are the reference's, on the H100's
constants; beside them the ratio of the traced FLOPs to the analytic ones
and the bottleneck the traced counts give.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List

from repro_torch.analysis.audit import fmt_bytes
from repro_torch.launch.mesh import HBM_BYTES

__all__ = ["load", "fmt_bytes", "fmt_s", "dryrun_table", "roofline_table",
           "skips_table"]


def load(dir_: str) -> List[dict]:
    out = []
    for p in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(p) as f:
            out.append(json.load(f))
    return out


def fmt_s(x) -> str:
    if x is None:
        return "-"
    x = float(x)
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.1f}us"


def dryrun_table(recs: List[dict], mesh: str) -> str:
    lines = [
        "| arch | shape | status | traced peak/rank (args+temp) "
        "| of 80 GB | traced flops/rank | analytic flops/rank "
        "| traced coll bytes/rank | trace |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["mesh"] != mesh:
            continue
        if r["status"] != "ok":
            status = "SKIP (documented)" if r["status"] == "skipped" \
                else r["status"]
            lines.append(f"| {r['arch']} | {r['shape']} | {status} "
                         f"| — | — | — | — | — | — |")
            continue
        peak = float(r.get("traced_peak_bytes_per_chip", 0))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['status']} "
            f"| {fmt_bytes(peak)} | {peak / HBM_BYTES:.1%} "
            f"| {float(r.get('traced_flops_per_chip', 0)):.2e} "
            f"| {float(r['analytic']['flops_per_chip']):.2e} "
            f"| {fmt_bytes(r.get('traced_coll_bytes_per_chip'))} "
            f"| {r.get('t_trace_s', 0)}s |")
    return "\n".join(lines)


def roofline_table(recs: List[dict], mesh: str = "16x16") -> str:
    lines = [
        "| arch | shape | t_compute | t_memory | t_collective | bottleneck "
        "| MODEL_FLOPS/analytic | traced/analytic flops "
        "| traced bottleneck | note |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["mesh"] != mesh or r["status"] != "ok":
            continue
        a = r["analytic"]
        mf = float(r.get("traced_model_flops_global", 0))
        af = float(a["flops_per_chip"]) * r["n_chips"]
        ratio = mf / af if af else 0
        tf = float(r.get("traced_flops_per_chip", 0))
        traced = tf / float(a["flops_per_chip"]) \
            if a["flops_per_chip"] else 0
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(a['t_compute_s'])} "
            f"| {fmt_s(a['t_memory_s'])} | {fmt_s(a['t_collective_s'])} "
            f"| **{a['bottleneck']}** | {ratio:.2f} | {traced:.2f} "
            f"| {r.get('traced_bottleneck', '-')} | {_note(r)} |")
    return "\n".join(lines)


def _note(r) -> str:
    a = r["analytic"]
    bn = a["bottleneck"]
    if bn == "compute":
        return "raise arithmetic intensity (bigger per-chip tiles) or shrink remat"
    if bn == "memory":
        return "weights/KV streaming bound: quantise cache, batch more tokens/step"
    return "shrink TP traffic: overlap psum with compute, FSDP+seq-parallel"


def skips_table(recs: List[dict]) -> str:
    lines = ["| arch | shape | reason |", "|---|---|---|"]
    seen = set()
    for r in recs:
        if r["status"] != "skipped":
            continue
        key = (r["arch"], r["shape"])
        if key in seen:
            continue
        seen.add(key)
        lines.append(f"| {r['arch']} | {r['shape']} | {r['reason'][:100]} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    n_ok = sum(r["status"] == "ok" for r in recs)
    n_skip = sum(r["status"] == "skipped" for r in recs)
    print(f"## Dry-run summary: {n_ok} ok, {n_skip} documented skips, "
          f"{sum(r['status'] == 'error' for r in recs)} errors\n")
    for mesh in ("16x16", "2x16x16"):
        print(f"### Dry-run mesh {mesh} (traced, rank 0)\n")
        print(dryrun_table(recs, mesh))
        print()
    print("### Documented skips\n")
    print(skips_table(recs))
    print()
    print("### Roofline (single-pod 16x16, analytic primary, H100)\n")
    print(roofline_table(recs))


if __name__ == "__main__":
    main()
