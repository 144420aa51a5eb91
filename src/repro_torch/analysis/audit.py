"""Estimate-error report over plan-audit records: is the Planner's byte
pricing still honest?  (Counterpart of ``repro.analysis.audit``; the same
grouping, table, tolerances and exit codes.)

Collects every ``plan_audit`` record the obs layer produced — from
``--trace`` JSONL files and from versioned ``train_log.json`` envelopes
(or any artefact JSON with a ``plan_audit`` key) — groups them by the axes
the pricing formulae branch on (``engine``, ``n_rows``, ``residency``,
``cache_kind``), and reports measured/estimated peak-byte ratios.
``--check`` turns the report into a gate: exit 1 when any group's ratio
leaves its source's tolerance band, or when no gated record was found.

  PYTHONPATH=src python -m repro_torch.analysis.audit /tmp/obs/*.jsonl \\
      /tmp/train/train_log.json --check

Tolerances are the reference's (``TOLERANCES``), measured there on XLA's
accounting: ``train_step`` [0.25, 4.0], ``train_step_lm`` [0.2, 20.0],
``serve_pool`` [0.95, 1.10], ``dryrun`` recorded only.  On the card the
measurement is ``torch.cuda.max_memory_allocated`` over one executed step
(:func:`repro_torch.obs.audit.measure_step`): the absolute peak of the
caching allocator, arguments included, against the plan's activation +
cache + ξ estimate — the same family of quantity, so the bands apply
unchanged.  A ratio outside its band is a pricing or holding fault to
find, not a band to widen.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Tuple


def fmt_bytes(b) -> str:
    """Human bytes (a copy of ``repro.analysis.report.fmt_bytes``)."""
    if b is None:
        return "-"
    b = float(b)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if b < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}TiB"


#: per-source [lo, hi] ratio bands; None = record-only, never gated
TOLERANCES: Dict[str, Optional[Tuple[float, float]]] = {
    "serve_pool": (0.95, 1.10),
    "train_step": (0.25, 4.0),
    "train_step_lm": (0.2, 20.0),
    "dryrun": None,
}


def _from_artefact(d: dict) -> List[dict]:
    """plan_audit records embedded in an artefact JSON (train_log
    envelope, serve artefact, dry-run record)."""
    a = d.get("plan_audit")
    return [a] if isinstance(a, dict) else []


def load_records(paths: List[str]) -> List[dict]:
    """Audit records from any mix of trace JSONLs and artefact JSONs."""
    out = []
    for path in paths:
        if path.endswith(".jsonl"):
            from repro_torch.obs.trace import read_jsonl
            out.extend(r.get("attrs", {}) for r in read_jsonl(path)
                       if r.get("kind") == "plan_audit")
        else:
            with open(path) as f:
                d = json.load(f)
            out.extend(_from_artefact(d))
    return [r for r in out if r.get("source") in TOLERANCES]


def group_key(rec: dict) -> Tuple[str, str, int, str, str]:
    return (rec.get("source", ""), rec.get("engine", ""),
            int(rec.get("n_rows", 0) or 0), rec.get("residency", ""),
            rec.get("cache_kind", "") or "")


def summarize(records: List[dict]) -> List[dict]:
    """One row per (source, engine, N, residency, cache_kind) group with
    the ratio range across its records."""
    groups: Dict[tuple, List[dict]] = {}
    for r in records:
        groups.setdefault(group_key(r), []).append(r)
    rows = []
    for key in sorted(groups):
        source, engine, n, residency, kind = key
        rs = groups[key]
        ratios = [r["ratio"] for r in rs if r.get("ratio") is not None]
        rows.append({
            "source": source, "engine": engine, "n_rows": n,
            "residency": residency, "cache_kind": kind,
            "count": len(rs),
            "est_bytes": int(rs[-1].get("est_bytes_per_device", 0) or 0),
            "measured_bytes": int(
                rs[-1].get("measured", {}).get("peak_bytes", 0) or 0),
            "ratio_min": min(ratios) if ratios else None,
            "ratio_max": max(ratios) if ratios else None,
            "tolerance": TOLERANCES.get(source),
        })
    return rows


def audit_table(rows: List[dict]) -> str:
    lines = [
        "| source | engine | N | residency | cache | est | measured "
        "| ratio | tolerance |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["ratio_min"] is None:
            ratio = "-"
        elif r["ratio_min"] == r["ratio_max"]:
            ratio = f"{r['ratio_min']:.3f}"
        else:
            ratio = f"{r['ratio_min']:.3f}-{r['ratio_max']:.3f}"
        tol = r["tolerance"]
        lines.append(
            f"| {r['source']} | {r['engine']} | {r['n_rows']} "
            f"| {r['residency']} | {r['cache_kind'] or '-'} "
            f"| {fmt_bytes(r['est_bytes'])} "
            f"| {fmt_bytes(r['measured_bytes'])} | {ratio} "
            f"| {f'[{tol[0]}, {tol[1]}]' if tol else 'record-only'} |")
    return "\n".join(lines)


def check(rows: List[dict]) -> List[str]:
    """Tolerance violations, one message per drifting group."""
    problems = []
    for r in rows:
        tol = r["tolerance"]
        if tol is None or r["ratio_min"] is None:
            continue
        lo, hi = tol
        if r["ratio_min"] < lo or r["ratio_max"] > hi:
            problems.append(
                f"{r['source']} engine={r['engine']} N={r['n_rows']} "
                f"residency={r['residency']} "
                f"cache={r['cache_kind'] or '-'}: ratio "
                f"[{r['ratio_min']:.3f}, {r['ratio_max']:.3f}] outside "
                f"[{lo}, {hi}] (est {fmt_bytes(r['est_bytes'])}, "
                f"measured {fmt_bytes(r['measured_bytes'])})")
    return problems


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("paths", nargs="+",
                    help="trace .jsonl files and/or artefact JSONs "
                         "(train_log.json, serve/dryrun artefacts)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 when any gated source's ratio leaves "
                         "its tolerance band")
    ap.add_argument("--cost-table-out", default="",
                    help="seed/update a CostTable at this path from the "
                         "loaded audit records: per-(source, engine, "
                         "residency, cache_kind) median measured/"
                         "estimated ratios fold into the table the "
                         "Planner's roofline chooser prices copies with")
    args = ap.parse_args()
    records = load_records(args.paths)
    rows = summarize(records)
    print(f"## Plan audit: {len(records)} records, {len(rows)} groups\n")
    print(audit_table(rows))
    if args.cost_table_out:
        import os

        from repro_torch.exec.costmodel import CostTable, hardware_fingerprint
        base = None
        if os.path.exists(args.cost_table_out):
            try:
                base = CostTable.load(args.cost_table_out)
            except (ValueError, KeyError, json.JSONDecodeError):
                base = None  # stale schema / corrupt: start fresh
        if base is None:
            base = CostTable(fingerprint=hardware_fingerprint())
        table = base.seed_from_audit(records)
        table.save(args.cost_table_out)
        print(f"\ncost table: {args.cost_table_out} "
              f"({len(table.ratios)} ratio groups, "
              f"version {table.version()})")
    problems = check(rows)
    if problems:
        print(f"\n{len(problems)} tolerance violations:")
        for p in problems:
            print(f"  DRIFT {p}")
        if args.check:
            raise SystemExit(1)
    elif args.check:
        gated = sum(1 for r in rows if r["tolerance"]
                    and r["ratio_min"] is not None)
        if not gated:
            print("\nno gated audit records found — nothing to check")
            raise SystemExit(1)
        print(f"\naudit OK: {gated} gated groups within tolerance")


if __name__ == "__main__":
    main()
