"""Measured-cost planning: calibrated primitive costs -> predicted step time
(counterpart of ``repro.exec.costmodel``; the same table, schema, version
hash and roofline).

* :class:`CostTable` — a serializable, schema-versioned table of primitive
  costs keyed by (hardware fingerprint, dtype): FLOP throughput, H2D/D2H
  copy bandwidth, and per-row dispatch overhead.  Two feeders:
  :meth:`CostTable.calibrate` microbenchmarks them live, and
  :meth:`CostTable.seed_from_audit` folds in plan-audit records
  (:mod:`repro_torch.analysis.audit`'s ``load_records`` output) as
  per-(source, engine, residency, cache_kind) measured/estimated ratios.
* a **roofline**: :meth:`CostTable.predict_step_us` prices a step as
  ``max(compute, copy) + per-row overhead`` — compute from the trunk's
  FLOP count (:func:`trunk_fwd_flops`), copy from the offloaded SD byte
  volume (``Planner.predict_plan_us`` assembles the per-engine terms).
* a **registry seam** (:func:`register_cost_table` /
  :func:`resolve_cost_table`): a pre-measured table for hardware the
  calibration cannot see.

Tables persist as ``cost_table.json`` (:func:`load_or_calibrate`), so a
plan cache can key entries on :meth:`CostTable.version` and go stale the
moment the measurements underneath a cached decision change.

On the card :meth:`CostTable.calibrate` times an fp32 matmul with TF32
off (as the trainers run), copies from and to pinned host memory, and a
tiny elementwise op for the per-row dispatch, each between CUDA events.
Its default sizes are larger there than the reference's (a 256² matmul or
a 4 MiB copy measures launch latency on an H100, not throughput); on the
CPU they are the reference's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

#: schema of the serialized table (the reference's)
COST_SCHEMA = 1
#: filename load_or_calibrate persists under its directory argument
COST_TABLE_FILENAME = "cost_table.json"
#: (matmul_dim, copy_bytes) calibrate uses by default, per device type
CALIBRATE_SIZES = {"cuda": (4096, 256 * 2**20), "cpu": (256, 4 * 2**20)}


def _resolve_device(device=None) -> torch.device:
    """``device``, else the card when there is one, else the CPU."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def hardware_fingerprint(device=None) -> str:
    """Stable id of the hardware a measurement on ``device`` (default: the
    card when there is one) belongs to, in the reference's
    ``backend:device_kind:xN`` shape: ``cuda:<device name, spaces as
    _>:x<device count>`` on the card, ``cpu:cpu:x1`` on the CPU.  Plans
    cached under one fingerprint never replay measurements from
    another."""
    if _resolve_device(device).type == "cuda":
        kind = torch.cuda.get_device_name(0).replace(" ", "_")
        return f"cuda:{kind}:x{torch.cuda.device_count()}"
    return "cpu:cpu:x1"


@dataclasses.dataclass(frozen=True)
class CostTable:
    """Calibrated primitive costs for one (hardware, dtype) pair.

    ``ratios`` carries audit-seeded measured/estimated corrections keyed
    ``"source/engine/residency/cache_kind"`` — the byte-honesty of the
    pricing formula that produced each group — which the roofline applies
    to the copy-byte term for the matching engine/residency.
    """

    fingerprint: str
    dtype: str = "float32"
    flops_per_s: float = 0.0
    h2d_bytes_per_s: float = 0.0
    d2h_bytes_per_s: float = 0.0
    row_overhead_us: float = 0.0
    ratios: Tuple[Tuple[str, float], ...] = ()
    sources: Tuple[str, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "ratios", tuple(sorted(self.ratios)))
        object.__setattr__(self, "sources", tuple(self.sources))

    # -- identity ------------------------------------------------------
    def version(self) -> str:
        """Short content hash of the canonical table — the staleness key
        a plan cache compares against."""
        blob = json.dumps(self.to_dict(), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:12]

    # -- serialization -------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "schema": COST_SCHEMA,
            "fingerprint": self.fingerprint,
            "dtype": self.dtype,
            "flops_per_s": self.flops_per_s,
            "h2d_bytes_per_s": self.h2d_bytes_per_s,
            "d2h_bytes_per_s": self.d2h_bytes_per_s,
            "row_overhead_us": self.row_overhead_us,
            "ratios": [list(r) for r in self.ratios],
            "sources": list(self.sources),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CostTable":
        if d.get("schema") != COST_SCHEMA:
            raise ValueError(
                f"cost table schema {d.get('schema')!r} != {COST_SCHEMA}; "
                f"recalibrate instead of guessing at an old layout")
        return cls(fingerprint=d["fingerprint"], dtype=d.get("dtype",
                                                             "float32"),
                   flops_per_s=float(d.get("flops_per_s", 0.0)),
                   h2d_bytes_per_s=float(d.get("h2d_bytes_per_s", 0.0)),
                   d2h_bytes_per_s=float(d.get("d2h_bytes_per_s", 0.0)),
                   row_overhead_us=float(d.get("row_overhead_us", 0.0)),
                   ratios=tuple((k, float(v)) for k, v
                                in d.get("ratios", [])),
                   sources=tuple(d.get("sources", [])))

    def save(self, path: str) -> str:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "CostTable":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # -- audit seeding -------------------------------------------------
    def ratio(self, key: str, default: float = 1.0) -> float:
        return dict(self.ratios).get(key, default)

    def seed_from_audit(self, records: Sequence[dict]) -> "CostTable":
        """Fold plan-audit records (``load_records`` output, or raw
        ``plan_audit`` attr dicts) into per-group median measured/estimated
        ratios.  Returns a new table; existing groups are replaced by the
        fresher medians."""
        groups: Dict[str, List[float]] = {}
        for r in records:
            if r.get("ratio") is None:
                continue
            key = audit_ratio_key(r.get("source", ""), r.get("engine", ""),
                                  r.get("residency", ""),
                                  r.get("cache_kind", ""))
            groups.setdefault(key, []).append(float(r["ratio"]))
        merged = dict(self.ratios)
        for key, vals in groups.items():
            vals.sort()
            merged[key] = round(vals[len(vals) // 2], 6)
        sources = self.sources if "audit" in self.sources \
            else self.sources + ("audit",)
        return dataclasses.replace(self, ratios=tuple(merged.items()),
                                   sources=sources)

    # -- roofline ------------------------------------------------------
    def compute_us(self, flops: float) -> float:
        return flops / self.flops_per_s * 1e6 if self.flops_per_s else 0.0

    def copy_us(self, d2h_bytes: float, h2d_bytes: float) -> float:
        us = 0.0
        if d2h_bytes and self.d2h_bytes_per_s:
            us += d2h_bytes / self.d2h_bytes_per_s * 1e6
        if h2d_bytes and self.h2d_bytes_per_s:
            us += h2d_bytes / self.h2d_bytes_per_s * 1e6
        return us

    def predict_step_us(self, flops: float, d2h_bytes: float = 0.0,
                        h2d_bytes: float = 0.0, n_rows: int = 1,
                        key: str = "") -> float:
        """Roofline step time: compute and host copies overlap (the
        prefetch hides the round trip behind the adjacent row), so the
        step pays the max of the two plus per-row dispatch overhead.
        ``key`` applies an audit-seeded byte-honesty ratio to the copy
        term."""
        scale = self.ratio(key) if key else 1.0
        copy = self.copy_us(d2h_bytes * scale, h2d_bytes * scale)
        return max(self.compute_us(flops), copy) \
            + self.row_overhead_us * max(1, n_rows)

    # -- calibration ---------------------------------------------------
    @classmethod
    def calibrate(cls, dtype: str = "float32",
                  matmul_dim: Optional[int] = None,
                  copy_bytes: Optional[int] = None, iters: int = 3,
                  device=None) -> "CostTable":
        """Microbenchmark the primitive costs on ``device`` (the card when
        there is one): FLOP throughput from a matmul (TF32 off), H2D/D2H
        bandwidth from copies out of and into pinned host memory, per-row
        overhead from a tiny elementwise op.  Each figure is the median of
        ``iters`` timed calls after one warmup, every call synchronised
        (CUDA events on the card, the host clock on the CPU).  Sizes
        default per device type (:data:`CALIBRATE_SIZES`)."""
        dev = _resolve_device(device)
        cuda = dev.type == "cuda"
        dim0, bytes0 = CALIBRATE_SIZES["cuda" if cuda else "cpu"]
        n = matmul_dim or dim0
        copy_bytes = copy_bytes or bytes0
        tdtype = getattr(torch, dtype)

        def median_s(fn) -> float:
            fn()  # warmup (first launch / allocation)
            times = []
            for _ in range(max(1, iters)):
                if cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    fn()
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end) * 1e-3)
                else:
                    t0 = time.perf_counter()
                    fn()
                    times.append(time.perf_counter() - t0)
            times.sort()
            return max(times[len(times) // 2], 1e-9)

        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            a = torch.ones((n, n), dtype=tdtype, device=dev)
            t_mm = median_s(lambda: a @ a)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        del a
        itemsize = torch.empty((), dtype=tdtype).element_size()
        numel = max(1, copy_bytes // itemsize)
        host = torch.ones(numel, dtype=tdtype, pin_memory=cuda)
        on_dev = torch.empty(numel, dtype=tdtype, device=dev)
        back = torch.empty(numel, dtype=tdtype, pin_memory=cuda)
        t_h2d = median_s(lambda: on_dev.copy_(host, non_blocking=cuda))
        t_d2h = median_s(lambda: back.copy_(on_dev, non_blocking=cuda))
        nbytes = numel * itemsize
        del host, on_dev, back
        tiny = torch.ones(8, dtype=tdtype, device=dev)
        t_row = median_s(lambda: tiny + 1)
        return cls(fingerprint=hardware_fingerprint(dev), dtype=dtype,
                   flops_per_s=2.0 * n * n * n / t_mm,
                   h2d_bytes_per_s=nbytes / t_h2d,
                   d2h_bytes_per_s=nbytes / t_d2h,
                   row_overhead_us=t_row * 1e6,
                   sources=("calibrate",))


def audit_ratio_key(source: str, engine: str, residency: str,
                    cache_kind: str) -> str:
    """One ratio-group key shared by seeding and lookup — the same axes
    ``analysis.audit.group_key`` aggregates on, minus N."""
    return f"{source}/{engine}/{residency or 'device'}/{cache_kind or '-'}"


# ---------------------------------------------------------------------------
# trunk FLOP accounting (the compute side of the roofline)
# ---------------------------------------------------------------------------


def _module_fwd_flops(m, sin: Tuple[int, int, int],
                      sout: Tuple[int, int, int], batch: int) -> float:
    h_out, w_out, c_out = sout
    if hasattr(m, "fwd_flops"):  # a block that counts its own (ConvNeXt)
        return m.fwd_flops(sin, batch)
    if hasattr(m, "cout") and hasattr(m, "k") and hasattr(m, "init"):
        # Conv: 2*k*k*Cin/groups MACs per output element
        cin = sin[2] // getattr(m, "groups", 1)
        return 2.0 * m.k * m.k * cin * c_out * h_out * w_out * batch
    if hasattr(m, "cmid"):
        # Bottleneck: 1x1 reduce at input spatial, 3x3 at output spatial,
        # 1x1 expand (+ projection shortcut when present)
        h_in, w_in, c_in = sin
        f = 2.0 * c_in * m.cmid * h_in * w_in
        f += 2.0 * 9 * m.cmid * m.cmid * h_out * w_out
        f += 2.0 * m.cmid * c_out * h_out * w_out
        if getattr(m, "project", False):
            f += 2.0 * c_in * c_out * h_out * w_out
        return f * batch
    if hasattr(m, "k"):  # pooling: k*k comparisons per output element
        return float(m.k * m.k * h_out * w_out * c_out * batch)
    # elementwise (ReLU / BatchNorm / ...): ~1 flop per element
    return float(h_out * w_out * c_out * batch)


def trunk_fwd_flops(modules: Sequence, in_shape: Tuple[int, int, int],
                    batch: int) -> float:
    """Forward FLOPs of one pass over the trunk, from the shape chain —
    exact for Conv stacks, bottleneck-approximate for ResNet blocks."""
    from repro_torch.core.rowplan import shape_chain

    shapes = shape_chain(modules, in_shape)
    return sum(_module_fwd_flops(m, sin, sout, batch)
               for m, sin, sout in zip(modules, shapes, shapes[1:]))


# ---------------------------------------------------------------------------
# third-party table registry + persistence
# ---------------------------------------------------------------------------

_COST_TABLES: Dict[str, CostTable] = {}


def register_cost_table(table: CostTable,
                        fingerprint: Optional[str] = None) -> CostTable:
    """Supply a pre-measured :class:`CostTable` for a hardware
    fingerprint — resolved before calibration."""
    _COST_TABLES[fingerprint or table.fingerprint] = table
    return table


def resolve_cost_table(fingerprint: Optional[str] = None
                       ) -> Optional[CostTable]:
    """Registered table for ``fingerprint`` (default: this host), or
    None."""
    return _COST_TABLES.get(fingerprint or hardware_fingerprint())


def load_or_calibrate(dir_path: str, dtype: str = "float32",
                      device=None) -> CostTable:
    """The launch-time entry point for a run on ``device`` (default: the
    card when there is one): registered table for its hardware if one
    exists, else the persisted ``cost_table.json`` under ``dir_path`` when
    its fingerprint still matches, else calibrate on ``device`` and
    persist.  The second launch loads the first launch's measurements, so
    cached plans stay fresh."""
    fingerprint = hardware_fingerprint(device)
    registered = resolve_cost_table(fingerprint)
    if registered is not None:
        return registered
    path = os.path.join(dir_path, COST_TABLE_FILENAME)
    if os.path.exists(path):
        try:
            table = CostTable.load(path)
            if table.fingerprint == fingerprint:
                return table
        except (ValueError, KeyError, json.JSONDecodeError):
            pass  # stale schema / corrupt file: recalibrate below
    os.makedirs(dir_path, exist_ok=True)
    table = CostTable.calibrate(dtype=dtype, device=device)
    table.save(path)
    return table
