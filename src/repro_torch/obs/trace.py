"""Tick-denominated span tracer with a schema-versioned JSONL sink
(counterpart of ``repro.obs.trace``; the same record layout, byte for
byte).

Every record is one JSON object per line.  The first line of a trace
file is a ``header`` record pinning the schema version and the run
metadata (arch, engine, plan digest — whatever :func:`repro_torch.obs.configure`
was given); every subsequent line is one of

  ``span``        a named unit of work at a tick (fp_row / bp_row /
                  decode_cohort / train_step ...), with free-form attrs
  ``event``       a point occurrence (offload / prefetch / admit /
                  preempt / page_grow ...), same shape as a span
  ``plan_audit``  a measured-vs-estimated peak-bytes record (see
                  :mod:`repro_torch.obs.audit`)

"Tick" is whatever clock the emitting layer is denominated in — the row
index inside the row-program executor, the scheduler tick in serve, the
optimiser step in train.  Wall-clock timestamps are deliberately *not*
part of the schema: the repo's executors are deterministic in ticks, so
two runs of the same config produce byte-identical traces, which is what
lets CI diff them.

The in-memory ``records`` list is always kept (tests and
``ServeReport.timeline()`` read it); the JSONL file is written only when
a path is given.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

#: version of the trace-record layout (bump on breaking change)
TRACE_SCHEMA = 1


class Tracer:
    """Structured-record sink: in-memory list + optional JSONL file."""

    def __init__(self, path: Optional[str] = None, meta: Optional[dict] = None):
        self.path = path
        self.records: List[dict] = []
        if path and os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        self._fh = open(path, "w") if path else None
        header = {"schema": TRACE_SCHEMA, "kind": "header",
                  **(meta or {})}
        self._write(header)

    def _write(self, rec: dict) -> None:
        self.records.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec, sort_keys=True) + "\n")

    def emit(self, kind: str, name: str, tick=None, **attrs) -> None:
        rec = {"kind": kind, "name": name}
        if tick is not None:
            # row/step ticks are ints; scheduler ticks may be fractional
            # (poisson arrivals) — keep whichever the layer is denominated in
            t = float(tick)
            rec["tick"] = int(t) if t.is_integer() else t
        if attrs:
            rec["attrs"] = attrs
        self._write(rec)

    def span(self, name: str, tick=None, **attrs) -> None:
        self.emit("span", name, tick, **attrs)

    def event(self, name: str, tick=None, **attrs) -> None:
        self.emit("event", name, tick, **attrs)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()


def read_jsonl(path: str) -> List[dict]:
    """Read a trace file back, validating the header's schema version."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    if not records or records[0].get("kind") != "header":
        raise ValueError(f"{path!r} is not a trace file (no header record)")
    schema = records[0].get("schema")
    if schema != TRACE_SCHEMA:
        raise ValueError(f"trace {path!r} has schema {schema!r}; this "
                         f"reader understands {TRACE_SCHEMA}")
    return records
