"""Metrics-backed step log for the launch CLIs (counterpart of
``repro.obs.steplog``).

One object does three jobs per logged step:

* keeps the per-step record (``step``, ``loss``, ``elapsed_s``, plus
  whatever the step function returned),
* prints the trainers' step line,
* feeds the active obs session: a ``{prefix}_step`` span per record, the
  ``{prefix}.steps_logged`` counter and a histogram per numeric field —
  so ``--metrics-out`` summarises a run without any consumer parsing the
  log file.

``dump`` writes the schema-versioned envelope
``{"schema": 1, ..., "steps": [<records>]}``; :func:`load_steps` reads
both that and the older bare-list layout.
"""

from __future__ import annotations

import json
from typing import List

from repro_torch import obs

#: version of the train_log.json envelope (the reference's)
STEPLOG_SCHEMA = 1


def _line(rec: dict) -> str:
    """The trainers' step line, chosen by which keys exist."""
    if "grad_norm" in rec:       # LM trainer
        return (f"step {rec['step']:5d} loss {rec['loss']:.4f} "
                f"ce {rec.get('ce', 0):.4f} "
                f"gnorm {rec['grad_norm']:.2f} "
                f"({rec['elapsed_s']}s)")
    return (f"step {rec['step']:5d} loss {rec['loss']:.4f} "
            f"({rec['elapsed_s']}s)")


class StepLog:
    """Per-step record list + console line + obs emission."""

    def __init__(self, prefix: str = "train"):
        self.prefix = prefix
        self.records: List[dict] = []

    def log(self, rec: dict, echo: bool = True) -> dict:
        self.records.append(rec)
        if echo:
            print(_line(rec), flush=True)
        obs.span(f"{self.prefix}_step", tick=rec.get("step"),
                 **{k: v for k, v in rec.items() if k != "step"})
        obs.counter(f"{self.prefix}.steps_logged").inc()
        for k, v in rec.items():
            if k != "step" and isinstance(v, (int, float)):
                obs.histogram(f"{self.prefix}.{k}").observe(v)
        return rec

    def dump(self, path: str, **header) -> None:
        with open(path, "w") as f:
            json.dump({"schema": STEPLOG_SCHEMA, **header,
                       "steps": self.records}, f, indent=2)


def load_steps(path: str) -> List[dict]:
    """Read a train log in either layout: the schema-1 envelope or a bare
    list of step records."""
    with open(path) as f:
        d = json.load(f)
    if isinstance(d, list):
        return d
    schema = d.get("schema")
    if schema != STEPLOG_SCHEMA:
        raise ValueError(f"train log {path!r} has schema {schema!r}; "
                         f"this reader understands {STEPLOG_SCHEMA}")
    return d["steps"]
