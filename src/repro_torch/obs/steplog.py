"""Step log for the launch CLIs (counterpart of ``repro.obs.steplog``
without the obs-session hooks, which are not ported yet).

Keeps the per-step records, prints the trainers' step line, and writes the
schema-versioned ``train_log.json`` envelope
``{"schema": 1, ..., "steps": [...]}`` the reference writes.
"""

from __future__ import annotations

import json
from typing import List

#: version of the train_log.json envelope (the reference's)
STEPLOG_SCHEMA = 1


class StepLog:
    """Per-step record list + console line."""

    def __init__(self):
        self.records: List[dict] = []

    def log(self, rec: dict) -> dict:
        self.records.append(rec)
        print(f"step {rec['step']:5d} loss {rec['loss']:.4f} "
              f"({rec['elapsed_s']}s)", flush=True)
        return rec

    def dump(self, path: str, **header) -> None:
        with open(path, "w") as f:
            json.dump({"schema": STEPLOG_SCHEMA, **header,
                       "steps": self.records}, f, indent=2)
