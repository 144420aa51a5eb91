"""Persistent plan cache: production launches skip the solve entirely
(counterpart of ``repro.exec.plancache``; the same key, entry layout and
counters).

Plans are already JSON-replayable (``ExecutionPlan.to_dict/from_dict``
round-trips bit-identically), so the cache is a directory of
schema-versioned entry files keyed by a content hash over everything the
solve depends on — config fields, mesh, budget, and the hardware
fingerprint — plus the :meth:`CostTable.version` the solve was priced
with.  A lookup whose stored cost-table version differs is a *stale*
miss: the measurements under the cached decision changed, so the caller
re-solves and re-stores.

Every lookup/store emits obs counters (``plancache.hit`` /
``plancache.miss`` / ``plancache.stale`` / ``plancache.store``) and a
``plan_cache`` event, which is what lets CI assert "second run = cache
hit + zero planner solves" from the metrics dump alone.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Callable, Optional, Tuple

from repro_torch import obs
from repro_torch.exec.plan import ExecutionPlan

#: schema of a cache entry file (bump on breaking layout change)
CACHE_SCHEMA = 1


def plan_cache_key(**fields) -> str:
    """Content hash over the solve's inputs.  Canonical JSON (sorted
    keys, default=str for tuples/specs) so key construction is stable
    across processes and field insertion order."""
    blob = json.dumps(fields, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


class PlanCache:
    """Directory-backed plan store: one ``plan_<key>.json`` per entry."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def path(self, key: str) -> str:
        return os.path.join(self.root, f"plan_{key}.json")

    def lookup(self, key: str, cost_version: str = ""
               ) -> Optional[ExecutionPlan]:
        """The cached plan for ``key``, or None on miss / schema change /
        stale cost-table version.  Counters + a ``plan_cache`` event
        record the outcome either way."""
        path = self.path(key)
        entry = None
        if os.path.exists(path):
            try:
                with open(path) as f:
                    entry = json.load(f)
            except (json.JSONDecodeError, OSError):
                entry = None
        stale = ""
        if entry is not None and entry.get("schema") != CACHE_SCHEMA:
            stale, entry = "schema", None
        if entry is not None and \
                entry.get("cost_table_version", "") != (cost_version or ""):
            stale, entry = "cost_table", None
        hit = entry is not None
        obs.counter("plancache.hit" if hit else "plancache.miss").inc()
        if stale:
            obs.counter("plancache.stale").inc()
        obs.event("plan_cache", hit=hit, key=key, stale=stale)
        return ExecutionPlan.from_dict(entry["plan"]) if hit else None

    def store(self, key: str, plan: ExecutionPlan, cost_version: str = "",
              **meta) -> str:
        """Persist ``plan`` under ``key``.  Atomic (tmp + replace) and
        deterministic (sorted keys), so a re-store of the same solve is
        byte-identical — the bit-identical-replay CI gate depends on it."""
        entry = {
            "schema": CACHE_SCHEMA,
            "key": key,
            "cost_table_version": cost_version or "",
            "plan": plan.to_dict(),
            "meta": {k: v for k, v in meta.items()
                     if isinstance(v, (str, int, float, bool))},
        }
        path = self.path(key)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(entry, f, indent=2, sort_keys=True, default=str)
        os.replace(tmp, path)
        obs.counter("plancache.store").inc()
        obs.event("plan_cache_store", key=key)
        return path


def add_plan_cache_arg(ap) -> None:
    """The shared ``--plan-cache DIR`` flag."""
    ap.add_argument("--plan-cache", default="", metavar="DIR",
                    help="persistent plan cache directory: a hit skips "
                         "the planner solve entirely and replays the "
                         "stored plan JSON bit-identically; misses (and "
                         "stale cost-table versions) solve and store. "
                         "The calibrated cost_table.json persists in the "
                         "same directory")


def cached_plan(cache_dir: str, key_fields: dict,
                solve: Callable[[], ExecutionPlan],
                cost_version: str = ""
                ) -> Tuple[ExecutionPlan, bool, str]:
    """The launch-CLI wrapper: lookup -> (plan, hit, key); on miss run
    ``solve()`` and store its result.  On a hit ``solve`` is never
    called — zero planner solves, asserted via the obs counters."""
    cache = PlanCache(cache_dir)
    key = plan_cache_key(**key_fields)
    plan = cache.lookup(key, cost_version)
    if plan is not None:
        return plan, True, key
    plan = solve()
    cache.store(key, plan, cost_version, **key_fields)
    return plan, False, key
