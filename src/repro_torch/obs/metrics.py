"""Metrics registry: counters / gauges / histograms with a JSON dump
(counterpart of ``repro.obs.metrics``; the same classes and dump layout).

The policy/mechanism split the rest of the repo uses, applied to
telemetry: instrumentation sites (the row executor, the serve scheduler,
the launch CLIs) talk to *named metrics* and never to files; one
:class:`MetricsRegistry` owns the state and serialises it
(:meth:`MetricsRegistry.to_dict` / :meth:`dump`) into a schema-versioned
JSON blob next to the run's other artefacts.

Disabled-mode cost is the design constraint (no per-step Python
allocation on the step's path): when no obs session is
active, :func:`repro_torch.obs.counter` and friends return the shared
:data:`NULL_METRIC` singleton whose mutators are no-ops — call sites
never branch, never allocate, and never import json.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

#: version of the metrics-dump JSON layout (bump on breaking change)
METRICS_SCHEMA = 1


class Counter:
    """Monotonic counter (events seen, rows executed, pages grown)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-value metric (bytes resident, slots active, plan estimate)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v) -> None:
        self.value = float(v)


class Histogram:
    """Value distribution (per-step loss, per-request latency).  Keeps the
    raw observations — runs are short and tick-denominated, so a bounded
    reservoir would only blur the percentiles the SLO checks read."""

    __slots__ = ("name", "values")

    def __init__(self, name: str):
        self.name = name
        self.values: List[float] = []

    def observe(self, v) -> None:
        self.values.append(float(v))

    def summary(self) -> dict:
        if not self.values:
            return {"count": 0}
        vals = sorted(self.values)

        def pct(p: float) -> float:
            return vals[min(len(vals) - 1, int(round(p * (len(vals) - 1))))]

        return {"count": len(vals), "sum": sum(vals), "min": vals[0],
                "max": vals[-1], "mean": sum(vals) / len(vals),
                "p50": pct(0.50), "p95": pct(0.95)}


class _NullMetric:
    """The disabled-mode stand-in for every metric type: mutators are
    no-ops, so instrumentation sites call unconditionally."""

    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def observe(self, v) -> None:
        pass


#: the one shared no-op metric (identity-comparable in tests)
NULL_METRIC = _NullMetric()


class MetricsRegistry:
    """Named-metric store, one per obs session."""

    def __init__(self):
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    # -- get-or-create accessors ---------------------------------------
    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name)
        return h

    # -- serialisation --------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "schema": METRICS_SCHEMA,
            "counters": {n: c.value for n, c in sorted(self.counters.items())},
            "gauges": {n: g.value for n, g in sorted(self.gauges.items())},
            "histograms": {n: h.summary()
                           for n, h in sorted(self.histograms.items())},
        }

    def dump(self, path: str) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)

    @staticmethod
    def load(path: str) -> dict:
        """Read a dump back, validating the schema version."""
        with open(path) as f:
            d = json.load(f)
        schema = d.get("schema")
        if schema != METRICS_SCHEMA:
            raise ValueError(f"metrics dump {path!r} has schema {schema!r}; "
                             f"this reader understands {METRICS_SCHEMA}")
        return d


def merge_counts(registry: MetricsRegistry,
                 counts: Optional[dict]) -> None:
    """Bulk-add a ``{name: n}`` mapping into the registry's counters —
    the bridge for components that tally locally (the scheduler's event
    counts) and flush once."""
    for name, n in (counts or {}).items():
        registry.counter(name).inc(int(n))
