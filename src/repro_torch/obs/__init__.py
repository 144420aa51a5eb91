"""repro_torch.obs — zero-overhead-when-disabled telemetry (counterpart
of ``repro.obs``).

One module-level session gates everything:

    from repro_torch import obs

    obs.configure(trace="run.jsonl", metrics="metrics.json",
                  meta={"arch": "vgg16", "engine": "twophase"})
    ...
    obs.shutdown()          # writes the metrics dump, closes the trace

Instrumentation sites call :func:`emit` / :func:`counter` / :func:`gauge`
/ :func:`histogram` unconditionally.  When no session is active,
``emit`` returns immediately and the metric constructors hand back the
shared :data:`~repro_torch.obs.metrics.NULL_METRIC` no-op — so a disabled
run pays one attribute load and one truthiness check per call site.  The
port runs eagerly, so where the reference's executor hooks fire once per
jit trace, the port's fire once per executed step; every hook site is
guarded by :func:`enabled`, and no hook touches a tensor's values, so a
step computes the same bits with obs on or off.

Registration is one call per layer (see ROADMAP "Observability"):
the row-program executor, the serve scheduler and the launch CLIs all
emit into whatever session is active; no plumbing of sink objects
through call stacks.
"""

from __future__ import annotations

import contextlib
from typing import Optional

from repro_torch.obs.metrics import (METRICS_SCHEMA, Counter, Gauge, Histogram,
                               MetricsRegistry, NULL_METRIC, merge_counts)
from repro_torch.obs.trace import TRACE_SCHEMA, Tracer, read_jsonl

__all__ = [
    "configure", "shutdown", "enabled", "session", "capture",
    "emit", "span", "event", "counter", "gauge", "histogram",
    "profile_range", "profiling",
    "Tracer", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "NULL_METRIC", "merge_counts", "read_jsonl",
    "TRACE_SCHEMA", "METRICS_SCHEMA",
]


class Session:
    """An active obs session: a tracer plus a metrics registry."""

    def __init__(self, trace: Optional[str] = None,
                 metrics: Optional[str] = None,
                 meta: Optional[dict] = None):
        self.tracer = Tracer(trace, meta=meta)
        self.metrics = MetricsRegistry()
        self.metrics_path = metrics

    def close(self) -> None:
        if self.metrics_path:
            self.metrics.dump(self.metrics_path)
        self.tracer.close()


#: the one active session, or None (disabled mode)
_session: Optional[Session] = None
#: whether a torch.profiler capture is running (set by ``cli.profiled``):
#: profiler ranges are opened only then
_profiling = False


def configure(trace: Optional[str] = None, metrics: Optional[str] = None,
              meta: Optional[dict] = None) -> Session:
    """Open a session.  Replaces (and closes) any active one."""
    global _session
    if _session is not None:
        _session.close()
    _session = Session(trace=trace, metrics=metrics, meta=meta)
    return _session


def shutdown() -> None:
    """Close the active session, writing the metrics dump if configured."""
    global _session
    if _session is not None:
        _session.close()
        _session = None


def enabled() -> bool:
    return _session is not None


def session() -> Optional[Session]:
    return _session


@contextlib.contextmanager
def capture(trace: Optional[str] = None, metrics: Optional[str] = None,
            meta: Optional[dict] = None):
    """Scoped session for tests and library callers: restores whatever
    session (or none) was active before."""
    global _session
    prev = _session
    _session = Session(trace=trace, metrics=metrics, meta=meta)
    try:
        yield _session
    finally:
        _session.close()
        _session = prev


# -- emission (the hot path: one global load + one None check) ----------

def emit(kind: str, name: str, tick=None, **attrs) -> None:
    s = _session
    if s is not None:
        s.tracer.emit(kind, name, tick, **attrs)


def span(name: str, tick=None, **attrs) -> None:
    emit("span", name, tick, **attrs)


def event(name: str, tick=None, **attrs) -> None:
    emit("event", name, tick, **attrs)


def counter(name: str):
    s = _session
    return NULL_METRIC if s is None else s.metrics.counter(name)


def gauge(name: str):
    s = _session
    return NULL_METRIC if s is None else s.metrics.gauge(name)


def histogram(name: str):
    s = _session
    return NULL_METRIC if s is None else s.metrics.histogram(name)


@contextlib.contextmanager
def profiling():
    """Mark a torch.profiler capture as running for its extent, so
    :func:`profile_range` names ranges inside it."""
    global _profiling
    _profiling = True
    try:
        yield
    finally:
        _profiling = False


def profile_range(name: str):
    """``torch.profiler.record_function(name)`` while a profiler capture
    runs (:func:`profiling`), so a profiled run's Chrome trace names the
    range (a train step and its phases, a recomputed row); a no-op context
    otherwise, so a traced run without ``--torch-profile`` pays nothing
    for it.  The port's addition: the reference's ``jax.profiler`` trace
    names XLA ops."""
    if not _profiling:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(name)
