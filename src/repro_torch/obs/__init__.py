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
guarded by :func:`counting` (a session or a capture is open), and no
hook touches a tensor's values, so a step computes the same bits with
obs on or off.

Registration is one call per layer (see ROADMAP "Observability"):
the row-program executor, the serve scheduler and the launch CLIs all
emit into whatever session is active; no plumbing of sink objects
through call stacks.

The timed side is :func:`profile_range`, the program's one span
primitive.  While :func:`profiling` runs (the trainer's
``--torch-profile``, the benchmark's profiled steps) a range opens a
``torch.profiler.record_function`` and appends a timed record to the
capture (:mod:`repro_torch.obs.capture`), and counters count into the
capture as well as into any session; :func:`last_capture` reads the
capture once it has closed.  Outside one, a range is a shared null
context.  :func:`span` emits a session's span record and returns the
range of the same name, so one call serves both.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.obs.capture import Capture, Record
from repro_torch.obs.metrics import (METRICS_SCHEMA, Counter, Gauge, Histogram,
                               MetricsRegistry, NULL_METRIC, merge_counts)
from repro_torch.obs.trace import TRACE_SCHEMA, Tracer, read_jsonl

__all__ = [
    "configure", "shutdown", "enabled", "session", "capture",
    "emit", "span", "event", "counter", "gauge", "histogram",
    "profile_range", "profiling", "last_capture", "counting", "NULL_RANGE",
    "Capture", "Record", "Tracer", "MetricsRegistry", "Counter", "Gauge",
    "Histogram", "NULL_METRIC", "merge_counts", "read_jsonl",
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
#: the running capture (:func:`profiling`), or None: ranges open only then
_capture: Optional[Capture] = None
#: the last capture to close
_last: Optional[Capture] = None
#: what :func:`profile_range` returns outside a capture
NULL_RANGE = contextlib.nullcontext()


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


def counting() -> bool:
    """Whether counters count anywhere: a session or a capture is open."""
    return _session is not None or _capture is not None


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


def span(name: str, tick=None, **attrs):
    """Emit a span record into the session, and return
    :func:`profile_range` of the same name and attributes, for the work
    the span stands for."""
    emit("span", name, tick, **attrs)
    return profile_range(name, tick=tick, **attrs)


def event(name: str, tick=None, **attrs) -> None:
    emit("event", name, tick, **attrs)


class _Both:
    """A counter of the session and the same-named one of the capture."""

    __slots__ = ("a", "b")

    def __init__(self, a: Counter, b: Counter):
        self.a, self.b = a, b

    def inc(self, n: int = 1) -> None:
        self.a.inc(n)
        self.b.inc(n)


def counter(name: str):
    s, c = _session, _capture
    if c is None:
        return NULL_METRIC if s is None else s.metrics.counter(name)
    if s is None:
        return c.metrics.counter(name)
    return _Both(s.metrics.counter(name), c.metrics.counter(name))


def gauge(name: str):
    s = _session
    return NULL_METRIC if s is None else s.metrics.gauge(name)


def histogram(name: str):
    s = _session
    return NULL_METRIC if s is None else s.metrics.histogram(name)


@contextlib.contextmanager
def profiling(device=None):
    """Open a :class:`Capture` for the block's extent (yielded; kept for
    :func:`last_capture` once closed): :func:`profile_range` records into
    it, and names its ranges to a running ``torch.profiler``.  Device
    times are recorded where there is a card and ``device`` is a CUDA
    device or None."""
    global _capture, _last
    cuda = torch.cuda.is_available() and (
        device is None or torch.device(device).type == "cuda")
    prev, cap = _capture, Capture(cuda=cuda)
    _capture = cap
    try:
        yield cap
    finally:
        _capture = prev
        cap.close()
        _last = cap


def last_capture() -> Optional[Capture]:
    """The last capture to close, or None."""
    return _last


def profile_range(name: str, **attrs):
    """The program's timed range: while a capture runs (:func:`profiling`)
    a ``torch.profiler.record_function(name)`` range and a record of the
    capture with ``attrs`` (indices go there, never into the name);
    :data:`NULL_RANGE` otherwise, so a run without a capture pays one
    global check for it.  The port's addition: the reference's
    ``jax.profiler`` trace names XLA ops."""
    cap = _capture
    if cap is None:
        return NULL_RANGE
    return cap.range(name, attrs)
