"""Timed capture: the program's ranges on the host's clock and, on a CUDA
device, on the device's, put on the host's clock through one anchor.

:func:`repro_torch.obs.profiling` opens a :class:`Capture`; while it runs
every :func:`repro_torch.obs.profile_range` appends a :class:`Record` (its
name, the record open around it, its attributes, and its host and device
times), and the counters the program bumps through
:func:`repro_torch.obs.counter` count into :attr:`Capture.metrics` too.

Device times come from a pair of timing ``torch.cuda.Event`` a range
records on the current stream; they are resolved only when the capture
closes, after a synchronise, so a range costs the host two event records
and never waits for the device.  The anchor is an event recorded right
after a synchronise at the capture's opening, with the host's time taken
right after it: a device event's host-clock time is the anchor's host
time plus the event's elapsed time from the anchor.  A few probes
recorded on the drained device give :attr:`Capture.idle_lag_ns`, how far
behind the host the device reaches a fresh event when nothing is queued.

A capture serves one thread at a time (a backward the autograd engine
runs on its device thread while the caller waits counts as one), and no
range reads or writes a tensor's values.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import torch

from repro_torch.obs.metrics import MetricsRegistry

#: empty-queue probes taken at the anchor
PROBES = 4


class Record:
    """One range: ``name``; ``parent``, the index in :attr:`Capture.records`
    of the range open around it (None at the top); ``attrs`` (row and
    segment indices, strategies); ``host_ns``, (start, end) on
    ``time.perf_counter_ns``; ``device_ns``, (start, end) of the range's
    events on the device, on the same clock, or None on CPU tensors and
    until the capture closes."""

    __slots__ = ("name", "parent", "attrs", "host_ns", "device_ns")

    def __init__(self, name: str, parent: Optional[int], attrs: dict,
                 host_ns: Tuple[int, Optional[int]],
                 device_ns: Optional[Tuple[int, int]] = None):
        self.name, self.parent, self.attrs = name, parent, attrs
        self.host_ns, self.device_ns = host_ns, device_ns

    def __repr__(self):
        return (f"Record({self.name!r}, parent={self.parent}, "
                f"attrs={self.attrs}, host_ns={self.host_ns}, "
                f"device_ns={self.device_ns})")


class _Range:
    """The context :func:`repro_torch.obs.profile_range` returns while a
    capture runs: a ``torch.profiler.record_function`` range (so a running
    profiler names it) and the capture's record."""

    __slots__ = ("cap", "name", "attrs", "rf", "index")

    def __init__(self, cap: "Capture", name: str, attrs: dict):
        self.cap, self.name, self.attrs = cap, name, attrs

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.index = self.cap._begin(self.name, self.attrs)
        return self

    def __exit__(self, *exc):
        self.cap._end(self.index)
        self.rf.__exit__(*exc)
        return False


class Capture:
    """The records and counters of one :func:`repro_torch.obs.profiling`
    extent.  ``cuda`` records device times (timing events on the current
    stream); otherwise every record's ``device_ns`` stays None.
    ``anchor_ns`` is the host time the device times are put against;
    ``idle_lag_ns`` (CUDA, once closed) the largest lag of the empty-queue
    probes."""

    def __init__(self, cuda: bool = False):
        self.records: List[Record] = []
        self.metrics = MetricsRegistry()
        self.idle_lag_ns: Optional[int] = None
        self._open: List[int] = []
        self._events = None  # per record [start, end] events, until close
        self._anchor = None
        if cuda:
            torch.cuda.synchronize()
            self._anchor = torch.cuda.Event(enable_timing=True)
            self._anchor.record()
        self.anchor_ns = time.perf_counter_ns()
        if cuda:
            self._events = []
            self._probes = []
            for _ in range(PROBES):
                torch.cuda.synchronize()
                self._probes.append(self._stamp())
            torch.cuda.synchronize()

    @staticmethod
    def _stamp():
        ev = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter_ns()
        ev.record()
        return t, ev

    def range(self, name: str, attrs: dict) -> _Range:
        return _Range(self, name, attrs)

    def _begin(self, name: str, attrs: dict) -> int:
        i = len(self.records)
        parent = self._open[-1] if self._open else None
        if self._events is None:
            t = time.perf_counter_ns()
        else:
            t, ev = self._stamp()
            self._events.append([ev, None])
        self.records.append(Record(name, parent, attrs, (t, None)))
        self._open.append(i)
        return i

    def _end(self, i: int) -> None:
        if self._events is None:
            t = time.perf_counter_ns()
        else:
            t, self._events[i][1] = self._stamp()
        rec = self.records[i]
        rec.host_ns = (rec.host_ns[0], t)
        self._open.pop()

    def close(self) -> None:
        """Resolve the device times (after a synchronise); a no-op on the
        CPU and the second time."""
        if self._anchor is None:
            return
        torch.cuda.synchronize()
        anchor, t0 = self._anchor, self.anchor_ns

        def on_host(ev):
            return t0 + round(anchor.elapsed_time(ev) * 1e6)

        self.idle_lag_ns = max(on_host(e) - t for t, e in self._probes)
        for rec, (e0, e1) in zip(self.records, self._events):
            if e1 is not None:
                rec.device_ns = (on_host(e0), on_host(e1))
        self._anchor = self._events = self._probes = None

    # -- reading --------------------------------------------------------

    def count(self, name: str) -> int:
        """The counter ``name``'s value (0 where nothing counted it)."""
        c = self.metrics.counters.get(name)
        return 0 if c is None else c.value

    def device_ms(self, name: str) -> Optional[float]:
        """Device milliseconds inside the ranges called ``name``, each
        counted once where such ranges nest; None where there is no such
        range or no device time."""
        recs = self.records
        total, seen = 0, False
        for rec in recs:
            if rec.name != name:
                continue
            p = rec.parent
            while p is not None and recs[p].name != name:
                p = recs[p].parent
            if p is not None:
                continue
            if rec.device_ns is None:
                return None
            total += rec.device_ns[1] - rec.device_ns[0]
            seen = True
        return total * 1e-6 if seen else None
