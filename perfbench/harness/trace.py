"""The traced run's profile: a few steps after the window under
``torch.profiler``, reduced from its Chrome trace to what the per-layer
metrics and the ``breakdown`` read.

Ranges on the host: ``pb_step`` around each step, the benchmark's
``forward`` / ``backward`` / ``optimizer`` inside it, and the program's
own (``row_recompute``, which ``repro_torch.obs.profile_range`` opens
while ``obs.profiling()`` is on)."""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

STEP = "pb_step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile(job, batches, first: int, steps: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, record_function
    from repro_torch import obs

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        with obs.profiling():
            for i in range(steps):
                with record_function(STEP):
                    job.step(*batches[(first + i) % len(batches)],
                             probe=record_function)
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce(events, steps)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events, steps: int) -> dict:
    """Seconds busy and the window (the first step's start on the host to
    the last device operation's end), device time by kernel name, kernel
    launches, and the idle gaps summed by the innermost host range open
    when each gap began."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in spans if e.get("cat") in DEVICE_CATS]
    ranges = [e for e in spans if e.get("cat") == "user_annotation"]
    marks = [e for e in ranges if e["name"] == STEP]
    if not marks or not dev:
        return {}
    w0 = min(float(e["ts"]) for e in marks)
    w1 = max(max(float(e["ts"]) + float(e["dur"]) for e in dev),
             max(float(e["ts"]) + float(e["dur"]) for e in marks))
    busy = _merge((max(w0, float(e["ts"])),
                   min(w1, float(e["ts"]) + float(e["dur"])))
                  for e in dev)
    kernels = defaultdict(lambda: [0.0, 0])
    for e in dev:
        if e["cat"] == "kernel":
            k = kernels[e["name"]]
            k[0] += float(e["dur"]) * 1e-6
            k[1] += 1
    spans_by_start = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                             e["name"]) for e in ranges)
    idle = defaultdict(float)
    edges = [w0] + [x for a, b in busy for x in (a, b)] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        inner, width = "outside a step", float("inf")
        for a, b, name in spans_by_start:
            if a > g0:
                break
            if b > g0 and b - a < width:
                inner, width = name, b - a
        idle[inner] += (g1 - g0) * 1e-6
    return {"steps": steps, "window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "launches": sum(k[1] for k in kernels.values()),
            "kernels": {n: tuple(k) for n, k in kernels.items()},
            "idle": dict(idle)}


def breakdown(prof: dict, top: int = 10) -> dict:
    ops = sorted(((n, s) for n, (s, _) in prof["kernels"].items()),
                 key=lambda x: -x[1])[:top]
    gaps = sorted(prof["idle"].items(), key=lambda x: -x[1])[:top]
    return {"device_ops": [[n[:200], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
