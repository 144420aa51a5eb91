"""One run of one cell.

Set-up (``setup_s``, from the process's start): the weights and a pool of
batches made on the device from ``--seed``; the program's plan, trunk and
step; three steps whose results the check reads, on three different
batches; two more warm steps.  Then the window: steps one after another
for ``--seconds``, with no synchronise inside, closed by one.  With
``--trace 1`` the window also times each step's phases, and a few
profiled steps follow it.  Then the program's state is freed and the
reference takes the same three steps from the same weights; the result
line says whether the two agree."""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from types import SimpleNamespace

from harness import check, data, spec

#: top-level module names that may not be loaded when the result prints
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CHECKED_STEPS, WARM_STEPS, PROFILED_STEPS = 3, 2, 3
#: the reference's block of images (it runs column-centric)
REF_CHUNK = 32


def forbidden_modules(names=None):
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class Stamps:
    """Step ends on the device's clock (CUDA events, no synchronise), or on
    the host's where there is no card."""

    def __init__(self, cuda: bool):
        import torch
        self.cuda = cuda
        self.torch = torch

    def stamp(self):
        if not self.cuda:
            return time.perf_counter()
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else 1e3 * (b - a)


class PhaseProbe:
    """``probe(name)`` for the traced window: stamps around each phase."""

    def __init__(self, stamps: Stamps):
        self.stamps = stamps
        self.ms = {}

    @contextlib.contextmanager
    def __call__(self, name):
        a = self.stamps.stamp()
        yield
        self.ms.setdefault(name, []).append((a, self.stamps.stamp()))

    def means(self):
        return {n: sum(self.stamps.ms(a, b) for a, b in v) / len(v)
                for n, v in self.ms.items()}


def inputs(cell, seed: int, device):
    """The seed's weights (the reference's leaves) and batch pool, drawn on
    ``device`` in that order from one generator."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    p0 = spec.reference(cell.cfg["arch"]).init_params(cell.cfg, gen, device)
    return p0, data.pool(cell.cfg, cell.traffic, gen, device)


def setup(cell, seed: int, device, faults=()):
    """The job, the batch pool and the program's readings of its first
    steps."""
    import torch
    from harness.program import Job

    cfg = cell.cfg
    torch.backends.cudnn.allow_tf32 = cfg["tf32"]
    torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    p0, batches = inputs(cell, seed, device)
    job = Job(spec.program(cfg["arch"]), cfg, cell.traffic, p0)
    del p0
    for fault in faults:
        fault(job)
    readings = job.follow(batches, CHECKED_STEPS)
    return job, batches, readings


def reference(cell, seed: int, batches, device, low: str = ""):
    """The plain reference's three steps from the seed's weights.  ``low``
    runs it a precision below the configuration's: ``tf32`` (TF32 on) or
    ``bf16`` (weights and images in bfloat16)."""
    import torch
    cfg = cell.cfg
    ref = spec.reference(cfg["arch"])
    gen = torch.Generator(device=device).manual_seed(seed)
    p0 = ref.init_params(cfg, gen, device)  # the first draws of inputs()
    tf32 = cfg["tf32"] or low == "tf32"
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    if low == "bf16":
        p0 = {n: t.bfloat16() for n, t in p0.items()}
        batches = [(x.bfloat16(), y) for x, y in batches]
    try:
        return ref.train(cfg, p0, batches, REF_CHUNK)
    finally:
        torch.backends.cudnn.allow_tf32 = cfg["tf32"]
        torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]


def window(job, batches, seconds: float, device, traced: bool, first: int):
    import torch
    cuda = device.type == "cuda"
    stamps = Stamps(cuda)
    probe = PhaseProbe(stamps) if traced else None
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, ends, host = [], [], []
    start = stamps.stamp()
    t0 = time.perf_counter()
    k = first
    while True:
        h0 = time.perf_counter()
        if traced:
            losses.append(job.step(*batches[k % len(batches)], probe=probe))
        else:
            losses.append(job.step(*batches[k % len(batches)]))
        host.append(1e3 * (time.perf_counter() - h0))
        ends.append(stamps.stamp())
        k += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    marks = [start] + ends
    w = SimpleNamespace(
        steps=len(ends), images=len(ends) * batches[0][0].shape[0],
        seconds=elapsed,
        step_ms=[stamps.ms(a, b) for a, b in zip(marks, marks[1:])],
        peak_bytes=(int(torch.cuda.max_memory_allocated()) if cuda
                    else None),
        failed=int((~torch.isfinite(torch.stack(losses))).sum()),
        next=k, host_ms=host if traced else None,
        phase_ms=probe.means() if traced else None)
    return w


def _json(x: float):
    """``x``, or its name where JSON has no number for it (inf, nan)."""
    return x if math.isfinite(x) else str(x)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run(cell, seed: int, seconds: float, traced: bool, device,
        t_start: float, faults=()):
    """One run; returns the result line's object, with the check's lines
    under ``_check_lines`` for standard error."""
    import torch
    from harness import trace

    device = torch.device(device)
    job, batches, prog = setup(cell, seed, device, faults)
    for i in range(CHECKED_STEPS, CHECKED_STEPS + WARM_STEPS):
        job.step(*batches[i % len(batches)])
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.time() - t_start
    win = window(job, batches, seconds, device, traced, CHECKED_STEPS
                 + WARM_STEPS)
    prof = (trace.profile(job, batches, win.next, PROFILED_STEPS)
            if traced and device.type == "cuda" else None)
    plan = job.plan
    del job
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference(cell, seed, batches, device)
    values, where = check.gaps(prog, ref)
    correct = check.verdict(values, cell.limits)

    # what a metric reads: it derives the rest from the cell and the plan
    facts = SimpleNamespace(cell=cell, plan=plan, setup_s=setup_s,
                            window=win, profile=prof)
    metrics, unread = {}, []
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.metric(m["name"], cell.root).read(facts)
        if value is None:
            unread.append(m["name"])
        else:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": win.peak_bytes or 0}
    out = {"correct": correct, "attempted": win.steps, "failed": win.failed,
           "metrics": metrics, "device": dev}
    if prof:
        dev["busy_s"], dev["window_s"] = prof["busy_s"], prof["window_s"]
        out["breakdown"] = trace.breakdown(prof)
    out["plan"] = plan.describe()
    out["card"] = power_limit() if cuda else "cpu"
    out["losses"] = {"program": [_json(x) for x in prog["loss"]],
                     "reference": [_json(x) for x in ref["loss"]]}
    out["check"] = {k: {"value": _json(values[k]), "limit": cell.limits[k]}
                    for k in cell.limits}
    out["_check_lines"] = (
        [f"perfbench: nothing to read for {unread}"] if unread else []) \
        + check.lines(values, cell.limits, where)
    return out


def parse(argv):
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = spec.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
              t_start)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: modules {bad} are loaded; the port runs without "
              f"JAX and without the JAX package", file=sys.stderr)
        return 3
    lines = out.pop("_check_lines")
    print(json.dumps(out), flush=True)
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    return 0
