"""What the program's timed capture costs a step, on the card, at a cell's
own sizes (no window; the benchmark's runs do not run this):

    python3 perfbench/capture_cost.py --workload <name> --seed <n> \\
        [--steps 3] [--rounds 2]

Set-up as a run makes it (weights, batches, plan, the checked and warm
steps), then rounds of four ways to take ``--steps`` steps, in turn, each
round in the reverse order of the one before:

* ``plain``: no profiler, no capture (the window's steps);
* ``capture``: the program's capture alone (``obs.profiling()``, no
  profiler): what a run would pay to read the capture's metrics over its
  window;
* ``profiled_bare``: the traced run's profiled steps
  (``harness/trace.py::profile``) with ``obs.profiling`` made a null
  context, so the program opens no range: the profiler alone;
* ``profiled``: the traced run's profiled steps as they are, ranges and
  capture included.

Each is read as ms a step: the plain and capture ways between CUDA events
around the steps (one synchronise after them), the profiled ways as the
profile's window over its steps.  Prints one JSON line with every
round's reading and the card's name and power limit."""

import argparse
import contextlib
import json
import sys
from pathlib import Path
from unittest import mock

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

from run import fixed_caches  # noqa: E402

WAYS = ("plain", "capture", "profiled_bare", "profiled")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    fixed_caches()
    import torch
    from harness import runner, spec, trace
    from repro_torch import obs

    cell = spec.cell(args.workload)
    device = torch.device("cuda")
    job, batches, _ = runner.setup(cell, args.seed, device)
    k = runner.CHECKED_STEPS
    for _ in range(runner.WARM_STEPS):
        job.step(*batches[k % len(batches)])
        k += 1
    torch.cuda.synchronize()

    def timed(ctx):
        nonlocal k
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with ctx:
            start.record()
            for _ in range(args.steps):
                job.step(*batches[k % len(batches)])
                k += 1
            end.record()
            torch.cuda.synchronize()
        return start.elapsed_time(end) / args.steps

    def profiled(ranges: bool):
        nonlocal k
        patch = contextlib.nullcontext() if ranges else mock.patch.object(
            obs, "profiling", contextlib.nullcontext)
        with patch:
            p = trace.profile(job, batches, k, args.steps)
        k += args.steps
        return 1e3 * p["window_s"] / p["steps"]

    read = {"plain": lambda: timed(contextlib.nullcontext()),
            "capture": lambda: timed(obs.profiling()),
            "profiled_bare": lambda: profiled(False),
            "profiled": lambda: profiled(True)}
    ms = {w: [] for w in WAYS}
    for r in range(args.rounds):
        for w in (WAYS if r % 2 == 0 else WAYS[::-1]):
            ms[w].append(read[w]())
    cap = obs.last_capture()
    print(json.dumps({"workload": cell.name, "seed": args.seed,
                      "steps": args.steps, "ms_per_step": ms,
                      "ranges_per_step": len(cap.records) / args.steps,
                      "card": runner.power_limit()}), flush=True)


if __name__ == "__main__":
    main()
