"""Shared obs wiring for the launch CLIs (counterpart of
``repro.obs.cli``).

The trainer takes three flags:

  --trace PATH          write the span/event/audit stream as JSONL
  --metrics-out PATH    write the metrics-registry dump on exit
  --torch-profile DIR   also capture a torch.profiler trace into DIR (the
                        counterpart of the reference's --jax-profile)

Passing either of the first two opens the module-level obs session; with
neither, the session stays closed and every hook in the executors is a
no-op (the zero-overhead default).
"""

from __future__ import annotations

import contextlib
import os

from repro_torch import obs


def add_obs_args(ap) -> None:
    ap.add_argument("--trace", default="",
                    help="write a schema-versioned JSONL span/event trace "
                         "(rows, transfers, plan audits) to this path")
    ap.add_argument("--metrics-out", default="",
                    help="write the metrics-registry dump (counters / "
                         "gauges / histogram summaries) to this path on "
                         "exit")
    ap.add_argument("--torch-profile", default="",
                    help="also capture a torch.profiler trace (CPU and "
                         "CUDA activities) of the run and export it as a "
                         "Chrome trace into this directory (requires "
                         "--trace or --metrics-out)")


def configure_from_args(args, **meta) -> bool:
    """Open an obs session if the CLI asked for one.  Returns enabled."""
    if not (args.trace or args.metrics_out):
        return False
    obs.configure(trace=args.trace or None,
                  metrics=args.metrics_out or None, meta=meta)
    return True


@contextlib.contextmanager
def profiled(args):
    """torch.profiler capture scoped over the run when --torch-profile is
    set (and obs is on — profiling without a sink to cross-reference
    would be unanchored).  The Chrome trace lands in the directory as
    ``trace.json``."""
    out_dir = getattr(args, "torch_profile", "")
    if not (out_dir and obs.enabled()):
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof, obs.profiling():
        yield
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
