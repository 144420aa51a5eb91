"""Plan audit: measured peak bytes of one step, next to the estimate
(counterpart of ``repro.obs.audit``).

The Planner prices every plan (Eqs. 7-16: activations + boundary caches +
optimiser state); this module *measures* a step so that a pricing
regression cannot ship silently.  Two measurement sources, recorded side
by side with the plan's per-device estimate:

``cuda_max_allocated``  :func:`measure_step` runs the step once on the
                        card between ``reset_peak_memory_stats`` and
                        ``max_memory_allocated``: the absolute peak of the
                        caching allocator's live tensors, arguments
                        (parameters, optimizer state, the batch) included —
                        the counterpart of the reference's XLA temp +
                        argument + output bytes of the compiled step.
``live_buffers``        the sum of ``.nbytes`` over a live tree of tensors
                        (:func:`live_bytes`).

The reference's ``memory_metrics``, which flattens XLA's
``compiled.memory_analysis()`` object, has no counterpart: eager PyTorch
compiles nothing to analyse, so the port runs the call instead.

The record is keyed by the plan axes the estimate formulae branch on —
``(engine, n_rows, residency, cache_kind)`` — so
:mod:`repro_torch.analysis.audit` can aggregate estimate error per formula
and flag drift.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.exec.plan import ExecutionPlan
from repro_torch.optim.adamw import tree_leaves

#: the ``method`` a card measurement records
CUDA_METHOD = "cuda_max_allocated"


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _device_of(args, device) -> torch.device:
    """``device`` when given, else the first tensor argument's, else the
    card when there is one."""
    if device is not None:
        return torch.device(device)
    tensors = _tensors(args)
    if tensors:
        return tensors[0].device
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def measure_step(fn, *args, time_iters: int = 0,
                 device=None) -> Optional[dict]:
    """Run ``fn(*args)`` once and return its memory metrics.

    On a CUDA device the card is synchronised, its peak statistics reset,
    the call run and synchronised again: ``peak_bytes`` is
    ``torch.cuda.max_memory_allocated()`` (``method``
    ``"cuda_max_allocated"``).  The device is ``device``, else the first
    tensor argument's, else the card when there is one — a closure that
    takes no arguments and keeps its own results is how a caller measures
    a step it also uses.  On the CPU nothing reports memory: the call runs
    and the result is None, as in the reference where the backend has no
    memory analysis.

    ``time_iters > 0`` then calls ``fn(*args)`` ``time_iters`` more times
    (the measured call was the warmup) and records the median under
    ``wall_us``: CUDA events on the card, the host clock on the CPU.  With
    timing asked for the dict is returned on the CPU too, with
    ``peak_bytes`` 0."""
    dev = _device_of(args, device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    fn(*args)
    if cuda:
        torch.cuda.synchronize(dev)
        out = {"peak_bytes": int(torch.cuda.max_memory_allocated(dev)),
               "method": CUDA_METHOD}
    elif time_iters:
        out = {"peak_bytes": 0}
    else:
        return None
    if time_iters:
        times = []
        for _ in range(time_iters):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) * 1e3)
            else:
                t0 = time.perf_counter()
                fn(*args)
                times.append((time.perf_counter() - t0) * 1e6)
        times.sort()
        out["wall_us"] = times[len(times) // 2]
    return out


def live_bytes(tree) -> int:
    """Bytes actually resident in a tree (dicts, lists, tuples) of
    tensors."""
    return sum(int(t.nbytes) for t in _tensors(tree))


def plan_audit(plan: ExecutionPlan, measured: dict, source: str,
               extra: Optional[dict] = None,
               est_bytes: Optional[int] = None) -> dict:
    """Build (and emit, when a session is active) one audit record.

    ``measured`` must contain ``peak_bytes``; ``source`` names the
    measurement path (``train_step`` / ``train_step_lm``) so the analysis
    side can apply a per-source tolerance.  ``est_bytes`` overrides the
    default per-device estimate when the measurement targets a different
    term (the LM step adds the paper's ξ)."""
    est = int(est_bytes) if est_bytes is not None \
        else int(plan.est_bytes_per_device or plan.est_bytes or 0)
    peak = int(measured.get("peak_bytes", 0))
    rec = {
        "source": source,
        "engine": plan.engine,
        "n_rows": plan.n_rows,
        "residency": (plan.residency.describe()
                      if plan.residency is not None else "device"),
        "cache_kind": plan.get("cache_kind", ""),
        "est_bytes_per_device": est,
        "measured": measured,
        "ratio": (peak / est) if est else None,
    }
    if extra:
        rec.update(extra)

    obs.emit("plan_audit", source, **rec)
    obs.gauge(f"audit.{source}.est_bytes").set(est)
    obs.gauge(f"audit.{source}.measured_peak_bytes").set(peak)
    if rec["ratio"] is not None:
        obs.gauge(f"audit.{source}.ratio").set(rec["ratio"])
    return rec
