"""Built-in engines behind the registry's ``build(modules, plan)``
signature (counterpart of ``repro.exec.engines``).

CNN engines (``kind="cnn"``): ``modules`` is the conv module list and the
plan partitions the input height ``plan.h0``; the returned ``apply(params,
x)`` is a drop-in trunk forward.  All six of the paper's strategies:
``base``, ``ckp``, ``overlap``, ``twophase``, ``overlap_h`` and
``twophase_h``; the carry-based ones (``twophase`` and the 2PS segments of
``twophase_h``) place their boundary caches by ``plan.residency``.

Sequence engines (``kind="seq"``): ``seq_chunked``, ``seq_carry_scan``
and ``seq_swa_overlap``.  Each takes two forms of ``modules``: the LM
stack as ``(params, ModelConfig)``, for which the builder returns the
plan-driven stack apply of :mod:`repro_torch.models.lm.rowexec`
(``apply(params, batch) -> (loss, aux)``), or a plain chunk-body callable
(a per-token fn, a scan body, an attend function), for which it returns
the :mod:`repro_torch.core.seqrow` apply of that shape.  The kernel-backed
engines live in :mod:`repro_torch.exec.kernel_engines`.
"""

from __future__ import annotations

from typing import List, Sequence

from repro_torch.core import overlap as _ov
from repro_torch.core import seqrow as _sr
from repro_torch.core import twophase as _tp
from repro_torch.core.hybrid import SegmentSpec, make_hybrid_apply
from repro_torch.exec.plan import ExecutionPlan
from repro_torch.exec.registry import register_engine


def _segment_specs(modules: Sequence, plan: ExecutionPlan,
                   inner: str) -> List[SegmentSpec]:
    """SegmentSpec list for the checkpointed engines: a pinned
    ``plan.segments`` verbatim, else the segmentation the planner
    estimates with (``derive_segments``), so estimate and execution
    cannot disagree."""
    from repro_torch.exec.planner import derive_segments
    segments = plan.segments or derive_segments(
        modules, plan.h0, inner, plan.n_rows, plan.n_segments)
    return [SegmentSpec(a, b, n, inner) for a, b, n in segments]


@register_engine("base", kind="cnn",
                 doc="column-centric reference (the paper's Base)")
def _build_base(modules, plan: ExecutionPlan):
    return _ov.make_column_apply(modules)


@register_engine("ckp", kind="cnn",
                 doc="sqrt(L) checkpointing, Chen et al. (the paper's Ckp)")
def _build_ckp(modules, plan: ExecutionPlan):
    return make_hybrid_apply(modules, plan.h0,
                             _segment_specs(modules, plan, "column"),
                             residency=plan.residency)


@register_engine("overlap", kind="cnn",
                 doc="OverL: replicated-halo rows, independent (Sec. IV-B)")
def _build_overlap(modules, plan: ExecutionPlan):
    return _ov.make_overlap_apply(modules, plan.h0, plan.n_rows,
                                  n_rows_bp=plan.get("n_rows_bp"))


@register_engine("twophase", kind="cnn",
                 doc="2PS: sequential rows with boundary cache (Sec. IV-A);"
                     " a row program — plan.residency places the SD caches")
def _build_twophase(modules, plan: ExecutionPlan):
    return _tp.make_twophase_apply(modules, plan.h0, plan.n_rows,
                                   residency=plan.residency)


@register_engine("overlap_h", kind="cnn",
                 doc="OverL-H: OverL rows inside sqrt(L) checkpoint segments")
def _build_overlap_h(modules, plan: ExecutionPlan):
    return make_hybrid_apply(modules, plan.h0,
                             _segment_specs(modules, plan, "overlap"),
                             residency=plan.residency)


@register_engine("twophase_h", kind="cnn",
                 doc="2PS-H: 2PS rows inside sqrt(L) checkpoint segments; "
                     "plan.residency places each segment's SD caches")
def _build_twophase_h(modules, plan: ExecutionPlan):
    return make_hybrid_apply(modules, plan.h0,
                             _segment_specs(modules, plan, "twophase"),
                             residency=plan.residency)


def _seq_modules(modules, plan: ExecutionPlan):
    """The LM stack apply when ``modules`` is ``(params, ModelConfig)``,
    else None (``modules`` is then a chunk-body callable)."""
    from repro_torch.models.lm.rowexec import build_lm_apply, lm_config
    cfg = lm_config(modules)
    return None if cfg is None else build_lm_apply(cfg, plan)


@register_engine("seq_chunked", kind="seq",
                 doc="halo-0 sequence chunks with per-chunk remat "
                     "(per-token layers); a carry-free row program")
def _build_seq_chunked(modules, plan: ExecutionPlan):
    lm = _seq_modules(modules, plan)
    if lm is not None:
        return lm
    return _sr.make_chunked_apply(modules, plan.n_rows,
                                  int(plan.get("axis", 1)),
                                  residency=plan.residency)


@register_engine("seq_carry_scan", kind="seq",
                 doc="2PS along the sequence: carried state as the named "
                     "boundary cache ('state'), placed by plan.residency")
def _build_seq_carry_scan(modules, plan: ExecutionPlan):
    lm = _seq_modules(modules, plan)
    if lm is not None:
        return lm
    return _sr.make_carry_scan_apply(modules, plan.n_rows,
                                     int(plan.get("axis", 1)),
                                     residency=plan.residency)


@register_engine("seq_swa_overlap", kind="seq",
                 doc="OverL along the sequence: replicated KV halo for "
                     "sliding-window attention; a carry-free row program")
def _build_seq_swa_overlap(modules, plan: ExecutionPlan):
    window = int(plan.get("window", 0))
    if window <= 0:
        raise ValueError("seq_swa_overlap plan needs a 'window' extra")
    lm = _seq_modules(modules, plan)
    if lm is not None:
        return lm
    return _sr.make_swa_overlap_apply(modules, window, plan.n_rows,
                                      residency=plan.residency)
