"""Built-in engines behind the registry's ``build(modules, plan)``
signature (counterpart of ``repro.exec.engines``).

CNN engines (``kind="cnn"``): ``modules`` is the conv module list and the
plan partitions the input height ``plan.h0``; the returned ``apply(params,
x)`` is a drop-in trunk forward.  Ported: ``base`` and ``overlap``.

Sequence engines (``kind="seq"``), in their LM form: ``modules`` is
``(params, ModelConfig)`` and the builder returns the plan-driven stack
apply of :mod:`repro_torch.models.lm.rowexec` (``apply(params, batch) ->
(loss, aux)``).  Ported: ``seq_chunked`` and ``seq_swa_overlap``; their
op-level forms (a plain chunk-body callable as ``modules``) are not ported
yet.  The kernel-backed engines live in
:mod:`repro_torch.exec.kernel_engines`.
"""

from __future__ import annotations

from repro_torch.core import overlap as _ov
from repro_torch.exec.plan import ExecutionPlan
from repro_torch.exec.registry import register_engine


@register_engine("base", kind="cnn",
                 doc="column-centric reference (the paper's Base)")
def _build_base(modules, plan: ExecutionPlan):
    return _ov.make_column_apply(modules)


@register_engine("overlap", kind="cnn",
                 doc="OverL: replicated-halo rows, independent (Sec. IV-B)")
def _build_overlap(modules, plan: ExecutionPlan):
    return _ov.make_overlap_apply(modules, plan.h0, plan.n_rows,
                                  n_rows_bp=plan.get("n_rows_bp"))


def _seq_modules(modules, plan: ExecutionPlan):
    """The LM stack apply when ``modules`` is ``(params, ModelConfig)``,
    else None."""
    from repro_torch.models.lm.rowexec import build_lm_apply, lm_config
    cfg = lm_config(modules)
    return None if cfg is None else build_lm_apply(cfg, plan)


def _lm_form(name: str, modules, plan: ExecutionPlan):
    lm = _seq_modules(modules, plan)
    if lm is None:
        raise NotImplementedError(
            f"the op-level form of {name!r} (a chunk-body callable as "
            f"modules) is not ported yet; pass the LM form (params, cfg)")
    return lm


@register_engine("seq_chunked", kind="seq",
                 doc="halo-0 sequence chunks with per-chunk remat "
                     "(per-token layers)")
def _build_seq_chunked(modules, plan: ExecutionPlan):
    return _lm_form("seq_chunked", modules, plan)


@register_engine("seq_swa_overlap", kind="seq",
                 doc="OverL along the sequence: replicated KV halo for "
                     "sliding-window attention")
def _build_seq_swa_overlap(modules, plan: ExecutionPlan):
    if int(plan.get("window", 0)) <= 0:
        raise ValueError("seq_swa_overlap plan needs a 'window' extra")
    return _lm_form("seq_swa_overlap", modules, plan)
