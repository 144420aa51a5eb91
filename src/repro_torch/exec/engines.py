"""Built-in CNN engines behind the registry's ``build(modules, plan)``
signature (counterpart of ``repro.exec.engines``).

``modules`` is the conv module list and the plan partitions the input
height ``plan.h0``; the returned ``apply(params, x)`` is a drop-in trunk
forward.  Ported so far: ``base`` and ``overlap``; the kernel-backed
``overlap_cuda`` lives in :mod:`repro_torch.exec.kernel_engines`.
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
