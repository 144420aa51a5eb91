"""Engine registry: one ``build_apply(modules, plan) -> apply_fn`` seam
between plans and row-centric mechanisms (counterpart of
``repro.exec.registry``).

Engines register under a string key with :func:`register_engine`.  Only the
engines ported so far are registered; asking for one of the reference's
other engines raises with the list of ported engines and says plainly that
the engine is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from repro_torch.exec.plan import ExecutionPlan

Builder = Callable[[Any, ExecutionPlan], Callable]

#: engines the reference registers that the port does not have yet, with
#: what each one waits for
NOT_PORTED = {
    "pipeline_rows": "exec/pipeline.py",
    "pipeline_seq": "exec/pipeline.py",
}


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    name: str
    kind: str           # "cnn" (modules = conv module list) | "seq"
    build: Builder
    doc: str = ""


_REGISTRY: Dict[str, EngineSpec] = {}


def register_engine(name: str, build: Optional[Builder] = None, *,
                    kind: str = "cnn", doc: str = ""):
    """Register ``build(modules, plan) -> apply_fn`` under ``name``; usable
    directly or as a decorator."""
    def _do(fn: Builder) -> Builder:
        if name in _REGISTRY:
            raise ValueError(f"engine {name!r} already registered")
        _REGISTRY[name] = EngineSpec(name, kind, fn, doc or (fn.__doc__ or ""))
        return fn

    return _do(build) if build is not None else _do


def not_ported_message(name: str) -> str:
    """The error text for an engine the registry does not know."""
    ported = ", ".join(list_engines())
    if name in NOT_PORTED:
        return (f"engine {name!r} is not ported yet (it needs "
                f"{NOT_PORTED[name]}); ported engines: {ported}")
    return f"unknown engine {name!r}; ported engines: {ported}"


def get_engine(name: str) -> EngineSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(not_ported_message(name)) from None


def list_engines(kind: Optional[str] = None) -> List[str]:
    return sorted(n for n, s in _REGISTRY.items()
                  if kind is None or s.kind == kind)


def build_apply(modules, plan: ExecutionPlan) -> Callable:
    """Resolve ``plan.engine`` in the registry and build its apply fn
    (``apply(params, x)`` for CNN engines; for seq engines given the LM
    form ``(params, cfg)``, ``apply(params, batch) -> (loss, aux)``).
    ``plan.residency`` travels to the engine: the carry-based engines run
    as row programs (:mod:`repro_torch.exec.rowprog`), which place their
    boundary caches by it.  Sharded plans are not ported yet and raise
    here."""
    spec = get_engine(plan.engine)
    if plan.mesh is not None and plan.mesh.n_devices > 1:
        raise NotImplementedError(
            f"sharded execution (mesh={plan.mesh.describe()}) is not "
            f"ported yet; run the plan on one device")
    return spec.build(modules, plan)
