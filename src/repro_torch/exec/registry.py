"""Engine registry: one ``build_apply(modules, plan) -> apply_fn`` seam
between plans and row-centric mechanisms (counterpart of
``repro.exec.registry``).

Engines register under a string key with :func:`register_engine`; asking
for an unknown one raises with the list of ported engines (and what an
engine in :data:`NOT_PORTED` waits for).

Sharding is layered here, not in the engines: when ``plan.mesh`` spans
more than one device, :func:`build_apply` wraps the engine's apply in the
mesh-aware outer layer registered for the engine's *kind* with
:func:`register_shard_wrapper` (:mod:`repro_torch.exec.engines` registers
the ``cnn`` and ``seq`` ones).  Engines stay single-device code: each
rank runs one on its own shard and the wrapper puts the collectives at
its edges.  A kind without a wrapper passes through untouched, and so
does an apply that says it places itself (``handles_mesh``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from repro_torch.exec.plan import ExecutionPlan

Builder = Callable[[Any, ExecutionPlan], Callable]

#: engines the reference registers that the port does not have yet, with
#: what each one waits for (none since the row pipeline came over)
NOT_PORTED: Dict[str, str] = {}

#: wrap(inner_apply, plan, modules, rebuild) -> sharded_apply, keyed by
#: EngineSpec.kind: the reference's (inner_apply, plan), plus the modules
#: the engine was built over and ``rebuild(modules)``, which builds the
#: same engine over others (the model axis hands it column-parallel convs)
ShardWrapper = Callable[[Callable, ExecutionPlan, Any, Callable], Callable]


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


_SHARD_WRAPPERS: Dict[str, ShardWrapper] = {}


def register_shard_wrapper(kind: str, wrap: Optional[ShardWrapper] = None):
    """Register the mesh-aware outer layer for every engine of ``kind``:
    ``wrap(inner_apply, plan, modules, rebuild)`` returns an apply that
    runs the engine over ``plan.mesh``.  One wrapper makes every engine of its
    kind shardable; no engine sees the mesh."""
    def _do(fn: ShardWrapper) -> ShardWrapper:
        if kind in _SHARD_WRAPPERS:
            raise ValueError(f"shard wrapper for kind {kind!r} already "
                             f"registered")
        _SHARD_WRAPPERS[kind] = fn
        return fn

    return _do(wrap) if wrap is not None else _do


def build_apply(modules, plan: ExecutionPlan) -> Callable:
    """Resolve ``plan.engine`` in the registry and build its apply fn
    (``apply(params, x)`` for CNN engines; for seq engines given the LM
    form ``(params, cfg)``, ``apply(params, batch) -> (loss, aux)``).
    ``plan.residency`` travels to the engine: the carry-based engines run
    as row programs (:mod:`repro_torch.exec.rowprog`), which place their
    boundary caches by it.  When ``plan.mesh`` spans more than one device
    the apply is wrapped in its kind's shard wrapper, so the plan that
    solved the per-device budget also pins how the batch and the
    parameters map onto the ranks."""
    spec = get_engine(plan.engine)
    inner = spec.build(modules, plan)
    if getattr(inner, "handles_mesh", False):
        return inner
    if plan.mesh is None or plan.mesh.n_devices <= 1:
        return inner
    wrap = _SHARD_WRAPPERS.get(spec.kind)
    if wrap is None:
        return inner  # the kind consumes plan.mesh itself
    return wrap(inner, plan, modules, lambda mods: spec.build(mods, plan))
