"""Plans, the engine registry, the engines and the Planner (counterpart of
``repro.exec``).  Importing this package registers every ported engine."""

from repro_torch.exec.plan import (
    ExecutionPlan, KernelSpec, MeshSpec, PlanRequest, ResidencySpec,
    StageSpec,
)
from repro_torch.exec.registry import (
    build_apply, get_engine, list_engines, register_engine,
)
from repro_torch.exec import engines as _engines  # noqa: F401  (registers)
from repro_torch.exec import kernel_engines as _kernel_engines  # noqa: F401
from repro_torch.exec.planner import Planner, kernelize_plan

__all__ = [
    "ExecutionPlan", "KernelSpec", "MeshSpec", "PlanRequest",
    "ResidencySpec", "StageSpec", "build_apply", "get_engine",
    "list_engines", "register_engine", "Planner", "kernelize_plan",
]
