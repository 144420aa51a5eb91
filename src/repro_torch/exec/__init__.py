"""Plans, the engine registry, the engines, the Planner and its measured
costs (counterpart of ``repro.exec``).  Importing this package registers
every ported engine."""

from repro_torch.exec.costmodel import (
    CostTable, hardware_fingerprint, load_or_calibrate, register_cost_table,
    resolve_cost_table, trunk_fwd_flops,
)
from repro_torch.exec.plan import (
    ExecutionPlan, KernelSpec, MeshSpec, PlanRequest, ResidencySpec,
    StageSpec,
)
from repro_torch.exec.plancache import PlanCache, cached_plan, plan_cache_key
from repro_torch.exec.registry import (
    build_apply, get_engine, list_engines, register_engine,
)
from repro_torch.exec.rowprog import RowProgram, make_rowprog_apply
from repro_torch.exec import engines as _engines  # noqa: F401  (registers)
from repro_torch.exec import kernel_engines as _kernel_engines  # noqa: F401
from repro_torch.exec.planner import (
    BUDGET_PREFERENCE, CNN_ENGINES, CUDA_ALTERNATE, CUDA_ENGINES,
    RESIDENCY_ENGINES, Planner, kernelize_plan, segment_row_capacity,
)

__all__ = [
    "ExecutionPlan", "KernelSpec", "MeshSpec", "PlanRequest",
    "ResidencySpec", "StageSpec", "Planner", "build_apply", "get_engine",
    "list_engines", "register_engine", "kernelize_plan",
    "RowProgram", "make_rowprog_apply",
    "CNN_ENGINES", "BUDGET_PREFERENCE", "CUDA_ALTERNATE", "CUDA_ENGINES",
    "RESIDENCY_ENGINES", "segment_row_capacity",
    "CostTable", "hardware_fingerprint", "load_or_calibrate",
    "register_cost_table", "resolve_cost_table", "trunk_fwd_flops",
    "PlanCache", "cached_plan", "plan_cache_key",
]
