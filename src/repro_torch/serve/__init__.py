"""repro_torch.serve — plan-driven continuous-batching inference
(counterpart of ``repro.serve``).

The serving transplant of LR-CNN's row-centric idea: the decode cache pool
is a fixed byte budget, decode slots are the rows, and the scheduler reuses
the budget across requests the way the trainer reuses it across row
partitions.  Layering::

    Request / traffic     (repro_torch.serve.request)   what arrives
      -> Scheduler        (repro_torch.serve.scheduler) when it runs
      -> ServeEngine      (repro_torch.serve.engine)    how it computes
      -> ExecutionPlan    (repro_torch.exec)            what fits

Policy comes from the Planner (``Planner.for_serve`` sizes the pool,
``Planner.for_model`` chunks each prefill); mechanism is the cache pool and
the per-family prefill and decode functions.  Typical use::

    from repro_torch.serve import make_requests, serve
    reqs = make_requests(16, cfg.vocab, traffic="poisson",
                         prompt_len=(16, 64), max_new_tokens=(8, 32),
                         mean_interarrival=2.0)
    report, plan = serve(params, cfg, reqs, budget=2 * 2**30)
    print(plan.describe(), report.summary())
"""

from repro_torch.serve.cache_pool import (
    CachePool, PagedCachePool, QuantCachePool, make_pool,
    register_cache_init, register_pool_kind,
)
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.pages import PageGeometry, PageManager
from repro_torch.serve.request import (
    Phase, Request, RequestState, make_requests,
)
from repro_torch.serve.scheduler import SLO, Scheduler, ServeReport, serve

__all__ = [
    "CachePool", "PagedCachePool", "QuantCachePool", "make_pool",
    "register_cache_init", "register_pool_kind", "ServeEngine",
    "PageGeometry", "PageManager", "Phase", "Request", "RequestState",
    "make_requests", "SLO", "Scheduler", "ServeReport", "serve",
]
