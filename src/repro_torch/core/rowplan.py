"""Analytic memory model and row-granularity solvers (LR-CNN Secs. II-B,
III-C, IV).

Counterpart of ``repro.core.rowplan``: pure integer math over the module
list, kept identical so the port's plans price exactly as the reference's.

Implements:

* Eq. (3)  column-centric feature-map volume  Ω = Σ_l B·H^l·W^l·C^l
* Eq. (6)  per-row slice volume               ϱ_i^l = ϱ^l / N
* Eq. (7)  FP peak                            Ω_FP(N) = max_{l<L} ϱ^l/N + ϱ^L
* Eq. (8)  BP peak                            Ω_BP(N) = Σ_{l<L} ϱ^l/N + ϱ^L
* Eq. (9)/(10) minimal N_FP / N_BP under a budget M
* Eq. (12) 2PS solver with the greedy row-1 closure + cache cost
           B(N−1) Σ_l (k^l − s^l) W^l C^l
* Eq. (16) OverL solver with replicated-halo cost B(N−1) Σ_l o^l W^l C^l
* upper bounds: 2PS validity (cache within neighbour), OverL N ≤ H/o^0

All sizes in bytes.  Shapes are propagated through the actual module list,
so kernel/stride/padding asymmetries and pooling are exact, not the paper's
even-partition approximation.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.core import twophase as _tp
from repro_torch.core.convmath import ceil_div
from repro_torch.core.overlap import plan_overlap


def shape_chain(modules: Sequence, in_shape: Tuple[int, int, int]):
    """Per-level (H, W, C) including the input (length L+1)."""
    shapes = [in_shape]
    for m in modules:
        shapes.append(m.out_shape(shapes[-1]))
    return shapes


def feature_bytes(modules: Sequence, in_shape, batch: int,
                  dtype_bytes: int = 4) -> List[int]:
    """ϱ^l for l = 1..L (bytes)."""
    shapes = shape_chain(modules, in_shape)
    return [batch * h * w * c * dtype_bytes for (h, w, c) in shapes[1:]]


def omega_column(modules, in_shape, batch, dtype_bytes: int = 4) -> int:
    """Eq. (3)."""
    return sum(feature_bytes(modules, in_shape, batch, dtype_bytes))


def omega_fp(modules, in_shape, batch, n_rows, dtype_bytes: int = 4) -> int:
    """Eq. (7)."""
    rho = feature_bytes(modules, in_shape, batch, dtype_bytes)
    inner = max(rho[:-1]) if len(rho) > 1 else 0
    return ceil_div(inner, n_rows) + rho[-1]


def omega_bp(modules, in_shape, batch, n_rows, dtype_bytes: int = 4) -> int:
    """Eq. (8)."""
    rho = feature_bytes(modules, in_shape, batch, dtype_bytes)
    return ceil_div(sum(rho[:-1]), n_rows) + rho[-1]


def twophase_cache_row_bytes(modules, in_shape, batch, n_rows,
                             dtype_bytes: int = 4) -> List[int]:
    """Per-importing-row SD bytes (rows r = 1..N-1): what ONE row's
    boundary caches pin across all levels.  The residency-aware planner
    prices host offload / recompute with the *maximum* of these — the
    transit working set — instead of their sum (what device residency
    pins FP->BP)."""
    plan = _tp.module_boundaries(modules, in_shape[0], n_rows)
    shapes = shape_chain(modules, in_shape)
    out = []
    for row in plan.cache_sizes():
        total = 0
        for lvl, rows in enumerate(row):  # cache over activation level lvl
            _, w, c = shapes[lvl]
            total += batch * rows * w * c * dtype_bytes
        out.append(total)
    return out


def twophase_cache_level_bytes(modules, in_shape, batch, n_rows,
                               dtype_bytes: int = 4) -> List[int]:
    """The same SD volume per activation level (level 0 is the block's
    input), summed over the importing rows."""
    plan = _tp.module_boundaries(modules, in_shape[0], n_rows)
    shapes = shape_chain(modules, in_shape)
    out = [0] * len(shapes)
    for row in plan.cache_sizes():
        for lvl, rows in enumerate(row):
            _, w, c = shapes[lvl]
            out[lvl] += batch * rows * w * c * dtype_bytes
    return out


def twophase_cache_bytes(modules, in_shape, batch, n_rows,
                         dtype_bytes: int = 4) -> int:
    """Exact SD volume from the 2PS plan (paper approximates it as
    B(N−1)Σ(k−s)W C)."""
    return sum(twophase_cache_row_bytes(modules, in_shape, batch, n_rows,
                                        dtype_bytes))


def overlap_halo_bytes(modules, in_shape, batch, n_rows,
                       dtype_bytes: int = 4) -> int:
    """Exact replicated-halo volume at the input level and all intermediate
    levels (Eq. 15 aggregated)."""
    plan = plan_overlap(modules, in_shape[0], n_rows)
    shapes = shape_chain(modules, in_shape)
    total = 0
    for r in range(1, plan.n_rows):
        for lvl in range(len(shapes) - 1):
            prev_end = plan.chains[r - 1][lvl][1]
            cur_start = plan.chains[r][lvl][0]
            halo = max(0, prev_end - cur_start)
            _, w, c = shapes[lvl]
            total += batch * halo * w * c * dtype_bytes
    return total


@dataclasses.dataclass
class RowPlanResult:
    strategy: str
    n_rows: int
    est_bytes: int
    budget: int
    feasible: bool
    detail: dict


def estimate_bytes(modules, in_shape, batch, strategy: str, n_rows: int,
                   dtype_bytes: int = 4, xi: int = 0) -> int:
    """Peak-estimate for a strategy at granularity N (Eqs. 8/12/16 family).

    BP dominates (paper: Ω = Ω_BP), so the estimate is BP-phase."""
    base = omega_bp(modules, in_shape, batch, n_rows, dtype_bytes)
    if strategy in ("base", "ckp", "column"):
        return omega_column(modules, in_shape, batch, dtype_bytes) + xi
    if strategy == "twophase":
        return base + twophase_cache_bytes(modules, in_shape, batch, n_rows,
                                           dtype_bytes) + xi
    if strategy == "overlap":
        return base + overlap_halo_bytes(modules, in_shape, batch, n_rows,
                                         dtype_bytes) // max(1, n_rows) + xi
    raise ValueError(strategy)


def solve_n(modules, in_shape, batch, budget: int, strategy: str,
            dtype_bytes: int = 4, xi: int = 0, n_max: int = 64
            ) -> RowPlanResult:
    """min N s.t. estimate(N) + ξ < M, subject to validity bounds
    (Eqs. 9/10/12/16 + the Sec. IV upper bounds)."""
    h0 = in_shape[0]
    best: Optional[RowPlanResult] = None
    for n in range(1, n_max + 1):
        if strategy == "twophase" and n > 1:
            try:
                if not _tp.validate_plan(_tp.module_boundaries(modules, h0, n)):
                    break
            except ValueError:
                break
        if strategy == "overlap":
            try:
                plan_overlap(modules, h0, n)
            except ValueError:
                break
        est = estimate_bytes(modules, in_shape, batch, strategy, n,
                             dtype_bytes, xi)
        if est < budget:
            return RowPlanResult(strategy, n, est, budget, True,
                                 {"omega_bp": omega_bp(modules, in_shape,
                                                       batch, n, dtype_bytes)})
        best = RowPlanResult(strategy, n, est, budget, False, {})
        if strategy in ("base", "ckp", "column"):
            break
    return best if best is not None else RowPlanResult(
        strategy, 0, 0, budget, False, {"reason": "no valid N"})


def largest_batch(modules, in_shape, budget: int, strategy: str,
                  dtype_bytes: int = 4, xi: int = 0, n_max: int = 64,
                  b_max: int = 4096) -> Tuple[int, int]:
    """Largest batch size a strategy fits under ``budget`` (Fig. 6 metric).
    Returns (batch, n_rows used)."""
    lo, hi, best = 0, b_max, (0, 1)
    while lo <= hi:
        mid = (lo + hi) // 2
        if mid == 0:
            lo = 1
            continue
        r = solve_n(modules, in_shape, mid, budget, strategy, dtype_bytes,
                    xi, n_max)
        if r.feasible:
            best = (mid, r.n_rows)
            lo = mid + 1
        else:
            hi = mid - 1
    return best


def largest_image(modules_for_h, base_shape, batch, budget: int,
                  strategy: str, dtype_bytes: int = 4, xi: int = 0,
                  n_max: int = 64, h_max: int = 4096) -> Tuple[int, int]:
    """Largest square image dimension under ``budget`` (Fig. 7 metric).

    ``modules_for_h(h)`` builds the module list for input (h, h, C)."""
    h = base_shape[0]
    best = (0, 1)
    step = 32
    while h <= h_max:
        modules = modules_for_h(h)
        shape = (h, h, base_shape[2])
        try:
            r = solve_n(modules, shape, batch, budget, strategy,
                        dtype_bytes, xi, n_max)
        except ValueError:
            break
        if r.feasible:
            best = (h, r.n_rows)
            h += step
        else:
            break
    return best
