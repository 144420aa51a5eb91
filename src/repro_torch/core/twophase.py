"""2PS — Two-Phase Sharing row partitioning (LR-CNN Sec. IV-A).

Counterpart of ``repro.core.twophase``.  Rows are scheduled sequentially;
every straddling receptive field is owned by the *lower* row, which
consumes the cached bottom-boundary rows of the row above (the paper's
"sharing data", SD) instead of recomputing them.  Planning: ownership
boundaries at every level from the ``in_end`` recursion, the cache heads
each row imports, and the validity bound on N; the memory model
(:mod:`repro_torch.core.rowplan`) prices 2PS from these.  Execution:
:class:`TwoPhaseRowProgram`, a row program whose carry IS the SD cache, run
by the shared executor (:mod:`repro_torch.exec.rowprog`) under the plan's
residency.

The boundary cache a row exports is a slice of that level's whole row
activation.  In PyTorch a slice is a view and saving it keeps the whole
activation alive, so the export is a ``.clone()`` (at batch 1 an H-slice of
NHWC is already contiguous and ``.contiguous()`` would return the view).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from repro_torch.core.convmath import Interval, split_even
from repro_torch.exec.rowprog import RowProgram, make_rowprog_apply
from repro_torch.models.cnn.layers import (
    flatten_params, trunk_heights, unflatten_params,
)


@dataclasses.dataclass(frozen=True)
class TwoPhasePlan:
    h0: int
    heights: Tuple[int, ...]
    bounds: Tuple[Tuple[int, ...], ...]   # bounds[l][r], l = 0..L, r = 0..N
    need_lo: Tuple[Tuple[int, ...], ...]  # [l-1][r]: first input row of
                                          # level l-1 row r needs at module l

    @property
    def n_rows(self) -> int:
        return len(self.bounds[0]) - 1

    @property
    def n_levels(self) -> int:
        return len(self.bounds) - 1

    def row_iv(self, l: int, r: int) -> Interval:
        return (self.bounds[l][r], self.bounds[l][r + 1])

    def cache_head(self, l: int, r: int) -> Interval:
        """Rows of activation level ``l-1`` row ``r`` imports from row
        r-1's cache (empty for r = 0)."""
        return (self.need_lo[l - 1][r], self.bounds[l - 1][r])

    def cache_sizes(self) -> List[List[int]]:
        """cache[r][l-1] sizes for r >= 1 — the paper's (k-s)·W volume."""
        return [[self.bounds[l - 1][r] - self.need_lo[l - 1][r]
                 for l in range(1, self.n_levels + 1)]
                for r in range(1, self.n_rows)]


def module_boundaries(modules: Sequence, h0: int, n_rows: int) -> TwoPhasePlan:
    hs = trunk_heights(modules, h0)
    L = len(modules)
    top = split_even(hs[-1], n_rows)
    bounds = [[iv[0] for iv in top] + [hs[-1]]]
    for l in range(L - 1, -1, -1):
        m = modules[l]
        above = bounds[-1]
        cur = [0]
        for r in range(1, n_rows):
            b = above[r]
            e = m.in_interval((max(0, b - 1), b), hs[l])[1] if b > 0 else 0
            cur.append(min(e, hs[l]))
        cur.append(hs[l])
        for r in range(1, n_rows + 1):  # monotonicity for degenerate cases
            cur[r] = max(cur[r], cur[r - 1])
        bounds.append(cur)
    bounds.reverse()

    need_lo: List[List[int]] = []
    for l in range(1, L + 1):
        m = modules[l - 1]
        row = []
        for r in range(n_rows):
            iv = (bounds[l][r], bounds[l][r + 1])
            row.append(bounds[l - 1][r] if iv[0] >= iv[1]
                       else m.in_interval(iv, hs[l - 1])[0])
        need_lo.append(row)
    return TwoPhasePlan(h0, tuple(hs), tuple(map(tuple, bounds)),
                        tuple(map(tuple, need_lo)))


def validate_plan(plan: TwoPhasePlan) -> bool:
    """Cache heads come from the immediately preceding row and every row's
    territory is non-empty at every level (the granularity bound)."""
    for l in range(plan.n_levels + 1):
        for r in range(plan.n_rows):
            if plan.bounds[l][r + 1] <= plan.bounds[l][r]:
                return False
    for l in range(1, plan.n_levels + 1):
        for r in range(1, plan.n_rows):
            lo, hi = plan.cache_head(l, r)
            if lo < plan.bounds[l - 1][r - 1] or hi < lo:
                return False
    return True


def max_valid_rows(modules: Sequence, h0: int, limit: int = 64) -> int:
    best = 1
    for n in range(2, limit + 1):
        try:
            if not validate_plan(module_boundaries(modules, h0, n)):
                break
        except ValueError:
            break
        best = n
    return best


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------


def _run_row(modules, params, plan: TwoPhasePlan, r: int, x_r, caches_in):
    """Run row r through all modules.

    ``x_r`` covers input rows ``[need_lo[0][r], bounds[0][r+1])``;
    ``caches_in`` holds the imported boundary activations of levels
    1..L-1 (possibly zero-height).  Returns (final rows, caches_out), where
    caches_out exports this row's boundary rows for row r+1 as copies."""
    hs = plan.heights
    act = x_r
    caches_out = []
    for l in range(1, plan.n_levels + 1):
        m = modules[l - 1]
        out_iv = plan.row_iv(l, r)
        in_iv = (plan.need_lo[l - 1][r], m.in_interval(out_iv, hs[l - 1])[1])
        if l == 1:
            x_in = act[:, :in_iv[1] - plan.need_lo[0][r]]
        else:
            own_lo = plan.bounds[l - 1][r]
            own = act[:, :in_iv[1] - own_lo]
            head_n = own_lo - in_iv[0]
            # the level l-1 import: cache_head(l, r)
            x_in = torch.cat([caches_in[l - 2], own], dim=1) if head_n > 0 \
                else own
        y = m.apply_row(params[l - 1], x_in, in_iv, hs[l - 1], out_iv)
        # export row r+1's head of level l-1; it lies within this row's
        # own rows by construction
        if l >= 2 and r + 1 < plan.n_rows:
            nlo = plan.need_lo[l - 1][r + 1]
            off = nlo - plan.bounds[l - 1][r]
            assert off >= 0, (l, r, nlo, plan.bounds[l - 1][r])
            n = plan.bounds[l - 1][r + 1] - nlo
            caches_out.append(act[:, off:off + n].clone())
        act = y
    return act, caches_out


def _x_slice(plan: TwoPhasePlan, r: int, x):
    return x[:, plan.need_lo[0][r]:plan.bounds[0][r + 1]]


def twophase_forward(modules: Sequence, params, x, plan: TwoPhasePlan,
                     return_caches: bool = False):
    caches: List = []
    outs = []
    caches_in: List = []
    for r in range(plan.n_rows):
        y, caches_out = _run_row(modules, params, plan, r,
                                 _x_slice(plan, r, x), caches_in)
        outs.append(y)
        caches.append(caches_in)
        caches_in = caches_out
    z = torch.cat(outs, dim=1)
    return (z, caches) if return_caches else z


class TwoPhaseRowProgram(RowProgram):
    """2PS as a row program: the carry between rows is the SD boundary
    cache, one activation slab per level ``l`` in ``1..L-1`` named
    ``"sd_l{l}"`` so a ResidencySpec can place each level.  Args are ``(x,
    *param_leaves)``; row ``r`` sees ``x``'s rows ``[need_lo[0][r],
    bounds[0][r+1])`` and every leaf whole."""

    def __init__(self, modules: Sequence, plan: TwoPhasePlan, spec):
        self.modules = modules
        self.plan = plan
        self.spec = spec
        self.n_rows = plan.n_rows

    def carry_names(self, r: int):
        if r == 0:
            return ()
        return tuple(f"sd_l{lvl}" for lvl in range(1, self.plan.n_levels))

    def row_args(self, args, r: int):
        return (_x_slice(self.plan, r, args[0]),) + tuple(args[1:])

    def add_row_grad(self, dargs, drow, r: int) -> None:
        if dargs[0] is not None and drow[0] is not None:
            dargs[0][:, self.plan.need_lo[0][r]:
                     self.plan.bounds[0][r + 1]] += drow[0]
        for acc, d in zip(dargs[1:], drow[1:]):
            if acc is not None and d is not None:
                acc += d

    def row_step(self, carry, row_args, r: int):
        x_r, *leaves = row_args
        y, caches_out = _run_row(self.modules,
                                 unflatten_params(leaves, self.spec),
                                 self.plan, r, x_r, list(carry))
        return tuple(caches_out), y

    def finish(self, ys):
        return torch.cat(ys, dim=1)

    def out_cotangent(self, g, r: int):
        os_, oe = self.plan.row_iv(self.plan.n_levels, r)
        return g[:, os_:oe]


def make_twophase_apply(modules: Sequence, h0: int, n_rows: int,
                        residency=None):
    """Returns ``apply(params, x) -> z_L`` with the 2PS row-centric
    backward, run as a row program so ``residency`` (a
    :class:`~repro_torch.exec.plan.ResidencySpec`, or None for
    device-resident) places the inter-row boundary caches."""
    modules = tuple(modules)
    plan = module_boundaries(modules, h0, n_rows)
    if not validate_plan(plan):
        raise ValueError(
            f"2PS plan with N={n_rows} invalid for H0={h0} over "
            f"{len(modules)} modules (granularity bound exceeded; use "
            f"hybrid checkpointing)")

    def apply(params, x):
        leaves, spec = flatten_params(params)
        prog = TwoPhaseRowProgram(modules, plan, spec)
        return make_rowprog_apply(prog, residency)(x, *leaves)

    return apply
