"""2PS — Two-Phase Sharing row partitioning (LR-CNN Sec. IV-A), planning half.

Counterpart of the planning part of ``repro.core.twophase``: ownership
boundaries at every level from the ``in_end`` recursion, the cache heads
each row imports from the row above, and the validity bound on N.  The
memory model (:mod:`repro_torch.core.rowplan`) prices 2PS from these.  The
2PS executor (the reference's ``TwoPhaseRowProgram``) waits for the port of
``exec/rowprog.py``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from repro_torch.core.convmath import Interval, split_even
from repro_torch.models.cnn.layers import trunk_heights


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
