"""OverL — overlapping row partitioning (LR-CNN Sec. IV-B).

Counterpart of ``repro.core.overlap``.  Each row owns a disjoint interval of
the final activation and receives the full receptive-field closure of it at
every level (Eq. 15 halo, replicated), so rows are independent.  The
forward pass runs row by row without recording a graph; the backward pass
re-partitions into ``n_rows_bp`` rows and recomputes one row at a time
under ``enable_grad``, so the live autograd state is one row's working set
(Eq. 7/8) instead of the whole network's (Eq. 3).

Exactness (DESIGN.md §2): output ownership is disjoint, so each row's
backward takes only its own slice of the cotangent, and the input
gradients of neighbouring rows — whose input intervals overlap — are
*added* into ``dx``.  The reference's ``lax.optimization_barrier`` between
rows has no counterpart: eager rows already run one after another.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.core.convmath import Interval, split_even
from repro_torch.models.cnn.layers import (
    apply_trunk, flatten_params, trunk_heights, trunk_in_intervals,
    unflatten_params,
)


@dataclasses.dataclass(frozen=True)
class OverlapPlan:
    """Static per-row interval chains for a trunk."""

    h0: int
    heights: Tuple[int, ...]
    row_ivs: Tuple[Interval, ...]              # final-level ownership
    chains: Tuple[Tuple[Interval, ...], ...]   # per row: ivs at levels 0..L

    @property
    def n_rows(self) -> int:
        return len(self.row_ivs)

    def overlap_rows_level0(self) -> List[int]:
        """Replicated input rows per seam (Eq. 15's o_r^0, measured)."""
        return [max(0, self.chains[r - 1][0][1] - self.chains[r][0][0])
                for r in range(1, self.n_rows)]


def plan_overlap(modules: Sequence, h0: int, n_rows: int) -> OverlapPlan:
    hs = trunk_heights(modules, h0)
    row_ivs = split_even(hs[-1], n_rows)
    chains = tuple(tuple(trunk_in_intervals(modules, h0, iv))
                   for iv in row_ivs)
    return OverlapPlan(h0, tuple(hs), tuple(row_ivs), chains)


def _run_row(modules, params, x_slice, chain, heights):
    y = x_slice
    for l, (m, p) in enumerate(zip(modules, params)):
        y = m.apply_row(p, y, chain[l], heights[l], chain[l + 1])
    return y


def overlap_forward(modules: Sequence, params, x, plan: OverlapPlan):
    """Row-by-row forward; concatenation of the disjoint final rows."""
    outs = []
    for chain in plan.chains:
        a, b = chain[0]
        outs.append(_run_row(modules, params, x[:, a:b], chain,
                             plan.heights))
    return torch.cat(outs, dim=1)


def _add_into(accs, grads) -> None:
    """``acc += d`` for each gradient that exists (a function, so that no
    loop variable keeps the last gradient alive)."""
    for acc, d in zip(accs, grads):
        if d is not None:
            acc += d


class _OverlapFunction(torch.autograd.Function):
    """Row-centric custom backward; saves only ``(params, x)``."""

    @staticmethod
    def forward(ctx, modules, plan_fp, plan_bp, spec, x, *leaves):
        ctx.modules, ctx.plan_bp, ctx.spec = modules, plan_bp, spec
        ctx.save_for_backward(x, *leaves)
        with torch.no_grad():
            return overlap_forward(modules, unflatten_params(leaves, spec),
                                   x, plan_fp)

    @staticmethod
    def backward(ctx, g):
        x, *leaves = ctx.saved_tensors
        plan = ctx.plan_bp
        want_x = ctx.needs_input_grad[4]
        # the first row's parameter gradients become the accumulators, and
        # each row's gradients are released before the next row is
        # recomputed: a zero-filled set of accumulators, or the previous
        # row's gradients kept alive by their variable, would add one
        # parameter-sized buffer to the backward's peak
        dleaves = None
        dx = torch.zeros_like(x) if want_x else None
        for r in range(plan.n_rows):
            chain = plan.chains[r]
            a, b = chain[0]
            p_r = [l.detach().requires_grad_() for l in leaves]
            xr = x[:, a:b].detach().requires_grad_(want_x)
            with torch.enable_grad(), obs.profile_range("row_recompute"):
                y = _run_row(ctx.modules, unflatten_params(p_r, ctx.spec),
                             xr, chain, plan.heights)
            os_, oe = plan.row_ivs[r]
            inputs = p_r + ([xr] if want_x else [])
            grads = torch.autograd.grad(y, inputs, g[:, os_:oe],
                                        allow_unused=True)
            del y
            if dleaves is None:
                dleaves = [torch.zeros_like(l) if d is None else d
                           for l, d in zip(leaves, grads[:len(leaves)])]
            else:
                _add_into(dleaves, grads[:len(leaves)])
            if want_x:
                dx[:, a:b] += grads[-1]
            del grads
        return (None, None, None, None, dx, *dleaves)


def make_overlap_apply(modules: Sequence, h0: int, n_rows_fp: int,
                       n_rows_bp: int | None = None):
    """Returns ``apply(params, x) -> z_L`` with the row-centric backward;
    FP uses ``n_rows_fp`` rows, BP re-partitions into ``n_rows_bp``
    (paper §III-C)."""
    n_rows_bp = n_rows_bp or n_rows_fp
    modules = tuple(modules)
    plan_fp = plan_overlap(modules, h0, n_rows_fp)
    plan_bp = plan_overlap(modules, h0, n_rows_bp)

    def apply(params, x):
        leaves, spec = flatten_params(params)
        return _OverlapFunction.apply(modules, plan_fp, plan_bp, spec, x,
                                      *leaves)

    return apply


def make_column_apply(modules: Sequence):
    """Column-centric reference (the paper's Base)."""

    def apply(params, x):
        return apply_trunk(modules, params, x)

    return apply


def make_splitcnn_apply(modules: Sequence, h0: int, n_rows: int):
    """Split-CNN [22]-style broken baseline for the Fig. 11 ablation: rows
    are processed independently with *closed* padding at seams and no halo
    — the paper's "feature loss" / "padding redundancy" pathologies.  The
    output height differs from the reference; callers need an H-agnostic
    head (e.g. global average pooling)."""

    def apply(params, x):
        outs = []
        for a, b in split_even(h0, n_rows):
            y = x[:, a:b]
            for m, p in zip(modules, params):
                y = m.apply(p, y)  # full padding everywhere == seam padding
            outs.append(y)
        return torch.cat(outs, dim=1)

    return apply
