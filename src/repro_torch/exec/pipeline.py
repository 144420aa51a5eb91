"""Pipelined row execution: stage-parallel plans over the model axis
(counterpart of ``repro.exec.pipeline``).

LR-CNN's rows are weakly dependent across every conv layer, which makes a
row partition exactly the microbatch a GPipe-style schedule streams
through layer stages.  A :class:`~repro_torch.exec.plan.StageSpec` on the
plan records how the module trunk splits into S contiguous stages, and
:class:`PipelineRowProgram` runs the schedule as a row program over
ticks: tick ``t`` runs stage ``s`` on microbatch (row) ``r = t - s`` for
every live ``(s, r)`` pair, so the (stage x row) grid is swept in ``N + S
- 1`` ticks.  The boundary activations between stages are the program's
carries, named ``"stage_b{s}"``, so the shared executor
(:mod:`repro_torch.exec.rowprog`) places the GPipe stash by the plan's
residency (device, pinned host memory with prefetch, or recompute) and
drives the per-stage FP/BP with its row-centric backward.  Rows are OverL
interval chains (:mod:`repro_torch.core.overlap`): each microbatch owns a
disjoint interval of the final rows and carries its replicated-halo
closure through the stages, so the stage outputs compose to the exact
column-centric result.

The port's executor takes a flat tuple of carry tensors, so the carry
entering tick ``t`` holds only the slots that are live then (slot ``s``
when stage ``s`` ran at tick ``t - 1``), in slot order; the reference
keeps ``()`` in the dead slots.  The reference's ``_dep_barrier`` (an
``optimization_barrier`` that keeps XLA from running every stage-0 step
at once) has no counterpart: eager execution already runs the ticks, and
the stages within a tick, one after another.

Tensor parallelism stays out of this module: the shard wrapper
(:mod:`repro_torch.exec.engines`) splits the stage-local conv kernels
over the mesh's model axis; engines never see the mesh.

The backward departs from the reference's in how much it holds at once,
never in what it computes: the executor's default re-runs a whole tick
under ``enable_grad``, so every stage live in it would keep its graph
until the tick's gradients are taken, and a microbatch's closure through
the whole trunk can span most of an early stage's rows.  So the program
gives the executor its own row VJP (``row_vjp``): the stages of a tick
are backpropagated one after another, and a CNN stage in parts of the
Planner's stage-local rows — one stage row's working set at a time,
which is what ``Planner.estimate_staged`` prices.

With an obs session open each ``(stage, row)`` step the forward runs (the
sweep, and a recompute residency's regeneration) records a ``stage_row``
span, and the last tick records the measured bubble fraction of the
schedule grid (``(S-1)/(N+S-1)`` for the plain fill/drain ramp) as a
``pipeline_bubble`` event and the ``pipeline.bubble_fraction`` gauge.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from repro_torch import obs
from repro_torch.core.convmath import split_even
from repro_torch.core.overlap import plan_overlap
from repro_torch.core.seqrow import _chunk_slice
from repro_torch.exec.plan import ExecutionPlan, StageSpec
from repro_torch.exec.registry import register_engine
from repro_torch.exec.rowprog import RowProgram, make_rowprog_apply
from repro_torch.models.cnn.layers import (
    flatten_params, trunk_in_intervals, unflatten_params,
)


def resolve_stage_spec(n_modules: int, plan: ExecutionPlan) -> StageSpec:
    """The one rule turning a plan into a stage partition: an explicit
    ``plan.stage`` wins verbatim; otherwise S comes from the ``n_stages``
    extra, else the mesh's model extent, else 2 — capped at the module
    count so every stage is non-empty."""
    if plan.stage is not None:
        return plan.stage
    n = int(plan.get("n_stages", 0))
    if not n and plan.mesh is not None:
        n = plan.mesh.model
    n = max(1, min(n or 2, n_modules))
    return StageSpec.even(n_modules, n)


class _PipelineBase(RowProgram):
    """The tick machinery shared by the CNN and sequence pipelines."""

    returns_carry = False

    def __init__(self, n_microbatches: int, stage: StageSpec):
        self.n_microbatches = n_microbatches
        self.stage = stage
        #: executor rows == schedule ticks
        self.n_rows = n_microbatches + stage.n_stages - 1

    # -- schedule geometry ---------------------------------------------
    def _live(self, t: int, s: int) -> bool:
        return 0 <= t - s < self.n_microbatches

    def _slots(self, t: int):
        """Carry slots live entering tick ``t``."""
        return [s for s in range(self.stage.n_stages - 1)
                if self._live(t - 1, s)]

    def bubble_fraction(self) -> float:
        """Idle fraction of the (stage x tick) schedule grid, counted from
        the slots the sweep skips (== (S-1)/(N+S-1) for the plain
        fill/drain ramp)."""
        S = self.stage.n_stages
        total = S * self.n_rows
        busy = sum(1 for t in range(self.n_rows) for s in range(S)
                   if self._live(t, s))
        return (total - busy) / total

    # -- row-program protocol ------------------------------------------
    def init_carry(self, args):
        return ()

    def carry_names(self, t: int):
        return tuple(f"stage_b{s}" for s in self._slots(t))

    def _stage_apply(self, params, y, s: int, r: int):
        raise NotImplementedError

    def _row_input(self, row_args):
        """(params, this tick's fresh microbatch or None) from the row
        args."""
        raise NotImplementedError

    def row_step(self, carry, row_args, t: int):
        S, N = self.stage.n_stages, self.n_microbatches
        trace = obs.enabled()
        params, xr = self._row_input(row_args)
        slots = dict(zip(self._slots(t), carry))
        new_carry, y_out = [], None
        for s in range(S):
            r = t - s
            if not 0 <= r < N:
                continue
            if trace:
                obs.span("stage_row", tick=t, stage=s, row=r, n_stages=S,
                         n_rows=N)
            y = xr if s == 0 else slots[s - 1]
            y = self._stage_apply(params, y, s, r)
            if s == S - 1:
                y_out = y
            else:
                new_carry.append(y)
        if trace and t == self.n_rows - 1:
            bf = self.bubble_fraction()
            obs.event("pipeline_bubble", tick=t, n_stages=S,
                      n_microbatches=N, bubble_fraction=bf)
            obs.gauge("pipeline.bubble_fraction").set(bf)
        return tuple(new_carry), y_out

    def finish(self, ys: Sequence):
        # microbatch r's tile drains at tick (S - 1) + r
        return self._concat(ys[self.stage.n_stages - 1:])

    def _concat(self, tiles):
        raise NotImplementedError

    def row_vjp(self, carry, row_args, need, g, dcarry, t: int):
        """Tick ``t``'s VJP, stage by stage: the stages of a tick read
        different microbatches and share nothing but the parameters, so
        each one is recomputed and backpropagated, and its graph freed,
        before the next — one stage's working set is live, which is what
        the Planner prices per stage, where differentiating the whole
        tick would hold every live stage's at once."""
        S, N = self.stage.n_stages, self.n_microbatches
        slots_in = self._slots(t)
        inputs = dict(zip(slots_in, carry))
        out_slots = self._slots(t + 1)
        cots = dict(zip(out_slots, dcarry or [None] * len(out_slots)))
        drow = [None] * len(row_args)
        dcarry_in = {}
        for s in range(S):
            r = t - s
            if not 0 <= r < N:
                continue
            if s == S - 1:
                cot = None if g is None else self.out_cotangent(g, t)
            else:
                cot = cots.get(s)
            if cot is None:  # the stage's output is unused
                continue
            want_in = need[0] if s == 0 else True
            y_in = row_args[0] if s == 0 else inputs[s - 1]
            d_in, d_rest = self._stage_vjp(row_args, need, y_in, cot, s, r,
                                           want_in)
            if s == 0:
                drow[0] = d_in
            else:
                dcarry_in[s - 1] = d_in
            rest = drow[1:]
            _add_into(rest, d_rest)
            drow[1:] = rest
        return drow, [dcarry_in.get(s) for s in slots_in]

    def _stage_vjp(self, row_args, need, y_in, cot, s: int, r: int,
                   want_in: bool):
        """``(d y_in, d row_args[1:])`` of stage ``s`` on microbatch ``r``
        for the output cotangent ``cot``, by recomputing the stage."""
        rest = [None if a is None else a.detach().requires_grad_(n)
                for a, n in zip(row_args[1:], need[1:])]
        yi = y_in.detach().requires_grad_(want_in)
        params = self._row_input((None, *rest))[0]
        with torch.enable_grad(), obs.profile_range("row_recompute"):
            y = self._stage_apply(params, yi, s, r)
        return _grads(y, yi if want_in else None, rest, cot)


class PipelineRowProgram(_PipelineBase):
    """The CNN trunk pipelined over ``apply(x, *param_leaves)``:
    microbatches are OverL rows (replicated halo, independent), so stage
    ``s`` maps microbatch ``r``'s interval chain from level
    ``stage.stages[s][0]`` to ``stage.stages[s][1]`` through the modules'
    ``apply_row``, the sub-chain OverL's rows run — exactness per stage is
    exactness of the composition.

    A microbatch carries the closure of its final rows through the whole
    trunk, which at an early stage can span most of the image (all of it
    for ResNet-50 at 224²).  So a stage's backward runs in rows of its
    own: the stage's output level is split into N even rows, as the
    Planner splits it when it prices the stage (``estimate_staged``), and
    each part of the microbatch's output inside one of them is recomputed
    from its closure within the stage and backpropagated on its own (OverL
    inside the stage: exact, parts' input gradients added).  The forward
    runs each microbatch's stage whole, without a graph."""

    def __init__(self, modules: Sequence, plan: ExecutionPlan,
                 stage: Optional[StageSpec] = None, spec=None):
        stage = stage or resolve_stage_spec(len(modules), plan)
        if stage.n_modules != len(modules):
            raise ValueError(
                f"StageSpec covers {stage.n_modules} modules but the trunk "
                f"has {len(modules)}")
        super().__init__(max(1, plan.n_rows), stage)
        self.modules = list(modules)
        self.ov = plan_overlap(modules, plan.h0, self.n_microbatches)
        self.spec = spec  # the param leaves' structure (flatten_params)

    def _row_input(self, row_args):
        x_r, *leaves = row_args
        return unflatten_params(leaves, self.spec), x_r

    def row_args(self, args, t: int):
        x, *leaves = args
        if t >= self.n_microbatches:  # no microbatch enters stage 0
            return (None, *leaves)
        a, b = self.ov.chains[t][0]
        return (x[:, a:b], *leaves)

    def add_row_grad(self, dargs, drow, t: int) -> None:
        if t < self.n_microbatches and dargs[0] is not None \
                and drow[0] is not None:
            a, b = self.ov.chains[t][0]
            dargs[0][:, a:b] += drow[0]
        for acc, d in zip(dargs[1:], drow[1:]):
            if acc is not None and d is not None:
                acc += d

    def _stage_apply(self, params, y, s: int, r: int):
        a, b = self.stage.stages[s]
        chain, heights = self.ov.chains[r], self.ov.heights
        for l in range(a, b):
            y = self.modules[l].apply_row(params[l], y, chain[l],
                                          heights[l], chain[l + 1])
        return y

    def _concat(self, tiles):
        return torch.cat(tiles, dim=1)

    def out_cotangent(self, g, t: int):
        r = t - (self.stage.n_stages - 1)
        if r < 0:
            return None
        a, b = self.ov.row_ivs[r]
        return g[:, a:b]

    def _stage_vjp(self, row_args, need, y_in, cot, s: int, r: int,
                   want_in: bool):
        a, b = self.stage.stages[s]
        h, N = self.ov.heights, self.n_microbatches
        lo = self.ov.chains[r][a][0]  # y_in holds these rows of level a
        o_lo, o_hi = self.ov.chains[r][b]
        rest = [None if t is None else t.detach().requires_grad_(n)
                for t, n in zip(row_args[1:], need[1:])]
        params = unflatten_params(rest, self.spec)
        d_in = torch.zeros_like(y_in) if want_in else None
        d_rest = [None] * len(rest)
        for k_lo, k_hi in split_even(h[b], min(N, h[b])):
            p_lo, p_hi = max(o_lo, k_lo), min(o_hi, k_hi)
            if p_lo >= p_hi:
                continue
            ivs = trunk_in_intervals(self.modules[a:b], h[a], (p_lo, p_hi))
            i_lo, i_hi = ivs[0][0] - lo, ivs[0][1] - lo
            yi = y_in[:, i_lo:i_hi].detach().requires_grad_(want_in)
            with torch.enable_grad(), obs.profile_range("row_recompute"):
                y = yi
                for l in range(a, b):
                    y = self.modules[l].apply_row(params[l], y, ivs[l - a],
                                                  h[l], ivs[l - a + 1])
            d_yi, d_p = _grads(y, yi if want_in else None, rest,
                               cot[:, p_lo - o_lo:p_hi - o_lo])
            del y
            if d_yi is not None:
                d_in[:, i_lo:i_hi] += d_yi
            _add_into(d_rest, d_p)
        return d_in, d_rest


class SeqPipelineRowProgram(_PipelineBase):
    """The sequence-axis counterpart over ``apply(x)``: microbatches are
    halo-0 sequence chunks, stages are contiguous splits of a per-chunk
    layer stack (callables mapping one chunk to one chunk; per-token
    layers, so chunks stay independent, as in
    :class:`~repro_torch.core.seqrow.ChunkedRowProgram`).  A stage fn's
    own weights get no gradient: the executor differentiates its args
    only."""

    def __init__(self, fns: Sequence[Callable], n_chunks: int,
                 stage: StageSpec, axis: int = 1):
        if stage.n_modules != len(fns):
            raise ValueError(
                f"StageSpec covers {stage.n_modules} fns but the stack "
                f"has {len(fns)}")
        super().__init__(max(1, n_chunks), stage)
        self.fns = list(fns)
        self.axis = axis

    def _row_input(self, row_args):
        return None, row_args[0]

    def row_args(self, args, t: int):
        if t >= self.n_microbatches:
            return (None,)
        return (_chunk_slice(args[0], t, self.n_microbatches, self.axis),)

    def add_row_grad(self, dargs, drow, t: int) -> None:
        if t < self.n_microbatches and dargs[0] is not None \
                and drow[0] is not None:
            _chunk_slice(dargs[0], t, self.n_microbatches,
                         self.axis).add_(drow[0])

    def _stage_apply(self, params, y, s: int, r: int):
        a, b = self.stage.stages[s]
        for l in range(a, b):
            y = self.fns[l](y)
        return y

    def _concat(self, tiles):
        return torch.cat(tiles, dim=self.axis)

    def out_cotangent(self, g, t: int):
        r = t - (self.stage.n_stages - 1)
        if r < 0:
            return None
        return _chunk_slice(g, r, self.n_microbatches, self.axis)


def _grads(y, x, rest, cot):
    """``(d x, [d t for t in rest])`` of ``y`` against the cotangent
    ``cot`` (None for ``x`` None and for a ``rest`` entry that is None or
    takes no gradient)."""
    wrt = ([x] if x is not None else []) \
        + [t for t in rest if t is not None and t.requires_grad]
    it = iter(torch.autograd.grad(y, wrt, cot, allow_unused=True))
    dx = next(it) if x is not None else None
    return dx, [next(it) if t is not None and t.requires_grad else None
                for t in rest]


def _add_into(accs: list, grads) -> None:
    """``accs[i] += grads[i]``, taking the first gradient as its own
    accumulator."""
    for i, d in enumerate(grads):
        if d is not None:
            accs[i] = d if accs[i] is None else accs[i].add_(d)


# ---------------------------------------------------------------------------
# engine registrations: the same seam as every other engine
# ---------------------------------------------------------------------------


@register_engine("pipeline_rows", kind="cnn",
                 doc="GPipe-style row pipeline: N OverL rows stream "
                     "through S contiguous module stages (plan.stage); "
                     "boundary activations are row-program carries placed "
                     "by plan.residency")
def _build_pipeline_rows(modules, plan: ExecutionPlan):
    modules = tuple(modules)
    stage = resolve_stage_spec(len(modules), plan)

    def apply(params, x):
        leaves, spec = flatten_params(params)
        prog = PipelineRowProgram(modules, plan, stage, spec)
        return make_rowprog_apply(prog, plan.residency)(x, *leaves)

    return apply


@register_engine("pipeline_seq", kind="seq",
                 doc="sequence-axis pipeline: N halo-0 chunks stream "
                     "through S stages of a per-chunk layer stack; the "
                     "LM (params, cfg) form delegates to build_lm_apply")
def _build_pipeline_seq(modules, plan: ExecutionPlan):
    from repro_torch.exec.engines import _seq_modules
    lm = _seq_modules(modules, plan)
    if lm is not None:
        return lm
    fns = list(modules)
    prog = SeqPipelineRowProgram(fns, plan.n_rows,
                                 resolve_stage_spec(len(fns), plan),
                                 axis=int(plan.get("axis", 1)))
    return make_rowprog_apply(prog, plan.residency)
