"""Row programs: the protocol behind every carry-based engine, and the one
executor that drives them all under a residency policy (counterpart of
``repro.exec.rowprog``).

LR-CNN's carry-based strategies (2PS rows, the 2PS segments of 2PS-H) share
one shape: an initial carry, a sequential sweep of row steps each of which
consumes the previous row's boundary caches and exports its own, and a
merge of the per-row outputs.  A :class:`RowProgram` names that shape:

* ``init_carry(args)``          — the carry entering row 0 (a tuple of
  tensors that carries no gradient; ``()`` for 2PS);
* ``row_args(args, r)``         — row ``r``'s inputs, one per arg: the arg
  itself or a slice of it;
* ``add_row_grad(dargs, drow, r)`` — the transpose of ``row_args``: add
  row ``r``'s input gradients into the args' gradients, a slice's into its
  interval.  Eager PyTorch has no linear transpose, so the program spells
  it out; it writes into one preallocated gradient per arg, where
  autograd through ``x[:, a:b]`` would allocate a full-size zero tensor
  per row;
* ``row_step(carry, row_args, r) -> (carry_out, y_r)`` — one row;
* ``finish(ys)``                — merge the per-row outputs;
* ``out_cotangent(g, r)``       — row ``r``'s slice of the output
  cotangent (the transpose of ``finish``);
* ``carry_names(r)``            — one name per carry leaf entering row
  ``r`` (or one string naming all), which a
  :class:`~repro_torch.exec.plan.ResidencySpec` targets.

:func:`make_rowprog_apply` turns a program into ``apply(*args)`` backed by
one ``torch.autograd.Function``: the forward sweeps the rows without a
graph and saves the args plus each row's incoming carry, placed by the
residency policy; the backward walks the rows in reverse, recomputes one
row at a time under ``enable_grad``, chains the carry cotangent and adds
the row's input gradients into the args' gradients.  Placement moves
bytes, never values:

* ``device``    — carries are kept as they are;
* ``host``      — each carry leaf is copied into pinned CPU memory on a
  side CUDA stream right after the producing row, and fetched back in the
  backward ``prefetch_depth`` rows ahead of the row that consumes it, so
  the copies overlap the rows in between; at most ``1 + prefetch_depth``
  fetched carries are live, which is what the planner prices;
* ``recompute`` — carries are dropped to zero-size sentinels and
  regenerated when consumed by re-running rows ``0..r-1`` without a graph
  (O(N²) row steps, no residency; one chain at a time).

On CPU tensors host residency is the reference's structural no-op
(:func:`offload_is_noop`): the schedule runs and no bytes move.  On CUDA
tensors a failure to pin or copy raises.  The reference's
``lax.optimization_barrier`` has no counterpart: eager order already
serialises the rows and the fetches.  Scan-shaped programs
(``returns_carry``, an initial carry differentiable in the args) are not
ported yet: they come with the ``seq_carry_scan`` engine.

Observability: with an obs session open (:mod:`repro_torch.obs`) the
executor emits the reference's records — an ``fp_row`` span per forward
row, ``offload`` / ``drop_recompute`` events per placed carry once the
sweep is done, and in the backward ``prefetch`` events, a ``bp_row`` span
per row and a ``recompute_chain`` event per regenerated carry — and counts
``rowprog.fp_rows``, ``bp_rows``, ``offload_bytes``, ``recompute_rows``,
``prefetches`` and ``prefetch_bytes``.  Events follow the placement
policy, so they are the same on CPU tensors, where no bytes move.  The
reference emits at jit trace time, once per compile; this eager executor
emits once per executed step.  Every site is guarded by
:func:`repro_torch.obs.enabled`.  Each recomputed row also runs inside a
``row_recompute`` profiler range (:func:`repro_torch.obs.profile_range`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.exec.plan import ResidencySpec


def offload_is_noop(device) -> bool:
    """True when host offload cannot leave the tensors' memory (CPU
    tensors): the policy is recorded and its schedule runs, but no bytes
    move."""
    return torch.device(device).type != "cuda"


class RowProgram:
    """Base class spelling out the row-program protocol (see the module
    docstring); ``n_rows`` is the row count."""

    n_rows: int = 1

    def init_carry(self, args) -> Tuple[torch.Tensor, ...]:
        return ()

    def carry_names(self, r: int):
        return ()

    def row_args(self, args, r: int) -> Tuple[torch.Tensor, ...]:
        raise NotImplementedError

    def add_row_grad(self, dargs: List[Optional[torch.Tensor]], drow,
                     r: int) -> None:
        raise NotImplementedError

    def row_step(self, carry, row_args, r: int):
        raise NotImplementedError

    def finish(self, ys: Sequence[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def out_cotangent(self, g: torch.Tensor, r: int) -> torch.Tensor:
        raise NotImplementedError


def _names_for(prog: RowProgram, carry, r: int) -> Tuple[str, ...]:
    names = prog.carry_names(r)
    if isinstance(names, str):
        return (names,) * len(carry)
    names = tuple(names)
    if len(names) != len(carry):
        raise ValueError(f"row {r}: carry_names() gave {len(names)} names "
                         f"for {len(carry)} carry leaves")
    return names


def rowprog_forward(prog: RowProgram, args, place=None):
    """Plain forward sweep.  With ``place(carry, r)`` also returns what it
    makes of the carry entering each row, called before that row runs
    (right after the row that produced it)."""
    trace = obs.enabled()
    carry = tuple(prog.init_carry(args))
    ys, placed = [], []
    for r in range(prog.n_rows):
        if trace:
            obs.span("fp_row", tick=r, n_rows=prog.n_rows,
                     carry_bytes=sum(int(t.nbytes) for t in carry))
            obs.counter("rowprog.fp_rows").inc()
        if place is not None:
            placed.append(place(carry, r))
        carry, y = prog.row_step(carry, prog.row_args(args, r), r)
        carry = tuple(carry)
        ys.append(y)
    out = prog.finish(ys)
    return out if place is None else (out, placed)


class _HostLink:
    """Pinned-host offload and fetch on one side CUDA stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.side = torch.cuda.Stream(device)

    def offload(self, t: torch.Tensor) -> torch.Tensor:
        current = torch.cuda.current_stream(self.device)
        self.side.wait_stream(current)  # the producing row first
        with torch.cuda.stream(self.side):
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
        t.record_stream(self.side)  # keep the source until the copy ends
        return h

    def fetch(self, h: torch.Tensor):
        """Issue the host-to-device copy; returns the device tensor and
        the event the consumer waits on."""
        current = torch.cuda.current_stream(self.device)
        d = torch.empty(h.shape, dtype=h.dtype, device=self.device)
        self.side.wait_stream(current)  # d's memory is free to write
        with torch.cuda.stream(self.side):
            d.copy_(h, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.side)
        return d, done


class _Placement:
    """Residency of one program's carries: place in the forward, fetch
    and regenerate in the backward."""

    def __init__(self, prog: RowProgram, res: ResidencySpec, device):
        self.prog, self.res = prog, res
        self.host = None
        #: (row, offloaded bytes, dropped bytes) per placed carry, kept
        #: for the obs events while a session is open
        self.moved: List[Tuple[int, int, int]] = []
        if not offload_is_noop(device) and (
                res.default == "host"
                or any(p == "host" for _, p in res.placements)):
            self.host = _HostLink(torch.device(device))

    def policies(self, carry, r: int) -> List[str]:
        return [self.res.placement(n)
                for n in _names_for(self.prog, carry, r)]

    def place(self, carry, r: int) -> tuple:
        out = []
        off = drop = 0
        for leaf, p in zip(carry, self.policies(carry, r)):
            if p == "host":
                off += int(leaf.nbytes)
                if self.host is not None:
                    leaf = self.host.offload(leaf)
            elif p == "recompute":
                drop += int(leaf.nbytes)
                leaf = leaf.new_empty((0,))
            out.append(leaf)
        if (off or drop) and obs.enabled():
            self.moved.append((r, off, drop))
        return tuple(out)

    def emit_moved(self) -> None:
        """The forward's placement events, in row order, after the sweep
        (where the reference's ``fwd`` places its carries)."""
        for r, off, drop in self.moved:
            if off:
                obs.event("offload", tick=r, bytes=off)
                obs.counter("rowprog.offload_bytes").inc(off)
            if drop:
                obs.event("drop_recompute", tick=r, bytes=drop)
        self.moved = []

    def host_bytes(self, saved, r: int) -> int:
        """Bytes of row ``r``'s host-placed leaves."""
        return sum(int(leaf.nbytes) for leaf, p in
                   zip(saved, self.policies(saved, r)) if p == "host")

    def fetch(self, saved, r: int):
        """Issue the copies of row ``r``'s host leaves; ``(leaves,
        events)``, other leaves passed through."""
        leaves, events = [], []
        for leaf, p in zip(saved, self.policies(saved, r)):
            if p == "host" and self.host is not None:
                leaf, done = self.host.fetch(leaf)
                events.append(done)
            leaves.append(leaf)
        return leaves, events

    def ready(self, fetched) -> list:
        leaves, events = fetched
        if events:
            current = torch.cuda.current_stream(self.host.device)
            for e in events:
                current.wait_event(e)
        return leaves

    def regenerate(self, leaves, args, r: int) -> tuple:
        """Substitute row ``r``'s recompute sentinels by re-running rows
        ``0..r-1`` without a graph."""
        policies = self.policies(leaves, r)
        if "recompute" not in policies:
            return tuple(leaves)
        if obs.enabled():
            obs.event("recompute_chain", tick=r, rows=r)
            obs.counter("rowprog.recompute_rows").inc(r)
        with torch.no_grad(), obs.profile_range("row_recompute"):
            carry = tuple(self.prog.init_carry(args))
            for rr in range(r):
                carry, _ = self.prog.row_step(
                    carry, self.prog.row_args(args, rr), rr)
        return tuple(c if p == "recompute" else leaf
                     for leaf, p, c in zip(leaves, policies, carry))


class _RowProgFunction(torch.autograd.Function):
    """The row-centric custom backward shared by every carry-based
    engine; saves the args and each row's placed incoming carry."""

    @staticmethod
    def forward(ctx, prog, res, *args):
        place = _Placement(prog, res, args[0].device)
        out, ctx.saved = rowprog_forward(prog, args, place.place)
        if obs.enabled():
            place.emit_moved()
        ctx.prog, ctx.place = prog, place
        ctx.save_for_backward(*args)
        return out

    @staticmethod
    def backward(ctx, g):
        prog, place, saved = ctx.prog, ctx.place, ctx.saved
        if saved is None:
            raise RuntimeError("the backward of a row program runs once: "
                               "it releases each row's carry as it goes")
        ctx.saved = None
        args = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        dargs = [torch.zeros_like(a) if n else None
                 for a, n in zip(args, need)]
        depth = place.res.prefetch_depth
        dcarry = None
        fetched = {}
        trace = obs.enabled()
        for r in range(prog.n_rows - 1, -1, -1):
            # ahead-of-use fetch of host carries: rows r .. r - depth
            for rr in range(r, max(-1, r - 1 - depth), -1):
                if rr not in fetched:
                    if trace and "host" in place.policies(saved[rr], rr):
                        nbytes = place.host_bytes(saved[rr], rr)
                        # depth = how many rows ahead of consumption the
                        # copy is issued (0 = demand fetch)
                        obs.event("prefetch", tick=r, row=rr, depth=r - rr,
                                  bytes=nbytes)
                        obs.counter("rowprog.prefetches").inc()
                        obs.counter("rowprog.prefetch_bytes").inc(nbytes)
                    fetched[rr] = place.fetch(saved[rr], rr)
                    saved[rr] = None
            leaves = place.ready(fetched.pop(r))
            if trace:
                obs.span("bp_row", tick=r, n_rows=prog.n_rows,
                         recomputes="recompute" in place.policies(leaves, r))
                obs.counter("rowprog.bp_rows").inc()
            carry_in = place.regenerate(leaves, args, r)
            c = [t.detach().requires_grad_() for t in carry_in]
            ra = [t.detach().requires_grad_(n) for t, n in
                  zip(prog.row_args(args, r), need)]
            with torch.enable_grad(), obs.profile_range("row_recompute"):
                carry_out, y = prog.row_step(tuple(c), tuple(ra), r)
            outs = [y]
            cots = [prog.out_cotangent(g, r)]
            if dcarry is not None:
                pairs = [(t, d) for t, d in zip(carry_out, dcarry)
                         if d is not None and t.requires_grad]
                outs += [t for t, _ in pairs]
                cots += [d for _, d in pairs]
                del pairs
            inputs = [t for t in ra if t.requires_grad] + c
            grads = torch.autograd.grad(outs, inputs, cots,
                                        allow_unused=True)
            it = iter(grads)
            drow = [next(it) if t.requires_grad else None for t in ra]
            dcarry = list(it)
            prog.add_row_grad(dargs, drow, r)
            # release this row's carry, recomputed outputs and input
            # gradients (now in dargs) before the next row is recomputed
            del grads, it, drow, outs, cots, carry_out, y, inputs, c, ra, \
                leaves, carry_in
        return (None, None, *dargs)


def make_rowprog_apply(prog: RowProgram,
                       residency: Optional[ResidencySpec] = None):
    """Build ``apply(*args)`` for a row program under a residency policy
    (``None`` keeps every carry on the device)."""
    res = residency or ResidencySpec()

    def apply(*args):
        return _RowProgFunction.apply(prog, res, *args)

    return apply
