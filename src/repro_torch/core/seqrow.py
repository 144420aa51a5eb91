"""Row-centric execution transplanted to sequence models (counterpart of
``repro.core.seqrow``).

LR-CNN partitions the spatial axis of activations, schedules compute row by
row, recomputes per row in BP, and handles row seams either by carrying
boundary data (2PS) or replicating a halo (OverL).  For sequence models the
spatial axis is the *sequence* axis:

* per-token layers (MLP, norms): halo 0 — :func:`chunked_apply` (exact, a
  pure activation-memory win);
* sliding-window attention (window w): a weak dependency of extent w —
  :func:`swa_overlap_chunks` (OverL: a replicated w-token K/V halo, chunks
  independent);
* recurrent scans (Mamba2, mLSTM, sLSTM): the carried state *is* the 2PS
  boundary cache — :func:`carry_scan_remat` (sequential chunks, exact, no
  redundancy);
* full attention and the LM head keep column semantics, the carve-out the
  paper makes for FC layers.

Each helper runs its chunk body under ``torch.utils.checkpoint``
(``use_reentrant=False``), so BP recomputes one chunk at a time — the BP
half of Alg. 1; where the reference ``lax.scan``s a checkpointed body, the
port loops over the chunks in Python and threads the carry through.

Their row-program forms (:class:`ChunkedRowProgram`,
:class:`CarryScanRowProgram`, :class:`StackedCarryScanRowProgram`,
:class:`SwaOverlapRowProgram` and the ``make_*_apply`` makers) are the same
math with the carry *named* (``"state"``), driven by the shared executor
(:mod:`repro_torch.exec.rowprog`), which places the carried state by a
:class:`~repro_torch.exec.plan.ResidencySpec`.  As in the reference, only a
spec that moves a cache off the device builds the executor; otherwise the
makers return the checkpointed loop.

The executor takes flat tensor args, so the carry-scan programs flatten
their ``(carry, xs[, consts])`` pytrees (tensors, or tuples of them) in
:meth:`CarryScanRowProgram.flatten` and give the body the structures back.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree
from torch.utils.checkpoint import checkpoint


def _split_chunks(x, n_chunks: int, axis: int):
    s = x.shape[axis]
    assert s % n_chunks == 0, f"seq {s} not divisible by {n_chunks} chunks"
    return x.reshape(x.shape[:axis] + (n_chunks, s // n_chunks)
                     + x.shape[axis + 1:])


def chunked_apply(fn: Callable, x, n_chunks: int, axis: int = 1):
    """Apply a per-token ``fn`` over ``n_chunks`` sequence chunks, each
    under ``torch.utils.checkpoint`` (the reference's
    ``lax.map(jax.checkpoint(fn))``).

    Equal to ``fn(x)`` for any fn that acts independently per position
    along ``axis``; the live hidden inside fn drops by ~n_chunks (Eq. 7
    with halo 0).  Falls back to ``fn(x)`` when ``n_chunks`` does not
    divide the axis, as the reference does."""
    if n_chunks <= 1 or x.shape[axis] % n_chunks:
        return fn(x)
    chunks = torch.chunk(x, n_chunks, dim=axis)
    return torch.cat([checkpoint(fn, c, use_reentrant=False)
                      for c in chunks], dim=axis)


def _scan_checkpointed(body: Callable, carry, xs, n_rows: int):
    """``lax.scan(jax.checkpoint(body), carry, xs)`` over leading-axis
    stacked ``xs`` (a tensor or a tuple of them): one checkpointed body
    call per row, the carry threaded through; returns ``(carry, stacked
    outputs)``, the body's per-row output being one tensor."""
    ys = []
    for r in range(n_rows):
        x_r = pytree.tree_map(lambda u: u[r], xs)
        carry, y = checkpoint(body, carry, x_r, use_reentrant=False)
        ys.append(y)
    return carry, torch.stack(ys)


def carry_scan_remat(body: Callable, carry_init, xs, n_chunks: int,
                     axis: int = 1):
    """2PS along the sequence: ``body(carry, chunk) -> (carry, out)`` run
    over ``n_chunks`` chunks of ``xs`` along ``axis`` with per-chunk
    recomputation.  The carry (the recurrent state) plays the role of the
    2PS boundary cache: computed once, handed to the next row, re-used in
    BP.  Returns ``(carry, out)``, ``out`` merged along ``axis``."""
    xc = torch.movedim(_split_chunks(xs, n_chunks, axis), axis, 0)
    carry, yc = _scan_checkpointed(body, carry_init, xc, n_chunks)
    yc = torch.movedim(yc, 0, axis)
    return carry, yc.reshape(xs.shape[:axis] + (xs.shape[axis],)
                             + yc.shape[axis + 2:])


def swa_overlap_chunks(attend: Callable, q, k, v, window: int,
                       n_chunks: int):
    """OverL along the sequence for causal sliding-window attention.

    ``attend(qc, kc, vc, q_offset, k_offset)`` computes attention of a
    query chunk against a key/value slab, masking (causal + window) from
    the global offsets.  Each query chunk ``[a, b)`` reads the replicated
    halo ``[a - window, b)`` of K/V, so chunks are independent, the LR-CNN
    OverL pattern.  q, k, v: (B, S, H, D) with the same S; returns
    (B, S, Hq, D)."""
    S = q.shape[1]
    assert S % n_chunks == 0
    c = S // n_chunks
    halo = min(window, S)  # replicated lookback
    # left-pad K/V so every chunk takes a slab of one size
    kp = F.pad(k, (0, 0, 0, 0, halo, 0))
    vp = F.pad(v, (0, 0, 0, 0, halo, 0))
    outs = []
    for i in range(n_chunks):
        a = i * c
        body = functools.partial(attend, q_offset=a, k_offset=a - halo)
        outs.append(checkpoint(body, q[:, a:a + c], kp[:, a:a + c + halo],
                               vp[:, a:a + c + halo], use_reentrant=False))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Row-program forms (repro_torch.exec.rowprog): the carry made explicit
# ---------------------------------------------------------------------------


def _chunk_slice(x, r: int, n_chunks: int, axis: int):
    s = x.shape[axis]
    assert s % n_chunks == 0, f"seq {s} not divisible by {n_chunks} chunks"
    c = s // n_chunks
    return x.narrow(axis, r * c, c)


class ChunkedRowProgram:
    """Halo-0 sequence chunks (:func:`chunked_apply`'s math) as a row
    program over ``apply(x)``: no carry, so BP's per-chunk recompute comes
    from the shared executor instead of ``torch.utils.checkpoint``."""

    returns_carry = False

    def __init__(self, fn: Callable, n_chunks: int, axis: int = 1):
        self.fn = fn
        self.n_rows = n_chunks
        self.axis = axis

    def init_carry(self, args):
        return ()

    def carry_names(self, r):
        return ()

    def row_args(self, args, r):
        return (_chunk_slice(args[0], r, self.n_rows, self.axis),)

    def add_row_grad(self, dargs, drow, r):
        if dargs[0] is not None and drow[0] is not None:
            _chunk_slice(dargs[0], r, self.n_rows, self.axis).add_(drow[0])

    def row_step(self, carry, row_args, r):
        return (), self.fn(row_args[0])

    def finish(self, ys):
        return torch.cat(ys, dim=self.axis)

    def out_cotangent(self, g, r):
        return _chunk_slice(g, r, self.n_rows, self.axis)


class CarryScanRowProgram:
    """2PS along the sequence (:func:`carry_scan_remat`'s math) as a row
    program over ``apply(carry_init, xs)``: the recurrent state is the
    named boundary cache (``"state"``), so a ResidencySpec can offload or
    recompute it.  ``xs`` is one tensor chunked along ``axis``.

    The executor's args are flat: :meth:`flatten` lays them out as the
    initial carry's leaves, then ``xs``'s, then (for
    :class:`StackedCarryScanRowProgram` with consts) the consts' leaves,
    and records the structures that :meth:`row_step` rebuilds for the
    body."""

    returns_carry = True
    with_consts = False

    def __init__(self, body: Callable, n_chunks: int, axis: int = 1):
        self.body = body
        self.n_rows = n_chunks
        self.axis = axis

    # -- flat args ------------------------------------------------------
    def flatten(self, carry, xs, consts=()) -> tuple:
        c, self._carry_spec = pytree.tree_flatten(carry)
        x, self._xs_spec = pytree.tree_flatten(xs)
        k, self._consts_spec = pytree.tree_flatten(consts)
        self._n = (len(c), len(x), len(k))
        return (*c, *x, *k)

    def carry_tree(self, leaves):
        return pytree.tree_unflatten(list(leaves), self._carry_spec)

    def _parts(self, args):
        nc, nx, _ = self._n
        return args[:nc], args[nc:nc + nx], args[nc + nx:]

    # -- the protocol ---------------------------------------------------
    def init_carry(self, args):
        return tuple(self._parts(args)[0])

    def carry_names(self, r):
        return "state"

    def row_args(self, args, r):
        carry, xs, consts = self._parts(args)
        return ((None,) * len(carry)
                + tuple(self._row_x(u, r) for u in xs) + tuple(consts))

    def _row_x(self, u, r):
        return _chunk_slice(u, r, self.n_rows, self.axis)

    def add_row_grad(self, dargs, drow, r):
        nc, nx, _ = self._n
        for i, (acc, d) in enumerate(zip(dargs, drow)):
            if acc is None or d is None:
                continue
            if i < nc + nx:  # an xs leaf (the carry's get no row grad)
                self._row_x(acc, r).add_(d)
            else:
                acc.add_(d)

    def row_step(self, carry, row_args, r):
        _, xs, consts = self._parts(row_args)
        xc = pytree.tree_unflatten(list(xs), self._xs_spec)
        carry = self.carry_tree(carry)
        if self.with_consts:
            consts = pytree.tree_unflatten(list(consts), self._consts_spec)
            carry, y = self.body(consts, carry, xc)
        else:
            carry, y = self.body(carry, xc)
        return tuple(pytree.tree_leaves(carry)), y

    def finish(self, ys):
        return torch.cat(ys, dim=self.axis)

    def out_cotangent(self, g, r):
        return self._row_x(g, r)


class SwaOverlapRowProgram:
    """OverL along the sequence (:func:`swa_overlap_chunks`'s math) as a
    row program over ``apply(q, k, v)``: chunks stay independent (no
    carry); each row's args are the query chunk plus its replicated K/V
    halo slab (zeros before the sequence start), and :meth:`add_row_grad`
    scatter-adds the slab gradients back — the reference's slicing
    transpose."""

    returns_carry = False

    def __init__(self, attend: Callable, window: int, n_chunks: int):
        self.attend = attend
        self.window = window
        self.n_rows = n_chunks

    def init_carry(self, args):
        return ()

    def carry_names(self, r):
        return ()

    def _geometry(self, q, r):
        S = q.shape[1]
        assert S % self.n_rows == 0, \
            f"seq {S} not divisible by {self.n_rows} chunks"
        c = S // self.n_rows
        return r * c, c, min(self.window, S)

    @staticmethod
    def _slab(t, lo, hi):
        """Rows ``[lo, hi)`` of ``t`` along dim 1, zeros where ``lo < 0``
        (the reference's left pad)."""
        if lo >= 0:
            return t[:, lo:hi]
        pad = t.new_zeros((t.shape[0], -lo) + t.shape[2:])
        return torch.cat([pad, t[:, :hi]], dim=1)

    def row_args(self, args, r):
        q, k, v = args
        a, c, halo = self._geometry(q, r)
        return (q[:, a:a + c], self._slab(k, a - halo, a + c),
                self._slab(v, a - halo, a + c))

    def add_row_grad(self, dargs, drow, r):
        full = [t for t in dargs if t is not None]
        if not full:
            return
        a, c, halo = self._geometry(full[0], r)  # q, k and v share S
        lo = a - halo
        if dargs[0] is not None and drow[0] is not None:
            dargs[0][:, a:a + c] += drow[0]
        for acc, d in zip(dargs[1:], drow[1:]):
            if acc is not None and d is not None:
                acc[:, max(lo, 0):a + c] += d[:, max(-lo, 0):]

    def row_step(self, carry, row_args, r):
        qc, kc, vc = row_args
        a = r * qc.shape[1]
        halo = kc.shape[1] - qc.shape[1]
        return (), self.attend(qc, kc, vc, q_offset=a, k_offset=a - halo)

    def finish(self, ys):
        return torch.cat(ys, dim=1)

    def out_cotangent(self, g, r):
        c = g.shape[1] // self.n_rows
        return g[:, r * c:(r + 1) * c]


class StackedCarryScanRowProgram(CarryScanRowProgram):
    """:class:`CarryScanRowProgram` for bodies that consume pre-stacked
    chunks: ``xs`` leaves are ``(n_chunks, ...)`` (a tuple of streams or
    one tensor), row ``r``'s args are the ``xs[r]`` slices.  This is the
    row-program form of the chunk scans the LM family layers build inline
    (SSD, mLSTM, sLSTM), where the chunk split happened upstream of the
    scan.  The body's per-row output is one tensor.

    ``with_consts`` handles bodies that also consume differentiable values
    shared by every row (sLSTM's recurrent weights): the executor only
    differentiates its args, so a body closing over such values would
    silently detach their gradients.  ``apply(c0, xs, consts)`` passes them
    to every row unsliced (their gradients summed over the rows) and calls
    ``body(consts, carry, chunk)``."""

    def __init__(self, body: Callable, n_chunks: int,
                 with_consts: bool = False):
        super().__init__(body, n_chunks, axis=0)
        self.with_consts = with_consts

    def _row_x(self, u, r):
        return u[r]

    def finish(self, ys):
        return torch.stack(ys)

    def out_cotangent(self, g, r):
        return g[r]


def _offloading(residency) -> bool:
    """Does the spec move any cache off the device?  Device-resident plans
    keep the checkpointed loop (the same math); the executor is built only
    when there is a placement for it to apply."""
    return residency is not None and residency.offloads


def _carry_scan_apply(prog: CarryScanRowProgram, residency):
    from repro_torch.exec.rowprog import make_rowprog_apply
    run = make_rowprog_apply(prog, residency)

    def apply(c0, xs, *consts):
        carry, out = run(*prog.flatten(c0, xs, *consts))
        return prog.carry_tree(carry), out

    return apply


def make_chunked_apply(fn: Callable, n_chunks: int, axis: int = 1,
                       residency=None):
    """``apply(x)`` equal to :func:`chunked_apply`.  Carry-free: a
    ResidencySpec has nothing to place here, so the checkpointed loop is
    used whatever the spec (``ChunkedRowProgram`` exists for engines that
    drive the executor directly)."""
    del residency  # no carries to place (see docstring)
    return lambda x: chunked_apply(fn, x, n_chunks, axis)


def make_carry_scan_apply(body: Callable, n_chunks: int, axis: int = 1,
                          residency=None):
    """``apply(carry_init, xs) -> (carry, out)`` equal to
    :func:`carry_scan_remat`, with the carried state as a placeable
    boundary cache: device-resident plans keep the checkpointed loop, an
    offloading spec builds the executor that realises the placement."""
    if not _offloading(residency):
        return lambda c0, xs: carry_scan_remat(body, c0, xs, n_chunks, axis)
    return _carry_scan_apply(CarryScanRowProgram(body, n_chunks, axis),
                             residency)


def make_stacked_carry_scan_apply(body: Callable, n_chunks: int,
                                  residency=None,
                                  with_consts: bool = False):
    """``apply(carry_init, xs) -> (carry, stacked_out)`` over pre-stacked
    chunk streams, equal to ``lax.scan(jax.checkpoint(body), ...)``.
    Device-resident plans keep the checkpointed loop; an offloading spec
    builds the executor (:class:`StackedCarryScanRowProgram`) that places
    the carried state.

    ``with_consts=True`` makes the signature ``apply(carry_init, xs,
    consts)`` with ``body(consts, carry, chunk)`` — required whenever the
    body would otherwise close over differentiable values (see
    :class:`StackedCarryScanRowProgram`)."""
    if not _offloading(residency):
        if with_consts:
            return lambda c0, xs, consts: _scan_checkpointed(
                functools.partial(body, consts), c0, xs, n_chunks)
        return lambda c0, xs: _scan_checkpointed(body, c0, xs, n_chunks)
    return _carry_scan_apply(
        StackedCarryScanRowProgram(body, n_chunks, with_consts), residency)


def make_swa_overlap_apply(attend: Callable, window: int, n_chunks: int,
                           residency=None):
    """``apply(q, k, v)`` equal to :func:`swa_overlap_chunks`.  Carry-free
    like :func:`make_chunked_apply`: residency has nothing to place, so the
    checkpointed loop is always used."""
    del residency  # no carries to place (see make_chunked_apply)
    return lambda q, k, v: swa_overlap_chunks(attend, q, k, v, window,
                                              n_chunks)
