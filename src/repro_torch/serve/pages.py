"""Paged decode-cache mechanics: the page pool, the block table, and the
int8 quantisation codec the ``paged_kv`` / ``quant_kv`` cache kinds build
on (counterpart of ``repro.serve.pages``).

LR-CNN's budget-over-allocation inversion, applied to decode state: a
contiguous pool pins ``max_len`` KV rows per slot for the slot's whole
life — worst-case column-style allocation.  The paged pool instead owns a
global set of fixed-size *pages* (the vLLM block-table idiom): a request
maps its token positions onto pages through a per-slot block table, pages
are allocated lazily as decode grows the sequence, and eviction returns
them to the free list — so the byte budget buys pages sized to the actual
mixed-length traffic, not to the longest request imaginable.

* **bookkeeping** (:class:`PageManager`) is plain numpy/python — which
  page belongs to which slot, deterministic lowest-index-first
  allocation, leak-free free lists (a copy of the reference's).
* **data movement** (:func:`gather_pages` / :func:`scatter_pages`):
  gather assembles the dense ``(slots, max_len, ...)`` view the decode
  step consumes (which keeps paged decode bit-identical to the contiguous
  pool), scatter writes it back into the page pool in place.  Unassigned
  block-table entries read as zeros and drop their writes, mirroring the
  zero-initialised contiguous cache.
* **quantisation** (:func:`quantise` / :func:`dequantise`) is the
  ``quant_kv`` codec: symmetric per-vector int8 with an fp32 scale per
  (position, kv-head) row; its codes and scales equal the reference's
  bit for bit (the scale is ``max |x|`` times the fp32 reciprocal of 127,
  the multiply XLA folds the reference's division by the constant into;
  then an fp32 division by the scale, round half to even, clip to ±127,
  in that order).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PageGeometry:
    """Shape of a paged pool: ``page_size`` tokens per page, ``n_pages``
    pages in the global pool, ``max_pages`` block-table width (the pages a
    ``max_len`` sequence would need)."""

    page_size: int
    n_pages: int
    max_pages: int

    def __post_init__(self):
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {self.n_pages}")
        if self.max_pages < 1:
            raise ValueError(f"max_pages must be >= 1, got {self.max_pages}")

    def pages_for(self, n_tokens: int) -> int:
        """Pages a ``n_tokens``-long sequence occupies (ceil)."""
        return max(0, -(-int(n_tokens) // self.page_size))


class PageManager:
    """Owns the global page pool's bookkeeping: the free list, the
    per-page owner, and the per-slot block table mapping token positions
    to pages.

    Deterministic by construction — allocation always hands out the
    lowest free page index, and freed pages re-enter the free list in
    sorted order — so a (requests, plan) pair replays the same table on
    every run (the scheduler's tick-clock discipline, applied to pages).

    Invariants (the hypothesis property tests assert these):

    * every page is either free or owned by exactly one slot;
    * a slot's block-table entries are distinct, in-bounds page indices;
    * ``n_free + sum(pages per slot) == n_pages`` — no leaks, ever.
    """

    def __init__(self, n_pages: int, page_size: int, n_slots: int,
                 max_len: int):
        self.geom = PageGeometry(page_size, n_pages,
                                 max(1, -(-max_len // page_size)))
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self._free: List[int] = list(range(n_pages))
        #: slot owning each page (-1 = free)
        self.owner = np.full(n_pages, -1, np.int32)
        #: per-slot page map; -1 = unassigned (reads as zeros, drops writes)
        self.table = np.full((n_slots, self.geom.max_pages), -1, np.int32)
        #: tokens each slot's pages currently cover capacity for
        self.seq_len = np.zeros(n_slots, np.int64)

    # ------------------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.geom.n_pages - len(self._free)

    def pages_of(self, slot: int) -> List[int]:
        return [int(p) for p in self.table[slot] if p >= 0]

    def can_alloc(self, slot: int, n_tokens: int) -> bool:
        """Would :meth:`alloc` succeed for ``n_tokens`` total tokens?"""
        need = self.geom.pages_for(n_tokens)
        have = len(self.pages_of(slot))
        return need <= self.geom.max_pages and need - have <= len(self._free)

    def alloc(self, slot: int, n_tokens: int) -> Optional[List[int]]:
        """Grow ``slot``'s page map to cover ``n_tokens`` total tokens.
        Returns the newly assigned page indices ([] when the current pages
        already cover it); None — with NO partial allocation — when the
        free list can't."""
        need = self.geom.pages_for(n_tokens)
        have = len(self.pages_of(slot))
        if need > self.geom.max_pages or need - have > len(self._free):
            return None
        newly = []
        for i in range(have, need):
            p = self._free.pop(0)
            self.table[slot, i] = p
            self.owner[p] = slot
            newly.append(p)
        self.seq_len[slot] = max(int(self.seq_len[slot]), int(n_tokens))
        return newly

    def grow(self, slot: int) -> Optional[List[int]]:
        """Capacity for one more token on ``slot`` — the per-decode-step
        call.  Same contract as :meth:`alloc`."""
        return self.alloc(slot, int(self.seq_len[slot]) + 1)

    def free(self, slot: int) -> List[int]:
        """Release every page of ``slot`` back to the (sorted) free list.
        Returns the freed page indices so the pool can zero their
        contents before reuse."""
        pages = self.pages_of(slot)
        for p in pages:
            self.owner[p] = -1
        self._free.extend(pages)
        self._free.sort()
        self.table[slot] = -1
        self.seq_len[slot] = 0
        return pages

    def check(self) -> None:
        """Assert the bookkeeping invariants (test hook)."""
        assigned = [int(p) for row in self.table for p in row if p >= 0]
        if len(assigned) != len(set(assigned)):
            raise AssertionError("page double-assignment in block table")
        if any(p >= self.geom.n_pages for p in assigned):
            raise AssertionError("block-table entry out of bounds")
        if sorted(assigned + self._free) != list(range(self.geom.n_pages)):
            raise AssertionError("page leak: free + assigned != pool")
        for p in assigned:
            s = int(self.owner[p])
            if p not in self.table[s]:
                raise AssertionError(f"owner[{p}]={s} but page not in "
                                     f"slot {s}'s table")


# ---------------------------------------------------------------------------
# page <-> dense movement
# ---------------------------------------------------------------------------


def _table(table) -> np.ndarray:
    if isinstance(table, torch.Tensor):
        table = table.cpu().numpy()
    return np.asarray(table, np.int64)


def gather_pages(pages, table, *, max_len: int):
    """Assemble the dense per-slot view from the page pool.

    ``pages``: ``(layers, n_pages, page_size, ...)`` — the stacked-layer
    page pool.  ``table``: ``(n_slots, max_pages)`` integers (numpy or a
    tensor), -1 = unassigned.  Returns a new ``(layers, n_slots, max_len,
    ...)`` tensor; unassigned entries read as zeros, exactly the
    zero-initialised contiguous cache (the bit-parity invariant)."""
    n_pages, page_size = pages.shape[1], pages.shape[2]
    tab = _table(table)
    n_slots, max_pages = tab.shape
    safe = torch.from_numpy(np.clip(tab, 0, n_pages - 1).reshape(-1)
                            ).to(pages.device)
    out = pages.index_select(1, safe)               # (L, S*MP, ps, ...)
    valid = torch.from_numpy(tab.reshape(-1) >= 0).to(pages.device)
    out = out.masked_fill(
        ~valid.reshape((1, -1) + (1,) * (out.ndim - 2)), 0)
    out = out.reshape((pages.shape[0], n_slots, max_pages * page_size)
                      + tuple(pages.shape[3:]))
    return out[:, :, :max_len].contiguous()


def scatter_pages(pages, table, dense):
    """Write a dense per-slot view back into the page pool, in place, and
    return the pool.

    Inverse of :func:`gather_pages`: ``dense`` is ``(layers, n_slots, L,
    ...)`` with ``L <= max_pages * page_size``; positions map onto each
    slot's block-table pages, and writes to unassigned entries are
    dropped.  Slots own disjoint pages (a :class:`PageManager` invariant),
    so the scatter has no write conflicts."""
    n_pages, page_size = pages.shape[1], pages.shape[2]
    tab = _table(table)
    n_slots, max_pages = tab.shape
    pad = max_pages * page_size - dense.shape[2]
    if pad:
        dense = torch.cat([dense, dense.new_zeros(
            dense.shape[:2] + (pad,) + tuple(dense.shape[3:]))], dim=2)
    dense = dense.reshape((dense.shape[0], n_slots * max_pages, page_size)
                          + tuple(dense.shape[3:]))
    flat = tab.reshape(-1)
    sel = np.nonzero(flat >= 0)[0]
    if sel.size:
        src = torch.from_numpy(sel).to(dense.device)
        dst = torch.from_numpy(flat[sel]).to(pages.device)
        pages.index_copy_(1, dst, dense.index_select(1, src).to(
            pages.device, pages.dtype))
    return pages


# ---------------------------------------------------------------------------
# int8 quantisation codec (the quant_kv kind)
# ---------------------------------------------------------------------------


#: 1/127 rounded to fp32: the reference's ``max / 127.0`` compiles to a
#: multiply by it
_INV_127 = float(np.float32(1.0 / 127.0))


def quantise(x):
    """Symmetric per-vector int8 over the last axis: ``q`` int8 codes in
    [-127, 127] plus an fp32 ``scale`` per leading block (one scale per
    (..., kv-head) row).  All-zero vectors quantise to (0, 0) and
    dequantise back to exact zeros."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) * _INV_127
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))[..., None]
    q = torch.clamp(torch.round(xf / safe), -127, 127).to(torch.int8)
    return q, scale


def dequantise(q, scale, *, dtype):
    """fp reconstruction: ``q * scale`` in fp32, cast to the cache dtype
    (a torch dtype or its name) the decode step consumes.  Max abs error
    per element is ``scale / 2`` (round to nearest) plus the cast's
    rounding."""
    if isinstance(dtype, str):
        from repro_torch.models.lm.common import torch_dtype
        dtype = torch_dtype(dtype)
    return (q.float() * scale[..., None]).to(dtype)
