"""Decode cache pools — the serving instance of LR-CNN's fixed memory
budget reused across row partitions (counterpart of
``repro.serve.cache_pool``).

A pool allocates ONE persistent buffer set whose batch axis is the slot
axis; requests borrow a slot for their lifetime (prefill writes the slot,
decode updates it in place, eviction frees it for the next request).  Pool
capacity is policy, not mechanism: a ``serve_pool`` :class:`ExecutionPlan`
from :meth:`repro_torch.exec.planner.Planner.for_serve` pins the slot count
(and page-pool geometry) the byte budget buys, and the pool honours it
verbatim.

Three pool *cache kinds* ship, all presenting the same surface to the
scheduler (``decode_view`` -> decode -> ``absorb``):

* ``full`` (:class:`CachePool`) — the contiguous worst-case pool; storage
  IS the dense view the decode step consumes.
* ``paged_kv`` (:class:`PagedCachePool`) — full-attention K/V rows live in
  a shared page pool behind a per-slot block table
  (:mod:`repro_torch.serve.pages`); ``decode_view`` gathers the dense
  view, ``absorb`` scatters it back, so decode stays bit-identical to the
  contiguous pool while eviction returns pages for other requests.
* ``quant_kv`` (:class:`QuantCachePool`) — K/V stored as int8 codes plus
  fp32 per-(position, kv-head) scales; ``decode_view`` dequantises,
  ``absorb`` quantises ONLY each slot's newly written position (old codes
  are never re-quantised, so stored history is bit-stable).

Cache kinds are registries: the policy side registers byte estimators with
:func:`repro_torch.exec.planner.register_cache_bytes`, the mechanism side
registers matching inits here with :func:`register_cache_init` (a
qualified ``"<cache_kind>/<layer_kind>"`` key overrides a layer's cache
under that pool kind) and the pool class with :func:`register_pool_kind`;
:func:`make_pool` dispatches on the plan's ``cache_kind`` extra.

Where the reference's jitted ``.at[].set`` returns updated buffers, the
port writes the pool's tensors in place (``copy_``, ``index_copy_``,
``zero_``); each leaf's slot axis is found structurally from a 1-slot and
a 2-slot pool built on the ``meta`` device (no memory).

Decode-state residency: a ``serve_pool`` plan whose ``residency`` says
``host`` keeps the pool buffers in pinned host memory and fetches the
decode cohort's dense view to the card per tick.  The copies run on a
side CUDA stream and are joined with events, as the row-program executor
does for row caches (:mod:`repro_torch.exec.rowprog`): the scheduler's
:meth:`CachePool.prefetch` starts the NEXT cohort's fetch one tick ahead,
and :meth:`CachePool.absorb` waits for a step's write-back to land in host
memory before the storage is updated, so a slot's next fetch always reads
its newest state.  On CPU tensors host residency is the reference's
structural no-op: the schedule runs and no bytes move.

Sharded pools (a plan whose ``mesh`` has more than one device): the slot
axis is split over the mesh's batch axes, as the reference places it, and
each rank is one process holding only its ``slots_per_device`` slots,
``[b * per_dev, (b + 1) * per_dev)`` for its index ``b`` on the batch
axes; ranks that differ only on the model axis hold the same slots (the
reference replicates over it).  Shared leaves (ring flags) stay whole.
Every rank keeps the global slot table (``acquire``, ``release``,
``owner``, ``history``), so the same scheduler decisions run everywhere;
``write``, ``decode_view``, ``absorb`` and the zeroing in ``release`` take
global slot numbers and touch only the slots this rank holds
(:meth:`CachePool.owns`).  Paged and quantised pools, and decode-state
residency, are single-host, as in the reference.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Type

import numpy as np
import torch

from repro_torch.exec.plan import ExecutionPlan
from repro_torch.models.lm.common import torch_dtype
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.serve.pages import (
    PageGeometry, PageManager, dequantise, gather_pages, quantise,
    scatter_pages,
)

#: kind -> init fn.  Bare layer kinds: init(cfg, batch, max_len, dtype,
#: device=None).  Qualified "<cache_kind>/<layer_kind>" kinds also receive
#: the pool's PageGeometry (None for non-paged kinds):
#: init(cfg, batch, max_len, dtype, geom, device=None).
CACHE_INITS: Dict[str, Callable] = {}


def register_cache_init(kind: str, fn: Optional[Callable] = None):
    """Register the mechanism half of a decode cache kind (the policy half
    is :func:`repro_torch.exec.planner.register_cache_bytes`)."""
    def _do(f):
        if kind in CACHE_INITS:
            raise ValueError(f"cache kind {kind!r} already registered")
        CACHE_INITS[kind] = f
        return f

    if fn is not None:
        return _do(fn)
    return _do


def _block_cache_init(kind):
    from repro_torch.models.lm.blocks import init_block_cache
    return lambda cfg, batch, max_len, dtype, device=None: init_block_cache(
        kind, cfg, batch, max_len, dtype, device)


for _k in ("attn", "global", "shared_attn", "moe", "local", "mamba",
           "mlstm", "slstm"):
    register_cache_init(_k, _block_cache_init(_k))


def _paged_attn_init(cfg, batch, max_len, dtype, geom: PageGeometry,
                     device=None):
    """paged_kv storage for a full-attention layer: K/V page pools shared
    across slots + the per-slot resident pos scalar.  Key names mirror the
    dense cache ({k, v, pos, ring}) so the structural slot write lines up
    leaf for leaf (page leaves are slot-shared and skip)."""
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    shape = (geom.n_pages, geom.page_size, kv, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "ring": torch.tensor(False, device=device)}


def _quant_attn_init(cfg, batch, max_len, dtype, geom, device=None):
    """quant_kv storage: int8 K/V codes + fp32 per-(position, kv-head)
    scales (the layout :func:`repro_torch.serve.pages.quantise` emits)."""
    kv, hd = cfg.n_kv_heads, cfg.head_dim

    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)
    return {"k_q": z((batch, max_len, kv, hd), torch.int8),
            "k_s": z((batch, max_len, kv), torch.float32),
            "v_q": z((batch, max_len, kv, hd), torch.int8),
            "v_s": z((batch, max_len, kv), torch.float32),
            "pos": z((batch,), torch.int32),
            "ring": torch.tensor(False, device=device)}


for _k in ("attn", "global", "shared_attn", "moe"):
    register_cache_init(f"paged_kv/{_k}", _paged_attn_init)
    register_cache_init(f"quant_kv/{_k}", _quant_attn_init)


def _kind_init(cache_kind: str, kind: str) -> Optional[Callable]:
    """The qualified init for ``kind`` under ``cache_kind`` (None when the
    layer keeps its dense slot-resident cache under this pool kind)."""
    if cache_kind == "full":
        return None
    return CACHE_INITS.get(f"{cache_kind}/{kind}")


def init_pool_caches(cfg, n_slots: int, max_len: int, enc_len: int = 0,
                     cache_kind: str = "full",
                     geom: Optional[PageGeometry] = None, device=None):
    """Pool-shaped caches: batch axis = slot axis.  Same structure the
    model's prefill emits (for layers a ``cache_kind`` overrides, the
    override's structure), so slot writes are a pure tree zip.  An
    enc-dec pool is ``encdec_init_caches``' tree (``full`` only): each
    slot's self KV and the cross K/V of its ``enc_len`` frames, which a
    slot write carries in with the prefill's cache."""
    dtype = torch_dtype(cfg.dtype)
    if cfg.family == "encdec":
        if cache_kind != "full":
            raise ValueError(f"cache kind {cache_kind!r} does not support "
                             f"enc-dec pools; use cache_kind='full'")
        from repro_torch.models.lm.encdec import encdec_init_caches
        return encdec_init_caches(cfg, n_slots, max_len, enc_len, device)
    caches = []
    for pat, count in cfg.scan_segments():
        group = []
        for kind in pat:
            fn = _kind_init(cache_kind, kind)
            if fn is not None:
                c = fn(cfg, n_slots, max_len, dtype, geom, device=device)
            else:
                c = CACHE_INITS[kind](cfg, n_slots, max_len, dtype,
                                      device=device)
            group.append({k: v.expand((count,) + v.shape).clone()
                          for k, v in c.items()})
        caches.append(tuple(group))
    return caches


def _slot_axes(cfg, max_len: int, enc_len: int, cache_kind: str = "full",
               geom: Optional[PageGeometry] = None) -> List[int]:
    """Per-leaf slot-axis indices, found structurally: the axis whose size
    changes between a 1-slot and a 2-slot pool built on the ``meta``
    device (-1 for shared leaves — ring flags AND page pools, which are
    per-layer, not per-slot)."""
    one = init_pool_caches(cfg, 1, max_len, enc_len, cache_kind, geom,
                           device="meta")
    two = init_pool_caches(cfg, 2, max_len, enc_len, cache_kind, geom,
                           device="meta")
    axes = []
    for a, b in zip(tree_leaves(one), tree_leaves(two)):
        diff = [i for i, (p, q) in enumerate(zip(a.shape, b.shape))
                if p != q]
        axes.append(diff[0] if diff else -1)
    return axes


def _index(slots, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(list(slots), np.int64), device=device)


def _write_slot(pool, single, slot: int, *, axes) -> None:
    """Install a batch=1 cache tree into ``slot`` of ``pool``, in place
    (shared leaves skip)."""
    for p, s, ax in zip(tree_leaves(pool), tree_leaves(single), axes):
        if ax >= 0:
            p.select(ax, slot).copy_(s.select(ax, 0))


def _zero_slot(pool, slot: int, *, axes) -> None:
    """Reset one slot's slices in place (shared leaves — ring flags, page
    pools — stay): the eviction-path guarantee that a recycled slot can
    never read a predecessor's stale state."""
    for p, ax in zip(tree_leaves(pool), axes):
        if ax >= 0:
            p.select(ax, slot).zero_()


def _gather_slots(pool, slots, *, axes, pin: bool = False):
    """Subset view: a new tree holding ``slots`` along each leaf's slot
    axis (shared leaves pass through whole); ``pin`` gathers CPU leaves
    into pinned memory, so their fetch to the card can run async."""
    it = iter(axes)

    def take(p):
        ax = next(it)
        if ax < 0:
            return p
        idx = _index(slots, p.device)
        if not pin:
            return p.index_select(ax, idx)
        shape = list(p.shape)
        shape[ax] = len(idx)
        out = torch.empty(shape, dtype=p.dtype, pin_memory=True)
        return torch.index_select(p, ax, idx, out=out)
    return tree_map(take, pool)


def _scatter_slots(pool, sub, slots, *, axes):
    """Inverse of :func:`_gather_slots`, in place: write the subset back
    (a shared leaf takes the step's updated copy).  Returns ``pool``."""
    for p, s, ax in zip(tree_leaves(pool), tree_leaves(sub), axes):
        if ax < 0:
            if s is not p:
                p.copy_(s)
        else:
            p.index_copy_(ax, _index(slots, p.device), s.to(p.device))
    return pool


def _small(leaf, ax) -> bool:
    """Whether one slot's slice of ``leaf`` is small enough that a host
    gather beats one copy per slice."""
    return leaf[(0,) * (ax + 1)].numel() < 65536


class _HostLink:
    """Copies between a pool tree in host memory and the card, on one side
    CUDA stream and joined with events (the row-program executor's
    pattern).  Slot subsets move slice by slice — one contiguous block per
    leading index and slot — straight out of and back into the host tree,
    so no host-side gather or scatter touches the big leaves."""

    def __init__(self, device: torch.device):
        self.device = device
        self.side = torch.cuda.Stream(device)

    @staticmethod
    def _slices(leaf, ax, slots):
        """(host index, subset index) of every slice of ``slots``."""
        for lead in np.ndindex(*leaf.shape[:ax]):
            for j, s in enumerate(slots):
                yield lead + (int(s),), lead + (j,)

    def fetch(self, tree, slots, axes):
        """``slots``' subset of ``tree`` (whole leaves for ``slots=None``)
        on the card; returns (device tree, the event the consumer waits
        on).  Small leaves are gathered into pinned memory first."""
        current = torch.cuda.current_stream(self.device)
        self.side.wait_stream(current)  # the destinations are free
        it = iter(axes)

        def put(h):
            ax = next(it)
            shape = list(h.shape)
            src = h
            if slots is not None and ax >= 0:
                shape[ax] = len(slots)
                src = _gather_slots([h], slots, axes=(ax,), pin=True)[0] \
                    if _small(h, ax) else None
            d = torch.empty(shape, dtype=h.dtype, device=self.device)
            with torch.cuda.stream(self.side):
                if src is not None:
                    d.copy_(src, non_blocking=True)
                else:
                    for hi, di in self._slices(h, ax, slots):
                        d[di].copy_(h[hi], non_blocking=True)
            d.record_stream(self.side)  # an abandoned fetch stays safe
            return d
        out = tree_map(put, tree)
        done = torch.cuda.Event()
        done.record(self.side)
        return out, done

    def wait(self, done) -> None:
        torch.cuda.current_stream(self.device).wait_event(done)

    def writeback(self, view, tree, slots, axes) -> None:
        """Copy a device view (``slots`` along each slot axis; whole
        leaves for ``slots=None``) back into the host ``tree`` in place,
        after the step that produced it, and return once the copies have
        landed: the host tree is then safe to read for the next fetch."""
        current = torch.cuda.current_stream(self.device)
        self.side.wait_stream(current)  # the producing step first
        staged = []
        with torch.cuda.stream(self.side):
            for d, h, ax in zip(tree_leaves(view), tree_leaves(tree), axes):
                if slots is None or ax < 0:
                    h.copy_(d, non_blocking=True)
                elif _small(h, ax):
                    stage = torch.empty(d.shape, dtype=d.dtype,
                                        pin_memory=True)
                    stage.copy_(d, non_blocking=True)
                    staged.append((h, ax, stage))
                else:
                    for hi, di in self._slices(h, ax, slots):
                        h[hi].copy_(d[di], non_blocking=True)
                d.record_stream(self.side)
        done = torch.cuda.Event()
        done.record(self.side)
        done.synchronize()
        for h, ax, stage in staged:
            h.index_copy_(ax, _index(slots, h.device), stage)


class CachePool:
    """Slot allocator + the pooled cache buffers a ``serve_pool`` plan
    describes.  ``owner[slot]`` is the request id currently pinned there
    (-1 = free); ``history[slot]`` records every request the slot served.

    The scheduler drives every pool kind through the same calls:
    ``decode_view(slots)`` -> engine decode -> ``absorb(new, slots)``,
    with ``grow(slot)`` before each decoding slot's step (page capacity
    for the incoming token; always True here) and ``prefetch(slots)``
    started one tick ahead of the next cohort (a stash the next matching
    ``decode_view`` serves under host decode residency).  ``device`` is
    where decode runs (the card unless the caller asks for the CPU)."""

    #: the plan ``cache_kind`` extra this class implements
    kind = "full"

    def __init__(self, cfg, plan: ExecutionPlan, device="cuda"):
        if plan.engine != "serve_pool":
            raise ValueError(f"CachePool needs a serve_pool plan, got "
                             f"{plan.engine!r}")
        want = plan.get("cache_kind", "full")
        if want != self.kind:
            raise ValueError(f"plan wants cache kind {want!r} but "
                             f"{type(self).__name__} implements "
                             f"{self.kind!r}; build pools with make_pool()")
        self.cfg = cfg
        self.plan = plan
        self.device = torch.device(device)
        self.n_slots = plan.n_rows
        self.max_len = int(plan.get("max_len"))
        self.enc_len = int(plan.get("enc_len", 0))
        self._geom = self._geometry()
        # ---- decode-state residency (plan.residency on serve_pool plans)
        self._host = plan.residency is not None \
            and plan.residency.default == "host"
        #: the slots this rank holds, ``[slot_lo, slot_lo + n_local)``, and
        #: its process group over the mesh's batch axes (None unsharded or
        #: when they span one rank)
        self.mesh, self.batch_group = None, None
        self.slot_lo, self.n_local = 0, self.n_slots
        if plan.mesh is not None and plan.mesh.n_devices > 1:
            self._shard_pool()
        self._link = _HostLink(self.device) \
            if self._host and self.device.type == "cuda" else None
        self.storage_device = torch.device("cpu") if self._link is not None \
            else self.device
        self.caches = init_pool_caches(cfg, self.n_local, self.max_len,
                                       self.enc_len, self.kind, self._geom,
                                       device=self.storage_device)
        if self._link is not None:
            self.caches = tree_map(lambda t: t.pin_memory(), self.caches)
        self._axes = tuple(_slot_axes(cfg, self.max_len, self.enc_len,
                                      self.kind, self._geom))
        #: slot axes of the DENSE view (== storage axes for the full kind)
        self._dense_axes = self._axes if self.kind == "full" \
            else tuple(_slot_axes(cfg, self.max_len, self.enc_len))
        self._free = list(range(self.n_slots))
        self.owner = [-1] * self.n_slots
        self.history: List[List[int]] = [[] for _ in range(self.n_slots)]
        #: (cohort slots, device view, full view, fetch event)
        self._stash = None
        self._last_full = None    # full dense view behind a subset view
        self.prefetch_hits = 0

    def _geometry(self) -> Optional[PageGeometry]:
        return None

    def _shard_pool(self) -> None:
        """This rank's slots of a pool whose slot axis is split over the
        plan mesh's batch axes (``slots_per_device`` each: the slot count
        is a multiple of the batch extent), and its batch-axes group."""
        from repro_torch.exec.collectives import axis_group
        from repro_torch.launch.mesh import build_mesh
        spec = self.plan.mesh
        if self._host:
            raise ValueError("decode-state residency pools are single-host; "
                             "drop mesh=")
        self.mesh = build_mesh(spec)
        coord = dict(zip(spec.axis_names, self.mesh.get_coordinate()))
        b = 0
        for a in spec.batch_axes:
            b = b * spec.extent(a) + coord[a]
        self.n_local = self.n_slots // spec.batch_extent
        self.slot_lo = b * self.n_local
        self.batch_group = axis_group(self.mesh, spec.batch_axes)

    def owns(self, slot: int) -> bool:
        """Whether this rank holds ``slot``'s storage."""
        return self.slot_lo <= slot < self.slot_lo + self.n_local

    def local_slots(self, slots: Optional[Sequence[int]] = None) -> List[int]:
        """The slots of ``slots`` (every slot for None) this rank holds,
        in order (global numbers)."""
        if slots is None:
            return list(range(self.slot_lo, self.slot_lo + self.n_local))
        return [int(s) for s in slots if self.owns(s)]

    def _local(self, slots: Optional[Sequence[int]]):
        """Storage indices of ``slots``' local ones (None: every slot)."""
        if slots is None:
            return None
        return [s - self.slot_lo for s in self.local_slots(slots)]

    def _groups(self, *trees):
        """(layer kind, the trees' cache dicts) at every pattern
        position of every segment."""
        for (pat, _c), *groups in zip(self.cfg.scan_segments(), *trees):
            for kind, *cs in zip(pat, *groups):
                yield kind, cs

    def _rebuild(self, fn, *trees):
        """A new cache tree of ``fn(kind, *dicts)`` per pattern position."""
        return [tuple(fn(kind, *cs) for kind, *cs in zip(pat, *groups))
                for (pat, _c), *groups in zip(self.cfg.scan_segments(),
                                              *trees)]

    # ------------------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return self.n_slots - len(self._free)

    def can_admit(self, seq_len: int = 0) -> bool:
        """Would :meth:`acquire` succeed for a ``seq_len``-token prompt?"""
        return bool(self._free)

    def acquire(self, rid: int, seq_len: int = 0) -> Optional[int]:
        """Lowest free slot, pinned to ``rid``; None when the pool is full
        (the request stays QUEUED — admission control under the budget).
        ``seq_len`` is the prompt footprint paged pools pre-allocate pages
        for (ignored by contiguous pools)."""
        if not self._free:
            return None
        slot = self._free.pop(0)
        self.owner[slot] = rid
        self.history[slot].append(rid)
        return slot

    def release(self, slot: int) -> None:
        """Free ``slot`` AND zero its cache slices (and, in subclasses,
        its pages) so the next tenant can never read the predecessor's
        stale state."""
        if self.owner[slot] < 0:
            raise ValueError(f"slot {slot} is already free")
        self.owner[slot] = -1
        self._free.append(slot)
        self._free.sort()
        if self.owns(slot):
            _zero_slot(self.caches, slot - self.slot_lo, axes=self._axes)
        self._stash = None

    def grow(self, slot: int) -> bool:
        """Capacity for one more decoded token on ``slot`` (page pools
        allocate here).  Contiguous pools always have it."""
        return True

    # ------------------------------------------------------------------
    # the decode_view / absorb surface
    # ------------------------------------------------------------------
    def _dense_view(self):
        """The whole pool in the dense structure the decode step
        consumes.  Storage IS that structure for the full kind."""
        return self.caches

    def _store(self, dense) -> None:
        """Absorb a full dense view back into storage (identity layout
        for the full kind)."""
        self.caches = dense

    def _on_storage(self, tree):
        """A tree (a prefilled cache, from the decode device) on the
        storage's device."""
        if self.storage_device == self.device:
            return tree
        return tree_map(lambda t: t.to(self.storage_device), tree)

    def decode_view(self, slots: Optional[Sequence[int]] = None):
        """The dense cache tree one decode step consumes, on the decode
        device: the whole pool (``slots=None``) or the given cohort's
        subset (slot axis = ``len(slots)``).  Serves a matching
        :meth:`prefetch` stash first — the one-tick-ahead fetch under
        host decode residency.  A sharded pool's view holds the slots of
        ``slots`` this rank holds (:meth:`local_slots`)."""
        slots = self._local(slots)
        if slots is not None:
            key = tuple(int(s) for s in slots)
            if self._stash is not None and self._stash[0] == key:
                _, sub, full, done = self._stash
                self._stash = None
                self._last_full = full
                self.prefetch_hits += 1
                if done is not None:
                    self._link.wait(done)
                return sub
        self._stash = None
        full = self._last_full = self._dense_view()
        if self._link is not None:
            view, done = self._link.fetch(full, slots, self._dense_axes)
            self._link.wait(done)
            return view
        if slots is None:
            return full
        return _gather_slots(full, slots, axes=self._dense_axes)

    def absorb(self, view, slots: Optional[Sequence[int]] = None) -> None:
        """Install a decode step's updated dense view back into storage
        (``slots`` must match the producing :meth:`decode_view`).  Under
        host residency the view is copied back into the host-side dense
        view first (for the full kind, the pool itself), and this returns
        once those copies have landed."""
        self._stash = None
        slots = self._local(slots)
        full = self._last_full
        if full is None:
            raise RuntimeError("absorb() needs the matching decode_view() "
                               "first")
        if self._link is not None:
            self._link.writeback(view, full, slots, self._dense_axes)
        elif slots is None:
            full = view
        else:
            _scatter_slots(full, view, slots, axes=self._dense_axes)
        self._last_full = None
        self._store(full)

    def prefetch(self, slots: Sequence[int]) -> None:
        """Start the NEXT cohort's device fetch one tick ahead (host
        decode residency only — device-resident pools have nothing to
        hide).  The stash is invalidated by any pool mutation; a matching
        :meth:`decode_view` consumes it and counts a hit."""
        if not self._host or not slots:
            return
        full = self._dense_view()
        if self._link is None:
            sub, done = _gather_slots(full, slots,
                                      axes=self._dense_axes), None
        else:
            sub, done = self._link.fetch(full, slots, self._dense_axes)
        self._stash = (tuple(int(s) for s in slots), sub, full, done)

    def write(self, slot: int, single_cache) -> None:
        """Install a freshly prefilled batch=1 cache into ``slot`` (a slot
        this rank holds)."""
        if not self.owns(slot):
            raise ValueError(f"slot {slot} is not held by this rank "
                             f"(slots {self.slot_lo}..."
                             f"{self.slot_lo + self.n_local - 1})")
        self._stash = None
        _write_slot(self.caches, self._on_storage(single_cache),
                    slot - self.slot_lo, axes=self._axes)


class PagedCachePool(CachePool):
    """``paged_kv``: full-attention K/V in a shared page pool behind a
    per-slot block table; ring-window and recurrent-state kinds stay
    slot-resident.  The dense decode view is gathered (unassigned pages
    read as zeros — identical to the contiguous pool's zero init, which
    keeps decode bit-identical) and scattered back on absorb; writes to
    unallocated pages drop, so a freed slot's history can never leak into
    the pool."""

    kind = "paged_kv"

    def __init__(self, cfg, plan: ExecutionPlan, device="cuda"):
        if plan.mesh is not None and plan.mesh.n_devices > 1:
            raise ValueError("paged_kv pools are single-host; drop mesh=")
        self.plan = plan  # _geometry needs it before super().__init__
        super().__init__(cfg, plan, device)
        self.pages = PageManager(self._geom.n_pages, self._geom.page_size,
                                 self.n_slots, self.max_len)

    def _geometry(self) -> PageGeometry:
        ps = int(self.plan.get("page_size", 16))
        n_pages = int(self.plan.get("n_pages", 1))
        return PageGeometry(ps, n_pages, max(1, -(-self.max_len // ps)))

    def _is_paged(self, kind: str) -> bool:
        return f"{self.kind}/{kind}" in CACHE_INITS

    # ------------------------------------------------------------------
    def can_admit(self, seq_len: int = 0) -> bool:
        return bool(self._free) and self.pages.can_alloc(
            self._free[0], max(1, seq_len))

    def acquire(self, rid: int, seq_len: int = 0) -> Optional[int]:
        if not self._free:
            return None
        if not self.pages.can_alloc(self._free[0], max(1, seq_len)):
            return None  # slot free but the page pool can't hold the prompt
        slot = super().acquire(rid, seq_len)
        self.pages.alloc(slot, max(1, seq_len))
        return slot

    def release(self, slot: int) -> None:
        freed = self.pages.free(slot)
        super().release(slot)  # zeroes the resident (pos) slices
        if freed:
            idx = _index(freed, self.storage_device)
            for kind, (c,) in self._groups(self.caches):
                if self._is_paged(kind):
                    c["k"].index_fill_(1, idx, 0)
                    c["v"].index_fill_(1, idx, 0)

    def grow(self, slot: int) -> bool:
        return self.pages.grow(slot) is not None

    # ------------------------------------------------------------------
    def _dense_view(self):
        table = self.pages.table

        def view(kind, c):
            if not self._is_paged(kind):
                return c
            return {"k": gather_pages(c["k"], table, max_len=self.max_len),
                    "v": gather_pages(c["v"], table, max_len=self.max_len),
                    "pos": c["pos"].clone(), "ring": c["ring"]}
        return self._rebuild(view, self.caches)

    def _store(self, dense) -> None:
        table = self.pages.table

        def store(kind, sc, dc):
            if not self._is_paged(kind):
                return dc
            return {"k": scatter_pages(sc["k"], table, dc["k"]),
                    "v": scatter_pages(sc["v"], table, dc["v"]),
                    "pos": dc["pos"].to(self.storage_device),
                    "ring": sc["ring"]}
        self.caches = self._rebuild(store, self.caches, dense)

    def write(self, slot: int, single_cache) -> None:
        self._stash = None
        single = self._on_storage(single_cache)
        # resident leaves (pos) via the structural write — page leaves are
        # slot-shared (axis -1) and skip — then the prefilled K/V rows
        # scatter onto the pages acquire() allocated
        _write_slot(self.caches, single, slot, axes=self._axes)
        row = self.pages.table[slot:slot + 1]
        for kind, (pc, sc) in self._groups(self.caches, single):
            if self._is_paged(kind):
                scatter_pages(pc["k"], row, sc["k"])
                scatter_pages(pc["v"], row, sc["v"])


class QuantCachePool(CachePool):
    """``quant_kv``: int8 K/V codes + fp32 per-(position, kv-head) scales
    for the full-attention kinds; everything else stays dense.  Prefill
    quantises the whole written prompt once; each decode step quantises
    ONLY the newly written position (``absorb``), so a stored code is
    written exactly once and never drifts — which makes pooled decode
    bit-identical to sequential decode under the same quantised cache."""

    kind = "quant_kv"

    def __init__(self, cfg, plan: ExecutionPlan, device="cuda"):
        if plan.mesh is not None and plan.mesh.n_devices > 1:
            raise ValueError("quant_kv pools are single-host; drop mesh=")
        super().__init__(cfg, plan, device)

    def _is_quant(self, kind: str) -> bool:
        return f"{self.kind}/{kind}" in CACHE_INITS

    # ------------------------------------------------------------------
    def _dense_view(self):
        dt = self.cfg.dtype

        def view(kind, c):
            if not self._is_quant(kind):
                return c
            # pos is copied: absorb reads the stored pre-step positions
            return {"k": dequantise(c["k_q"], c["k_s"], dtype=dt),
                    "v": dequantise(c["v_q"], c["v_s"], dtype=dt),
                    "pos": c["pos"].clone(), "ring": c["ring"]}
        return self._rebuild(view, self.caches)

    def _quantise_tree(self, dense):
        def quant(kind, c):
            if not self._is_quant(kind):
                return c
            kq, ks = quantise(c["k"])
            vq, vs = quantise(c["v"])
            return {"k_q": kq, "k_s": ks, "v_q": vq, "v_s": vs,
                    "pos": c["pos"], "ring": c["ring"]}
        return self._rebuild(quant, dense)

    def _store(self, dense) -> None:
        def store(kind, qc, dc):
            return _quant_absorb_kind(qc, dc) if self._is_quant(kind) \
                else dc
        self.caches = self._rebuild(store, self.caches, dense)

    def write(self, slot: int, single_cache) -> None:
        self._stash = None
        _write_slot(self.caches,
                    self._quantise_tree(self._on_storage(single_cache)),
                    slot, axes=self._axes)


def _quant_absorb_kind(qc, dc):
    """Write-back for one quantised layer group after a decode step, in
    place: quantise each slot's row at its PRE-decode position (the one
    position ``attn_decode`` just wrote) into the int8 store; every other
    stored code is untouched.  Slots the step didn't decode write zeros
    over the zeros already at their (unwritten) position — a no-op by
    construction, so one path serves full-pool and cohort absorbs
    alike."""
    C, B, S = qc["k_q"].shape[:3]
    dev = qc["k_q"].device
    idx = qc["pos"].long().clamp(max=S - 1)                   # (C, B)
    ci = torch.arange(C, device=dev)[:, None].expand(C, B)
    bi = torch.arange(B, device=dev)[None, :].expand(C, B)
    for name in ("k", "v"):
        row = dc[name].to(dev)[ci, bi, idx]                   # (C,B,kv,hd)
        q, s = quantise(row)
        qc[f"{name}_q"][ci, bi, idx] = q
        qc[f"{name}_s"][ci, bi, idx] = s
    return {"k_q": qc["k_q"], "k_s": qc["k_s"], "v_q": qc["v_q"],
            "v_s": qc["v_s"], "pos": dc["pos"].to(dev), "ring": qc["ring"]}


# ---------------------------------------------------------------------------
# pool-kind registry (the third seam next to bytes + init)
# ---------------------------------------------------------------------------

POOL_KINDS: Dict[str, Type[CachePool]] = {}


def register_pool_kind(kind: str, cls: Optional[Type[CachePool]] = None):
    """Register the pool class serving a ``cache_kind`` plan extra (the
    companion of :func:`register_cache_init` /
    :func:`repro_torch.exec.planner.register_cache_bytes`)."""
    def _do(c):
        if kind in POOL_KINDS:
            raise ValueError(f"pool cache kind {kind!r} already registered")
        POOL_KINDS[kind] = c
        return c

    if cls is not None:
        return _do(cls)
    return _do


register_pool_kind("full", CachePool)
register_pool_kind("paged_kv", PagedCachePool)
register_pool_kind("quant_kv", QuantCachePool)


def make_pool(cfg, plan: ExecutionPlan, device="cuda") -> CachePool:
    """Build the pool a ``serve_pool`` plan describes, dispatching on its
    ``cache_kind`` extra (default: the contiguous full pool), for decode
    on ``device``."""
    kind = plan.get("cache_kind", "full")
    try:
        cls = POOL_KINDS[kind]
    except KeyError:
        raise KeyError(
            f"no cache pool registered for kind {kind!r}; known: "
            f"{sorted(POOL_KINDS)} — register one with "
            f"repro_torch.serve.cache_pool.register_pool_kind") from None
    return cls(cfg, plan, device)
