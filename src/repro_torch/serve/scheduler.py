"""Continuous-batching scheduler: admission under the budget, chunked
prefill interleaved with batched decode, eviction on completion
(counterpart of ``repro.serve.scheduler``; the same policy, tick for
tick).

The LR-CNN mapping: the cache pool is the fixed memory budget, decode
slots are the rows, and the scheduler is the row iterator — it admits a
queued request the moment a slot frees up (continuous batching) instead of
waiting for the whole batch to drain (static batching, kept as
``mode="static"`` for the ablation benchmarks).

Production semantics layered on the same tick clock:

* **priorities** — arrived requests admit highest-priority first
  (``Request.priority``, ties broken by arrival then rid — identical to
  the plain FIFO order when every priority is equal);
* **preemptible prefill** — a prompt's budget-chunked prefill spends one
  tick per row chunk instead of one atomic tick, and a higher-priority
  arrival may evict a strictly-lower-priority in-flight prefill (the
  victim re-queues and later replays identically: tokens are keyed on
  (request seed, step), never on scheduling history);
* **page-pressure preemption** — when a ``paged_kv`` pool can't grow a
  decoding slot by one token, the lowest-priority / latest-arrival other
  decoder is evicted back to QUEUED and its pages fund the growth;
* **decode cohorts** — ``decode_batch`` on the plan caps the per-tick
  decode width; active slots rotate round-robin through fixed-size
  cohorts (two decode shapes in all), and the *next* cohort's device
  fetch is prefetched one tick ahead under host decode-state residency;
* **SLO accounting** — p50/p95 latency and time-to-first-token targets
  (:class:`SLO`) checked against the tick-denominated measurements in
  :meth:`ServeReport.summary`, for bursty-traffic capacity studies.

Time is a simulated tick counter: every engine call (one prefill chunk or
whole prefill, or one batched decode step) costs one tick, and request
arrivals are tick-denominated (see :mod:`repro.serve.request`).  No
wall-clock enters the logic — a (requests, plan, seed) triple replays
bit-for-bit.  ``walltime_fn`` (benchmarks only) stamps completions for
latency percentiles without influencing any decision.

Under a plan mesh the reference drives one sharded pool from one
controller.  The port runs one process per rank, each with the same
:class:`Scheduler` over the global slot table, so every rank makes the
same admissions, preemptions and ticks: they depend only on the requests
and on tokens every rank has.  A prefill runs on the rank that holds the
request's slot, which broadcasts token 0 over the batch-axes group; after
a decode tick each rank draws its own slots' tokens (the draw is seeded
per (seed, step), so the holder's draw is one process's) and the ranks
all-gather the int32 token ids, never the logits.  Completion stamps are
rank 0's.  Ranks that differ only on the model axis hold and decode the
same slots.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.exec.collectives import (
    all_gather_cat, all_reduce_, broadcast_,
)
from repro_torch.optim.adamw import tree_leaves
from repro_torch.serve.cache_pool import CachePool, make_pool
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.request import Phase, Request, RequestState


def percentile(values: Sequence[float], p: float) -> float:
    """Nearest-rank percentile (p in [0, 1]) — shared by report summaries
    and the serving benchmarks.  Returns 0.0 for an empty sequence."""
    vals = sorted(values)
    if not vals:
        return 0.0
    return vals[min(len(vals) - 1, int(round(p * (len(vals) - 1))))]


@dataclasses.dataclass(frozen=True)
class SLO:
    """Latency objectives in scheduler ticks (0 = unset).  ``latency`` is
    arrival -> completion, ``ttft`` is arrival -> first token; the p50/p95
    fields bound the corresponding measured percentiles."""

    p50_latency: float = 0.0
    p95_latency: float = 0.0
    p50_ttft: float = 0.0
    p95_ttft: float = 0.0

    def check(self, latencies: Sequence[float],
              ttfts: Sequence[float]) -> dict:
        """Measured percentiles vs targets, plus per-request *attainment*
        (fraction of requests inside every set p95 target)."""
        measured = {
            "p50_latency": percentile(latencies, 0.50),
            "p95_latency": percentile(latencies, 0.95),
            "p50_ttft": percentile(ttfts, 0.50),
            "p95_ttft": percentile(ttfts, 0.95),
        }
        targets = dataclasses.asdict(self)
        met = {k: measured[k] <= t for k, t in targets.items() if t > 0}
        ok = [lat <= self.p95_latency if self.p95_latency else True
              for lat in latencies]
        if self.p95_ttft and ttfts:
            ok = [o and t <= self.p95_ttft for o, t in zip(ok, ttfts)]
        att = (sum(ok) / len(ok)) if ok else 1.0
        return {"targets": {k: v for k, v in targets.items() if v > 0},
                "measured": measured, "met": met,
                "attainment": round(att, 4)}


@dataclasses.dataclass
class ServeReport:
    """What a scheduler run produced, for tests / benchmarks / the CLI."""

    states: List[RequestState]
    total_ticks: float = 0.0
    n_prefills: int = 0
    n_decode_steps: int = 0
    max_active: int = 0
    n_preempted: int = 0
    prefetch_hits: int = 0
    slo: Optional[SLO] = None
    slot_history: Dict[int, List[int]] = dataclasses.field(
        default_factory=dict)
    events: List[dict] = dataclasses.field(default_factory=list)
    plan_audit: Optional[dict] = None

    @property
    def total_generated(self) -> int:
        return sum(s.n_generated for s in self.states)

    def tokens(self, rid: int) -> List[int]:
        for s in self.states:
            if s.rid == rid:
                return list(s.generated)
        raise KeyError(rid)

    def timeline(self, start: float = 0.0,
                 end: Optional[float] = None) -> List[dict]:
        """The per-tick event stream (admission / prefill chunks / decode
        cohorts / preemptions / page traffic), in emission order, in the
        tracer's record schema (``{"kind", "name", "tick", "attrs"}``) —
        so a report and a ``--trace`` JSONL of the same run line up
        record-for-record.  ``start``/``end`` bound the tick range."""
        return [e for e in self.events
                if e.get("tick", 0) >= start
                and (end is None or e.get("tick", 0) <= end)]

    def latency_ticks(self) -> List[float]:
        """Per-request arrival -> completion, in ticks (queueing included)."""
        return [s.finish_tick - s.request.arrival for s in self.states]

    def ttft_ticks(self) -> List[float]:
        """Per-request arrival -> first token, in ticks.  A preempted
        request keeps its FIRST emission time — the user already saw that
        token stream start."""
        return [s.first_token_tick - s.request.arrival
                for s in self.states if s.first_token_tick >= 0]

    def summary(self) -> dict:
        lat = self.latency_ticks()
        ttft = self.ttft_ticks()
        out = {
            "requests": len(self.states),
            "generated_tokens": self.total_generated,
            "ticks": self.total_ticks,
            "prefills": self.n_prefills,
            "decode_steps": self.n_decode_steps,
            "max_active": self.max_active,
            "preemptions": self.n_preempted,
            "prefetch_hits": self.prefetch_hits,
            "tok_per_tick": round(self.total_generated
                                  / max(1.0, self.total_ticks), 3),
            "p50_latency_ticks": percentile(lat, 0.50),
            "p95_latency_ticks": percentile(lat, 0.95),
            "p50_ttft_ticks": percentile(ttft, 0.50),
            "p95_ttft_ticks": percentile(ttft, 0.95),
        }
        if self.slo is not None:
            out["slo"] = self.slo.check(lat, ttft)
        return out


class Scheduler:
    """Drives a :class:`ServeEngine` + :class:`CachePool` over a request
    list until every request is DONE.

    ``mode="continuous"`` — free slots are refilled as soon as any request
    finishes.  ``mode="static"`` — the old one-shot behaviour: a batch is
    admitted only into an empty pool and runs until its *last* member
    finishes (finished slots idle — exactly the waste continuous batching
    removes).

    ``preemptible_prefill=True`` runs each admitted prompt's prefill one
    row chunk per tick and lets strictly-higher-priority arrivals evict
    it; the pool's ``decode_batch`` extra (from
    ``Planner.for_serve(..., decode_batch=)``) caps the decode cohort per
    tick.  Both default off, leaving the original semantics untouched.
    """

    def __init__(self, engine: ServeEngine, pool: CachePool,
                 requests: Sequence[Request], mode: str = "continuous",
                 walltime_fn: Optional[Callable[[], float]] = None,
                 preemptible_prefill: bool = False,
                 slo: Optional[SLO] = None):
        if mode not in ("continuous", "static"):
            raise ValueError(f"unknown scheduler mode {mode!r}")
        self.engine = engine
        self.pool = pool
        self.mode = mode
        self.walltime_fn = walltime_fn
        self.preemptible_prefill = preemptible_prefill
        self.slo = slo
        self.states = [RequestState(r) for r in
                       sorted(requests, key=lambda r: (r.arrival, r.rid))]
        self.tick = 0.0
        self.n_prefills = 0
        self.n_decode_steps = 0
        self.max_active = 0
        self.n_preempted = 0
        self.decode_batch = int(pool.plan.get("decode_batch", 0) or 0)
        #: per-tick event stream in the tracer's record schema — always
        #: kept (simulator scale), mirrored into the obs session when one
        #: is active; ``ServeReport.timeline()`` exports it
        self.events: List[dict] = []
        #: round-robin cohort order over decoding slots
        self._rotation: List[int] = []
        # last sampled token per slot; free slots hold 0 and their rows'
        # outputs are discarded (static-shape continuous batching)
        self.last_token = np.zeros(pool.n_slots, np.int32)

    # ------------------------------------------------------------------
    # a sharded pool: the holder draws a slot's token, the group shares it
    # ------------------------------------------------------------------
    def _draw(self, logits_row, st: RequestState, step: int) -> int:
        """``st``'s token ``step``, or -1 for non-finite logits: under a
        mesh every rank then raises together, in :meth:`_checked`."""
        try:
            return self.engine.sample(logits_row, st.request, step)
        except FloatingPointError:
            return -1

    @staticmethod
    def _checked(tok: int, st: RequestState, step: int) -> int:
        if tok < 0:
            raise FloatingPointError(
                f"non-finite logits for request {st.rid} at step {step}")
        return tok

    def _from_holder(self, slot: int, tok: int) -> int:
        """The token the rank holding ``slot`` drew, on every rank."""
        group = self.pool.batch_group
        if group is None:
            return tok
        import torch
        import torch.distributed as dist
        t = torch.tensor([tok], dtype=torch.int32)
        src = dist.get_global_rank(group, slot // self.pool.n_local)
        return int(broadcast_(t, src, group)[0])

    def _gathered(self, drawn: Dict[int, int]) -> Dict[int, int]:
        """Every rank's drawn tokens (slot -> token), all-gathered as int32
        over the batch-axes group."""
        group = self.pool.batch_group
        if group is None:
            return drawn
        import torch
        buf = torch.full((self.pool.n_local,), -2, dtype=torch.int32)
        for slot, tok in drawn.items():
            buf[slot - self.pool.slot_lo] = tok
        every = all_gather_cat(buf, 0, group).tolist()
        return {s: every[s] for s in range(len(every)) if every[s] != -2}

    def _emit(self, name: str, **attrs) -> None:
        tick = float(self.tick)
        rec = {"kind": "event", "name": name,
               "tick": int(tick) if tick.is_integer() else tick}
        if attrs:
            rec["attrs"] = attrs
        self.events.append(rec)
        obs.emit("event", name, self.tick, **attrs)
        obs.counter(f"serve.{name}").inc()

    def _free_pages(self) -> Optional[int]:
        pages = getattr(self.pool, "pages", None)
        return None if pages is None else pages.n_free

    def _page_delta(self, name: str, before: Optional[int],
                    **attrs) -> None:
        """Emit a page alloc/grow/free event when the pool's free-page
        count moved across an operation (paged pools only)."""
        after = self._free_pages()
        if before is not None and after != before:
            self._emit(name, pages=abs(after - before), free=after, **attrs)

    # ------------------------------------------------------------------
    def _queued(self) -> List[RequestState]:
        return [s for s in self.states if s.phase is Phase.QUEUED]

    def _decoding(self) -> List[RequestState]:
        return [s for s in self.states if s.phase is Phase.DECODE]

    def _prefilling(self) -> List[RequestState]:
        return [s for s in self.states if s.phase is Phase.PREFILL]

    @property
    def all_done(self) -> bool:
        return all(s.done for s in self.states)

    def _prompt_tokens(self, req: Request) -> int:
        """Cache positions the prompt occupies (page pre-allocation)."""
        need = req.prompt_len
        if self.engine.cfg.frontend == "vision":
            need += self.engine.cfg.n_frontend_tokens
        return need

    # ------------------------------------------------------------------
    def _finish(self, st: RequestState) -> None:
        st.phase = Phase.DONE
        st.finish_tick = self.tick
        if self.walltime_fn is not None:
            st.finish_wall = self.walltime_fn()
        free0 = self._free_pages()
        self.pool.release(st.slot)
        self._emit("finish", rid=st.rid, slot=st.slot,
                   generated=st.n_generated,
                   latency=self.tick - st.request.arrival)
        self._page_delta("page_free", free0, rid=st.rid)
        if st.slot in self._rotation:
            self._rotation.remove(st.slot)

    def _preempt(self, st: RequestState, reason: str = "priority") -> None:
        """Evict an admitted request back to QUEUED.  Its slot/pages are
        freed and its generated tokens dropped — a later re-admission
        replays the exact same stream (sampling is keyed on (seed, step)),
        so preemption costs latency, never determinism.  TTFT keeps the
        first emission."""
        free0 = self._free_pages()
        self.pool.release(st.slot)
        self._emit("preempt", rid=st.rid, slot=st.slot, reason=reason,
                   phase=st.phase.name.lower())
        self._page_delta("page_free", free0, rid=st.rid)
        if st.slot in self._rotation:
            self._rotation.remove(st.slot)
        st.slot = -1
        st.phase = Phase.QUEUED
        st.generated.clear()
        st.prefill_left = 0
        self.n_preempted += 1

    @staticmethod
    def _victim(cands: List[RequestState]) -> Optional[RequestState]:
        """Deterministic eviction choice: lowest priority first, then the
        latest arrival (LIFO within a priority class), then highest rid."""
        if not cands:
            return None
        return min(cands, key=lambda s: (s.request.priority,
                                         -s.request.arrival, -s.rid))

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def _admit(self, st: RequestState) -> bool:
        free0 = self._free_pages()
        slot = self.pool.acquire(st.rid, seq_len=self._prompt_tokens(
            st.request))
        if slot is None:
            return False
        st.slot = slot
        st.phase = Phase.PREFILL
        st.admit_tick = self.tick
        self._emit("admit", rid=st.rid, slot=slot,
                   prompt=st.request.prompt_len,
                   priority=st.request.priority)
        self._page_delta("page_alloc", free0, rid=st.rid)
        if self.preemptible_prefill:
            # one row chunk per tick; the engine call runs when the last
            # chunk's tick completes (step() drives _prefill_advance)
            plan = self.engine.prefill_plan(st.request.prompt_len)
            st.prefill_chunks = plan.n_rows
            st.prefill_left = plan.n_rows
            return True
        self._run_prefill(st)
        return True

    def _run_prefill(self, st: RequestState) -> None:
        """The engine half of admission: run the (chunked) prefill, write
        the slot, sample token 0 (under a mesh: on the rank that holds the
        slot)."""
        logits = None
        if self.pool.owns(st.slot):
            logits, cache, st.prefill_chunks = self.engine.prefill(
                st.request)
            self.pool.write(st.slot, cache)
        else:
            st.prefill_chunks = self.engine.prefill_chunks(st.request)
        self.n_prefills += 1
        self._emit("prefill", rid=st.rid, slot=st.slot,
                   chunks=st.prefill_chunks)
        if not self.preemptible_prefill:
            self.tick += 1.0  # one engine call (chunk ticks counted already
            #                   by _prefill_advance in preemptible mode)
        if st.request.max_new_tokens <= 0:  # degenerate: prefill-only
            st.phase = Phase.DECODE
            self._finish(st)
            return
        tok = self._draw(logits, st, 0) if logits is not None else 0
        tok = self._checked(self._from_holder(st.slot, tok), st, 0)
        st.generated.append(tok)
        if st.first_token_tick < 0:
            st.first_token_tick = self.tick
        self.last_token[st.slot] = tok
        st.phase = Phase.DECODE
        self._rotation.append(st.slot)
        if st.finished_decoding():  # max_new_tokens == 1
            self._finish(st)

    def _prefill_advance(self) -> None:
        """Preemptible-prefill mode: spend this tick on one row chunk of
        the highest-priority in-flight prefill."""
        pre = self._prefilling()
        if not pre:
            return
        st = min(pre, key=lambda s: (-s.request.priority, s.admit_tick,
                                     s.request.arrival, s.rid))
        st.prefill_left -= 1
        self._emit("prefill_chunk", rid=st.rid, slot=st.slot,
                   left=st.prefill_left)
        self.tick += 1.0
        if st.prefill_left <= 0:
            self._run_prefill(st)

    def _admit_ready(self) -> None:
        if self.mode == "static" and self.pool.n_active:
            return  # static batching: only refill a drained pool
        arrived = [s for s in self._queued()
                   if s.request.arrival <= self.tick]
        # highest priority first; FIFO (arrival, rid) within a class —
        # identical to the original order when every priority is equal
        arrived.sort(key=lambda s: (-s.request.priority, s.request.arrival,
                                    s.rid))
        for st in arrived:
            if self._admit(st):
                continue
            if self.preemptible_prefill:
                victim = self._victim(
                    [p for p in self._prefilling()
                     if p.request.priority < st.request.priority])
                if victim is not None:
                    self._preempt(victim)
                    if self._admit(st):
                        continue
            break  # pool full — stays QUEUED (budget admission control)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _grow_or_preempt(self, st: RequestState) -> bool:
        """Page capacity for ``st``'s next token, evicting other decoders
        under page pressure.  False if ``st`` itself got impossible."""
        free0 = self._free_pages()
        while not self.pool.grow(st.slot):
            victim = self._victim([d for d in self._decoding()
                                   if d is not st])
            if victim is None:
                raise RuntimeError(
                    f"request {st.rid}: page pool exhausted with no "
                    f"preemption candidates — the plan's n_pages cannot "
                    f"hold one max-length request; raise n_pages/budget")
            self._preempt(victim, reason="page_pressure")
            free0 = self._free_pages()  # the eviction's pages fund the grow
        self._page_delta("page_grow", free0, rid=st.rid, slot=st.slot)
        return True

    def _decode_once(self) -> None:
        decoding = self._decoding()
        if self.decode_batch and len(decoding) > self.decode_batch:
            slots = self._rotation[: self.decode_batch]
            cohort = [s for s in decoding if s.slot in slots]
        else:
            slots = None
            cohort = decoding
        for st in list(cohort):
            if st.phase is Phase.DECODE:  # earlier preemption may evict it
                self._grow_or_preempt(st)
        cohort = [s for s in cohort if s.phase is Phase.DECODE]
        if slots is not None:
            live = {st.slot for st in cohort}
            slots = [s for s in slots if s in live]
            if len(slots) != self.decode_batch:
                # preemption shrank the cohort below the cohort width;
                # fall back to the full-pool shape this tick (growing the
                # decoders the cohort pass skipped)
                slots = None
                for st in self._decoding():
                    if st.slot not in live and st.phase is Phase.DECODE:
                        self._grow_or_preempt(st)
                cohort = self._decoding()
        if not cohort:
            return
        self._emit("decode", width=len(cohort),
                   cohort=sorted(st.slot for st in cohort),
                   full_pool=slots is None)
        # the slots this rank holds: all of them on one process
        local = self.pool.local_slots(slots)
        if local:
            view = self.pool.decode_view(slots)
            logits, view = self.engine.decode_step(self.last_token[local],
                                                   view)
            self.pool.absorb(view, slots)
        row = {s: i for i, s in enumerate(local)}
        if slots is not None:
            # rotate: this cohort goes to the back, then warm the next one
            self._rotation = ([s for s in self._rotation if s not in slots]
                              + [s for s in slots if s in self._rotation])
            nxt = self._rotation[: self.decode_batch]
            self.pool.prefetch(nxt)
            self._emit("cohort_prefetch", slots=list(nxt))
        self.n_decode_steps += 1
        self.tick += 1.0
        toks = self._gathered({
            st.slot: self._draw(logits[row[st.slot]], st, st.n_generated)
            for st in cohort if st.slot in row})
        for st in cohort:
            tok = self._checked(toks[st.slot], st, st.n_generated)
            st.generated.append(tok)
            self.last_token[st.slot] = tok
            if st.finished_decoding():
                self._finish(st)

    # ------------------------------------------------------------------
    def step(self) -> None:
        """One scheduler iteration: jump idle time, admit, advance one
        prefill chunk (preemptible mode), decode once."""
        queued = self._queued()
        if not self.pool.n_active and queued \
                and queued[0].request.arrival > self.tick:
            self.tick = queued[0].request.arrival  # fast-forward idle time
        before = self.tick
        self._admit_ready()
        self.max_active = max(self.max_active, self.pool.n_active)
        self._prefill_advance()
        if self._decoding():
            self._decode_once()
        if self.tick == before and not self.pool.n_active:
            # nothing ran and nothing is admitted: every remaining request
            # is unadmittable (e.g. a prompt larger than the page pool)
            stuck = [s.rid for s in self._queued()
                     if s.request.arrival <= self.tick]
            if stuck:
                raise RuntimeError(
                    f"scheduler stalled: requests {stuck} can never be "
                    f"admitted under this plan (pool/page capacity too "
                    f"small for a single request)")

    def run(self) -> ServeReport:
        while not self.all_done:
            self.step()
        if self.walltime_fn is not None and self.pool.mesh is not None:
            # every rank reports rank 0's completion stamps
            import torch
            walls = torch.tensor([s.finish_wall for s in self.states],
                                 dtype=torch.float64)
            for s, w in zip(self.states, broadcast_(walls, 0).tolist()):
                s.finish_wall = w
        return ServeReport(
            states=sorted(self.states, key=lambda s: s.rid),
            total_ticks=self.tick, n_prefills=self.n_prefills,
            n_decode_steps=self.n_decode_steps, max_active=self.max_active,
            n_preempted=self.n_preempted,
            prefetch_hits=self.pool.prefetch_hits, slo=self.slo,
            slot_history={i: list(h)
                          for i, h in enumerate(self.pool.history)},
            events=list(self.events))


def serve(params, cfg, requests: Sequence[Request], *,
          budget: int = 0, n_slots: int = 0, max_len: int = 0,
          enc_len: int = 0, prefill_budget: int = 0,
          mode: str = "continuous", mesh=None, residency: str = "",
          cache_kind: str = "full", page_size: int = 16, avg_len: int = 0,
          n_pages: int = 0, decode_residency: str = "",
          decode_batch: int = 0, preemptible_prefill: bool = False,
          slo: Optional[SLO] = None,
          walltime_fn: Optional[Callable[[], float]] = None,
          plan_cache: str = ""):
    """One-call serving loop: plan the pool, build engine + pool +
    scheduler, run to completion.  Returns (report, plan).  Runs on the
    parameters' device.

    ``residency=`` ("host"/"recompute") is recorded on every prompt's
    budget-chunked prefill plan.  ``cache_kind`` picks the pool layout
    ("full" / "paged_kv" / "quant_kv" or any registered kind); for paged
    pools ``avg_len`` defaults to the actual traffic's mean sequence
    length, which is what lets the planner admit more than worst-case
    slots.  ``decode_residency="host"`` keeps decode state in pinned host
    memory with the ``decode_batch`` cohort fetched one tick ahead;
    ``preemptible_prefill`` / ``slo`` are scheduler policy (see
    :class:`Scheduler` / :class:`SLO`).

    ``plan_cache`` (a directory) persists the resolved pool plan keyed by
    the pool-geometry inputs + hardware fingerprint: a hit replays the
    stored plan without re-running ``Planner.for_serve``.

    ``mesh=`` (a :class:`~repro_torch.exec.plan.MeshSpec`) shards the
    decode-slot pool over its batch axes: call it on every rank of a
    process group of ``mesh.n_devices`` ranks (row-major over the mesh),
    each with the same (whole) parameters and requests.  Each rank holds
    its ``slots_per_device`` slots, a request's chunked prefill runs on
    the rank holding its slot against ``prefill_budget // batch_extent``,
    and every rank returns the same report, whose streams equal one
    process's."""
    from repro_torch.exec.planner import Planner
    need = [r.prompt_len + r.max_new_tokens for r in requests]
    if cfg.frontend == "vision":
        need = [n + cfg.n_frontend_tokens for n in need]
    if not max_len:
        max_len = max(need)
    if cache_kind == "paged_kv" and not avg_len:
        avg_len = -(-sum(need) // len(need))  # ceil of the traffic mean
    n_max = max(1, min(256, len(requests)))

    def _solve():
        # more slots than requests would only widen every decode step
        return Planner.for_serve(cfg, max_len, budget=budget,
                                 enc_len=enc_len, n_slots=n_slots,
                                 mesh=mesh, n_max=n_max,
                                 cache_kind=cache_kind,
                                 page_size=page_size, avg_len=avg_len,
                                 n_pages=n_pages,
                                 decode_residency=decode_residency or None,
                                 decode_batch=decode_batch)

    if plan_cache:
        from repro_torch.exec.costmodel import hardware_fingerprint
        from repro_torch.exec.plancache import cached_plan
        plan, hit, key = cached_plan(plan_cache, dict(
            mode="serve", arch=cfg.name, max_len=max_len, budget=budget,
            n_slots=n_slots, enc_len=enc_len,
            mesh=mesh.describe() if mesh is not None else "",
            cache_kind=cache_kind, page_size=page_size, avg_len=avg_len,
            n_pages=n_pages, decode_residency=decode_residency or "",
            decode_batch=decode_batch, n_max=n_max,
            fingerprint=hardware_fingerprint(
                tree_leaves(params)[0].device)), _solve)
        print(f"plan cache: {'hit' if hit else 'miss'} key={key}")
    else:
        plan = _solve()
    if mesh is not None and prefill_budget:
        # a request's chunked prefill runs unsharded on one device, so it
        # must fit the PER-DEVICE slice of the budget, like everything else
        prefill_budget //= max(1, mesh.batch_extent)
    engine = ServeEngine(params, cfg, plan, prefill_budget=prefill_budget,
                         residency=residency)
    pool = make_pool(cfg, plan, device=engine.device)
    report = Scheduler(engine, pool, requests, mode=mode,
                       walltime_fn=walltime_fn,
                       preemptible_prefill=preemptible_prefill,
                       slo=slo).run()
    if obs.enabled():
        # plan audit: what the pool actually holds vs what for_serve
        # priced.  Pool buffers are allocated from the plan's own slot
        # and page formulae, so the ratio should sit near 1.0 — drift
        # means a pricing regression in decode_slot_bytes / page_bytes /
        # a registered cache-bytes fn.  A host-resident pool holds the
        # FULL bytes the ``host_bytes`` extra prices, in pinned host
        # memory (the device estimate is only the transit set).  A
        # sharded pool's bytes are summed over the batch-axes group (the
        # model axis replicates them) and held to the global estimate.
        import torch
        from repro_torch.obs.audit import live_bytes, plan_audit
        host = int(plan.get("host_bytes", 0) or 0)
        est = host if host else int(plan.est_bytes or 0)
        live = live_bytes(pool.caches)
        if pool.batch_group is not None:
            live = int(all_reduce_(torch.tensor([live], dtype=torch.int64),
                                   pool.batch_group)[0])
        measured = {"peak_bytes": live, "live_buffer_bytes": live}
        report.plan_audit = plan_audit(
            plan, measured, "serve_pool",
            extra={"n_slots": pool.n_slots,
                   "audited_term": "host_bytes" if host else "est_bytes"},
            est_bytes=est)
    return report, plan
