"""The Planner: Eqs. 7-16 as a policy solver producing ExecutionPlans
(counterpart of ``repro.exec.planner``).

Ported: CNN estimates, explicit (engine, N) plans and solves for all six
CNN engines — the checkpointed ones (Ckp / 2PS-H / OverL-H) priced as
segment-input checkpoints plus the worst segment's inner-strategy peak —
under a :class:`ResidencySpec` (an offloading one re-prices 2PS's SD caches
as a transit buffer); ``resolve`` of a :class:`PlanRequest` with an
automatic engine or a pinned N; ``for_budget`` in the static Table I order
with the ``residencize`` fallback; the sequence side (``seq_estimate``,
``for_budget_seq``, ``for_model``: Eq. 7 along the token axis); and the
kernel pass (:func:`kernelize_plan`) that swaps an engine for its
CUDA-backed alternate when the kernel can run it.  The kernel pass prices
what each CUDA kernel needs — one CTA's shared memory against Hopper's
227 KiB and the types it takes
(:func:`repro_torch.kernels.conv2d_rows.launch_problem`,
:func:`repro_torch.kernels.swa_attention.launch_problem`,
:func:`repro_torch.kernels.ssd_chunk.launch_problem`) — where the
reference priced a VMEM row block against 16 MiB and MXU alignment.
Measured-cost planning: ``predict_plan_us`` (a roofline over a
:class:`~repro_torch.exec.costmodel.CostTable`), the costed ``for_budget``
that ranks every feasible candidate by it, and ``autotune_kernel``, which
times the feasible tile candidates on the card.  Every public solve entry
point bumps the ``planner.solves`` obs counter, as in the reference.

The serving half sizes the decode-cache pool (``decode_slot_bytes``,
``page_bytes``, ``for_serve``: Eq. 7 applied to decode slots), with the
per-layer-kind byte estimators in the ``SERVE_CACHE_BYTES`` registry; its
integers equal the reference's.

The staged half plans the row pipeline (``pipeline_rows``,
:mod:`repro_torch.exec.pipeline`): ``estimate_staged`` prices the worst
stage per device (its GPipe stash, its OverL working set and its share of
``xi`` over the model axis), ``plan_staged`` / ``solve_staged`` pin or
solve N at an even S-stage partition, ``stagedize`` fits a
single-stage-infeasible budget by pipelining stages over the model axis,
the costed ``for_budget`` ranks the staged alternates beside the rest, and
``predict_plan_us`` charges the GPipe bubble ``1 + (S-1)/N``.  Their
integers and plan JSON equal the reference's.
"""

from __future__ import annotations

from dataclasses import replace as dataclasses_replace
from typing import Callable, Dict, Optional, Sequence, Tuple

from repro_torch import obs
from repro_torch.core import rowplan as _rp
from repro_torch.core import twophase as _tp
from repro_torch.core.hybrid import auto_segments, max_rows_per_segment
from repro_torch.exec.plan import (
    ExecutionPlan, KernelSpec, MeshSpec, PlanRequest, ResidencySpec,
    StageSpec, batch_shards,
)
from repro_torch.kernels import ssd_chunk as _ssd
from repro_torch.kernels import swa_attention as _swa
from repro_torch.kernels.conv2d_rows import SMEM_LIMIT, launch_problem
from repro_torch.kernels.ops import candidate_tiles

CNN_ENGINES = ("base", "ckp", "overlap", "twophase", "overlap_h",
               "twophase_h")
#: auto-selection order under a budget (least runtime overhead first)
BUDGET_PREFERENCE = ("base", "twophase", "overlap", "twophase_h",
                     "overlap_h", "ckp")
#: per-segment strategy of each checkpointed engine
INNER_STRATEGY = {"ckp": "column", "overlap_h": "overlap",
                  "twophase_h": "twophase"}
#: engines whose device-byte estimate changes under an offloading
#: ResidencySpec — the carry-based CNN engines (OverL replicates its halo
#: instead of carrying it, so residency cannot shrink it)
RESIDENCY_ENGINES = ("twophase", "twophase_h")
#: plain engine -> its CUDA-backed alternate with the same call signature
#: (base and overlap both map to overlap_cuda: the kernel's row tiling is
#: internal, so its full-tensor apply is a drop-in for either)
CUDA_ALTERNATE = {"base": "overlap_cuda", "overlap": "overlap_cuda",
                  "seq_swa_overlap": "seq_swa_cuda"}
CUDA_ENGINES = ("overlap_cuda", "seq_swa_cuda", "seq_ssd_cuda")


def _count_solve() -> None:
    """Bump the ``planner.solves`` obs counter (a no-op without an active
    obs session): every public solve entry point calls this, which is
    what shows "plan-cache hit => zero planner solves" in the metrics
    dump."""
    obs.counter("planner.solves").inc()


def _offloads(residency: Optional[ResidencySpec]) -> bool:
    """True when the spec moves EVERY cache off-device (default host /
    recompute with no per-cache override back to device).  A spec that
    pins some caches on device keeps the full device-resident estimate:
    pricing is never optimistic."""
    return residency is not None and residency.default != "device" \
        and all(p != "device" for _, p in residency.placements)


def derive_segments(modules: Sequence, h0: int, inner: str, n_rows: int,
                    n_segments: Optional[int]
                    ) -> Tuple[Tuple[int, int, int], ...]:
    """The one segmentation rule shared by planner estimates and engine
    builders: sqrt(L) even cuts with per-segment granularity caps
    (Table I).  Returns (start, end, n_rows) triples."""
    cuts = auto_segments(len(modules), n_segments)
    if inner == "column":
        return tuple((a, b, 1) for a, b in cuts)
    caps = max_rows_per_segment(modules, h0, cuts, inner)
    return tuple((a, b, max(1, min(n_rows, cap)))
                 for (a, b), cap in zip(cuts, caps))


def segment_row_capacity(modules: Sequence, h0: int, inner: str,
                         n_segments: Optional[int] = None
                         ) -> Tuple[Tuple[int, int, int], ...]:
    """Per-segment granularity caps under sqrt(L) segmentation — the
    Table I counters, as plan-shaped (start, end, cap) triples."""
    cuts = auto_segments(len(modules), n_segments)
    caps = max_rows_per_segment(modules, h0, cuts, inner)
    return tuple((a, b, cap) for (a, b), cap in zip(cuts, caps))


# ---------------------------------------------------------------------------
# Kernel-execution policy: plain <-> cuda engine selection
# ---------------------------------------------------------------------------


def _cuda_infeasible(target: str, plan: ExecutionPlan, spec: KernelSpec,
                     modules: Optional[Sequence],
                     smem_limit: int) -> Tuple[str, dict]:
    """``(reason, pricing)``: why ``target`` cannot run ``spec``'s tiling
    ("" when it can) plus the pricing extras to record on the plan.  A
    conv layer counts when the halo precondition holds; every counted
    layer must then pass the kernel's launch limits.  The sequence engines
    are priced against the plan's ``seq`` extra (required: the kernels
    raise on a tiling that does not divide it); ``seq_swa_cuda`` against
    its ``head_dim`` extra too, ``seq_ssd_cuda`` against fp32 and its
    ``ssm_state`` extra (the state size N)."""
    if target in ("seq_swa_cuda", "seq_ssd_cuda"):
        return _seq_infeasible(target, plan, spec, smem_limit)
    if target != "overlap_cuda":
        return f"engine {plan.engine!r} has no cuda alternate", {}
    if plan.in_shape is None:
        return "plan has no in_shape to tile over", {}
    if modules is None:
        return "module list unavailable for shared-memory pricing", {}
    from repro_torch.exec.kernel_engines import conv_tiles
    n_ok, worst = 0, 0
    for m, _, out, eligible, smem in conv_tiles(modules, plan.in_shape,
                                                spec):
        if not eligible:
            continue
        n_ok += 1
        worst = max(worst, smem)
        bh = max(1, min(spec.block_h, out[0]))
        problem = launch_problem(bh, m.s, m.k, m.cout, plan.dtype_bytes,
                                 smem_limit)
        if problem:
            return problem, {}
    if not n_ok:
        return (f"no conv layer admits the halo precondition at "
                f"block_h={spec.block_h}"), {}
    return "", {"kernel_smem_bytes": worst, "kernel_layers": n_ok}


def _seq_infeasible(target: str, plan: ExecutionPlan, spec: KernelSpec,
                    smem_limit: int) -> Tuple[str, dict]:
    seq = int(plan.get("seq", 0))
    if not seq:
        return (f"plan has no 'seq' extra to validate {target!r} tiling "
                f"against"), {}
    if target == "seq_ssd_cuda":
        return _ssd_infeasible(plan, spec, seq, smem_limit)
    try:
        bq, bk, _, _ = _swa.tiles(seq, 0, spec.bq, spec.bk)
    except ValueError as e:
        return str(e), {}
    d = int(plan.get("head_dim", 0))
    if not d:
        return "", {}
    problem = _swa.launch_problem(bq, bk, d, plan.dtype_bytes, smem_limit)
    if problem:
        return problem, {}
    return "", {"kernel_smem_bytes": _swa.smem_bytes(bq, bk, d,
                                                     plan.dtype_bytes)}


def _ssd_infeasible(plan: ExecutionPlan, spec: KernelSpec, seq: int,
                    smem_limit: int) -> Tuple[str, dict]:
    """The reference's chunk-divides-seq rule, then the kernel's own:
    fp32 only, and one CTA's shared memory at the plan's state size."""
    chunk = min(spec.chunk, seq)
    if seq % chunk:
        return f"ssd chunk={chunk} does not divide seq={seq}", {}
    if plan.dtype_bytes != 4:
        return (f"the CUDA ssd_scan kernel is fp32-only (dtype_bytes="
                f"{plan.dtype_bytes})"), {}
    n = int(plan.get("ssm_state", 0))
    if not n:
        return "", {}
    problem = _ssd.launch_problem(chunk, n, smem_limit)
    if problem:
        return problem, {}
    return "", {"kernel_smem_bytes": _ssd.smem_bytes(chunk, n)}


def _tile_candidates(target: str, plan: ExecutionPlan) -> tuple:
    """The deterministic tile search space for ``target`` against this
    plan's geometry (``candidate_tiles``, as in the reference)."""
    if target == "seq_swa_cuda":
        return candidate_tiles("swa", seq=int(plan.get("seq", 0)))
    if target == "seq_ssd_cuda":
        return candidate_tiles("ssd", seq=int(plan.get("seq", 0)))
    h = plan.in_shape[0] if plan.in_shape else 0
    return candidate_tiles("conv", h_out=h)


def _fmt_tiles(tiles: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in sorted(tiles.items()))


def _kernel_fallback(plan: ExecutionPlan, spec: KernelSpec,
                     reason: str) -> ExecutionPlan:
    plain = dataclasses_replace(spec, backend="plain")
    return dataclasses_replace(plan.with_extras(kernel_fallback=reason),
                               kernel=plain)


def kernelize_plan(plan: ExecutionPlan, spec,
                   modules: Optional[Sequence] = None,
                   smem_limit: int = SMEM_LIMIT) -> ExecutionPlan:
    """Apply a kernel-execution policy to a resolved plan.

    ``spec`` is a :class:`KernelSpec` or a bare backend string.  With the
    plain backend the spec is attached.  With the cuda backend the engine
    is swapped for its CUDA-backed alternate (:data:`CUDA_ALTERNATE`) when
    the tiling is feasible; otherwise the plan keeps its engine and records
    why under the ``kernel_fallback`` extra.  A bare ``"cuda"`` string means
    "any feasible tiling": when the default tiles are rejected, the
    ``candidate_tiles`` enumeration is searched and the first feasible
    candidate wins (``kernel_retile`` extra).  Estimates are untouched."""
    retile = isinstance(spec, str)
    if retile:
        spec = KernelSpec(backend=spec)
    if spec.backend != "cuda":
        return dataclasses_replace(plan, kernel=spec)
    target = CUDA_ALTERNATE.get(plan.engine, plan.engine)
    if target not in CUDA_ENGINES:
        return _kernel_fallback(
            plan, spec, f"engine {plan.engine!r} has no cuda alternate")
    reason, pricing = _cuda_infeasible(target, plan, spec, modules,
                                       smem_limit)
    if reason and retile:
        for tiles in _tile_candidates(target, plan):
            cand = dataclasses_replace(spec, **tiles)
            if cand == spec:
                continue  # the default already failed above
            r2, p2 = _cuda_infeasible(target, plan, cand, modules,
                                      smem_limit)
            if not r2:
                out = dataclasses_replace(plan, engine=target, kernel=cand)
                return out.with_extras(
                    kernel_retile=(f"default tiling infeasible ({reason}); "
                                   f"first feasible candidate "
                                   f"{_fmt_tiles(tiles)}"), **p2)
        return _kernel_fallback(
            plan, spec, f"{reason}; no candidate tiling feasible either")
    if reason:
        return _kernel_fallback(plan, spec, reason)
    out = dataclasses_replace(plan, engine=target, kernel=spec)
    return out.with_extras(**pricing) if pricing else out


# ---------------------------------------------------------------------------
# The Planner
# ---------------------------------------------------------------------------


def _seq_extras(axis: int, seq: int, d_model: int, window: int,
                head_dim: int) -> tuple:
    """A sequence plan's extras: ``window`` for the SWA engines and
    ``head_dim`` so that :func:`kernelize_plan` can price the kernel."""
    extras = {"axis": axis, "seq": seq, "d_model": d_model}
    if window:
        extras["window"] = window
    if head_dim:
        extras["head_dim"] = head_dim
    return tuple(extras.items())


# ---------------------------------------------------------------------------
# Serving-side estimates: decode-slot bytes (policy half of repro_torch.serve)
# ---------------------------------------------------------------------------

#: per-layer-kind decode cache byte estimators: fn(cfg, max_len, db) -> bytes
#: for ONE slot (one batch element).  repro_torch.serve.cache_pool registers
#: the matching init mechanism.  A bare layer kind ("attn", "mamba", ...)
#: prices that layer's cache under the contiguous ("full") pool; a
#: qualified "<cache_kind>/<layer_kind>" key overrides it under another
#: pool kind (lookups try the qualified key first), so a pool kind only
#: overrides the layers it changes (ring-window 'local' caches and
#: recurrent states stay slot-resident under paging).
SERVE_CACHE_BYTES: Dict[str, Callable] = {}


def register_cache_bytes(kind: str, fn: Optional[Callable] = None):
    """Register a per-slot byte estimator for a decode cache kind."""
    def _do(f):
        if kind in SERVE_CACHE_BYTES:
            raise ValueError(f"cache kind {kind!r} already registered")
        SERVE_CACHE_BYTES[kind] = f
        return f

    if fn is not None:
        return _do(fn)
    return _do


def _kv_bytes(cfg, cache_len: int, db: int) -> int:
    # k + v (cache_len, KV, hd) each, + the int32 "pos" scalar per slot
    return 2 * cache_len * cfg.n_kv_heads * cfg.head_dim * db + 4


register_cache_bytes(
    "attn", lambda cfg, max_len, db: _kv_bytes(cfg, max_len, db))
for _k in ("global", "shared_attn", "moe"):
    register_cache_bytes(_k, SERVE_CACHE_BYTES["attn"])
register_cache_bytes(
    "local", lambda cfg, max_len, db: _kv_bytes(
        cfg, min(cfg.sliding_window, max_len), db))


@register_cache_bytes("mamba")
def _mamba_state_bytes(cfg, max_len, db):
    inner = cfg.ssm_expand * cfg.d_model
    heads = cfg.ssm_heads or cfg.n_heads
    state_n = cfg.ssm_state or 64
    h = heads * (inner // heads) * state_n * 4          # fp32 state
    conv = (cfg.conv_k - 1) * (inner + 2 * state_n) * db
    return h + conv


@register_cache_bytes("mlstm")
def _mlstm_state_bytes(cfg, max_len, db):
    H = cfg.n_heads
    hd = (cfg.ssm_expand * cfg.d_model) // H
    return 4 * (H * hd * hd + H * hd + H)               # C, n, m (fp32)


register_cache_bytes(
    "slstm", lambda cfg, max_len, db: 4 * 4 * cfg.d_model)  # c,n,h,m fp32


# paged_kv: full-attention K/V rows live in the shared page pool, so a
# slot's resident decode state is the int32 "pos" scalar (the block table
# is host-side numpy bookkeeping); pages are priced by Planner.page_bytes
for _k in ("attn", "global", "shared_attn", "moe"):
    register_cache_bytes(f"paged_kv/{_k}", lambda cfg, max_len, db: 4)


def _quant_kv_bytes(cfg, max_len, db):
    # int8 k + v codes, one fp32 scale per (position, kv-head) block, + pos
    rows = max_len * cfg.n_kv_heads
    return 2 * rows * cfg.head_dim + 2 * rows * 4 + 4


for _k in ("attn", "global", "shared_attn", "moe"):
    register_cache_bytes(f"quant_kv/{_k}", _quant_kv_bytes)


def serve_cache_kinds() -> Tuple[str, ...]:
    """Registered pool cache kinds: "full" plus every qualified prefix."""
    kinds = {"full"}
    kinds.update(k.split("/", 1)[0] for k in SERVE_CACHE_BYTES if "/" in k)
    return tuple(sorted(kinds))


class _ServePlannerMixin:
    """decode_slot_bytes / page_bytes / for_serve, mixed into
    :class:`Planner` below."""

    @staticmethod
    def decode_slot_bytes(cfg, max_len: int, enc_len: int = 0,
                          cache_kind: str = "full") -> int:
        """Decode-state bytes ONE request pins for its whole lifetime: KV
        rows for attention kinds (ring-capped for 'local'), recurrent
        state for SSM kinds, plus the cross-attention K/V of ``enc_len``
        encoder positions for the encoder-decoder — Eq. 7 applied to
        serving, with decode slots as the rows.  ``cache_kind`` routes
        each layer kind through its qualified estimator when one is
        registered, so under ``"paged_kv"`` this is the slot's *resident*
        bytes (pages are priced by :meth:`page_bytes`).  Enc-dec pools
        are ``full`` only (their cross caches are precomputed whole)."""
        db = 2 if cfg.dtype == "bfloat16" else 4
        if cfg.family == "encdec":
            if cache_kind != "full":
                raise ValueError(
                    f"cache kind {cache_kind!r} does not support enc-dec "
                    f"pools (cross-attention caches are precomputed "
                    f"whole); use cache_kind='full'")
            # decoder layers: self-attn KV + precomputed cross K/V (no pos)
            cross = 2 * enc_len * cfg.n_kv_heads * cfg.head_dim * db
            return cfg.n_layers * (_kv_bytes(cfg, max_len, db) + cross)
        total = 0
        for kind in cfg.layer_kinds():
            fn = SERVE_CACHE_BYTES.get(f"{cache_kind}/{kind}") \
                if cache_kind != "full" else None
            if fn is None:
                try:
                    fn = SERVE_CACHE_BYTES[kind]
                except KeyError:
                    raise KeyError(
                        f"no decode-cache byte estimator for layer kind "
                        f"{kind!r}; register one with repro_torch.exec."
                        f"planner.register_cache_bytes") from None
            total += fn(cfg, max_len, db)
        return total

    @staticmethod
    def page_bytes(cfg, page_size: int) -> int:
        """Device bytes ONE page adds to a ``paged_kv`` pool: a
        (page_size, kv_heads, head_dim) K and V tile per paged layer
        (ring-window and state kinds stay slot-resident)."""
        db = 2 if cfg.dtype == "bfloat16" else 4
        n = sum(1 for kind in cfg.layer_kinds()
                if f"paged_kv/{kind}" in SERVE_CACHE_BYTES)
        return n * 2 * page_size * cfg.n_kv_heads * cfg.head_dim * db

    @classmethod
    def for_serve(cls, cfg, max_len: int, budget: int = 0,
                  enc_len: int = 0, n_slots: int = 0,
                  n_max: int = 256, mesh=None, cache_kind: str = "full",
                  page_size: int = 16, avg_len: int = 0, n_pages: int = 0,
                  decode_residency=None,
                  decode_batch: int = 0) -> ExecutionPlan:
        """Size the decode cache pool: the largest slot count whose pinned
        decode state fits ``budget`` (or an explicit ``n_slots``).  Returns
        an ``engine="serve_pool"`` plan whose ``extras`` carry the pool
        geometry :mod:`repro_torch.serve.cache_pool` honours verbatim.

        ``cache_kind``: ``"full"`` (contiguous worst-case slots),
        ``"quant_kv"`` (int8 codes + scales) or ``"paged_kv"`` (tiny
        resident state plus pages of a shared pool: the budget buys
        ``avg_len``-sized page shares instead of ``max_len`` worst cases).
        ``n_pages`` pins the page-pool size (default: the worst case under
        a pinned ``n_slots``, the budget's remainder otherwise).

        ``decode_residency="host"`` keeps the pool in host memory: the
        device holds the hot cohort's dense transit view (``(1 +
        prefetch_depth) * decode_batch`` slots), which is what the budget
        must cover; the pool's own bytes go under the ``host_bytes``
        extra.

        With ``mesh=`` decode slots shard across the batch axes: the
        global ``budget`` is divided by the batch extent to get each
        device's slice, each device pins the ``slots_per_device`` slots
        that slice buys, and the global slot count is their product
        (rounded up to a multiple of the extent when ``n_slots`` is
        pinned, so the pool's slot axis divides evenly).  Paged/quant
        pools and decode-state residency are single-host."""
        _count_solve()
        known = serve_cache_kinds()
        if cache_kind not in known:
            raise KeyError(
                f"unknown pool cache kind {cache_kind!r}; known: "
                f"{list(known)} — register a '<kind>/<layer>' estimator "
                f"with repro_torch.exec.planner.register_cache_bytes and "
                f"the matching init/pool with repro_torch.serve.cache_pool")
        if isinstance(decode_residency, str):
            decode_residency = ResidencySpec.parse(decode_residency)
        if decode_residency is not None \
                and decode_residency.default == "recompute":
            raise ValueError("decode state cannot be recomputed (tokens "
                             "depend on it); use 'host' or 'device' "
                             "decode residency")
        shards = mesh.batch_extent if mesh is not None else 1
        if shards > 1 and (cache_kind != "full"
                           or decode_residency is not None):
            raise ValueError(
                f"cache kind {cache_kind!r} / decode-state residency "
                f"pools are single-host; drop mesh= or use the default "
                f"contiguous kind")
        host = decode_residency is not None \
            and decode_residency.default == "host"
        slot = cls.decode_slot_bytes(cfg, max_len, enc_len,
                                     cache_kind=cache_kind)
        dev_budget = budget // shards
        extras = {"max_len": max_len, "slot_bytes": slot,
                  "cache_kind": cache_kind}
        if decode_batch:
            extras["decode_batch"] = int(decode_batch)
        if cache_kind == "paged_kv":
            pb = cls.page_bytes(cfg, page_size)
            if not pb:
                raise ValueError(
                    f"{cfg.name}: no paged-eligible layer kinds "
                    f"({sorted(set(cfg.layer_kinds()))}) — every cache is "
                    f"slot-resident, so paging buys nothing; use "
                    f"cache_kind='full'")
            mp = -(-max_len // page_size)
            avg = int(avg_len) or max_len
            app = max(1, -(-avg // page_size))  # expected pages per request
            if n_slots:
                per_dev = n_slots
                n_pages = n_pages or n_slots * mp    # worst case: no sharing
            elif budget:
                per_req = slot + app * pb
                per_dev = max(1, min(n_max, dev_budget // per_req))
                n_pages = n_pages or max(per_dev * app,
                                         (dev_budget - per_dev * slot) // pb)
            else:
                per_dev = 1
                n_pages = n_pages or mp
            n_pages = max(1, int(n_pages))
            per_dev_est = per_dev * slot + n_pages * pb
            n_slots = per_dev * shards               # shards == 1 here
            extras.update(page_size=int(page_size), n_pages=n_pages,
                          page_bytes=pb, avg_len=avg)
        else:
            if not n_slots:
                if budget:
                    per_dev = max(1, min(max(1, n_max // shards),
                                         dev_budget // slot))
                else:
                    per_dev = 1
                n_slots = per_dev * shards
            else:
                per_dev = -(-n_slots // shards)   # ceil: even slot sharding
                n_slots = per_dev * shards
            per_dev_est = per_dev * slot
        if host:
            # the pool lives in host memory; the device holds the hot
            # cohort's dense transit view (current fetch + prefetch_depth
            # in flight), so that is what the budget must cover
            dense_slot = cls.decode_slot_bytes(cfg, max_len, enc_len)
            hot = int(decode_batch) or per_dev
            extras["host_bytes"] = per_dev_est
            per_dev_est = min(per_dev, hot * (
                1 + decode_residency.prefetch_depth)) * dense_slot
        extras["slots_per_device"] = per_dev
        if cfg.family == "encdec":
            extras["enc_len"] = enc_len
        return ExecutionPlan(
            engine="serve_pool", n_rows=n_slots, in_shape=None,
            batch=n_slots, dtype_bytes=2 if cfg.dtype == "bfloat16" else 4,
            est_bytes=per_dev_est * shards, est_bytes_per_device=per_dev_est,
            budget=budget,
            feasible=(budget == 0 or per_dev_est < dev_budget),
            mesh=mesh, residency=decode_residency,
            extras=tuple(extras.items()))


class Planner(_ServePlannerMixin):
    """Solves (engine, N) for a CNN trunk.  ``xi`` is the paper's constant
    (params + grads + optimizer state) added to every estimate.  A mesh
    divides batch and budget per device, as in the reference, and its
    model extent stages the row pipeline.  With a ``cost_table``
    (:class:`~repro_torch.exec.costmodel.CostTable`) budget-driven
    selection ranks feasible candidates by predicted step time instead of
    the static Table I order."""

    def __init__(self, modules: Sequence, in_shape: Tuple[int, int, int],
                 batch: int, dtype_bytes: int = 4, xi: int = 0,
                 n_max: int = 64, mesh: Optional[MeshSpec] = None,
                 cost_table=None):
        self.modules = list(modules)
        self.in_shape = tuple(in_shape)
        self.batch = batch
        self.dtype_bytes = dtype_bytes
        self.xi = xi
        self.n_max = n_max
        self.mesh = mesh
        self.cost_table = cost_table
        shards = mesh.batch_extent if mesh is not None else 1
        if shards > 1 and batch % shards:
            raise ValueError(f"global batch {batch} does not divide over "
                             f"the mesh batch axes ({shards})")
        self.dev_batch = batch // shards
        self.shards = shards

    # -- estimates ---------------------------------------------------------
    def _shapes(self):
        return _rp.shape_chain(self.modules, self.in_shape)

    def _segments(self, n_rows: int, inner: str,
                  n_segments: Optional[int]
                  ) -> Tuple[Tuple[int, int, int], ...]:
        return derive_segments(self.modules, self.in_shape[0], inner,
                               n_rows, n_segments)

    def _twophase_offloaded(self, modules, in_shape, n_rows: int,
                            residency: ResidencySpec) -> int:
        """Device bytes of a 2PS block whose SD caches leave device
        memory: the Eq. 8 BP baseline plus the transit buffer — the
        largest single row's caches times the rows' worth concurrently on
        the device (``1 + prefetch_depth`` fetches for host residency;
        producer + consumer of the recompute chain for recompute; summed
        for a mixed spec, capped at the N-1 importing rows)."""
        base = _rp.omega_bp(modules, in_shape, self.dev_batch, n_rows,
                            self.dtype_bytes)
        return base + self._twophase_transit(modules, in_shape, n_rows,
                                             residency)

    def _twophase_transit(self, modules, in_shape, n_rows: int,
                          residency: ResidencySpec) -> int:
        """The transit buffer of :meth:`_twophase_offloaded`."""
        rows = _rp.twophase_cache_row_bytes(modules, in_shape,
                                            self.dev_batch, n_rows,
                                            self.dtype_bytes)
        buf = max(rows) if rows else 0
        policies = {residency.default} | {p for _, p in
                                          residency.placements}
        mult = 0
        if "host" in policies:
            mult += 1 + residency.prefetch_depth
        if "recompute" in policies:
            mult += 2
        mult = min(mult, max(1, n_rows - 1))
        return mult * buf

    def _estimate_segmented(self, segments, inner: str,
                            residency: Optional[ResidencySpec] = None
                            ) -> int:
        """Checkpoint bytes (segment-input maps stay live FP->BP) + the
        worst per-segment peak under the inner strategy."""
        shapes = self._shapes()
        db, B = self.dtype_bytes, self.dev_batch
        ckpt = sum(B * shapes[a][0] * shapes[a][1] * shapes[a][2] * db
                   for a, _, _ in segments if a > 0)
        worst = 0
        for a, b, n in segments:
            sub = self.modules[a:b]
            if inner == "column":
                est = _rp.omega_column(sub, shapes[a], B, db)
            elif inner == "twophase" and _offloads(residency):
                est = self._twophase_offloaded(sub, shapes[a], n, residency)
            else:
                est = _rp.estimate_bytes(sub, shapes[a], B, inner, n, db)
            worst = max(worst, est)
        return ckpt + worst

    def estimate(self, engine: str, n_rows: int,
                 n_segments: Optional[int] = None,
                 segments: Tuple[Tuple[int, int, int], ...] = (),
                 residency: Optional[ResidencySpec] = None,
                 stage: Optional[StageSpec] = None) -> int:
        """Peak activation bytes ONE device holds, plus ``xi``.
        ``residency`` re-prices the carry-based engines' SD caches; the
        other engines carry nothing, so theirs is residency-invariant.
        ``stage`` routes ``"pipeline_rows"`` through the per-stage
        accounting (:meth:`estimate_staged`)."""
        if engine == "pipeline_rows":
            return self.estimate_staged(
                n_rows, stage or self._default_stage_spec())
        if engine == "base":
            return _rp.omega_column(self.modules, self.in_shape,
                                    self.dev_batch, self.dtype_bytes) + self.xi
        if engine in ("overlap", "twophase"):
            if engine == "twophase" and _offloads(residency):
                return self._twophase_offloaded(
                    self.modules, self.in_shape, n_rows, residency) + self.xi
            return _rp.estimate_bytes(self.modules, self.in_shape,
                                      self.dev_batch, engine, n_rows,
                                      self.dtype_bytes, self.xi)
        if engine in INNER_STRATEGY:
            inner = INNER_STRATEGY[engine]
            segs = segments or self._segments(n_rows, inner, n_segments)
            return self._estimate_segmented(segs, inner, residency) + self.xi
        raise ValueError(f"unknown CNN engine {engine!r}; known: "
                         f"{list(CNN_ENGINES)}")

    def _block_terms(self, modules, in_shape, inner: str, n_rows: int,
                     residency: Optional[ResidencySpec]) -> dict:
        """One block's estimate under ``inner`` as named terms."""
        db, B = self.dtype_bytes, self.dev_batch
        if inner == "column":
            return {"feature_maps": _rp.omega_column(modules, in_shape, B,
                                                     db)}
        terms = {"bp_rows": _rp.omega_bp(modules, in_shape, B, n_rows, db)}
        if inner == "overlap":
            terms["halo_share"] = _rp.overlap_halo_bytes(
                modules, in_shape, B, n_rows, db) // max(1, n_rows)
        elif _offloads(residency):
            terms["sd_transit"] = self._twophase_transit(
                modules, in_shape, n_rows, residency)
        else:
            terms["sd_caches"] = _rp.twophase_cache_bytes(
                modules, in_shape, B, n_rows, db)
        return terms

    def estimate_terms(self, plan: ExecutionPlan) -> dict:
        """``plan``'s per-device estimate as the terms :meth:`estimate`
        adds, in bytes, so a measured peak can be read against each:
        ``feature_maps`` (``base``, column segments), ``bp_rows`` (the
        Eq. 8 row baseline) with ``halo_share`` (OverL), ``sd_caches``
        (2PS, device-resident) or ``sd_transit`` (2PS, offloaded); the
        hybrids add ``checkpoints`` and price their worst segment, whose
        terms carry a ``segment.`` prefix; every plan adds ``xi``.  The
        values sum to ``estimate`` for the plan's engine, N, segments and
        residency.  A pipelined plan prices its worst stage: ``stash``
        (the GPipe stash at the stage's input), its OverL terms under a
        ``stage.`` prefix and its share of ``xi``.  A CUDA alternate keeps the estimate of the engine it
        replaced, so ``overlap_cuda`` is split as ``overlap`` or, where
        that does not give its estimate, as ``base``."""
        if plan.engine == "overlap_cuda":
            split = [self.estimate_terms(dataclasses_replace(plan, engine=e))
                     for e in ("overlap", "base")]
            return next((t for t in split if sum(t.values())
                         == plan.est_bytes_per_device), split[0])
        engine = plan.engine
        res, n = plan.residency, max(1, plan.n_rows)
        if engine == "pipeline_rows":
            return self._staged_terms(n, plan.stage
                                      or self._default_stage_spec())
        if engine == "base":
            terms = self._block_terms(self.modules, self.in_shape, "column",
                                      1, res)
        elif engine in ("overlap", "twophase"):
            terms = self._block_terms(self.modules, self.in_shape, engine,
                                      n, res)
        elif engine in INNER_STRATEGY:
            inner = INNER_STRATEGY[engine]
            segs = plan.segments or self._segments(n, inner,
                                                   plan.n_segments)
            shapes = self._shapes()
            terms = {"checkpoints": sum(
                self.dev_batch * shapes[a][0] * shapes[a][1] * shapes[a][2]
                * self.dtype_bytes for a, _, _ in segs if a > 0)}
            worst = None
            for a, b, sn in segs:
                t = self._block_terms(self.modules[a:b], shapes[a], inner,
                                      sn, res)
                if worst is None or sum(t.values()) > sum(worst.values()):
                    worst = t
            terms.update({f"segment.{k}": v for k, v in worst.items()})
        else:
            raise ValueError(f"estimate_terms: {plan.engine!r} is not a CNN "
                             f"engine; known: {list(CNN_ENGINES)}")
        terms["xi"] = self.xi
        return terms

    def _staged_terms(self, n_rows: int, stage: StageSpec) -> dict:
        """:meth:`estimate_staged`'s worst stage as named terms."""
        shapes = self._shapes()
        db, B = self.dtype_bytes, self.dev_batch
        worst = None
        for a, b in stage.stages:
            t = {"stash": (B * shapes[a][0] * shapes[a][1] * shapes[a][2]
                           * db if a > 0 else 0)}
            t.update({f"stage.{k}": v for k, v in self._block_terms(
                self.modules[a:b], shapes[a], "overlap", n_rows,
                None).items()})
            if worst is None or sum(t.values()) > sum(worst.values()):
                worst = t
        model = self.mesh.model if self.mesh is not None else 1
        worst["xi"] = self.xi // max(1, model)
        return worst

    def sd_volume(self, plan: ExecutionPlan) -> Optional[dict]:
        """The SD caches one step of a 2PS plan moves, as priced (every
        block's, not only the worst segment's): ``sd_bytes`` in all and
        ``input_level_bytes`` of it over each block's input level, whose
        rows the row executor slices from the block's input instead of
        carrying them — so an offloading residency moves ``sd_bytes -
        input_level_bytes`` each way.  None for an engine without 2PS
        blocks."""
        if plan.engine == "twophase":
            blocks = ((0, len(self.modules), max(1, plan.n_rows)),)
        elif INNER_STRATEGY.get(plan.engine) == "twophase":
            blocks = plan.segments or self._segments(
                plan.n_rows, "twophase", plan.n_segments)
        else:
            return None
        shapes = self._shapes()
        total = level0 = 0
        for a, b, n in blocks:
            lv = _rp.twophase_cache_level_bytes(
                self.modules[a:b], shapes[a], self.dev_batch, n,
                self.dtype_bytes)
            total += sum(lv)
            level0 += lv[0]
        return {"sd_bytes": total, "input_level_bytes": level0}

    # -- plans ---------------------------------------------------------------
    def plan(self, engine: str, n_rows: int = 1,
             n_segments: Optional[int] = None, budget: int = 0,
             residency: Optional[ResidencySpec] = None,
             stage: Optional[StageSpec] = None,
             **extras) -> ExecutionPlan:
        """An explicit (engine, N) request as a full plan with estimates
        and, for the checkpointed engines, pinned segments; ``residency``
        is priced and recorded on the plan.  ``"pipeline_rows"`` goes to
        :meth:`plan_staged` (``stage`` pins the partition)."""
        n_rows = max(1, n_rows)
        if engine == "pipeline_rows":
            return self.plan_staged(n_rows, stage, budget=budget,
                                    residency=residency, **extras)
        segments: Tuple[Tuple[int, int, int], ...] = ()
        if engine in INNER_STRATEGY:
            segments = self._segments(n_rows, INNER_STRATEGY[engine],
                                      n_segments)
        dev_est = self.estimate(engine, n_rows, n_segments, segments,
                                residency)
        return ExecutionPlan(
            engine=engine, n_rows=n_rows, in_shape=self.in_shape,
            batch=self.batch, dtype_bytes=self.dtype_bytes,
            n_segments=n_segments, segments=segments,
            est_bytes=dev_est * self.shards, est_bytes_per_device=dev_est,
            budget=budget,
            feasible=(budget == 0 or dev_est < budget // self.shards),
            mesh=self.mesh, residency=residency,
            extras=tuple(extras.items()))

    def solve(self, engine: str, budget: int,
              n_segments: Optional[int] = None,
              residency: Optional[ResidencySpec] = None) -> ExecutionPlan:
        """min N s.t. estimate(engine, N) < budget (Eqs. 9/10/12/16 plus
        the Sec. IV validity bounds), as a plan; per device under a
        mesh."""
        if engine == "pipeline_rows":
            return self.solve_staged(budget=budget, residency=residency)
        if engine == "twophase" and _offloads(residency):
            # the validity-bounded scan solve_n does, against the
            # offloaded estimate
            return self._scan_n(engine, self._valid_twophase_ns(), budget,
                                residency=residency)
        if engine in ("base", "overlap", "twophase"):
            r = _rp.solve_n(self.modules, self.in_shape, self.dev_batch,
                            budget // self.shards, engine, self.dtype_bytes,
                            self.xi, self.n_max)
            return self.plan(engine, max(1, r.n_rows), budget=budget,
                             residency=residency)
        if engine == "ckp":  # granularity-free: one estimate
            return self.plan(engine, 1, n_segments, budget=budget,
                             residency=residency)
        if engine not in INNER_STRATEGY:
            raise ValueError(f"unknown CNN engine {engine!r}; known: "
                             f"{list(CNN_ENGINES)}")
        # hybrid engines: per-segment granularity caps bound the search
        caps = [cap for _, _, cap in segment_row_capacity(
            self.modules, self.in_shape[0], INNER_STRATEGY[engine],
            n_segments)]
        return self._scan_n(engine,
                            range(1, min(self.n_max, max(caps)) + 1),
                            budget, n_segments, residency)

    def _valid_twophase_ns(self):
        """N = 1, 2, ... while the 2PS granularity bound admits N."""
        for n in range(1, self.n_max + 1):
            if n > 1:
                try:
                    if not _tp.validate_plan(_tp.module_boundaries(
                            self.modules, self.in_shape[0], n)):
                        return
                except ValueError:
                    return
            yield n

    def _scan_n(self, engine: str, ns, budget: int,
                n_segments: Optional[int] = None,
                residency: Optional[ResidencySpec] = None
                ) -> Optional[ExecutionPlan]:
        """First feasible plan over the granularities ``ns``, else the
        smallest-estimate loser (estimates need not be monotonic in N)."""
        best: Optional[ExecutionPlan] = None
        for n in ns:
            p = self.plan(engine, n, n_segments, budget=budget,
                          residency=residency)
            if p.feasible:
                return p
            if best is None or p.est_bytes < best.est_bytes:
                best = p
        return best

    def residencize(self, plan: ExecutionPlan,
                    budget: Optional[int] = None) -> ExecutionPlan:
        """Fit a device-infeasible plan by moving boundary caches off
        device: retry the carry-based engines (the plan's own first when
        it is one) under ``host`` then ``recompute`` residency; the first
        feasible re-solve wins and records why under the ``residencized``
        extra.  Otherwise the plan comes back unchanged."""
        budget = plan.budget if budget is None else budget
        if plan.feasible or not budget or _offloads(plan.residency):
            return plan
        candidates = list(RESIDENCY_ENGINES)
        if plan.engine in candidates:
            candidates.remove(plan.engine)
            candidates.insert(0, plan.engine)
        dev_budget = budget // self.shards
        for policy in ("host", "recompute"):
            spec = ResidencySpec(default=policy)
            for engine in candidates:
                p = self.solve(engine, budget, residency=spec)
                if p is not None and p.feasible:
                    return p.with_extras(residencized=(
                        f"device-only solve infeasible (best "
                        f"{plan.engine} needs {plan.est_bytes_per_device} "
                        f"B/device > budget {dev_budget}); {policy} "
                        f"residency of {engine} boundary caches fits at "
                        f"N={p.n_rows}"))
        return plan

    # -- staged (pipelined) plans: Eqs. 7-16 per stage --------------------
    def _default_stage_spec(self, n_stages: Optional[int] = None
                            ) -> StageSpec:
        """Even partition with S = the mesh's model extent when it has one
        (one stage per model shard), else 2 — capped at the module count."""
        if n_stages is None:
            model = self.mesh.model if self.mesh is not None else 1
            n_stages = model if model > 1 else 2
        return StageSpec.even(len(self.modules),
                              max(1, min(n_stages, len(self.modules))))

    def estimate_staged(self, n_rows: int, stage: StageSpec) -> int:
        """Per-device bytes of the pipelined schedule: the worst stage's
        (a) GPipe stash — one full feature map at the stage's input level
        (stage 0 reads the batch input, which every engine already
        charges, so its stash is 0) — plus (b) the OverL working set of its
        own sub-trunk at granularity N, plus (c) its share of ``xi``, which
        divides by the model extent (each model shard holds only its
        stages' parameters)."""
        if stage.n_modules != len(self.modules):
            raise ValueError(
                f"StageSpec covers {stage.n_modules} modules but the trunk "
                f"has {len(self.modules)}")
        shapes = self._shapes()
        db, B = self.dtype_bytes, self.dev_batch
        model = self.mesh.model if self.mesh is not None else 1
        xi_s = self.xi // max(1, model)
        worst = 0
        for a, b in stage.stages:
            stash = (B * shapes[a][0] * shapes[a][1] * shapes[a][2] * db
                     if a > 0 else 0)
            work = _rp.estimate_bytes(self.modules[a:b], shapes[a], B,
                                      "overlap", n_rows, db)
            worst = max(worst, stash + work + xi_s)
        return worst

    def plan_staged(self, n_rows: int, stage: Optional[StageSpec] = None,
                    budget: int = 0,
                    residency: Optional[ResidencySpec] = None,
                    **extras) -> ExecutionPlan:
        """Explicit ``pipeline_rows`` plan: N row microbatches through the
        stage partition (default :meth:`_default_stage_spec`), feasible
        per stage and per device."""
        n_rows = max(1, n_rows)
        stage = stage or self._default_stage_spec()
        dev_est = self.estimate_staged(n_rows, stage)
        return ExecutionPlan(
            engine="pipeline_rows", n_rows=n_rows, in_shape=self.in_shape,
            batch=self.batch, dtype_bytes=self.dtype_bytes,
            est_bytes=dev_est * self.shards, est_bytes_per_device=dev_est,
            budget=budget,
            feasible=(budget == 0 or dev_est < budget // self.shards),
            mesh=self.mesh, residency=residency, stage=stage,
            extras=tuple(extras.items()))

    def solve_staged(self, n_stages: Optional[int] = None, budget: int = 0,
                     residency: Optional[ResidencySpec] = None
                     ) -> Optional[ExecutionPlan]:
        """min N such that the worst stage fits the per-device budget, at
        the even S-stage partition; the smallest-estimate loser when
        nothing fits."""
        stage = self._default_stage_spec(n_stages)
        best: Optional[ExecutionPlan] = None
        for n in range(1, self.n_max + 1):
            try:
                p = self.plan_staged(n, stage, budget=budget,
                                     residency=residency)
            except ValueError:
                break  # N exceeds a stage's row-split bound; larger N too
            if p.feasible:
                return p
            if best is None or p.est_bytes < best.est_bytes:
                best = p
        return best

    def stagedize(self, plan: Optional[ExecutionPlan],
                  budget: Optional[int] = None,
                  residency: Optional[ResidencySpec] = None
                  ) -> Optional[ExecutionPlan]:
        """Fit a single-stage-infeasible plan by pipelining stages over
        the model axis (the model-parallel counterpart of
        :meth:`residencize`, run after it): tries S = 2 .. min(model
        extent, L) and returns the first feasible staged solve, recording
        why under the ``pipeline`` extra.  A feasible plan, a zero budget
        or a mesh with no model extent come back unchanged."""
        if plan is None or plan.feasible:
            return plan
        budget = plan.budget if budget is None else budget
        model = self.mesh.model if self.mesh is not None else 1
        if not budget or model <= 1:
            return plan
        dev_budget = budget // self.shards
        for n_stages in range(2, min(model, len(self.modules)) + 1):
            p = self.solve_staged(n_stages, budget, residency=residency)
            if p is not None and p.feasible:
                return p.with_extras(pipeline=(
                    f"single-stage solve infeasible (best {plan.engine} "
                    f"needs {plan.est_bytes_per_device} B/device > budget "
                    f"{dev_budget}); S={n_stages} pipeline stages over the "
                    f"model axis fit at N={p.n_rows}"))
        return plan

    @classmethod
    def for_budget(cls, modules: Sequence, in_shape: Tuple[int, int, int],
                   batch: int, budget: int, dtype_bytes: int = 4,
                   xi: int = 0, n_max: int = 64,
                   candidates: Sequence[str] = BUDGET_PREFERENCE,
                   mesh: Optional[MeshSpec] = None,
                   residency: Optional[ResidencySpec] = None,
                   cost_table=None) -> ExecutionPlan:
        """Auto-select strategy *and* granularity under a byte budget:
        ``candidates`` in order of increasing runtime overhead (Table I /
        Fig. 8), the first feasible plan wins.  If none fits and no
        residency is pinned, :meth:`residencize` retries the carry-based
        engines with their caches off device, then :meth:`stagedize`
        (a no-op without a model axis).  Failing everything, the
        infeasible plan with the smallest estimate.  Per device under a
        mesh.

        With a ``cost_table`` the static orders are replaced by the
        measured roofline (:meth:`_for_budget_costed`): every feasible
        candidate — each engine under the pinned residency, plus the host-
        and recompute-offloaded carry engines when none is pinned — is
        priced by :meth:`predict_plan_us` and the least predicted step
        time wins, recorded under the ``cost_model`` /
        ``predicted_step_us`` / ``cost_table_version`` extras."""
        _count_solve()
        planner = cls(modules, in_shape, batch, dtype_bytes, xi, n_max,
                      mesh=mesh, cost_table=cost_table)
        if cost_table is not None:
            return planner._for_budget_costed(budget, candidates,
                                              residency, cost_table)
        best: Optional[ExecutionPlan] = None
        for engine in candidates:
            p = planner.solve(engine, budget, residency=residency)
            if p.feasible:
                return p
            if best is None or p.est_bytes < best.est_bytes:
                best = p
        if residency is None:
            best = planner.residencize(best, budget)
        return planner.stagedize(best, budget, residency)

    def kernelize(self, plan: ExecutionPlan, spec,
                  smem_limit: int = SMEM_LIMIT) -> ExecutionPlan:
        """Apply a kernel backend to a plan, priced against this planner's
        module list — see :func:`kernelize_plan`."""
        return kernelize_plan(plan, spec, modules=self.modules,
                              smem_limit=smem_limit)

    def resolve(self, request: PlanRequest) -> ExecutionPlan:
        """Turn a config-level :class:`PlanRequest` into a plan; its
        ``kernel`` ("cuda"/"plain") is applied to whatever resolves."""
        _count_solve()
        if request.mesh:
            mesh = MeshSpec.parse(request.mesh)
            if mesh != self.mesh:
                return Planner(self.modules, self.in_shape, self.batch,
                               self.dtype_bytes, self.xi, self.n_max,
                               mesh=mesh,
                               cost_table=self.cost_table).resolve(
                                   dataclasses_replace(request, mesh=""))
        plan = self._resolve(request, ResidencySpec.parse(request.residency))
        if request.kernel:
            plan = self.kernelize(plan, request.kernel)
        return plan

    def _resolve(self, request: PlanRequest,
                 residency: Optional[ResidencySpec] = None) -> ExecutionPlan:
        budget = int(request.budget_gb * 2**30)
        if request.engine and request.n_rows:
            return self.plan(request.engine, request.n_rows,
                             request.n_segments, budget=budget,
                             residency=residency)
        if request.engine:
            return self.solve(request.engine, budget,
                              n_segments=request.n_segments,
                              residency=residency)
        if request.n_rows:
            # engine auto, N pinned: the first engine (Table I order)
            # feasible at exactly this granularity
            best: Optional[ExecutionPlan] = None
            for engine in BUDGET_PREFERENCE:
                if engine in ("base", "ckp") and request.n_rows > 1:
                    continue  # granularity-free engines can't honour N
                try:
                    if engine == "twophase" and not _tp.validate_plan(
                            _tp.module_boundaries(self.modules,
                                                  self.in_shape[0],
                                                  request.n_rows)):
                        continue  # exceeds the 2PS granularity bound
                    p = self.plan(engine, request.n_rows,
                                  request.n_segments, budget=budget,
                                  residency=residency)
                except ValueError:  # N invalid for this engine's bounds
                    continue
                if p.feasible:
                    return p
                if best is None or p.est_bytes < best.est_bytes:
                    best = p
            if best is not None:
                return best
        return self.for_budget(self.modules, self.in_shape, self.batch,
                               budget, dtype_bytes=self.dtype_bytes,
                               xi=self.xi, n_max=self.n_max, mesh=self.mesh,
                               residency=residency,
                               cost_table=self.cost_table)

    def autotune_kernel(self, plan: ExecutionPlan, *, time_fn=None,
                        smem_limit: int = SMEM_LIMIT,
                        base_spec: Optional[KernelSpec] = None
                        ) -> ExecutionPlan:
        """Search the KernelSpec tile geometry for ``plan``'s CUDA
        alternate and return the plan kernelized with the fastest tiling.

        Candidates come from the enumeration kernelize retiles over
        (``candidate_tiles``), filtered by the same shared-memory and halo
        pricers (:func:`_cuda_infeasible`), then *timed*: ``time_fn
        (candidate plan) -> us`` (default: :meth:`_default_kernel_timer`,
        the trunk's batch-1 forward on the card, which it needs; the
        sequence engines have no trunk, so their callers pass one).  The
        least time wins; exact ties break toward the earlier candidate, so
        the search is deterministic for a deterministic timer.  The
        winner records the search under the ``autotune`` / ``autotune_us``
        extras; when no candidate passes the pricers the plan falls back
        to the plain engine with the usual ``kernel_fallback`` reason."""
        spec0 = base_spec or plan.kernel or KernelSpec(backend="cuda")
        spec0 = dataclasses_replace(spec0, backend="cuda")
        target = CUDA_ALTERNATE.get(plan.engine, plan.engine)
        if target not in CUDA_ENGINES:
            return _kernel_fallback(
                plan, spec0, f"engine {plan.engine!r} has no cuda alternate")
        feasible = []
        seen = set()
        for tiles in _tile_candidates(target, plan):
            spec = dataclasses_replace(spec0, **tiles)
            if spec in seen:
                continue
            seen.add(spec)
            reason, pricing = _cuda_infeasible(target, plan, spec,
                                               self.modules, smem_limit)
            if not reason:
                feasible.append((spec, pricing, tiles))
        if not feasible:
            return _kernel_fallback(
                plan, spec0,
                f"autotune: no tile candidate feasible for {target}")
        timer = time_fn if time_fn is not None \
            else self._default_kernel_timer()
        scored = []
        for idx, (spec, pricing, tiles) in enumerate(feasible):
            cand = dataclasses_replace(plan, engine=target, kernel=spec)
            scored.append((float(timer(cand)), idx, cand, pricing, tiles))
        scored.sort(key=lambda t: (t[0], t[1]))
        us, _, cand, pricing, tiles = scored[0]
        return cand.with_extras(
            autotune=(f"timed {len(feasible)} feasible of "
                      f"{len(seen)} tile candidates for {target}; best "
                      f"{_fmt_tiles(tiles)} at {us:.1f}us"),
            autotune_us=round(us, 3), **pricing)

    def _default_kernel_timer(self):
        """Timer over this planner's own trunk on the card: seeded
        parameters, a batch-1 forward without a graph through
        ``build_apply``, timed by :func:`~repro_torch.obs.audit.measure_step`
        (one warmup call, then the median of 2 timed ones).  It times CUDA
        kernels, so without a card it raises: a tile chosen from the plain
        versions' CPU times would say nothing about the kernel."""
        import torch

        from repro_torch.exec.registry import build_apply
        from repro_torch.models.cnn.layers import init_trunk
        from repro_torch.obs.audit import measure_step

        if not torch.cuda.is_available():
            raise RuntimeError(
                "autotune_kernel's default timer times the CUDA kernels and "
                "needs a CUDA device; pass time_fn to tune without one")
        dev = torch.device("cuda")
        params, _ = init_trunk(self.modules,
                               torch.Generator().manual_seed(0),
                               self.in_shape, device=dev)
        x = torch.zeros((1,) + self.in_shape, device=dev)

        def timer(cand: ExecutionPlan) -> float:
            fn = build_apply(self.modules,
                             dataclasses_replace(cand, mesh=None))
            with torch.no_grad():
                m = measure_step(fn, params, x, time_iters=2)
            return float(m["wall_us"])

        return timer

    # -- measured-cost selection (roofline over a calibrated CostTable) ---
    def predict_plan_us(self, plan: ExecutionPlan, table) -> dict:
        """Roofline step-time prediction for ``plan`` under ``table``:
        ``{"us", "compute_us", "copy_us", "flops", "copy_bytes"}``.

        Compute side: one forward + ~2x backward over the trunk
        (:func:`~repro_torch.exec.costmodel.trunk_fwd_flops`), plus one
        extra forward for the checkpointed engines (segment recompute),
        plus the replicated-halo fraction for the OverL family, plus the
        O(N^2) forward-chain term — ``fwd * (N-1)/2`` — under recompute
        residency.  Copy side: the 2PS SD volume crosses PCIe both ways
        under host residency, scaled by the audit-seeded byte-honesty
        ratio for the matching plan group.  The step pays ``max(compute,
        copy)`` (prefetch hides copies behind the adjacent row) plus
        per-row dispatch overhead.  A pipelined plan also stretches its
        compute by the GPipe fill/drain bubble ``1 + (S-1)/N``.

        One departure from the reference: the halo and SD terms split the
        trunk into at most as many rows as its last level has (OverL-H and
        2PS-H plans ask for more, e.g. N=10 on VGG-16's 7-row last level at
        224², and cap each segment); the reference raises ``ValueError``
        there, which stops its costed chooser on any budget where such a
        plan is a candidate.  Wherever the reference answers, the answers
        are equal."""
        from repro_torch.exec.costmodel import (
            audit_ratio_key, trunk_fwd_flops,
        )

        fwd = trunk_fwd_flops(self.modules, self.in_shape, self.dev_batch)
        flops = 3.0 * fwd
        n = max(1, plan.n_rows)
        # the hybrids cap each segment's N at the segment's final height,
        # so the trunk-wide halo and SD terms split into at most as many
        # rows as the trunk's last level has; the reference prices N as
        # given and raises past it
        n_split = min(n, self._shapes()[-1][0])
        engine = plan.engine
        if engine in INNER_STRATEGY:  # segment recompute: one extra FP
            flops += fwd
        if engine in ("overlap", "overlap_h", "overlap_cuda",
                      "pipeline_rows") and n > 1:
            halo = _rp.overlap_halo_bytes(self.modules, self.in_shape,
                                          self.dev_batch, n_split,
                                          self.dtype_bytes)
            feat = sum(_rp.feature_bytes(self.modules, self.in_shape,
                                         self.dev_batch, self.dtype_bytes))
            if feat:
                flops += 3.0 * fwd * (halo / feat)  # redundant halo compute
        d2h = h2d = 0.0
        res = plan.residency
        if _offloads(res) and engine in RESIDENCY_ENGINES:
            policies = {res.default} | {p for _, p in res.placements}
            sd = _rp.twophase_cache_bytes(self.modules, self.in_shape,
                                          self.dev_batch, n_split,
                                          self.dtype_bytes)
            if "host" in policies:
                d2h += sd   # FP exports every boundary cache ...
                h2d += sd   # ... and BP prefetches it back
            if "recompute" in policies:
                # regenerating row r's caches replays rows 0..r-1's FP:
                # sum over importing rows ~= fwd * (N-1)/2
                flops += fwd * (n - 1) / 2.0
        key = audit_ratio_key("train_step", engine,
                              res.describe() if res is not None
                              else "device", "")
        scale = table.ratio(key)
        compute = table.compute_us(flops)
        if engine == "pipeline_rows" and plan.stage is not None:
            # GPipe fill/drain bubble: (S-1) of (N+S-1) ticks run below
            # full stage occupancy, charged as compute stretch
            compute *= 1.0 + (plan.stage.n_stages - 1) / n
        copy = table.copy_us(d2h * scale, h2d * scale)
        return {"us": max(compute, copy) + table.row_overhead_us * n,
                "compute_us": compute, "copy_us": copy, "flops": flops,
                "copy_bytes": d2h + h2d}

    def _for_budget_costed(self, budget: int, candidates: Sequence[str],
                           residency: Optional[ResidencySpec],
                           table) -> ExecutionPlan:
        """Collect every feasible candidate plan, rank by predicted step
        time, record the decision — the measured replacement for both the
        Table I order and residencize's host-before-recompute order."""
        pool = []
        for engine in candidates:
            p = self.solve(engine, budget, residency=residency)
            if p is not None:
                pool.append(p)
        device_pool = list(pool)
        if residency is None:
            # the offload alternatives enter the SAME ranked pool instead
            # of a fixed host-then-recompute retry order
            for policy in ("host", "recompute"):
                spec = ResidencySpec(default=policy)
                for engine in RESIDENCY_ENGINES:
                    p = self.solve(engine, budget, residency=spec)
                    if p is not None:
                        pool.append(p)
        model = self.mesh.model if self.mesh is not None else 1
        if model > 1:
            # staged alternates join the pool too: the roofline's bubble
            # term prices their fill/drain ramp against the offload copies
            for n_stages in range(2, min(model, len(self.modules)) + 1):
                p = self.solve_staged(n_stages, budget, residency=residency)
                if p is not None:
                    pool.append(p)
        feasible = [p for p in pool if p.feasible]
        if not feasible:
            best = min(device_pool, key=lambda p: p.est_bytes)
            if residency is None:
                best = self.residencize(best, budget)
            return self.stagedize(best, budget, residency)
        pref = {e: i for i, e in enumerate(BUDGET_PREFERENCE)}
        scored = [(self.predict_plan_us(p, table), p) for p in feasible]
        scored.sort(key=lambda cp: (cp[0]["us"],
                                    pref.get(cp[1].engine, len(pref)),
                                    cp[1].n_rows))
        cost, chosen = scored[0]
        res_desc = chosen.residency.describe() \
            if chosen.residency is not None else "device"
        chosen = chosen.with_extras(
            cost_model=(f"ranked {len(feasible)} feasible candidates by "
                        f"roofline step time; {chosen.engine} N="
                        f"{chosen.n_rows} ({res_desc}) predicted "
                        f"{cost['us']:.1f}us (compute "
                        f"{cost['compute_us']:.1f}us, copy "
                        f"{cost['copy_us']:.1f}us)"),
            predicted_step_us=round(cost["us"], 3),
            cost_table_version=table.version())
        if _offloads(chosen.residency) \
                and not any(p.feasible for p in device_pool):
            dev_budget = budget // self.shards
            chosen = chosen.with_extras(residencized=(
                f"no device-resident candidate fits budget {dev_budget} "
                f"B/device; {chosen.residency.default} residency of "
                f"{chosen.engine} boundary caches fits at "
                f"N={chosen.n_rows}"))
        return chosen

    # -- sequence-side planning (the LM transplant) -----------------------
    @staticmethod
    def seq_estimate(seq_len: int, d_model: int, batch: int, n_chunks: int,
                     d_ff: int = 0, window: int = 0,
                     dtype_bytes: int = 4) -> int:
        """Eq. 7 along the token axis: residual stream (always live) + one
        chunk's widest sub-layer working set (+ the SWA halo)."""
        width = max(3 * d_model, 2 * (d_ff or 4 * d_model))
        chunk_tokens = -(-seq_len // n_chunks) + window
        stream = batch * seq_len * d_model * dtype_bytes
        return stream + batch * chunk_tokens * width * dtype_bytes

    @classmethod
    def for_budget_seq(cls, seq_len: int, d_model: int, batch: int,
                       budget: int, d_ff: int = 0,
                       engine: str = "seq_chunked", window: int = 0,
                       axis: int = 1, dtype_bytes: int = 4,
                       n_max: int = 64, head_dim: int = 0,
                       mesh: Optional[MeshSpec] = None,
                       residency: Optional[ResidencySpec] = None
                       ) -> ExecutionPlan:
        """Smallest chunk count (dividing ``seq_len``) that fits ``budget``
        (per device under a mesh); the infeasible plan at the largest
        divisor otherwise.  ``residency`` rides along on the plan."""
        _count_solve()
        shards = batch_shards(mesh, batch)
        divisors = [n for n in range(1, min(n_max, seq_len) + 1)
                    if seq_len % n == 0]
        extras = _seq_extras(axis, seq_len, d_model, window, head_dim)
        best = None
        for n in divisors:
            est = cls.seq_estimate(seq_len, d_model, batch // shards, n,
                                   d_ff, window, dtype_bytes)
            plan = ExecutionPlan(
                engine=engine, n_rows=n, in_shape=None, batch=batch,
                dtype_bytes=dtype_bytes, est_bytes=est * shards,
                est_bytes_per_device=est, budget=budget,
                feasible=(budget == 0 or est < budget // shards),
                mesh=mesh, residency=residency, extras=extras)
            if plan.feasible:
                return plan
            best = plan
        return best

    @classmethod
    def for_model(cls, cfg, batch: int, seq_len: int, budget: int = 0,
                  mesh: Optional[MeshSpec] = None,
                  residency: Optional[ResidencySpec] = None,
                  kernel=None) -> ExecutionPlan:
        """Sequence plan for a :class:`~repro_torch.models.lm.config.
        ModelConfig`: engine from the layer pattern, N from the budget (or
        the config's ``row_chunks`` when unconstrained); ``kernel=`` (spec
        or backend string) kernelizes the resolved plan, so the KernelSpec
        lands on the one plan the train path executes."""
        _count_solve()
        kinds = set(cfg.layer_kinds())
        if kinds & {"mamba", "mlstm", "slstm"}:
            engine, window = "seq_carry_scan", 0
        elif "local" in kinds and cfg.sliding_window:
            engine, window = "seq_swa_overlap", cfg.sliding_window
        else:
            engine, window = "seq_chunked", 0
        head_dim = cfg.head_dim if window else 0
        dtype_bytes = 2 if cfg.dtype == "bfloat16" else 4
        if budget:
            plan = cls.for_budget_seq(seq_len, cfg.d_model, batch, budget,
                                      d_ff=cfg.d_ff, engine=engine,
                                      window=window, dtype_bytes=dtype_bytes,
                                      head_dim=head_dim, mesh=mesh,
                                      residency=residency)
        else:
            shards = batch_shards(mesh, batch)
            n = max(1, cfg.row_chunks)
            est = cls.seq_estimate(seq_len, cfg.d_model, batch // shards, n,
                                   cfg.d_ff, window, dtype_bytes)
            plan = ExecutionPlan(
                engine=engine, n_rows=n, in_shape=None, batch=batch,
                dtype_bytes=dtype_bytes, est_bytes=est * shards,
                est_bytes_per_device=est, mesh=mesh, residency=residency,
                extras=_seq_extras(1, seq_len, cfg.d_model, window,
                                   head_dim))
        if kernel:
            plan = kernelize_plan(plan, kernel)
        return plan
