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

Not ported yet, and raising :class:`NotImplementedError` with what they
wait for: the costed chooser (``for_budget`` with a ``cost_table``),
``stagedize`` where it would have to stage, the tile autotuner and the
serving planner.
"""

from __future__ import annotations

from dataclasses import replace as dataclasses_replace
from typing import Optional, Sequence, Tuple

from repro_torch.core import rowplan as _rp
from repro_torch.core import twophase as _tp
from repro_torch.core.hybrid import auto_segments, max_rows_per_segment
from repro_torch.exec.plan import (
    ExecutionPlan, KernelSpec, MeshSpec, PlanRequest, ResidencySpec,
    batch_shards,
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


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet")


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


class Planner:
    """Solves (engine, N) for a CNN trunk.  ``xi`` is the paper's constant
    (params + grads + optimizer state) added to every estimate.  A mesh is
    accepted as plain data and divides batch and budget per device, as in
    the reference; executing it is not ported yet."""

    def __init__(self, modules: Sequence, in_shape: Tuple[int, int, int],
                 batch: int, dtype_bytes: int = 4, xi: int = 0,
                 n_max: int = 64, mesh: Optional[MeshSpec] = None):
        self.modules = list(modules)
        self.in_shape = tuple(in_shape)
        self.batch = batch
        self.dtype_bytes = dtype_bytes
        self.xi = xi
        self.n_max = n_max
        self.mesh = mesh
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
        return base + mult * buf

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
                 residency: Optional[ResidencySpec] = None) -> int:
        """Peak activation bytes ONE device holds, plus ``xi``.
        ``residency`` re-prices the carry-based engines' SD caches; the
        other engines carry nothing, so theirs is residency-invariant."""
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

    # -- plans ---------------------------------------------------------------
    def plan(self, engine: str, n_rows: int = 1,
             n_segments: Optional[int] = None, budget: int = 0,
             residency: Optional[ResidencySpec] = None,
             **extras) -> ExecutionPlan:
        """An explicit (engine, N) request as a full plan with estimates
        and, for the checkpointed engines, pinned segments; ``residency``
        is priced and recorded on the plan."""
        n_rows = max(1, n_rows)
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

    def stagedize(self, plan: Optional[ExecutionPlan],
                  budget: Optional[int] = None,
                  residency: Optional[ResidencySpec] = None
                  ) -> Optional[ExecutionPlan]:
        """The model-axis fallback: a feasible plan, a zero budget or a
        mesh with no model extent come back unchanged, as in the
        reference; pipelining stages over a model axis is not ported
        yet."""
        if plan is None or plan.feasible:
            return plan
        budget = plan.budget if budget is None else budget
        model = self.mesh.model if self.mesh is not None else 1
        if not budget or model <= 1:
            return plan
        raise _not_ported("Planner.stagedize over a model axis (pipelined "
                          "stages, exec/pipeline.py)")

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
        mesh."""
        if cost_table is not None:
            raise _not_ported("the costed chooser (Planner.for_budget with "
                              "a cost_table, exec/costmodel.py)")
        planner = cls(modules, in_shape, batch, dtype_bytes, xi, n_max,
                      mesh=mesh)
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
        if request.mesh:
            mesh = MeshSpec.parse(request.mesh)
            if mesh != self.mesh:
                return Planner(self.modules, self.in_shape, self.batch,
                               self.dtype_bytes, self.xi, self.n_max,
                               mesh=mesh).resolve(
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
                               residency=residency)

    def autotune_kernel(self, *args, **kwargs):
        raise _not_ported("Planner.autotune_kernel (timed tile search)")

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

    @classmethod
    def for_serve(cls, *args, **kwargs):
        raise _not_ported("Planner.for_serve (serving plans)")
