"""Built-in engines behind the registry's ``build(modules, plan)``
signature (counterpart of ``repro.exec.engines``).

CNN engines (``kind="cnn"``): ``modules`` is the conv module list and the
plan partitions the input height ``plan.h0``; the returned ``apply(params,
x)`` is a drop-in trunk forward.  All six of the paper's strategies:
``base``, ``ckp``, ``overlap``, ``twophase``, ``overlap_h`` and
``twophase_h``; the carry-based ones (``twophase`` and the 2PS segments of
``twophase_h``) place their boundary caches by ``plan.residency``.

Sequence engines (``kind="seq"``): ``seq_chunked``, ``seq_carry_scan``
and ``seq_swa_overlap``.  Each takes two forms of ``modules``: the LM
stack as ``(params, ModelConfig)``, for which the builder returns the
plan-driven stack apply of :mod:`repro_torch.models.lm.rowexec`
(``apply(params, batch) -> (loss, aux)``), or a plain chunk-body callable
(a per-token fn, a scan body, an attend function), for which it returns
the :mod:`repro_torch.core.seqrow` apply of that shape.  The kernel-backed
engines live in :mod:`repro_torch.exec.kernel_engines`, the row pipeline
in :mod:`repro_torch.exec.pipeline`.

Sharding: the engines are single-device code.  The two shard wrappers at
the bottom (one per kind) are the only mesh-aware layer: under a plan
whose mesh spans more than one device, each rank runs the engine on its
own slice of the batch and the wrappers put the collectives
(:mod:`repro_torch.exec.collectives`) at its edges.  The LM stack apply is
the exception, as in the reference: it handles the mesh itself, through
the seams of the model code under the step's shard context.
"""

from __future__ import annotations

from typing import List, Sequence

from repro_torch.core import overlap as _ov
from repro_torch.core import seqrow as _sr
from repro_torch.core import twophase as _tp
from repro_torch.core.hybrid import SegmentSpec, make_hybrid_apply
from repro_torch.exec.plan import ExecutionPlan
from repro_torch.exec.registry import register_engine, register_shard_wrapper


def _segment_specs(modules: Sequence, plan: ExecutionPlan,
                   inner: str) -> List[SegmentSpec]:
    """SegmentSpec list for the checkpointed engines: a pinned
    ``plan.segments`` verbatim, else the segmentation the planner
    estimates with (``derive_segments``), so estimate and execution
    cannot disagree."""
    from repro_torch.exec.planner import derive_segments
    segments = plan.segments or derive_segments(
        modules, plan.h0, inner, plan.n_rows, plan.n_segments)
    return [SegmentSpec(a, b, n, inner) for a, b, n in segments]


@register_engine("base", kind="cnn",
                 doc="column-centric reference (the paper's Base)")
def _build_base(modules, plan: ExecutionPlan):
    return _ov.make_column_apply(modules)


@register_engine("ckp", kind="cnn",
                 doc="sqrt(L) checkpointing, Chen et al. (the paper's Ckp)")
def _build_ckp(modules, plan: ExecutionPlan):
    return make_hybrid_apply(modules, plan.h0,
                             _segment_specs(modules, plan, "column"),
                             residency=plan.residency)


@register_engine("overlap", kind="cnn",
                 doc="OverL: replicated-halo rows, independent (Sec. IV-B)")
def _build_overlap(modules, plan: ExecutionPlan):
    return _ov.make_overlap_apply(modules, plan.h0, plan.n_rows,
                                  n_rows_bp=plan.get("n_rows_bp"))


@register_engine("twophase", kind="cnn",
                 doc="2PS: sequential rows with boundary cache (Sec. IV-A);"
                     " a row program — plan.residency places the SD caches")
def _build_twophase(modules, plan: ExecutionPlan):
    return _tp.make_twophase_apply(modules, plan.h0, plan.n_rows,
                                   residency=plan.residency)


@register_engine("overlap_h", kind="cnn",
                 doc="OverL-H: OverL rows inside sqrt(L) checkpoint segments")
def _build_overlap_h(modules, plan: ExecutionPlan):
    return make_hybrid_apply(modules, plan.h0,
                             _segment_specs(modules, plan, "overlap"),
                             residency=plan.residency)


@register_engine("twophase_h", kind="cnn",
                 doc="2PS-H: 2PS rows inside sqrt(L) checkpoint segments; "
                     "plan.residency places each segment's SD caches")
def _build_twophase_h(modules, plan: ExecutionPlan):
    return make_hybrid_apply(modules, plan.h0,
                             _segment_specs(modules, plan, "twophase"),
                             residency=plan.residency)


def _seq_modules(modules, plan: ExecutionPlan):
    """The LM stack apply when ``modules`` is ``(params, ModelConfig)``,
    else None (``modules`` is then a chunk-body callable).  Under a mesh
    the LM apply is marked ``handles_mesh``: the sharded train step
    (:mod:`repro_torch.launch.steps`) places the state and the batch and
    activates the shard context its seams read, so the registry leaves it
    unwrapped."""
    from repro_torch.models.lm.rowexec import build_lm_apply, lm_config
    cfg = lm_config(modules)
    if cfg is None:
        return None
    return build_lm_apply(cfg, plan)


@register_engine("seq_chunked", kind="seq",
                 doc="halo-0 sequence chunks with per-chunk remat "
                     "(per-token layers); a carry-free row program")
def _build_seq_chunked(modules, plan: ExecutionPlan):
    lm = _seq_modules(modules, plan)
    if lm is not None:
        return lm
    return _sr.make_chunked_apply(modules, plan.n_rows,
                                  int(plan.get("axis", 1)),
                                  residency=plan.residency)


@register_engine("seq_carry_scan", kind="seq",
                 doc="2PS along the sequence: carried state as the named "
                     "boundary cache ('state'), placed by plan.residency")
def _build_seq_carry_scan(modules, plan: ExecutionPlan):
    lm = _seq_modules(modules, plan)
    if lm is not None:
        return lm
    return _sr.make_carry_scan_apply(modules, plan.n_rows,
                                     int(plan.get("axis", 1)),
                                     residency=plan.residency)


@register_engine("seq_swa_overlap", kind="seq",
                 doc="OverL along the sequence: replicated KV halo for "
                     "sliding-window attention; a carry-free row program")
def _build_seq_swa_overlap(modules, plan: ExecutionPlan):
    window = int(plan.get("window", 0))
    if window <= 0:
        raise ValueError("seq_swa_overlap plan needs a 'window' extra")
    lm = _seq_modules(modules, plan)
    if lm is not None:
        return lm
    return _sr.make_swa_overlap_apply(modules, window, plan.n_rows,
                                      residency=plan.residency)


# ---------------------------------------------------------------------------
# Shard wrappers: the mesh-aware outer layer build_apply adds per kind
# ---------------------------------------------------------------------------


def _plan_ctx(plan: ExecutionPlan):
    """ShardCtx over the plan's mesh, built on the default process group
    (:func:`repro_torch.launch.mesh.build_mesh`); with it active the one
    slicing entry point is :func:`repro_torch.launch.sharding.lc`."""
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.launch.sharding import make_plan_ctx
    return make_plan_ctx(build_mesh(plan.mesh), plan.mesh)


def _groups(ctx):
    """(batch group, model group) of this rank, None where an axis spans
    one rank."""
    from repro_torch.exec.collectives import axis_group
    return (axis_group(ctx.mesh, ctx.logical["batch"] or ()),
            axis_group(ctx.mesh, ctx.logical["tp"] or ()))


def _gather_batch0(tree, group):
    """Every tensor of ``tree`` (tuples nested) with its leading axis
    all-gathered over ``group``."""
    from repro_torch.exec.collectives import GatherBatch
    if group is None:
        return tree
    if isinstance(tree, (tuple, list)):
        return type(tree)(_gather_batch0(t, group) for t in tree)
    return GatherBatch.apply(tree, group)


@register_shard_wrapper("cnn")
def _shard_cnn(inner, plan: ExecutionPlan, modules, rebuild):
    """CNN trunk sharding.  ``apply(params, x)`` takes the full parameter
    tree and this rank's slice of the batch (what
    :func:`repro_torch.data.pipeline.device_put_global` gives it) and
    returns the whole batch's output, gathered over the batch axes (pod x
    data), so the head and the loss after it compute the global batch's
    mean on every rank.  Each leaf's gradient is summed over the batch
    group: the rank's slice contributes its share of it.

    Over the model axis a ``Conv`` whose output channels the axis divides
    (the reference's ``filter_spec`` fallback on the logical "tp" name)
    runs column-parallel (:class:`~repro_torch.exec.collectives.
    ColumnParallel`): ``lc`` hands it this rank's channel slice of the
    kernel and, unlike the reference, of the bias too (an eager conv adds
    its bias to its own channels; GSPMD slices the replicated bias
    itself), and its output is gathered along channels.  Split leaves'
    gradients are also summed over the model group.  A layer the axis does
    not divide, and a ResNet bottleneck, runs whole on every rank of the
    model group: the same arithmetic, without the split.  The row
    granularity N stays per device, as the Planner solved it, and the
    engine (pipelined or not) never sees the mesh."""
    from repro_torch.exec.collectives import ColumnParallel, ReduceGrads
    from repro_torch.launch.sharding import lc, use_ctx
    from repro_torch.models.cnn.layers import (
        dense_conv, flatten_params, unflatten_params,
    )
    ctx = _plan_ctx(plan)
    batch, model = _groups(ctx)
    split = [False] * len(modules)
    if model is not None:
        m_ext = plan.mesh.model
        split = [dense_conv(m) and m.cout % m_ext == 0 for m in modules]
        if any(split):
            inner = rebuild([ColumnParallel(m, model) if s else m
                             for m, s in zip(modules, split)])
    batch_only = tuple(g for g in (batch,) if g is not None)
    both = tuple(g for g in (batch, model) if g is not None)

    def _local(p: dict, is_split: bool):
        if not is_split:
            return p
        return {k: lc(v, *(None,) * (v.ndim - 1), "tp")
                for k, v in p.items()}

    def apply(params, x):
        leaves, spec = flatten_params(params)
        counts = [len(flatten_params([p])[0]) for p in params]
        groups = tuple(both if s else batch_only
                       for s, n in zip(split, counts) for _ in range(n))
        if any(groups):
            leaves = ReduceGrads.apply(groups, *leaves)
        with use_ctx(ctx):
            local = [_local(p, s) for p, s in
                     zip(unflatten_params(leaves, spec), split)]
        return _gather_batch0(inner(local, x), batch)

    return apply


@register_shard_wrapper("seq")
def _shard_seq(inner, plan: ExecutionPlan, modules, rebuild):
    """Sequence engines take positional tensors all batched on axis 0
    (x / (carry, xs) / (q, k, v)) and close over their weights: each rank
    passes its slice of the batch, the chunked engine runs on it, and
    every output comes back whole, gathered over the batch axes."""
    batch, _ = _groups(_plan_ctx(plan))

    def apply(*args):
        return _gather_batch0(inner(*args), batch)

    return apply
