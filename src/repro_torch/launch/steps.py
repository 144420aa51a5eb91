"""The LM train, prefill and serve steps, the shape contexts and the state
and batch placements of a sharded step (counterpart of
``repro.launch.steps``).

Shapes (the reference's assignment):
  train_4k      seq=4096    global_batch=256   train_step (fwd+bwd+adamw)
  prefill_32k   seq=32768   global_batch=32    prefill_step
  decode_32k    seq=32768   global_batch=128   serve_step (1 token vs cache)
  long_500k     seq=524288  global_batch=1     serve_step, sub-quadratic only

Sharding policy: the batch over ("pod", "data") when it divides, else
fewer axes (:func:`make_shape_ctx`); tensor, vocab and expert parallelism
over "model"; FSDP over "data" on request; the ``dp_only`` layout puts
the batch over every axis and 2-D shards the parameters.  Placements are
``torch.distributed.tensor`` placements per mesh dim, one per leaf
(:func:`state_sharding`, :func:`batch_sharding`), from the reference's
rules (:data:`~repro_torch.launch.sharding.LM_RULES`).

A sharded train step (``make_train_step(ctx=...)`` with a context bound to
process groups) runs on each rank with only its shard of the parameters
and the AdamW moments, and its slice of the batch: the model's seams
(:mod:`repro_torch.launch.sharding`) put the collectives where a value
crosses ranks, each leaf's gradient is summed over the batch group only,
and AdamW's global-norm clip sees the global norm.  The loss, the
gradients and the updated shards equal one process's.  The cache
placements, ``params_specs``' callers and ``build_jitted`` wait for the
sharded serve pools and the dry run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from repro_torch.launch.sharding import (
    LM_RULES, ShardCtx, Sharded, zip_map, axis_names, axis_sizes,
    batch_axes, leaf_uses, make_ctx, spec_tree, use_ctx,
)
from repro_torch.models.lm.model import family_fns
from repro_torch.optim.adamw import (
    AdamWConfig, adamw_update_, tree_leaves, tree_map,
)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str   # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """The step's batch as ``meta`` tensors (shapes and dtypes, no
    memory; the reference's ``ShapeDtypeStruct`` stand-ins)."""
    from repro_torch.models.lm.common import torch_dtype
    B, S = shape.batch, shape.seq
    if shape.kind == "decode":
        return {"tokens": _meta((B, 1), torch.int32)}
    dt = torch_dtype(cfg.dtype)
    if cfg.family == "encdec":
        half = S // 2
        out = {"frames": _meta((B, half, cfg.d_model), dt),
               "tokens": _meta((B, half), torch.int32)}
        if shape.kind == "train":
            out["labels"] = _meta((B, half), torch.int32)
        return out
    if cfg.family == "vlm":
        n_img = min(cfg.n_frontend_tokens, S // 2)
        out = {"tokens": _meta((B, S - n_img), torch.int32),
               "patch_embeds": _meta((B, n_img, cfg.frontend_dim), dt)}
        if shape.kind == "train":
            out["labels"] = _meta((B, S - n_img), torch.int32)
        return out
    out = {"tokens": _meta((B, S), torch.int32)}
    if shape.kind == "train":
        out["labels"] = _meta((B, S), torch.int32)
    return out


def params_specs(cfg):
    """The parameter tree as ``meta`` tensors (the reference's
    ``eval_shape`` of its init)."""
    from repro_torch.models.lm.common import META
    return family_fns(cfg).init(META, cfg)


def make_shape_ctx(mesh, cfg, shape: ShapeSpec,
                   fsdp: bool = False) -> ShardCtx:
    """The context of ``cfg`` at ``shape`` on ``mesh`` (a ``DeviceMesh`` or
    a :class:`~repro_torch.exec.plan.MeshSpec`): the ``dp_only`` layout
    when the config asks for it, and the batch over progressively fewer
    axes when the global batch does not divide (a batch of 1 is
    replicated)."""
    seq_sharded = shape.name == "long_500k"
    dp_only = getattr(cfg, "parallel", "tp") == "dp_only"
    ctx = make_ctx(mesh, fsdp=fsdp or dp_only, seq_sharded=seq_sharded,
                   dp_only=dp_only)
    sizes = axis_sizes(mesh)

    def axes_size(names):
        return math.prod(sizes[n] for n in names or ())

    b = ctx.logical["batch"]
    if b and shape.batch % axes_size(b) != 0:
        for cand in (("data", "model"), ("data",), None):
            cand = tuple(a for a in (cand or ()) if a in axis_names(mesh)) \
                or None
            if cand is None or (shape.batch % axes_size(cand) == 0
                                and shape.batch > 1):
                ctx.logical["batch"] = cand
                break
    return ctx


def batch_sharding(ctx: ShardCtx, batch_tree):
    """Each batch leaf's placements: its leading dim over the batch
    axes."""
    return {k: ctx.sharding(("batch",) + (None,) * (v.ndim - 1))
            for k, v in batch_tree.items()}


def state_sharding(ctx: ShardCtx, state_shape):
    """Placements of ``{"params", "opt"}`` (global shapes): the parameters
    by the LM rules, each AdamW moment as its parameter, the step count
    replicated."""
    out = {"params": spec_tree(state_shape["params"], ctx, LM_RULES)}
    if "opt" in state_shape:
        out["opt"] = {
            "mu": spec_tree(state_shape["opt"]["mu"], ctx, LM_RULES),
            "nu": spec_tree(state_shape["opt"]["nu"], ctx, LM_RULES),
            "step": ctx.sharding(())}
    return out


def _use_params(p, uses, ctx: ShardCtx, groups):
    """The tree the model reads: each leaf it computes on split or
    replicated as is, with its gradient summed over the batch ``groups``
    (:class:`~repro_torch.exec.collectives.ReduceGrads`); each leaf it
    needs whole as a :class:`~repro_torch.launch.sharding.Sharded`, which
    the layer gathers at use and whose gradient the gather reduces."""
    from repro_torch.exec.collectives import ReduceGrads
    flags = tree_leaves(uses)
    plain = [t for t, u in zip(tree_leaves(p), flags) if not u.gather]
    if groups and plain:
        plain = list(ReduceGrads.apply(tuple(groups for _ in plain),
                                       *plain))
    plain = iter(plain)

    def one(t, u):
        if not u.gather:
            return next(plain)
        return Sharded(t, tuple((ctx.groups[a], d) for a, d in u.split),
                       groups)

    return zip_map(one, p, uses)


def sharded_global_norm(grads, uses, ctx: ShardCtx) -> torch.Tensor:
    """The global norm of the gradients of a sharded state: each leaf's
    sum of squares summed over the mesh axes its shard is split over (a
    replicated leaf counted once), the buckets added."""
    from repro_torch.exec.collectives import all_reduce_
    buckets: Dict[tuple, Any] = {}
    for g, u in zip(tree_leaves(grads), tree_leaves(uses)):
        key = tuple(sorted(a for a, _ in u.split))
        buckets[key] = buckets.get(key, 0.0) + torch.sum(g.float() ** 2)
    total = 0.0
    for key in sorted(buckets):
        sq = buckets[key]
        for a in key:
            all_reduce_(sq, ctx.groups[a])
        total = total + sq
    return torch.sqrt(total)


def _leaf_uses(cfg, ctx: Optional[ShardCtx]):
    """Each parameter leaf's :class:`~repro_torch.launch.sharding.LeafUse`
    under ``state_sharding`` when ``ctx`` is bound to process groups, else
    None (one device)."""
    if ctx is None or ctx.groups is None:
        return None
    shapes = params_specs(cfg)
    return leaf_uses(
        shapes, state_sharding(ctx, {"params": shapes})["params"], ctx)


def make_grad_fn(cfg, ctx: Optional[ShardCtx] = None, plan=None):
    """``grad_fn(params, batch) -> (loss, aux, grads)``: the family loss
    (through ``build_apply((None, cfg), plan)`` with a plan) and its
    gradients, a tree of ``params``' layout.  Under a context bound to
    process groups ``params`` are this rank's shards and ``batch`` its
    rows (``data.pipeline.device_put_global`` over the context's batch
    axes); the loss and ``aux`` are the global ones and each gradient is
    that of the rank's shard of the global loss."""
    if plan is not None:
        from repro_torch.exec import build_apply
        loss_apply = build_apply((None, cfg), plan)
    else:
        loss_fn = family_fns(cfg).loss
        loss_apply = lambda p, b: loss_fn(p, b, cfg)  # noqa: E731
    uses = _leaf_uses(cfg, ctx)
    groups = None if uses is None \
        else tuple(ctx.groups[a] for a in batch_axes(ctx))

    def grad_fn(params, batch):
        with use_ctx(ctx):
            p = tree_map(lambda t: t.detach().requires_grad_(), params)
            used = p if uses is None \
                else _use_params(p, uses, ctx, groups)
            loss, aux = loss_apply(used, batch)
            leaves = iter(torch.autograd.grad(loss, tree_leaves(p)))
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, \
            tree_map(lambda _: next(leaves), p)

    return grad_fn


def make_train_step(cfg, opt_cfg: Optional[AdamWConfig] = None,
                    ctx: Optional[ShardCtx] = None, plan=None):
    """fwd + bwd + AdamW: ``step(state, batch) -> (state, metrics)`` with
    ``state = {"params", "opt"}``.  With an
    :class:`~repro_torch.exec.plan.ExecutionPlan` the loss is built through
    ``build_apply((None, cfg), plan)``, so the plan's seq engine and kernel
    backend run inside the step; without one the config's
    ``remat``/``row_chunks`` apply directly.  The update is in place
    (:func:`~repro_torch.optim.adamw.adamw_update_`): the step overwrites
    ``state``'s tensors, as the reference's jitted step donates them, so
    no second copy of the parameters and moments is made.  Metrics stay
    tensors (read them with ``float`` where the host needs them).

    ``ctx`` — a context bound to process groups
    (:func:`~repro_torch.launch.sharding.bind_groups`) — makes the step
    sharded (:func:`make_grad_fn`): ``state`` holds this rank's shards
    under :func:`state_sharding` (:func:`~repro_torch.launch.sharding.
    local_shards`); the loss and the metrics are the global ones, and the
    clip reads the global gradient norm (:func:`sharded_global_norm`)."""
    opt_cfg = opt_cfg or AdamWConfig()
    grad_fn = make_grad_fn(cfg, ctx=ctx, plan=plan)
    uses = _leaf_uses(cfg, ctx)
    norm = None if uses is None \
        else lambda g: sharded_global_norm(g, uses, ctx)  # noqa: E731

    def train_step(state, batch):
        loss, aux, grads = grad_fn(state["params"], batch)
        _, _, om = adamw_update_(state["params"], grads, state["opt"],
                                 opt_cfg, global_norm_fn=norm)
        return state, {"loss": loss, **aux, **om}

    return train_step


def make_prefill_step(cfg, cache_len: int):
    """``prefill_step(params, batch) -> (token, caches)``: the prompt's
    forward with caches for ``cache_len`` positions (the reference's
    ``shape.seq``), and the greedy (argmax) next token per row, int32."""
    prefill = family_fns(cfg).prefill

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, caches = prefill(params, batch, cfg, cache_len)
        token = torch.argmax(logits[:, -1].float(), dim=-1).to(torch.int32)
        return token, caches

    return prefill_step


def make_serve_step(cfg):
    """``serve_step(params, caches, batch) -> (token, caches)``: one
    decode step of ``batch["tokens"]`` (B, 1) and its greedy next token
    per row, int32."""
    decode = family_fns(cfg).decode

    @torch.no_grad()
    def serve_step(params, caches, batch):
        logits, caches = decode(params, batch["tokens"], caches, cfg)
        token = torch.argmax(logits[:, -1].float(), dim=-1).to(torch.int32)
        return token, caches

    return serve_step
