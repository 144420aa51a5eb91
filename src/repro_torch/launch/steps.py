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
gradients and the updated shards equal one process's.

The serving half: :func:`cache_shape_specs` and :func:`input_specs` (meta
tensors), the decode caches' placements (:func:`cache_sharding`, the
reference's ``_CACHE_LEAF_AXES`` and ``_kv_fallback``), and sharded
prefill and decode steps (``make_prefill_step(ctx=...)``,
``make_serve_step(ctx=...)``): each rank holds its shard of the
parameters and of the caches, and the logits and greedy tokens equal one
process's.  A cache leaf the layers compute on as it is split (kv heads
or, under the fallback, positions over the model axis; the SSM's and the
mLSTM's states by heads) stays a shard; any other split leaf (the conv
state's channels, the sLSTM's width, a layout the reference's rules give
that no layer computes on) reaches the model whole on the rank's rows and
is re-sharded after the step (:class:`_CacheLeaf`).  ``build_jitted``
waits for the dry run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from repro_torch.launch.sharding import (
    LM_RULES, ShardCtx, Sharded, zip_map, axis_names, axis_sizes,
    batch_axes, filter_spec, leaf_uses, local_bounds, make_ctx, placements,
    shard_of, spec_tree, tp_axis, use_ctx,
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


def shape_applicable(cfg, shape: ShapeSpec):
    """``(applicable, why not)``: 500k-token decode only for the
    architectures with a sub-quadratic path (the reference's rule)."""
    if shape.name == "long_500k" and not cfg.supports_long_context():
        return False, ("pure full-attention architecture: 500k decode is "
                       "linear-memory in context (KV cache) with no "
                       "sub-quadratic path; skipped per assignment rules")
    return True, ""


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


def _cache_shapes(cfg, batch: int, max_len: int, enc_len: int = 0):
    """The decode caches of ``batch`` rows and ``max_len`` positions (an
    encoder-decoder's cross K/V ``enc_len`` long) as ``meta`` tensors."""
    if cfg.family == "encdec":
        from repro_torch.models.lm.encdec import encdec_init_caches
        return encdec_init_caches(cfg, batch, max_len, enc_len, "meta")
    from repro_torch.models.lm.model import init_caches
    return init_caches(cfg, batch, max_len, "meta")


def cache_shape_specs(cfg, shape: ShapeSpec):
    """The decode caches of ``shape`` as ``meta`` tensors (the reference's
    ``eval_shape`` of ``init_caches``; an encoder-decoder's frames are
    half the shape's length)."""
    return _cache_shapes(cfg, shape.batch, shape.seq, shape.seq // 2)


def input_specs(cfg, shape: ShapeSpec, with_opt: bool = True):
    """Every abstract input of the step of (``cfg``, ``shape``), as
    ``meta`` tensors: the batch, and the train state (with AdamW's moments
    unless ``with_opt`` is false) or the parameters (and a decode's
    caches)."""
    from repro_torch.optim.adamw import adamw_init
    p = params_specs(cfg)
    out: Dict[str, Any] = {"batch": batch_specs(cfg, shape)}
    if shape.kind == "train":
        state = {"params": p}
        if with_opt:  # the step count is an int32 scalar, as there
            state["opt"] = dict(adamw_init(p), step=_meta((), torch.int32))
        out["state"] = state
    else:
        out["params"] = p
        if shape.kind == "decode":
            out["caches"] = cache_shape_specs(cfg, shape)
    return out


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


#: each cache leaf's logical axes by (name, rank of the unstacked leaf);
#: the dims a stacked layer prefix adds (0 to 2) are left-padded with
#: None.  The reference's table, entry for entry (an sLSTM's stacked
#: ``n``, rank 3, reads the mLSTM's entry there too)
_CACHE_LEAF_AXES = {
    ("k", 4): ("batch", "seq", "tp", None),    # (B, L, KV, hd)
    ("v", 4): ("batch", "seq", "tp", None),
    ("pos", 1): ("batch",),
    ("ring", 0): (),
    ("h", 4): ("batch", "tp", None, None),     # mamba (B, H, P, N)
    ("conv", 3): ("batch", None, "tp"),        # (B, k-1, C)
    ("C", 4): ("batch", "tp", None, None),     # mlstm (B, H, hd, hd)
    ("n", 3): ("batch", "tp", None),           # mlstm (B, H, hd)
    ("m", 2): ("batch", "tp"),                 # mlstm (B, H); slstm (B, d)
    ("c", 2): ("batch", "tp"),                 # slstm (B, d)
    ("n", 2): ("batch", "tp"),
    ("h", 2): ("batch", "tp"),
}


def _kv_fallback(ctx: ShardCtx, spec, shape, strip: int) -> tuple:
    """When the kv-head dim could not shard over the model axis (8 kv
    heads on a 16-way axis), the cache's positions go over it instead, if
    they divide: otherwise a 32k cache replicates 16x per chip.  (The
    reference looks the model axis up unconditionally and raises on a
    mesh without one; here such a mesh keeps the spec.)"""
    head, seq = strip + 2, strip + 1
    entries = list(spec) + [None] * (len(shape) - len(spec))
    sizes = axis_sizes(ctx.mesh)
    cur = entries[seq]
    cur = () if cur is None else (cur,) if isinstance(cur, str) \
        else tuple(cur)
    if entries[head] is not None or "model" in cur or "model" not in sizes:
        return tuple(spec)
    cand = cur + ("model",)
    if shape[seq] % math.prod(sizes[a] for a in cand) == 0:
        entries[seq] = cand if len(cand) > 1 else cand[0]
        return tuple(entries)
    return tuple(spec)


def _cache_spec(ctx: ShardCtx, name, shape):
    """``(spec, logical names)`` of one cache leaf (names None for a leaf
    no entry matches, which replicates)."""
    for strip in range(3):
        key = (name, len(shape) - strip)
        if key in _CACHE_LEAF_AXES:
            names = (None,) * strip + tuple(_CACHE_LEAF_AXES[key])
            spec = filter_spec(ctx.resolve(names), shape, ctx.mesh)
            if name in ("k", "v"):
                spec = _kv_fallback(ctx, spec, shape, strip)
            return spec, names
    return (None,) * len(shape), None


def _cache_leaves(tree, path=()):
    """``(path, leaf)`` of every cache leaf in :func:`tree_leaves` order
    (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _cache_leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _cache_leaves(t, path + (i,))
    elif tree is not None:
        yield path, tree


def _leaf_name(path):
    return next((p for p in reversed(path) if isinstance(p, str)), None)


def cache_sharding(ctx: ShardCtx, cfg, caches_shape):
    """The placements of every decode-cache leaf (global shapes): its
    logical axes from the leaf's name and rank, the divisibility fallback
    to replication, and for K/V :func:`_kv_fallback`.  A tree of
    ``caches_shape``'s layout."""
    it = iter([placements(_cache_spec(ctx, _leaf_name(p), t.shape)[0],
                          ctx.mesh)
               for p, t in _cache_leaves(caches_shape)])
    return tree_map(lambda _: next(it), caches_shape)


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


def _split_dims(cfg, path) -> tuple:
    """The logical names of the dims a cache leaf's layer computes on
    while they are split (its layer's declaration,
    :func:`~repro_torch.models.lm.blocks.block_cache_split`; every
    encoder-decoder cache is attention K/V)."""
    from repro_torch.models.lm.blocks import block_cache_split
    kind = "attn" if cfg.family == "encdec" \
        else cfg.scan_segments()[path[0]][0][path[1]]
    return block_cache_split(kind).get(_leaf_name(path), ())


class _CacheLeaf:
    """How a sharded step holds one cache leaf: ``places`` (its placements
    under :func:`cache_sharding`), ``bdim`` (its batch dim, or None) and
    whether the model computes on the shard itself (``split``) or on the
    leaf whole on this rank's rows (:meth:`to_rows`, :meth:`from_rows`)."""

    def __init__(self, ctx: ShardCtx, cfg, path, leaf, rows):
        spec, names = _cache_spec(ctx, _leaf_name(path), leaf.shape)
        self.ctx, self.rows = ctx, rows
        self.places = placements(spec, ctx.mesh)
        self.shape = tuple(leaf.shape)
        # the rows of every cache leaf but the ring flags follow its layer
        # axis (an sLSTM's stacked ``n`` names its layer axis "batch")
        self.bdim = 1 if len(self.shape) > 1 else None
        dims = {names.index(n) for n in _split_dims(cfg, path)
                if names and n in names}
        batch = batch_axes(ctx)
        tpa = tp_axis(ctx)
        sizes = axis_sizes(ctx.mesh)
        self.splits = [(a, p.dim) for a, p in zip(axis_names(ctx.mesh),
                                                  self.places)
                       if getattr(p, "dim", None) is not None
                       and sizes[a] > 1]
        rows = tuple(a for a, d in self.splits if d == self.bdim)
        self.split = (self.bdim is None or rows == batch) and all(
            (a in batch and d == self.bdim) or (a == tpa and d in dims)
            for a, d in self.splits)

    def to_rows(self, t):
        """The whole leaf on this rank's rows, from its shard."""
        from repro_torch.exec.collectives import all_gather_cat
        for a, d in reversed(self.splits):
            t = all_gather_cat(t, d, self.ctx.groups[a])
        if self.bdim is not None:
            t = t.narrow(self.bdim, self.rows[0],
                         self.rows[1] - self.rows[0])
        return t

    def from_rows(self, t):
        """This rank's shard of the leaf, from the whole leaf on its rows:
        the rows of the batch group gathered where the shard needs rows
        of other ranks."""
        from repro_torch.exec.collectives import all_gather_cat
        if self.bdim is not None and t.shape[self.bdim] != \
                self.shape[self.bdim]:
            for a in reversed(batch_axes(self.ctx)):
                t = all_gather_cat(t, self.bdim, self.ctx.groups[a])
        return shard_of(t, self.places, self.ctx.mesh)


def _cache_layout(ctx: ShardCtx, cfg, rows: int, cache_len: int,
                  enc_len: int):
    """One :class:`_CacheLeaf` per cache leaf (:func:`tree_leaves` order)
    of a step whose rank holds ``rows`` rows of the batch."""
    B = rows * math.prod(axis_sizes(ctx.mesh)[a] for a in batch_axes(ctx))
    lo, hi = local_bounds((B,), ctx.mesh, ctx.sharding(("batch",)))[0]
    return [_CacheLeaf(ctx, cfg, p, t, (lo, hi)) for p, t in
            _cache_leaves(_cache_shapes(cfg, B, cache_len, enc_len))]


def _whole_vocab(logits, cfg):
    """Logits whose columns are this rank's slice of the vocabulary,
    gathered whole over the model group."""
    if logits.shape[-1] == cfg.vocab:
        return logits
    from repro_torch.launch.sharding import tp_gather
    return tp_gather(logits.float(), logits.ndim - 1)


def _greedy(logits):
    return torch.argmax(logits[:, -1].float(), dim=-1).to(torch.int32)


def _serving(cfg, ctx: Optional[ShardCtx]):
    """``(uses, run)``: the parameter uses of a sharded step (None on one
    device) and ``run(fn, params, cache_len, enc_len)``, which calls
    ``fn(params)`` under the step's context, on the parameters as the
    model reads them."""
    uses = _leaf_uses(cfg, ctx)

    def run(fn, params, cache_len, enc_len):
        if uses is None:
            return fn(params)
        sctx = dataclasses.replace(ctx, kv_lens=(cache_len, enc_len))
        with use_ctx(sctx):
            return fn(_use_params(params, uses, ctx, ()))

    return uses, run


def make_prefill_step(cfg, cache_len: int, ctx: Optional[ShardCtx] = None):
    """``prefill_step(params, batch) -> (token, caches, logits)``: the
    prompt's forward with caches for ``cache_len`` positions (the
    reference's ``shape.seq``), the greedy (argmax) next token per row,
    int32, and the last position's logits (B, 1, V), which the
    reference's step does not return.

    ``ctx``, a context bound to process groups, makes the step sharded:
    ``params`` are this rank's shards under :func:`state_sharding` and
    ``batch`` its rows; the caches come back as this rank's shards under
    :func:`cache_sharding`, and the token and the logits are the whole
    ones of those rows."""
    prefill = family_fns(cfg).prefill
    uses, run = _serving(cfg, ctx)

    @torch.no_grad()
    def prefill_step(params, batch):
        enc_len = batch["frames"].shape[1] if "frames" in batch else 0

        def fn(p):
            logits, caches = prefill(p, batch, cfg, cache_len)
            if uses is None:
                return logits, caches
            layout = _cache_layout(ctx, cfg, batch["tokens"].shape[0],
                                   cache_len, enc_len)
            leaves = iter([t if c.split else c.from_rows(t).contiguous()
                           for t, c in zip(tree_leaves(caches), layout)])
            return (_whole_vocab(logits, cfg),
                    tree_map(lambda _: next(leaves), caches))

        logits, caches = run(fn, params, cache_len, enc_len)
        return _greedy(logits), caches, logits

    return prefill_step


def make_serve_step(cfg, ctx: Optional[ShardCtx] = None, cache_len: int = 0,
                    enc_len: int = 0):
    """``serve_step(params, caches, batch) -> (token, caches, logits)``:
    one decode step of ``batch["tokens"]`` (B, 1), its greedy next token
    per row, int32, and its logits (B, 1, V); the caches are updated in
    place.

    ``ctx`` makes the step sharded, as :func:`make_prefill_step`'s:
    ``caches`` are this rank's shards of caches of ``cache_len`` positions
    (an encoder-decoder's cross K/V ``enc_len`` long)."""
    decode = family_fns(cfg).decode
    uses, run = _serving(cfg, ctx)
    layouts: Dict[int, list] = {}

    @torch.no_grad()
    def serve_step(params, caches, batch):
        tokens = batch["tokens"]
        if uses is None:
            logits, caches = decode(params, tokens, caches, cfg)
            return _greedy(logits), caches, logits
        rows = tokens.shape[0]
        if rows not in layouts:
            layouts[rows] = _cache_layout(ctx, cfg, rows, cache_len,
                                          enc_len)
        layout = layouts[rows]
        local = tree_leaves(caches)
        view = iter([t if c.split else c.to_rows(t).contiguous()
                     for t, c in zip(local, layout)])
        whole = tree_map(lambda _: next(view), caches)

        def fn(p):
            logits, _ = decode(p, tokens, whole, cfg)
            return _whole_vocab(logits, cfg)

        logits = run(fn, params, cache_len, enc_len)
        for t, w, c in zip(local, tree_leaves(whole), layout):
            if not c.split:
                t.copy_(c.from_rows(w))
        return _greedy(logits), caches, logits

    return serve_step
