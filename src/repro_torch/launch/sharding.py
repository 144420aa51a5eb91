"""Name-based sharding rules: logical activation axes and regex parameter
rules (counterpart of ``repro.launch.sharding``).

The logical vocabulary, the param rules and the divisibility fallback are
the reference's, case for case:

  batch  -> ("pod", "data") (multi-pod) | ("data",)
  fsdp   -> ("data",) when FSDP is on, else None
  tp     -> ("model",)
  expert -> ("model",)  (expert parallelism shares the model axis)
  seq    -> ("data",) only for length-sharded long-context decode

A resolved *spec* is what the reference's ``PartitionSpec`` holds, one
entry per tensor dim (``None``, an axis name or a tuple of them), so
:func:`filter_spec` can be held to the reference's tuple for tuple.
:func:`placements` turns it into what ``torch.distributed.tensor`` takes:
one ``Shard(d)`` or ``Replicate()`` per mesh dim.  A mesh is a
``DeviceMesh`` (:func:`repro_torch.launch.mesh.build_mesh`); the rules and
the placements need only its axis names and sizes, so a
:class:`~repro_torch.exec.plan.MeshSpec` stands in for one there.

:func:`lc` is the seam where the reference lets GSPMD partition a value.
Here each rank holds its own shard, so ``lc`` slices the global value
``x`` down to this rank's part under the active :class:`ShardCtx` (a view:
gradients flow back into ``x``'s slice); without a context it is the
identity, so the same code runs on one device.  The CNN shard wrapper
uses it so (:mod:`repro_torch.exec.engines`).

**What ``lc`` becomes for the LM.**  Under GSPMD the reference's 28
``lc(...)`` calls in ``repro.models.lm`` only *constrain* a value.  In the
port each rank computes on local tensors, and each of those calls is a
:func:`seam` at the same line, with the same logical names, that stands
for the collective its transition needs:

* a ``"batch"`` entry is already true: each rank holds its own slice of
  the batch (:func:`repro_torch.launch.steps.batch_sharding`);
* a ``"tp"``-named seam after a column-parallel product (q/k/v heads, the
  MLP's ff, the vocab of the logits, the experts) is a no-op: the rank
  holds its columns;
* a ``(..., None)`` seam after a row-parallel product (the attention and
  MLP outputs, the experts' combine, a vocab-split embedding) sums the
  partial values over the model group (``partial=True``:
  :class:`~repro_torch.exec.collectives.ReduceFromGroup`);
* the input of a column-parallel product enters through :func:`enter`
  (:class:`~repro_torch.exec.collectives.CopyToGroup`: the identity, whose
  backward sums the input's partial gradients over the group).

Which leaves a rank computes on split is read from their placements, never
from the config's name: :func:`leaf_uses` keeps a leaf split where its one
split is over the tensor-parallel axis along the dim its layer partitions
(:data:`TP_DIMS`), and marks every other split leaf to be gathered at use
(:class:`Sharded`, :func:`at_use`): the SSM's fused in-projection, the
divisibility fallbacks (``wk`` row-split over ``d``), every leaf the
``dp_only`` layout 2-D shards.  That part then runs whole on every rank of
the model group: the same arithmetic.  So storage always equals
:func:`~repro_torch.launch.steps.state_sharding`'s placements.  Without a
context bound to process groups (:func:`bind_groups`) every seam is the
identity and the model runs on one device unchanged.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import types
from typing import Any, List, Optional, Sequence, Tuple

#: the active context: process-wide, not thread-local, because the
#: autograd engine runs a CUDA backward on a thread of its own, where a
#: checkpointed region recomputes and its seams must see the step's context
_STATE = types.SimpleNamespace(ctx=None)


def _current() -> Optional["ShardCtx"]:
    return _STATE.ctx


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict:
    return dict(zip(axis_names(mesh), tuple(mesh.shape)))


@dataclasses.dataclass
class ShardCtx:
    mesh: Any       # DeviceMesh, or a MeshSpec for placement arithmetic
    logical: dict   # logical name -> physical axis name(s) or None
    #: this rank's process group over each mesh axis (None where the axis
    #: spans one rank); set by :func:`bind_groups`, None for placement
    #: arithmetic
    groups: Optional[dict] = None
    #: the global self- and cross-attention KV cache lengths of a serving
    #: step (set by the steps of :mod:`repro_torch.launch.steps`), from
    #: which a decoding attention layer tells a cache split along its
    #: positions from a whole one (:func:`kv_seq_split`)
    kv_lens: Tuple[int, int] = (0, 0)

    def resolve(self, names: Sequence) -> tuple:
        """The physical spec of the logical ``names``, one entry per dim,
        spelled as the reference's ``PartitionSpec`` spells it (a single
        axis as its name)."""
        phys = []
        for n in names:
            if n is None:
                phys.append(None)
            elif isinstance(n, (tuple, list)):
                merged: Tuple = ()
                for sub in n:
                    m = self.logical.get(sub)
                    if m:
                        merged += m if isinstance(m, tuple) else (m,)
                phys.append(merged if merged else None)
            else:
                phys.append(self.logical.get(n))
        return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                     for p in phys)

    def sharding(self, names: Sequence) -> tuple:
        """The placements of the logical ``names`` on this mesh."""
        return placements(self.resolve(names), self.mesh)


def make_ctx(mesh, *, fsdp: bool = False, seq_sharded: bool = False,
             dp_only: bool = False) -> ShardCtx:
    axes = axis_names(mesh)
    if dp_only:
        # pure data-parallel/FSDP layout: batch over every axis, params
        # 2-D sharded over (data, model)
        batch = tuple(a for a in ("pod", "data", "model") if a in axes)
        shard2d = tuple(a for a in ("data", "model") if a in axes)
        return ShardCtx(mesh, {
            "batch": batch if batch else None,
            "tp": None,
            "expert": None,
            "fsdp": shard2d if fsdp else None,
            "seq": ("data",) if (seq_sharded and "data" in axes) else None,
        })
    batch = tuple(a for a in ("pod", "data") if a in axes)
    return ShardCtx(mesh, {
        "batch": batch if batch else None,
        "tp": ("model",) if "model" in axes else None,
        "expert": ("model",) if "model" in axes else None,
        "fsdp": ("data",) if (fsdp and "data" in axes) else None,
        "seq": ("data",) if (seq_sharded and "data" in axes) else None,
    })


def make_plan_ctx(mesh, spec) -> ShardCtx:
    """ShardCtx for a plan's :class:`~repro_torch.exec.plan.MeshSpec`:
    batch over the spec's data axis (after a "pod" axis when the mesh has
    one), tensor and expert parallelism over its model axis.  The engine
    shard wrappers (:mod:`repro_torch.exec.engines`) resolve logical
    names against it."""
    axes = axis_names(mesh)
    batch = tuple(a for a in ("pod", spec.data_axis) if a in axes)
    model = (spec.model_axis,) if spec.model_axis in axes else None
    return ShardCtx(mesh, {
        "batch": batch or None,
        "tp": model,
        "expert": model,
        "fsdp": None,
        "seq": None,
    })


@contextlib.contextmanager
def use_ctx(ctx: Optional[ShardCtx]):
    prev = _current()
    _STATE.ctx = ctx
    try:
        yield
    finally:
        _STATE.ctx = prev


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axes_size(mesh, entry) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in _entry_axes(entry):
        n *= sizes[a]
    return n


def filter_spec(spec: Sequence, shape, mesh) -> tuple:
    """Drop mesh axes from the dims they do not divide (replicate instead)
    — the reference's fallback for awkward head or channel counts."""
    out = []
    for d, entry in enumerate(spec):
        if entry is not None and shape[d] % _axes_size(mesh, entry) != 0:
            out.append(None)
        else:
            out.append(entry)
    out += [None] * (len(shape) - len(out))
    return tuple(out)


def placements(spec: Sequence, mesh) -> tuple:
    """One ``torch.distributed.tensor`` placement per mesh dim: ``Shard(d)``
    where tensor dim ``d``'s entry names that mesh axis, else
    ``Replicate()``.  A dim split over several axes (``batch`` over pod and
    data) is split over them major to minor, as the mesh orders them."""
    from torch.distributed.tensor import Replicate, Shard
    owner = {a: d for d, entry in enumerate(spec)
             for a in _entry_axes(entry)}
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in axis_names(mesh))


def _coordinate(mesh) -> List[int]:
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return list(coord)


def local_bounds(shape, mesh, places) -> List[List[int]]:
    """``[[start, stop], ...]`` per tensor dim of this rank's slice under
    ``places`` (``DTensor``'s even chunking, mesh dims in order)."""
    bounds = [[0, int(s)] for s in shape]
    sizes = tuple(mesh.shape)
    for i, (p, c) in enumerate(zip(places, _coordinate(mesh))):
        d = getattr(p, "dim", None)
        if d is None:
            continue
        a, b = bounds[d]
        chunk = -(-(b - a) // sizes[i])
        lo = min(a + c * chunk, b)
        bounds[d] = [lo, min(lo + chunk, b)]
    return bounds


def shard_of(x, places, mesh):
    """This rank's slice of the global tensor ``x`` under ``places`` (a
    view)."""
    for d, (a, b) in enumerate(local_bounds(x.shape, mesh, places)):
        if (a, b) != (0, x.shape[d]):
            x = x.narrow(d, a, b - a)
    return x


def lc(x, *names):
    """This rank's slice of ``x`` under the logical ``names`` (after the
    divisibility fallback); ``x`` itself without an active context."""
    ctx = _current()
    if ctx is None:
        return x
    spec = filter_spec(ctx.resolve(names), x.shape, ctx.mesh)
    return shard_of(x, placements(spec, ctx.mesh), ctx.mesh)


def local_shards(tree, places, mesh):
    """This rank's shard of every leaf of the global ``tree`` under its
    placements in ``places`` (a tree of the same layout), each a copy: no
    rank keeps a view of the whole leaf."""
    return zip_map(lambda t, pl: shard_of(t, pl, mesh).clone(), tree,
                   places)


def zip_map(fn, tree, other):
    """``fn(leaf, other's leaf)`` over ``tree``'s structure, in the leaf
    order of :func:`~repro_torch.optim.adamw.tree_leaves` (dict keys
    sorted; ``other``'s leaves may be tuples themselves, as placements
    are)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: zip_map(fn, tree[k], other[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(zip_map(fn, t, o) for t, o in zip(tree, other))
    return fn(tree, other)


# ---------------------------------------------------------------------------
# The LM's seams on local tensors
# ---------------------------------------------------------------------------


def bind_groups(ctx: ShardCtx) -> ShardCtx:
    """``ctx`` with this rank's process group over each mesh axis (a
    collective call: every rank binds, in the same order)."""
    from repro_torch.exec.collectives import axis_group
    return dataclasses.replace(ctx, groups={
        a: axis_group(ctx.mesh, (a,)) for a in axis_names(ctx.mesh)})


def _bound() -> Optional[ShardCtx]:
    ctx = _current()
    return ctx if ctx is not None and ctx.groups is not None else None


def batch_axes(ctx: ShardCtx) -> Tuple[str, ...]:
    """The mesh axes the batch is split over (after ``make_shape_ctx``'s
    fallback), those of one rank left out."""
    sizes = axis_sizes(ctx.mesh)
    return tuple(a for a in _entry_axes(ctx.logical.get("batch"))
                 if sizes[a] > 1)


def tp_axis(ctx: ShardCtx) -> Optional[str]:
    """The mesh axis the layers compute on split (tensor, vocab and
    expert parallelism), or None: none is named, it spans one rank, or
    the batch is split over it too (the ``dp_only`` layout), so its ranks
    hold different rows and gather their leaves instead."""
    axes = _entry_axes(ctx.logical.get("tp"))
    if len(axes) != 1 or axis_sizes(ctx.mesh)[axes[0]] == 1 \
            or axes[0] in _entry_axes(ctx.logical.get("batch")):
        return None
    return axes[0]


@dataclasses.dataclass(frozen=True)
class TP:
    """This rank's place on the tensor-parallel axis."""
    group: Any
    rank: int
    size: int


def tp() -> Optional[TP]:
    """The active tensor-parallel group, or None (no bound context, or no
    axis the layers compute on split)."""
    import torch.distributed as dist
    ctx = _bound()
    axis = tp_axis(ctx) if ctx is not None else None
    if axis is None:
        return None
    group = ctx.groups[axis]
    return TP(group, dist.get_rank(group), dist.get_world_size(group))


def seam(x, *names, partial: bool = False):
    """The LM's ``lc``: ``x`` itself, unless ``partial`` marks the partial
    sums of a row-parallel product, which are summed over the model group
    (forward; the backward is the identity).  ``names`` are the
    reference's logical names at that line."""
    t = tp() if partial else None
    if t is None:
        return x
    from repro_torch.exec.collectives import ReduceFromGroup
    return ReduceFromGroup.apply(x, t.group)


def enter(x):
    """The input of a column-parallel product: the identity, whose
    backward sums ``x``'s partial gradients over the model group."""
    t = tp()
    if t is None:
        return x
    from repro_torch.exec.collectives import CopyToGroup
    return CopyToGroup.apply(x, t.group)


def split_offset(n_local: int, n_global: int) -> Optional[int]:
    """Where this rank's slice of a dim of ``n_global`` starts, when the
    rank holds ``n_local < n_global`` of it along the model axis; None for
    a whole dim."""
    t = tp()
    if t is None or n_local == n_global:
        return None
    if n_local * t.size != n_global:
        raise ValueError(f"a split dim of {n_local} is not 1/{t.size} of "
                         f"{n_global}")
    return t.rank * n_local


def kv_lens() -> Tuple[int, int]:
    """The active serving step's global (self, cross) KV cache lengths."""
    ctx = _bound()
    return ctx.kv_lens if ctx is not None else (0, 0)


def kv_seq_split(heads_whole: bool, seq: int) -> Optional[TP]:
    """The model group a KV cache of ``seq`` positions (global) is split
    over along its positions, or None.  The reference's ``_kv_fallback``
    puts a cache's positions over the model axis when its kv heads do not
    divide that axis and its positions do; a layer computes on such a
    cache when the model axis is the tensor-parallel one and nothing else
    splits the positions.  Any other split (positions over the data axis
    too, the long-context shape) the step gathers, and the layer sees the
    cache whole."""
    t = tp() if heads_whole else None
    if t is None:
        return None
    ctx = _bound()
    if tp_axis(ctx) != "model" or any(filter_spec(
            ctx.resolve(("seq",)), (seq,), ctx.mesh)):
        return None
    if seq <= 0:
        raise ValueError("a sharded serving step must set its context's "
                         "kv_lens (the global KV cache lengths)")
    return t if seq % t.size == 0 else None


def tp_part(x, dim: int):
    """``x``'s slice along ``dim`` at this rank's place on the
    tensor-parallel axis when the dim divides over it (the cache
    placements' rule for a dim named "tp"), else ``x`` itself."""
    t = tp()
    n = x.shape[dim]
    if t is None or n % t.size:
        return x
    w = n // t.size
    return x.narrow(dim, t.rank * w, w)


def tp_gather(x, dim: int):
    """The tensor-parallel group's slices of ``x`` along ``dim``, whole
    (``x`` itself without a group)."""
    t = tp()
    if t is None:
        return x
    from repro_torch.exec.collectives import all_gather_cat
    return all_gather_cat(x, dim, t.group)


def batch_groups() -> tuple:
    """The process groups of the batch axes (one per axis), or ()."""
    ctx = _bound()
    if ctx is None:
        return ()
    return tuple(ctx.groups[a] for a in batch_axes(ctx))


def batch_sum(t):
    """``t`` summed over the ranks that hold other rows of the batch
    (backward: the identity); ``t`` itself on one device."""
    from repro_torch.exec.collectives import ReduceFromGroup
    for group in batch_groups():
        t = ReduceFromGroup.apply(t, group)
    return t


def batch_mean(t):
    """The mean of ``t`` over the ranks of the batch group (equal slices,
    so a per-slice mean becomes the global one)."""
    import math
    import torch.distributed as dist
    groups = batch_groups()
    if not groups:
        return t
    return batch_sum(t) / math.prod(dist.get_world_size(g) for g in groups)


#: the dim, counted from the end, along which an LM leaf's split over the
#: tensor-parallel axis is a partition its layer computes on: heads (q, k,
#: v column-parallel, the output projection row-parallel), the MLP's ff
#: (gate/up column-, down row-parallel), the vocabulary and the experts
TP_DIMS: Tuple[Tuple[str, int], ...] = (
    (r"(^|/)embed/table$", -2),
    (r"(^|/)unembed/w$", -1),
    (r"attn/w[qkv]$", -2),
    (r"attn/b[qkv]$", -2),
    (r"attn/wo$", -3),
    (r"(^|/)mlp/w_(gate|up)$", -1),
    (r"(^|/)mlp/w_down$", -2),
    (r"(^|/)moe/we_(gate|up|down)$", -3),
)


@dataclasses.dataclass(frozen=True)
class LeafUse:
    """How a rank uses its stored shard: ``split`` lists ``(mesh axis,
    dim)`` for each axis of more than one rank the leaf is split over
    (minor axis first); ``gather`` says the layer needs it whole."""
    split: Tuple[Tuple[str, int], ...]
    gather: bool


def leaf_uses(tree, places, ctx: ShardCtx):
    """Per leaf of the global ``tree`` (tensors, or ``meta`` ones), its
    :class:`LeafUse` under the placements ``places``."""
    sizes = axis_sizes(ctx.mesh)
    names = axis_names(ctx.mesh)
    axis = tp_axis(ctx)

    def one(path, leaf, pl):
        split = tuple((a, p.dim) for a, p in reversed(list(zip(names, pl)))
                      if getattr(p, "dim", None) is not None
                      and sizes[a] > 1)
        dim = next((d for pat, d in TP_DIMS if re.search(pat, path)), None)
        computable = axis is not None and dim is not None \
            and split == ((axis, leaf.ndim + dim),)
        return LeafUse(split, bool(split) and not computable)

    def walk(tree, pl, path):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: walk(tree[k], pl[k], path + (str(k),)) for k in tree}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(t, p, path + (str(i),))
                              for i, (t, p) in enumerate(zip(tree, pl)))
        return one("/".join(path), tree, pl)

    return walk(tree, places, ())


class Sharded:
    """A stored shard its layer computes on whole: :func:`at_use` gathers
    it (:class:`~repro_torch.exec.collectives.GatherLeaf`) where the layer
    reads it, so a stacked leaf is gathered one layer at a time
    (indexing a ``Sharded`` takes the layer's slice of the shard)."""

    __slots__ = ("local", "gathers", "reduce")

    def __init__(self, local, gathers, reduce):
        self.local, self.gathers, self.reduce = local, gathers, reduce

    def __getitem__(self, i):
        if any(d == 0 for _, d in self.gathers):
            raise ValueError("a leaf split along its layer axis")
        return Sharded(self.local[i],
                       tuple((g, d - 1) for g, d in self.gathers),
                       self.reduce)

    def gather(self):
        from repro_torch.exec.collectives import GatherLeaf
        return GatherLeaf.apply(self.local, self.gathers, self.reduce)


def at_use(tree):
    """``tree`` with every :class:`Sharded` leaf gathered whole (``tree``
    itself outside a sharded step, which alone makes such leaves)."""
    if _bound() is None:
        return tree
    return _gathered(tree)


def _gathered(tree):
    if isinstance(tree, Sharded):
        return tree.gather()
    if isinstance(tree, dict):
        return {k: _gathered(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_gathered(t) for t in tree)
    return tree


# ---------------------------------------------------------------------------
# Param rules
# ---------------------------------------------------------------------------

Rule = Tuple[str, Any]  # (path regex, logical names per dim, or a list)

#: the reference's rules for the LM parameter tree: a value is one
#: logical-name tuple or a list of candidates, the first of which keeps a
#: sharded dim after the divisibility filter wins
LM_RULES: Tuple[Rule, ...] = (
    (r"embed/table", ("tp", "fsdp")),            # (vocab, d)
    (r"unembed/w", ("fsdp", "tp")),              # (d, vocab)
    (r".*attn/wq", [("fsdp", "tp", None),        # (d, H, hd): heads first,
                    ("tp", None, None)]),        # else row-parallel over d
    (r".*attn/wk", [("fsdp", "tp", None), ("tp", None, None)]),
    (r".*attn/wv", [("fsdp", "tp", None), ("tp", None, None)]),
    (r".*attn/wo", [("tp", None, "fsdp"),        # (H, hd, d): heads first,
                    (None, None, "tp")]),        # else col-parallel over d
    (r".*attn/bq", ("tp", None)),
    (r".*attn/bk", ("tp", None)),
    (r".*attn/bv", ("tp", None)),
    (r".*mlp/w_gate", ("fsdp", "tp")),           # (d, ff)
    (r".*mlp/w_up", ("fsdp", "tp")),
    (r".*mlp/w_down", ("tp", "fsdp")),           # (ff, d)
    (r".*moe/router", (None, None)),             # (d, E) replicated
    (r".*moe/we_gate", ("expert", "fsdp", None)),  # (E, d, ff)
    (r".*moe/we_up", ("expert", "fsdp", None)),
    (r".*moe/we_down", ("expert", None, "fsdp")),  # (E, ff, d)
    (r".*ssm/w_in", ("fsdp", "tp")),
    (r".*ssm/(w_out|c_out)", ("tp", "fsdp")),
    (r".*ssm/conv_w", (None, None, "tp")),
    (r".*(scale|bias|gamma|beta|dt_bias|a_log|d_skip)$", (None,)),
)


def _map_with_path(fn, tree, path=()):
    """``fn(path string, leaf)`` over a tree of dicts, lists and tuples
    (dict keys sorted, ``None`` an empty subtree)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], path + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, t, path + (str(i),))
                          for i, t in enumerate(tree))
    return fn("/".join(path), tree)


def spec_tree(params: Any, ctx: ShardCtx, rules: Sequence[Rule] = LM_RULES,
              scan_prefix_dims: int = 0):
    """Per-leaf placements for a parameter tree through the first
    matching rule; a leaf no rule matches is replicated.  Leading dims a
    rule does not name get ``None``.  (``scan_prefix_dims`` is the
    reference's argument, which its rule fitting does not read either.)"""

    def _one(names, shape):
        names = tuple(names)
        pad = len(shape) - len(names)
        if pad < 0:  # rule longer than the leaf's rank: keep the last dims
            names = names[-len(shape):]
            pad = 0
        return filter_spec(ctx.resolve((None,) * pad + names), shape,
                           ctx.mesh)

    def assign(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        spec = (None,) * len(shape)
        for pat, names in rules:
            if re.search(pat, path):
                for cand in names if isinstance(names, list) else [names]:
                    spec = _one(cand, shape)
                    if any(e is not None for e in spec):
                        break
                break
        return placements(spec, ctx.mesh)

    return _map_with_path(assign, params)


def replicated(ctx: ShardCtx, tree: Any):
    """Every leaf's placements: replicated on every mesh dim."""
    return _map_with_path(
        lambda _, leaf: ctx.sharding((None,) * leaf.ndim), tree)
