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
identity, so the same code runs on one device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from typing import Any, List, Optional, Sequence, Tuple

_STATE = threading.local()


def _current() -> Optional["ShardCtx"]:
    return getattr(_STATE, "ctx", None)


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict:
    return dict(zip(axis_names(mesh), tuple(mesh.shape)))


@dataclasses.dataclass
class ShardCtx:
    mesh: Any       # DeviceMesh, or a MeshSpec for placement arithmetic
    logical: dict   # logical name -> physical axis name(s) or None

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
