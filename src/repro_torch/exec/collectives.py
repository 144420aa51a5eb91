"""The collectives the shard wrappers put at an engine's edges, as
autograd functions, and the column-parallel conv of the model axis.

The engines' custom ``autograd.Function`` s and the CUDA kernels take
plain tensors, so under a mesh each rank runs the engine on its own shard
and these are the only places values cross ranks:

* :class:`GatherBatch` — forward, all-gather the ranks' batch slices of an
  output along dim 0; backward, this rank's slice of the cotangent.
* :class:`ReduceGrads` — forward, the identity on the parameter leaves;
  backward, each leaf's gradient summed over its groups (the batch group
  for every leaf; also the model group for a split leaf, whose ranks each
  hold the gradient of their own channel slice and zeros elsewhere).
* :class:`ColumnParallel` — a ``Conv`` whose output channels are split
  over the model group (Megatron's column-parallel pair): the input enters
  through :class:`CopyToGroup` (identity; backward, the input gradient
  summed over the group, since each rank's slice contributes part of it)
  and the rank's channel slice of the output leaves through
  :class:`GatherChannels` (all-gather along channels; backward, the
  rank's slice).

The LM's sharded step (:mod:`repro_torch.launch.steps`) adds Megatron's
other half and the pieces of a sharded parameter:

* :class:`ReduceFromGroup` — forward, the sum over the group (a
  row-parallel product's partial sums, a vocab-split embedding's rows);
  backward, the identity.
* :class:`GatherLeaf` — a parameter whose stored shard is not a partition
  its layer can compute on: forward, the whole leaf, all-gathered over the
  mesh axes it is split over; backward, the gradient summed over the
  batch group, then this rank's slice of it.
* :func:`vocab_lse` / :func:`vocab_pick` — the log-sum-exp of logits split
  along the vocabulary (its max and its sum of exponentials all-reduced),
  and the label's logit, from whichever rank holds its column.

A collective takes its tensor where the group's backend needs it and
puts the result back where the tensor was (:func:`wire_device`): CUDA
tensors under ``gloo`` (ranks that share one card) go through host copies,
since gloo's all-gather takes CPU tensors only, and host tensors under
``nccl`` (the scheduler's token ids and byte counts) through the rank's
card, since NCCL takes CUDA tensors only.  A half-precision sum is taken
in fp32 and rounded once.  Under an obs
session every collective counts its calls and the bytes of the tensor it
sends (``collectives.calls``, ``collectives.bytes``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch import obs


def axis_group(mesh, axes: Sequence[str]):
    """This rank's process group over the mesh ``axes`` (ranks ordered
    row-major over them), or None when they span one rank.  A collective
    call: every rank makes every group, in the same order."""
    from repro_torch.launch.sharding import axis_names
    names = axis_names(mesh)
    dims = [names.index(a) for a in axes]
    ranks = mesh.mesh
    size = math.prod(ranks.shape[d] for d in dims)
    if size == 1:
        return None
    rest = [d for d in range(ranks.ndim) if d not in dims]
    grid = ranks.permute(*rest, *dims).reshape(-1, size).tolist()
    me, mine = dist.get_rank(), None
    for row in grid:
        g = dist.new_group(row)
        if me in row:
            mine = g
    return mine


def _count(t: torch.Tensor) -> None:
    obs.counter("collectives.calls").inc()
    obs.counter("collectives.bytes").inc(int(t.nbytes))


def wire_device(t: torch.Tensor, group) -> torch.device:
    """Where ``group``'s backend (the default group's for None) takes
    ``t``: the rank's card under ``nccl``, the host under ``gloo``."""
    if dist.get_backend(group) == "nccl":
        return t.device if t.is_cuda else torch.device("cuda")
    return torch.device("cpu")


def all_reduce_(t: torch.Tensor, group,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``t`` over ``group`` in place (a sum unless ``op`` says
    otherwise)."""
    _count(t)
    wire = wire_device(t, group)
    half = t.dtype in (torch.bfloat16, torch.float16)
    if wire != t.device or half:
        h = t.detach().to(wire, torch.float32 if half else t.dtype,
                          copy=True)
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` from the global rank ``src`` on every rank of ``group`` (the
    default group for None), in place."""
    _count(t)
    wire = wire_device(t, group)
    if wire != t.device:
        h = t.to(wire)
        dist.broadcast(h, src=src, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src=src, group=group)
    return t


def all_gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's slices of ``t`` (equal shapes), concatenated along
    ``dim`` in group-rank order."""
    src = t.contiguous()
    _count(src)
    src = src.to(wire_device(src, group))
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def _own_slice(g: torch.Tensor, dim: int, width: int, group):
    return g.narrow(dim, dist.get_rank(group) * width, width)


class GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        ctx.group, ctx.n = group, y.shape[0]
        return all_gather_cat(y, 0, group)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, 0, ctx.n, ctx.group), None


class GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        ctx.group, ctx.c = group, y.shape[-1]
        return all_gather_cat(y, y.ndim - 1, group)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, g.ndim - 1, ctx.c, ctx.group), None


class CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class ReduceFromGroup(torch.autograd.Function):
    """Forward, the sum of ``x`` over ``group``; backward, the identity
    (every rank's cotangent is already the whole one)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class GatherLeaf(torch.autograd.Function):
    """``apply(shard, gathers, reduce)``: ``gathers`` is ``((group, dim),
    ...)``, minor mesh axis first, each all-gathering the shard along
    ``dim`` over ``group``; the gradient is summed over the groups of
    ``reduce`` (the batch group) whole, then sliced back to the shard."""

    @staticmethod
    def forward(ctx, t, gathers, reduce):
        ctx.steps, ctx.reduce = [], reduce
        for group, dim in gathers:
            ctx.steps.append((group, dim, t.shape[dim]))
            t = all_gather_cat(t, dim, group)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        for group in ctx.reduce:
            all_reduce_(g, group)
        for group, dim, width in reversed(ctx.steps):
            g = _own_slice(g, dim, width, group)
        return g, None, None


def vocab_lse(logits: torch.Tensor, group) -> torch.Tensor:
    """The log-sum-exp over the last axis of fp32 ``logits`` whose columns
    are split over ``group``: the row max all-reduced (no gradient flows
    through it, as none does through a stable log-sum-exp's shift), then
    the sum of the shifted exponentials."""
    with torch.no_grad():
        m = all_reduce_(logits.max(dim=-1).values, group,
                        dist.ReduceOp.MAX)
    se = ReduceFromGroup.apply(torch.exp(logits - m[..., None]).sum(-1),
                               group)
    return m + torch.log(se)


def vocab_pick(logits: torch.Tensor, labels: torch.Tensor, lo: int,
               group) -> torch.Tensor:
    """Each row's logit at ``labels`` (global column ids, >= 0) where this
    rank's ``logits`` hold columns ``[lo, lo + width)``: each rank picks
    the labels it holds and zero elsewhere, and the group sums them."""
    n = logits.shape[-1]
    local = labels - lo
    inside = (local >= 0) & (local < n)
    picked = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    return ReduceFromGroup.apply(
        torch.where(inside, picked, torch.zeros_like(picked)), group)


class ReduceGrads(torch.autograd.Function):
    """``apply(groups, *leaves)``: ``groups[i]`` is the tuple of process
    groups leaf ``i``'s gradient is summed over."""

    @staticmethod
    def forward(ctx, groups, *leaves):
        ctx.groups = groups
        return tuple(l.view_as(l) for l in leaves)

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for g, groups in zip(grads, ctx.groups):
            if g is not None:
                g = g.clone()
                for group in groups:
                    all_reduce_(g, group)
            out.append(g)
        return (None, *out)


class ColumnParallel:
    """A ``Conv`` module whose output channels are split over the model
    group ``group``: it takes this rank's slice of the kernel and bias and
    returns the full output.  Every other attribute (geometry, shapes,
    intervals) is the wrapped module's, so the planners and row programs
    see the global layer."""

    def __init__(self, inner, group):
        self.inner, self.group = inner, group

    def __getattr__(self, name):
        if name == "inner":  # not set yet (a copy being built)
            raise AttributeError(name)
        return getattr(self.inner, name)

    def wrap(self, fn):
        """``fn(params, x, *rest)`` on the channel slice, as the full
        layer."""
        group = self.group

        def run(params, x, *rest):
            y = fn(params, CopyToGroup.apply(x, group), *rest)
            return GatherChannels.apply(y, group)

        return run

    def apply(self, params, x):
        return self.wrap(self.inner.apply)(params, x)

    def apply_row(self, params, x, iv_in, h_in, out_iv):
        return self.wrap(self.inner.apply_row)(params, x, iv_in, h_in,
                                               out_iv)


def unwrap(module):
    """The module a :class:`ColumnParallel` wraps, else ``module``."""
    return module.inner if isinstance(module, ColumnParallel) else module
