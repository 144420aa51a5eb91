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

Collectives on CUDA tensors under ``gloo`` (ranks that share one card)
go through host copies: gloo's all-gather takes CPU tensors only.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist


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


def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place."""
    if _via_host(t, group):
        h = t.cpu()
        dist.all_reduce(h, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=group)
    return t


def all_gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's slices of ``t`` (equal shapes), concatenated along
    ``dim`` in group-rank order."""
    src = t.contiguous()
    if _via_host(src, group):
        src = src.cpu()
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
