"""Optimizers on parameter trees: SGD-momentum (the paper's CNN regime) and
AdamW, with global-norm clipping (counterpart of ``repro.optim.adamw``).

A parameter tree is nested dicts, lists and tuples of tensors, walked in the
reference's leaf order (dict keys sorted); ``None`` is an empty subtree, as
in JAX.  Updates are functional, as in
the reference: they return new tensors and leave their inputs untouched.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

import torch


def tree_leaves(tree) -> List[torch.Tensor]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for t in tree for l in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def adamw_init(params):
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": 0}


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(l.float() ** 2)
                          for l in tree_leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, lr_scale=1.0):
    """Returns (new_params, new_state, metrics).  Leaf by leaf: the clipped
    gradient, the moments and the new parameter of one leaf are made
    before the next leaf's, so no clipped copy of the whole gradient tree
    is ever live (1.8 B parameters make that 7 GB in fp32)."""
    grads = tree_map(lambda g: g.float(), grads)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.clip_norm > 0 else None
    step = state["step"] + 1
    c1 = 1.0 - cfg.b1 ** step
    c2 = 1.0 - cfg.b2 ** step
    lr = cfg.lr * lr_scale

    def upd(p, g, m, n):
        if scale is not None:
            g = g * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        n = cfg.b2 * n + (1 - cfg.b2) * g * g
        pf = p.float()
        step_v = (m / c1) / (torch.sqrt(n / c2) + cfg.eps)
        return (pf - lr * (step_v + cfg.weight_decay * pf)).to(p.dtype), m, n

    out = [upd(p, g, m, n) for p, g, m, n in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state["mu"]),
        tree_leaves(state["nu"]))]
    new_p, mu, nu = (_unflatten(params, [o[i] for o in out])
                     for i in range(3))
    return new_p, {"mu": mu, "nu": nu, "step": step}, \
        {"grad_norm": gnorm, "lr": lr}


def _unflatten(like, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 5e-4
    clip_norm: float = 0.0


def sgd_init(params):
    return {"vel": tree_map(lambda p: torch.zeros_like(p,
                                                       dtype=torch.float32),
                            params)}


@torch.no_grad()
def sgd_update(params, grads, state, cfg: SGDConfig, lr_scale=1.0):
    """L2 weight decay added to the gradient, then momentum:
    ``v = m*v + (g + wd*p)``, ``p = p - lr*v``."""
    grads = tree_map(lambda g: g.float(), grads)
    if cfg.clip_norm > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)
    lr = cfg.lr * lr_scale

    def momentum(p, g, v):
        return cfg.momentum * v + (g + cfg.weight_decay * p.float())

    def descend(p, v):
        return (p.float() - lr * v).to(p.dtype)

    vel = tree_map(momentum, params, grads, state["vel"])
    new_p = tree_map(descend, params, vel)
    return new_p, {"vel": vel}, {"grad_norm": gnorm}
