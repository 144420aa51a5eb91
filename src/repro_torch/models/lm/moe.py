"""Mixture-of-Experts layer: top-k routing, capacity-based dispatch
(GShard-style einsum) and shared experts (DeepSeek-MoE) — counterpart of
``repro.models.lm.moe``.

Tokens are regrouped as (G, t, d) with ``G = batch * seq_groups`` (or
``batch`` when the sequence does not divide into ``seq_groups``), each
group routing its ``t`` tokens into per-expert queues of capacity ``C``;
a choice ranked at or past ``C`` in its expert's queue is dropped.

In a sharded step each rank routes the groups of its own batch slice (the
capacity is per group, so a slice holds whole groups) on every rank of
the model group, then runs the experts it holds (``E/M`` of them, split
over the model axis) on its tokens: the partial output, taken in fp32, is
summed over the model group.  The routing weights enter the split region
through :func:`~repro_torch.launch.sharding.enter`, so the router's
gradient sums every rank's experts.  The load-balance loss ``E·Σ(me·ce)``
is a product of two means over all groups, so ``me``, ``ce`` and the
z-loss are averaged over the batch group before the product.

Routing follows the reference's integers exactly: the top-k choices are
taken by a stable descending sort (``jax.lax.top_k`` breaks ties by the
lower index; ``torch.topk`` promises no order), and a rank's one-hot over
the capacity slots is built by comparison, so a rank at or past ``C``
gives an all-zero row as ``jax.nn.one_hot`` does.

Aux losses: load-balance (Switch-style) and the router z-loss, returned to
the caller for the training objective.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.launch.sharding import (
    batch_mean, enter, seam, split_offset,
)
from repro_torch.models.lm.common import dense_init
from repro_torch.models.lm.mlp import init_mlp, mlp_apply


@dataclasses.dataclass(frozen=True)
class MoEDims:
    d: int
    d_expert: int
    n_experts: int
    top_k: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    seq_groups: int = 4


def init_moe(gen, dims: MoEDims, param_dtype, stack: int = 0):
    E, d, f = dims.n_experts, dims.d, dims.d_expert
    p = {
        "router": dense_init(gen, (d, E), "float32", scale=0.02,
                             stack=stack),
        "we_gate": dense_init(gen, (E, d, f), param_dtype, stack=stack),
        "we_up": dense_init(gen, (E, d, f), param_dtype, stack=stack),
        "we_down": dense_init(gen, (E, f, d), param_dtype, stack=stack),
    }
    if dims.n_shared:
        p["shared"] = init_mlp(gen, d, f * dims.n_shared, param_dtype,
                               stack=stack)
    return p


def _capacity(t: int, dims: MoEDims) -> int:
    c = int(t * dims.top_k / dims.n_experts * dims.capacity_factor)
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def route(probs, dims: MoEDims, C: int, experts=None, weights=None):
    """The routing of (G, t, E) router probabilities into queues of
    capacity ``C``: a dict of ``topw`` (G, t, k) normalised weights,
    ``topi`` (G, t, k) expert indices, ``onehot`` (G, t, k, E), ``pos``
    (G, t, k, E) 0-based ranks in each expert's queue (0 where not
    chosen), ``keep`` (G, t, k, E) and the (G, t, E, C) ``dispatch`` and
    ``combine`` tensors, all fp32 but ``topi``/``keep``.  ``experts =
    (lo, hi)`` builds ``dispatch``/``combine`` for those experts only, and
    ``weights`` (a function of ``topw``) is what ``combine`` weighs by."""
    G, t, E = probs.shape
    k = dims.top_k
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    topi = order[..., :k]
    topw = probs.gather(-1, topi)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(topi, E).float()                     # (G, t, k, E)
    # position of each (token, choice) within its expert queue
    pos = torch.cumsum(onehot.reshape(G, t * k, E), dim=1) \
        .reshape(G, t, k, E)
    pos = (pos - 1.0) * onehot                                # 0-based ranks
    keep = (pos < C) & (onehot > 0)
    lo, hi = experts or (0, E)
    w = weights(topw) if weights is not None else topw
    # dispatch / combine accumulate over the k choices, as the reference
    # does, so no (G, t, k, E, C) intermediate is built
    slots = torch.arange(C, device=probs.device, dtype=pos.dtype)
    dispatch = torch.zeros((G, t, hi - lo, C), device=probs.device)
    combine = torch.zeros((G, t, hi - lo, C), device=probs.device)
    for i in range(k):
        pc = (pos[:, :, i, lo:hi, None] == slots).float() \
            * keep[:, :, i, lo:hi, None]
        dispatch = dispatch + pc
        combine = combine + w[:, :, i, None, None] * pc
    return {"topw": topw, "topi": topi, "onehot": onehot, "pos": pos,
            "keep": keep, "dispatch": dispatch, "combine": combine}


def moe_apply(params, x, dims: MoEDims, n_chunks: int = 1):
    """x: (B, S, d) -> (y, aux) with aux = {load_balance, z_loss}.  The
    expert weights are cast to the activation dtype at every call, as the
    reference's ``astype`` does; ``n_chunks`` chunks the shared experts
    only (routing always sees the whole sequence)."""
    B, S, d = x.shape
    sg = dims.seq_groups if S % dims.seq_groups == 0 else 1
    G = B * sg
    t = S // sg
    xt = x.reshape(G, t, d)
    # each rank routes the groups of its own slice of the batch
    xt = seam(xt, ("batch", "tp"), None, None)

    logits = xt.float() @ params["router"].float()             # (G, t, E)
    probs = torch.softmax(logits, dim=-1)
    E = dims.n_experts
    El = params["we_gate"].shape[-3]
    lo = split_offset(El, E)
    r = route(probs, dims, _capacity(t, dims),
              experts=None if lo is None else (lo, lo + El),
              weights=None if lo is None else enter)

    dt = x.dtype
    xe = xt if lo is None else enter(xt)
    xin = torch.einsum("gtec,gtd->gecd", r["dispatch"].to(dt), xe)
    xin = seam(xin, None, "expert", None, None)
    h = F.silu(torch.einsum("gecd,edf->gecf", xin,
                            params["we_gate"].to(dt))) \
        * torch.einsum("gecd,edf->gecf", xin, params["we_up"].to(dt))
    xout = torch.einsum("gecf,efd->gecd", h, params["we_down"].to(dt))
    xout = seam(xout, None, "expert", None, None)
    if lo is None:
        y = torch.einsum("gtec,gecd->gtd", r["combine"].to(dt), xout)
        y = seam(y.reshape(B, S, d), "batch", None, None)
    else:  # this rank's experts' share, in fp32
        y = torch.einsum("gtec,gecd->gtd", r["combine"].to(dt).float(),
                         xout.float())
        y = seam(y.reshape(B, S, d), "batch", None, None,
                 partial=True).to(dt)

    if dims.n_shared:
        y = y + mlp_apply(params["shared"], x, n_chunks)

    # --- aux losses ------------------------------------------------------
    # means over every group of the global batch (identities on one device)
    me = batch_mean(probs.mean(dim=(0, 1)))         # mean router prob per e
    ce = batch_mean(r["onehot"].sum(dim=2).mean(dim=(0, 1)))  # routed share
    load_balance = E * torch.sum(me * ce)
    z_loss = batch_mean(torch.mean(torch.logsumexp(logits, dim=-1) ** 2))
    return y, {"load_balance": load_balance, "z_loss": z_loss}
