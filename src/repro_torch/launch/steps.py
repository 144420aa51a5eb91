"""The LM train, prefill and serve steps (counterpart of
``repro.launch.steps``; the sharded steps, ``build_jitted`` and the
shape/sharding helpers wait for slice 11 of the port).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.lm.model import family_fns
from repro_torch.optim.adamw import (
    AdamWConfig, adamw_update_, tree_leaves, tree_map,
)


def make_train_step(cfg, opt_cfg: Optional[AdamWConfig] = None, plan=None):
    """fwd + bwd + AdamW: ``step(state, batch) -> (state, metrics)`` with
    ``state = {"params", "opt"}``.  With an
    :class:`~repro_torch.exec.plan.ExecutionPlan` the loss is built through
    ``build_apply((None, cfg), plan)``, so the plan's seq engine and kernel
    backend run inside the step; without one the config's
    ``remat``/``row_chunks`` apply directly.  The update is in place
    (:func:`~repro_torch.optim.adamw.adamw_update_`): the step overwrites
    ``state``'s tensors, as the reference's jitted step donates them, so
    no second copy of the parameters and moments is made.  Metrics stay
    tensors (read them with ``float`` where the host needs them)."""
    opt_cfg = opt_cfg or AdamWConfig()
    if plan is not None:
        from repro_torch.exec import build_apply
        loss_apply = build_apply((None, cfg), plan)
    else:
        loss_fn = family_fns(cfg).loss
        loss_apply = lambda p, b: loss_fn(p, b, cfg)  # noqa: E731

    def train_step(state, batch):
        p = tree_map(lambda t: t.detach().requires_grad_(), state["params"])
        loss, aux = loss_apply(p, batch)
        leaves = iter(torch.autograd.grad(loss, tree_leaves(p)))
        grads = tree_map(lambda _: next(leaves), p)
        del p
        _, _, om = adamw_update_(state["params"], grads, state["opt"],
                                 opt_cfg)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in aux.items()}, **om}
        return state, metrics

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
