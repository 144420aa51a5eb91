"""Top-level decoder-only LM: init, the training loss, prefill and decode
(counterpart of ``repro.models.lm.model``) for the dense, MoE, SSM, hybrid
and VLM families; the encoder-decoder family has its own model,
:mod:`repro_torch.models.lm.encdec`.

The VLM vision tower is the reference's stub: ``batch["patch_embeds"]``
carries precomputed patch embeddings (B, n_patches, frontend_dim), which a
learned 2-layer projector maps into d_model and puts before the token
embeddings (LLaVA's order); the loss drops the image positions, which
carry no labels.

In a sharded step (:mod:`repro_torch.launch.steps`) each rank runs
:func:`lm_loss` on its slice of the batch with its shard of the
parameters: the embedding and the logits are vocab-parallel where the
table is split, the cross-entropy's log-sum-exp and label logit are
reduced over the vocabulary's ranks, and the loss is the global sum of
the masked NLL over the global count of labels.
"""

from __future__ import annotations

import types
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.sharding import (
    at_use, batch_sum, enter, seam, split_offset, tp,
)
from repro_torch.models.lm.blocks import (
    init_stack, init_stack_caches, stack_decode, stack_prefill, stack_train,
)
from repro_torch.models.lm.common import (
    dense_init, embed_apply, embed_init, init_rms, rms_norm, torch_dtype,
    unembed_apply, unembed_init,
)
from repro_torch.models.lm.config import ModelConfig


#: families this module runs (``encdec`` runs through ``encdec.py``)
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")


def check_ported(cfg: ModelConfig) -> None:
    """Raise for a family this module does not run: the encoder-decoder
    family has its own model functions in ``encdec.py``."""
    if cfg.family not in PORTED_FAMILIES:
        where = " (use repro_torch.models.lm.encdec)" \
            if cfg.family == "encdec" else ""
        raise ValueError(
            f"{cfg.name}: family {cfg.family!r} is not a decoder-only "
            f"family{where}; this module runs {', '.join(PORTED_FAMILIES)}")


def family_fns(cfg: ModelConfig) -> types.SimpleNamespace:
    """The model functions of ``cfg``'s family, ``init``, ``loss``,
    ``prefill`` and ``decode``: ``encdec.py``'s for the encoder-decoder
    family, this module's for the others (the reference's ``if
    cfg.family == "encdec"`` branches in one place)."""
    if cfg.family == "encdec":
        from repro_torch.models.lm import encdec as ED
        return types.SimpleNamespace(
            init=ED.init_encdec, loss=ED.encdec_loss,
            prefill=ED.encdec_prefill, decode=ED.encdec_decode)
    check_ported(cfg)
    return types.SimpleNamespace(init=init_lm, loss=lm_loss,
                                 prefill=lm_prefill, decode=lm_decode)


def init_lm(gen: torch.Generator, cfg: ModelConfig):
    """Seeded init on ``gen``'s device (the reference's tree layout)."""
    check_ported(cfg)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, cfg.param_dtype),
        "stack": init_stack(gen, cfg),
        "final_norm": {"scale": init_rms(cfg.d_model, cfg.param_dtype,
                                         gen)},
    }
    if not cfg.tie_embeddings:
        params["unembed"] = unembed_init(gen, cfg.d_model, cfg.vocab,
                                         cfg.param_dtype)
    if cfg.frontend == "vision":
        params["projector"] = {
            "w1": dense_init(gen, (cfg.frontend_dim, cfg.d_model),
                             cfg.param_dtype),
            "w2": dense_init(gen, (cfg.d_model, cfg.d_model),
                             cfg.param_dtype),
        }
    return params


def params_from_reference(tree, device="cuda"):
    """A parameter tree of the JAX package (``init_lm``'s, as numpy
    arrays) as torch tensors on ``device``: dicts, lists and tuples keep
    their shape and ``None`` stays ``None``, so leaves line up one for
    one."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_reference(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def caches_from_reference(tree, device="cuda"):
    """A decode-cache tree of the JAX package (``init_caches``' or
    ``lm_prefill``'s, as numpy arrays) as torch tensors on ``device``,
    leaf for leaf: a list over segments of tuples over pattern positions
    of ``{"k", "v", "pos", "ring"}`` / recurrent-state dicts."""
    return params_from_reference(tree, device)


def _embed_inputs(params, batch, cfg: ModelConfig, dtype):
    x = embed_apply(params["embed"], batch["tokens"].long(), dtype,
                    cfg.vocab)
    if cfg.frontend == "vision":
        pe = batch["patch_embeds"].to(dtype)
        # jax.nn.gelu's default is the tanh approximation
        pe = F.gelu(pe @ params["projector"]["w1"].to(dtype),
                    approximate="tanh")
        pe = pe @ params["projector"]["w2"].to(dtype)
        x = torch.cat([pe, x], dim=1)  # image tokens first (LLaVA)
    return seam(x, "batch", None, None)


def _head_offset(params, cfg: ModelConfig):
    """Where this rank's columns of the logits start when the head is
    vocab-split, else None."""
    w = params["embed"]["table"].T if cfg.tie_embeddings \
        else params["unembed"]["w"]
    return split_offset(w.shape[-1], cfg.vocab)


def _logits(params, x, cfg: ModelConfig, dtype):
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    if cfg.tie_embeddings:
        table = params["embed"]["table"]
        if split_offset(table.shape[0], cfg.vocab) is not None:
            x = enter(x)
        return seam(x.to(dtype) @ table.to(dtype).T, "batch", None, "tp")
    return unembed_apply(params["unembed"], x, dtype, cfg.vocab)


def lm_forward(params, batch, cfg: ModelConfig):
    check_ported(cfg)
    dtype = torch_dtype(cfg.dtype)
    x = _embed_inputs(params, batch, cfg, dtype)
    x, aux = stack_train(params["stack"], x, cfg)
    return _logits(params, x, cfg, dtype), aux


def softmax_xent(logits, labels, vocab_lo=None):
    """CE in fp32 on (possibly bf16) logits: logsumexp minus the label's
    logit, labels < 0 ignored.  Returns (sum_nll, n_valid).  The reference
    picks the label's logit with a one-hot contraction (sharding-friendly);
    a gather gives the same value without a (B, S, V) one-hot.
    ``vocab_lo`` marks logits that are this rank's columns of the
    vocabulary from ``vocab_lo`` on: the log-sum-exp and the label's logit
    are then reduced over the model group."""
    from repro_torch.exec.collectives import vocab_lse, vocab_pick
    lf = logits.float()
    labels = labels.long()
    if vocab_lo is None:
        lse = torch.logsumexp(lf, dim=-1)
        picked = lf.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    else:
        group = tp().group
        lse = vocab_lse(lf, group)
        picked = vocab_pick(lf, labels.clamp(min=0), vocab_lo, group)
    mask = (labels >= 0).float()
    return torch.sum((lse - picked) * mask), torch.sum(mask)


def chunked_xent(x, labels, logits_fn, n_chunks: int, vocab_lo=None):
    """Row-centric loss: the (B, S, V) logits are never whole — per
    sequence chunk, under ``torch.utils.checkpoint``: project, CE, release
    (Eq. 7 applied to the classifier head, the single largest activation in
    LM training).  ``vocab_lo``: see :func:`softmax_xent`."""
    S = labels.shape[1]
    if n_chunks <= 1 or S % n_chunks:
        return softmax_xent(logits_fn(x), labels, vocab_lo)
    c = S // n_chunks
    tot = torch.zeros((), device=x.device)
    cnt = torch.zeros((), device=x.device)
    for i in range(n_chunks):
        t, n = checkpoint(
            lambda xc, lc: softmax_xent(logits_fn(xc), lc, vocab_lo),
            x[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c],
            use_reentrant=False)
        tot = tot + t
        cnt = cnt + n
    return tot, cnt


def at_use_top(params):
    """The leaves outside the layer stacks gathered where a sharded step
    stores them split but uses them whole (the stacks gather one layer at
    a time, in their loops)."""
    return {k: v if k in ("stack", "enc", "dec") else at_use(v)
            for k, v in params.items()}


def lm_loss(params, batch, cfg: ModelConfig,
            lb_coeff: float = 0.01, z_coeff: float = 1e-3):
    """Next-token CE (labels = batch["labels"], -1 = ignore) + MoE aux
    (zero for the families without a ``moe`` layer)."""
    check_ported(cfg)
    dtype = torch_dtype(cfg.dtype)
    params = at_use_top(params)
    x = _embed_inputs(params, batch, cfg, dtype)
    x, aux = stack_train(params["stack"], x, cfg)
    labels = batch["labels"]
    if cfg.frontend == "vision":  # image positions carry no labels
        x = x[:, x.shape[1] - labels.shape[1]:]
    nc = cfg.row_chunks if cfg.remat in ("rows", "block_rows") else 1
    tot, cnt = chunked_xent(x, labels,
                            lambda xc: _logits(params, xc, cfg, dtype), nc,
                            _head_offset(params, cfg))
    # label masks make the counts differ per rank: the global sum over the
    # global count (identities on one device)
    ce = batch_sum(tot) / torch.clamp(batch_sum(cnt), min=1.0)
    loss = ce + lb_coeff * aux["load_balance"] + z_coeff * aux["z_loss"]
    return loss, {"ce": ce, **aux}


def lm_prefill(params, batch, cfg: ModelConfig, cache_len: int):
    """Full-sequence forward; returns (last-token logits (B, 1, V), caches
    sized for ``cache_len`` positions).  A VLM's image tokens come first
    and occupy cache positions too."""
    check_ported(cfg)
    dtype = torch_dtype(cfg.dtype)
    params = at_use_top(params)
    x = _embed_inputs(params, batch, cfg, dtype)
    x, caches = stack_prefill(params["stack"], x, cfg, cache_len, dtype)
    return _logits(params, x[:, -1:], cfg, dtype), caches


def lm_decode(params, tokens, caches, cfg: ModelConfig):
    """One-token decode.  tokens: (B, 1) integer.  Returns (logits (B, 1,
    V), caches); the caches are updated in place and returned."""
    dtype = torch_dtype(cfg.dtype)
    params = at_use_top(params)
    x = embed_apply(params["embed"], tokens.long(), dtype, cfg.vocab)
    x, caches = stack_decode(params["stack"], x, caches, cfg)
    return _logits(params, x, cfg, dtype), caches


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device=None):
    check_ported(cfg)
    return init_stack_caches(cfg, batch, max_len, torch_dtype(cfg.dtype),
                             device)
