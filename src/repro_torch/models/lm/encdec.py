"""Encoder-decoder backbone, the SeamlessM4T-medium configuration
(counterpart of ``repro.models.lm.encdec``).

The speech frontend (mel filterbank + conv feature extractor) is the
reference's stub: ``batch["frames"]`` carries precomputed frame embeddings
(B, T_frames, d_model).  The model is the transformer backbone: a
bidirectional encoder over the frames and a causal text decoder with
cross-attention in every layer.

The parameter and cache trees are the reference's: ``enc`` and ``dec`` are
each one dict of tensors stacked over their layers (the reference's
``vmap``-ed init), and the decode caches are ``{"self": {"k", "v", "pos",
"ring"}, "cross": {"k", "v"}}`` stacked over the decoder layers.  Where the
reference ``lax.scan``s over the layers, the port loops over them in
Python and indexes the stacked tensors.  Decode writes each layer's self
K/V into the stacked cache in place and reads the cross K/V that the
prefill wrote; the encoder has no decode step.

In a sharded step (:func:`encode`, :func:`encdec_loss`) each rank runs its
slice of the batch with its shard of the parameters: attention heads and
the MLP's ff column/row-parallel, the vocabulary split in the embedding,
the logits and the cross-entropy, the leaves stored split but used whole
gathered one layer at a time.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.launch.sharding import (
    at_use, batch_sum, seam, split_offset, tp,
)
from repro_torch.models.lm.attention import (
    _kv_for_heads, attn_bidir, attn_cross, attn_cross_cached, attn_decode,
    attn_prefill, attn_train, cross_kv, init_attn, init_cache, seq_part,
)
from repro_torch.models.lm.blocks import _layer, _stack_layers, attn_dims
from repro_torch.models.lm.common import (
    embed_apply, embed_init, init_rms, rms_norm, torch_dtype, unembed_apply,
    unembed_init,
)
from repro_torch.models.lm.config import ModelConfig
from repro_torch.models.lm.mlp import init_mlp, mlp_apply


def _nc(cfg):
    return cfg.row_chunks if cfg.remat in ("rows", "block_rows") else 1


def init_enc_layer(gen, cfg: ModelConfig, stack: int = 0):
    d, pd = cfg.d_model, cfg.param_dtype
    return {"norm1": {"scale": init_rms(d, pd, gen, stack)},
            "attn": init_attn(gen, attn_dims(cfg, "attn"), pd, stack),
            "norm2": {"scale": init_rms(d, pd, gen, stack)},
            "mlp": init_mlp(gen, d, cfg.d_ff, pd, stack)}


def init_dec_layer(gen, cfg: ModelConfig, stack: int = 0):
    d, pd = cfg.d_model, cfg.param_dtype
    return {"norm1": {"scale": init_rms(d, pd, gen, stack)},
            "self_attn": init_attn(gen, attn_dims(cfg, "attn"), pd, stack),
            "norm_x": {"scale": init_rms(d, pd, gen, stack)},
            "cross_attn": init_attn(gen, attn_dims(cfg, "attn"), pd, stack),
            "norm2": {"scale": init_rms(d, pd, gen, stack)},
            "mlp": init_mlp(gen, d, cfg.d_ff, pd, stack)}


def init_encdec(gen: torch.Generator, cfg: ModelConfig):
    """Seeded init on ``gen``'s device (the reference's tree layout)."""
    pd = cfg.param_dtype
    return {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, pd),
        "enc": init_enc_layer(gen, cfg, stack=cfg.n_enc_layers),
        "dec": init_dec_layer(gen, cfg, stack=cfg.n_layers),
        "enc_norm": {"scale": init_rms(cfg.d_model, pd, gen)},
        "final_norm": {"scale": init_rms(cfg.d_model, pd, gen)},
        "unembed": unembed_init(gen, cfg.d_model, cfg.vocab, pd),
    }


def encode(params, frames, cfg: ModelConfig):
    dims = attn_dims(cfg, "attn")
    eps = cfg.norm_eps
    nc = _nc(cfg)
    x = seam(frames, "batch", None, None)
    for i in range(cfg.n_enc_layers):
        lp = at_use(_layer(params["enc"], i))
        h = rms_norm(x, lp["norm1"]["scale"], eps)
        x = x + attn_bidir(lp["attn"], h, dims, nc)
        h = rms_norm(x, lp["norm2"]["scale"], eps)
        x = x + mlp_apply(lp["mlp"], h, nc, cfg.d_ff)
    return rms_norm(x, at_use(params["enc_norm"])["scale"], eps)


def _dec_layer(lp, x, enc_out, cfg: ModelConfig, nc: int):
    dims = attn_dims(cfg, "attn")
    eps = cfg.norm_eps
    h = rms_norm(x, lp["norm1"]["scale"], eps)
    x = x + attn_train(lp["self_attn"], h, dims, nc)
    h = rms_norm(x, lp["norm_x"]["scale"], eps)
    kv = cross_kv(lp["cross_attn"], enc_out, dims)
    x = x + attn_cross(lp["cross_attn"], h, kv, dims)
    h = rms_norm(x, lp["norm2"]["scale"], eps)
    return x + mlp_apply(lp["mlp"], h, nc, cfg.d_ff)


def encdec_forward(params, batch, cfg: ModelConfig):
    """The logits (in a sharded step, this rank's rows of the batch and
    its columns of the vocabulary)."""
    dtype = torch_dtype(cfg.dtype)
    top = {k: at_use(v) for k, v in params.items()
           if k not in ("enc", "dec")}
    enc_out = encode(params, batch["frames"].to(dtype), cfg)
    x = embed_apply(top["embed"], batch["tokens"].long(), dtype, cfg.vocab)
    nc = _nc(cfg)
    for i in range(cfg.n_layers):
        x = _dec_layer(at_use(_layer(params["dec"], i)), x, enc_out, cfg,
                       nc)
    x = rms_norm(x, top["final_norm"]["scale"], cfg.norm_eps)
    return unembed_apply(top["unembed"], x, dtype, cfg.vocab)


def encdec_loss(params, batch, cfg: ModelConfig):
    """Mean next-token CE over labels >= 0.  The whole (B, S, vocab) logits
    are built, in fp32, as in the reference (no chunked head here); a rank
    holding a slice of the vocabulary reduces the log-sum-exp and the
    label's logit over the model group, and the batch group sums the NLL
    and the label count."""
    from repro_torch.exec.collectives import vocab_lse, vocab_pick
    logits = encdec_forward(params, batch, cfg).float()
    labels = batch["labels"].long()
    mask = labels >= 0
    lo = split_offset(logits.shape[-1], cfg.vocab)
    if lo is None:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    else:
        group = tp().group
        nll = vocab_lse(logits, group) \
            - vocab_pick(logits, labels.clamp(min=0), lo, group)
    ce = batch_sum(torch.sum(nll * mask)) \
        / torch.clamp(batch_sum(torch.sum(mask)), min=1)
    return ce, {"ce": ce}


# ---------------------------------------------------------------------------
# Serving: prefill + decode with self-KV cache and precomputed cross-K/V
# ---------------------------------------------------------------------------


def encdec_prefill(params, batch, cfg: ModelConfig, cache_len: int):
    """The frames' encoding and the prompt's decoder pass; returns
    (last-token logits (B, 1, V), caches): the self caches sized for
    ``cache_len`` positions and each layer's cross K/V."""
    dtype = torch_dtype(cfg.dtype)
    dims = attn_dims(cfg, "attn")
    eps = cfg.norm_eps
    nc = _nc(cfg)
    enc_out = encode(params, batch["frames"].to(dtype), cfg)
    top = {k: at_use(v) for k, v in params.items()
           if k not in ("enc", "dec")}
    x = embed_apply(top["embed"], batch["tokens"].long(), dtype, cfg.vocab)
    E = enc_out.shape[1]
    selfs, crosses = [], []
    for i in range(cfg.n_layers):
        lp = at_use(_layer(params["dec"], i))
        h = rms_norm(x, lp["norm1"]["scale"], eps)
        y, cache = attn_prefill(lp["self_attn"], h, dims, cache_len, nc)
        x = x + y
        h = rms_norm(x, lp["norm_x"]["scale"], eps)
        # the cache keeps K/V as projected (in a sharded step the rank's
        # kv heads, or its slice of the positions of every kv head)
        kv = cross_kv(lp["cross_attn"], enc_out, dims, for_heads=False)
        k, v = _kv_for_heads(lp["cross_attn"], kv["k"], kv["v"], dims)
        x = x + attn_cross(lp["cross_attn"], h, {"k": k, "v": v}, dims)
        h = rms_norm(x, lp["norm2"]["scale"], eps)
        x = x + mlp_apply(lp["mlp"], h, nc, cfg.d_ff)
        selfs.append(cache)
        crosses.append({n: seq_part(t, E, dims).contiguous()
                        for n, t in kv.items()})
    x = rms_norm(x[:, -1:], top["final_norm"]["scale"], eps)
    return unembed_apply(top["unembed"], x, dtype, cfg.vocab), \
        {"self": _stack_layers(selfs), "cross": _stack_layers(crosses)}


def encdec_init_caches(cfg: ModelConfig, batch: int, max_len: int,
                       enc_len: int, device=None) -> Dict[str, Any]:
    dtype = torch_dtype(cfg.dtype)
    L = cfg.n_layers
    one_self = init_cache(batch, max_len, cfg.n_kv_heads, cfg.head_dim,
                          dtype, device=device)
    shape = (batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
    one_cross = {"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device)}

    def stack(tree):
        return {k: v.expand((L,) + v.shape).clone() for k, v in tree.items()}
    return {"self": stack(one_self), "cross": stack(one_cross)}


def encdec_decode(params, tokens, caches, cfg: ModelConfig):
    """One-token decode.  tokens: (B, 1) integer.  Returns (logits (B, 1,
    V), caches); the self caches are updated in place and the cross K/V
    pass through."""
    dtype = torch_dtype(cfg.dtype)
    dims = attn_dims(cfg, "attn")
    eps = cfg.norm_eps
    top = {k: at_use(v) for k, v in params.items()
           if k not in ("enc", "dec")}
    x = embed_apply(top["embed"], tokens.long(), dtype, cfg.vocab)
    for i in range(cfg.n_layers):
        lp = at_use(_layer(params["dec"], i))
        view = _layer(caches["self"], i)
        h = rms_norm(x, lp["norm1"]["scale"], eps)
        y, new = attn_decode(lp["self_attn"], h, view, dims)
        for k, t in new.items():
            if t is not view[k]:
                view[k].copy_(t)
        x = x + y
        h = rms_norm(x, lp["norm_x"]["scale"], eps)
        x = x + attn_cross_cached(lp["cross_attn"], h,
                                  _layer(caches["cross"], i), dims)
        h = rms_norm(x, lp["norm2"]["scale"], eps)
        x = x + mlp_apply(lp["mlp"], h, 1, cfg.d_ff)
    x = rms_norm(x, top["final_norm"]["scale"], eps)
    return unembed_apply(top["unembed"], x, dtype, cfg.vocab), caches
