"""Decoder blocks and the layer stack — training, prefill and decode
(counterpart of ``repro.models.lm.blocks``).

Layer kinds (ModelConfig.layer_kinds):
  attn          dense attention + SwiGLU MLP
  local/global  gemma3-style sliding-window / full attention + MLP
  moe           attention + MoE FFN (optional shared experts); its
                training forward returns the router's aux losses
  mamba         Mamba2 mixer only (norm + ssm + residual)
  mlstm/slstm   xLSTM mixers
  shared_attn   zamba2-style attention + MLP block whose parameters are
                SHARED by all its occurrences (held once, under
                ``params["shared"]``, not stacked)

Stacking keeps the reference's parameter tree: per
``ModelConfig.scan_segments()`` segment, a tuple over the pattern's
positions of parameters stacked over the segment's ``count`` layers
(``None`` at a shared position).  Where the reference ``lax.scan``s over a
segment, the port runs one Python loop over its layers and indexes the
stacked tensors, so parameters and optimizer state convert leaf for leaf.
The shared block's gradient is the sum over its occurrences, as autograd
accumulates it.

Decode caches keep the reference's tree too: per segment, a tuple over
the pattern's positions of per-kind caches stacked over the segment's
layers (a shared block has one cache per occurrence).  :func:`stack_decode`
updates that tree in place — each layer's new cache is written back into
its slice of the stacked tensors — and returns it.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.sharding import at_use
from repro_torch.models.lm import rowexec
from repro_torch.models.lm.attention import (
    AttnDims, attn_decode, attn_prefill, attn_train, init_attn, init_cache,
)
from repro_torch.models.lm.common import init_rms, rms_norm, torch_dtype
from repro_torch.models.lm.config import ModelConfig
from repro_torch.models.lm.mlp import init_mlp, mlp_apply
from repro_torch.models.lm.moe import MoEDims, init_moe, moe_apply
from repro_torch.models.lm.ssm import (
    SSMDims, init_ssm, init_ssm_state, ssm_decode, ssm_train,
)
from repro_torch.models.lm.xlstm import (
    XLSTMDims, init_mlstm, init_mlstm_state, init_slstm, init_slstm_state,
    mlstm_decode, mlstm_train, slstm_decode, slstm_train,
)

ATTN_KINDS = ("attn", "local", "global", "shared_attn", "moe")
RECURRENT_KINDS = ("mamba", "mlstm", "slstm")


def _check_kind(kind: str) -> None:
    if kind not in ATTN_KINDS + RECURRENT_KINDS:
        raise ValueError(f"unknown layer kind {kind!r}; known: "
                         f"{ATTN_KINDS + RECURRENT_KINDS}")


def zero_aux(device) -> Dict[str, torch.Tensor]:
    return {"load_balance": torch.zeros((), device=device),
            "z_loss": torch.zeros((), device=device)}


def attn_dims(cfg: ModelConfig, kind: str) -> AttnDims:
    return AttnDims(
        d=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.head_dim, qkv_bias=cfg.qkv_bias,
        rope_theta=cfg.rope_theta,
        window=cfg.sliding_window if kind == "local" else 0)


def ssm_dims(cfg: ModelConfig) -> SSMDims:
    inner = cfg.ssm_expand * cfg.d_model
    heads = cfg.ssm_heads or cfg.n_heads
    return SSMDims(d=cfg.d_model, n_heads=heads, head_p=inner // heads,
                   state_n=cfg.ssm_state or 64, conv_k=cfg.conv_k)


def xlstm_dims(cfg: ModelConfig) -> XLSTMDims:
    return XLSTMDims(d=cfg.d_model, n_heads=cfg.n_heads,
                     expand=cfg.ssm_expand)


def moe_dims(cfg: ModelConfig) -> MoEDims:
    return MoEDims(d=cfg.d_model, d_expert=cfg.d_expert,
                   n_experts=cfg.n_experts, top_k=cfg.top_k,
                   n_shared=cfg.n_shared_experts,
                   capacity_factor=cfg.capacity_factor,
                   seq_groups=cfg.moe_seq_groups)


_RECURRENT = {"mamba": (init_ssm, ssm_train, ssm_dims),
              "mlstm": (init_mlstm, mlstm_train, xlstm_dims),
              "slstm": (init_slstm, slstm_train, xlstm_dims)}
_DECODE = {"mamba": ssm_decode, "mlstm": mlstm_decode,
           "slstm": slstm_decode}


def init_block(gen, kind: str, cfg: ModelConfig, stack: int = 0):
    """One block's parameters, with a leading axis of ``stack`` layers
    when given (the reference's ``vmap``-ed init)."""
    _check_kind(kind)
    pd, d = cfg.param_dtype, cfg.d_model
    if kind in RECURRENT_KINDS:
        init, _, dims = _RECURRENT[kind]
        return {"norm1": {"scale": init_rms(d, pd, gen, stack)},
                "ssm": init(gen, dims(cfg), pd, stack)}
    p = {
        "norm1": {"scale": init_rms(d, pd, gen, stack)},
        "attn": init_attn(gen, attn_dims(cfg, kind), pd, stack),
        "norm2": {"scale": init_rms(d, pd, gen, stack)},
    }
    if kind == "moe":
        p["moe"] = init_moe(gen, moe_dims(cfg), pd, stack)
    else:
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, pd, stack)
    return p


def _ffn(params, h, kind: str, cfg: ModelConfig, nc: int):
    """The block's feed-forward half: (y, aux or None)."""
    if kind == "moe":
        return moe_apply(params["moe"], h, moe_dims(cfg), nc)
    return mlp_apply(params["mlp"], h, nc, cfg.d_ff), None


def block_train(params, x, kind: str, cfg: ModelConfig):
    """Returns (x, aux).  In a sharded step the leaves stored split but
    used whole are gathered here, one layer at a time (and again when a
    checkpointed block recomputes)."""
    _check_kind(kind)
    params = at_use(params)
    eps = cfg.norm_eps
    h = rms_norm(x, params["norm1"]["scale"], eps)
    if kind in RECURRENT_KINDS:
        _, train, dims = _RECURRENT[kind]
        return x + train(params["ssm"], h, dims(cfg)), zero_aux(x.device)
    nc = cfg.row_chunks if cfg.remat in ("rows", "block_rows") else 1
    x = x + attn_train(params["attn"], h, attn_dims(cfg, kind), nc)
    h = rms_norm(x, params["norm2"]["scale"], eps)
    y, aux = _ffn(params, h, kind, cfg, nc)
    return x + y, aux if aux is not None else zero_aux(x.device)


def init_block_cache(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                     dtype, device=None):
    """One block's decode cache for ``batch`` rows (``dtype``: a torch
    dtype or its name; recurrent states other than Mamba's conv inputs
    are fp32)."""
    _check_kind(kind)
    dt = torch_dtype(dtype) if isinstance(dtype, str) else dtype
    if kind == "local":
        return init_cache(batch, min(cfg.sliding_window, max_len),
                          cfg.n_kv_heads, cfg.head_dim, dt, ring=True,
                          device=device)
    if kind in ATTN_KINDS:
        return init_cache(batch, max_len, cfg.n_kv_heads, cfg.head_dim, dt,
                          device=device)
    if kind == "mamba":
        return init_ssm_state(batch, ssm_dims(cfg), dt, device=device)
    if kind == "mlstm":
        return init_mlstm_state(batch, xlstm_dims(cfg), device=device)
    return init_slstm_state(batch, cfg.d_model, device=device)


def block_decode(params, x, cache, kind: str, cfg: ModelConfig):
    """One-token step.  Returns (x, new_cache)."""
    _check_kind(kind)
    eps = cfg.norm_eps
    h = rms_norm(x, params["norm1"]["scale"], eps)
    if kind in RECURRENT_KINDS:
        _, _, dims = _RECURRENT[kind]
        y, cache = _DECODE[kind](params["ssm"], h, cache, dims(cfg))
        return x + y, cache
    y, cache = attn_decode(params["attn"], h, cache, attn_dims(cfg, kind))
    x = x + y
    h = rms_norm(x, params["norm2"]["scale"], eps)
    return x + _ffn(params, h, kind, cfg, 1)[0], cache


def block_prefill(params, x, kind: str, cfg: ModelConfig, cache_len: int,
                  dtype=None):
    """Full-sequence forward returning (x, cache) for the decode that
    follows (``dtype`` is the reference's argument, unused there too)."""
    _check_kind(kind)
    eps = cfg.norm_eps
    nc = cfg.row_chunks if cfg.remat in ("rows", "block_rows") else 1
    h = rms_norm(x, params["norm1"]["scale"], eps)
    if kind in RECURRENT_KINDS:
        _, train, dims = _RECURRENT[kind]
        y, cache = train(params["ssm"], h, dims(cfg), return_state=True)
        return x + y, cache
    clen = min(cfg.sliding_window, cache_len) if kind == "local" \
        else cache_len
    y, cache = attn_prefill(params["attn"], h, attn_dims(cfg, kind), clen,
                            nc, ring=(kind == "local"))
    x = x + y
    h = rms_norm(x, params["norm2"]["scale"], eps)
    return x + _ffn(params, h, kind, cfg, nc)[0], cache


def init_stack(gen, cfg: ModelConfig):
    """Params: ``{"segments": [per-segment tuple over pattern positions of
    stacked params, None at a shared_attn position], "shared": the
    shared_attn block's params or None}``."""
    segs = cfg.scan_segments()
    shared = None
    if any("shared_attn" in pat for pat, _ in segs):
        shared = init_block(gen, "shared_attn", cfg)
    segments = []
    for pat, count in segs:
        segments.append(tuple(
            None if kind == "shared_attn"
            else init_block(gen, kind, cfg, stack=count) for kind in pat))
    return {"segments": segments, "shared": shared}


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def stack_train(params, x, cfg: ModelConfig):
    """Every layer in order; returns (x, aux).  Block-level remat
    (``block``/``block_rows``, the paper's checkpointing hybrid) runs each
    block under ``torch.utils.checkpoint``, re-entering the active plan
    for the recomputation in backward."""
    aux = zero_aux(x.device)
    block_remat = cfg.remat in ("block", "block_rows")
    plan = rowexec.current_plan()
    for (pat, count), seg in zip(cfg.scan_segments(), params["segments"]):
        for i in range(count):
            for j, kind in enumerate(pat):
                p = params["shared"] if kind == "shared_attn" \
                    else _layer(seg[j], i)
                if block_remat:
                    def run(p, x, kind=kind):
                        with rowexec.use_plan(plan):
                            return block_train(p, x, kind, cfg)
                    x, a2 = checkpoint(run, p, x, use_reentrant=False)
                else:
                    x, a2 = block_train(p, x, kind, cfg)
                aux = {k: aux[k] + a2[k] for k in aux}
    return x, aux


def _stack_layers(caches):
    """Per-layer cache dicts -> one dict of tensors stacked over layers."""
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def init_stack_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      device=None):
    caches = []
    for pat, count in cfg.scan_segments():
        group = []
        for kind in pat:
            c = init_block_cache(kind, cfg, batch, max_len, dtype, device)
            group.append({k: v.expand((count,) + v.shape).clone()
                          for k, v in c.items()})
        caches.append(tuple(group))
    return caches


def stack_decode(params, x, caches, cfg: ModelConfig):
    """One token through every layer.  ``caches`` is updated in place
    (each layer's new cache copied into its stacked slice, unless the
    layer already wrote there) and returned."""
    for (pat, count), seg, cgroup in zip(cfg.scan_segments(),
                                         params["segments"], caches):
        for i in range(count):
            for j, kind in enumerate(pat):
                p = params["shared"] if kind == "shared_attn" \
                    else _layer(seg[j], i)
                view = _layer(cgroup[j], i)
                x, new = block_decode(p, x, view, kind, cfg)
                for k, t in new.items():
                    if t is not view[k]:
                        view[k].copy_(t)
    return x, caches


def stack_prefill(params, x, cfg: ModelConfig, cache_len: int, dtype=None):
    caches = []
    for (pat, count), seg in zip(cfg.scan_segments(), params["segments"]):
        per_layer = [[] for _ in pat]
        for i in range(count):
            for j, kind in enumerate(pat):
                p = params["shared"] if kind == "shared_attn" \
                    else _layer(seg[j], i)
                x, c = block_prefill(p, x, kind, cfg, cache_len, dtype)
                per_layer[j].append(c)
        caches.append(tuple(_stack_layers(cs) for cs in per_layer))
    return x, caches
