"""Decoder blocks and the layer stack (counterpart of
``repro.models.lm.blocks``; the training half).

Layer kinds (ModelConfig.layer_kinds):
  attn          dense attention + SwiGLU MLP
  local/global  gemma3-style sliding-window / full attention + MLP
  mamba         Mamba2 mixer only (norm + ssm + residual)
  mlstm/slstm   xLSTM mixers
  shared_attn   zamba2-style attention + MLP block whose parameters are
                SHARED by all its occurrences (held once, under
                ``params["shared"]``, not stacked)
The reference's ``moe`` kind raises "not ported yet".

Stacking keeps the reference's parameter tree: per
``ModelConfig.scan_segments()`` segment, a tuple over the pattern's
positions of parameters stacked over the segment's ``count`` layers
(``None`` at a shared position).  Where the reference ``lax.scan``s over a
segment, the port runs one Python loop over its layers and indexes the
stacked tensors, so parameters and optimizer state convert leaf for leaf.
The shared block's gradient is the sum over its occurrences, as autograd
accumulates it.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.lm import rowexec
from repro_torch.models.lm.attention import AttnDims, attn_train, init_attn
from repro_torch.models.lm.common import init_rms, rms_norm
from repro_torch.models.lm.config import ModelConfig
from repro_torch.models.lm.mlp import init_mlp, mlp_apply
from repro_torch.models.lm.ssm import SSMDims, init_ssm, ssm_train
from repro_torch.models.lm.xlstm import (
    XLSTMDims, init_mlstm, init_slstm, mlstm_train, slstm_train,
)

ATTN_KINDS = ("attn", "local", "global", "shared_attn")
RECURRENT_KINDS = ("mamba", "mlstm", "slstm")


def _check_kind(kind: str) -> None:
    if kind not in ATTN_KINDS + RECURRENT_KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet; ported: "
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


_RECURRENT = {"mamba": (init_ssm, ssm_train, ssm_dims),
              "mlstm": (init_mlstm, mlstm_train, xlstm_dims),
              "slstm": (init_slstm, slstm_train, xlstm_dims)}


def init_block(gen, kind: str, cfg: ModelConfig, stack: int = 0):
    """One block's parameters, with a leading axis of ``stack`` layers
    when given (the reference's ``vmap``-ed init)."""
    _check_kind(kind)
    pd, d = cfg.param_dtype, cfg.d_model
    if kind in RECURRENT_KINDS:
        init, _, dims = _RECURRENT[kind]
        return {"norm1": {"scale": init_rms(d, pd, gen, stack)},
                "ssm": init(gen, dims(cfg), pd, stack)}
    return {
        "norm1": {"scale": init_rms(d, pd, gen, stack)},
        "attn": init_attn(gen, attn_dims(cfg, kind), pd, stack),
        "norm2": {"scale": init_rms(d, pd, gen, stack)},
        "mlp": init_mlp(gen, d, cfg.d_ff, pd, stack),
    }


def block_train(params, x, kind: str, cfg: ModelConfig):
    """Returns (x, aux)."""
    _check_kind(kind)
    eps = cfg.norm_eps
    h = rms_norm(x, params["norm1"]["scale"], eps)
    if kind in RECURRENT_KINDS:
        _, train, dims = _RECURRENT[kind]
        return x + train(params["ssm"], h, dims(cfg)), zero_aux(x.device)
    nc = cfg.row_chunks if cfg.remat in ("rows", "block_rows") else 1
    x = x + attn_train(params["attn"], h, attn_dims(cfg, kind), nc)
    h = rms_norm(x, params["norm2"]["scale"], eps)
    return x + mlp_apply(params["mlp"], h, nc), zero_aux(x.device)


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
