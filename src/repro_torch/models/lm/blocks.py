"""Decoder blocks and the layer stack (counterpart of
``repro.models.lm.blocks``; ported kinds ``attn``, ``local`` and
``global``).

Layer kinds (ModelConfig.layer_kinds):
  attn          dense attention + SwiGLU MLP
  local/global  gemma3-style sliding-window / full attention + MLP
The reference's ``moe``, ``mamba``, ``mlstm``, ``slstm`` and
``shared_attn`` kinds raise "not ported yet".

Stacking keeps the reference's parameter tree: per
``ModelConfig.scan_segments()`` segment, a tuple over the pattern's
positions of parameters stacked over the segment's ``count`` layers.
Where the reference ``lax.scan``s over a segment, the port runs one Python
loop over its layers and indexes the stacked tensors, so parameters and
optimizer state convert leaf for leaf.
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

ATTN_KINDS = ("attn", "local", "global")


def _check_kind(kind: str) -> None:
    if kind not in ATTN_KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet; ported: {ATTN_KINDS}")


def zero_aux(device) -> Dict[str, torch.Tensor]:
    return {"load_balance": torch.zeros((), device=device),
            "z_loss": torch.zeros((), device=device)}


def attn_dims(cfg: ModelConfig, kind: str) -> AttnDims:
    return AttnDims(
        d=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.head_dim, qkv_bias=cfg.qkv_bias,
        rope_theta=cfg.rope_theta,
        window=cfg.sliding_window if kind == "local" else 0)


def init_block(gen, kind: str, cfg: ModelConfig, stack: int = 0):
    """One block's parameters, with a leading axis of ``stack`` layers
    when given (the reference's ``vmap``-ed init)."""
    _check_kind(kind)
    pd, d = cfg.param_dtype, cfg.d_model
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
    nc = cfg.row_chunks if cfg.remat in ("rows", "block_rows") else 1
    h = rms_norm(x, params["norm1"]["scale"], eps)
    x = x + attn_train(params["attn"], h, attn_dims(cfg, kind), nc)
    h = rms_norm(x, params["norm2"]["scale"], eps)
    return x + mlp_apply(params["mlp"], h, nc), zero_aux(x.device)


def init_stack(gen, cfg: ModelConfig):
    """Params: ``{"segments": [per-segment tuple over pattern positions of
    stacked params], "shared": None}``."""
    segments = []
    for pat, count in cfg.scan_segments():
        segments.append(tuple(init_block(gen, kind, cfg, stack=count)
                              for kind in pat))
    return {"segments": segments, "shared": None}


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
                p = _layer(seg[j], i)
                if block_remat:
                    def run(p, x, kind=kind):
                        with rowexec.use_plan(plan):
                            return block_train(p, x, kind, cfg)
                    x, a2 = checkpoint(run, p, x, use_reentrant=False)
                else:
                    x, a2 = block_train(p, x, kind, cfg)
                aux = {k: aux[k] + a2[k] for k in aux}
    return x, aux
