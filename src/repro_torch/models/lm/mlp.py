"""SwiGLU MLP with row-centric sequence chunking, the halo-0 exact case
(counterpart of ``repro.models.lm.mlp``)."""

from __future__ import annotations

import torch.nn.functional as F

from repro_torch.core.seqrow import chunked_apply
from repro_torch.models.lm.common import dense_init


def init_mlp(gen, d, ff, param_dtype, stack: int = 0):
    return {
        "w_gate": dense_init(gen, (d, ff), param_dtype, stack=stack),
        "w_up": dense_init(gen, (d, ff), param_dtype, stack=stack),
        "w_down": dense_init(gen, (ff, d), param_dtype, stack=stack),
    }


def _mlp(params, x):
    dt = x.dtype
    h = F.silu(x @ params["w_gate"].to(dt)) * (x @ params["w_up"].to(dt))
    return h @ params["w_down"].to(dt)


def mlp_apply(params, x, n_chunks: int = 1):
    """Per token, so row partitioning along the sequence is exact (halo
    0); ``n_chunks > 1`` bounds the live (B, S, ff) hidden to (B, S/n,
    ff)."""
    return chunked_apply(lambda xc: _mlp(params, xc), x, n_chunks)
