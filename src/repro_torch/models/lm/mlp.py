"""SwiGLU MLP with row-centric sequence chunking, the halo-0 exact case
(counterpart of ``repro.models.lm.mlp``).

In a sharded step a rank holding its slice of the ff axis runs Megatron's
pair: ``w_gate``/``w_up`` column-parallel (the input enters through
:func:`~repro_torch.launch.sharding.enter`), ``w_down`` row-parallel, its
partial sums taken in fp32 and summed over the model group before the one
rounding to the activation dtype.
"""

from __future__ import annotations

import torch.nn.functional as F

from repro_torch.core.seqrow import chunked_apply
from repro_torch.launch.sharding import enter, seam, split_offset
from repro_torch.models.lm.common import dense_init


def init_mlp(gen, d, ff, param_dtype, stack: int = 0):
    return {
        "w_gate": dense_init(gen, (d, ff), param_dtype, stack=stack),
        "w_up": dense_init(gen, (d, ff), param_dtype, stack=stack),
        "w_down": dense_init(gen, (ff, d), param_dtype, stack=stack),
    }


def _mlp(params, x, ff: int = 0):
    dt = x.dtype
    split = split_offset(params["w_gate"].shape[-1],
                         ff or params["w_gate"].shape[-1]) is not None
    if split:
        x = enter(x)
    h = F.silu(x @ params["w_gate"].to(dt)) * (x @ params["w_up"].to(dt))
    h = seam(h, "batch", None, "tp")
    if not split:
        return seam(h @ params["w_down"].to(dt), "batch", None, None)
    y = h.float() @ params["w_down"].to(dt).float()
    return seam(y, "batch", None, None, partial=True).to(dt)


def mlp_apply(params, x, n_chunks: int = 1, ff: int = 0):
    """Per token, so row partitioning along the sequence is exact (halo
    0); ``n_chunks > 1`` bounds the live (B, S, ff) hidden to (B, S/n,
    ff).  ``ff`` is the layer's global width: ``w_gate`` narrower than it
    is this rank's slice."""
    return chunked_apply(lambda xc: _mlp(params, xc, ff), x, n_chunks)
