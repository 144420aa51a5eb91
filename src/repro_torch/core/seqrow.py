"""Row-centric execution transplanted to sequence models (counterpart of
``repro.core.seqrow``; only :func:`chunked_apply` is ported so far).

For sequence models LR-CNN's spatial axis is the sequence axis.  Per-token
layers (MLP, norms) have halo 0: :func:`chunked_apply` runs them chunk by
chunk with per-chunk recomputation, so BP recomputes one chunk at a time —
the BP half of Alg. 1.  The sliding-window halo loop lives in
``models/lm/attention.py::attn_train``; the carried-scan helpers wait for
the SSM/xLSTM slice.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint


def chunked_apply(fn: Callable, x, n_chunks: int, axis: int = 1):
    """Apply a per-token ``fn`` over ``n_chunks`` sequence chunks, each
    under ``torch.utils.checkpoint`` (the reference's
    ``lax.map(jax.checkpoint(fn))``).

    Equal to ``fn(x)`` for any fn that acts independently per position
    along ``axis``; the live hidden inside fn drops by ~n_chunks (Eq. 7
    with halo 0).  Falls back to ``fn(x)`` when ``n_chunks`` does not
    divide the axis, as the reference does."""
    if n_chunks <= 1 or x.shape[axis] % n_chunks:
        return fn(x)
    chunks = torch.chunk(x, n_chunks, dim=axis)
    return torch.cat([checkpoint(fn, c, use_reentrant=False)
                      for c in chunks], dim=axis)
