"""GQA attention with RoPE, optional QKV bias, sliding-window masking,
row-centric query chunking, and KV caches (full and ring-buffer) for
prefill and decode, and the encoder-decoder's bidirectional and cross
attention (counterpart of ``repro.models.lm.attention``; the cache
placements are :func:`repro_torch.launch.steps.cache_sharding`).

Row-centric notes: full causal attention has a *strong* dependency along
the sequence, but its score matrix is still the dominant live activation
in training, so the query axis is chunked with per-chunk recomputation —
each chunk's (B, H, c, S) score block is built, consumed and released.
Sliding-window ("local") layers have a genuinely weak dependency: a query
chunk ``[a, a + c)`` reads only the replicated halo ``[a - window, a + c)``
of K/V (OverL).  A plan that kernelized to ``seq_swa_cuda`` swaps that loop
for the engine's op (the hand-written CUDA kernel on the card).

Decode caches keep the reference's tree, ``{"k", "v", "pos", "ring"}``:
``pos`` is each row's absolute next position and ``ring`` a boolean
scalar marking a sliding-window ring buffer (position p lives at slot
``p % cache_len``).  :func:`attn_decode` writes the new token's K/V into
the cache tensors in place (``index_put_``), where the reference's
``.at[].set`` returns an updated copy; ``pos`` is returned as a new
tensor, so a caller that reads the pre-step positions still can.

In a sharded step (train, prefill and cross attention) a rank holding its
slice of the heads computes them column-parallel in :func:`_qkv` and the
output projection row-parallel in :func:`_proj_out` (fp32 partial sums,
summed over the model group, then one rounding).  GQA keeps q head *h*
with kv head *h*·KV/H on the same rank: the rank's kv heads when ``wk``
is split with ``wq``, else (``wk`` gathered whole, its heads not divisible
by the model extent) the kv heads its q heads read, taken from the whole
K/V, whose gradient the group then sums (:func:`_kv_for_heads`).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.sharding import (
    enter, kv_lens, kv_seq_split, seam, split_offset,
)
from repro_torch.models.lm import rowexec
from repro_torch.models.lm.common import dense_init, rope, torch_dtype

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnDims:
    d: int
    n_heads: int
    n_kv: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    window: int = 0  # 0 = full causal


def init_attn(gen, dims: AttnDims, param_dtype, stack: int = 0):
    d, H, KV, hd = dims.d, dims.n_heads, dims.n_kv, dims.head_dim
    p = {
        "wq": dense_init(gen, (d, H, hd), param_dtype, stack=stack),
        "wk": dense_init(gen, (d, KV, hd), param_dtype, stack=stack),
        "wv": dense_init(gen, (d, KV, hd), param_dtype, stack=stack),
        "wo": dense_init(gen, (H, hd, d), param_dtype, stack=stack),
    }
    if dims.qkv_bias:
        lead = (stack,) if stack else ()
        for name, heads in (("bq", H), ("bk", KV), ("bv", KV)):
            p[name] = torch.zeros(lead + (heads, hd), device=gen.device,
                                  dtype=torch_dtype(param_dtype))
    return p


def _q_offset(params, dims: AttnDims):
    """Where this rank's q heads start when they are split, else None."""
    return split_offset(params["wq"].shape[-2], dims.n_heads)


def _kv_for_heads(params, k, v, dims: AttnDims):
    """K/V for this rank's q heads.  Split with them, or one device: as
    they are.  Computed whole (``wk`` gathered): the kv head of each local
    q head, repeated, so the grouping is one kv head a q head; the whole
    K/V enters the split region through ``enter``, so its gradient sums
    the ranks' parts."""
    lo = _q_offset(params, dims)
    if lo is None or k.shape[2] != dims.n_kv:
        return k, v
    hl = params["wq"].shape[-2]
    idx = torch.div(torch.arange(lo, lo + hl, device=k.device),
                    dims.n_heads // dims.n_kv, rounding_mode="floor")
    return (enter(k).index_select(2, idx), enter(v).index_select(2, idx))


def _qkv(params, x, dims: AttnDims, positions, for_heads: bool = True):
    """q, k, v of ``x``; ``for_heads=False`` keeps K/V as the projection
    gives them (a cache stores them so), without :func:`_kv_for_heads`."""
    dt = x.dtype
    xq = enter(x) if _q_offset(params, dims) is not None else x
    xk = xq if params["wk"].shape[-2] != dims.n_kv else x
    q = torch.einsum("bsd,dhk->bshk", xq, params["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", xk, params["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", xk, params["wv"].to(dt))
    if dims.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    q = rope(q, positions, dims.rope_theta)
    k = rope(k, positions, dims.rope_theta)
    q = seam(q, "batch", None, "tp", None)
    k = seam(k, "batch", None, "tp", None)
    v = seam(v, "batch", None, "tp", None)
    if for_heads:
        k, v = _kv_for_heads(params, k, v, dims)
    return q, k, v


def _scores_mask(q_pos, k_pos, window: int, causal: bool = True):
    """(Sq, Sk) causal (+ window) mask of additive NEG_INF, fp32; all
    zeros when not ``causal``."""
    if not causal:
        return torch.zeros((q_pos.shape[0], k_pos.shape[0]),
                           device=q_pos.device)
    ok = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    return torch.where(ok, 0.0, NEG_INF).float()


def _attend(q, k, v, q_pos, k_pos, window: int, n_q_per_kv: int,
            causal: bool = True):
    """q: (B,Sq,Hq,D), k/v: (B,Sk,KV,D) -> (B,Sq,Hq,D)."""
    B, Sq, Hq, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, n_q_per_kv, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) / math.sqrt(D)
    scores = scores + _scores_mask(q_pos, k_pos, window, causal)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def _proj_out(params, attn_out, dims: AttnDims):
    dt = attn_out.dtype
    wo = params["wo"]
    if _q_offset(params, dims) is None:
        y = torch.einsum("bshk,hkd->bsd", attn_out, wo.to(dt))
        return seam(y, "batch", None, None)
    # row-parallel (``wo`` splits its heads with ``wq``): this rank's
    # heads' share of the output, in fp32
    y = torch.einsum("bshk,hkd->bsd", attn_out.float(), wo.to(dt).float())
    return seam(y, "batch", None, None, partial=True).to(dt)


def attn_train(params, x, dims: AttnDims, n_chunks: int = 1):
    """Training forward over a full sequence, query-chunked.

    Sliding-window layers consult the active plan
    (:func:`repro_torch.models.lm.rowexec.swa_kernel`): a ``seq_swa_cuda``
    plan swaps the halo chunk loop below for the engine's op (GQA handled
    by repeating KV heads, value-identical); other plans keep the loop,
    which IS the ``seq_swa_overlap`` row lowering.  Each chunk of the loop
    runs under ``torch.utils.checkpoint``, as the reference wraps it in
    ``jax.checkpoint``."""
    B, S, _ = x.shape
    k_pos = torch.arange(S, device=x.device)
    positions = k_pos.expand(B, S)
    q, k, v = _qkv(params, x, dims, positions)
    g = q.shape[2] // k.shape[2]
    kernel = rowexec.swa_kernel(dims.window) if dims.window > 0 else None
    if kernel is not None:
        kk = k.repeat_interleave(g, dim=2) if g > 1 else k
        vv = v.repeat_interleave(g, dim=2) if g > 1 else v
        out = kernel(q, kk, vv).to(q.dtype)
    elif n_chunks <= 1 or S % n_chunks:
        out = _attend(q, k, v, k_pos, k_pos, dims.window, g)
    else:
        c = S // n_chunks
        outs = []
        for i in range(n_chunks):
            a = i * c
            # OverL halo: only [a - window, a + c) keys can be attended;
            # causal: keys [0, a + c)
            lo = max(0, a - dims.window) if dims.window > 0 else 0
            outs.append(checkpoint(
                _attend, q[:, a:a + c], k[:, lo:a + c], v[:, lo:a + c],
                k_pos[a:a + c], k_pos[lo:a + c], dims.window, g,
                use_reentrant=False))
        out = torch.cat(outs, dim=1)
    return _proj_out(params, out, dims)


def attn_bidir(params, x, dims: AttnDims, n_chunks: int = 1):
    """Bidirectional self-attention (encoder side), query-chunked; each
    query chunk attends to every key under ``torch.utils.checkpoint``."""
    B, S, _ = x.shape
    k_pos = torch.arange(S, device=x.device)
    q, k, v = _qkv(params, x, dims, k_pos.expand(B, S))
    g = q.shape[2] // k.shape[2]
    if n_chunks <= 1 or S % n_chunks:
        out = _attend(q, k, v, k_pos, k_pos, 0, g, causal=False)
    else:
        c = S // n_chunks
        out = torch.cat([checkpoint(
            _attend, q[:, a:a + c], k, v, k_pos[a:a + c], k_pos, 0, g,
            False, use_reentrant=False) for a in range(0, S, c)], dim=1)
    return _proj_out(params, out, dims)


def cross_kv(params, y, dims: AttnDims, for_heads: bool = True):
    """Encoder-side K/V for cross-attention (no RoPE); in a sharded step,
    those of this rank's q heads (``for_heads=False``: as the projection
    gives them, which a cache stores)."""
    dt = y.dtype
    if params["wk"].shape[-2] != dims.n_kv:
        y = enter(y)
    k = torch.einsum("bsd,dhk->bshk", y, params["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", y, params["wv"].to(dt))
    if dims.qkv_bias:
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    k = seam(k, "batch", None, "tp", None)
    v = seam(v, "batch", None, "tp", None)
    if for_heads:
        k, v = _kv_for_heads(params, k, v, dims)
    return {"k": k, "v": v}


def attn_cross(params, x, kv, dims: AttnDims):
    """Cross-attention of decoder states over precomputed encoder K/V
    (no RoPE, no mask)."""
    dt = x.dtype
    if _q_offset(params, dims) is not None:
        x = enter(x)
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    if dims.qkv_bias:
        q = q + params["bq"].to(dt)
    q = seam(q, "batch", None, "tp", None)
    out = _attend(q, kv["k"], kv["v"],
                  torch.arange(x.shape[1], device=x.device),
                  torch.arange(kv["k"].shape[1], device=x.device),
                  0, q.shape[2] // kv["k"].shape[2], causal=False)
    return _proj_out(params, out, dims)


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------


#: the dims of a cache leaf :func:`attn_decode` and
#: :func:`attn_cross_cached` compute on while a sharded step splits them
#: (logical names of :func:`repro_torch.launch.steps.cache_sharding`):
#: K/V by kv heads, or by positions (:func:`kv_seq_split`)
CACHE_SPLIT = {"k": ("seq", "tp"), "v": ("seq", "tp")}


def init_cache(batch, max_len, n_kv, head_dim, dtype, ring: bool = False,
               device=None):
    """Cache tree; ``ring=True`` -> sliding-window ring buffer.  ``dtype``
    is a torch dtype or its name."""
    dt = torch_dtype(dtype) if isinstance(dtype, str) else dtype
    return {
        "k": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dt,
                         device=device),
        "v": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dt,
                         device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        "ring": torch.tensor(ring, device=device),
    }


def _decode_len(dims: AttnDims) -> int:
    """The global length of a decode step's self-attention cache: the
    ring window of a sliding-window layer, else the step's cache length."""
    max_len = kv_lens()[0]
    return min(dims.window, max_len) if dims.window > 0 else max_len


def _attend_split(q, k, v, valid, group, dims: AttnDims):
    """One query position over a KV cache whose positions are split over
    ``group``: q (B, 1, H, D) for every head, k/v (B, L_local, KV, D),
    ``valid`` (B, L_local) or None.  Each rank scores its positions; the
    softmax is combined as :func:`~repro_torch.exec.collectives.vocab_lse`
    combines a split log-sum-exp (the global max, then the sum of the
    shifted exponentials), and the weighted values are summed over the
    group in fp32.  Returns (B, 1, H, D) in fp32."""
    import torch.distributed as dist

    from repro_torch.exec.collectives import all_reduce_
    B, _, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, 1, KV, H // KV, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) / math.sqrt(dims.head_dim)
    if valid is not None:
        scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    m = all_reduce_(scores.max(dim=-1).values, group, dist.ReduceOp.MAX)
    e = torch.exp(scores - m[..., None])
    den = all_reduce_(e.sum(dim=-1), group)
    num = all_reduce_(torch.einsum("bhgqk,bkhd->bqhgd", e, v.float()),
                      group)
    out = num / den.permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, 1, H, D)


def _all_heads(params, q, dims: AttnDims):
    """q of every head: the model group's heads gathered when this rank
    holds a slice of them."""
    if _q_offset(params, dims) is None:
        return q
    from repro_torch.launch.sharding import tp_gather
    return tp_gather(q, 2)


def _own_heads(params, out, dims: AttnDims):
    """This rank's q heads of an every-head output (all of them on one
    device or when the heads are not split)."""
    lo = _q_offset(params, dims)
    if lo is None:
        return out
    return out.narrow(2, lo, params["wq"].shape[-2])


def attn_decode(params, x, cache, dims: AttnDims):
    """One-token decode step.  x: (B, 1, d).  Returns (y, new_cache); the
    new K/V row is written into ``cache["k"]``/``cache["v"]`` in place.
    Scores and softmax are fp32 whatever the cache dtype.

    In a sharded step the cache holds this rank's kv heads (split with
    ``wk``), or every kv head: whole on every rank of the model group
    (each writes the new row, and its q heads read their kv heads), or
    split along its positions (:func:`kv_seq_split`, the reference's
    ``_kv_fallback``): then only the rank that holds the written slot
    writes it, the mask is built from global positions, and every head's
    query attends its rank's positions, combined over the group
    (:func:`_attend_split`)."""
    B = x.shape[0]
    L = cache["k"].shape[1]
    pos = cache["pos"]  # (B,)
    q, k_new, v_new = _qkv(params, x, dims, pos[:, None], for_heads=False)
    split = kv_seq_split(cache["k"].shape[2] == dims.n_kv,
                         _decode_len(dims))
    lo, max_len = (split.rank * L, L * split.size) if split is not None \
        else (0, L)

    ring = cache["ring"]
    slot = torch.where(ring, torch.remainder(pos, max_len),
                       pos.clamp(max=max_len - 1))
    bidx = torch.arange(B, device=x.device)
    k, v = cache["k"], cache["v"]
    if split is None:
        k.index_put_((bidx, slot.long()), k_new[:, 0].to(k.dtype))
        v.index_put_((bidx, slot.long()), v_new[:, 0].to(v.dtype))
    else:  # only the holder of the slot writes it
        mine = (slot >= lo) & (slot < lo + L)
        rows, at = bidx[mine], (slot[mine] - lo).long()
        k.index_put_((rows, at), k_new[mine, 0].to(k.dtype))
        v.index_put_((rows, at), v_new[mine, 0].to(v.dtype))
    k = seam(k, "batch", None, "tp", None)
    v = seam(v, "batch", None, "tp", None)

    # absolute positions held in each cache slot; ring: slot i holds
    # position p - ((slot - i) mod max_len), a floor modulo
    idx = torch.arange(lo, lo + L, dtype=torch.int32, device=x.device)
    abs_pos = torch.where(
        ring, pos[:, None] - torch.remainder(slot[:, None] - idx[None, :],
                                             max_len),
        idx[None, :])
    valid = (abs_pos >= 0) & (abs_pos <= pos[:, None])
    if dims.window > 0:
        valid &= abs_pos > (pos[:, None] - dims.window)

    if split is not None:
        out = _attend_split(_all_heads(params, q, dims), k, v, valid,
                            split.group, dims)
        out = _own_heads(params, out, dims).to(x.dtype)
    else:
        ka, va = _kv_for_heads(params, k, v, dims)
        KV = ka.shape[2]
        qg = q.reshape(B, 1, KV, q.shape[2] // KV, -1)
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                              ka.float()) / math.sqrt(dims.head_dim)
        scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, va.float())
        out = out.reshape(B, 1, q.shape[2], dims.head_dim).to(x.dtype)
    y = _proj_out(params, out, dims)
    return y, {"k": k, "v": v, "pos": pos + 1, "ring": ring}


def attn_cross_cached(params, x, kv, dims: AttnDims):
    """Cross-attention of one decoding position over a cache's encoder
    K/V (``kv`` as :func:`cross_kv` gives it with ``for_heads=False``): on
    one device :func:`attn_cross`; in a sharded step also over a cache
    split along its positions (:func:`_attend_split`)."""
    split = kv_seq_split(kv["k"].shape[2] == dims.n_kv, kv_lens()[1])
    if split is None:
        k, v = _kv_for_heads(params, kv["k"], kv["v"], dims)
        return attn_cross(params, x, {"k": k, "v": v}, dims)
    dt = x.dtype
    if _q_offset(params, dims) is not None:
        x = enter(x)
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    if dims.qkv_bias:
        q = q + params["bq"].to(dt)
    q = seam(q, "batch", None, "tp", None)
    out = _attend_split(_all_heads(params, q, dims), kv["k"], kv["v"], None,
                        split.group, dims)
    return _proj_out(params, _own_heads(params, out, dims).to(dt), dims)


def seq_part(t, seq: int, dims: AttnDims, dim: int = 1):
    """This rank's slice of a whole cache tensor along its positions
    ``dim`` when the sharded step splits them (:func:`kv_seq_split`),
    else ``t``."""
    split = kv_seq_split(t.shape[2] == dims.n_kv, seq)
    if split is None:
        return t
    w = seq // split.size
    return t.narrow(dim, split.rank * w, w).contiguous()


def attn_prefill(params, x, dims: AttnDims, cache_len: int,
                 n_chunks: int = 1, ring=None):
    """Full-sequence forward that also returns a populated cache.

    ``ring`` marks a sliding-window ring buffer (local layers pass True
    explicitly: it must hold even when the prompt is shorter than the
    window).  A cache shorter than the prompt keeps the prompt's tail,
    rolled to its ring slots; a longer one is zero-padded.  In a sharded
    step the cache holds the rank's kv heads, or every kv head, whole or
    this rank's slice of the positions (:func:`seq_part`)."""
    B, S, _ = x.shape
    if ring is None:
        ring = cache_len < S
    y = attn_train(params, x, dims, n_chunks)
    positions = torch.arange(S, device=x.device).expand(B, S)
    _, k, v = _qkv(params, x, dims, positions, for_heads=False)
    if cache_len < S:  # keep the tail, placed at its ring slots
        k = torch.roll(k[:, S - cache_len:], S % cache_len, dims=1)
        v = torch.roll(v[:, S - cache_len:], S % cache_len, dims=1)
    elif cache_len > S:  # positions p < S already sit at slot p
        pad = (0, 0, 0, 0, 0, cache_len - S)
        k, v = F.pad(k, pad), F.pad(v, pad)
    cache = {"k": seq_part(k, cache_len, dims).contiguous(),
             "v": seq_part(v, cache_len, dims).contiguous(),
             "pos": torch.full((B,), S, dtype=torch.int32, device=x.device),
             "ring": torch.tensor(bool(ring), device=x.device)}
    return y, cache
