"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, exponential
gating) and sLSTM (scalar memory, hidden-state recurrence) — training,
the prefill that returns the final state, and the one-token decode
(counterpart of ``repro.models.lm.xlstm``).

Both are recurrent scans, so the LR-CNN 2PS mapping (carried state =
boundary cache) applies directly: training runs an outer chunk scan
through :func:`repro_torch.models.lm.rowexec.scan_rows` (the checkpointed
chunk loop with per-chunk BP recompute, or the residency-placing
row-program executor when the active plan offloads), and an exact
token-by-token scan inside the chunk.  In eager PyTorch that inner scan
is a Python loop: a few kernel launches per token.  Decode is one
recurrence step with O(1) state.

Stabilised exponential gating follows the paper: ``m_t = max(f̃+m, ĩ)``,
``i' = exp(ĩ−m)``, ``f' = exp(f̃+m_prev−m)``; the stabiliser starts at
``-1e30``.

In a sharded step a rank gathers the layers' split leaves and runs them
whole; the seams at the reference's ``lc`` lines stay identities.  A
sharded serving step keeps the mLSTM's ``C``/``n``/``m`` split by heads
(the prefill returns the rank's heads; a decode steps them and gathers
their output over the model group); the sLSTM's states, split by width,
reach the layer whole (the step gathers them).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.launch.sharding import seam, split_offset, tp_gather, tp_part
from repro_torch.models.lm import rowexec
from repro_torch.models.lm.common import dense_init

M_INIT = -1e30


@dataclasses.dataclass(frozen=True)
class XLSTMDims:
    d: int
    n_heads: int
    expand: int = 2
    chunk: int = 256

    @property
    def inner(self) -> int:
        return self.d * self.expand

    @property
    def head_dim(self) -> int:
        return self.inner // self.n_heads


def _stacked(stack: int, shape) -> tuple:
    return ((stack,) if stack else ()) + tuple(shape)


def _scan_tokens(step, carry, seq):
    """``lax.scan(step, carry, seq)`` along axis 1 of every leaf of
    ``seq``; returns ``(stacked outputs along axis 1, carry)``."""
    hs = []
    for t in range(seq[0].shape[1]):
        carry, h = step(carry, tuple(u[:, t] for u in seq))
        hs.append(h)
    return torch.stack(hs, dim=1), carry


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(gen, dims: XLSTMDims, param_dtype, stack: int = 0):
    d, inner, H = dims.d, dims.inner, dims.n_heads
    return {
        "w_in": dense_init(gen, (d, 2 * inner), param_dtype,   # x | gate z
                           stack=stack),
        "wq": dense_init(gen, (inner, inner), param_dtype, stack=stack),
        "wk": dense_init(gen, (inner, inner), param_dtype, stack=stack),
        "wv": dense_init(gen, (inner, inner), param_dtype, stack=stack),
        "w_if": dense_init(gen, (inner, 2 * H), param_dtype, scale=0.02,
                           stack=stack),
        "f_bias": torch.full(_stacked(stack, (H,)), 3.0,   # forget-gate bias
                             device=gen.device),
        "w_out": dense_init(gen, (inner, d), param_dtype, stack=stack),
    }


def _mlstm_step(carry, qkvif):
    """carry: (C, n, m) with C: (B,H,hd,hd), n: (B,H,hd), m: (B,H).
    qkvif: one step's (q, k, v): (B,H,hd) and (i, f): (B,H)."""
    C, n, m = carry
    q, k, v, ig, fg = qkvif
    m_new = torch.maximum(fg + m, ig)
    i_p = torch.exp(ig - m_new)[..., None]
    f_p = torch.exp(fg + m - m_new)[..., None]
    C = f_p[..., None] * C + i_p[..., None] * v[..., None] * k[..., None, :]
    n = f_p * n + i_p * k
    num = torch.einsum("bhij,bhj->bhi", C, q)
    den = torch.maximum(torch.abs(torch.einsum("bhj,bhj->bh", n, q)),
                        torch.ones((), device=q.device))
    h = num / den[..., None]
    return (C, n, m_new), h


def _mlstm_scan(qkvif_seq, carry):
    """Inner exact scan over a chunk.  qkvif_seq leaves: (B, c, H, ...)."""
    return _scan_tokens(_mlstm_step, carry, qkvif_seq)


def mlstm_train(params, x, dims: XLSTMDims, return_state: bool = False):
    B, S, _ = x.shape
    dt = x.dtype
    proj = x @ params["w_in"].to(dt)
    xi, z = torch.chunk(proj, 2, dim=-1)
    xi = seam(xi, "batch", None, "tp")
    H, hd = dims.n_heads, dims.head_dim
    q = (xi @ params["wq"].to(dt)).reshape(B, S, H, hd).float()
    k = (xi @ params["wk"].to(dt)).reshape(B, S, H, hd).float() \
        / math.sqrt(hd)
    v = (xi @ params["wv"].to(dt)).reshape(B, S, H, hd).float()
    gates = (xi @ params["w_if"].to(dt)).float()
    ig = gates[..., :H]
    fg = F.logsigmoid(gates[..., H:] + params["f_bias"])

    n_chunks = max(1, S // dims.chunk)
    dev = x.device
    carry0 = (torch.zeros((B, H, hd, hd), device=dev),
              torch.zeros((B, H, hd), device=dev),
              torch.full((B, H), M_INIT, device=dev))

    if n_chunks > 1:
        c = S // n_chunks

        def stack(u):
            return torch.movedim(
                u.reshape((B, n_chunks, c) + u.shape[2:]), 1, 0)

        def body(carry, chunk):
            hs, carry = _mlstm_scan(chunk, carry)
            return carry, hs
        carry, hs = rowexec.scan_rows(body, carry0,
                                      (stack(q), stack(k), stack(v),
                                       stack(ig), stack(fg)))
        h = torch.movedim(hs, 0, 1).reshape(B, S, H, hd)
    else:
        h, carry = _mlstm_scan((q, k, v, ig, fg), carry0)
        h = h.reshape(B, S, H, hd)

    h = h.reshape(B, S, dims.inner) * F.silu(z.float())
    out = seam(h.to(dt) @ params["w_out"].to(dt), "batch", None, None)
    if return_state:
        return out, {"C": tp_part(carry[0], 1), "n": tp_part(carry[1], 1),
                     "m": tp_part(carry[2], 1)}
    return out


#: the state leaves :func:`mlstm_decode` computes on while a sharded step
#: splits them: all three by heads
MLSTM_STATE_SPLIT = {"C": ("tp",), "n": ("tp",), "m": ("tp",)}


def init_mlstm_state(batch, dims: XLSTMDims, device=None):
    H, hd = dims.n_heads, dims.head_dim
    return {"C": torch.zeros((batch, H, hd, hd), device=device),
            "n": torch.zeros((batch, H, hd), device=device),
            "m": torch.full((batch, H), M_INIT, device=device)}


def mlstm_decode(params, x, state, dims: XLSTMDims):
    B = x.shape[0]
    dt = x.dtype
    proj = x @ params["w_in"].to(dt)
    xi, z = torch.chunk(proj, 2, dim=-1)
    H, hd = dims.n_heads, dims.head_dim
    q = (xi @ params["wq"].to(dt)).reshape(B, 1, H, hd).float()[:, 0]
    k = (xi @ params["wk"].to(dt)).reshape(B, 1, H, hd).float()[:, 0] \
        / math.sqrt(hd)
    v = (xi @ params["wv"].to(dt)).reshape(B, 1, H, hd).float()[:, 0]
    gates = (xi @ params["w_if"].to(dt)).float()[:, 0]
    ig = gates[:, :H]
    fg = F.logsigmoid(gates[:, H:] + params["f_bias"])
    lo = split_offset(state["C"].shape[1], H)
    if lo is not None:  # this rank's heads of a split state
        q, k, v, ig, fg = (t.narrow(1, lo, state["C"].shape[1])
                           for t in (q, k, v, ig, fg))
    (C, n, m), h = _mlstm_step((state["C"], state["n"], state["m"]),
                               (q, k, v, ig, fg))
    if lo is not None:
        h = tp_gather(h, 1)
    h = h.reshape(B, 1, dims.inner) * F.silu(z.float())
    out = h.to(dt) @ params["w_out"].to(dt)
    return seam(out, "batch", None, None), {"C": C, "n": n, "m": m}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(gen, dims: XLSTMDims, param_dtype, stack: int = 0):
    d, H = dims.d, dims.n_heads
    hd = d // H
    return {
        # input weights of the (z, i, f, o) gates
        "w_x": dense_init(gen, (d, 4 * d), param_dtype, stack=stack),
        # per-head recurrent weights (block-diagonal, as in the paper)
        "r_h": dense_init(gen, (H, hd, 4 * hd), param_dtype, scale=0.1,
                          stack=stack),
        "f_bias": torch.full(_stacked(stack, (d,)), 3.0, device=gen.device),
        "w_out": dense_init(gen, (d, d), param_dtype, stack=stack),
    }


def _slstm_step(params_f32, dims: XLSTMDims, carry, x_t):
    """carry: (c, n, h, m), each (B, d); x_t: (B, 4d), the projected
    input."""
    r_h, f_bias = params_f32
    c, n, h, m = carry
    B = c.shape[0]
    H = dims.n_heads
    hd = c.shape[1] // H
    hh = h.reshape(B, H, hd)
    rec = torch.einsum("bhi,hij->bhj", hh, r_h).reshape(B, 4 * H * hd)
    pre = x_t + rec
    z_t, i_t, f_t, o_t = torch.chunk(pre, 4, dim=-1)
    z_t = torch.tanh(z_t)
    o_t = torch.sigmoid(o_t)
    f_log = F.logsigmoid(f_t + f_bias)
    m_new = torch.maximum(f_log + m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(f_log + m - m_new)
    c = f_p * c + i_p * z_t
    n = f_p * n + i_p
    h = o_t * c / torch.maximum(n, torch.ones((), device=n.device))
    return (c, n, h, m_new), h


def slstm_train(params, x, dims: XLSTMDims, return_state: bool = False):
    B, S, d = x.shape
    dt = x.dtype
    xp = (x @ params["w_x"].to(dt)).float()
    pf32 = (params["r_h"].float(), params["f_bias"])
    dev = x.device
    carry0 = tuple(torch.zeros((B, d), device=dev) for _ in range(3)) \
        + (torch.full((B, d), M_INIT, device=dev),)

    n_chunks = max(1, S // dims.chunk)
    if n_chunks > 1:
        c = S // n_chunks
        xc = torch.movedim(xp.reshape(B, n_chunks, c, 4 * d), 1, 0)

        # the recurrent weights go through scan_rows' explicit consts: the
        # row-program executor cannot differentiate a closure
        def body(consts, carry, chunk):
            hs, carry = _scan_tokens(
                lambda cry, xt: _slstm_step(consts, dims, cry, xt[0]),
                carry, (chunk,))
            return carry, hs
        carry, hs = rowexec.scan_rows(body, carry0, xc, consts=pf32)
        h = torch.movedim(hs, 0, 1).reshape(B, S, d)
    else:
        h, carry = _scan_tokens(
            lambda cry, xt: _slstm_step(pf32, dims, cry, xt[0]),
            carry0, (xp,))
    out = seam(h.to(dt) @ params["w_out"].to(dt), "batch", None, None)
    if return_state:
        return out, {"c": carry[0], "n": carry[1], "h": carry[2],
                     "m": carry[3]}
    return out


#: :func:`slstm_decode` takes its states (split by width) whole
SLSTM_STATE_SPLIT: dict = {}


def init_slstm_state(batch, d, device=None):
    return {"c": torch.zeros((batch, d), device=device),
            "n": torch.zeros((batch, d), device=device),
            "h": torch.zeros((batch, d), device=device),
            "m": torch.full((batch, d), M_INIT, device=device)}


def slstm_decode(params, x, state, dims: XLSTMDims):
    dt = x.dtype
    xp = (x[:, 0] @ params["w_x"].to(dt)).float()
    pf32 = (params["r_h"].float(), params["f_bias"])
    carry = (state["c"], state["n"], state["h"], state["m"])
    (c, n, h, m), h_t = _slstm_step(pf32, dims, carry, xp)
    out = h_t[:, None].to(dt) @ params["w_out"].to(dt)
    return seam(out, "batch", None, None), {"c": c, "n": n, "h": h, "m": m}
