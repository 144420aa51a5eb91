"""Mamba2 (SSD, chunked): the training forward, the prefill that also
returns the recurrent state, and the one-token decode (counterpart of
``repro.models.lm.ssm``).

The recurrent-scan family where LR-CNN's 2PS is native: the inter-chunk
recurrent state *is* the two-phase boundary cache, computed once and
carried to the next sequence row; per-chunk recomputation is the BP half of
Alg. 1.

Simplified-but-faithful SSD: scalar-per-head decay ``a_t = exp(-softplus
(dt_bias + dt_t) * exp(a_log))``, state update ``h_t = a_t h_{t-1} + dt_t *
B_t ⊗ x_t``, output ``y_t = C_t · h_t + D x_t`` with multi-head structure
(n_heads × head_p × state_n), a causal-conv1d input stage and a gated
output.  Training runs the chunked form: an intra-chunk causal
attention-like term plus the inter-chunk carried state through
:func:`repro_torch.models.lm.rowexec.scan_rows` (the checkpointed chunk
loop, or the row-program executor when the active plan's residency
offloads the carry).  As in the reference, this path runs the chunk in
PyTorch ops (:func:`_ssd_chunk`), not the ``ssd_scan`` kernel, which only
the op-level ``seq_ssd_cuda`` engine calls.

In a sharded step the in-projection's fused ``[x|z|B|C|dt]`` columns are
stored split in contiguous halves, not per head, so a rank gathers the
layer's leaves and runs it whole (the seams below stay identities).  A
sharded serving step keeps the recurrent state ``h`` split by heads: the
prefill returns the rank's heads, and a decode updates them and gathers
their output over the model group; it also computes the in-projection on
the rank's columns of ``w_in`` (then gathers the projection, not the
weight) and the out-projection on its rows of ``w_out`` (fp32 partial
sums over the model group).  The conv state's channels (``[x|B|C]``,
which a split does not cut at a head) reach the layer whole: the step
gathers them (:func:`repro_torch.launch.steps.make_serve_step`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.launch.sharding import (
    Sharded, at_use, seam, split_offset, tp, tp_gather, tp_part,
)
from repro_torch.models.lm import rowexec
from repro_torch.models.lm.common import dense_init


@dataclasses.dataclass(frozen=True)
class SSMDims:
    d: int
    n_heads: int
    head_p: int      # channels per head (inner = n_heads * head_p)
    state_n: int     # SSM state size per channel
    conv_k: int = 4
    chunk: int = 256  # SSD chunk (the sequence "row" granularity)

    @property
    def inner(self) -> int:
        return self.n_heads * self.head_p


def init_ssm(gen, dims: SSMDims, param_dtype, stack: int = 0):
    d, inner, N, H = dims.d, dims.inner, dims.state_n, dims.n_heads
    lead = (stack,) if stack else ()
    dev = gen.device
    return {
        # in-projection packs [x(inner) | z(inner) | B(N) | C(N) | dt(H)]
        "w_in": dense_init(gen, (d, 2 * inner + 2 * N + H), param_dtype,
                           stack=stack),
        "conv_w": dense_init(gen, (dims.conv_k, 1, inner + 2 * N),
                             param_dtype, scale=0.5, stack=stack),
        "a_log": torch.zeros(lead + (H,), device=dev),
        "dt_bias": torch.zeros(lead + (H,), device=dev),
        "d_skip": torch.ones(lead + (H,), device=dev),
        "w_out": dense_init(gen, (inner, d), param_dtype, stack=stack),
    }


def softplus(x):
    """``jax.nn.softplus``: ``log(1 + exp(x))`` with no linear cut-over
    (``F.softplus`` returns ``x`` above its threshold 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _split_proj(proj, dims: SSMDims):
    inner, N = dims.inner, dims.state_n
    x = proj[..., :inner]
    z = proj[..., inner:2 * inner]
    B = proj[..., 2 * inner:2 * inner + N]
    C = proj[..., 2 * inner + N:2 * inner + 2 * N]
    dt = proj[..., 2 * inner + 2 * N:]
    return x, z, B, C, dt


def _causal_conv(u, w, state=None):
    """Depthwise causal conv1d.  u: (B, S, C); w: (k, 1, C).  ``state``:
    (B, k-1, C) trailing context, or None (zero padding).  Returns
    ``(silu(y), new_state)``."""
    k = w.shape[0]
    if state is None:
        pad = u.new_zeros((u.shape[0], k - 1, u.shape[2]))
    else:
        pad = state.to(u.dtype)
    ext = torch.cat([pad, u], dim=1)
    S = u.shape[1]
    y = sum(ext[:, i:i + S] * w[i, 0] for i in range(k))
    new_state = ext[:, ext.shape[1] - (k - 1):] if k > 1 else ext[:, :0]
    return F.silu(y), new_state


def _ssd_chunk(x, B, C, a, dt, h0, dims: SSMDims):
    """Exact SSD over one chunk given the incoming state h0.

    x: (Bt, c, H, P); B/C: (Bt, c, N); a: (Bt, c, H) decay in (0, 1);
    dt: (Bt, c, H); h0: (Bt, H, P, N).  Returns (y, h_out)."""
    la = torch.log(a + 1e-12)                    # (Bt, c, H)
    cum = torch.cumsum(la, dim=1)                # L_t = sum_{<=t} log a
    # intra-chunk: y_t += C_t . sum_{s<=t} exp(L_t - L_s) dt_s B_s x_s
    diff = cum[:, :, None, :] - cum[:, None, :, :]       # (Bt, t, s, H)
    c = x.shape[1]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    # mask BEFORE exp: acausal (t < s) entries have diff > 0, which
    # overflows in long chunks, and inf in the backward turns every
    # upstream gradient to NaN; exp(-inf) = 0 keeps the forward equal
    w = torch.exp(torch.where(mask[None, :, :, None], diff, -torch.inf))
    cb = torch.einsum("btn,bsn->bts", C, B)              # (Bt, t, s)
    scores = cb[..., None] * w                           # (Bt, t, s, H)
    xdt = x * dt[..., None]                              # (Bt, s, H, P)
    y = torch.einsum("btsh,bshp->bthp", scores, xdt)
    # contribution of the carried state
    decay_t = torch.exp(cum)                             # (Bt, t, H)
    y = y + torch.einsum("btn,bhpn,bth->bthp", C, h0, decay_t)
    # outgoing state
    tail = torch.exp(cum[:, -1:, :] - cum)               # (Bt, s, H)
    h_out = h0 * torch.exp(cum[:, -1, :])[:, :, None, None] \
        + torch.einsum("bshp,bsn,bsh->bhpn", xdt, B, tail)
    return y, h_out


def ssm_train(params, x, dims: SSMDims, return_state: bool = False):
    """Full-sequence training forward: chunked SSD with the state carried
    from chunk to chunk (2PS along the sequence).  ``return_state=True``
    also returns the final recurrent and conv state (for a decode)."""
    Bt, S, _ = x.shape
    dt_ = x.dtype
    proj = x @ params["w_in"].to(dt_)
    xs, z, B, C, dtproj = _split_proj(proj, dims)
    conv_in = torch.cat([xs, B, C], dim=-1)
    conv_out, _ = _causal_conv(conv_in, params["conv_w"].to(dt_))
    conv_state = conv_in[:, S - (dims.conv_k - 1):] if dims.conv_k > 1 \
        else conv_in[:, :0]
    xs = conv_out[..., :dims.inner]
    B = conv_out[..., dims.inner:dims.inner + dims.state_n]
    C = conv_out[..., dims.inner + dims.state_n:]
    xs = seam(xs, "batch", None, "tp")

    H, P, N = dims.n_heads, dims.head_p, dims.state_n
    xh = xs.reshape(Bt, S, H, P).float()
    dt_act = softplus(dtproj.float() + params["dt_bias"])     # (Bt, S, H)
    a = torch.exp(-dt_act * torch.exp(params["a_log"]))       # in (0, 1)
    Bf = B.float()
    Cf = C.float()

    n_chunks = max(1, S // dims.chunk)

    def body(h, chunk):
        xc, Bc, Cc, ac, dtc = chunk
        y, h2 = _ssd_chunk(xc, Bc, Cc, ac, dtc, h, dims)
        return h2, y

    h0 = torch.zeros((Bt, H, P, N), device=x.device)
    if n_chunks > 1:
        c = S // n_chunks

        def stack(u):
            return torch.movedim(
                u.reshape((Bt, n_chunks, c) + u.shape[2:]), 1, 0)
        h_fin, ys = rowexec.scan_rows(body, h0, (stack(xh), stack(Bf),
                                                 stack(Cf), stack(a),
                                                 stack(dt_act)))
        y = torch.movedim(ys, 0, 1).reshape(Bt, S, H, P)
    else:
        h_fin, y = body(h0, (xh, Bf, Cf, a, dt_act))

    y = y + xh * params["d_skip"][None, None, :, None]
    y = (y.reshape(Bt, S, dims.inner) * F.silu(z.float())).to(dt_)
    out = seam(y @ params["w_out"].to(dt_), "batch", None, None)
    if return_state:
        return out, {"h": tp_part(h_fin, 1), "conv": conv_state}
    return out


def _tp_shard(w, dim: int):
    """The stored shard of a leaf the sharded step would gather at use
    (:class:`~repro_torch.launch.sharding.Sharded`) when its one split is
    over the tensor-parallel group along ``dim``, else None."""
    t = tp()
    if t is None or not isinstance(w, Sharded) or len(w.gathers) != 1:
        return None
    group, d = w.gathers[0]
    return w.local if group is t.group and d == dim % w.local.ndim else None


#: the state leaves :func:`ssm_decode` computes on while a sharded step
#: splits them: ``h`` by heads (the conv state's channels, which a split
#: cuts across ``[x|B|C]``, it takes whole)
STATE_SPLIT = {"h": ("tp",)}


def init_ssm_state(batch, dims: SSMDims, dtype=torch.float32, device=None):
    """Decode state: the fp32 recurrent state ``h`` and the causal conv's
    trailing ``conv_k - 1`` inputs in ``dtype``."""
    return {
        "h": torch.zeros((batch, dims.n_heads, dims.head_p, dims.state_n),
                         device=device),
        "conv": torch.zeros((batch, dims.conv_k - 1,
                             dims.inner + 2 * dims.state_n), dtype=dtype,
                            device=device),
    }


def ssm_decode(params, x, state, dims: SSMDims):
    """One-token decode.  x: (B, 1, d).  O(1) state, no KV growth; it
    continues from ``ssm_train(..., return_state=True)``'s state."""
    Bt = x.shape[0]
    dt_ = x.dtype
    w_in = _tp_shard(params["w_in"], -1)
    proj = x @ at_use(params["w_in"]).to(dt_) if w_in is None \
        else tp_gather(x @ w_in.to(dt_), 2)
    xs, z, B, C, dtproj = _split_proj(proj, dims)
    conv_in = torch.cat([xs, B, C], dim=-1)
    conv_out, conv_state = _causal_conv(
        conv_in, at_use(params["conv_w"]).to(dt_), state["conv"])
    xs = conv_out[..., :dims.inner]
    B = conv_out[..., dims.inner:dims.inner + dims.state_n]
    C = conv_out[..., dims.inner + dims.state_n:]

    H, P = dims.n_heads, dims.head_p
    xh = xs.reshape(Bt, 1, H, P).float()[:, 0]                  # (B, H, P)
    dt_act = softplus(dtproj.float()[:, 0] + params["dt_bias"])  # (B, H)
    a = torch.exp(-dt_act * torch.exp(params["a_log"]))
    d_skip = params["d_skip"]
    lo = split_offset(state["h"].shape[1], H)
    if lo is not None:  # this rank's heads of a split state
        hl = state["h"].shape[1]
        xh, dt_act, a = (t.narrow(1, lo, hl) for t in (xh, dt_act, a))
        d_skip = d_skip.narrow(0, lo, hl)
    Bf = B.float()[:, 0]                                         # (B, N)
    Cf = C.float()[:, 0]
    h = state["h"] * a[:, :, None, None] \
        + torch.einsum("bhp,bn,bh->bhpn", xh, Bf, dt_act)
    y = torch.einsum("bn,bhpn->bhp", Cf, h) \
        + xh * d_skip[None, :, None]
    if lo is not None:
        y = tp_gather(y, 1)
    y = (y.reshape(Bt, 1, dims.inner) * F.silu(z.float())).to(dt_)
    w_out = _tp_shard(params["w_out"], 0)
    if w_out is None:
        out = y @ at_use(params["w_out"]).to(dt_)
        return seam(out, "batch", None, None), {"h": h, "conv": conv_state}
    rows = w_out.shape[0]
    out = y[..., tp().rank * rows:(tp().rank + 1) * rows].float() \
        @ w_out.to(dt_).float()
    return seam(out, "batch", None, None, partial=True).to(dt_), \
        {"h": h, "conv": conv_state}
