"""Plain PyTorch oracles for the kernels (the allclose ground truth).

Counterpart of ``repro.kernels.ref``.  ``swa_attention_ref`` and
``ssd_scan_ref`` are also the functions whose gradients the kernel
engines' backward passes take (``exec/kernel_engines.py``), as the
reference's ``custom_vjp``s take the lax VJP of its oracles.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def conv2d_ref(x, w, stride: int = 1, padding: int = 0):
    """NHWC x HWIO -> NHWC, symmetric padding."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def swa_attention_ref(q, k, v, window: int):
    """Causal sliding-window attention, dense.  q/k/v: (B, H, S, D)."""
    S, D = q.shape[2], q.shape[3]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                          k.float()) / math.sqrt(D)
    qp = torch.arange(S, device=q.device)
    ok = qp[None, :] <= qp[:, None]
    if window > 0:
        ok &= qp[None, :] > (qp[:, None] - window)
    scores = scores.masked_fill(~ok, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
    return out.to(q.dtype)


def ssd_scan_ref(x, B, C, a, dt):
    """Sequential reference for the Mamba2 SSD recurrence.

    x: (Bt, S, H, P); B/C: (Bt, S, N); a/dt: (Bt, S, H).
    h_t = a_t h_{t-1} + dt_t * x_t ⊗ B_t ;  y_t = C_t · h_t.
    Returns (y: (Bt, S, H, P), h_final: (Bt, H, P, N))."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    h = x.new_zeros((Bt, H, P, N))
    ys = []
    for t in range(S):
        h = h * a[:, t, :, None, None] + torch.einsum(
            "bhp,bn,bh->bhpn", x[:, t], B[:, t], dt[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", C[:, t], h))
    return torch.stack(ys, dim=1), h
