"""Public wrappers for the port's kernels, with their launch counters.

Counterpart of ``repro.kernels.ops``.  A wrapper dispatches on where its
tensors lie: on the CPU it runs the kernel's plain PyTorch version, on a
CUDA device it launches the hand-written kernel — and adds one to its
``launches`` counter, which is the only place that counter moves.  There
is no fallback from a CUDA tensor to the plain version; any other device
raises.  The reference's interpret-mode policy has no counterpart: where
a tensor lies decides.
"""

from __future__ import annotations

from repro_torch.kernels import conv2d_rows as _cr

#: deterministic conv tile search space, largest first — the enumeration
#: order doubles as the tie-break order (identical to the reference's)
CONV_BLOCK_HS = (32, 16, 8, 4, 2, 1)


def candidate_tiles(kind: str, *, h_out: int = 0) -> tuple:
    """The one deterministic tile-candidate enumeration the planner's
    retile pass walks: a tuple of KernelSpec field dicts in search order.

    ``"conv"`` yields ``{"block_h"}`` candidates, clamped to ``h_out`` when
    given and deduplicated in order.  Geometry only — feasibility stays
    with the planner's pricers.  The ``"swa"``/``"ssd"`` spaces come with
    their kernels."""
    if kind != "conv":
        raise ValueError(f"unknown tile kind {kind!r}; ported: 'conv'")
    out, seen = [], set()
    for b in CONV_BLOCK_HS:
        b = min(b, h_out) if h_out else b
        if b >= 1 and b not in seen:
            seen.add(b)
            out.append({"block_h": b})
    return tuple(out)


def conv2d(x, w, stride: int = 1, padding: int = 0, block_h: int = 8):
    """NHWC x HWIO -> NHWC row-block convolution: the CUDA kernel for CUDA
    tensors (counted in ``conv2d.launches``), its plain version for CPU
    tensors."""
    if x.device.type == "cpu":
        return _cr.conv2d_rows_plain(x, w, stride, padding, block_h)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d runs on CPU or CUDA tensors, got "
                         f"{x.device}")
    y = _cr.conv2d_rows(x, w, stride=stride, padding=padding,
                        block_h=block_h)
    conv2d.launches += 1
    return y


conv2d.launches = 0
