"""Frozen yardstick arithmetic: the H100's peaks and a convolution's
operations and bytes.

Copied from ``chip_smoke.py`` (``PEAK_FP32_FLOPS``, ``PEAK_TF32_FLOPS``,
``PEAK_BF16_FLOPS``, ``PEAK_HBM_BYTES``, ``_bound_parts``, ``_bound``) so
that a change to the program cannot move the benchmark's ruler.  The peaks
are NVIDIA's data sheet for the H100 SXM (dense, no sparsity, at the full
700 W power limit); a run writes the card's own limit beside them.
"""

from __future__ import annotations

from typing import Tuple

#: fp32 outside the tensor cores: the configurations run fp32 with TF32 off
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def conv_out(size: int, k: int, s: int, p: int) -> int:
    return (size + 2 * p - k) // s + 1


def conv_flops(B, H, W, cin, cout, k=3, s=1, p=1) -> int:
    """Multiply-adds of one direct convolution, counted twice (FLOPs)."""
    return 2 * B * conv_out(H, k, s, p) * conv_out(W, k, s, p) \
        * cout * k * k * cin


def conv_bytes(B, H, W, cin, cout, k=3, s=1, p=1, itemsize=4) -> int:
    """Each input element read once, the output written once."""
    ho, wo = conv_out(H, k, s, p), conv_out(W, k, s, p)
    return itemsize * (B * H * W * cin + k * k * cin * cout
                       + B * ho * wo * cout)


def bound_parts(B, H, W, cin, cout, k=3, s=1, p=1) -> Tuple[float, float]:
    """(ms for the FLOPs at the fp32 peak, ms for the bytes at the HBM
    rate) of one fp32 convolution."""
    return (1e3 * conv_flops(B, H, W, cin, cout, k, s, p) / PEAK_FP32_FLOPS,
            1e3 * conv_bytes(B, H, W, cin, cout, k, s, p) / PEAK_HBM_BYTES)


def bound(t_ops: float, t_bytes: float) -> Tuple[float, str]:
    """The least time the card could take, and which of the two sets it."""
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")
