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
from repro_torch.kernels import ssd_chunk as _ssd
from repro_torch.kernels import swa_attention as _swa

#: deterministic tile search spaces, largest first — the enumeration order
#: doubles as the tie-break order (identical to the reference's)
CONV_BLOCK_HS = (32, 16, 8, 4, 2, 1)
SWA_BLOCKS = (256, 128, 64, 32, 16, 8)
SSD_CHUNKS = (256, 128, 64, 32, 16, 8)


def candidate_tiles(kind: str, *, h_out: int = 0, seq: int = 0) -> tuple:
    """The one deterministic tile-candidate enumeration the planner's
    retile pass walks: a tuple of KernelSpec field dicts in search order.

    ``"conv"`` yields ``{"block_h"}`` candidates, clamped to ``h_out`` when
    given and deduplicated in order; ``"swa"`` yields ``{"bq", "bk"}``
    pairs satisfying the kernel's divisibility contract against ``seq``
    (``seq % bq == seq % bk == bq % bk == 0, bk <= bq``); ``"ssd"`` yields
    ``{"chunk"}`` divisors of ``seq``.  Geometry only — feasibility stays
    with the planner's pricers."""
    if kind == "conv":
        out, seen = [], set()
        for b in CONV_BLOCK_HS:
            b = min(b, h_out) if h_out else b
            if b >= 1 and b not in seen:
                seen.add(b)
                out.append({"block_h": b})
        return tuple(out)
    if kind == "swa":
        out = []
        for bq in SWA_BLOCKS:
            if seq and (bq > seq or seq % bq):
                continue
            for bk in SWA_BLOCKS:
                if bk > bq or bq % bk or (seq and seq % bk):
                    continue
                out.append({"bq": bq, "bk": bk})
        return tuple(out)
    if kind == "ssd":
        return tuple({"chunk": c} for c in SSD_CHUNKS
                     if not seq or (c <= seq and seq % c == 0))
    raise ValueError(f"unknown tile kind {kind!r}; "
                     f"known: 'conv', 'swa', 'ssd'")


def _device_kind(t, name: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got "
                         f"{t.device}")
    return t.device.type


def conv2d(x, w, stride: int = 1, padding: int = 0, block_h: int = 8):
    """NHWC x HWIO -> NHWC row-block convolution: the CUDA kernel for CUDA
    tensors (counted in ``conv2d.launches``), its plain version for CPU
    tensors."""
    if _device_kind(x, "conv2d") == "cpu":
        return _cr.conv2d_rows_plain(x, w, stride, padding, block_h)
    y = _cr.conv2d_rows(x, w, stride=stride, padding=padding,
                        block_h=block_h)
    conv2d.launches += 1
    return y


conv2d.launches = 0


def swa_attention(q, k, v, window: int, bq: int = 128, bk: int = 128):
    """(B, H, S, D) causal sliding-window attention: the CUDA kernel for
    CUDA tensors (counted in ``swa_attention.launches``), its plain
    version for CPU tensors."""
    if _device_kind(q, "swa_attention") == "cpu":
        return _swa.swa_attention_plain(q, k, v, window, bq, bk)
    o = _swa.swa_attention(q, k, v, window=window, bq=bq, bk=bk)
    swa_attention.launches += 1
    return o


swa_attention.launches = 0


def ssd_scan(x, B, C, a, dt, chunk: int = 128):
    """The Mamba2 SSD scan's ``y`` in chunks of ``min(chunk, S)`` rows: the
    CUDA kernel for CUDA tensors (counted in ``ssd_scan.launches``), its
    plain version for CPU tensors."""
    if _device_kind(x, "ssd_scan") == "cpu":
        return _ssd.ssd_scan_plain(x, B, C, a, dt, chunk)
    y = _ssd.ssd_scan(x, B, C, a, dt, chunk=chunk)
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0
