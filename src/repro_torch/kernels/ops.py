"""Public wrappers for the port's kernels.

Counterpart of ``repro.kernels.ops``.  A wrapper dispatches on where its
tensors lie: on the CPU it runs the kernel's plain PyTorch version, on a
CUDA device it launches the hand-written kernel inside a range named
after it (``conv2d_rows``, ``swa_attention``, ``ssd_scan``,
``dwconv_wgrad``, ``dwconv2d``; :func:`repro_torch.obs.profile_range`)
and, once the launch returns, adds its launches to the obs counter of the
same name (one; two for ``dwconv_wgrad``, whose partial sums and their
finish are separate kernels), which is the only place that counter moves
(it counts while an obs session or capture is open).
There is no fallback from a CUDA tensor to the plain version; any other
device raises.  The reference's interpret-mode policy has no
counterpart: where a tensor lies decides.
"""

from __future__ import annotations

from repro_torch import obs
from repro_torch.kernels import conv2d_rows as _cr
from repro_torch.kernels import dwconv2d as _dc
from repro_torch.kernels import dwconv_wgrad as _dw
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
    tensors (range and counter ``conv2d_rows``), its plain version for CPU
    tensors."""
    if _device_kind(x, "conv2d") == "cpu":
        return _cr.conv2d_rows_plain(x, w, stride, padding, block_h)
    with obs.profile_range("conv2d_rows"):
        y = _cr.conv2d_rows(x, w, stride=stride, padding=padding,
                            block_h=block_h)
    obs.counter("conv2d_rows").inc()
    return y


def swa_attention(q, k, v, window: int, bq: int = 128, bk: int = 128):
    """(B, H, S, D) causal sliding-window attention: the CUDA kernel for
    CUDA tensors (range and counter ``swa_attention``), its plain version
    for CPU tensors."""
    if _device_kind(q, "swa_attention") == "cpu":
        return _swa.swa_attention_plain(q, k, v, window, bq, bk)
    with obs.profile_range("swa_attention"):
        o = _swa.swa_attention(q, k, v, window=window, bq=bq, bk=bk)
    obs.counter("swa_attention").inc()
    return o


def ssd_scan(x, B, C, a, dt, chunk: int = 128):
    """The Mamba2 SSD scan's ``y`` in chunks of ``min(chunk, S)`` rows: the
    CUDA kernel for CUDA tensors (range and counter ``ssd_scan``, one a
    call), its plain version for CPU tensors."""
    if _device_kind(x, "ssd_scan") == "cpu":
        return _ssd.ssd_scan_plain(x, B, C, a, dt, chunk)
    with obs.profile_range("ssd_scan"):
        y = _ssd.ssd_scan(x, B, C, a, dt, chunk=chunk)
    obs.counter("ssd_scan").inc()
    return y


def dwconv_wgrad(g, x, padding, k: int):
    """``(dw, db)`` of a stride-1 depthwise conv (NCHW views ``g`` and
    ``x``; ``dw`` as the OIHW view of HWIO storage): the CUDA kernel for
    CUDA tensors (range ``dwconv_wgrad``; counter ``dwconv_wgrad``,
    :data:`~repro_torch.kernels.dwconv_wgrad.LAUNCHES` a call), after an
    NHWC copy of a tensor that is not NHWC storage (counter
    ``dwconv_wgrad.copies``), its plain version for CPU tensors."""
    if _device_kind(x, "dwconv_wgrad") == "cpu":
        return _dw.dwconv_wgrad_plain(g, x, padding, k)
    for t in (g, x):
        if not _dw.nhwc_strided(t):
            obs.counter("dwconv_wgrad.copies").inc()
    g, x = _dw.channels_last(g), _dw.channels_last(x)
    with obs.profile_range("dwconv_wgrad"):
        out = _dw.dwconv_wgrad(g, x, padding, k)
    obs.counter("dwconv_wgrad").inc(_dw.LAUNCHES)
    return out


def dwconv2d(x, w, b, padding, flip: bool = False):
    """A stride-1 depthwise conv (NCHW view ``x``, OIHW view ``w`` of HWIO
    storage, bias ``b`` or None; with ``flip``, the filter flipped: the
    data gradient): the CUDA kernel for CUDA tensors (range and counter
    ``dwconv2d``, one a call), after an NHWC copy of an ``x`` that is not
    NHWC storage (counter ``dwconv2d.copies``), its plain version for CPU
    tensors."""
    if _device_kind(x, "dwconv2d") == "cpu":
        return _dc.dwconv2d_plain(x, w, b, padding, flip)
    if not _dw.nhwc_strided(x):
        obs.counter("dwconv2d.copies").inc()
        x = _dw.channels_last(x)
    with obs.profile_range("dwconv2d"):
        y = _dc.dwconv2d(x, w, b, padding, flip)
    obs.counter("dwconv2d").inc(_dc.LAUNCHES)
    return y
