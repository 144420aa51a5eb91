"""Causal sliding-window flash attention: the CUDA kernel and its plain
version.

Counterpart of ``repro.kernels.swa_attention`` (the Pallas TPU kernel,
``_swa_kernel``).  The kernel is ``csrc/swa_attention.cu``, hand-written
CUDA C++ for ``sm_90a``.  It is bound by operations: at Gemma-3 4B's local
layers it does ~450 FLOP per byte of q, k, v and o, above the H100's bf16
ridge, so its ceiling is the tensor cores.  Two instantiations:

* **bf16** (the LM path): a FlashAttention-2-style forward on the tensor
  cores.  One CTA per (q block, batch*head), one warp per 16 query rows;
  the q block stays in shared memory, keys stream through a 2-stage
  ``cp.async`` ring of ``STAGE_KEYS``-row K/V stages, S = QKᵀ and O += PV
  are ``mma.sync`` m16n8k16 products with fp32 accumulators, and m, l, O
  stay in fp32 registers (P is rounded to bf16 only as PV's operand).
* **fp32**: a SIMT kernel (fp32 FMAs).  A tensor-core fp32 product
  is TF32, which cannot hold the 2e-5 fp32 parity.

This module holds:

* :func:`swa_attention` — launches the kernel on CUDA tensors (and only on
  CUDA tensors; it raises on anything else and on a failed launch);
* :func:`swa_attention_plain` — the same computation in plain PyTorch with
  the kernel's index math: q blocks of ``bq`` rows, each visiting the
  ``n_kv`` key blocks of ``bk`` rows that end at its diagonal, keys front-
  padded with zeros, an online softmax in fp32.  The CPU takes this path,
  and it is what the kernel is checked against on the card;
* :func:`tiles`, :func:`smem_bytes` and :func:`launch_problem` — the
  geometry the planner prices.

Layout is the reference's ``(B, H, S, D)``; any strides are accepted as long
as ``D`` is contiguous, so callers pass ``transpose(1, 2)`` views of
``(B, S, H, D)`` tensors without a copy, and the output takes the same
strides as ``q``.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
#: shared memory one CTA may use on Hopper (227 KiB)
SMEM_LIMIT = 232448
#: fp32 (SIMT) kernel: query rows one pass of a CTA keeps in flight (8
#: warps x 4 rows), and its largest key block
PASS_ROWS = 32
MAX_BK = 256
#: bf16 (tensor-core) kernel: keys per shared-memory stage, stages in the
#: ring, and the largest q block (8 warps of 16 rows)
STAGE_KEYS = 64
KV_STAGES = 2
MAX_BQ_BF16 = 128
#: the kernel's head-dim range
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def tiles(S: int, window: int, bq: int, bk: int):
    """``(bq, bk, n_kv, pad_front)`` after the reference's clamps and
    asserts: ``bq``/``bk`` clamped to ``S``, ``S % bq == S % bk == bq % bk
    == 0`` with ``bk <= bq``; ``n_kv`` key blocks per q block (all of them
    when ``window == 0``)."""
    bq, bk = min(bq, S), min(bk, S)
    if S % bq or S % bk or bk > bq or bq % bk:
        raise ValueError(f"swa tiling bq={bq} bk={bk} does not tile S={S} "
                         f"(need S % bq == S % bk == bq % bk == 0, bk <= bq)")
    n_kv = min(-(-(bq + window) // bk), S // bk) if window > 0 else S // bk
    return bq, bk, n_kv, max(0, n_kv * bk - bq)


def smem_bytes(bq: int, bk: int, d: int, dtype_bytes: int) -> int:
    """Dynamic shared memory of one CTA (``swa_attention_smem_bytes`` in
    the CUDA source computes the same).  bf16: the whole q block plus
    ``KV_STAGES`` stages of K and V at ``STAGE_KEYS`` rows (``bk`` does not
    enter).  fp32: the K tile (rows padded by one 32-bit word), the V tile
    and ``PASS_ROWS`` fp32 q rows (``bq`` does not enter)."""
    if dtype_bytes == 2:
        return 2 * d * (bq + 2 * KV_STAGES * STAGE_KEYS)
    return 4 * (bk * (d + 1) + bk * d + PASS_ROWS * d)


def launch_problem(bq: int, bk: int, d: int, dtype_bytes: int,
                   smem_limit: int = SMEM_LIMIT) -> str:
    """Why the kernel cannot run this geometry ("" when it can): fp32 or
    bf16, ``d`` a multiple of 32 up to 256; bf16 needs ``bq`` a multiple
    of 16 in 16..128 (one warp per 16 query rows, at most 8 warps), fp32
    ``bk <= 256``; and one CTA's shared memory within ``smem_limit``
    (Hopper's 227 KiB by default)."""
    if dtype_bytes not in (2, 4):
        return f"the CUDA swa kernel takes fp32 or bf16 (dtype_bytes=" \
               f"{dtype_bytes})"
    if d % 32 or not 32 <= d <= MAX_HEAD_DIM:
        return f"head_dim={d} is not a multiple of 32 in 32..{MAX_HEAD_DIM}"
    if dtype_bytes == 2 and (bq % 16 or not 16 <= bq <= MAX_BQ_BF16):
        return (f"bq={bq}: the bf16 tensor-core kernel runs one warp per "
                f"16 query rows, at most 8 (bq a multiple of 16 in "
                f"16..{MAX_BQ_BF16})")
    if dtype_bytes == 4 and bk > MAX_BK:
        return f"bk={bk} exceeds {MAX_BK}"
    smem = smem_bytes(bq, bk, d, dtype_bytes)
    if smem > smem_limit:
        return (f"CTA shared memory {smem} B at bq={bq} bk={bk} "
                f"head_dim={d} exceeds the {smem_limit}-byte limit")
    return ""


def _check(q, k, v):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"expected q, k, v of one (B, H, S, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"swa_attention takes fp32 or bf16 q, k, v of one "
                        f"type, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")


def swa_attention_plain(q, k, v, window: int, bq: int = 128, bk: int = 128):
    """The kernel's computation in plain PyTorch.  All q blocks advance
    together through their ``n_kv`` visits; visit ``j`` of q block ``i``
    reads padded keys ``[i*bq + j*bk, + bk)``, i.e. unpadded keys from
    ``i*bq + bq - (n_kv - j)*bk``.  Masks, ``-1e30`` scores, the online
    softmax and the ``max(l, 1e-30)`` floor follow the reference kernel."""
    _check(q, k, v)
    B, H, S, D = q.shape
    bq, bk, n_kv, pad = tiles(S, window, bq, bk)
    n_q = S // bq
    f32 = torch.float32
    qb = (q.reshape(B * H, n_q, bq, D).to(f32) * (1.0 / D ** 0.5))
    kp = torch.nn.functional.pad(k.reshape(B * H, S, D), (0, 0, pad, 0))
    vp = torch.nn.functional.pad(v.reshape(B * H, S, D), (0, 0, pad, 0))
    dev = q.device
    q_pos = (torch.arange(n_q, device=dev)[:, None] * bq
             + torch.arange(bq, device=dev))                     # (n_q, bq)
    m = torch.full((B * H, n_q, bq), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((B * H, n_q, bq), dtype=f32, device=dev)
    acc = torch.zeros((B * H, n_q, bq, D), dtype=f32, device=dev)
    for j in range(n_kv):
        rows = (torch.arange(n_q, device=dev)[:, None] * bq + j * bk
                + torch.arange(bk, device=dev))                  # (n_q, bk)
        kj = kp[:, rows].to(f32)                                 # (BH,n_q,bk,D)
        vj = vp[:, rows].to(f32)
        k_pos = rows - pad
        s = torch.einsum("bnqd,bnkd->bnqk", qb, kj)
        ok = (k_pos[:, None, :] >= 0) & (k_pos[:, None, :] <= q_pos[:, :, None])
        if window > 0:
            ok &= k_pos[:, None, :] > (q_pos[:, :, None] - window)
        s = torch.where(ok, s, torch.tensor(NEG_INF, dtype=f32, device=dev))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bnqk,bnkd->bnqd", p, vj)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, S, D).to(q.dtype)


def _lib():
    from repro_torch.kernels.build import load
    lib = load("swa_attention")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.swa_attention_launch.argtypes = [p, p, p, p] + [i] * 5 + [
            ctypes.POINTER(ctypes.c_longlong)] + [i] * 4 + [ctypes.c_float, p]
        lib.swa_attention_launch.restype = i
        lib.swa_attention_smem_bytes.argtypes = [i, i, i, i]
        lib.swa_attention_smem_bytes.restype = ctypes.c_longlong
        lib.swa_attention_error_string.argtypes = [i]
        lib.swa_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def swa_attention(q, k, v, *, window: int, bq: int = 128, bk: int = 128):
    """Launch the CUDA kernel: ``(B, H, S, D)`` q, k, v of one type (fp32 or
    bf16) on one CUDA device, ``D`` contiguous, any other strides (whole
    16-byte units in bf16, 32-bit words in fp32).  The output has ``q``'s
    strides.  The launch goes on the current stream and is checked with
    ``cudaGetLastError``; a refused launch raises."""
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"swa_attention launches on CUDA tensors only, got "
                         f"{q.device}; the plain version is "
                         f"swa_attention_plain")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    B, H, S, D = q.shape
    bq, bk, n_kv, _ = tiles(S, window, bq, bk)
    nbytes = q.element_size()
    problem = launch_problem(bq, bk, D, nbytes)
    if problem:
        raise ValueError(problem)
    o = torch.empty_like(q)
    # bf16 rows are copied in 16-byte pieces: q, k, v rows must start on
    # 16-byte boundaries; fp32 reads 32-bit words
    align = 16 if nbytes == 2 else 4
    strides = []
    for t in (q, k, v, o):
        if t.stride(3) != 1:
            raise ValueError("swa_attention needs a contiguous head dim")
        st = (t.stride(0), t.stride(1), t.stride(2))
        a = 4 if t is o else align
        if any(s * nbytes % a for s in st) or t.data_ptr() % a:
            raise ValueError(f"strides {st} of a {t.dtype} tensor (or its "
                             f"pointer) are not whole {a}-byte units")
        strides.extend(st)
    lib = _lib()
    arr = (ctypes.c_longlong * 12)(*strides)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.swa_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPES[q.dtype], B, H, S, D, arr, window, bq, bk, n_kv,
            1.0 / D ** 0.5, stream)
    if err:
        raise RuntimeError(f"swa_attention launch failed: "
                           f"{lib.swa_attention_error_string(err).decode()} "
                           f"(cudaError {err})")
    return o
