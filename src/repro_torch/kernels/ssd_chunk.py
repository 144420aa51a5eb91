"""Mamba2 SSD scan: the CUDA kernel and its plain version.

Counterpart of ``repro.kernels.ssd_chunk`` (the Pallas TPU kernel, which
walks sequence chunks in order with the state in VMEM scratch).  Both
forms here compute the same chunked SSD as that kernel, with its index
math: per chunk of ``chunk`` rows (``min(chunk, S)``, which must divide
``S``), ``cum`` is the inclusive scan of ``log(a + 1e-12)``, the causal
``(c, c)`` decay ``exp(cum_t - cum_s)`` (masked before the ``exp``) scales
the ``C Bᵀ`` Gram matrix, and the state ``h (H, P, N)`` is carried from
chunk to chunk.  The kernel is ``csrc/ssd_scan.cu`` (hand-written CUDA C++
for ``sm_90a``, fp32 on the tensor cores in a 3xTF32 split); its header
says what bounds it.  This module holds:

* :func:`ssd_scan` — launches the kernel on CUDA tensors (only there; it
  raises on anything else and on a failed launch);
* :func:`ssd_scan_plain` — the plain version, the same chunked form in
  PyTorch.  The CPU takes this path, and the kernel is checked against it
  on the card; the sequential :func:`repro_torch.kernels.ref.ssd_scan_ref`
  is the second check and the gradient oracle;
* :func:`smem_bytes` / :func:`launch_problem` — what one CTA needs, which
  the planner prices.
"""

from __future__ import annotations

import ctypes

import torch

#: largest state size N the kernel takes
MAX_N = 128
#: P columns one CTA owns
P_TILE = 32
#: dynamic shared memory a CTA may take on Hopper (227 KiB)
SMEM_LIMIT = 232448
#: shared memory a CTA may take for two to fit on one SM: half of the SM's
#: 233,472 bytes less the 1,024 reserved per CTA
TWO_PER_SM = 233472 // 2 - 1024


def _check(x, B, C, a, dt):
    if x.dim() != 4 or B.dim() != 3 or C.shape != B.shape:
        raise ValueError(f"expected x (Bt, S, H, P) and B, C (Bt, S, N), "
                         f"got {tuple(x.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    Bt, S, H, _ = x.shape
    if B.shape[:2] != (Bt, S) or a.shape != (Bt, S, H) \
            or dt.shape != a.shape:
        raise ValueError(f"B {tuple(B.shape)}, a {tuple(a.shape)}, dt "
                         f"{tuple(dt.shape)} do not fit x {tuple(x.shape)}")
    ts = (x, B, C, a, dt)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"ssd_scan is fp32-only, got "
                        f"{[str(t.dtype) for t in ts]}")
    if any(t.device != x.device for t in ts):
        raise ValueError("x, B, C, a, dt lie on different devices")


def chunk_rows(chunk: int, seq: int) -> int:
    """The chunk the scan runs at, ``min(chunk, seq)``; raises when it does
    not divide ``seq`` (the reference asserts the same)."""
    c = min(chunk, seq)
    if c < 1 or seq % c:
        raise ValueError(f"ssd chunk={c} does not divide seq={seq}")
    return c


def _ld_bc(np_: int) -> int:
    """Row stride of the B, C and state tiles: ``N`` rounded up to 16, then
    to 8 mod 16 words (bank-conflict-free fragment reads)."""
    return np_ + (8 - np_ % 16) % 16


def _smem_floats(rows: int, ldb: int, stages: int) -> int:
    return (stages * rows * (P_TILE + 4 + 2 * ldb) + 2 * P_TILE * ldb
            + (6 + 2 * stages) * rows)


def stages(chunk: int, n: int) -> int:
    """Copies of the chunk's x, B and C tiles the kernel keeps: two (the
    next chunk loads while this one computes) when they leave room for two
    CTAs per SM, else one (``ssd_scan``'s ``stages_for``)."""
    rows, ldb = -(-chunk // 16) * 16, _ld_bc(-(-n // 16) * 16)
    return 2 if 4 * _smem_floats(rows, ldb, 2) <= TWO_PER_SM else 1


def smem_bytes(chunk: int, n: int) -> int:
    """Dynamic shared memory of one CTA at ``chunk`` rows and state size
    ``n`` (``ssd_scan_smem_bytes`` in the CUDA source): :func:`stages`
    copies of the x tile, B and C, the state tile as TF32 hi and lo parts,
    a ring of a and dt with a slot per stage, and two buffers of three
    per-row arrays (cum, tail, dt)."""
    rows, ldb = -(-chunk // 16) * 16, _ld_bc(-(-n // 16) * 16)
    return 4 * _smem_floats(rows, ldb, stages(chunk, n))


def gram_floats(bt: int, seq: int, chunk: int) -> int:
    """Floats of the workspace one call needs for the Gram pass: the causal
    16 x 8 tiles of every chunk's ``C Bᵀ`` (``ssd_scan_workspace_floats``
    in the CUDA source)."""
    m = -(-chunk // 16)
    return bt * (seq // chunk) * m * (m + 1) * 128


def launch_problem(chunk: int, n: int, smem_limit: int = SMEM_LIMIT) -> str:
    """Why the kernel cannot run ``chunk`` rows at state size ``n`` ("" when
    it can)."""
    if n < 1 or n > MAX_N:
        return f"state size N={n} is outside the kernel's 1..{MAX_N}"
    need = smem_bytes(chunk, n)
    if need > smem_limit:
        return (f"ssd chunk={chunk} at N={n} needs {need} B of shared "
                f"memory per CTA, above {smem_limit}")
    return ""


def ssd_scan_plain(x, B, C, a, dt, chunk: int = 128):
    """``y`` of the chunked SSD scan in PyTorch, with the kernel's index
    math (the kernel's plain version)."""
    _check(x, B, C, a, dt)
    Bt, S, H, P = x.shape
    c = chunk_rows(chunk, S)
    causal = torch.ones(c, c, dtype=torch.bool, device=x.device).tril()
    h = x.new_zeros((Bt, H, P, B.shape[-1]))
    ys = []
    for k0 in range(0, S, c):
        xk, Bk, Ck = x[:, k0:k0 + c], B[:, k0:k0 + c], C[:, k0:k0 + c]
        dtk = dt[:, k0:k0 + c]
        cum = torch.cumsum(torch.log(a[:, k0:k0 + c] + 1e-12), dim=1)
        diff = cum[:, :, None, :] - cum[:, None, :, :]     # (Bt, t, s, H)
        w = torch.exp(diff.masked_fill(~causal[None, :, :, None],
                                       float("-inf")))
        scores = torch.einsum("btn,bsn->bts", Ck, Bk)[..., None] * w
        xdt = xk * dtk[..., None]                          # (Bt, s, H, P)
        y = torch.einsum("btsh,bshp->bthp", scores, xdt)
        y = y + torch.einsum("btn,bhpn,bth->bthp", Ck, h, torch.exp(cum))
        tail = torch.exp(cum[:, -1:, :] - cum)             # (Bt, s, H)
        h = h * torch.exp(cum[:, -1, :])[:, :, None, None] \
            + torch.einsum("bshp,bsn,bsh->bhpn", xdt, Bk, tail)
        ys.append(y)
    return torch.cat(ys, dim=1)


def _lib():
    from repro_torch.kernels.build import load
    lib = load("ssd_scan")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_launch.argtypes = [p] * 7 + [i] * 6 + [p]
        lib.ssd_scan_launch.restype = i
        lib.ssd_scan_smem_bytes.argtypes = [i, i]
        lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
        lib.ssd_scan_workspace_floats.argtypes = [i, i, i]
        lib.ssd_scan_workspace_floats.restype = ctypes.c_longlong
        lib.ssd_scan_error_string.argtypes = [i]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def ssd_scan(x, B, C, a, dt, chunk: int = 128):
    """Launch the CUDA kernel: contiguous fp32 ``x (Bt, S, H, P)``, ``B``/``C
    (Bt, S, N)``, ``a``/``dt (Bt, S, H)`` on one CUDA device -> ``y`` like
    ``x``, in chunks of ``min(chunk, S)`` rows.  The two launches (the Gram
    pass, then the scan, with a workspace of :func:`gram_floats`) go on the
    current stream and are checked with ``cudaGetLastError``; a refused
    launch raises."""
    _check(x, B, C, a, dt)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan launches on CUDA tensors only, got "
                         f"{x.device}; the plain version is ssd_scan_plain")
    if not all(t.is_contiguous() for t in (x, B, C, a, dt)):
        raise ValueError("ssd_scan needs contiguous x, B, C, a, dt")
    Bt, S, H, P = x.shape
    N = B.shape[2]
    c = chunk_rows(chunk, S)
    problem = launch_problem(c, N)
    if problem:
        raise ValueError(problem)
    y = torch.empty_like(x)
    gram = torch.empty(gram_floats(Bt, S, c), dtype=torch.float32,
                       device=x.device)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_launch(x.data_ptr(), B.data_ptr(), C.data_ptr(),
                                  a.data_ptr(), dt.data_ptr(), y.data_ptr(),
                                  gram.data_ptr(), Bt, S, H, P, N, c, stream)
    if err:
        raise RuntimeError(f"ssd_scan launch failed: "
                           f"{lib.ssd_scan_error_string(err).decode()} "
                           f"(cudaError {err})")
    return y
