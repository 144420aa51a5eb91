"""Mamba2 SSD recurrence: the CUDA kernel and its plain version.

Counterpart of ``repro.kernels.ssd_chunk`` (the Pallas TPU kernel, which
walks sequence chunks in order with the state in VMEM scratch).  The kernel
is ``csrc/ssd_scan.cu`` (hand-written CUDA C++ for ``sm_90a``, fp32): it runs
the recurrence step by step with each state row in registers; its header
says what bounds it.  The TPU kernel's chunked form (``(c, c)`` decay times
the ``C Bᵀ`` Gram matrix) is a tiling for the MXU, not the function, so the
port has no chunk parameter.  This module holds:

* :func:`ssd_scan` — launches the kernel on CUDA tensors (only there; it
  raises on anything else and on a failed launch);
* :func:`ssd_scan_plain` — the plain version: the sequential reference
  recurrence (:func:`repro_torch.kernels.ref.ssd_scan_ref`).  The CPU takes
  this path, and it is what the kernel is checked against on the card.
"""

from __future__ import annotations

import ctypes

import torch

#: state values one lane may hold (N / lanes-per-row)
MAX_PER_LANE = 16


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


def group_lanes(n: int) -> int:
    """Lanes that share one state row: the largest power of two <= 8 that
    divides ``n`` (``ssd_scan_group_lanes`` in the CUDA source)."""
    g = 8
    while n % g:
        g //= 2
    return g


def launch_problem(n: int) -> str:
    """Why the kernel cannot run state size ``n`` ("" when it can)."""
    if n < 1 or n // group_lanes(n) > MAX_PER_LANE:
        return (f"state size N={n} needs more than {MAX_PER_LANE} values "
                f"per lane")
    return ""


def ssd_scan_plain(x, B, C, a, dt):
    """``y`` of the sequential reference recurrence (the kernel's plain
    version)."""
    from repro_torch.kernels.ref import ssd_scan_ref
    _check(x, B, C, a, dt)
    return ssd_scan_ref(x, B, C, a, dt)[0]


def _lib():
    from repro_torch.kernels.build import load
    lib = load("ssd_scan")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_launch.argtypes = [p] * 6 + [i] * 5 + [p]
        lib.ssd_scan_launch.restype = i
        lib.ssd_scan_group_lanes.argtypes = [i]
        lib.ssd_scan_group_lanes.restype = i
        lib.ssd_scan_error_string.argtypes = [i]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def ssd_scan(x, B, C, a, dt):
    """Launch the CUDA kernel: contiguous fp32 ``x (Bt, S, H, P)``, ``B``/``C
    (Bt, S, N)``, ``a``/``dt (Bt, S, H)`` on one CUDA device -> ``y`` like
    ``x``.  The launch goes on the current stream and is checked with
    ``cudaGetLastError``; a refused launch raises."""
    _check(x, B, C, a, dt)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan launches on CUDA tensors only, got "
                         f"{x.device}; the plain version is ssd_scan_plain")
    if not all(t.is_contiguous() for t in (x, B, C, a, dt)):
        raise ValueError("ssd_scan needs contiguous x, B, C, a, dt")
    Bt, S, H, P = x.shape
    N = B.shape[2]
    problem = launch_problem(N)
    if problem:
        raise ValueError(problem)
    y = torch.empty_like(x)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_launch(x.data_ptr(), B.data_ptr(), C.data_ptr(),
                                  a.data_ptr(), dt.data_ptr(), y.data_ptr(),
                                  Bt, S, H, P, N, stream)
    if err:
        raise RuntimeError(f"ssd_scan launch failed: "
                           f"{lib.ssd_scan_error_string(err).decode()} "
                           f"(cudaError {err})")
    return y
