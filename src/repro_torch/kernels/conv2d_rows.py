"""Row-block convolution: the CUDA kernel and its plain version.

Counterpart of ``repro.kernels.conv2d_rows`` (the Pallas TPU kernel,
``_conv_kernel``).  The kernel itself is ``csrc/conv2d_rows.cu``,
hand-written CUDA C++ for ``sm_90a`` in fp32.  It is bound by operations
on the SIMT fp32 pipe (TF32 on the tensor cores would break the 1e-4
parity), so its design keeps that pipe fed: an implicit GEMM over the
row-centric tiling, one CTA per (``block_h`` rows x a column tile, 64 or
128 output channels), 8 x 8 accumulators a thread fed by float4 reads of
shared memory, and each Cin chunk's halo'd input window and weights
streamed through a 2-stage ``cp.async`` ring that overlaps the copy of one
chunk with the FMAs of the one before.  The source header has the details.
This module holds:

* :func:`conv2d_rows` — launches the kernel on CUDA tensors (and only on
  CUDA tensors; it raises on anything else and on a failed launch);
* :func:`conv2d_rows_plain` — the same computation in plain PyTorch with
  the kernel's index math: output row blocks of ``block_h``, each reading
  its own halo'd input rows with zero rows where the window leaves the
  tensor.  The CPU takes this path, and it is what the kernel is checked
  against on the card;
* :func:`halo_ok`, :func:`tile_w`, :func:`smem_bytes` and
  :func:`launch_problem` — the geometry the planner prices.

``halo_ok`` is kept from the reference as the engines' layer-eligibility
rule, so the port picks the same layers; the CUDA kernel itself has no
halo limit (each CTA loads its own halo).
"""

from __future__ import annotations

import ctypes

import torch

#: output pixels one CTA computes (block_h rows x tile_w columns)
CTA_PIXELS = 128
#: output channels per CTA: the wide tile, and the narrow one for Cout <= 64
CTA_COUT = 128
CTA_COUT_NARROW = 64
#: input channels per shared-memory chunk (the narrow one only where the
#: wide one overflows shared memory), and chunks in flight
CIN_CHUNKS = (8, 4)
STAGES = 2
#: shared memory one CTA may use on Hopper (227 KiB)
SMEM_LIMIT = 232448


def halo_ok(k: int, stride: int, block_h: int,
            h_out: int | None = None) -> bool:
    """The reference's eligibility rule: ``(k - stride) <= block_h *
    stride`` at the clamped block ``min(block_h, h_out)``."""
    if h_out is not None:
        block_h = min(block_h, h_out)
    return (k - stride) <= block_h * stride


def out_size(n: int, k: int, stride: int, padding: int) -> int:
    return (n + 2 * padding - k) // stride + 1


def tile_w(block_h: int) -> int:
    """Output columns per CTA: as many as fit ``CTA_PIXELS`` beside
    ``block_h`` rows."""
    return max(1, CTA_PIXELS // block_h)


def cout_tile(cout: int) -> int:
    """Output channels per CTA: the narrow tile when it covers ``cout``."""
    return CTA_COUT_NARROW if cout <= CTA_COUT_NARROW else CTA_COUT


def _smem(block_h: int, stride: int, k: int, co: int, cc: int) -> int:
    rows = (block_h - 1) * stride + k
    cols = (tile_w(block_h) - 1) * stride + k
    return 4 * (rows * cols + STAGES * (rows * cols * cc + k * k * cc * co))


def cin_chunk(block_h: int, stride: int, k: int, cout: int) -> int:
    """Input channels per chunk: 8 when that fits a CTA's 227 KiB, else 4
    (the CUDA source picks the same, whatever limit the planner prices)."""
    wide, narrow = CIN_CHUNKS
    return wide if _smem(block_h, stride, k, cout_tile(cout), wide) \
        <= SMEM_LIMIT else narrow


def smem_bytes(block_h: int, stride: int, k: int, cout: int) -> int:
    """Dynamic shared memory of one CTA: the halo'd window's offset table
    plus ``STAGES`` x (the input window of one Cin chunk + that chunk's
    weights) (``conv2d_rows_smem_bytes`` in the CUDA source computes the
    same)."""
    return _smem(block_h, stride, k, cout_tile(cout),
                 cin_chunk(block_h, stride, k, cout))


def launch_problem(block_h: int, stride: int, k: int, cout: int,
                   dtype_bytes: int = 4, smem_limit: int = SMEM_LIMIT) -> str:
    """Why the kernel cannot run this geometry ("" when it can): it takes
    fp32 only, at most ``CTA_PIXELS`` rows per block, and one CTA's shared
    memory must fit ``smem_limit`` (Hopper's 227 KiB by default)."""
    if dtype_bytes != 4:
        return f"the CUDA conv kernel is fp32-only (dtype_bytes={dtype_bytes})"
    if not 1 <= block_h <= CTA_PIXELS:
        return f"block_h={block_h} outside 1..{CTA_PIXELS}"
    smem = smem_bytes(block_h, stride, k, cout)
    if smem > smem_limit:
        return (f"CTA shared memory {smem} B exceeds the {smem_limit}-byte "
                f"limit")
    return ""


def _check(x, w, stride, padding, block_h):
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"expected NHWC x and HWIO w, got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    kh, kw, cin, _ = w.shape
    if kh != kw or cin != x.shape[3]:
        raise ValueError(f"weight {tuple(w.shape)} does not fit input "
                         f"{tuple(x.shape)} (square HWIO kernel expected)")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"conv2d_rows is fp32-only, got {x.dtype}/{w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    if stride < 1 or padding < 0 or block_h < 1:
        raise ValueError(f"bad stride={stride} padding={padding} "
                         f"block_h={block_h}")
    h_out = out_size(x.shape[1], kh, stride, padding)
    w_out = out_size(x.shape[2], kh, stride, padding)
    if h_out < 1 or w_out < 1:
        raise ValueError(f"k={kh} s={stride} p={padding} collapses input "
                         f"{tuple(x.shape)}")
    return kh, h_out, w_out, min(block_h, h_out)


def conv2d_rows_plain(x, w, stride: int = 1, padding: int = 0,
                      block_h: int = 8):
    """The kernel's computation in plain PyTorch, one output row block at
    a time: each block reads input rows ``[oh0*s - p, oh0*s - p + n_in)``
    with zero rows outside ``[0, H)``, then accumulates ``k*k`` fp32
    matmuls ``(B*rows*W_out, Cin) x (Cin, Cout)``."""
    k, h_out, w_out, bh = _check(x, w, stride, padding, block_h)
    B, H, _, cin = x.shape
    cout = w.shape[3]
    s, p = stride, padding
    xw = torch.nn.functional.pad(x, (0, 0, p, p))  # W padding once
    out = x.new_empty((B, h_out, w_out, cout))
    for oh0 in range(0, h_out, bh):
        rows = min(bh, h_out - oh0)
        ih0 = oh0 * s - p
        n_in = (rows - 1) * s + k
        lo, hi = max(ih0, 0), min(ih0 + n_in, H)
        blk = x.new_zeros((B, n_in, xw.shape[2], cin))
        blk[:, lo - ih0:hi - ih0] = xw[:, lo:hi]
        acc = x.new_zeros((B * rows * w_out, cout))
        for ki in range(k):
            for kj in range(k):
                patch = blk[:, ki:ki + (rows - 1) * s + 1:s,
                            kj:kj + (w_out - 1) * s + 1:s]
                acc += patch.reshape(-1, cin) @ w[ki, kj]
        out[:, oh0:oh0 + rows] = acc.view(B, rows, w_out, cout)
    return out


def _lib():
    from repro_torch.kernels.build import load
    lib = load("conv2d_rows")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conv2d_rows_launch.argtypes = [p, p, p] + [i] * 12 + [p]
        lib.conv2d_rows_launch.restype = i
        lib.conv2d_rows_smem_bytes.argtypes = [i, i, i, i, i]
        lib.conv2d_rows_smem_bytes.restype = ctypes.c_longlong
        lib.conv2d_rows_error_string.argtypes = [i]
        lib.conv2d_rows_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def conv2d_rows(x, w, *, stride: int = 1, padding: int = 0,
                block_h: int = 8):
    """Launch the CUDA kernel: NHWC x HWIO -> NHWC, symmetric padding,
    fp32.  Both tensors must be contiguous fp32 on one CUDA device.  The
    launch goes on the current stream and is checked with
    ``cudaGetLastError``; a refused launch raises."""
    k, h_out, w_out, bh = _check(x, w, stride, padding, block_h)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_rows launches on CUDA tensors only, got "
                         f"{x.device}; the plain version is "
                         f"conv2d_rows_plain")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv2d_rows needs contiguous NHWC x and HWIO w")
    problem = launch_problem(bh, stride, k, w.shape[3])
    if problem:
        raise ValueError(problem)
    B, H, W, cin = x.shape
    cout = w.shape[3]
    y = torch.empty((B, h_out, w_out, cout), device=x.device,
                    dtype=torch.float32)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.conv2d_rows_launch(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), B, H, W, cin, cout,
            h_out, w_out, k, stride, padding, bh, tile_w(bh), stream)
    if err:
        raise RuntimeError(f"conv2d_rows launch failed: "
                           f"{lib.conv2d_rows_error_string(err).decode()} "
                           f"(cudaError {err})")
    return y
