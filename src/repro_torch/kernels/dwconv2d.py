"""Stride-1 depthwise convolution, forward and data gradient: the CUDA
kernel and its plain version.

``F.conv2d(x, w, b, stride=1, padding=(ph, pw), groups=C)`` for an odd
square kernel ``k`` in :data:`KSIZES` and ``0 <= ph, pw <= k - 1``:

    y[n, c, oy, ox] = b[c] + sum_{ky, kx} x[n, c, oy + ky - ph, ox + kx - pw] * w[c, 0, ky, kx]

(``x`` zero outside itself).  With ``flip`` the filter is read flipped,
``w[c, 0, k - 1 - ky, k - 1 - kx]``: the data gradient of the conv at
padding ``p`` is this conv of its output's gradient at padding ``k - 1 -
p``, so one kernel serves both passes.  It has no counterpart in the JAX
package, which has no depthwise convolution; the kernel exists because
cuDNN's fp32 depthwise forward and data gradient run about ten times over
their byte bound at ConvNeXt's shapes.  The kernel is ``csrc/dwconv2d.cu``,
hand-written CUDA C++ for ``sm_90a``: bound by bytes, it reads the input
about once and reuses each read from registers or L1, and each output is
one thread's sum in a fixed order, so a launch is deterministic.  The
source header has the details.  This module holds:

* :func:`dwconv2d` — launches the kernel on CUDA tensors (and only on CUDA
  tensors; it raises on anything else and on a failed launch);
* :func:`dwconv2d_plain` — the same sums in plain PyTorch, one tap at a
  time.  The CPU takes this path.

``x`` is the NCHW view of NHWC storage that the port's convs pass (channel
stride 1, column stride C; :func:`~repro_torch.kernels.dwconv_wgrad.
nhwc_strided`); its image and row strides are free, so a row slice of a
larger map is read in place.  ``w`` is the OIHW ``(C, 1, k, k)`` view of
the HWIO ``(k, k, 1, C)`` parameter.  ``y`` comes back as the NCHW view of
packed NHWC storage, the layout ``F.conv2d`` returns for such an input.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels.dwconv_wgrad import KSIZES, nhwc_strided

#: kernel launches a call of :func:`dwconv2d` makes
LAUNCHES = 1


def _out_hw(x, padding, k: int):
    """``(Ho, Wo)`` of the stride-1 conv of ``x`` at ``padding``."""
    return (x.shape[2] + 2 * padding[0] - k + 1,
            x.shape[3] + 2 * padding[1] - k + 1)


def _check(x, w, b, padding):
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"expected NCHW x and OIHW w, got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    c, k = x.shape[1], w.shape[-1]
    ph, pw = padding
    if k not in KSIZES or not (0 <= ph < k and 0 <= pw < k):
        raise ValueError(f"k={k} padding={tuple(padding)}: the kernel takes "
                         f"k in {KSIZES} and 0 <= padding <= k - 1")
    if tuple(w.shape) != (c, 1, k, k):
        raise ValueError(f"w {tuple(w.shape)} is not the depthwise filter "
                         f"{(c, 1, k, k)} of x {tuple(x.shape)}")
    if b is not None and tuple(b.shape) != (c,):
        raise ValueError(f"b {tuple(b.shape)} is not a bias of {c} channels")
    if min(_out_hw(x, padding, k)) < 1:
        raise ValueError(f"x {tuple(x.shape)} has no output at k={k} "
                         f"padding={tuple(padding)}")
    for t in (w, b):
        if t is not None and (t.device != x.device or t.dtype != x.dtype):
            raise ValueError(f"x on {x.device} ({x.dtype}) but its filter "
                             f"or bias on {t.device} ({t.dtype})")


def dwconv2d_plain(x, w, b, padding, flip: bool = False):
    """``y`` in plain PyTorch: for each tap, the shifted window of the
    zero-padded ``x`` times the tap's weight, added to an NHWC buffer; the
    bias last."""
    _check(x, w, b, padding)
    ph, pw = padding
    n, c = x.shape[:2]
    k = w.shape[-1]
    ho, wo = _out_hw(x, padding, k)
    if flip:
        w = w.flip(2, 3)
    xp = F.pad(x, (pw, pw, ph, ph))
    y = x.new_zeros((n, ho, wo, c)).permute(0, 3, 1, 2)
    for ky in range(k):
        for kx in range(k):
            y.addcmul_(xp[:, :, ky:ky + ho, kx:kx + wo],
                       w[:, 0, ky, kx].view(1, c, 1, 1))
    if b is not None:
        y.add_(b.view(1, c, 1, 1))
    return y


def _lib():
    from repro_torch.kernels.build import load
    lib = load("dwconv2d")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dwconv2d_launch.argtypes = [p] * 4 + [i] * 6 + [ll] * 2 \
            + [i] * 4 + [p]
        lib.dwconv2d_launch.restype = i
        lib.dwconv2d_error_string.argtypes = [i]
        lib.dwconv2d_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _hwio_strided(w) -> bool:
    """Whether the OIHW view ``w`` is the view of HWIO storage, the
    layout the kernel reads its taps from."""
    return w.permute(2, 3, 1, 0).is_contiguous()


def dwconv2d(x, w, b, padding, flip: bool = False):
    """Launch the CUDA kernel: ``y`` as :func:`dwconv2d_plain` gives it,
    fp32.  The tensors must lie on one CUDA device, ``x`` be
    :func:`~repro_torch.kernels.dwconv_wgrad.nhwc_strided`, ``w`` a view
    of HWIO storage and ``b`` (or None) contiguous.  The launch goes on the
    current stream and is checked with ``cudaGetLastError``; a refused
    launch raises."""
    _check(x, w, b, padding)
    if x.device.type != "cuda":
        raise ValueError(f"dwconv2d launches on CUDA tensors only, got "
                         f"{x.device}; the plain version is dwconv2d_plain")
    if x.dtype != torch.float32:
        raise TypeError(f"dwconv2d is fp32-only, got {x.dtype}")
    if not (nhwc_strided(x) and _hwio_strided(w)
            and (b is None or b.is_contiguous())):
        raise ValueError(f"dwconv2d reads NHWC x (channel stride 1, column "
                         f"stride C), HWIO w and a contiguous b, got "
                         f"strides {x.stride()}, {w.stride()} and "
                         f"{None if b is None else b.stride()}")
    n, c, h, wd = x.shape
    k = w.shape[-1]
    ho, wo = _out_hw(x, padding, k)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        y = torch.empty((n, ho, wo, c), device=x.device, dtype=torch.float32)
        err = lib.dwconv2d_launch(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            y.data_ptr(), n, c, h, wd, ho, wo, x.stride(0), x.stride(2), k,
            padding[0], padding[1], int(flip), stream)
    if err:
        raise RuntimeError(f"dwconv2d launch failed: "
                           f"{lib.dwconv2d_error_string(err).decode()} "
                           f"(cudaError {err})")
    return y.permute(0, 3, 1, 2)
