"""Depthwise convolution weight and bias gradient: the CUDA kernel and its
plain version.

The gradient of ``F.conv2d(x, w, b, stride=1, padding=(ph, pw),
groups=C)`` with respect to ``w`` and ``b``, for an odd square kernel
``k`` in :data:`KSIZES`:

    dw[c, 0, ky, kx] = sum_{n, oy, ox} g[n, c, oy, ox] * x[n, c, oy + ky - ph, ox + kx - pw]
    db[c]            = sum_{n, oy, ox} g[n, c, oy, ox]

(``x`` zero outside itself).  It has no counterpart in the JAX package,
which has no depthwise convolution; the kernel exists because cuDNN's
fp32 grouped weight gradient runs hundreds of times over its byte bound at
ConvNeXt's shapes.  The kernel is ``csrc/dwconv_wgrad.cu``, hand-written
CUDA C++ for ``sm_90a``: bound by bytes, it reads ``x`` and ``g`` once and
reuses each read from registers, and sums in a fixed order (per-lane runs,
then per CTA, then across CTAs in a second kernel), so a launch is
deterministic.  The source header has the details.  This module holds:

* :func:`dwconv_wgrad` — launches the kernel on CUDA tensors (and only on
  CUDA tensors; it raises on anything else and on a failed launch);
* :func:`dwconv_wgrad_plain` — the same sums in plain PyTorch, one tap at
  a time.  The CPU takes this path;
* :func:`channels_last` — the layout the kernel reads.

Tensors are the NCHW views of NHWC storage that the port's convs pass
(channel stride 1, column stride C); image and row strides are free, so a
row slice of a larger map is read in place.  ``dw`` comes back as the
OIHW ``(C, 1, k, k)`` view of HWIO ``(k, k, 1, C)`` storage, the layout of
the port's depthwise parameter.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

#: the kernel sizes the CUDA source is built for
KSIZES = (1, 3, 5, 7)
#: kernel launches a call of :func:`dwconv_wgrad` makes: the partial sums,
#: then their finish
LAUNCHES = 2


def _check(g, x, padding, k: int):
    if x.dim() != 4 or g.dim() != 4:
        raise ValueError(f"expected NCHW x and g, got {tuple(x.shape)} and "
                         f"{tuple(g.shape)}")
    n, c, h, w = x.shape
    ph, pw = padding
    if k not in KSIZES or ph < 0 or pw < 0:
        raise ValueError(f"k={k} padding={tuple(padding)}: the kernel takes "
                         f"k in {KSIZES} and padding >= 0")
    want = (n, c, h + 2 * ph - k + 1, w + 2 * pw - k + 1)
    if tuple(g.shape) != want:
        raise ValueError(f"g {tuple(g.shape)} is not the output {want} of x "
                         f"{tuple(x.shape)} at k={k} padding={tuple(padding)}")
    if g.device != x.device or g.dtype != x.dtype:
        raise ValueError(f"g on {g.device} ({g.dtype}) but x on {x.device} "
                         f"({x.dtype})")


def _dw_of(hwio):
    """The OIHW view of an HWIO ``(k, k, 1, C)`` tensor."""
    return hwio.permute(3, 2, 0, 1)


def dwconv_wgrad_plain(g, x, padding, k: int):
    """``(dw, db)`` in plain PyTorch: for each tap, the product of ``g``
    and the shifted window of the zero-padded ``x``, summed over the
    image, the rows and the columns."""
    _check(g, x, padding, k)
    ph, pw = padding
    ho, wo = g.shape[2], g.shape[3]
    xp = F.pad(x, (pw, pw, ph, ph))
    dw = x.new_empty((k, k, 1, x.shape[1]))
    for ky in range(k):
        for kx in range(k):
            dw[ky, kx, 0] = (g * xp[:, :, ky:ky + ho, kx:kx + wo]).sum(
                (0, 2, 3))
    return _dw_of(dw), g.sum((0, 2, 3))


def nhwc_strided(t) -> bool:
    """Whether the NCHW view ``t`` has the strides the kernel reads:
    channel stride 1 and column stride C."""
    _, c, _, w = t.shape
    return (c == 1 or t.stride(1) == 1) and (w == 1 or t.stride(3) == c)


def channels_last(t):
    """``t`` itself where :func:`nhwc_strided`, else its NHWC copy."""
    return t if nhwc_strided(t) else t.contiguous(
        memory_format=torch.channels_last)


def _lib():
    from repro_torch.kernels.build import load
    lib = load("dwconv_wgrad")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dwconv_wgrad_launch.argtypes = [p] * 5 + [i] * 6 + [ll] * 4 \
            + [i] * 4 + [p]
        lib.dwconv_wgrad_launch.restype = i
        lib.dwconv_wgrad_parts.argtypes = [i] * 4
        lib.dwconv_wgrad_parts.restype = i
        lib.dwconv_wgrad_error_string.argtypes = [i]
        lib.dwconv_wgrad_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def dwconv_wgrad(g, x, padding, k: int):
    """Launch the CUDA kernel: ``(dw, db)`` as :func:`dwconv_wgrad_plain`
    gives them, fp32.  Both tensors must lie on one CUDA device and be
    :func:`nhwc_strided`.  The partial sums take ``parts x (k^2 + 1) x C``
    floats of scratch, ``parts`` being what the kernel library picks for
    the device (about two waves of the card).  Both launches go on the
    current stream and are checked with ``cudaGetLastError``; a refused
    launch raises."""
    _check(g, x, padding, k)
    if x.device.type != "cuda":
        raise ValueError(f"dwconv_wgrad launches on CUDA tensors only, got "
                         f"{x.device}; the plain version is "
                         f"dwconv_wgrad_plain")
    if x.dtype != torch.float32:
        raise TypeError(f"dwconv_wgrad is fp32-only, got {x.dtype}")
    if not (nhwc_strided(x) and nhwc_strided(g)):
        raise ValueError(f"dwconv_wgrad reads NHWC storage (channel stride "
                         f"1, column stride C), got strides {x.stride()} "
                         f"and {g.stride()}")
    n, c, h, w = x.shape
    ho, wo = g.shape[2], g.shape[3]
    ph, pw = padding
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        parts = lib.dwconv_wgrad_parts(n, c, ho, k)
        if parts < 1:
            raise RuntimeError(f"dwconv_wgrad cannot size a launch of "
                               f"{tuple(x.shape)} at k={k}")
        part = torch.empty(parts * (k * k + 1) * c, device=x.device,
                           dtype=torch.float32)
        dw = torch.empty((k, k, 1, c), device=x.device, dtype=torch.float32)
        db = torch.empty(c, device=x.device, dtype=torch.float32)
        err = lib.dwconv_wgrad_launch(
            x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(),
            db.data_ptr(), n, c, h, w, ho, wo, x.stride(0), x.stride(2),
            g.stride(0), g.stride(2), k, ph, pw, parts, stream)
    if err:
        raise RuntimeError(f"dwconv_wgrad launch failed: "
                           f"{lib.dwconv_wgrad_error_string(err).decode()} "
                           f"(cudaError {err})")
    return _dw_of(dw), db
