"""Interval-aware CNN layers (NHWC) for row-centric execution.

Counterpart of ``repro.models.cnn.layers``.  Every module implements the
protocol the row engines (:mod:`repro_torch.core.overlap`) need:

* ``init(generator, in_shape, device) -> params``   (in_shape = (H, W, C))
* ``out_shape(in_shape) -> (H', W', C')``
* ``apply(params, x) -> y``                 column-centric, full tensor
* ``in_interval(out_iv, h_in) -> Interval``  H-rows needed for an output iv
* ``apply_row(params, x, iv_in, h_in, out_iv) -> y``
      ``x`` covers global input rows ``iv_in``; returns exactly the rows
      ``out_iv`` of the global output, computed with semi-closed padding.

Params are plain dicts of tensors (nested for a ``Bottleneck``).
Activations are NHWC and conv weights HWIO, as in the reference; the
``torch.nn.functional`` calls see NCHW/OIHW views of the same storage.
``F.conv2d`` and ``F.max_pool2d`` only pad symmetrically: the conv gets row
mode's asymmetric H padding (``pad_for_slice``) by dropping output rows
where it can (see ``Conv._conv``), the pool by an explicit ``-inf``
``F.pad``.  The pool's backward re-derives the argmax from its saved input
(:class:`_MaxPool2d`) instead of keeping autograd's int64 indices from the
forward, as the reference's XLA VJP keeps none.  Every conv, the
``overlap_cuda`` engine's kernel layers too, goes through :func:`conv2d`,
the one place that picks a conv's forward and gradient kernels (with
:func:`conv_backward`).  A grouped conv (``DepthwiseConv``, ConvNeXt's
7x7) runs inside a ``dwconv`` range, forward and backward, and counts its
forward calls (``conv.depthwise_calls``); a stride-1 depthwise one runs on
the port's depthwise kernels in both (:func:`_depthwise`).

Norm note (as in the reference): ``BatchNorm`` normalises with the running
statistics held in the parameter tree, so row-centric and column-centric
execution agree; they are trainable leaves like any other.  Batch moments
for exact global statistics are :func:`batch_moments` and
:func:`merge_moments` (Chan's merge of per-row moments).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import ClassVar, List, Sequence, Tuple

import torch
import torch.nn.functional as F

import numpy as np

from repro_torch import obs
from repro_torch.core.convmath import (
    Geometry, Interval, backward_intervals, interval_union,
)
from repro_torch.kernels import dwconv2d as _dwc
from repro_torch.kernels import ops


def _he_init(generator, shape, fan_in, device):
    w = torch.randn(shape, generator=generator, dtype=torch.float32)
    return (w * math.sqrt(2.0 / fan_in)).to(device)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _slice_rows(y, off: int, n: int):
    return y[:, off:off + n]


# ---------------------------------------------------------------------------
# The conv op: forward and gradient routing
# ---------------------------------------------------------------------------

#: Tensor bytes (the conv's input or output) above which its data gradient
#: runs in batch chunks.  cuDNN's fast dgrads (FFT, implicit GEMM) want a
#: workspace of 2-4.5x the tensor.  Where its allocation fails, PyTorch
#: tries the next engine and keeps for the shape the first that runs; the
#: last, ``dgrad2d_grouped_direct_kernel``, needs none and runs at ~2.3
#: TFLOP/s.  In VGG-16's 2PS N=2 step at batch 768, conv1_2's row-0 dgrad
#: (9.56 GB in and out) asked for 17.2-18.0 GB eight times with 6.0 GB
#: free and fell back: 5.7 s of an 8.5 s step.  Its row-0 convs of 2.25-4.76
#: GB got their 6-11 GB there; the limit splits them too, as a margin for
#: a step with less memory free, at ~9 % of their dgrad time where memory
#: is ample.  The bytes stand for the workspace, since the forward, which
#: picks the path, cannot see the memory free at the backward.  The b64
#: and b256 training steps' largest tensor is 0.82 GB.  (tools/conv_dgrad.py
#: and an out-of-memory observer on that step; NVIDIA H100 80GB HBM3,
#: 700 W, cuDNN 9.22.)
DGRAD_SPLIT_BYTES = 2 ** 31
#: Most bytes of the larger of a chunk's input and output.  Every chunk
#: holds a power of two of images (cuDNN picks slow engines for some odd
#: counts): the largest that fits, and a remainder in its binary digits.
#: At 1 GiB the six split convs of that step take 209 ms in chunks against
#: 192 ms in one call each, with 1.8-3.7 GB of workspace a chunk; at
#: 256 MiB, 318 ms (conv1_2 and conv2_1 drop to implicit-GEMM engines).
DGRAD_CHUNK_BYTES = 2 ** 30


def _pow2_floor(n: int) -> int:
    return 1 << max(0, n.bit_length() - 1)


def _splits_dgrad(x, out_numel: int) -> bool:
    return x.shape[0] > 1 and max(x.numel(), out_numel) \
        * x.element_size() > DGRAD_SPLIT_BYTES


def _depthwise(x, w, stride: int, padding, groups: int) -> bool:
    """Whether the conv is one the depthwise kernels compute, its forward
    and data gradient (:func:`repro_torch.kernels.ops.dwconv2d`) and its
    weight and bias gradients (:func:`repro_torch.kernels.ops.
    dwconv_wgrad`): depthwise (``groups`` = input = output channels),
    stride 1, an odd square kernel ``k`` of
    :data:`~repro_torch.kernels.dwconv2d.KSIZES`, ``0 <= padding <= k -
    1``."""
    k = w.shape[-1]
    return (groups > 1 and groups == x.shape[1] == w.shape[0]
            and w.shape[1] == 1 and stride == 1
            and w.shape[2] == k in _dwc.KSIZES
            and all(0 <= p < k for p in padding))


def conv_backward(g, x, w, stride: int, padding, need, groups: int = 1):
    """``(dx, dw, db)`` of ``F.conv2d(x, w, b, stride, padding, groups)``
    against ``g`` (NCHW views; ``need``: which of x, w, b want a gradient,
    the others come back None), chosen apart:

    * where :func:`_depthwise` admits the conv (cuDNN's fp32 depthwise
      gradients run ten to hundreds of times over their byte bound at
      ConvNeXt's shapes), ``dw`` and ``db`` from
      :func:`repro_torch.kernels.ops.dwconv_wgrad`, then ``dx`` from
      :func:`repro_torch.kernels.ops.dwconv2d`: the conv of ``g`` with the
      filter flipped at padding ``k - 1 - p``, which needs no workspace;
    * else all three from ``aten``; ``dx``, where the batch is above 1 and
      ``x`` or ``g`` exceeds :data:`DGRAD_SPLIT_BYTES`, into an NHWC
      buffer chunk by chunk along the batch (an image's data
      gradient depends on that image alone), each chunk a power of two of
      images within :data:`DGRAD_CHUNK_BYTES` (counter
      ``conv.dgrad_chunks``; range ``conv_dgrad_split`` from the
      whole-batch call on).

    What ``aten`` owes is one ``aten.convolution_backward`` over the whole
    batch, as autograd's ``ConvolutionBackward0`` issues it, before the
    chunks."""
    args = ([stride, stride], list(padding), [1, 1], False, [0, 0], groups)
    kernel = _depthwise(x, w, stride, padding, groups)
    split = need[0] and not kernel and _splits_dgrad(x, g.numel())
    owed = [need[0] and not (kernel or split), need[1] and not kernel,
            need[2] and not kernel]
    grads = [None, None, None]
    if kernel:
        k = w.shape[-1]
        if need[1] or need[2]:
            dw, db = ops.dwconv_wgrad(g, x, args[1], k)
            grads[1:] = [dw if need[1] else None, db if need[2] else None]
        if need[0]:
            grads[0] = ops.dwconv2d(g, w, None, [k - 1 - p for p in padding],
                                    flip=True)
    with (obs.profile_range("conv_dgrad_split") if split
          else contextlib.nullcontext()):
        if any(owed):
            got = torch.ops.aten.convolution_backward(
                g, x, w, [w.shape[0]] if owed[2] else None, *args, owed)
            grads = [a if o else b for a, o, b in zip(got, owed, grads)]
        if split:
            n, c, h, wd = x.shape
            grads[0] = x.new_empty((n, h, wd, c)).permute(0, 3, 1, 2)
            per_image = max(x[0].numel(), g[0].numel()) * x.element_size()
            step = _pow2_floor(DGRAD_CHUNK_BYTES // per_image)
            i = 0
            while i < n:
                k = min(step, _pow2_floor(n - i))
                grads[0][i:i + k].copy_(torch.ops.aten.convolution_backward(
                    g[i:i + k], x[i:i + k], w, None, *args,
                    [True, False, False])[0])
                i += k
                obs.counter("conv.dgrad_chunks").inc()
    return tuple(grads)


class _Conv2d(torch.autograd.Function):
    """:func:`conv2d`'s Function: forward the ``dwconv2d`` kernel where
    :func:`_depthwise` admits the conv, ``F.conv2d`` or, at a ``block_h``,
    ``conv2d_rows`` on the views' NHWC/HWIO storage and a bias add;
    backward :func:`conv_backward` (in a ``dwconv`` range if grouped).  It
    saves what ``ConvolutionBackward0`` saves, the input and the weight."""

    @staticmethod
    def forward(ctx, xc, w, b, stride: int, padding, groups: int, block_h):
        ctx.save_for_backward(xc, w)
        ctx.stride, ctx.padding, ctx.groups = stride, padding, groups
        if _depthwise(xc, w, stride, padding, groups):
            return ops.dwconv2d(xc, w, b, padding)
        if block_h is None:
            return F.conv2d(xc, w, b, stride=stride, padding=padding,
                            groups=groups)
        y = ops.conv2d(_nhwc(xc).contiguous(),
                       w.permute(2, 3, 1, 0).contiguous(), stride,
                       padding[1], block_h)
        return _nchw(y + b if b is not None else y)

    @staticmethod
    def backward(ctx, g):
        xc, w = ctx.saved_tensors
        with (obs.profile_range("dwconv", phase="bwd") if ctx.groups > 1
              else contextlib.nullcontext()):
            grads = conv_backward(g, xc, w, ctx.stride, ctx.padding,
                                  ctx.needs_input_grad[:3], ctx.groups)
        return (*grads, None, None, None, None)


def _will_split(xc, w, stride: int, padding) -> bool:
    """Whether autograd will want ``xc``'s gradient, split in chunks."""
    if not (torch.is_grad_enabled() and xc.requires_grad):
        return False
    k = w.shape[-1]
    hw = [Geometry(k, stride, p).out_size(d)
          for p, d in zip(padding, xc.shape[2:])]
    return _splits_dgrad(xc, xc.shape[0] * w.shape[0] * math.prod(hw))


def conv2d(xc, w, b, stride: int, padding, groups: int = 1, block_h=None):
    """The CNN path's one conv, ``F.conv2d(xc, w, b, stride, padding,
    groups)`` on NCHW views (``padding`` an (H, W) pair), or the
    ``conv2d_rows`` kernel (symmetric padding) at row block ``block_h``.
    The kernel, a grouped conv, and a dense conv whose input's gradient
    autograd will want and :func:`conv_backward` will split go through
    :class:`_Conv2d`; any other conv is plain ``F.conv2d``, with autograd's
    own backward.  A grouped conv's forward runs inside a ``dwconv`` range
    (phase ``fwd``), counted by ``conv.depthwise_calls``."""
    if groups > 1:
        obs.counter("conv.depthwise_calls").inc()
        with obs.profile_range("dwconv", phase="fwd"):
            return _Conv2d.apply(xc, w, b, stride, padding, groups, None)
    if block_h is None and not _will_split(xc, w, stride, padding):
        return F.conv2d(xc, w, b, stride=stride, padding=padding)
    return _Conv2d.apply(xc, w, b, stride, padding, 1, block_h)


# ---------------------------------------------------------------------------
# Primitive modules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Conv:
    """2-D convolution, square kernel, symmetric W padding, semi-closed H
    padding in row mode.  ``groups`` splits the channels as ``F.conv2d``
    does, 1 here (see :class:`DepthwiseConv`); the HWIO weight's I is
    ``cin // groups``."""

    cout: int
    k: int = 3
    s: int = 1
    p: int = 1
    bias: bool = True
    groups: ClassVar[int] = 1

    @property
    def geometry(self) -> Geometry:
        return Geometry(self.k, self.s, self.p)

    def init(self, generator, in_shape, device="cuda"):
        cin = in_shape[2] // self.groups
        params = {"w": _he_init(generator, (self.k, self.k, cin, self.cout),
                                self.k * self.k * cin, device)}
        if self.bias:
            params["b"] = torch.zeros(self.cout, device=device)
        return params

    def out_shape(self, in_shape):
        h, w, _ = in_shape
        g = self.geometry
        return (g.out_size(h), g.out_size(w), self.cout)

    def in_interval(self, out_iv: Interval, h_in: int) -> Interval:
        return self.geometry.in_interval(out_iv, h_in)

    def _conv(self, params, x, pad_h, block_h=None):
        """Conv with H padding ``pad_h`` (top, bottom), W padding ``p``,
        through :func:`conv2d`.

        A seam's missing padding is had without copying the slice: the
        conv runs with the symmetric ``p`` and the output rows that read
        top padding are dropped (rows past a missing bottom pad are
        never selected by ``apply_row``).  Only when the top shift is not
        a whole number of strides does the slice get an explicit
        ``F.pad``."""
        xc = _nchw(x)
        w = params["w"].permute(3, 2, 0, 1)
        b = params.get("b") if self.bias else None
        shift, rem = divmod(self.p - pad_h[0], self.s)
        if rem == 0:
            y = conv2d(xc, w, b, self.s, (self.p, self.p), self.groups,
                       block_h)
            return _nhwc(y)[:, shift:]
        xc = F.pad(xc, (0, 0, pad_h[0], pad_h[1]))
        return _nhwc(conv2d(xc, w, b, self.s, (0, self.p), self.groups))

    def apply(self, params, x, block_h=None):
        """The whole conv; at a ``block_h``, by ``conv2d_rows`` (dense)."""
        return self._conv(params, x, (self.p, self.p), block_h)

    def apply_row(self, params, x, iv_in, h_in, out_iv):
        g = self.geometry
        y = self._conv(params, x, g.pad_for_slice(iv_in, h_in))
        off = out_iv[0] - g.first_out_of_slice(iv_in[0])
        n = out_iv[1] - out_iv[0]
        assert off >= 0 and off + n <= y.shape[1], (off, n, y.shape, iv_in,
                                                    out_iv, h_in)
        return _slice_rows(y, off, n)


@dataclasses.dataclass(frozen=True)
class DepthwiseConv(Conv):
    """One ``k``x``k`` filter per channel (``groups = cin = cout``), as
    ConvNeXt's 7x7; HWIO weight ``(k, k, 1, cout)``."""

    @property
    def groups(self) -> int:
        return self.cout


def dense_conv(m) -> bool:
    """Whether ``m`` is a dense :class:`Conv` (``groups`` 1), the only conv
    the ``conv2d_rows`` kernel and a column split take; seen through a
    ``ColumnParallel``, which keeps the module it wraps as ``inner``."""
    m = getattr(m, "inner", m)
    return isinstance(m, Conv) and m.groups == 1


class _MaxPool2d(torch.autograd.Function):
    """``F.max_pool2d`` (NCHW view, no padding) that saves only its input.

    Autograd's own max pool keeps int64 argmax indices the size of its
    output from the forward to the backward — 8 bytes an element, twice
    the fp32 output, 392 MB for VGG-16's five pools at 224², batch 32.  The
    input is kept anyway (it is the ReLU output the ReLU saves), so the
    backward recomputes the indices from it and calls the same backward
    kernel: the gradient is bit-identical, first maximum of a window
    first, as in the reference's select-and-scatter."""

    @staticmethod
    def forward(ctx, xc, k: int, s: int):
        ctx.save_for_backward(xc)
        ctx.k, ctx.s = k, s
        return F.max_pool2d(xc, k, s)

    @staticmethod
    def backward(ctx, g):
        (xc,) = ctx.saved_tensors
        k, s = ctx.k, ctx.s
        _, idx = F.max_pool2d(xc, k, s, return_indices=True)
        dx = torch.ops.aten.max_pool2d_with_indices_backward(
            g, xc, [k, k], [s, s], [0, 0], [1, 1], False, idx)
        return dx, None, None


@dataclasses.dataclass(frozen=True)
class MaxPool:
    k: int = 2
    s: int = 2
    p: int = 0

    @property
    def geometry(self) -> Geometry:
        return Geometry(self.k, self.s, self.p)

    def init(self, generator, in_shape, device="cuda"):
        return {}

    def out_shape(self, in_shape):
        h, w, c = in_shape
        g = self.geometry
        return (g.out_size(h), g.out_size(w), c)

    def in_interval(self, out_iv, h_in):
        return self.geometry.in_interval(out_iv, h_in)

    def _pool(self, x, pad_h):
        xc = _nchw(x)
        if pad_h != (0, 0) or self.p:
            xc = F.pad(xc, (self.p, self.p, pad_h[0], pad_h[1]),
                       value=-math.inf)
        return _nhwc(_MaxPool2d.apply(xc, self.k, self.s))

    def apply(self, params, x):
        return self._pool(x, (self.p, self.p))

    def apply_row(self, params, x, iv_in, h_in, out_iv):
        g = self.geometry
        y = self._pool(x, g.pad_for_slice(iv_in, h_in))
        off = out_iv[0] - g.first_out_of_slice(iv_in[0])
        return _slice_rows(y, off, out_iv[1] - out_iv[0])


@dataclasses.dataclass(frozen=True)
class ReLU:
    def init(self, generator, in_shape, device="cuda"):
        return {}

    def out_shape(self, in_shape):
        return in_shape

    def in_interval(self, out_iv, h_in):
        return out_iv

    def apply(self, params, x):
        return torch.relu(x)

    def apply_row(self, params, x, iv_in, h_in, out_iv):
        off = out_iv[0] - iv_in[0]
        return _slice_rows(torch.relu(x), off, out_iv[1] - out_iv[0])


@dataclasses.dataclass(frozen=True)
class BatchNorm:
    """Running-stats normalisation (row-exact); see module docstring."""

    eps: float = 1e-5

    def init(self, generator, in_shape, device="cuda"):
        c = in_shape[-1]
        return {"scale": torch.ones(c, device=device),
                "bias": torch.zeros(c, device=device),
                "mean": torch.zeros(c, device=device),
                "var": torch.ones(c, device=device)}

    def out_shape(self, in_shape):
        return in_shape

    def in_interval(self, out_iv, h_in):
        return out_iv

    def apply(self, params, x):
        inv = torch.rsqrt(params["var"] + self.eps) * params["scale"]
        return x * inv + (params["bias"] - params["mean"] * inv)

    def apply_row(self, params, x, iv_in, h_in, out_iv):
        off = out_iv[0] - iv_in[0]
        return _slice_rows(self.apply(params, x), off,
                           out_iv[1] - out_iv[0])


@dataclasses.dataclass(frozen=True)
class LayerNorm:
    """Normalisation over the channels of each pixel (ConvNeXt's
    ``LayerNorm`` in ``channels_last``): exact per row, as no statistic
    crosses a pixel."""

    eps: float = 1e-6

    def init(self, generator, in_shape, device="cuda"):
        c = in_shape[-1]
        return {"scale": torch.ones(c, device=device),
                "bias": torch.zeros(c, device=device)}

    def out_shape(self, in_shape):
        return in_shape

    def in_interval(self, out_iv, h_in):
        return out_iv

    def apply(self, params, x):
        return F.layer_norm(x, (x.shape[-1],), params["scale"],
                            params["bias"], self.eps)

    def apply_row(self, params, x, iv_in, h_in, out_iv):
        off = out_iv[0] - iv_in[0]
        return self.apply(params, _slice_rows(x, off, out_iv[1] - out_iv[0]))


@dataclasses.dataclass(frozen=True)
class GELU:
    """The exact (erf) GELU."""

    def init(self, generator, in_shape, device="cuda"):
        return {}

    def out_shape(self, in_shape):
        return in_shape

    def in_interval(self, out_iv, h_in):
        return out_iv

    def apply(self, params, x):
        return F.gelu(x)

    def apply_row(self, params, x, iv_in, h_in, out_iv):
        off = out_iv[0] - iv_in[0]
        return F.gelu(_slice_rows(x, off, out_iv[1] - out_iv[0]))


def batch_moments(x):
    """Per-channel (sum, sumsq, count) over (B, H, W) — mergeable."""
    n = x.shape[0] * x.shape[1] * x.shape[2]
    return x.sum(dim=(0, 1, 2)), (x * x).sum(dim=(0, 1, 2)), n


def merge_moments(*ms):
    """Chan's parallel moment merge: exact global mean/var from row
    moments."""
    s = sum(m[0] for m in ms)
    ss = sum(m[1] for m in ms)
    n = sum(m[2] for m in ms)
    mean = s / n
    return mean, ss / n - mean * mean


# ---------------------------------------------------------------------------
# Composite: ResNet bottleneck block (branching interval algebra)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Bottleneck:
    """ResNet-v1 bottleneck: 1x1 -> 3x3(stride) -> 1x1 (+BN, ReLU), with
    identity or projection shortcut.  One trunk "module": the row engines
    see a single unit whose internal halo is replicated."""

    cmid: int
    cout: int
    s: int = 1
    project: bool = False

    def _parts(self):
        c1 = Conv(self.cmid, k=1, s=1, p=0, bias=False)
        c2 = Conv(self.cmid, k=3, s=self.s, p=1, bias=False)
        c3 = Conv(self.cout, k=1, s=1, p=0, bias=False)
        sc = Conv(self.cout, k=1, s=self.s, p=0, bias=False) \
            if self.project else None
        return c1, c2, c3, sc

    @property
    def main_geoms(self):
        return [Geometry(1, 1, 0), Geometry(3, self.s, 1), Geometry(1, 1, 0)]

    def init(self, generator, in_shape, device="cuda"):
        c1, c2, c3, sc = self._parts()
        bn = BatchNorm()
        p, shape = {}, in_shape
        for name, m in (("c1", c1), ("c2", c2), ("c3", c3)):
            p[name] = m.init(generator, shape, device)
            shape = m.out_shape(shape)
            p[name + "_bn"] = bn.init(generator, shape, device)
        if sc is not None:
            p["sc"] = sc.init(generator, in_shape, device)
            p["sc_bn"] = bn.init(generator, sc.out_shape(in_shape), device)
        return p

    def out_shape(self, in_shape):
        h, w, _ = in_shape
        g = Geometry(3, self.s, 1)
        return (g.out_size(h), g.out_size(w), self.cout)

    def in_interval(self, out_iv, h_in):
        main_iv = backward_intervals(self.main_geoms, h_in, out_iv)[0]
        sc_iv = Geometry(1, self.s, 0).in_interval(out_iv, h_in)
        return interval_union(main_iv, sc_iv)

    def apply(self, params, x):
        c1, c2, c3, sc = self._parts()
        bn = BatchNorm()
        y = torch.relu(bn.apply(params["c1_bn"], c1.apply(params["c1"], x)))
        y = torch.relu(bn.apply(params["c2_bn"], c2.apply(params["c2"], y)))
        y = bn.apply(params["c3_bn"], c3.apply(params["c3"], y))
        r = x if sc is None \
            else bn.apply(params["sc_bn"], sc.apply(params["sc"], x))
        return torch.relu(y + r)

    def apply_row(self, params, x, iv_in, h_in, out_iv):
        c1, c2, c3, sc = self._parts()
        bn = BatchNorm()
        hs_main = [h_in]
        for g in self.main_geoms:
            hs_main.append(g.out_size(hs_main[-1]))
        ivs = backward_intervals(self.main_geoms, h_in, out_iv)

        def local(iv_needed):
            return _slice_rows(x, iv_needed[0] - iv_in[0],
                               iv_needed[1] - iv_needed[0])

        # main path
        y = c1.apply_row(params["c1"], local(ivs[0]), ivs[0], hs_main[0],
                         ivs[1])
        y = torch.relu(bn.apply(params["c1_bn"], y))
        y = c2.apply_row(params["c2"], y, ivs[1], hs_main[1], ivs[2])
        y = torch.relu(bn.apply(params["c2_bn"], y))
        y = c3.apply_row(params["c3"], y, ivs[2], hs_main[2], ivs[3])
        y = bn.apply(params["c3_bn"], y)
        # shortcut
        sc_g = Geometry(1, self.s, 0)
        sc_iv = sc_g.in_interval(out_iv, h_in)
        xs = local(sc_iv)
        if sc is not None:
            r = bn.apply(params["sc_bn"], sc.apply_row(params["sc"], xs,
                                                       sc_iv, h_in, out_iv))
        else:
            off = out_iv[0] - sc_g.first_out_of_slice(sc_iv[0])
            r = _slice_rows(xs, off, out_iv[1] - out_iv[0])
        return torch.relu(y + r)


# ---------------------------------------------------------------------------
# Composite: ConvNeXt block (one halo'd conv, then per-pixel layers)
# ---------------------------------------------------------------------------


#: ConvNeXt's initial layer scale (the paper's 1e-6)
LAYER_SCALE_INIT = 1e-6


@dataclasses.dataclass(frozen=True)
class ConvNeXtBlock:
    """ConvNeXt's block (Liu et al., 2022): depthwise ``k``x``k`` conv ->
    LayerNorm -> 1x1 ``dim -> expansion * dim`` -> GELU -> 1x1 back to
    ``dim`` -> layer scale ``gamma`` -> residual add.  One trunk module, as
    a ``Bottleneck`` is: its only halo is the depthwise conv's ``k // 2``
    rows a side, and the rest works pixel by pixel.  The 1x1 convs are
    matmuls over the NHWC channels (``F.linear``; weights ``(dim,
    expansion * dim)`` and back), which need no layout copy.  ``gamma``
    starts at :data:`LAYER_SCALE_INIT`."""

    dim: int
    k: int = 7
    expansion: int = 4
    eps: float = 1e-6

    def _dw(self) -> DepthwiseConv:
        return DepthwiseConv(self.dim, k=self.k, s=1, p=self.k // 2)

    def init(self, generator, in_shape, device="cuda"):
        hidden = self.expansion * self.dim

        def linear(cin, cout):
            return {"w": _he_init(generator, (cin, cout), cin, device),
                    "b": torch.zeros(cout, device=device)}

        return {"dw": self._dw().init(generator, in_shape, device),
                "ln": LayerNorm(self.eps).init(generator, in_shape, device),
                "pw1": linear(self.dim, hidden),
                "pw2": linear(hidden, self.dim),
                "gamma": torch.full((self.dim,), LAYER_SCALE_INIT,
                                    device=device)}

    def out_shape(self, in_shape):
        return in_shape

    def in_interval(self, out_iv, h_in):
        return self._dw().in_interval(out_iv, h_in)

    def _branch(self, params, y):
        y = LayerNorm(self.eps).apply(params["ln"], y)
        y = F.gelu(F.linear(y, params["pw1"]["w"].t(), params["pw1"]["b"]))
        y = F.linear(y, params["pw2"]["w"].t(), params["pw2"]["b"])
        return y * params["gamma"]

    def apply(self, params, x):
        return x + self._branch(params, self._dw().apply(params["dw"], x))

    def apply_row(self, params, x, iv_in, h_in, out_iv):
        y = self._dw().apply_row(params["dw"], x, iv_in, h_in, out_iv)
        r = _slice_rows(x, out_iv[0] - iv_in[0], out_iv[1] - out_iv[0])
        return r + self._branch(params, y)

    def fwd_flops(self, in_shape, batch: int) -> float:
        """Forward FLOPs: the depthwise conv's and the two 1x1 convs'
        multiply-adds, counted twice."""
        h, w, c = in_shape
        return 2.0 * batch * h * w * c * (self.k * self.k
                                          + 2 * self.expansion * c)


# ---------------------------------------------------------------------------
# Trunk helpers
# ---------------------------------------------------------------------------


def init_trunk(modules: Sequence, generator, in_shape, device="cuda"):
    """Initialise a list of modules; returns (params_list, out_shape)."""
    params = []
    shape = in_shape
    for m in modules:
        params.append(m.init(generator, shape, device))
        shape = m.out_shape(shape)
    return params, shape


def apply_trunk(modules: Sequence, params, x):
    """Column-centric reference forward."""
    for m, p in zip(modules, params):
        x = m.apply(p, x)
    return x


def trunk_heights(modules: Sequence, h0: int) -> List[int]:
    hs = [h0]
    for m in modules:
        # every module exposes out_shape((h, w, c)); W/C don't affect H
        hs.append(m.out_shape((hs[-1], 4096, 1))[0])
    return hs


def trunk_in_intervals(modules: Sequence, h0: int,
                       out_iv: Interval) -> List[Interval]:
    """Needed interval at every activation level (len = L+1)."""
    hs = trunk_heights(modules, h0)
    ivs = [out_iv]
    for l in range(len(modules) - 1, -1, -1):
        ivs.append(modules[l].in_interval(ivs[-1], hs[l]))
    ivs.reverse()
    return ivs


def _flatten(p, leaves):
    if isinstance(p, dict):
        return tuple((k, _flatten(p[k], leaves)) for k in sorted(p))
    leaves.append(p)
    return None


def _unflatten(spec, it):
    if spec is None:
        return next(it)
    return {k: _unflatten(s, it) for k, s in spec}


def flatten_params(params) -> Tuple[List[torch.Tensor], Tuple]:
    """A trunk's list of (nested) param dicts as a flat tensor list, in
    the reference's leaf order (keys sorted), plus the key structure
    :func:`unflatten_params` rebuilds it from (what an
    ``autograd.Function`` needs: tensors as direct arguments)."""
    leaves: List[torch.Tensor] = []
    spec = tuple(_flatten(p, leaves) for p in params)
    return leaves, spec


def unflatten_params(leaves: Sequence[torch.Tensor], spec) -> List[dict]:
    it = iter(leaves)
    return [_unflatten(s, it) for s in spec]


def params_from_reference(tree, device="cuda"):
    """The JAX package's CNN parameter tree (leaves given as numpy arrays:
    ``{"trunk": (per-module dicts, nested for a Bottleneck), "head": {"w",
    "b"}}``) as the port's.  Both packages keep HWIO conv weights, so this
    is a copy, not a transpose; it exists because JAX and torch draw
    different random numbers from the same seed."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return torch.tensor(np.array(t, dtype=np.float32), device=device)

    return {"trunk": [conv(p) for p in tree["trunk"]],
            "head": conv(tree["head"])}
