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
forward, as the reference's XLA VJP keeps none.

Norm note (as in the reference): ``BatchNorm`` normalises with the running
statistics held in the parameter tree, so row-centric and column-centric
execution agree; they are trainable leaves like any other.  Batch moments
for exact global statistics are :func:`batch_moments` and
:func:`merge_moments` (Chan's merge of per-row moments).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

import numpy as np

from repro_torch.core.convmath import (
    Geometry, Interval, backward_intervals, interval_union,
)


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
# Primitive modules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Conv:
    """2-D convolution, square kernel, symmetric W padding, semi-closed H
    padding in row mode."""

    cout: int
    k: int = 3
    s: int = 1
    p: int = 1
    bias: bool = True

    @property
    def geometry(self) -> Geometry:
        return Geometry(self.k, self.s, self.p)

    def init(self, generator, in_shape, device="cuda"):
        _, _, cin = in_shape
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

    def _conv(self, params, x, pad_h):
        """Conv with H padding ``pad_h`` (top, bottom), W padding ``p``.

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
            y = F.conv2d(xc, w, b, stride=self.s, padding=self.p)
            return _nhwc(y)[:, shift:]
        xc = F.pad(xc, (0, 0, pad_h[0], pad_h[1]))
        return _nhwc(F.conv2d(xc, w, b, stride=self.s, padding=(0, self.p)))

    def apply(self, params, x):
        return self._conv(params, x, (self.p, self.p))

    def apply_row(self, params, x, iv_in, h_in, out_iv):
        g = self.geometry
        y = self._conv(params, x, g.pad_for_slice(iv_in, h_in))
        off = out_iv[0] - g.first_out_of_slice(iv_in[0])
        n = out_iv[1] - out_iv[0]
        assert off >= 0 and off + n <= y.shape[1], (off, n, y.shape, iv_in,
                                                    out_iv, h_in)
        return _slice_rows(y, off, n)


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
