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

Params are plain dicts of tensors.  Activations are NHWC and conv weights
HWIO, as in the reference; the ``torch.nn.functional`` calls see NCHW/OIHW
views of the same storage.  ``F.conv2d`` and ``F.max_pool2d`` only pad
symmetrically, so row mode's asymmetric H padding (``pad_for_slice``) is an
explicit ``F.pad`` — zeros for the conv, ``-inf`` for the pool.

``BatchNorm`` and ``Bottleneck`` are not ported yet (they arrive with
ResNet-50).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.convmath import Geometry, Interval


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
        return _nhwc(F.max_pool2d(xc, self.k, self.s))

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


def flatten_params(params) -> Tuple[List[torch.Tensor], Tuple]:
    """A trunk's list of param dicts as a flat tensor list plus the key
    structure :func:`unflatten_params` rebuilds it from (what an
    ``autograd.Function`` needs: tensors as direct arguments)."""
    leaves, spec = [], []
    for p in params:
        keys = tuple(sorted(p))
        spec.append(keys)
        leaves.extend(p[k] for k in keys)
    return leaves, tuple(spec)


def unflatten_params(leaves: Sequence[torch.Tensor], spec) -> List[dict]:
    out, i = [], 0
    for keys in spec:
        out.append({k: leaves[i + j] for j, k in enumerate(keys)})
        i += len(keys)
    return out
