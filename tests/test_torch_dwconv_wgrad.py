"""The depthwise weight-gradient kernel's plain version and its place in
``conv_backward``, on the CPU.

``dwconv_wgrad_plain`` is held against autograd of ``F.conv2d(...,
groups=C)`` in float64 at shapes no tile divides, both paddings the port's
convs pass (``(3, 3)``, and ``(0, 3)`` after ``Conv._conv``'s explicit
``F.pad``), and on rows of a larger NHWC map read in place.
``conv_backward`` routes a depthwise call's weight and bias gradients
through ``kernels.ops.dwconv_wgrad`` (its calls read by a spy; the
wrapper's counter counts launches, and the CPU launches none) and gives what
one ``aten.convolution_backward`` gives, within 1e-12 in float64; dense,
strided and other grouped convs keep the one call.  A depthwise call over
``DGRAD_SPLIT_BYTES`` takes the weight-gradient kernel, then the
data-gradient one (``tests/test_torch_dwconv2d.py``), and no chunk.  The kernel itself runs
only on the card (``tests/test_torch_cuda.py``).
"""

import pytest
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.kernels import dwconv_wgrad as dk
from repro_torch.kernels import ops
from repro_torch.models.cnn import layers as L

#: (N, C, H, W, k, (ph, pw), row slice (first row, rows) or None)
PLAIN_CASES = [
    (1, 5, 9, 11, 7, (3, 3), None),
    (5, 3, 13, 7, 7, (0, 3), None),
    (5, 37, 6, 9, 3, (1, 1), None),
    (1, 4, 7, 5, 3, (0, 1), None),
    (2, 33, 8, 13, 5, (2, 2), None),
    (2, 6, 17, 9, 7, (3, 3), (4, 10)),
    (5, 3, 11, 11, 7, (0, 3), (2, 7)),
]
TOL = 1e-12


def _spy(monkeypatch):
    """The list that each call of ``ops.dwconv_wgrad`` appends its input's
    shape to, while it calls through."""
    calls, wrapped = [], ops.dwconv_wgrad

    def spy(g, x, padding, k):
        calls.append(tuple(x.shape))
        return wrapped(g, x, padding, k)

    monkeypatch.setattr(ops, "dwconv_wgrad", spy)
    return calls


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


def _inputs(n, c, h, w, k, padding, rows, seed=0):
    """NCHW views of NHWC ``x`` and ``g`` (``rows``: rows of a taller map,
    so that the image stride is not the packed one) and the OIHW view of an
    HWIO depthwise weight, float64."""
    gen = torch.Generator().manual_seed(seed)
    ph, pw = padding
    tall = h + (rows[0] + 3 if rows else 0)
    x = torch.randn((n, tall, w, c), generator=gen, dtype=torch.float64)
    ho, wo = h + 2 * ph - k + 1, w + 2 * pw - k + 1
    g = torch.randn((n, ho + (5 if rows else 0), wo, c), generator=gen,
                    dtype=torch.float64)
    if rows:
        x, g = x[:, rows[0]:rows[0] + h], g[:, 2:2 + ho]
    wt = torch.randn((k, k, 1, c), generator=gen, dtype=torch.float64)
    return g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1)


@pytest.mark.parametrize("case", PLAIN_CASES, ids=str)
def test_plain_matches_autograd(case):
    n, c, h, w, k, padding, rows = case
    g, x, wt = _inputs(n, c, h, w, k, padding, rows)
    assert dk.nhwc_strided(x) and dk.nhwc_strided(g)
    xr = x.detach().clone().requires_grad_()
    wr = wt.detach().clone().requires_grad_()
    br = torch.zeros(c, dtype=torch.float64, requires_grad=True)
    F.conv2d(xr, wr, br, padding=padding, groups=c).backward(g)
    dw, db = dk.dwconv_wgrad_plain(g, x, padding, k)
    assert dw.shape == wt.shape and dw.stride() == wt.stride()
    assert _rel(dw, wr.grad) < TOL and _rel(db, br.grad) < TOL


#: (name, (N, C, H, W), (k, stride, padding, groups, weight's in-channels),
#: need, whether the call takes the kernel)
ROUTES = [
    ("depthwise7", (3, 6, 11, 9), (7, 1, (3, 3), 6, 1), (True, True, True),
     True),
    ("depthwise7_pad03", (2, 5, 12, 8), (7, 1, (0, 3), 5, 1),
     (True, True, True), True),
    ("depthwise3_no_dx", (2, 7, 9, 9), (3, 1, (1, 1), 7, 1),
     (False, True, True), True),
    ("depthwise7_bias_only", (2, 4, 9, 9), (7, 1, (3, 3), 4, 1),
     (True, False, True), True),
    ("depthwise7_dx_only", (2, 4, 9, 9), (7, 1, (3, 3), 4, 1),
     (True, False, False), False),
    ("dense", (2, 4, 9, 9), (3, 1, (1, 1), 1, 4), (True, True, True), False),
    ("depthwise_strided", (2, 4, 9, 9), (3, 2, (1, 1), 4, 1),
     (True, True, True), False),
    ("grouped_not_depthwise", (2, 4, 9, 9), (3, 1, (1, 1), 2, 2),
     (True, True, True), False),
    ("depthwise_even_k", (2, 4, 9, 9), (4, 1, (2, 2), 4, 1),
     (True, True, True), False),
]


@pytest.mark.parametrize("route", ROUTES, ids=lambda r: r[0])
def test_conv_backward_routes_depthwise_wgrad(route, monkeypatch):
    """A depthwise call whose ``w`` or ``b`` wants a gradient takes the
    wrapper once; every other call takes none.  Both give what one
    ``aten.convolution_backward`` gives, and the CPU counts no launch."""
    _, (n, c, h, w), (k, s, padding, groups, cin), need, takes = route
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((n, h, w, c), generator=gen,
                    dtype=torch.float64).permute(0, 3, 1, 2)
    cout = c
    wt = torch.randn((k, k, cin, cout), generator=gen,
                     dtype=torch.float64).permute(3, 2, 0, 1)
    ho = (h + 2 * padding[0] - k) // s + 1
    wo = (w + 2 * padding[1] - k) // s + 1
    g = torch.randn((n, ho, wo, cout), generator=gen,
                    dtype=torch.float64).permute(0, 3, 1, 2)
    want = torch.ops.aten.convolution_backward(
        g, x, wt, [cout] if need[2] else None, [s, s], list(padding),
        [1, 1], False, [0, 0], groups, list(need))
    calls = _spy(monkeypatch)
    with obs.profiling() as cap:
        got = L.conv_backward(g, x, wt, s, padding, need, groups)
    assert calls == ([(n, c, h, w)] if takes else [])
    assert cap.count("dwconv_wgrad") == 0
    for a, b, wanted in zip(got, want, need):
        assert (a is None) == (not wanted)
        if wanted:
            assert a.shape == b.shape and _rel(a, b) < TOL


def test_convnext_trunk_takes_the_kernel_in_every_depthwise_backward(
        monkeypatch):
    """Under 2PS-H on a small ConvNeXt, each row of each block opens one
    ``dwconv`` backward range, and each holds one call of the wrapper."""
    from repro_torch.exec import Planner, build_apply
    from repro_torch.models.cnn import convnext
    shape, batch = (32, 32, 3), 2
    mods, params = convnext.init_convnext(
        torch.Generator().manual_seed(0), shape, width_mult=1 / 16,
        n_classes=10, depths=[1, 1, 2, 1], device="cpu")
    leaves, _ = L.flatten_params(params["trunk"])
    for t in leaves:
        t.requires_grad_(True)
    x = torch.randn((batch,) + shape,
                    generator=torch.Generator().manual_seed(1))
    plan = Planner(mods, shape, batch).plan("twophase_h", 2)
    calls = _spy(monkeypatch)
    with obs.profiling() as cap:
        feats = build_apply(mods, plan)(params["trunk"], x)
        loss = convnext.head_apply(params["head"], feats).square().mean()
        torch.autograd.grad(loss, leaves)
    bwd = [r for r in cap.records
           if r.name == "dwconv" and r.attrs == {"phase": "bwd"}]
    assert len(bwd) == sum(n_r * sum(isinstance(m, L.ConvNeXtBlock)
                                     for m in mods[a:b])
                           for a, b, n_r in plan.segments)
    assert len(calls) == len(bwd)


@pytest.mark.parametrize("need", [(True, True, True), (True, True, False),
                                  (True, False, True)],
                         ids=["all", "no_bias", "no_weight"])
def test_split_depthwise_backward_takes_the_kernel_before_the_chunks(
        need, monkeypatch):
    """Over ``DGRAD_SPLIT_BYTES`` a depthwise call takes both kernels, the
    weight gradient first, then the data gradient: no chunk and no
    ``conv_dgrad_split`` range (the data-gradient kernel needs no
    workspace); the gradients are one ``aten.convolution_backward``'s."""
    g, x, wt = _inputs(5, 6, 9, 9, 7, (3, 3), None)
    want = torch.ops.aten.convolution_backward(
        g, x, wt, [6] if need[2] else None, [1, 1], [3, 3], [1, 1], False,
        [0, 0], 6, list(need))
    seen, wgrad, dgrad = [], ops.dwconv_wgrad, ops.dwconv2d
    monkeypatch.setattr(L, "DGRAD_SPLIT_BYTES", 0)
    monkeypatch.setattr(L, "DGRAD_CHUNK_BYTES", 2 * 6 * 9 * 9 * 8)
    with obs.profiling() as cap:
        def spy_w(*args):
            seen.append("wgrad")
            return wgrad(*args)

        def spy_d(*args, **kw):
            seen.append("dgrad")
            return dgrad(*args, **kw)

        monkeypatch.setattr(ops, "dwconv_wgrad", spy_w)
        monkeypatch.setattr(ops, "dwconv2d", spy_d)
        got = L.conv_backward(g, x, wt, 1, (3, 3), need, 6)
    assert seen == ["wgrad", "dgrad"]
    assert cap.count("conv.dgrad_chunks") == 0
    assert [r.name for r in cap.records] == []
    for a, b, wanted in zip(got, want, need):
        assert (a is None) == (not wanted)
        if wanted:
            assert _rel(a, b) < TOL
