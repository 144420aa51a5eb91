"""The depthwise conv kernel's plain version and its place in the conv op,
on the CPU.

``dwconv2d_plain`` is held against ``F.conv2d(..., groups=C)`` and, with
the filter flipped at padding ``k - 1 - p``, against autograd's data
gradient, in float64 at every kernel size the source is built for, both
paddings the port's convs pass (``(3, 3)`` and ``(0, 3)``) and on rows of a
taller NHWC map read in place.  The conv op calls
``kernels.ops.dwconv2d`` (its calls read by a spy; the CPU launches none)
in the forward of every depthwise stride-1 odd-k conv and for the data
gradient of each such conv whose input wants one, and in no other conv;
what it gives is what ``F.conv2d`` and one ``aten.convolution_backward``
give, within 1e-12 in float64.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""

import pytest
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.kernels import dwconv2d as dc
from repro_torch.kernels import dwconv_wgrad as dk
from repro_torch.kernels import ops
from repro_torch.models.cnn import layers as L

from test_torch_dwconv_wgrad import PLAIN_CASES, ROUTES, TOL, _inputs, _rel

#: the ROUTES cases the depthwise kernels take: depthwise, stride 1, odd k
ADMITTED = {"depthwise7", "depthwise7_pad03", "depthwise3_no_dx",
            "depthwise7_bias_only", "depthwise7_dx_only"}
#: (N, C, H, W, k, (ph, pw), row slice or None) beyond the weight
#: gradient's cases: a 1x1 and a 5x5 at its largest padding
EXTRA_CASES = [(2, 7, 6, 5, 1, (0, 0), None), (2, 9, 8, 7, 5, (4, 4), None)]


def _spy(monkeypatch):
    """The list that each call of ``ops.dwconv2d`` appends ``(its input's
    shape, flip)`` to, while it calls through."""
    calls, wrapped = [], ops.dwconv2d

    def spy(x, w, b, padding, flip=False):
        calls.append((tuple(x.shape), flip))
        return wrapped(x, w, b, padding, flip)

    monkeypatch.setattr(ops, "dwconv2d", spy)
    return calls


@pytest.mark.parametrize("case", PLAIN_CASES + EXTRA_CASES, ids=str)
def test_plain_matches_conv2d_and_its_data_gradient(case):
    """The forward against ``F.conv2d`` with a bias; the flipped conv of
    ``g`` at padding ``k - 1 - p`` against autograd's ``dx``."""
    n, c, h, w, k, padding, rows = case
    g, x, wt = _inputs(n, c, h, w, k, padding, rows)
    b = torch.randn(c, generator=torch.Generator().manual_seed(9),
                    dtype=torch.float64)
    y = dc.dwconv2d_plain(x, wt, b, padding)
    want = F.conv2d(x, wt, b, padding=padding, groups=c)
    assert y.shape == want.shape and dk.nhwc_strided(y)
    assert _rel(y, want) < TOL
    xr = x.detach().clone().requires_grad_()
    F.conv2d(xr, wt, b, padding=padding, groups=c).backward(g)
    dx = dc.dwconv2d_plain(g, wt, None, [k - 1 - p for p in padding],
                           flip=True)
    assert dx.shape == x.shape and _rel(dx, xr.grad) < TOL


def test_plain_refuses_what_the_kernel_does_not_take():
    g, x, wt = _inputs(2, 4, 9, 9, 7, (3, 3), None)
    with pytest.raises(ValueError, match="padding"):
        dc.dwconv2d_plain(x, wt, None, (7, 3))
    with pytest.raises(ValueError, match="k="):
        dc.dwconv2d_plain(x, wt[..., :6, :6], None, (3, 3))
    with pytest.raises(ValueError, match="depthwise filter"):
        dc.dwconv2d_plain(x[:, :3], wt, None, (3, 3))


def _route_inputs(route):
    _, (n, c, h, w), (k, s, padding, groups, cin), need, _ = route
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((n, h, w, c), generator=gen,
                    dtype=torch.float64).permute(0, 3, 1, 2)
    wt = torch.randn((k, k, cin, c), generator=gen,
                     dtype=torch.float64).permute(3, 2, 0, 1)
    b = torch.randn(c, generator=gen, dtype=torch.float64)
    ho = (h + 2 * padding[0] - k) // s + 1
    wo = (w + 2 * padding[1] - k) // s + 1
    g = torch.randn((n, ho, wo, c), generator=gen,
                    dtype=torch.float64).permute(0, 3, 1, 2)
    return x, wt, b, g


@pytest.mark.parametrize("route", ROUTES, ids=lambda r: r[0])
def test_conv_op_routes_depthwise_forward_and_data_gradient(route,
                                                            monkeypatch):
    """The conv op's forward calls the wrapper once for an admitted conv
    and ``conv_backward`` once more where ``x`` wants a gradient (the
    flipped conv); other convs never call it.  Both give what
    ``F.conv2d`` and one ``aten.convolution_backward`` give, and the CPU
    counts no launch."""
    name, (n, c, h, w), (k, s, padding, groups, _), need, _ = route
    x, wt, b, g = _route_inputs(route)
    calls = _spy(monkeypatch)
    with obs.profiling() as cap:
        y = L.conv2d(x, wt, b, s, padding, groups)
        got = L.conv_backward(g, x, wt, s, padding, need, groups)
    admitted = name in ADMITTED
    assert calls == ([((n, c, h, w), False)] if admitted else []) \
        + ([(tuple(g.shape), True)] if admitted and need[0] else [])
    assert cap.count("dwconv2d") == 0 and cap.count("dwconv2d.copies") == 0
    assert _rel(y, F.conv2d(x, wt, b, stride=s, padding=padding,
                            groups=groups)) < TOL
    want = torch.ops.aten.convolution_backward(
        g, x, wt, [c] if need[2] else None, [s, s], list(padding), [1, 1],
        False, [0, 0], groups, list(need))
    for a, bb, wanted in zip(got, want, need):
        assert (a is None) == (not wanted)
        if wanted:
            assert a.shape == bb.shape and _rel(a, bb) < TOL


def test_convnext_trunk_calls_the_kernel_in_every_depthwise_conv(
        monkeypatch):
    """Under 2PS-H on a small ConvNeXt, every depthwise forward call (the
    rows' and their recomputation's) and every depthwise backward that
    owes ``dx`` makes one call of the wrapper, and no other call does."""
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
    owes, backward = [], L.conv_backward

    def spy_backward(g, x, w, stride, padding, need, groups=1):
        if groups > 1:
            owes.append(need[0])
        return backward(g, x, w, stride, padding, need, groups)

    monkeypatch.setattr(L, "conv_backward", spy_backward)
    with obs.profiling() as cap:
        feats = build_apply(mods, plan)(params["trunk"], x)
        loss = convnext.head_apply(params["head"], feats).square().mean()
        torch.autograd.grad(loss, leaves)
    fwd = cap.count("conv.depthwise_calls")
    assert fwd > 0 and sum(owes) > 0
    assert [f for _, f in calls].count(False) == fwd
    assert [f for _, f in calls].count(True) == sum(owes)
