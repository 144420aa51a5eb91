"""Parity of the port's interval math and CNN layers with the JAX package.

Inputs are made with numpy from a seed and handed to both packages; the
layers must agree to 1e-5 relative in fp32 (DESIGN.md §2) and every
interval must be equal.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import convmath as ref_cm
from repro.models.cnn import layers as ref_layers
from repro.models.cnn.vgg import vgg16_modules as ref_vgg16_modules
from repro_torch import obs
from repro_torch.core import convmath as pt_cm
from repro_torch.exec.collectives import ColumnParallel
from repro_torch.models.cnn import layers as pt_layers
from repro_torch.models.cnn.vgg import vgg16_modules as pt_vgg16_modules

TOL = 1e-5
H, W, C = 16, 12, 4

MODULES = {
    "conv3": ("Conv", dict(cout=8, k=3, s=1, p=1)),
    "conv3_s2": ("Conv", dict(cout=8, k=3, s=2, p=1)),
    "conv5_p0": ("Conv", dict(cout=6, k=5, s=1, p=0)),
    "conv1": ("Conv", dict(cout=5, k=1, s=1, p=0, bias=False)),
    "pool2": ("MaxPool", dict(k=2, s=2)),
    "pool3_p1": ("MaxPool", dict(k=3, s=2, p=1)),
    "relu": ("ReLU", {}),
}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max()) / max(float(np.abs(a).max()), 1e-30)


def _pair(name, seed=0):
    cls, kw = MODULES[name]
    ref_m = getattr(ref_layers, cls)(**kw)
    pt_m = getattr(pt_layers, cls)(**kw)
    ref_p = ref_m.init(jax.random.PRNGKey(seed), (H, W, C))
    pt_p = {k: torch.tensor(np.asarray(v)) for k, v in ref_p.items()}
    if pt_p.get("b") is not None:  # non-zero bias so it is exercised
        b = np.random.default_rng(seed).normal(size=pt_p["b"].shape)
        ref_p = dict(ref_p, b=jax.numpy.asarray(b, jax.numpy.float32))
        pt_p["b"] = torch.tensor(b, dtype=torch.float32)
    return ref_m, pt_m, ref_p, pt_p


def _x(seed=1):
    return np.random.default_rng(seed).normal(size=(2, H, W, C)) \
        .astype(np.float32)


@pytest.mark.parametrize("name", sorted(MODULES))
def test_apply_matches_reference(name):
    ref_m, pt_m, ref_p, pt_p = _pair(name)
    x = _x()
    want = ref_m.apply(ref_p, jax.numpy.asarray(x))
    got = pt_m.apply(pt_p, torch.tensor(x))
    assert _rel(want, got.numpy()) < TOL
    assert pt_m.out_shape((H, W, C)) == ref_m.out_shape((H, W, C))


@pytest.mark.parametrize("name", sorted(MODULES))
def test_apply_row_matches_reference(name):
    ref_m, pt_m, ref_p, pt_p = _pair(name)
    x = _x()
    h_out = ref_m.out_shape((H, W, C))[0]
    rng = np.random.default_rng(2)
    ivs = [(0, min(2, h_out)), (max(0, h_out - 2), h_out)]
    for _ in range(4):
        a = int(rng.integers(0, h_out))
        ivs.append((a, int(rng.integers(a + 1, h_out + 1))))
    for out_iv in ivs:
        iv_in = ref_m.in_interval(out_iv, H)
        assert pt_m.in_interval(out_iv, H) == iv_in
        xs = x[:, iv_in[0]:iv_in[1]]
        want = ref_m.apply_row(ref_p, jax.numpy.asarray(xs), iv_in, H, out_iv)
        got = pt_m.apply_row(pt_p, torch.tensor(xs), iv_in, H, out_iv)
        assert _rel(want, got.numpy()) < TOL, (out_iv, iv_in)
        # the row result is the matching slice of the full output
        full = pt_m.apply(pt_p, torch.tensor(x))[:, out_iv[0]:out_iv[1]]
        assert _rel(full.numpy(), got.numpy()) < TOL


@pytest.mark.parametrize("n_stages,h0", [(3, 32), (5, 64), (2, 37)])
def test_trunk_intervals_equal(n_stages, h0):
    ref_mods = ref_vgg16_modules(0.125, n_stages)
    pt_mods = pt_vgg16_modules(0.125, n_stages)
    assert pt_layers.trunk_heights(pt_mods, h0) \
        == ref_layers.trunk_heights(ref_mods, h0)
    h_last = ref_layers.trunk_heights(ref_mods, h0)[-1]
    for n in range(1, min(4, h_last) + 1):
        for iv in ref_cm.split_even(h_last, n):
            assert pt_layers.trunk_in_intervals(pt_mods, h0, iv) \
                == ref_layers.trunk_in_intervals(ref_mods, h0, iv)


GEOMS = [
    [(3, 1, 1)] * 4,
    [(3, 1, 1), (2, 2, 0), (3, 1, 1), (2, 2, 0)],
    [(7, 2, 3), (3, 2, 1), (3, 1, 1), (1, 1, 0)],
    [(5, 1, 2), (3, 2, 0), (3, 1, 1)],
]


@pytest.mark.parametrize("gi", range(len(GEOMS)))
def test_convmath_equal(gi):
    ref_g = [ref_cm.Geometry(*g) for g in GEOMS[gi]]
    pt_g = [pt_cm.Geometry(*g) for g in GEOMS[gi]]
    h0 = 64
    assert pt_cm.heights(pt_g, h0) == ref_cm.heights(ref_g, h0)
    h_last = ref_cm.heights(ref_g, h0)[-1]
    for n in range(1, 5):
        assert pt_cm.split_even(h_last, n) == ref_cm.split_even(h_last, n)
        for iv in ref_cm.split_even(h_last, n):
            assert pt_cm.backward_intervals(pt_g, h0, iv) \
                == ref_cm.backward_intervals(ref_g, h0, iv)
        assert pt_cm.twophase_boundaries(pt_g, h0, n) \
            == ref_cm.twophase_boundaries(ref_g, h0, n)
        assert pt_cm.validate_twophase(pt_g, h0, n) \
            == ref_cm.validate_twophase(ref_g, h0, n)
    for b in range(1, h_last):
        assert pt_cm.overlap_rows(pt_g, h0, b) \
            == ref_cm.overlap_rows(ref_g, h0, b)
    assert pt_cm.max_valid_rows(pt_g, h0) == ref_cm.max_valid_rows(ref_g, h0)
    for g_pt, g_ref in zip(pt_g, ref_g):
        for a in range(0, 8):
            for b in range(a + 1, 12):
                assert g_pt.out_interval((a, b), 12) \
                    == g_ref.out_interval((a, b), 12)
                assert g_pt.pad_for_slice((a, b), 12) \
                    == g_ref.pad_for_slice((a, b), 12)
                assert g_pt.first_out_of_slice(a) \
                    == g_ref.first_out_of_slice(a)


def _np_tree(ref_mods, in_shape, seed=0):
    """A VGG parameter tree in the reference's layout, made with numpy."""
    rng = np.random.default_rng(seed)
    trunk, shape = [], in_shape
    for m in ref_mods:
        p = {}
        if isinstance(m, ref_layers.Conv):
            p["w"] = rng.normal(size=(m.k, m.k, shape[2], m.cout)) \
                .astype(np.float32)
            p["b"] = rng.normal(size=(m.cout,)).astype(np.float32)
        trunk.append(p)
        shape = m.out_shape(shape)
    head = {"w": rng.normal(size=(shape[2], 10)).astype(np.float32),
            "b": rng.normal(size=(10,)).astype(np.float32)}
    return {"trunk": tuple(trunk), "head": head}


def test_params_from_reference_roundtrip():
    from repro_torch.models.cnn.vgg import params_from_reference
    tree_np = _np_tree(ref_vgg16_modules(0.125, 3), (32, 32, 3))
    pt = params_from_reference(tree_np, device="cpu")
    assert len(pt["trunk"]) == len(tree_np["trunk"])
    for a, b in zip(pt["trunk"], tree_np["trunk"]):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), b[k])
    np.testing.assert_array_equal(pt["head"]["w"].numpy(),
                                  tree_np["head"]["w"])


def test_port_init_shapes_match_reference():
    from repro_torch.models.cnn.vgg import init_vgg16 as pt_init
    ref_tree = _np_tree(ref_vgg16_modules(0.125, 3), (32, 32, 3))
    _, pt_tree = pt_init(torch.Generator().manual_seed(0), (32, 32, 3),
                         0.125, 10, 3, device="cpu")
    for a, b in zip(pt_tree["trunk"], ref_tree["trunk"]):
        assert {k: tuple(v.shape) for k, v in a.items()} \
            == {k: tuple(v.shape) for k, v in b.items()}
    assert tuple(pt_tree["head"]["w"].shape) == ref_tree["head"]["w"].shape
    # He init: std sqrt(2 / fan_in) within sampling noise
    w = pt_tree["trunk"][2]["w"]  # conv, relu, conv, ...
    fan_in = w.shape[0] * w.shape[1] * w.shape[2]
    assert abs(float(w.std()) / np.sqrt(2.0 / fan_in) - 1) < 0.1


@pytest.mark.parametrize("k,s,p", [(2, 2, 0), (3, 2, 1)])
def test_max_pool_keeps_no_indices_and_its_gradient(k, s, p):
    """The pool saves only its input (autograd's own max pool would keep
    int64 argmax indices the size of its output until the backward), and
    its gradient equals autograd's, ties included: a ReLU output is mostly
    zeros, so many windows tie."""
    from torch.autograd.graph import saved_tensors_hooks
    rng = np.random.default_rng(3)
    x = torch.relu(torch.tensor(rng.normal(size=(2, 16, 12, 4)),
                                dtype=torch.float32))
    g = torch.tensor(rng.normal(size=(2, 8, 6, 4)), dtype=torch.float32)
    pool = pt_layers.MaxPool(k=k, s=s, p=p)
    saved = []

    def pack(t):
        saved.append(t.dtype)
        return t

    xa = x.clone().requires_grad_()
    with saved_tensors_hooks(pack, lambda t: t):
        y = pool.apply({}, xa)
    assert saved and torch.int64 not in saved
    (ga,) = torch.autograd.grad(y, xa, g)
    xb = x.clone().requires_grad_()
    xc = pt_layers._nchw(xb)
    if p:
        xc = torch.nn.functional.pad(xc, (p, p, p, p), value=-float("inf"))
    yb = pt_layers._nhwc(torch.nn.functional.max_pool2d(xc, k, s))
    (gb,) = torch.autograd.grad(yb, xb, g)
    assert torch.equal(y, yb) and torch.equal(ga, gb)


def test_vgg_trunk_saves_no_int64_tensor():
    from torch.autograd.graph import saved_tensors_hooks
    from repro_torch.models.cnn.layers import apply_trunk, init_trunk
    mods = pt_vgg16_modules(0.125, 3)
    params, _ = init_trunk(mods, torch.Generator().manual_seed(0),
                           (32, 32, 3), device="cpu")
    x = torch.ones(2, 32, 32, 3, requires_grad=True)
    dtypes = []

    def pack(t):
        dtypes.append(t.dtype)
        return t

    with saved_tensors_hooks(pack, lambda t: t):
        apply_trunk(mods, params, x).sum().backward()
    assert dtypes and set(dtypes) == {torch.float32}


# -- the batch-split data gradient (layers.conv_backward) -------------------

def _graph_names(t):
    names, todo, seen = set(), [t.grad_fn], set()
    while todo:
        f = todo.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        names.add(f.name())
        todo += [n for n, _ in f.next_functions]
    return names


def _conv_grads(m, p, x_full, rows, pad_h, g_seed=3):
    """``m._conv`` on rows ``rows`` of ``x_full`` (an H-slice of NHWC) and
    its gradients against a fixed cotangent, under a counting session."""
    xb = x_full.clone().requires_grad_()
    pp = {k: v.clone().requires_grad_() for k, v in p.items()}
    with obs.capture() as s:
        y = m._conv(pp, xb[:, rows[0]:rows[1]], pad_h)
        g = torch.randn(y.shape, generator=torch.Generator().manual_seed(
            g_seed))
        (y * g).sum().backward()
    return ([xb.grad, pp["w"].grad] + ([pp["b"].grad] if "b" in pp else []),
            _graph_names(y), s.metrics.counter("conv.dgrad_chunks").value)


def _split_rel(a, b):
    return float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)


#: (stride, pad_h, bias, rows of the 13-row input the conv reads): the
#: ``rem == 0`` branch of ``Conv._conv`` (stride 1, or stride 2 with an even
#: top shift) and its ``F.pad`` branch (stride 2, odd shift); whole and
#: H-sliced inputs
SPLIT_CASES = [(1, (1, 1), True, (0, 13)), (1, (0, 1), False, (2, 11)),
               (1, (1, 0), True, (3, 13)), (2, (1, 1), False, (0, 13)),
               (2, (1, 1), True, (2, 11)), (2, (0, 1), True, (0, 13)),
               (2, (0, 1), False, (2, 11)), (2, (0, 0), True, (1, 12))]


@pytest.mark.parametrize("s,pad_h,bias,rows", SPLIT_CASES)
def test_split_dgrad_matches_autograd(monkeypatch, s, pad_h, bias, rows):
    """Above ``DGRAD_SPLIT_BYTES`` the conv's backward splits its data
    gradient into batch chunks (batch 5 in chunks of 2: the last is
    uneven): dx, dw and db equal ``F.conv2d`` autograd's, and the counter
    counts the chunk calls; below it the graph is autograd's own."""
    m = pt_layers.Conv(6, k=3, s=s, p=1, bias=bias)
    p = m.init(torch.Generator().manual_seed(1), (9, 7, 4), "cpu")
    if bias:
        p["b"] = torch.randn(6, generator=torch.Generator().manual_seed(2))
    x_full = torch.randn(5, 13, 7, 4,
                         generator=torch.Generator().manual_seed(4))
    want, names, n = _conv_grads(m, p, x_full, rows, pad_h)
    assert "ConvolutionBackward0" in names and n == 0
    assert not any("_Conv2d" in k for k in names)
    # per image: the conv's input rows (+ an explicit pad in the F.pad
    # branch) and its output rows, the larger of the two in bytes
    h = rows[1] - rows[0]
    if (m.p - pad_h[0]) % s:
        h += pad_h[0] + pad_h[1]
    ph = 0 if (m.p - pad_h[0]) % s else 1
    h_out, w_out = (h + 2 * ph - 3) // s + 1, (7 + 2 - 3) // s + 1
    per_image = 4 * max(h * 7 * 4, h_out * w_out * 6)
    monkeypatch.setattr(pt_layers, "DGRAD_SPLIT_BYTES", 0)
    monkeypatch.setattr(pt_layers, "DGRAD_CHUNK_BYTES", 3 * per_image)
    got, names, n = _conv_grads(m, p, x_full, rows, pad_h)
    assert "ConvolutionBackward0" not in names
    assert any("_Conv2d" in k for k in names)
    assert n == 3  # chunks of 2, 2, 1
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert _split_rel(a, b) < 1e-6


@pytest.mark.parametrize("split", [False, True])
def test_kernel_conv_backward_uses_the_split_rule(monkeypatch, split):
    """``overlap_cuda``'s conv (the kernel's plain version on the CPU) runs
    through the layers' one conv op, whose Function takes its backward
    from ``conv_backward``: one call below ``DGRAD_SPLIT_BYTES``, chunks
    above, autograd's gradients either way."""
    from repro_torch.exec.kernel_engines import _kernel_conv
    m = pt_layers.Conv(6, k=3, s=1, p=1)
    p = m.init(torch.Generator().manual_seed(1), (9, 7, 4), "cpu")
    p["b"] = torch.randn(6, generator=torch.Generator().manual_seed(2))
    x = torch.randn(5, 9, 7, 4, generator=torch.Generator().manual_seed(4))
    g = torch.randn(5, 9, 7, 6, generator=torch.Generator().manual_seed(3))

    def grads(fn):
        xa = x.clone().requires_grad_()
        pp = {k: v.clone().requires_grad_() for k, v in p.items()}
        with obs.capture() as s:
            y = fn(pp, xa)
            (y * g).sum().backward()
        return ([xa.grad, pp["w"].grad, pp["b"].grad],
                s.metrics.counter("conv.dgrad_chunks").value, _graph_names(y))

    want, _, names = grads(m.apply)
    assert "ConvolutionBackward0" in names
    if split:
        monkeypatch.setattr(pt_layers, "DGRAD_SPLIT_BYTES", 0)
        monkeypatch.setattr(pt_layers, "DGRAD_CHUNK_BYTES", 2 * 9 * 7 * 6 * 4)
    got, n, names = grads(_kernel_conv(m, 4))
    assert n == (3 if split else 0)
    assert "ConvolutionBackward0" not in names
    assert any("_Conv2d" in k for k in names)
    for a, b in zip(want, got):
        assert _split_rel(a, b) < 1e-6


@pytest.mark.parametrize("n,fit,calls", [(7, 4, 3), (11, 8, 3), (12, 8, 2),
                                         (6, 3, 3)])
def test_split_dgrad_chunks_are_powers_of_two(monkeypatch, n, fit, calls):
    """``conv_backward`` cuts a batch of ``n`` into chunks of a power of two
    of images: as many of the largest within ``fit`` images as the batch
    holds, then the remainder in its binary digits (7 at 4: 4, 2, 1; 11 at
    8: 8, 2, 1; 6 at 3: 2, 2, 2).  The data gradient equals one call's."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(n, 4, 9, 7, generator=gen)
    g = torch.randn(n, 6, 9, 7, generator=gen)
    w = torch.randn(6, 4, 3, 3, generator=gen)
    want = torch.ops.aten.convolution_backward(
        g, x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
        [True, True, False])
    monkeypatch.setattr(pt_layers, "DGRAD_SPLIT_BYTES", 0)
    monkeypatch.setattr(pt_layers, "DGRAD_CHUNK_BYTES", fit * 6 * 9 * 7 * 4)
    with obs.capture() as s:
        got = pt_layers.conv_backward(g, x, w, 1, (1, 1),
                                      (True, True, False))
    assert s.metrics.counter("conv.dgrad_chunks").value == calls
    assert got[2] is None
    for a, b in zip(want[:2], got[:2]):
        assert _split_rel(a, b) < 1e-6


@pytest.mark.parametrize("module,dense", [
    (pt_layers.Conv(8), True),
    (pt_layers.Conv(8, k=1, p=0, bias=False), True),
    (pt_layers.DepthwiseConv(8, k=7, p=3), False),
    (pt_layers.MaxPool(), False),
    (ColumnParallel(pt_layers.Conv(8), None), True),
    (ColumnParallel(pt_layers.DepthwiseConv(8, k=7, p=3), None), False),
], ids=["conv3", "conv1", "depthwise7", "pool", "column_parallel_conv3",
        "column_parallel_depthwise7"])
def test_dense_conv_is_the_one_predicate(module, dense):
    """``dense_conv``, which the kernel engine and the column split ask,
    holds for a dense ``Conv`` alone, and sees through ``ColumnParallel``."""
    assert pt_layers.dense_conv(module) is dense
