"""The port's ConvNeXt (``models/cnn/convnext.py`` and its layers) against
a plain PyTorch ConvNeXt (``tests/plain_convnext.py``) on seeded weights
at 64², widths a sixteenth of ConvNeXt-B's and depths [1, 1, 2, 1]:
values and gradients within 1e-5 relative, module by module (whole and on
row intervals) and for the whole trunk under every engine; the grouped
conv's batch-split data gradient; the 2PS granularity caps the 7x7 halos
set at ConvNeXt-B's own 384²; the trainer on its normal path."""

import random

import pytest
import torch
import torch.nn.functional as F

import plain_convnext as plain
from repro_torch import obs
from repro_torch.core import twophase as tp
from repro_torch.exec import Planner, PlanRequest, build_apply
from repro_torch.exec.planner import derive_segments, segment_row_capacity
from repro_torch.models.cnn import convnext
from repro_torch.models.cnn import layers as L

TOL = 1e-5
IMAGE, BATCH, WIDTH, DEPTHS = 64, 2, 1 / 16, [1, 1, 2, 1]
DIMS = [8, 16, 32, 64]
N_CLASSES = 10


@pytest.fixture(autouse=True)
def _one_thread():
    # multi-threaded CPU reductions are not bit-reproducible run to run
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _hwio(w):
    return w.permute(2, 3, 1, 0).contiguous()


def _affine(p, name):
    return {"scale": p[f"{name}.w"], "bias": p[f"{name}.b"]}


def port_tree(mods, p):
    """The plain leaves as the port's parameter tree."""
    trunk, block, down = [], 0, 0
    for i, m in enumerate(mods):
        if isinstance(m, L.ConvNeXtBlock):
            j = f"block{block}"
            trunk.append({"dw": {"w": _hwio(p[f"{j}.dw.w"]),
                                 "b": p[f"{j}.dw.b"]},
                          "ln": _affine(p, f"{j}.ln"),
                          "pw1": {"w": p[f"{j}.pw1.w"], "b": p[f"{j}.pw1.b"]},
                          "pw2": {"w": p[f"{j}.pw2.w"], "b": p[f"{j}.pw2.b"]},
                          "gamma": p[f"{j}.gamma"]})
            block += 1
        elif isinstance(m, L.Conv):
            name = "stem" if i == 0 else f"down{down}"
            trunk.append({"w": _hwio(p[f"{name}.w"]), "b": p[f"{name}.b"]})
        elif i == 1:
            trunk.append(_affine(p, "stem_ln"))
        else:  # a downsampling layer's LayerNorm
            down += 1
            trunk.append(_affine(p, f"down{down}.ln"))
    head = {"ln": _affine(p, "head_ln"), "w": p["head.w"], "b": p["head.b"]}
    return {"trunk": trunk, "head": head}


def _leaves(seed=0):
    return plain.init_leaves(DIMS, DEPTHS, N_CLASSES, seed)


def _images(seed=1):
    return torch.randn((BATCH, IMAGE, IMAGE, 3),
                       generator=torch.Generator().manual_seed(seed))


def test_modules_and_leaves_match_the_plain_model():
    mods = convnext.convnext_modules(WIDTH, DEPTHS)
    assert [m.dim for m in mods if isinstance(m, L.ConvNeXtBlock)] == [
        8, 16, 32, 32, 64]
    assert [(m.k, m.s, m.cout) for m in mods if isinstance(m, L.Conv)] == [
        (4, 4, 8), (2, 2, 16), (2, 2, 32), (2, 2, 64)]
    _, init = convnext.init_convnext(torch.Generator().manual_seed(0),
                                     (IMAGE, IMAGE, 3), WIDTH, N_CLASSES,
                                     DEPTHS, device="cpu")
    tree = port_tree(mods, _leaves())
    shapes = lambda t: {k: shapes(v) if isinstance(v, dict) else v.shape
                        for k, v in t.items()}
    assert [shapes(a) for a in init["trunk"]] == [shapes(b) for b in
                                                  tree["trunk"]]
    assert shapes(init["head"]) == shapes(tree["head"])
    # the trainer's own init starts the layer scale at the paper's 1e-6
    gammas = [t["gamma"] for t in init["trunk"] if "gamma" in t]
    assert all(float(g.max()) == pytest.approx(1e-6) for g in gammas)
    # ConvNeXt-B's 88.6 M parameters, counted from the module list
    n, c = 1024 * 1000 + 1000 + 2 * 1024, 3  # classifier and head LN
    for m in convnext.convnext_modules():
        if isinstance(m, L.ConvNeXtBlock):
            d = m.dim
            n += 49 * d + d + 2 * d + 8 * d * d + 4 * d + d + d
        elif isinstance(m, L.Conv):
            n += m.k * m.k * c * m.cout + m.cout
            c = m.cout
        else:
            n += 2 * c
    assert n == pytest.approx(88.59e6, rel=1e-3)


# -- modules: apply and apply_row ---------------------------------------------

C = 8
H = 13


def _module_case(name):
    """``(port module, port params, plain function of NHWC x)``."""
    p = _leaves(3)
    if name == "layernorm":
        m = L.LayerNorm()
        prm = _affine(p, "block0.ln")
        return m, prm, lambda x, q: F.layer_norm(
            x, (C,), q["scale"], q["bias"], 1e-6)
    if name == "gelu":
        return L.GELU(), {}, lambda x, q: F.gelu(x)
    if name == "dwconv":
        m = L.DepthwiseConv(C, k=7, s=1, p=3)
        prm = {"w": _hwio(p["block0.dw.w"]), "b": p["block0.dw.b"]}
        return m, prm, lambda x, q: F.conv2d(
            x.permute(0, 3, 1, 2), q["w"].permute(3, 2, 0, 1), q["b"],
            padding=3, groups=C).permute(0, 2, 3, 1)
    m = L.ConvNeXtBlock(C)
    prm = port_tree(convnext.convnext_modules(WIDTH, DEPTHS), p)["trunk"][2]

    def block(x, q):
        leaves = {"block0.dw.w": q["dw"]["w"].permute(3, 2, 0, 1),
                  "block0.dw.b": q["dw"]["b"],
                  "block0.ln.w": q["ln"]["scale"],
                  "block0.ln.b": q["ln"]["bias"],
                  "block0.pw1.w": q["pw1"]["w"], "block0.pw1.b": q["pw1"]["b"],
                  "block0.pw2.w": q["pw2"]["w"], "block0.pw2.b": q["pw2"]["b"],
                  "block0.gamma": q["gamma"]}
        return plain.block(leaves, 0, x.permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1)

    return m, prm, block


def _grads(fn, x, prm, g):
    xa = x.clone().requires_grad_()
    pa = torch.utils._pytree.tree_map(lambda t: t.clone().requires_grad_(),
                                      prm)
    leaves = torch.utils._pytree.tree_leaves(pa)
    y = fn(xa, pa)
    got = torch.autograd.grad((y * g).sum(), [xa] + leaves)
    return y.detach(), got


MODULES = ["layernorm", "gelu", "dwconv", "block"]


@pytest.mark.parametrize("name", MODULES)
def test_module_apply_matches_plain(name):
    m, prm, ref = _module_case(name)
    x = torch.randn((BATCH, H, 11, C),
                    generator=torch.Generator().manual_seed(4))
    g = torch.randn((BATCH, H, 11, C),
                    generator=torch.Generator().manual_seed(5))
    want, dwant = _grads(ref, x, prm, g)
    got, dgot = _grads(lambda xs, q: m.apply(q, xs), x, prm, g)
    assert _rel(got, want) < TOL
    for a, b in zip(dgot, dwant):
        assert _rel(a, b) < TOL


@pytest.mark.parametrize("name", MODULES)
def test_module_apply_row_matches_plain_on_random_intervals(name):
    """``apply_row`` on the input rows its ``in_interval`` asks for gives
    exactly the plain output's rows, and their gradients."""
    m, prm, ref = _module_case(name)
    rnd = random.Random(7)
    x = torch.randn((BATCH, H, 11, C),
                    generator=torch.Generator().manual_seed(4))
    for _ in range(6):
        a = rnd.randrange(0, H)
        b = rnd.randrange(a + 1, H + 1)
        iv_in = m.in_interval((a, b), H)
        g = torch.randn((BATCH, b - a, 11, C),
                        generator=torch.Generator().manual_seed(a * 31 + b))

        def row(xs, q):
            return m.apply_row(q, xs[:, iv_in[0]:iv_in[1]], iv_in, H, (a, b))

        def whole(xs, q):
            return ref(xs, q)[:, a:b]

        want, dwant = _grads(whole, x, prm, g)
        got, dgot = _grads(row, x, prm, g)
        assert _rel(got, want) < TOL, (a, b)
        for u, v in zip(dgot, dwant):
            assert _rel(u, v) < TOL, (a, b)


# -- the whole trunk under each engine -------------------------------------

#: (engine, N): the largest N each admits at 64² (2PS over the whole trunk
#: admits 1: its 7x7 halos chain through every block; 2PS-H runs N=2 in
#: the segments that hold stage 1 and 2)
ENGINES = [("base", 1), ("overlap", 2), ("twophase", 1), ("twophase_h", 2)]


@pytest.mark.parametrize("engine,n", ENGINES)
def test_trunk_and_head_match_plain_under_each_engine(engine, n):
    mods = convnext.convnext_modules(WIDTH, DEPTHS)
    p = _leaves()
    shape = (IMAGE, IMAGE, 3)
    plan = Planner(mods, shape, BATCH).plan(engine, n)
    if engine == "twophase_h":
        assert [s[2] for s in plan.segments] == [2, 2, 1, 1]
    apply = build_apply(mods, plan)
    x = _images()
    labels = torch.tensor([3, 7])

    def loss_of(logits):
        return -torch.log_softmax(logits, -1).gather(1, labels[:, None]).mean()

    names = sorted(p)
    ref_leaves = [p[k].clone().requires_grad_() for k in names]
    live = dict(zip(names, ref_leaves))
    xr = x.clone().requires_grad_()
    ref_logits = plain.logits(live, xr.permute(0, 3, 1, 2), DIMS, DEPTHS)
    ref_grads = dict(zip(names + ["x"], torch.autograd.grad(
        loss_of(ref_logits), ref_leaves + [xr])))

    leaves = {k: t.clone().requires_grad_() for k, t in p.items()}
    tree = port_tree(mods, leaves)
    xp = x.clone().requires_grad_()
    logits = convnext.head_apply(tree["head"], apply(tree["trunk"], xp))
    got = dict(zip(names + ["x"], torch.autograd.grad(
        loss_of(logits), [leaves[k] for k in names] + [xp])))
    assert _rel(logits.detach(), ref_logits.detach()) < TOL
    for k in names + ["x"]:
        assert _rel(got[k], ref_grads[k]) < TOL, k


def test_kernel_request_declines_the_depthwise_convs():
    """A ``kernel: cuda`` request resolves: only the dense stem and
    downsampling convs count for the kernel, and the kernelized trunk
    (the kernel's plain version here) computes what ``base`` does."""
    mods = convnext.convnext_modules(WIDTH, DEPTHS)
    shape = (IMAGE, IMAGE, 3)
    plan = Planner(mods, shape, BATCH).resolve(
        PlanRequest(engine="overlap", n_rows=2, kernel="cuda"))
    assert plan.engine == "overlap_cuda" and plan.get("kernel_layers") == 4
    tree = port_tree(mods, _leaves())
    x = _images()
    want = build_apply(mods, Planner(mods, shape, BATCH).plan("base"))(
        tree["trunk"], x)
    assert _rel(build_apply(mods, plan)(tree["trunk"], x), want) < TOL


# -- the grouped conv's batch-split data gradient -----------------------------

def test_grouped_conv_backward_splits_its_data_gradient(monkeypatch):
    """At ``groups = C`` the batch-split path of ``conv_backward`` gives
    autograd's gradients, chunk by chunk (batch 5 in chunks of 2, 2, 1),
    inside the ``dwconv`` backward range: a stride-2 depthwise conv, which
    the depthwise kernels do not take (a stride-1 one takes them and never
    splits, ``tests/test_torch_dwconv_wgrad.py``)."""
    m = L.DepthwiseConv(C, k=7, s=2, p=3)
    prm = m.init(torch.Generator().manual_seed(1), (9, 9, C), "cpu")
    prm["b"] = torch.randn(C, generator=torch.Generator().manual_seed(2))
    x = torch.randn((5, 9, 9, C), generator=torch.Generator().manual_seed(3))
    g = torch.randn((5, 5, 5, C), generator=torch.Generator().manual_seed(4))

    def ref(xs, q):
        return F.conv2d(xs.permute(0, 3, 1, 2), q["w"].permute(3, 2, 0, 1),
                        q["b"], stride=2, padding=3,
                        groups=C).permute(0, 2, 3, 1)

    _, want = _grads(ref, x, prm, g)
    monkeypatch.setattr(L, "DGRAD_SPLIT_BYTES", 0)
    monkeypatch.setattr(L, "DGRAD_CHUNK_BYTES", 2 * 9 * 9 * C * 4)
    with obs.profiling() as cap:
        _, got = _grads(lambda xs, q: m.apply(q, xs), x, prm, g)
    assert cap.count("conv.dgrad_chunks") == 3
    assert cap.count("conv.depthwise_calls") == 1
    split = [r for r in cap.records if r.name == "conv_dgrad_split"]
    assert len(split) == 1
    assert cap.records[split[0].parent].name == "dwconv"
    assert cap.records[split[0].parent].attrs == {"phase": "bwd"}
    for a, b in zip(got, want):
        assert _rel(a, b) < TOL


# -- the 2PS caps at ConvNeXt-B's own size ------------------------------------

#: sqrt(44) = 7 even segments of ConvNeXt-B's 44 modules at 384²: the stem
#: and stage 1 (96 rows, three 7x7 blocks) hold N=8; stage 2's segment
#: (48 rows) 2; the stage 3 and 4 segments (24 and 12 rows, six blocks
#: each: 18 halo rows a side) 1
SEGMENTS_384 = ((0, 7, 8), (7, 14, 2), (14, 20, 1), (20, 26, 1),
                (26, 32, 1), (32, 38, 1), (38, 44, 1))


def test_twophase_caps_at_384():
    mods = convnext.convnext_modules()
    hs = L.trunk_heights(mods, 384)
    segs = derive_segments(mods, 384, "twophase", 8, None)
    assert segs == SEGMENTS_384
    caps = segment_row_capacity(mods, 384, "twophase")
    for (a, b, n), (_, _, cap) in zip(segs, caps):
        sub = mods[a:b]
        assert n == min(8, cap)
        assert tp.validate_plan(tp.module_boundaries(sub, hs[a], n))
        assert tp.validate_plan(tp.module_boundaries(sub, hs[a], cap))
        try:
            over = tp.validate_plan(tp.module_boundaries(sub, hs[a],
                                                         cap + 1))
        except ValueError:
            over = False
        assert not over, (a, b, cap)


# -- the trainer ---------------------------------------------------------------

def test_trainer_runs_the_reduced_preset(tmp_path, capsys):
    from repro_torch.launch import train
    train.main(["--arch", "convnext_b384", "--preset", "reduced",
                "--steps", "2", "--device", "cpu", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "engine=overlap N=2" in out and "arch=convnext_b384" in out
    assert out.count(" loss ") == 2
