"""2PS and the hybrid engines of the port against the JAX package.

Trunks: VGG-16 at width 0.125 with 3 stages, and ResNet-50 at width 0.125
with ``stage_blocks=[1, 1, 1, 1]`` (the reference's row-engine and
residency test trunks), image 64, batch 2.  The same numpy parameters,
input and (positive) output weights go to both packages; the loss is
``sum(trunk(x) * w)``.

The planning half (bounds, ``need_lo``, validity), ``twophase_forward``
and ``make_splitcnn_apply`` of the reference import in this process.  Its
2PS engine needs ``repro.exec``, which does not import where JAX lacks
``jax.sharding.TransferToMemoryKind`` (JAX 0.9): those reference values
come from one child process, started once for this module, which maps that
name onto ``jax.memory.Space`` before importing ``repro.exec`` and writes
its numbers into ``tmp_path``.  The stand-in exists only in the child.

Loss and every gradient (params and input) must agree to 1e-5 relative,
integers must be equal.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import overlap as ref_ov
from repro.core import twophase as ref_tp
from repro.models.cnn.resnet import resnet50_modules as ref_resnet50_modules
from repro.models.cnn.vgg import vgg16_modules as ref_vgg16_modules
from repro_torch.core import overlap as pt_ov
from repro_torch.core import twophase as pt_tp
from repro_torch.exec import ExecutionPlan, ResidencySpec, build_apply
from repro_torch.models.cnn.layers import params_from_reference
from repro_torch.models.cnn.resnet import resnet50_modules
from repro_torch.models.cnn.vgg import vgg16_modules
from repro_torch.optim.adamw import tree_leaves
from test_torch_resnet import np_trunk

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5
H = 64
SHAPE = (H, H, 3)


def _mods(arch):
    if arch == "vgg":
        return ref_vgg16_modules(0.125, 3), vgg16_modules(0.125, 3)
    return (ref_resnet50_modules(0.125, [1, 1, 1, 1]),
            resnet50_modules(0.125, [1, 1, 1, 1]))


def _inputs(arch):
    ref_m, _ = _mods(arch)
    tree = np_trunk(ref_m, SHAPE, seed=0)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2,) + SHAPE).astype(np.float32)
    shape = SHAPE
    for m in ref_m:
        shape = m.out_shape(shape)
    w = rng.uniform(0.5, 1.5, size=(2,) + shape).astype(np.float32)
    return tree["trunk"], x, w


#: (arch, engine, N, residency default, prefetch_depth)
RESIDENCIES = [("device", 1), ("host", 0), ("host", 1), ("host", 2),
               ("recompute", 1)]
CASES = [("vgg", e, n, p, d)
         for e, n in (("twophase", 2), ("twophase_h", 3))
         for p, d in RESIDENCIES] \
    + [("vgg", e, n, p, 1)
       for e, n in (("ckp", 1), ("overlap_h", 3))
       for p in ("device", "host")] \
    + [("resnet", "twophase_h", 3, p, 1)
       for p in ("device", "host", "recompute")] \
    + [("resnet", e, n, "device", 1)
       for e, n in (("twophase", 2), ("ckp", 1), ("overlap_h", 2))]


def _cid(c):
    return "-".join(map(str, c))


#: the child compiles many small programs; one XLA thread keeps it from
#: crowding other test workers, and is no slower
CHILD_XLA_FLAGS = ("--xla_cpu_multi_thread_eigen=false "
                   "intra_op_parallelism_threads=1")

CHILD = r'''
import json, sys
import numpy as np
import jax, jax.numpy as jnp
import jax.memory, jax.sharding
if not hasattr(jax.sharding, "TransferToMemoryKind"):
    # JAX 0.9 dropped the name repro.exec.rowprog imports; this process only
    jax.sharding.TransferToMemoryKind = lambda kind: (
        jax.memory.Space.Host if "host" in kind else jax.memory.Space.Device)
from repro.exec import ExecutionPlan, ResidencySpec, build_apply
from repro.models.cnn.resnet import resnet50_modules
from repro.models.cnn.vgg import vgg16_modules

d = sys.argv[1]
cases = json.load(open(d + "/cases.json"))
inp = np.load(d + "/inputs.npz")
H = 64

def trunk(arch, n):
    t = [{} for _ in range(n)]
    for k in inp.files:
        parts = k.split("|")
        if parts[0] != arch or parts[1] != "p":
            continue
        node = t[int(parts[2])]
        for p in parts[3:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(inp[k])
    return tuple(t)

def flat(prefix, tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            flat(prefix + "|" + k, tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            flat(prefix + "|" + str(i), t, out)
    else:
        out[prefix] = np.asarray(tree)

res = {}
for arch, engine, n, policy, depth in cases:
    mods = vgg16_modules(0.125, 3) if arch == "vgg" \
        else resnet50_modules(0.125, [1, 1, 1, 1])
    params = trunk(arch, len(mods))
    x, w = jnp.asarray(inp[arch + "|x"]), jnp.asarray(inp[arch + "|w"])
    plan = ExecutionPlan(engine=engine, n_rows=n, in_shape=(H, H, 3),
                         residency=ResidencySpec(default=policy,
                                                 prefetch_depth=depth))
    apply = build_apply(mods, plan)
    loss = lambda p, xx: jnp.sum(apply(p, xx) * w)
    val, (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        params, x)
    cid = "-".join(map(str, (arch, engine, n, policy, depth)))
    res[cid + "|loss"] = np.asarray(val)
    res[cid + "|gx"] = np.asarray(gx)
    flat(cid + "|g", gp, res)
np.savez(d + "/out.npz", **res)
'''


def _flat(prefix, tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flat(f"{prefix}|{k}", tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            _flat(f"{prefix}|{i}", t, out)
    else:
        out[prefix] = np.asarray(tree)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's loss and gradients for every case, computed by the
    child process."""
    d = tmp_path_factory.mktemp("ref_twophase")
    arrays = {}
    for arch in ("vgg", "resnet"):
        trunk, x, w = _inputs(arch)
        _flat(f"{arch}|p", trunk, arrays)
        arrays[f"{arch}|x"], arrays[f"{arch}|w"] = x, w
    np.savez(d / "inputs.npz", **arrays)
    (d / "cases.json").write_text(json.dumps(CASES))
    r = subprocess.run(
        [sys.executable, "-c", CHILD, str(d)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 JAX_PLATFORMS="cpu", XLA_FLAGS=CHILD_XLA_FLAGS),
        capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(d / "out.npz"))


def _port_loss_and_grads(arch, engine, n, policy, depth):
    _, pt_m = _mods(arch)
    trunk, x, w = _inputs(arch)
    p = params_from_reference({"trunk": trunk, "head": {}}, "cpu")["trunk"]
    for t in tree_leaves(p):
        t.requires_grad_()
    xt = torch.tensor(x, requires_grad=True)
    plan = ExecutionPlan(engine=engine, n_rows=n, in_shape=SHAPE,
                         residency=ResidencySpec(default=policy,
                                                 prefetch_depth=depth))
    loss = (build_apply(pt_m, plan)(p, xt) * torch.tensor(w)).sum()
    loss.backward()
    return loss.item(), _flat("g", [_grad_tree(d) for d in p], {}), \
        xt.grad.numpy()


def _grad_tree(d):
    return {k: _grad_tree(v) if isinstance(v, dict) else v.grad
            for k, v in d.items()}


def _rel(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max()) / max(float(np.abs(a).max()), 1e-30)


@pytest.mark.parametrize("case", CASES, ids=_cid)
def test_engine_loss_and_grads_match_reference(reference, case):
    cid = _cid(case)
    loss, grads, gx = _port_loss_and_grads(*case)
    want = float(reference[cid + "|loss"])
    assert abs(loss - want) / abs(want) < TOL
    ref_g = {k[len(cid) + 1:]: v for k, v in reference.items()
             if k.startswith(cid + "|g|")}
    assert sorted(ref_g) == sorted(grads)
    for k in ref_g:
        assert _rel(ref_g[k], grads[k]) < TOL, k
    assert _rel(reference[cid + "|gx"], gx) < TOL


@pytest.mark.parametrize("arch,n", [("vgg", 1), ("vgg", 2), ("vgg", 3),
                                    ("resnet", 1), ("resnet", 2),
                                    ("resnet", 3)])
def test_module_boundaries_equal(arch, n):
    ref_m, pt_m = _mods(arch)
    if n > ref_tp.trunk_heights(ref_m, H)[-1]:  # more rows than output rows
        with pytest.raises(ValueError):
            ref_tp.module_boundaries(ref_m, H, n)
        with pytest.raises(ValueError):
            pt_tp.module_boundaries(pt_m, H, n)
        return
    want = ref_tp.module_boundaries(ref_m, H, n)
    got = pt_tp.module_boundaries(pt_m, H, n)
    assert (got.heights, got.bounds, got.need_lo) \
        == (want.heights, want.bounds, want.need_lo)
    assert pt_tp.validate_plan(got) == ref_tp.validate_plan(want)
    assert got.cache_sizes() == want.cache_sizes()


@pytest.mark.parametrize("arch,width,blocks_or_stages,image,want", [
    ("vgg", 1.0, 5, 224, 2), ("vgg", 1.0, 5, 64, 1),
    ("vgg", 0.125, 3, 64, None), ("resnet", 1.0, None, 224, 1),
    ("resnet", 0.125, [1, 1, 1, 1], 64, None),
])
def test_max_valid_rows_equal(arch, width, blocks_or_stages, image, want):
    if arch == "vgg":
        ref_m = ref_vgg16_modules(width, blocks_or_stages)
        pt_m = vgg16_modules(width, blocks_or_stages)
    else:
        ref_m = ref_resnet50_modules(width, blocks_or_stages)
        pt_m = resnet50_modules(width, blocks_or_stages)
    got = pt_tp.max_valid_rows(pt_m, image)
    assert got == ref_tp.max_valid_rows(ref_m, image)
    if want is not None:
        assert got == want


@pytest.mark.parametrize("arch,n", [("vgg", 1), ("vgg", 2), ("resnet", 2)])
def test_twophase_forward_matches_reference(arch, n):
    ref_m, pt_m = _mods(arch)
    trunk, x, _ = _inputs(arch)
    plan_r = ref_tp.module_boundaries(ref_m, H, n)
    plan_p = pt_tp.module_boundaries(pt_m, H, n)
    want, want_c = ref_tp.twophase_forward(
        ref_m, jax.tree.map(jnp.asarray, trunk), jnp.asarray(x), plan_r,
        return_caches=True)
    p = params_from_reference({"trunk": trunk, "head": {}}, "cpu")["trunk"]
    got, got_c = pt_tp.twophase_forward(pt_m, p, torch.tensor(x), plan_p,
                                        return_caches=True)
    assert _rel(np.asarray(want), got.numpy()) < TOL
    assert [[tuple(c.shape) for c in row] for row in got_c] \
        == [[tuple(c.shape) for c in row] for row in want_c]


def test_splitcnn_matches_reference_and_is_broken():
    ref_m, pt_m = _mods("vgg")
    trunk, x, _ = _inputs("vgg")
    want = ref_ov.make_splitcnn_apply(ref_m, H, 2)(
        jax.tree.map(jnp.asarray, trunk), jnp.asarray(x))
    p = params_from_reference({"trunk": trunk, "head": {}}, "cpu")["trunk"]
    got = pt_ov.make_splitcnn_apply(pt_m, H, 2)(p, torch.tensor(x))
    assert _rel(np.asarray(want), got.numpy()) < TOL
    base = pt_ov.make_column_apply(pt_m)(p, torch.tensor(x))
    assert got.shape == base.shape
    assert float((got - base).abs().max()) > 1e-3  # seams lose features


def test_reduced_vgg_preset_request_raises_in_both():
    """The reduced VGG preset's own request (twophase N=2 at 64²) exceeds
    2PS's granularity bound; both packages raise, neither fixes it."""
    from repro_torch.configs import vgg16 as cfg
    from repro_torch.exec import Planner
    c = cfg.reduced()
    shape = (c.image, c.image, c.channels)
    mods = vgg16_modules(c.width_mult)
    plan = Planner(mods, shape, c.batch).resolve(c.plan)
    assert (plan.engine, plan.n_rows) == ("twophase", 2)
    with pytest.raises(ValueError, match="granularity bound"):
        build_apply(mods, plan)
    with pytest.raises(ValueError, match="granularity bound"):
        ref_tp.make_twophase_apply(ref_vgg16_modules(c.width_mult), c.image,
                                   2)


def test_twophase_split_dgrad_matches_column_path(monkeypatch):
    """2PS N=2 with ``DGRAD_SPLIT_BYTES`` below some of its row convs'
    tensors (their data gradients in batch chunks of one image) gives the
    column path's loss and gradients, and ``conv.dgrad_chunks`` counts one
    chunk an image for each (row, conv) whose input or output exceeds the
    limit, from the plan's shapes."""
    from repro_torch import obs
    from repro_torch.models.cnn import layers
    from repro_torch.models.cnn.layers import Conv
    want = _port_loss_and_grads("vgg", "base", 1, "device", 1)
    _, pt_m = _mods("vgg")
    plan = pt_tp.module_boundaries(pt_m, H, 2)
    sizes, cin = [], 3
    for l, m in enumerate(pt_m):
        if isinstance(m, Conv):
            for r in range(2):  # stride 1, padding 1: out rows = in rows
                px = (plan.bounds[l][r + 1] - plan.need_lo[l][r]) \
                    * plan.heights[l] * 4
                sizes.append(max(px * cin, px * m.cout))
            cin = m.cout
    limit = 2 * sorted(sizes)[len(sizes) // 2]  # bytes at batch 2
    monkeypatch.setattr(layers, "DGRAD_SPLIT_BYTES", limit)
    monkeypatch.setattr(layers, "DGRAD_CHUNK_BYTES", 1)
    with obs.capture() as s:
        loss, grads, gx = _port_loss_and_grads("vgg", "twophase", 2,
                                               "device", 1)
    n_split = sum(2 * b > limit for b in sizes)
    assert 0 < n_split < len(sizes)
    assert s.metrics.counter("conv.dgrad_chunks").value == 2 * n_split
    assert abs(loss - want[0]) / abs(want[0]) < TOL
    assert sorted(grads) == sorted(want[1])
    for k in grads:
        assert _rel(want[1][k], grads[k]) < TOL, k
    assert _rel(want[2], gx) < TOL
