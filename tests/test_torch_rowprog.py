"""The port's row-program executor (``exec/rowprog.py``) on the CPU.

* A toy carry program (each row adds the previous row's last output row)
  against the same function written as one autograd graph: values and
  gradients, under every residency policy and prefetch depth.
* The 2PS engines under ``host`` and ``recompute`` residency against
  ``device`` residency with ``torch.equal``: placement moves bytes, never
  values.  On CPU tensors host residency moves nothing (the reference's
  ``offload_is_noop``); recompute saves zero-size sentinels.
* The saved 2PS boundary caches own their storage (a slice of a row
  activation is a view, and saving it would keep the whole activation):
  at batch 1, where an H-slice of NHWC is already contiguous, and at
  batch 2.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import twophase as pt_tp
from repro_torch.exec import ExecutionPlan, ResidencySpec, build_apply
from repro_torch.exec.rowprog import (
    RowProgram, make_rowprog_apply, offload_is_noop, rowprog_forward,
)
from repro_torch.models.cnn.layers import flatten_params
from repro_torch.models.cnn.resnet import init_resnet50
from repro_torch.models.cnn.vgg import init_vgg16
from repro_torch.optim.adamw import tree_leaves

H = 64
SHAPE = (H, H, 3)
POLICIES = [("device", 1), ("host", 0), ("host", 1), ("host", 2),
            ("recompute", 1)]


class _Running(RowProgram):
    """Rows of ``x`` (B, R*4, C): ``y_r = tanh(x_r * w) + carry``, the
    carry being ``y_r``'s last row (named ``"tail"``)."""

    def __init__(self, n_rows):
        self.n_rows = n_rows

    def carry_names(self, r):
        return () if r == 0 else "tail"

    def row_args(self, args, r):
        x, w = args
        return x[:, 4 * r:4 * r + 4], w

    def add_row_grad(self, dargs, drow, r):
        if dargs[0] is not None:
            dargs[0][:, 4 * r:4 * r + 4] += drow[0]
        if dargs[1] is not None:
            dargs[1] += drow[1]

    def row_step(self, carry, row_args, r):
        x_r, w = row_args
        y = torch.tanh(x_r * w)
        if carry:
            y = y + carry[0]
        return (y[:, -1:].clone(),), y

    def finish(self, ys):
        return torch.cat(ys, dim=1)

    def out_cotangent(self, g, r):
        return g[:, 4 * r:4 * r + 4]


def _plain_running(x, w, n_rows):
    ys, tail = [], None
    for r in range(n_rows):
        y = torch.tanh(x[:, 4 * r:4 * r + 4] * w)
        if tail is not None:
            y = y + tail
        tail = y[:, -1:]
        ys.append(y)
    return torch.cat(ys, dim=1)


@pytest.mark.parametrize("policy,depth", POLICIES)
def test_toy_program_matches_one_graph(policy, depth):
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(2, 20, 3)).astype(np.float32)
    w0 = rng.normal(size=(3,)).astype(np.float32)
    g = torch.tensor(rng.normal(size=(2, 20, 3)).astype(np.float32))
    res = ResidencySpec(default=policy, prefetch_depth=depth)
    apply = make_rowprog_apply(_Running(5), res)
    outs = []
    for fn in (apply, lambda x, w: _plain_running(x, w, 5)):
        x = torch.tensor(x0, requires_grad=True)
        w = torch.tensor(w0, requires_grad=True)
        y = fn(x, w)
        y.backward(g)
        outs.append((y.detach(), x.grad, w.grad))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    # the forward sweep alone gives the same output
    fwd = rowprog_forward(_Running(5), (torch.tensor(x0), torch.tensor(w0)))
    torch.testing.assert_close(fwd, outs[0][0], rtol=0, atol=0)


def test_carry_names_must_match_the_carry():
    class Bad(_Running):
        def carry_names(self, r):
            return () if r == 0 else ("a", "b")

    x = torch.zeros(1, 8, 2, requires_grad=True)
    with pytest.raises(ValueError, match="carry_names"):
        make_rowprog_apply(Bad(2))(x, torch.ones(2))


def test_offload_is_noop_only_off_the_card():
    assert offload_is_noop("cpu") and offload_is_noop(torch.device("cpu"))
    assert not offload_is_noop("cuda")


def _trunk(arch):
    g = torch.Generator().manual_seed(0)
    if arch == "vgg":
        mods, p = init_vgg16(g, SHAPE, 0.125, n_stages=3, device="cpu")
    else:
        mods, p = init_resnet50(g, SHAPE, 0.125, stage_blocks=[1, 1, 1, 1],
                                device="cpu")
    return mods, p["trunk"]


def _run(arch, engine, n, res, batch=2):
    mods, trunk = _trunk(arch)
    for t in tree_leaves(trunk):
        t.requires_grad_()
    x = torch.randn((batch,) + SHAPE, generator=torch.Generator()
                    .manual_seed(1), requires_grad=True)
    plan = ExecutionPlan(engine=engine, n_rows=n, in_shape=SHAPE,
                         residency=res)
    y = build_apply(mods, plan)(trunk, x)
    y.square().sum().backward()
    return [y.detach(), x.grad] + [t.grad for t in tree_leaves(trunk)]


@pytest.mark.parametrize("arch,engine,n", [("vgg", "twophase", 2),
                                           ("vgg", "twophase_h", 4),
                                           ("resnet", "twophase", 2),
                                           ("resnet", "twophase_h", 3)])
@pytest.mark.parametrize("policy,depth", POLICIES[1:])
def test_residency_equals_device_exactly(arch, engine, n, policy, depth):
    want = _run(arch, engine, n, None)
    got = _run(arch, engine, n, ResidencySpec(default=policy,
                                              prefetch_depth=depth))
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def _saved_carries(arch, n, res, batch):
    """The placed carries the 2PS function saved for its backward."""
    mods, trunk = _trunk(arch)
    leaves, spec = flatten_params(trunk)
    leaves = [t.requires_grad_() for t in leaves]
    plan = pt_tp.module_boundaries(mods, H, n)
    prog = pt_tp.TwoPhaseRowProgram(mods, plan, spec)
    x = torch.randn((batch,) + SHAPE,
                    generator=torch.Generator().manual_seed(2))
    y = make_rowprog_apply(prog, res)(x, *leaves)
    return y.grad_fn.saved, prog


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("arch", ["vgg", "resnet"])
def test_saved_caches_own_their_storage(arch, batch):
    saved, prog = _saved_carries(arch, 2, None, batch)
    leaves = [t for row in saved for t in row]
    assert len(saved) == 2 and saved[0] == ()
    assert len(saved[1]) == prog.plan.n_levels - 1
    assert any(t.shape[1] > 0 for t in leaves)
    for t in leaves:
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()


def test_zero_height_heads_and_cpu_placements():
    saved, prog = _saved_carries("vgg", 2, None, 2)
    heads = [r for row in prog.plan.cache_sizes() for r in row]
    # a pool boundary that needs no row above exports a zero-height head
    assert 0 in heads and any(h > 0 for h in heads)
    assert [t.shape[1] for t in saved[1]] == heads[1:]
    host, _ = _saved_carries("vgg", 2, ResidencySpec(default="host"), 2)
    for a, b in zip(saved[1], host[1]):  # no bytes move on the CPU
        assert torch.equal(a, b) and b.device.type == "cpu"
    rec, _ = _saved_carries("vgg", 2, ResidencySpec(default="recompute"), 2)
    assert all(t.numel() == 0 for t in rec[1])
    mixed, _ = _saved_carries("vgg", 2, ResidencySpec(
        default="device", placements=(("sd_l3", "recompute"),)), 2)
    names = prog.carry_names(1)
    for name, t, full in zip(names, mixed[1], saved[1]):
        assert t.numel() == 0 if name == "sd_l3" else torch.equal(t, full)
