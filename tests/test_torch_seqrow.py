"""The port's sequence row programs, the ``seq_*`` engines and the planned
LM step against the JAX package, on the CPU.

* ``core/seqrow.py``: the checkpointed helpers (``chunked_apply``,
  ``carry_scan_remat``, ``swa_overlap_chunks``) against the reference's;
  the four row programs on the port's executor under every residency
  policy, and the makers and the op-level ``seq_chunked`` /
  ``seq_carry_scan`` / ``seq_swa_overlap`` engines, against the
  reference's helpers (the same math) and against the reference's own
  row-program executor.
* The planned LM step: ``Planner.for_model`` plan JSON for the five
  configs this slice adds (reduced and full, with budgets, residency and a
  kernel); loss and every gradient of the dense, SSM and hybrid families
  under device, host and recompute residency; the offloading plan driving
  the executor (its counters); the carry-scan plan's kernel fallback; and
  the trainer's steps under each residency and under ``--budget-gb``.

The reference's executor and Planner (``repro.exec``) do not import where
``jax.sharding`` lacks ``TransferToMemoryKind`` (JAX 0.9): those reference
values come from one child process, started once for this module, which
installs a stand-in for that name and writes its numbers into
``tmp_path``.  The stand-in exists only in the child.  fp32 throughout:
1e-5 relative (max |diff| over max |reference| per leaf); the SSD decay
rates ``a_log`` and ``dt_bias`` at 5e-5 (``tests/test_torch_ssm.py`` says
why).  Trajectories: 1e-5 at step 0, times 10 per step.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.core import seqrow as ref_sr
from repro.models.lm import model as ref_model
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import seqrow as sr
from repro_torch.exec import ExecutionPlan, Planner, ResidencySpec, build_apply
from repro_torch.exec.rowprog import make_rowprog_apply
from repro_torch.launch import train as T
from repro_torch.models.lm import model
from repro_torch.optim.adamw import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (name, default placement, prefetch depth)
POLICIES = [("device", "device", 1), ("host0", "host", 0),
            ("host1", "host", 1), ("host2", "host", 2),
            ("recompute", "recompute", 1)]
DECAY_LEAVES = ("a_log", "dt_bias")


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """One torch CPU thread for this module: its many small ops (xLSTM's
    per-token loop above all) take the same time alone on one thread and
    do not stall beside other test workers, and multi-threaded CPU
    reductions are not bit-reproducible from run to run, while some
    cases here compare runs bit for bit."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _spec(policy):
    name = {p[0]: p for p in POLICIES}[policy]
    return ResidencySpec(default=name[1], prefetch_depth=name[2])


def _rel(want, got):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape, (want.shape, got.shape)
    return float(np.abs(want - got).max()) / max(
        float(np.abs(want).max()), 1e-30)


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# Row-program cases: one JAX body per case, exec'd here and in the child
# ---------------------------------------------------------------------------

#: the reference side of every case; ``run(name, apply)`` takes the case's
#: apply (None: the reference helper) and returns its outputs, then the
#: gradients of ``sum(out ** 2) + sum(carry ** 2)`` in every input
JAX_CASES = r'''
import jax, jax.numpy as jnp
from repro.core import seqrow as SR

WINDOW, N = 16, 4


def ema_body(carry, chunk):          # chunk (B, c, D): the 2PS carry
    def step(c, xt):
        c = 0.9 * c + 0.1 * xt
        return c, c
    carry, ys = jax.lax.scan(step, carry, jnp.moveaxis(chunk, 1, 0))
    return carry, jnp.moveaxis(ys, 0, 1)


def pair_body(carry, chunk):         # two carried leaves, two streams
    c, m = carry
    a, b = chunk
    def step(cm, ab):
        c, m = cm
        c = 0.8 * c + jnp.tanh(ab[0] * ab[1])
        m = jnp.maximum(m, c)
        return (c, m), c - m
    (c, m), ys = jax.lax.scan(step, (c, m), (jnp.moveaxis(a, 1, 0),
                                            jnp.moveaxis(b, 1, 0)))
    return (c, m), jnp.moveaxis(ys, 0, 1)


def const_body(consts, carry, chunk):  # weights every row reads
    w, bias = consts
    def step(h, xt):
        h = jnp.tanh(h @ w + xt + bias)
        return h, h
    carry, ys = jax.lax.scan(step, carry, jnp.moveaxis(chunk, 1, 0))
    return carry, jnp.moveaxis(ys, 0, 1)


def tanh_fn(w):
    return lambda u: jnp.tanh(u @ w)


def attend(qc, kc, vc, q_offset, k_offset):
    d = qc.shape[-1]
    s = jnp.einsum("bqhd,bkhd->bhqk", qc, kc) / jnp.sqrt(d)
    qp = q_offset + jnp.arange(qc.shape[1])
    kp = k_offset + jnp.arange(kc.shape[1])
    ok = (kp[None, :] <= qp[:, None]) \
        & (kp[None, :] > qp[:, None] - WINDOW) & (kp[None, :] >= 0)
    s = jnp.where(ok[None, None], s, -1e30)
    return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, -1), vc)


def _stack(u):
    B, S = u.shape[:2]
    return jnp.moveaxis(u.reshape((B, N, S // N) + u.shape[2:]), 1, 0)


def _loss(res):
    return sum(jnp.sum(l ** 2) for l in jax.tree.leaves(res))


def run(name, inp, apply=None, n=N):
    """(outputs, gradients) of case ``name`` on ``inp`` (numpy arrays);
    ``n`` chunks for the reference helpers of the carry and swa cases."""
    a = {k: jnp.asarray(v) for k, v in inp.items()}
    if name == "carry":
        f = apply or (lambda c0, x: SR.carry_scan_remat(ema_body, c0, x, n))
        args = (a["c0"], a["x"])
    elif name == "stacked":
        f = apply or (lambda c0, xs: jax.lax.scan(pair_body, c0, xs))
        args = ((a["c0"], a["m0"]), (_stack(a["xa"]), _stack(a["xb"])))
    elif name == "consts":
        f = apply or (lambda c0, xs, k: jax.lax.scan(
            lambda c, x: const_body(k, c, x), c0, xs))
        args = (a["c0"], _stack(a["x"]), (a["w"], a["bias"]))
    elif name == "chunked":
        f = apply or (lambda x, w: SR.chunked_apply(tanh_fn(w), x, N))
        args = (a["x"], a["w"])
    else:  # swa
        f = apply or (lambda q, k, v: SR.swa_overlap_chunks(
            attend, q, k, v, WINDOW, n))
        args = (a["q"], a["k"], a["v"])
    out = f(*args)
    # the chunked case's weight is a constant the rows close over (the
    # executors differentiate their args only)
    diff = (0,) if name == "chunked" else tuple(range(len(args)))
    grads = jax.grad(lambda *xs: _loss(f(*xs)), argnums=diff)(*args)
    return jax.tree.leaves(out), jax.tree.leaves(grads)


def ref_executor_apply(name, policy):
    """The reference's row-program form of case ``name`` under
    ``policy`` (needs repro.exec)."""
    from repro.exec import ResidencySpec
    from repro.exec.rowprog import make_rowprog_apply
    res = ResidencySpec(default=policy)
    if name == "carry":
        return SR.make_carry_scan_apply(ema_body, N, 1, residency=res)
    if name == "stacked":
        return SR.make_stacked_carry_scan_apply(pair_body, N, residency=res)
    if name == "consts":
        return SR.make_stacked_carry_scan_apply(const_body, N, residency=res,
                                                with_consts=True)
    if name == "chunked":
        return lambda x, w: make_rowprog_apply(
            SR.ChunkedRowProgram(tanh_fn(w), N, 1), res)(x)
    return make_rowprog_apply(SR.SwaOverlapRowProgram(attend, WINDOW, N),
                              res)
'''

CASE_NAMES = ["carry", "stacked", "consts", "chunked", "swa"]


def _case_inputs(name):
    if name == "carry":
        return {"c0": _np(1, 2, 8), "x": _np(2, 2, 32, 8)}
    if name == "stacked":
        return {"c0": _np(3, 2, 6), "m0": _np(4, 2, 6),
                "xa": _np(5, 2, 32, 6), "xb": _np(6, 2, 32, 6)}
    if name == "consts":
        return {"c0": _np(7, 2, 6), "x": _np(8, 2, 32, 6),
                "w": _np(9, 6, 6, scale=0.4), "bias": _np(10, 6)}
    if name == "chunked":
        return {"x": _np(11, 2, 32, 16), "w": _np(12, 16, 16, scale=0.3)}
    return {k: _np(13 + i, 2, 64, 2, 16) for i, k in enumerate("qkv")}


# the port's side of the same bodies

def _ema_body(carry, chunk):
    ys = []
    for t in range(chunk.shape[1]):
        carry = 0.9 * carry + 0.1 * chunk[:, t]
        ys.append(carry)
    return carry, torch.stack(ys, dim=1)


def _pair_body(carry, chunk):
    c, m = carry
    a, b = chunk
    ys = []
    for t in range(a.shape[1]):
        c = 0.8 * c + torch.tanh(a[:, t] * b[:, t])
        m = torch.maximum(m, c)
        ys.append(c - m)
    return (c, m), torch.stack(ys, dim=1)


def _const_body(consts, carry, chunk):
    w, bias = consts
    ys = []
    for t in range(chunk.shape[1]):
        carry = torch.tanh(carry @ w + chunk[:, t] + bias)
        ys.append(carry)
    return carry, torch.stack(ys, dim=1)


def _attend(qc, kc, vc, q_offset, k_offset):
    d = qc.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", qc, kc) / np.sqrt(np.float32(d))
    qp = q_offset + torch.arange(qc.shape[1])
    kp = k_offset + torch.arange(kc.shape[1])
    ok = (kp[None, :] <= qp[:, None]) \
        & (kp[None, :] > qp[:, None] - 16) & (kp[None, :] >= 0)
    s = torch.where(ok[None, None], s, -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vc)


def _stack(u):
    B, S = u.shape[:2]
    return torch.movedim(u.reshape((B, 4, S // 4) + u.shape[2:]), 1, 0)


def _port_apply(name, kind, res):
    """The port's apply for case ``name``: ``kind`` "program" drives the
    row program on the executor directly, "maker" takes the make_* form,
    "engine" the op-level engine through ``build_apply``."""
    if name == "carry":
        if kind == "engine":
            return build_apply(_ema_body, ExecutionPlan.explicit(
                "seq_carry_scan", 4, axis=1, residency=res))
        if kind == "maker":
            return sr.make_carry_scan_apply(_ema_body, 4, 1, residency=res)
        prog = sr.CarryScanRowProgram(_ema_body, 4, 1)
        return sr._carry_scan_apply(prog, res)
    if name in ("stacked", "consts"):
        body, wc = (_pair_body, False) if name == "stacked" \
            else (_const_body, True)
        if kind == "program":
            return sr._carry_scan_apply(
                sr.StackedCarryScanRowProgram(body, 4, wc), res)
        return sr.make_stacked_carry_scan_apply(body, 4, residency=res,
                                                with_consts=wc)
    if name == "chunked":
        if kind == "program":
            return lambda x, w: make_rowprog_apply(sr.ChunkedRowProgram(
                lambda u: torch.tanh(u @ w), 4, 1), res)(x)
        if kind == "engine":
            return lambda x, w: build_apply(
                lambda u: torch.tanh(u @ w),
                ExecutionPlan.explicit("seq_chunked", 4, residency=res))(x)
        return lambda x, w: sr.make_chunked_apply(
            lambda u: torch.tanh(u @ w), 4, 1, residency=res)(x)
    if kind == "program":
        return make_rowprog_apply(sr.SwaOverlapRowProgram(_attend, 16, 4),
                                  res)
    if kind == "engine":
        return build_apply(_attend, ExecutionPlan.explicit(
            "seq_swa_overlap", 4, window=16, residency=res))
    return sr.make_swa_overlap_apply(_attend, 16, 4, residency=res)


def _diff_keys(name, inp):
    """The inputs a case differentiates (the chunked case's weight is a
    constant its rows close over)."""
    return ["x"] if name == "chunked" else list(inp)


def _port_run(name, inp, apply):
    a = {k: torch.tensor(v).requires_grad_(k in _diff_keys(name, inp))
         for k, v in inp.items()}
    if name == "carry":
        args = (a["c0"], a["x"])
    elif name == "stacked":
        args = ((a["c0"], a["m0"]), (_stack(a["xa"]), _stack(a["xb"])))
    elif name == "consts":
        args = (a["c0"], _stack(a["x"]), (a["w"], a["bias"]))
    elif name == "chunked":
        args = (a["x"], a["w"])
    else:
        args = (a["q"], a["k"], a["v"])
    out = apply(*args)
    leaves = [t for t in torch.utils._pytree.tree_leaves(out)]
    sum(t.square().sum() for t in leaves).backward()
    return [t.detach() for t in leaves], \
        [a[k].grad for k in _diff_keys(name, inp)]


@functools.lru_cache(maxsize=None)
def _jax_cases():
    ns = {}
    exec(JAX_CASES, ns)
    return ns


@functools.lru_cache(maxsize=None)
def _reference_helper(name, n=4):
    """The reference helper's outputs and gradients on case ``name``'s
    inputs (the same for every policy and form of the port's)."""
    return _jax_cases()["run"](name, _case_inputs(name), n=n)


def _grad_order(name, inp):
    """The reference's gradient leaves follow its args' order; the port's
    follow ``inp``'s keys.  Map the first onto the second."""
    order = {"carry": ["c0", "x"], "stacked": ["c0", "m0", "xa", "xb"],
             "consts": ["c0", "x", "w", "bias"], "chunked": ["x"],
             "swa": ["q", "k", "v"]}[name]
    return [order.index(k) for k in _diff_keys(name, inp)]


def _unstack_grads(name, grads):
    """The reference helper sees stacked xs for the stacked cases; undo
    the stacking of their gradients so they line up with ``inp``."""
    def unstack(g):
        g = np.moveaxis(np.asarray(g), 0, 1)
        return g.reshape((g.shape[0], -1) + g.shape[3:])
    if name == "stacked":
        return [grads[0], grads[1], unstack(grads[2]), unstack(grads[3])]
    if name == "consts":
        return [grads[0], unstack(grads[1]), grads[2], grads[3]]
    return grads


def _assert_case(name, inp, want, got):
    (w_out, w_grads), (g_out, g_grads) = want, got
    assert len(w_out) == len(g_out)
    for a, b in zip(w_out, g_out):
        assert _rel(a, b) < 1e-5
    w_grads = _unstack_grads(name, [np.asarray(g) for g in w_grads])
    for i, g in zip(_grad_order(name, inp), g_grads):
        assert _rel(w_grads[i], g) < 1e-5, (name, i)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_chunked_apply(n):
    x, w = _np(20, 2, 32, 16), _np(21, 16, 16, scale=0.3)
    want = ref_sr.chunked_apply(lambda u: jax.nn.gelu(u @ w),
                                jnp.asarray(x), n)
    gw = jax.grad(lambda w: jnp.sum(ref_sr.chunked_apply(
        lambda u: jnp.tanh(u @ w), jnp.asarray(x), n) ** 2))(jnp.asarray(w))
    tw = torch.tensor(w).requires_grad_()
    got = sr.chunked_apply(
        lambda u: torch.nn.functional.gelu(u @ tw, approximate="tanh"),
        torch.tensor(x), n)
    assert _rel(want, got.detach()) < 1e-5
    sr.chunked_apply(lambda u: torch.tanh(u @ tw), torch.tensor(x),
                     n).square().sum().backward()
    assert _rel(gw, tw.grad) < 1e-5


@pytest.mark.parametrize("name", ["carry", "swa"])
@pytest.mark.parametrize("n", [2, 4])
def test_checkpointed_helpers(name, n):
    """``carry_scan_remat`` and ``swa_overlap_chunks`` at ``n`` chunks,
    values and gradients, against the reference's."""
    inp = _case_inputs(name)
    want = _reference_helper(name, n)
    if name == "carry":
        apply = lambda c0, x: sr.carry_scan_remat(_ema_body, c0, x, n)  # noqa
    else:
        apply = lambda q, k, v: sr.swa_overlap_chunks(  # noqa: E731
            _attend, q, k, v, 16, n)
    _assert_case(name, inp, want, _port_run(name, inp, apply))


@pytest.mark.parametrize("policy", [p[0] for p in POLICIES])
@pytest.mark.parametrize("name", CASE_NAMES)
@pytest.mark.parametrize("kind", ["program", "maker"])
def test_row_program_matches_reference_helper(kind, name, policy):
    """Each row program on the port's executor, and each maker, under
    every policy against the reference's checkpointed helper: placement
    moves bytes, never values."""
    inp = _case_inputs(name)
    want = _reference_helper(name)
    got = _port_run(name, inp, _port_apply(name, kind, _spec(policy)))
    _assert_case(name, inp, want, got)


@pytest.mark.parametrize("policy", ["device", "host1", "recompute"])
@pytest.mark.parametrize("name", ["carry", "chunked", "swa"])
def test_seq_engine_op_forms(name, policy):
    """``seq_carry_scan``, ``seq_chunked`` and ``seq_swa_overlap`` given a
    chunk-body callable (the reference's ``test_seq_carry_scan_residency_
    parity`` and its carry-free siblings)."""
    inp = _case_inputs(name)
    want = _reference_helper(name)
    got = _port_run(name, inp, _port_apply(name, "engine", _spec(policy)))
    _assert_case(name, inp, want, got)


def test_rowprog_rejects_indivisible_seq():
    apply = sr.make_carry_scan_apply(
        lambda c, x: (c + x.sum(1), x), 3, 1,
        residency=ResidencySpec(default="host"))
    with pytest.raises(AssertionError, match="not divisible"):
        apply(torch.zeros(2, 3), torch.randn(2, 10, 3))


def test_carry_free_makers_keep_the_checkpointed_loop():
    """A residency has nothing to place in a carry-free program, so its
    makers return the checkpointed helper whatever the spec (as the
    reference's do): no executor, no ``fp_row`` records."""
    from repro_torch import obs
    x = torch.randn(2, 32, 16)
    with obs.capture() as s:
        sr.make_chunked_apply(torch.tanh, 4, residency=ResidencySpec(
            default="host"))(x)
        counts = {n: c.value for n, c in s.metrics.counters.items()}
    assert "rowprog.fp_rows" not in counts


# ---------------------------------------------------------------------------
# The reference's executor, Planner and planned LM step (from the child)
# ---------------------------------------------------------------------------

NEW_ARCHS = ["llama3_2_3b", "qwen1_5_4b", "qwen1_5_110b", "zamba2_7b",
             "xlstm_125m"]
#: family -> (arch, batch, seq): the recurrent families at two chunks
FAMILIES = {"dense": ("llama3_2_3b", 2, 64),
            "ssm": ("xlstm_125m", 1, 512),
            "hybrid": ("zamba2_7b", 1, 512)}
RES_POLICIES = ("device", "host", "recompute")
#: (preset, batch, seq, budget bytes, residency) plan queries per arch
PLAN_QUERIES = [(preset, b, s, budget, res)
                for preset in ("reduced", "full")
                for b, s in ((1, 512), (8, 4096))
                for budget in (0, 2**20, 2**26, 2**30)
                for res in ("", "host")]
TRAIN_STEPS = 2

#: the child compiles many small programs; one XLA thread keeps it from
#: crowding other test workers, and is no slower
CHILD_XLA_FLAGS = ("--xla_cpu_multi_thread_eigen=false "
                   "intra_op_parallelism_threads=1")

CHILD = r'''
import json, sys
import numpy as np
import jax, jax.numpy as jnp, jax.memory, jax.sharding
if not hasattr(jax.sharding, "TransferToMemoryKind"):
    # JAX 0.9 dropped the name repro.exec.rowprog imports; this process only
    jax.sharding.TransferToMemoryKind = lambda kind: (
        jax.memory.Space.Host if "host" in kind else jax.memory.Space.Device)
from repro.configs import get_config, get_reduced
from repro.data.pipeline import TokenDataset, TokenDatasetConfig
from repro.exec import Planner, ResidencySpec, build_apply
from repro.launch.steps import make_train_step
from repro.models.lm import model as LM
from repro.optim.adamw import AdamWConfig, adamw_init

d = sys.argv[1]
spec = json.load(open(d + "/spec.json"))
ns = {}
exec(spec["cases"], ns)
arrays, out = {}, {}

# the row programs on the reference's executor
inputs = np.load(d + "/cases.npz")
for name in spec["case_names"]:
    inp = {k.split("|")[1]: inputs[k] for k in inputs.files
           if k.startswith(name + "|")}
    for policy in ("host", "recompute"):
        outs, grads = ns["run"](name, inp,
                                ns["ref_executor_apply"](name, policy))
        for i, a in enumerate(outs):
            arrays[f"case|{name}|{policy}|out|{i}"] = np.asarray(a)
        for i, a in enumerate(grads):
            arrays[f"case|{name}|{policy}|grad|{i}"] = np.asarray(a)

# for_model plan JSON
for arch in spec["archs"]:
    for preset, b, s, budget, res in spec["plan_queries"]:
        cfg = get_reduced(arch) if preset == "reduced" else get_config(arch)
        key = f"{arch}|{preset}|{b}|{s}|{budget}|{res}"
        out["plan|" + key] = Planner.for_model(
            cfg, b, s, budget=budget,
            residency=ResidencySpec.parse(res)).to_dict()
    out["kernel|" + arch] = Planner.for_model(
        get_reduced(arch), 1, 512, kernel="pallas").to_dict()

def batch_of(cfg, B, S):
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels[:, -3:] = -1
    return {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}

# family x residency: planned loss and gradients
for family, (arch, B, S) in spec["families"].items():
    cfg = get_reduced(arch)
    params = LM.init_lm(jax.random.PRNGKey(0), cfg)
    batch = batch_of(cfg, B, S)
    for policy in spec["policies"]:
        plan = Planner.for_model(cfg, B, S,
                                 residency=ResidencySpec.parse(policy))
        apply = build_apply((None, cfg), plan)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: apply(p, batch), has_aux=True))(params)
        out[f"family|{family}|{policy}|loss"] = float(loss)
        for i, g in enumerate(jax.tree.leaves(grads)):
            arrays[f"family|{family}|{policy}|{i}"] = np.asarray(g)

# the dense train step under each residency: a short trajectory
arch, B, S = spec["families"]["dense"]
cfg = get_reduced(arch)
ds = TokenDataset(TokenDatasetConfig(vocab=cfg.vocab, seq_len=S, batch=B,
                                     seed=0))
for policy in spec["policies"]:
    plan = Planner.for_model(cfg, B, S,
                             residency=ResidencySpec.parse(policy))
    step_fn = jax.jit(make_train_step(cfg, AdamWConfig(lr=3e-4), plan=plan))
    params = LM.init_lm(jax.random.PRNGKey(0), cfg)
    state = {"params": params, "opt": adamw_init(params)}
    losses = []
    for step in range(spec["train_steps"]):
        hb = ds.batch_at(step)
        state, m = step_fn(state, {k: jnp.asarray(hb[k])
                                   for k in ("tokens", "labels")})
        losses.append(float(m["loss"]))
    out[f"train|{policy}"] = {"losses": losses, "plan": plan.to_dict()}
budget_plan = Planner.for_model(cfg, B, S, budget=spec["budget"])
out["budget_plan"] = budget_plan.to_dict()

np.savez(d + "/ref.npz", **arrays)
json.dump(out, open(d + "/ref.json", "w"))
'''

BUDGET = 2**20


@pytest.fixture(scope="module", autouse=True)
def _reference_child(tmp_path_factory):
    """Start the reference child with the module's first test, so that it
    works while the in-process tests above run; ``reference`` waits for it."""
    d = tmp_path_factory.mktemp("ref_seqrow")
    arrays = {f"{name}|{k}": v for name in CASE_NAMES
              for k, v in _case_inputs(name).items()}
    np.savez(d / "cases.npz", **arrays)
    (d / "spec.json").write_text(json.dumps(dict(
        cases=JAX_CASES, case_names=CASE_NAMES, archs=NEW_ARCHS,
        plan_queries=PLAN_QUERIES, families=FAMILIES,
        policies=RES_POLICIES, train_steps=TRAIN_STEPS, budget=BUDGET)))
    child = subprocess.Popen(
        [sys.executable, "-c", CHILD, str(d)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 JAX_PLATFORMS="cpu", XLA_FLAGS=CHILD_XLA_FLAGS),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        yield child, d
    finally:
        child.kill()
        child.wait()


@pytest.fixture(scope="module")
def reference(_reference_child):
    """The child's numbers: ``(json answers, arrays)``."""
    child, d = _reference_child
    _, err = child.communicate(timeout=900)
    assert child.returncode == 0, err[-4000:]
    return json.load(open(d / "ref.json")), dict(np.load(d / "ref.npz"))


@pytest.mark.parametrize("policy", ["host", "recompute"])
@pytest.mark.parametrize("name", CASE_NAMES)
def test_row_program_matches_reference_executor(reference, name, policy):
    """The port's row programs against the reference's row-program forms
    on its own executor, under the same placement."""
    _, arrays = reference
    pre = f"case|{name}|{policy}|"
    want = ([arrays[k] for k in sorted(a for a in arrays
                                       if a.startswith(pre + "out|"))],
            [arrays[f"{pre}grad|{i}"] for i in range(sum(
                k.startswith(pre + "grad|") for k in arrays))])
    inp = _case_inputs(name)
    kind = "maker" if name in ("carry", "stacked", "consts") \
        else "program"
    got = _port_run(name, inp, _port_apply(
        name, kind, _spec({"host": "host1"}.get(policy, policy))))
    _assert_case(name, inp, want, got)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_for_model_plan_json_equals_reference(reference, arch):
    ref, _ = reference
    bad = []
    for preset, b, s, budget, res in PLAN_QUERIES:
        cfg = get_reduced(arch) if preset == "reduced" else get_config(arch)
        got = Planner.for_model(cfg, b, s, budget=budget,
                                residency=ResidencySpec.parse(res))
        key = f"{arch}|{preset}|{b}|{s}|{budget}|{res}"
        if got.to_dict() != ref["plan|" + key]:
            bad.append((key, got.to_dict(), ref["plan|" + key]))
    assert not bad, bad[:2]
    # kernelized: the reference's "pallas" and the port's "cuda" swap the
    # same engines, or record a fallback on the same ones
    want = ref["kernel|" + arch]
    got = Planner.for_model(get_reduced(arch), 1, 512, kernel="cuda")
    assert got.engine == want["engine"]
    assert ("kernel_fallback" in dict(got.extras)) \
        == ("kernel_fallback" in dict(want["extras"]))


@functools.lru_cache(maxsize=None)
def _ref_tree(arch):
    return jax.tree.map(np.asarray, ref_model.init_lm(
        jax.random.PRNGKey(0), ref_get_reduced(arch)))


def _leaf_names(tree, prefix=""):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree)
                for n in _leaf_names(t, f"{prefix}/{i}")]
    return [prefix]


def _family_batch(cfg, B, S):
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels[:, -3:] = -1
    return {"tokens": torch.tensor(tokens), "labels": torch.tensor(labels)}


def _planned_loss_grads(arch, B, S, plan):
    cfg = get_reduced(arch)
    params = model.params_from_reference(_ref_tree(arch), "cpu")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    loss, _ = build_apply((None, cfg), plan)(params,
                                             _family_batch(cfg, B, S))
    return loss.item(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("policy", RES_POLICIES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_residency_parity(reference, family, policy):
    """The planned step's loss and every gradient, per family and
    residency, against the reference's planned step (which its own tests
    pin bit-exact to its unplanned one)."""
    ref, arrays = reference
    arch, B, S = FAMILIES[family]
    plan = Planner.for_model(get_reduced(arch), B, S,
                             residency=ResidencySpec.parse(policy))
    assert plan.engine == ("seq_chunked" if family == "dense"
                           else "seq_carry_scan")
    loss, grads = _planned_loss_grads(arch, B, S, plan)
    want = ref[f"family|{family}|{policy}|loss"]
    assert abs(loss - want) / abs(want) < 1e-5
    names = _leaf_names(_ref_tree(arch))
    assert len(names) == len(grads)
    for i, (name, g) in enumerate(zip(names, grads)):
        lim = 5e-5 if name.split("/")[-1] in DECAY_LEAVES else 1e-5
        assert _rel(arrays[f"family|{family}|{policy}|{i}"], g) < lim, name


def test_offloading_plan_actually_runs_rowprog():
    """Host residency on a recurrent family drives the executor: one
    ``fp_row`` and one ``bp_row`` per chunk of every recurrent layer, and
    the carried state's bytes offloaded and prefetched once per chunk."""
    from repro_torch import obs
    from repro_torch.models.lm.blocks import xlstm_dims
    arch, B, S = FAMILIES["ssm"]
    cfg = get_reduced(arch)
    plan = Planner.for_model(cfg, B, S, residency=ResidencySpec.parse(
        "host"))
    with obs.capture() as s:
        _planned_loss_grads(arch, B, S, plan)
        names = [r["name"] for r in s.tracer.records[1:]]
        counts = {n: c.value for n, c in s.metrics.counters.items()}
    dims = xlstm_dims(cfg)
    chunks = S // dims.chunk
    H, hd, d = dims.n_heads, dims.head_dim, cfg.d_model
    carry_bytes = {"mlstm": 4 * B * (H * hd * hd + H * hd + H),
                   "slstm": 4 * B * 4 * d}
    kinds = cfg.layer_kinds()
    assert sorted(set(kinds)) == ["mlstm", "slstm"]
    rows = len(kinds) * chunks
    assert names.count("fp_row") == names.count("bp_row") == rows
    assert counts["rowprog.fp_rows"] == counts["rowprog.bp_rows"] == rows
    want = chunks * sum(carry_bytes[k] for k in kinds)
    assert counts["rowprog.offload_bytes"] == want
    assert counts["rowprog.prefetch_bytes"] == want
    assert counts["rowprog.prefetches"] == rows


def test_kernel_fallback_keeps_carry_scan_exact(reference):
    """``seq_carry_scan`` has no CUDA alternate: kernelizing records the
    fallback (the reference's has no Pallas one) and the numerics are the
    unkernelized plan's."""
    ref, arrays = reference
    arch, B, S = FAMILIES["ssm"]
    plan = Planner.for_model(get_reduced(arch), B, S, kernel="cuda")
    assert plan.engine == "seq_carry_scan"
    assert "no cuda alternate" in plan.get("kernel_fallback")
    assert "kernel_fallback" in dict(ref["kernel|" + arch]["extras"])
    loss, grads = _planned_loss_grads(arch, B, S, plan)
    want = ref["family|ssm|device|loss"]
    assert abs(loss - want) / abs(want) < 1e-5
    for i, g in enumerate(grads):
        assert _rel(arrays[f"family|ssm|device|{i}"], g) < 1e-5


def _train_args(out, arch, B, S, *extra):
    return T.build_parser().parse_args(
        ["--arch", arch, "--preset", "reduced", "--device", "cpu",
         "--batch", str(B), "--seq", str(S), "--log-every", "1",
         "--out", str(out), *extra])


@pytest.mark.parametrize("policy", RES_POLICIES)
def test_train_step_matches_reference(reference, tmp_path, policy):
    """The trainer under ``--residency`` (the dense family, whose plan is
    carry-free): the reference's planned trajectory from the same
    initial parameters and batches, and the reference's plan."""
    ref, _ = reference
    arch, B, S = FAMILIES["dense"]
    recs = T.train_lm(_train_args(tmp_path, arch, B, S, "--steps",
                                  str(TRAIN_STEPS), "--residency", policy),
                      params=model.params_from_reference(_ref_tree(arch),
                                                         "cpu"))
    want = ref[f"train|{policy}"]
    got = [r["loss"] for r in recs]
    for step, (a, b) in enumerate(zip(want["losses"], got)):
        assert abs(a - b) / abs(a) < 1e-5 * 10 ** step, (step, want, got)
    log = json.load(open(tmp_path / "train_log.json"))
    assert log["plan"] == want["plan"]


@pytest.mark.parametrize("arch", ["zamba2_7b", "xlstm_125m"])
def test_trainer_residency_gives_the_same_losses(tmp_path, arch):
    """``--residency host|recompute`` moves the carried state's bytes,
    never its values: three steps give the losses of the run without a
    residency, bit for bit."""
    losses = {}
    for policy in ("", "host", "recompute"):
        flags = ("--residency", policy) if policy else ()
        recs = T.train_lm(_train_args(tmp_path / (policy or "none"), arch,
                                      1, 512, "--steps", "3", *flags))
        losses[policy] = [r["loss"] for r in recs]
    assert all(np.isfinite(losses[""]))
    assert losses["host"] == losses[""] == losses["recompute"], losses


def test_budget_flag_resolves_through_for_model(reference, tmp_path,
                                                capsys):
    ref, _ = reference
    arch, B, S = FAMILIES["dense"]
    T.train_lm(_train_args(tmp_path, arch, B, S, "--steps", "1",
                           "--budget-gb", str(BUDGET / 2**30)))
    plan = json.load(open(tmp_path / "train_log.json"))["plan"]
    assert plan == ref["budget_plan"]
    assert plan["engine"] == "seq_chunked" and plan["budget"] == BUDGET
    assert "plan: ExecutionPlan(engine=seq_chunked" in capsys.readouterr().out
    # an explicit --row-chunks wins over the plan, as in the reference
    T.train_lm(_train_args(tmp_path, arch, B, S, "--steps", "1",
                           "--budget-gb", "1", "--row-chunks", "4"))
    assert json.load(open(tmp_path / "train_log.json"))["plan"] is None
