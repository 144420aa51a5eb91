"""The row pipeline (``exec/pipeline.py``) and the Planner's staged half
against the JAX package's, and against the port's own column apply.

``repro.exec`` cannot be imported where ``jax.sharding`` lacks
``TransferToMemoryKind`` (JAX 0.9): one child process, started with the
module's first test, installs a stand-in for that name, runs the
reference's ``pipeline_rows`` / ``pipeline_seq`` and answers
``QUERIES`` (the staged plans) with the reference; this process answers
the same script with the port.  Tolerances are the reference's own
(``tests/test_pipeline.py``): forward 1e-5 absolute, loss 1e-5 relative,
gradients 1e-4 max-relative.  Planner integers and plan JSON must be
equal, floats to 1e-6 relative.
"""

import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core.overlap import make_column_apply
from repro_torch.exec import (
    CostTable, ExecutionPlan, MeshSpec, Planner, ResidencySpec, StageSpec,
    build_apply,
)
from repro_torch.exec.pipeline import PipelineRowProgram, resolve_stage_spec
from repro_torch.models.cnn.vgg import vgg16_modules

ROOT = pathlib.Path(__file__).resolve().parents[1]
H, BATCH = 64, 8
SHAPE = (H, H, 3)
MODS = vgg16_modules(0.125, 3)
MESH22 = MeshSpec.parse("data=2,model=2")
#: the staged runs: (name, N, S, residency)
RUNS = [("s3", 4, 3, None), ("s2", 4, 2, None), ("host", 4, 2, "host"),
        ("recompute", 4, 2, "recompute")]

#: one query script, run here against the port and in the child against
#: the reference; ``ns`` supplies each package's names and trunks
QUERIES = r'''
XI = 3 * 2**20
BUDGET = 5 * 2**20
MESHES = ["", "data=2", "data=2,model=2", "data=1,model=4"]


def answer(fn):
    try:
        return fn()
    except ValueError:
        return "ValueError"


def run(ns):
    Planner, MeshSpec, StageSpec = ns["Planner"], ns["MeshSpec"], \
        ns["StageSpec"]
    ResidencySpec, CostTable = ns["ResidencySpec"], ns["CostTable"]
    table = CostTable(fingerprint="test", flops_per_s=1e12,
                      h2d_bytes_per_s=1e10, d2h_bytes_per_s=1e10,
                      row_overhead_us=3.0)
    out = {}
    for tname, (mods, shape, batch, xi) in ns["trunks"].items():
        L = len(mods)
        for m in MESHES:
            mesh = MeshSpec.parse(m) if m else None
            pl = Planner(mods, shape, batch, xi=xi, mesh=mesh)
            k = f"{tname}|{m or 'none'}"
            out[f"default|{k}"] = pl._default_stage_spec().to_dict()
            for n in (1, 2, 3, 4):
                out[f"plan|{k}|{n}"] = answer(
                    lambda: pl.plan("pipeline_rows", n).to_dict())
                out[f"plan3|{k}|{n}"] = answer(lambda: pl.plan(
                    "pipeline_rows", n, stage=StageSpec.even(L, 3),
                    budget=BUDGET,
                    residency=ResidencySpec(default="host")).to_dict())
                out[f"est|{k}|{n}"] = answer(lambda: pl.estimate(
                    "pipeline_rows", n, stage=StageSpec.even(L, 5)))
            # the solves scan N: the reduced trunk only (the full one's
            # scans take the reference a minute)
            budgets = (BUDGET // 2, BUDGET, 4 * BUDGET, 64 * BUDGET) \
                if tname == "reduced" else ()
            for budget in budgets:
                kb = f"{k}|{budget}"
                for s in (None, 2, 3):
                    out[f"solve_staged|{kb}|{s}"] = answer(
                        lambda: pl.solve_staged(s, budget).to_dict())
                out[f"solve|{kb}"] = answer(
                    lambda: pl.solve("pipeline_rows", budget).to_dict())
                out[f"for_budget|{kb}"] = answer(lambda: Planner.for_budget(
                    mods, shape, batch, budget, xi=xi,
                    mesh=mesh).to_dict())
                out[f"stagedize|{kb}"] = answer(lambda: pl.stagedize(
                    pl.plan("base", 1, budget=budget)).to_dict())
                out[f"costed|{kb}"] = answer(lambda: Planner.for_budget(
                    mods, shape, batch, budget, xi=xi, mesh=mesh,
                    cost_table=table).to_dict())
            for n in (2, 4):
                for e in ("overlap", "pipeline_rows"):
                    out[f"pred|{k}|{e}|{n}"] = answer(
                        lambda: pl.predict_plan_us(pl.plan(e, n), table))
    return out
'''

CHILD = r'''
import json, sys
import jax, jax.memory, jax.sharding
import jax.numpy as jnp
import numpy as np
if not hasattr(jax.sharding, "TransferToMemoryKind"):
    # JAX 0.9 dropped the name repro.exec.rowprog imports; this process only
    jax.sharding.TransferToMemoryKind = lambda kind: (
        jax.memory.Space.Host if "host" in kind else jax.memory.Space.Device)
from repro.core.overlap import make_column_apply
from repro.exec import (CostTable, ExecutionPlan, MeshSpec, Planner,
                        ResidencySpec, StageSpec, build_apply)
from repro.exec.pipeline import PipelineRowProgram
from repro.models.cnn import vgg

d = sys.argv[1]
H, B = 64, 8
mods, params = vgg.init_vgg16(jax.random.PRNGKey(0), (H, H, 3),
                              width_mult=0.125, n_classes=4, n_stages=3)
x = jax.random.normal(jax.random.PRNGKey(1), (B, H, H, 3))
arrays = {"x": np.asarray(x)}
for l, p in enumerate(params["trunk"]):
    for kk, v in p.items():
        arrays[f"param/{l}/{kk}"] = np.asarray(v)


def grads(fn):
    def loss(p, xx):
        return jnp.sum(fn(p, xx) ** 2)
    return jax.value_and_grad(loss)(params["trunk"], x)


def save(name, fn):
    arrays[f"{name}/y"] = np.asarray(fn(params["trunk"], x))
    l, g = grads(fn)
    arrays[f"{name}/loss"] = np.asarray(l)
    for i, leaf in enumerate(jax.tree.leaves(g)):
        arrays[f"{name}/g{i}"] = np.asarray(leaf)


save("column", make_column_apply(mods))
for name, n, s, res in json.loads(sys.argv[2]):
    plan = Planner(mods, (H, H, 3), B).plan(
        "pipeline_rows", n, stage=StageSpec.even(len(mods), s),
        residency=ResidencySpec(default=res) if res else None)
    save(name, build_apply(mods, plan))
geo = {}
plan = ExecutionPlan.explicit("pipeline_rows", 4, in_shape=(H, H, 3),
                              stage=StageSpec.even(len(mods), 3))
prog = PipelineRowProgram(mods, plan)
geo["n_rows"] = prog.n_rows
geo["bubble"] = prog.bubble_fraction()
geo["carry_names"] = [list(prog.carry_names(t)) for t in range(prog.n_rows + 1)]
xs = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (4, 32, 16)))
w = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (16, 16))) * 0.25
fns = [lambda u: jnp.tanh(u @ w), lambda u: u * 2.0, lambda u: u + 1.0]
seq = build_apply(fns, ExecutionPlan.explicit(
    "pipeline_seq", 4, axis=1, stage=StageSpec.even(3, 2)))
arrays["seq/x"], arrays["seq/w"] = xs, w
arrays["seq/y"] = np.asarray(seq(jnp.asarray(xs)))
arrays["seq/g"] = np.asarray(jax.grad(
    lambda u: jnp.sum(seq(u) ** 2))(jnp.asarray(xs)))
np.savez(d + "/ref.npz", **arrays)
ns = dict(Planner=Planner, MeshSpec=MeshSpec, StageSpec=StageSpec,
          ResidencySpec=ResidencySpec, CostTable=CostTable,
          trunks={"reduced": (vgg.vgg16_modules(0.125, 3), (H, H, 3), B,
                              3 * 2**20),
                  "full": (vgg.vgg16_modules(1.0), (224, 224, 3), 32,
                           12 * 138357544)})
exec(open(d + "/queries.py").read(), ns)
json.dump({"geo": geo, "queries": ns["run"](ns)},
          open(d + "/ref.json", "w"))
'''

CHILD_XLA_FLAGS = ("--xla_cpu_multi_thread_eigen=false "
                   "intra_op_parallelism_threads=1")


@pytest.fixture(scope="module")
def _reference_child(tmp_path_factory):
    """Start the reference child with the module's first test, so that it
    works while this process runs the port's side."""
    d = tmp_path_factory.mktemp("ref_pipeline")
    (d / "queries.py").write_text(QUERIES)
    child = subprocess.Popen(
        [sys.executable, "-c", CHILD, str(d), json.dumps(RUNS)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 JAX_PLATFORMS="cpu", XLA_FLAGS=CHILD_XLA_FLAGS),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        yield child, d
    finally:
        child.kill()
        child.wait()


@pytest.fixture(scope="module")
def reference(_reference_child):
    """The child's answers: ``(json, arrays)``."""
    child, d = _reference_child
    _, err = child.communicate(timeout=600)
    assert child.returncode == 0, err[-4000:]
    return json.load(open(d / "ref.json")), dict(np.load(d / "ref.npz"))


@pytest.fixture(scope="module")
def port_answers():
    ns = dict(Planner=Planner, MeshSpec=MeshSpec, StageSpec=StageSpec,
              ResidencySpec=ResidencySpec, CostTable=CostTable,
              trunks={"reduced": (MODS, SHAPE, BATCH, 3 * 2**20),
                      "full": (vgg16_modules(1.0), (224, 224, 3), 32,
                               12 * 138357544)})
    exec(QUERIES, ns)
    return json.loads(json.dumps(ns["run"](ns)))


def _params(arrays):
    trunk = []
    for l in range(len(MODS)):
        prefix = f"param/{l}/"
        trunk.append({k[len(prefix):]: torch.tensor(v) for k, v in
                      arrays.items() if k.startswith(prefix)})
    return trunk


def _loss_grads(fn, trunk, x):
    p = [{k: v.clone().requires_grad_() for k, v in d.items()}
         for d in trunk]
    y = fn(p, x)
    loss = torch.sum(y ** 2)
    leaves = [p[l][k] for l in range(len(p)) for k in sorted(p[l])]
    return y.detach(), loss.item(), torch.autograd.grad(loss, leaves)


def _max_rel(a, b):
    out = 0.0
    for u, v in zip(a, b):
        u, v = torch.as_tensor(u), torch.as_tensor(v)
        denom = float(u.abs().max())
        if denom > 0:
            out = max(out, float((u - v).abs().max()) / denom)
    return out


def _check(got, want):
    (y, loss, g), (y0, loss0, g0) = got, want
    assert float((torch.as_tensor(y) - torch.as_tensor(y0)).abs().max()) \
        <= 1e-5
    assert abs(loss - loss0) / abs(loss0) < 1e-5
    assert _max_rel(g0, g) < 1e-4


def _ref_run(arrays, name):
    n = sum(1 for k in arrays if k.startswith(f"{name}/g"))
    return (arrays[f"{name}/y"], float(arrays[f"{name}/loss"]),
            [arrays[f"{name}/g{i}"] for i in range(n)])


# ---------------------------------------------------------------------------
# StageSpec and the schedule (no child needed)
# ---------------------------------------------------------------------------


def test_stage_spec_validates_and_roundtrips():
    with pytest.raises(ValueError, match="at least one"):
        StageSpec(stages=())
    with pytest.raises(ValueError, match="start at module 0"):
        StageSpec(stages=((1, 3),))
    with pytest.raises(ValueError, match="empty"):
        StageSpec(stages=((0, 0),))
    with pytest.raises(ValueError, match="contiguous"):
        StageSpec(stages=((0, 2), (3, 5)))
    with pytest.raises(ValueError, match="cannot split"):
        StageSpec.even(3, 4)
    s = StageSpec.even(17, 3)
    assert (s.n_stages, s.n_modules) == (3, 17)
    assert s.stages == ((0, 6), (6, 12), (12, 17))
    assert s.describe() == "0:6|6:12|12:17"
    assert StageSpec.from_dict(s.to_dict()) == s


def test_resolve_stage_spec_precedence():
    plan = ExecutionPlan.explicit("pipeline_rows", 4,
                                  stage=StageSpec.even(17, 5))
    assert resolve_stage_spec(17, plan).n_stages == 5      # explicit wins
    plan = ExecutionPlan.explicit("pipeline_rows", 4, n_stages=3)
    assert resolve_stage_spec(17, plan).n_stages == 3      # extras next
    plan = ExecutionPlan.explicit("pipeline_rows", 4, mesh=MESH22)
    assert resolve_stage_spec(17, plan).n_stages == 2      # mesh.model
    plan = ExecutionPlan.explicit("pipeline_rows", 4)
    assert resolve_stage_spec(17, plan).n_stages == 2      # default S=2
    assert resolve_stage_spec(1, plan).n_stages == 1       # capped at L


def test_tick_schedule_and_bubble_fraction(reference):
    """The tick geometry of ``tests/test_pipeline.py``, and the
    reference's own answers for it."""
    plan = ExecutionPlan.explicit("pipeline_rows", 4, in_shape=SHAPE,
                                  stage=StageSpec.even(len(MODS), 3))
    prog = PipelineRowProgram(MODS, plan)
    N, S = 4, 3
    assert prog.n_rows == N + S - 1
    assert prog.bubble_fraction() == (S - 1) / (N + S - 1)
    assert prog.carry_names(0) == ()
    assert prog.carry_names(1) == ("stage_b0",)
    assert prog.carry_names(2) == ("stage_b0", "stage_b1")
    assert prog.carry_names(N) == ("stage_b0", "stage_b1")
    assert prog.carry_names(N + 1) == ("stage_b1",)
    geo = reference[0]["geo"]
    assert geo["n_rows"] == prog.n_rows
    assert geo["bubble"] == prog.bubble_fraction()
    assert geo["carry_names"] == [list(prog.carry_names(t))
                                  for t in range(prog.n_rows + 1)]


def test_per_device_keeps_the_stage_partition():
    """per_device divides the batch by the batch extent only (the model
    axis replicates it) and keeps the stages."""
    plan = Planner(MODS, SHAPE, BATCH, mesh=MESH22).plan("pipeline_rows", 4)
    assert plan.stage.n_stages == 2
    sub = plan.per_device()
    assert sub.mesh is None and sub.batch == BATCH // 2
    assert sub.stage == plan.stage and sub.n_rows == plan.n_rows
    rt = ExecutionPlan.from_json(plan.to_json())
    assert rt == plan and "stages=" in rt.describe()


# ---------------------------------------------------------------------------
# exactness: pipeline_rows == column apply == the reference's pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,n,s,res", RUNS, ids=[r[0] for r in RUNS])
def test_pipeline_rows_matches_column_and_reference(reference, name, n, s,
                                                    res):
    arrays = reference[1]
    trunk, x = _params(arrays), torch.tensor(arrays["x"])
    plan = Planner(MODS, SHAPE, BATCH).plan(
        "pipeline_rows", n, stage=StageSpec.even(len(MODS), s),
        residency=ResidencySpec(default=res) if res else None)
    got = _loss_grads(build_apply(MODS, plan), trunk, x)
    _check(got, _loss_grads(make_column_apply(MODS), trunk, x))
    _check(got, _ref_run(arrays, name))
    _check(_ref_run(arrays, "column"), _ref_run(arrays, name))


def test_pipeline_seq_matches_stack_and_reference(reference):
    arrays = reference[1]
    w = torch.tensor(arrays["seq/w"])
    fns = [lambda u: torch.tanh(u @ w), lambda u: u * 2.0,
           lambda u: u + 1.0]
    x = torch.tensor(arrays["seq/x"], requires_grad=True)
    apply = build_apply(fns, ExecutionPlan.explicit(
        "pipeline_seq", 4, axis=1, stage=StageSpec.even(3, 2)))
    ref = fns[2](fns[1](fns[0](x)))
    y = apply(x)
    assert torch.allclose(y, ref, atol=1e-6)
    assert torch.allclose(y, torch.tensor(arrays["seq/y"]), atol=1e-6)
    g1 = torch.autograd.grad(torch.sum(ref ** 2), x)[0]
    g2 = torch.autograd.grad(torch.sum(apply(x) ** 2), x)[0]
    assert torch.allclose(g1, g2, rtol=1e-5, atol=1e-5)
    assert torch.allclose(g2, torch.tensor(arrays["seq/g"]), rtol=1e-5,
                          atol=1e-5)


def test_pipeline_records_stage_rows_and_bubble(tmp_path):
    """The obs records: a ``stage_row`` span for every (stage, row) of the
    grid, and the measured bubble fraction."""
    x = torch.randn(2, H, H, 3, generator=torch.Generator().manual_seed(0))
    from repro_torch.models.cnn.layers import init_trunk
    trunk, _ = init_trunk(MODS, torch.Generator().manual_seed(1), SHAPE,
                          device="cpu")
    plan = Planner(MODS, SHAPE, 2).plan("pipeline_rows", 3)
    with obs.capture(trace=str(tmp_path / "t.jsonl")) as s:
        build_apply(MODS, plan)(trunk, x)
        gauge = s.metrics.gauge("pipeline.bubble_fraction").value
    recs = [json.loads(l) for l in open(tmp_path / "t.jsonl")]
    spans = {(r["attrs"]["stage"], r["attrs"]["row"]) for r in recs
             if r.get("name") == "stage_row"}
    assert spans == {(s_, r) for s_ in range(2) for r in range(3)}
    assert gauge == pytest.approx(1 / 4)
    assert any(r.get("name") == "pipeline_bubble" for r in recs)


# ---------------------------------------------------------------------------
# the staged Planner against the reference
# ---------------------------------------------------------------------------


def _close(a, b):
    if isinstance(a, float) or isinstance(b, float):
        return isinstance(a, (int, float)) and isinstance(b, (int, float)) \
            and math.isclose(a, b, rel_tol=1e-6, abs_tol=1e-9)
    if isinstance(a, dict) and isinstance(b, dict):
        return sorted(a) == sorted(b) and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_close(u, v) for u, v in zip(a, b))
    return a == b


KINDS = ["default", "plan", "plan3", "est", "solve_staged", "solve",
         "for_budget", "stagedize", "costed", "pred"]


@pytest.mark.parametrize("kind", KINDS)
def test_staged_planner_equals_reference(reference, port_answers, kind):
    """Integers, plan JSON and roofline predictions equal the
    reference's, key for key.  The costed chooser answers where the
    reference raises (an OverL-H or 2PS-H candidate past the last level:
    ``Planner.predict_plan_us``'s one departure); those keys are counted
    and skipped."""
    ref = reference[0]["queries"]
    keys = sorted(k for k in ref if k.split("|")[0] == kind)
    assert keys and keys == sorted(k for k in port_answers
                                   if k.split("|")[0] == kind)
    diverge = [k for k in keys if ref[k] == "ValueError"
               and port_answers[k] != "ValueError"]
    assert kind == "costed" or not diverge
    bad = [k for k in keys if k not in diverge
           and not _close(ref[k], port_answers[k])]
    assert not bad, [(k, ref[k], port_answers[k]) for k in bad[:2]]


def test_staged_solve_rescues_an_infeasible_budget(port_answers):
    """The reference's acceptance case: every single-stage engine is
    infeasible (xi alone exceeds the per-device budget), S=2 fits, and
    the decision lands in the ``pipeline`` extra."""
    xi, budget = 3 * 2**20, 5 * 2**20
    pl = Planner(MODS, SHAPE, BATCH, mesh=MESH22, xi=xi)
    for engine in ("base", "overlap", "twophase"):
        assert not pl.solve(engine, budget).feasible
    plan = Planner.for_budget(MODS, SHAPE, BATCH, budget, xi=xi,
                              mesh=MESH22)
    assert plan.feasible and plan.engine == "pipeline_rows"
    assert plan.stage.n_stages == 2
    assert "pipeline stages over the model axis" in plan.get("pipeline")
    assert plan.est_bytes_per_device < budget // 2
    assert ExecutionPlan.from_json(plan.to_json()) == plan
    # a data-only mesh has nothing to pipeline onto
    data = Planner.for_budget(MODS, SHAPE, BATCH, budget, xi=xi,
                              mesh=MeshSpec.parse("data=2"))
    assert data.engine != "pipeline_rows" and data.get("pipeline") is None


def test_predict_plan_us_charges_the_bubble():
    table = CostTable(fingerprint="test", flops_per_s=1e12,
                      h2d_bytes_per_s=1e10, d2h_bytes_per_s=1e10,
                      row_overhead_us=0.0)
    pl = Planner(MODS, SHAPE, BATCH, mesh=MESH22)
    over = pl.predict_plan_us(pl.plan("overlap", 4), table)
    pipe = pl.predict_plan_us(pl.plan("pipeline_rows", 4), table)
    assert pipe["compute_us"] == pytest.approx(
        over["compute_us"] * (1 + (2 - 1) / 4), rel=1e-6)
    assert pipe["us"] > over["us"]


def test_estimate_terms_sum_to_the_staged_estimate():
    for mesh in (None, MESH22):
        pl = Planner(MODS, SHAPE, BATCH, mesh=mesh, xi=3 * 2**20)
        for n in (1, 2, 4):
            plan = pl.plan("pipeline_rows", n)
            terms = pl.estimate_terms(plan)
            assert sum(terms.values()) == plan.est_bytes_per_device
            assert terms["xi"] == 3 * 2**20 // (mesh.model if mesh else 1)
