"""Sharded execution on ``torch.distributed``: the sharding rules against
the JAX package's, mesh plans' JSON against the reference, and shard
parity of the engines in spawned ``gloo`` groups against single-device
execution.

``repro.launch.sharding`` imports only ``jax.sharding``, so its rules
are called here (over an ``AbstractMesh``); the mesh plans come from
``repro.exec``, which one child process imports with a stand-in for
``TransferToMemoryKind`` (JAX 0.9 lacks it).  The process groups are
separate processes (2 ranks for ``data=2``, 4 for ``data=2,model=2``) that
meet through a ``file://`` store under ``tmp_path`` and carry a timeout of
their own, so a hang fails its test.  Tolerances are the reference's
(``tests/test_sharded_plans.py``, ``tests/test_pipeline.py``): forward
1e-5 absolute (sequence engines 1e-6), loss 1e-5 relative, gradients 1e-4
max-relative (sequence engines 1e-5).
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_reduced as ref_reduced
from repro.launch import sharding as ref_sh
from repro.models.lm.model import init_lm as ref_init_lm
from repro_torch.configs import get_reduced
from repro_torch.core.overlap import make_column_apply
from repro_torch.exec import ExecutionPlan, MeshSpec, Planner, build_apply
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import build_mesh, production_mesh_spec
from repro_torch.models.lm.model import family_fns

ROOT = pathlib.Path(__file__).resolve().parents[1]
GROUP_TIMEOUT_S = 120

#: the process groups: 2 ranks, and 4 with a model axis
MESHES = ["data=2", "data=2,model=2"]
MESH_SHAPES = [("data=2", {"data": 2}), ("data=2,model=2",
                                          {"data": 2, "model": 2}),
               ("pod=2,data=2,model=2", {"pod": 2, "data": 2, "model": 2}),
               ("data=4,model=2", {"data": 4, "model": 2})]


def _abstract(sizes):
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


# ---------------------------------------------------------------------------
# the rules, case for case
# ---------------------------------------------------------------------------

FILTER_CASES = [
    (("data", None, "model"), (4, 3, 6)),
    (("data", None, "model"), (3, 3, 5)),
    ((("pod", "data"), None), (8, 2)),
    ((("pod", "data"), None), (6, 2)),
    ((None, None, None, "model"), (3, 3, 8, 16)),
    ((None, None, None, "model"), (3, 3, 8, 15)),
    (("model",), (7,)),
    ((None,), (5, 4, 3)),
    ((), (2, 2)),
]


@pytest.mark.parametrize("mesh_s,sizes", MESH_SHAPES,
                         ids=[m for m, _ in MESH_SHAPES])
def test_filter_spec_equals_reference(mesh_s, sizes):
    spec = MeshSpec.parse(mesh_s)
    ref_mesh = _abstract(sizes)
    for entries, shape in FILTER_CASES:
        if any(a not in sizes for e in entries if e is not None
               for a in ((e,) if isinstance(e, str) else e)):
            continue
        want = tuple(ref_sh.filter_spec(P(*entries), shape, ref_mesh))
        assert sh.filter_spec(entries, shape, spec) == want, (entries,
                                                              shape)


@pytest.mark.parametrize("mesh_s,sizes", MESH_SHAPES,
                         ids=[m for m, _ in MESH_SHAPES])
def test_contexts_equal_reference(mesh_s, sizes):
    spec = MeshSpec.parse(mesh_s)
    ref_mesh = _abstract(sizes)
    for kw in ({}, {"fsdp": True}, {"seq_sharded": True},
               {"dp_only": True, "fsdp": True}):
        assert sh.make_ctx(spec, **kw).logical \
            == ref_sh.make_ctx(ref_mesh, **kw).logical
    assert sh.make_plan_ctx(spec, spec).logical \
        == ref_sh.make_plan_ctx(ref_mesh, spec).logical
    ctx, ref_ctx = sh.make_ctx(spec), ref_sh.make_ctx(ref_mesh)
    for names in (("batch", None), (None, "tp"), (("batch", "tp"), None),
                  ("expert", "fsdp", None), ("seq",)):
        assert ctx.resolve(names) == tuple(ref_ctx.resolve(names))


@pytest.mark.parametrize("arch", ["qwen1_5_4b", "deepseek_moe_16b",
                                  "zamba2_7b", "gemma3_4b"])
@pytest.mark.parametrize("mesh_s,sizes", MESH_SHAPES[1:3],
                         ids=[m for m, _ in MESH_SHAPES[1:3]])
def test_spec_tree_equals_reference(arch, mesh_s, sizes):
    """``LM_RULES`` over a reduced LM's parameter tree: each leaf's
    placements are those of the reference's ``PartitionSpec`` for it."""
    ref_cfg = ref_reduced(arch)
    ref_tree = jax.eval_shape(lambda: ref_init_lm(jax.random.PRNGKey(0),
                                                  ref_cfg))
    cfg = get_reduced(arch)
    tree = family_fns(cfg).init(torch.Generator().manual_seed(0), cfg)
    spec = MeshSpec.parse(mesh_s)
    for fsdp in (False, True):
        want = [tuple(s.spec) for s in jax.tree.leaves(
            ref_sh.spec_tree(ref_tree, ref_sh.make_ctx(_abstract(sizes),
                                                       fsdp=fsdp)))]
        ctx = sh.make_ctx(spec, fsdp=fsdp)
        got = list(_leaves(tree, sh.spec_tree(tree, ctx)))
        assert got == [sh.placements(s, spec) for s in want]
        # and the placements shard exactly the axes the specs name
        for s, pl in zip(want, got):
            for name, p in zip(spec.axis_names, pl):
                dims = [d for d, e in enumerate(s) if e is not None
                        and name in ((e,) if isinstance(e, str) else e)]
                assert p == (Shard(dims[0]) if dims else Replicate())


def _leaves(tree, out):
    """``out``'s per-leaf values, walked by the structure of the parameter
    tree ``tree`` (the values are tuples themselves)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], out[k])
    elif isinstance(tree, (list, tuple)):
        for t, o in zip(tree, out):
            yield from _leaves(t, o)
    elif tree is not None:
        yield out


def test_placements_and_replicated():
    spec = MeshSpec.parse("data=2,model=2")
    ctx = sh.make_plan_ctx(spec, spec)
    assert ctx.sharding((None, None, None, "tp")) == (Replicate(), Shard(3))
    assert ctx.sharding(("batch", None)) == (Shard(0), Replicate())
    pod = MeshSpec.parse("pod=2,data=2,model=2")
    assert sh.make_plan_ctx(pod, pod).sharding(("batch",)) \
        == (Shard(0), Shard(0), Replicate())
    tree = {"w": torch.zeros(3, 3), "b": [torch.zeros(4)]}
    assert sh.replicated(ctx, tree) == {
        "b": [(Replicate(), Replicate())], "w": (Replicate(), Replicate())}
    assert sh.lc(torch.ones(4, 2), "batch", None).shape == (4, 2)  # no ctx


def test_build_mesh_needs_the_ranks():
    with pytest.raises(ValueError, match=r"needs 4 devices .*per_device"):
        build_mesh(MeshSpec.parse("data=2,model=2"))
    assert production_mesh_spec().describe() == "data=16,model=16"
    assert production_mesh_spec(multi_pod=True).n_devices == 512


def test_lm_and_serve_meshes_name_slice_11(tmp_path):
    """The LM's sharded step is ported (``tests/test_torch_lm_sharding.py``
    holds it to the reference): a mesh plan's LM apply handles the mesh
    itself, unwrapped.  So is serving over a mesh
    (``tests/test_torch_serve_sharding.py``): ``Planner.for_serve(mesh=)``
    splits the slots over the batch axes, and the server's ``--mesh``
    needs a rank a mesh coordinate, so in one process it raises, naming
    torchrun."""
    from repro_torch.launch import serve as S
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        S.main(["--arch", "qwen1_5_4b", "--device", "cpu", "--mesh",
                "data=2"])
    plan = Planner.for_serve(get_reduced("qwen1_5_4b"), 64, 2**20,
                             mesh=MeshSpec.parse("data=2"))
    assert plan.n_rows == 2 * plan.get("slots_per_device")
    cfg = get_reduced("qwen1_5_4b")
    params = family_fns(cfg).init(torch.Generator().manual_seed(0), cfg)
    plan = ExecutionPlan.explicit("seq_chunked", 2,
                                  mesh=MeshSpec.parse("data=2"))
    assert getattr(build_apply((params, cfg), plan), "handles_mesh", False)


# ---------------------------------------------------------------------------
# mesh plans' JSON against the reference
# ---------------------------------------------------------------------------

PLAN_CHILD = r'''
import json, sys
import jax, jax.memory, jax.sharding
if not hasattr(jax.sharding, "TransferToMemoryKind"):
    # JAX 0.9 dropped the name repro.exec.rowprog imports; this process only
    jax.sharding.TransferToMemoryKind = lambda kind: (
        jax.memory.Space.Host if "host" in kind else jax.memory.Space.Device)
from repro.exec import MeshSpec, Planner, PlanRequest
from repro.models.cnn.vgg import vgg16_modules
exec(open(sys.argv[1]).read())
json.dump(run(MeshSpec, Planner, PlanRequest, vgg16_modules),
          open(sys.argv[2], "w"))
'''

PLAN_QUERIES = r'''
def run(MeshSpec, Planner, PlanRequest, vgg16_modules):
    out = {}
    mods = vgg16_modules(0.125, 3)
    for m in ("data=2", "data=4", "data=2,model=2", "pod=2,data=2"):
        mesh = MeshSpec.parse(m)
        pl = Planner(mods, (64, 64, 3), 8, xi=2**20, mesh=mesh)
        for e, n in (("base", 1), ("overlap", 4), ("twophase", 2),
                     ("twophase_h", 3), ("overlap_h", 3), ("ckp", 1),
                     ("pipeline_rows", 4)):
            p = pl.plan(e, n, budget=8 * 2**20)
            out[f"plan|{m}|{e}"] = p.to_dict()
            out[f"per_device|{m}|{e}"] = p.per_device().to_dict()
        for b in (2**21, 2**23, 2**26):
            out[f"budget|{m}|{b}"] = Planner.for_budget(
                mods, (64, 64, 3), 8, b, xi=2**20, mesh=mesh).to_dict()
        out[f"resolve|{m}"] = Planner(mods, (64, 64, 3), 8).resolve(
            PlanRequest(engine="overlap", n_rows=2, mesh=m)).to_dict()
    return out
'''


def test_mesh_plans_equal_reference(tmp_path):
    (tmp_path / "q.py").write_text(PLAN_QUERIES)
    r = subprocess.run(
        [sys.executable, "-c", PLAN_CHILD, str(tmp_path / "q.py"),
         str(tmp_path / "ref.json")], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    ns = {}
    exec(PLAN_QUERIES, ns)
    from repro_torch.exec import PlanRequest
    from repro_torch.models.cnn.vgg import vgg16_modules
    port = json.loads(json.dumps(ns["run"](MeshSpec, Planner, PlanRequest,
                                           vgg16_modules)))
    ref = json.load(open(tmp_path / "ref.json"))
    assert sorted(port) == sorted(ref)
    bad = [k for k in ref if ref[k] != port[k]]
    assert not bad, [(k, ref[k], port[k]) for k in bad[:2]]
    for k in ref:
        assert ExecutionPlan.from_dict(ref[k]).to_dict() == port[k]


# ---------------------------------------------------------------------------
# shard parity in spawned gloo groups
# ---------------------------------------------------------------------------

H, BATCH = 64, 8
CNN_ENGINES = [("overlap", 4), ("twophase", 2), ("twophase_h", 3),
               ("pipeline_rows", 4), ("overlap_cuda", 4)]
SEQ_ENGINES = ["seq_chunked", "seq_carry_scan"]

COMMON = r'''
import numpy as np
import torch


def cnn_inputs(H, B):
    from repro_torch.models.cnn.vgg import init_vgg16
    mods, params = init_vgg16(torch.Generator().manual_seed(0), (H, H, 3),
                              0.125, 4, n_stages=3, device="cpu")
    x = np.random.default_rng(1).normal(size=(B, H, H, 3))
    return mods, params["trunk"], x.astype(np.float32)


def seq_inputs():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(8, 32, 16)).astype(np.float32)
    w = (0.25 * rng.normal(size=(16, 16))).astype(np.float32)
    c0 = rng.normal(size=(8, 16)).astype(np.float32)
    return x, w, c0


def ema_body(c, chunk):
    ys = []
    for t in range(chunk.shape[1]):
        c = 0.9 * c + 0.1 * chunk[:, t]
        ys.append(c)
    return c, torch.stack(ys, 1)


def cnn_loss_grads(fn, trunk, x):
    p = [{k: v.clone().requires_grad_() for k, v in d.items()}
         for d in trunk]
    y = fn(p, x)
    loss = torch.sum(y ** 2)
    leaves = [p[l][k] for l in range(len(p)) for k in sorted(p[l])]
    g = torch.autograd.grad(loss, leaves)
    return y.detach().numpy(), loss.item(), [t.numpy() for t in g]


def seq_run(fn, args):
    args = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*args)
    outs = list(out) if isinstance(out, tuple) else [out]
    loss = sum(torch.sum(o ** 2) for o in outs)
    g = torch.autograd.grad(loss, args)
    return ([o.detach().numpy() for o in outs], loss.item(),
            [t.numpy() for t in g])
'''

WORKER = COMMON + r'''
import datetime, sys
import torch.distributed as dist

rank, world, init, out, mesh_s, timeout = sys.argv[1:7]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=float(timeout)))
try:
    from repro_torch.data.pipeline import device_put_global
    from repro_torch.exec import ExecutionPlan, MeshSpec, Planner, build_apply
    from repro_torch.launch.mesh import build_mesh
    mesh = MeshSpec.parse(mesh_s)
    dmesh = build_mesh(mesh)
    H, B = 64, 8
    mods, trunk, x = cnn_inputs(H, B)
    xl = device_put_global({"x": x}, dmesh)["x"]
    res = {}
    for engine, n in json_engines:
        pl = Planner(mods, (H, H, 3), B, mesh=mesh)
        plan = pl.kernelize(pl.plan("overlap", n), "cuda") \
            if engine == "overlap_cuda" else pl.plan(engine, n)
        assert plan.engine == engine, plan
        y, loss, g = cnn_loss_grads(build_apply(mods, plan), trunk, xl)
        res[engine] = {"y": y, "loss": loss, "g": g}
    xs, w, c0 = seq_inputs()
    wt = torch.tensor(w)
    local = device_put_global({"x": xs, "c0": c0}, dmesh)
    plan = ExecutionPlan.explicit("seq_chunked", 4, axis=1, mesh=mesh)
    fn = build_apply(lambda u: torch.tanh(u @ wt), plan)
    res["seq_chunked"] = dict(zip(("y", "loss", "g"), seq_run(
        fn, [local["x"].numpy()])))
    plan = ExecutionPlan.explicit("seq_carry_scan", 4, axis=1, mesh=mesh)
    fn = build_apply(ema_body, plan)
    res["seq_carry_scan"] = dict(zip(("y", "loss", "g"), seq_run(
        fn, [local["c0"].numpy(), local["x"].numpy()])))
    flat = {}
    for e, r in res.items():
        ys = r["y"] if isinstance(r["y"], list) else [r["y"]]
        for i, a in enumerate(ys):
            flat[f"{e}/y{i}"] = a
        flat[f"{e}/loss"] = np.asarray(r["loss"])
        for i, a in enumerate(r["g"]):
            flat[f"{e}/g{i}"] = a
    np.savez(f"{out}/rank{rank}.npz", **flat)
finally:
    dist.destroy_process_group()
'''


def _spawn(script, world, tmp_path, *args):
    """Run ``script`` as ``world`` ranks meeting through a file store;
    every rank must end within the group's timeout."""
    init = tmp_path / "init"
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(rank), str(world), str(init),
         *map(str, args)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=GROUP_TIMEOUT_S + 60))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}: {err[-4000:]}"
    return [out for out, _ in outs]


@pytest.fixture(scope="module", params=MESHES, ids=MESHES)
def group_run(request, tmp_path_factory):
    """One process group per mesh: every engine's output, loss and
    gradients on each rank."""
    mesh_s = request.param
    world = MeshSpec.parse(mesh_s).n_devices
    d = tmp_path_factory.mktemp("group")
    script = WORKER.replace("json_engines", repr(CNN_ENGINES))
    _spawn(script, world, d, d, mesh_s, GROUP_TIMEOUT_S)
    return mesh_s, [dict(np.load(d / f"rank{r}.npz"))
                    for r in range(world)]


def _single_device():
    ns = {}
    exec(COMMON, ns)
    mods, trunk, x = ns["cnn_inputs"](H, BATCH)
    want = {"cnn": ns["cnn_loss_grads"](make_column_apply(mods), trunk,
                                        torch.tensor(x))}
    xs, w, c0 = ns["seq_inputs"]()
    wt = torch.tensor(w)
    want["seq_chunked"] = ns["seq_run"](lambda u: torch.tanh(u @ wt), [xs])
    from repro_torch.core.seqrow import carry_scan_remat
    want["seq_carry_scan"] = ns["seq_run"](
        lambda c, u: carry_scan_remat(ns["ema_body"], c, u, 1, 1), [c0, xs])
    return want, x.shape[0]


def _max_rel(a, b):
    out = 0.0
    for u, v in zip(a, b):
        denom = float(np.abs(u).max())
        if denom > 0:
            out = max(out, float(np.abs(u - v).max()) / denom)
    return out


@pytest.mark.parametrize("engine", [e for e, _ in CNN_ENGINES]
                         + SEQ_ENGINES)
def test_shard_parity(group_run, engine):
    """Every rank's gathered output, the loss of the global batch and the
    gradients equal single-device execution (sequence engines: the input
    gradients, this rank's slice of the batch)."""
    mesh_s, ranks = group_run
    want, B = _single_device_cached()
    ref = want["cnn"] if engine not in SEQ_ENGINES else want[engine]
    seq = engine in SEQ_ENGINES
    k = MeshSpec.parse(mesh_s).data
    for rank, got in enumerate(ranks):
        n_y = sum(1 for n in got if n.startswith(f"{engine}/y"))
        ys = [got[f"{engine}/y{i}"] for i in range(n_y)]
        ref_ys = ref[0] if seq else [ref[0]]
        for y, y0 in zip(ys, ref_ys):
            assert np.abs(y - y0).max() <= (1e-6 if seq else 1e-5)
        loss = float(got[f"{engine}/loss"])
        assert abs(loss - ref[1]) / abs(ref[1]) < 1e-5
        n_g = sum(1 for n in got if n.startswith(f"{engine}/g"))
        g = [got[f"{engine}/g{i}"] for i in range(n_g)]
        g0 = ref[2]
        if seq:  # this rank's batch slice of the input gradients
            coord = rank // (MeshSpec.parse(mesh_s).model)
            per = B // k
            g0 = [a[coord * per:(coord + 1) * per] for a in g0]
            assert all(np.allclose(u, v, rtol=1e-5, atol=1e-5)
                       for u, v in zip(g, g0))
        else:
            assert _max_rel(g0, g) < 1e-4


_CACHE = {}


def _single_device_cached():
    if "want" not in _CACHE:
        _CACHE["want"] = _single_device()
    return _CACHE["want"]


TRAIN_WORKER = r'''
import datetime, json, sys
import torch
import torch.distributed as dist

rank, world, init, out, timeout = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=float(timeout)))
try:
    from repro_torch.launch import train as T
    recs = T.main(["--arch", "vgg16", "--preset", "reduced", "--strategy",
                   "overlap", "--rows", "2", "--mesh", "data=2", "--batch",
                   "4", "--steps", "3", "--device", "cpu", "--log-every",
                   "1", "--out", f"{out}/rank{rank}"])
    json.dump([r["loss"] for r in recs], open(f"{out}/losses{rank}.json",
                                              "w"))
finally:
    dist.destroy_process_group()
'''


def test_train_cnn_mesh_data2_trains(tmp_path):
    """``train_cnn --mesh data=2`` in a 2-rank group: each rank takes half
    of every batch, and both see the single-process losses; only rank 0
    prints and writes ``train_log.json``."""
    from repro_torch.launch import train as T
    outs = _spawn(TRAIN_WORKER, 2, tmp_path, tmp_path, GROUP_TIMEOUT_S)
    single = [r["loss"] for r in T.main(
        ["--arch", "vgg16", "--preset", "reduced", "--strategy", "overlap",
         "--rows", "2", "--batch", "4", "--steps", "3", "--device", "cpu",
         "--log-every", "1", "--out", str(tmp_path / "single")])]
    assert len(single) == 3
    for rank in range(2):
        got = json.load(open(tmp_path / f"losses{rank}.json"))
        assert all(abs(a - b) / abs(b) < 1e-5 for a, b in zip(got, single)), \
            (got, single)
    assert "plan: ExecutionPlan(engine=overlap N=2 mesh=data=2" in outs[0]
    assert "loss" in outs[0] and "loss" not in outs[1]
    assert (tmp_path / "rank0" / "train_log.json").exists()
    assert not (tmp_path / "rank1" / "train_log.json").exists()
    log = json.load(open(tmp_path / "rank0" / "train_log.json"))
    assert log["plan"]["mesh"]["axes"] == [["data", 2]]
