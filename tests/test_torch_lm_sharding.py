"""The LM's sharded train step against the JAX package: the shape
contexts and the state and batch placements of ``launch/steps.py``, shard
parity of every LM family in spawned ``gloo`` groups, the mesh plan's
JSON, and a sharded checkpoint.

``repro.launch.sharding`` and ``repro.launch.steps`` import only JAX, so
the reference's placements are built here over an ``AbstractMesh`` (no
devices).  The process groups are separate processes (2 ranks for
``data=2`` and ``data=1,model=2``, 4 for ``data=2,model=2``) that meet
through a ``file://`` store under ``tmp_path``, with a timeout of their
own; each runs every family of its mesh in one spawn.  The weights are
the reference's seeded init, written by ``repro.ckpt.store.save`` and
restored by each rank from the file.  Tolerances: the loss within 1e-5
relative of the reference's one-device ``lm_loss``/``encdec_loss``, each
rank's gradient shard within 1e-4 max-relative of the slice of
``jax.grad``, and the parameters after one AdamW step within 1e-3 of the
port's one-process step (the reference's bound for a sharded step,
``tests/test_lm_plan_exec.py``: AdamW's first step divides by
``sqrt(nu) ~ |g|``).
"""

import dataclasses
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
from jax.sharding import AbstractMesh

from repro.ckpt import store as ref_store
from repro.configs import get_config as ref_config
from repro.configs import get_reduced as ref_reduced
from repro.launch import steps as ref_steps
from repro.models.lm import encdec as ref_ed
from repro.models.lm import model as ref_lm
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro_torch.ckpt import store
from repro_torch.configs import get_config, get_reduced
from repro_torch.exec import MeshSpec
from repro_torch.launch import sharding as sh
from repro_torch.launch import steps
from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
GROUP_TIMEOUT_S = 240
ARCHS = ["qwen3_moe_235b_a22b", "llava_next_34b", "qwen1_5_110b",
         "xlstm_125m", "deepseek_moe_16b", "llama3_2_3b", "gemma3_4b",
         "zamba2_7b", "seamless_m4t_medium", "qwen1_5_4b"]
OPTIMIZED = ["llama3_2_3b", "qwen1_5_110b", "qwen3_moe_235b_a22b"]
PLACEMENT_MESHES = {"data=16,model=16": {"data": 16, "model": 16},
                    "pod=2,data=16,model=16": {"pod": 2, "data": 16,
                                               "model": 16},
                    "data=2,model=2": {"data": 2, "model": 2}}


def _abstract(sizes):
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _full(arch, optimized):
    """The full config of ``arch`` (its ``OPTIMIZED`` variant), in both
    packages."""
    import importlib
    if not optimized:
        return get_config(arch), ref_config(arch)
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    ref = importlib.import_module(f"repro.configs.{arch}")
    return mod.OPTIMIZED, ref.OPTIMIZED


# ---------------------------------------------------------------------------
# (a) placements, config by config
# ---------------------------------------------------------------------------


def _spec_placements(spec, mesh):
    return sh.placements(tuple(spec), mesh)


@pytest.mark.parametrize("arch,optimized",
                         [(a, False) for a in ARCHS]
                         + [(a, True) for a in OPTIMIZED],
                         ids=[a for a in ARCHS]
                         + [f"{a}-OPTIMIZED" for a in OPTIMIZED])
def test_placements_equal_reference(arch, optimized):
    """``make_shape_ctx``, ``state_sharding`` and ``batch_sharding`` of
    the full config (and its ``OPTIMIZED`` variant) on the production
    meshes and a 2×2 one, at the train shape's batch and at batches 1
    and 6 (the fallback axes): the reference's ``PartitionSpec`` s mapped
    through :func:`placements`, leaf for leaf."""
    cfg, ref_cfg = _full(arch, optimized)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    shapes = steps.params_specs(cfg)
    ref_shapes = ref_steps.params_specs(ref_cfg)
    state = {"params": shapes, "opt": adamw_init(shapes)}
    ref_state = {"params": ref_shapes,
                 "opt": jax.eval_shape(ref_adamw_init, ref_shapes)}
    for mesh_s, sizes in PLACEMENT_MESHES.items():
        mesh = MeshSpec.parse(mesh_s)
        ref_mesh = _abstract(sizes)
        for batch in (256, 1, 6):
            shape = steps.ShapeSpec("t", "train", 4096, batch)
            ref_shape = ref_steps.ShapeSpec("t", "train", 4096, batch)
            ctx = steps.make_shape_ctx(mesh, cfg, shape)
            ref_ctx = ref_steps.make_shape_ctx(ref_mesh, ref_cfg, ref_shape)
            assert ctx.logical == ref_ctx.logical, (mesh_s, batch)
            want = jax.tree.leaves(
                ref_steps.state_sharding(ref_ctx, ref_state),
                is_leaf=lambda x: hasattr(x, "spec"))
            got = steps.state_sharding(ctx, state)
            got_leaves = list(_placement_leaves(state, got))
            assert len(got_leaves) == len(want)
            assert got_leaves == [_spec_placements(w.spec, mesh)
                                  for w in want], (mesh_s, batch)
            b = steps.batch_specs(cfg, shape)
            rb = ref_steps.batch_specs(ref_cfg, ref_shape)
            assert {k: tuple(v.shape) for k, v in b.items()} \
                == {k: tuple(v.shape) for k, v in rb.items()}
            got_b = steps.batch_sharding(ctx, b)
            want_b = ref_steps.batch_sharding(ref_ctx, rb)
            assert got_b == {k: _spec_placements(v.spec, mesh)
                             for k, v in want_b.items()}


def _placement_leaves(tree, out):
    """``out``'s per-leaf placements in the reference's leaf order (dict
    keys sorted; AdamW's ``step`` is a leaf there too)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _placement_leaves(tree[k], out[k])
    elif isinstance(tree, (list, tuple)):
        for t, o in zip(tree, out):
            yield from _placement_leaves(t, o)
    elif tree is not None:
        yield out


def test_optimized_configs_are_the_references():
    for arch in OPTIMIZED:
        cfg, ref_cfg = _full(arch, True)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert _full("llama3_2_3b", True)[0].parallel == "dp_only"


def test_leaf_uses_split_or_gather():
    """Which leaves a rank computes on split: heads, ff, vocabulary and
    experts over ``model``; the SSM's fused in-projection, a row-split
    ``wk`` and every 2-D shard gathered at use."""
    mesh = MeshSpec.parse("data=2,model=4")

    def uses(cfg, batch=2):
        ctx = steps.make_shape_ctx(mesh, cfg,
                                   steps.ShapeSpec("t", "train", 64, batch))
        shapes = steps.params_specs(cfg)
        places = steps.state_sharding(ctx, {"params": shapes})["params"]
        return sh.leaf_uses(shapes, places, ctx)

    g = uses(get_reduced("gemma3_4b"))       # 4 heads, 2 kv heads
    attn = g["stack"]["segments"][0][0]["attn"]
    assert attn["wq"] == sh.LeafUse((("model", 2),), False)
    assert attn["wk"] == sh.LeafUse((("model", 1),), True)   # over d
    assert attn["wo"] == sh.LeafUse((("model", 1),), False)
    assert g["embed"]["table"] == sh.LeafUse((("model", 0),), False)
    mlp = g["stack"]["segments"][0][0]["mlp"]
    assert mlp["w_down"] == sh.LeafUse((("model", 1),), False)
    z = uses(get_reduced("zamba2_7b"))
    ssm = z["stack"]["segments"][0][0]["ssm"]
    assert ssm["w_in"].gather and ssm["conv_w"].gather
    d = uses(dataclasses.replace(get_reduced("llama3_2_3b"),
                                 parallel="dp_only"))
    assert d["embed"]["table"] == sh.LeafUse(
        (("model", 1), ("data", 1)), True)
    # batch over the model axis too: no tensor parallelism
    assert sh.tp_axis(steps.make_shape_ctx(
        mesh, dataclasses.replace(get_reduced("llama3_2_3b"),
                                  parallel="dp_only"),
        steps.ShapeSpec("t", "train", 64, 8))) is None


# ---------------------------------------------------------------------------
# (b) shard parity in spawned gloo groups
# ---------------------------------------------------------------------------

SEQ = 32

#: (case, arch, config overrides, batch); the kv1 Gemma puts its single
#: kv head's ``wk`` on the divisibility fallback (row-split over d),
#: gathered at use
CASES = [("gemma", "gemma3_4b", {}, 2),
         ("gemma_b1", "gemma3_4b", {}, 1),
         ("gemma_kv1", "gemma3_4b", {"n_kv_heads": 1}, 2),
         ("moe", "deepseek_moe_16b", {}, 2),
         ("hybrid", "zamba2_7b", {}, 2),
         ("xlstm", "xlstm_125m", {}, 2),
         ("vlm", "llava_next_34b", {}, 2),
         ("encdec", "seamless_m4t_medium", {}, 2),
         ("dp_only", "llama3_2_3b", {"parallel": "dp_only",
                                     "remat": "block_rows"}, 2)]
GROUP_MESHES = ["data=2", "data=1,model=2", "data=2,model=2"]


def _case_cfgs(arch, over):
    return (dataclasses.replace(get_reduced(arch), **over),
            dataclasses.replace(ref_reduced(arch), **over))


def _batch(cfg, B, seed):
    """Seeded tokens and labels (a quarter of the labels masked, so the
    ranks' label counts differ), plus patch embeddings or frames."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, SEQ)).astype(np.int32)}
    labels = rng.integers(0, cfg.vocab, (B, SEQ)).astype(np.int32)
    labels[rng.random((B, SEQ)) < 0.25] = -1
    out["labels"] = labels
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.normal(
            0, 1, (B, cfg.n_frontend_tokens, cfg.frontend_dim)) \
            .astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.normal(0, 1, (B, SEQ, cfg.d_model)) \
            .astype(np.float32)
    return out


WORKER = r'''
import datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist


def _pl_leaves(tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _pl_leaves(tree[k], out[k])
    elif isinstance(tree, (list, tuple)):
        for t, o in zip(tree, out):
            yield from _pl_leaves(t, o)
    elif tree is not None:
        yield (None, out)


rank, world, init, src, d, mesh_s, timeout = sys.argv[1:8]
rank, world = int(rank), int(world)
cases = json.loads(sys.argv[8])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=float(timeout)))
try:
    import dataclasses
    from repro_torch.ckpt import store
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import device_put_global
    from repro_torch.exec import MeshSpec
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    mesh = build_mesh(MeshSpec.parse(mesh_s))
    for name, arch, over, B in cases:
        cfg = dataclasses.replace(get_reduced(arch), **over)
        glob = store.restore(f"{src}/w_{name}", steps.params_specs(cfg))
        hb = dict(np.load(f"{src}/b_{name}.npz"))
        ctx = sh.bind_groups(steps.make_shape_ctx(
            mesh, cfg, steps.ShapeSpec("t", "train", hb["tokens"].shape[1],
                                       B)))
        places = steps.state_sharding(ctx, {"params": glob})["params"]
        local = sh.local_shards(glob, places, mesh)
        bounds = {k: sh.local_bounds(g.shape, mesh, pl) for (k, g), (_, pl)
                  in zip(store._flatten_with_keys(glob),
                         _pl_leaves(glob, places))}
        rows = device_put_global(hb, mesh,
                                 batch_axes=ctx.logical["batch"] or ())
        loss, aux, grads = steps.make_grad_fn(cfg, ctx=ctx)(local, rows)
        state = {"params": local, "opt": adamw_init(local)}
        step = steps.make_train_step(cfg, AdamWConfig(), ctx=ctx)
        state, metrics = step(state, rows)
        out = {"loss": np.asarray(float(loss)),
               "step_loss": np.asarray(float(metrics["loss"])),
               "gnorm": np.asarray(float(metrics["grad_norm"])),
               "rows": np.asarray(rows["tokens"].shape[0])}
        for k, g in store._flatten_with_keys(grads):
            out[f"g/{k}"] = g.numpy()
        for k, t in store._flatten_with_keys(state["params"]):
            out[f"p/{k}"] = t.numpy()
        for k, t in store._flatten_with_keys(state["opt"]["mu"]):
            out[f"mu_shape/{k}"] = np.asarray(t.shape)
        for k, b in bounds.items():
            out[f"b/{k}"] = np.asarray(b)
        np.savez(f"{d}/{name}_rank{rank}.npz", **out)
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


def _cases(mesh_s):
    """The cases of a mesh: batch 1 only where a data axis replicates it,
    the kv1 Gemma only under a model axis."""
    m = MeshSpec.parse(mesh_s)
    return [c for c in CASES
            if (c[0] != "gemma_b1" or m.data > 1)
            and (c[0] != "gemma_kv1" or m.model > 1)]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Every case's weights (the reference's seeded init, written by its
    own store) and batch, once for all meshes."""
    d = tmp_path_factory.mktemp("lminputs")
    for i, (name, arch, over, B) in enumerate(CASES):
        _, ref_cfg = _case_cfgs(arch, over)
        init = ref_ed.init_encdec if ref_cfg.family == "encdec" \
            else ref_lm.init_lm
        params = init(jax.random.PRNGKey(i), ref_cfg)
        ref_store.save(str(d / f"w_{name}"), 0, params)
        np.savez(d / f"b_{name}.npz", **_batch(ref_cfg, B, 100 + i))
    return d


@pytest.fixture(scope="module")
def group_run(inputs, tmp_path_factory):
    """``run(mesh)``: one process group per mesh, every case of the mesh
    in one spawn (made on the mesh's first use): each rank's loss,
    gradient shards, bounds and stepped shards."""
    done = {}

    def run(mesh_s):
        if mesh_s not in done:
            world = MeshSpec.parse(mesh_s).n_devices
            d = tmp_path_factory.mktemp("lmgroup")
            cases = _cases(mesh_s)
            _spawn(WORKER, world, d, inputs, d, mesh_s, GROUP_TIMEOUT_S,
                   json.dumps(cases))
            done[mesh_s] = {c[0]: [dict(np.load(d / f"{c[0]}_rank{r}.npz"))
                                   for r in range(world)] for c in cases}
        return done[mesh_s]

    return run


_REF = {}


def _reference(d, name):
    """The reference's one-device loss and gradients (flat keys), and the
    port's one-process AdamW step's parameters, on the case's inputs in
    ``d``."""
    if name in _REF:
        return _REF[name]
    _, arch, over, B = next(c for c in CASES if c[0] == name)
    cfg, ref_cfg = _case_cfgs(arch, over)
    params = ref_store.restore(str(d / f"w_{name}"),
                               ref_steps.params_specs(ref_cfg))
    hb = dict(np.load(d / f"b_{name}.npz"))
    loss_fn = ref_ed.encdec_loss if ref_cfg.family == "encdec" \
        else ref_lm.lm_loss
    batch = {k: jnp.asarray(v) for k, v in hb.items()}
    loss, grads = jax.value_and_grad(
        lambda p: loss_fn(p, batch, ref_cfg)[0])(params)
    flat_g = dict(zip((k for k, _ in store._flatten_with_keys(
        steps.params_specs(cfg))), (np.asarray(g) for g in
                                    jax.tree.leaves(grads))))
    # the port's one-process step on the same inputs
    glob = store.restore(str(d / f"w_{name}"), steps.params_specs(cfg))
    state = {"params": glob, "opt": adamw_init(glob)}
    tb = {k: torch.from_numpy(v) for k, v in hb.items()}
    state, metrics = steps.make_train_step(cfg, AdamWConfig())(state, tb)
    flat_p = {k: t.numpy() for k, t in
              store._flatten_with_keys(state["params"])}
    _REF[name] = (float(loss), flat_g, flat_p, float(metrics["grad_norm"]))
    return _REF[name]


def _ref_local_shapes(cfg, ref_cfg, mesh_s, B):
    """Each leaf's shard shape under the reference's ``state_sharding``."""
    spec = MeshSpec.parse(mesh_s)
    sizes = dict(spec.axes)
    ref_ctx = ref_steps.make_shape_ctx(
        _abstract(sizes), ref_cfg, ref_steps.ShapeSpec("t", "train", SEQ, B))
    shapes = ref_steps.params_specs(ref_cfg)
    specs = jax.tree.leaves(
        ref_steps.state_sharding(ref_ctx, {"params": shapes})["params"],
        is_leaf=lambda x: hasattr(x, "spec"))
    out = {}
    for (k, _), leaf, s in zip(store._flatten_with_keys(
            steps.params_specs(cfg)), jax.tree.leaves(shapes), specs):
        local = list(leaf.shape)
        for dim, entry in enumerate(s.spec):
            for a in (() if entry is None else (entry,)
                      if isinstance(entry, str) else entry):
                local[dim] //= sizes[a]
        out[k] = tuple(local)
    return out


def _max_rel(got, want):
    denom = float(np.abs(want).max())
    return float(np.abs(got - want).max()) / denom if denom > 0 else \
        float(np.abs(got).max())


@pytest.mark.parametrize(
    "mesh_s,name", [(m, c[0]) for m in GROUP_MESHES for c in _cases(m)],
    ids=[f"{m}-{c[0]}" for m in GROUP_MESHES for c in _cases(m)])
def test_lm_shard_parity(group_run, inputs, mesh_s, name):
    """Every rank: the global loss within 1e-5 of the reference's
    one-device loss; its gradient shards within 1e-4 of the slices of
    ``jax.grad``; after one AdamW step (global-norm clip included) its
    parameter shards within 1e-3 of the port's one-process step; it holds
    only the shards ``state_sharding`` places on it, parameters and
    moments alike, and its rows of the batch."""
    ranks, d = group_run(mesh_s), inputs
    _, arch, over, B = next(c for c in CASES if c[0] == name)
    cfg, ref_cfg = _case_cfgs(arch, over)
    loss, g_ref, p_one, gnorm = _reference(d, name)
    local = _ref_local_shapes(cfg, ref_cfg, mesh_s, B)
    ctx = steps.make_shape_ctx(MeshSpec.parse(mesh_s), cfg,
                               steps.ShapeSpec("t", "train", SEQ, B))
    sizes = dict(MeshSpec.parse(mesh_s).axes)
    rows = B // int(np.prod([sizes[a] for a in ctx.logical["batch"] or ()]))
    for rank, got in enumerate(ranks[name]):
        assert int(got["rows"]) == rows
        assert abs(float(got["loss"]) - loss) <= 1e-5 * abs(loss)
        assert abs(float(got["step_loss"]) - loss) <= 1e-5 * abs(loss)
        assert abs(float(got["gnorm"]) - gnorm) <= 1e-4 * gnorm
        for k, want in g_ref.items():
            b = got[f"b/{k}"]
            sl = tuple(slice(int(a), int(z)) for a, z in b)
            g = got[f"g/{k}"]
            assert g.shape == local[k], (k, g.shape, local[k])
            assert tuple(got[f"mu_shape/{k}"]) == local[k]
            assert _max_rel(g, want[sl]) < 1e-4, (rank, k)
            assert _max_rel(got[f"p/{k}"], p_one[k][sl]) < 1e-3, (rank, k)


# ---------------------------------------------------------------------------
# (c) the trainer's mesh plan against the reference's
# ---------------------------------------------------------------------------

PLAN_CHILD = r'''
import json, sys
import jax, jax.memory, jax.sharding
if not hasattr(jax.sharding, "TransferToMemoryKind"):
    # JAX 0.9 dropped the name repro.exec.rowprog imports; this process only
    jax.sharding.TransferToMemoryKind = lambda kind: (
        jax.memory.Space.Host if "host" in kind else jax.memory.Space.Device)
from repro.configs import get_reduced
from repro.exec import MeshSpec, Planner
out = {}
for arch, budget in (("gemma3_4b", 0.001), ("zamba2_7b", 0.002)):
    out[arch] = Planner.for_model(
        get_reduced(arch), 4, 64, budget=int(budget * 2**30),
        mesh=MeshSpec.parse("data=2")).to_dict()
json.dump(out, open(sys.argv[1], "w"))
'''

TRAIN_WORKER = r'''
import datetime, json, sys
import torch
import torch.distributed as dist

rank, world, init, out, timeout = sys.argv[1:6]
args = json.loads(sys.argv[6])
rank, world = int(rank), int(world)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=float(timeout)))
try:
    from repro_torch.launch import train as T
    for name, flags in args:
        recs = T.main(flags + ["--out", f"{out}/{name}"])
        json.dump([r["loss"] for r in recs],
                  open(f"{out}/{name}_losses{rank}.json", "w"))
finally:
    dist.destroy_process_group()
'''

COMMON = ["--preset", "reduced", "--seq", "64", "--batch", "4",
          "--device", "cpu", "--log-every", "1"]
TRAIN_RUNS = [
    ("gemma_plan", ["--arch", "gemma3_4b", "--steps", "2", "--mesh",
                    "data=2", "--budget-gb", "0.001"] + COMMON),
    ("zamba_plan", ["--arch", "zamba2_7b", "--steps", "1", "--mesh",
                    "data=2", "--budget-gb", "0.002"] + COMMON),
    ("gemma_save", ["--arch", "gemma3_4b", "--steps", "2", "--mesh",
                    "data=1,model=2", "--save"] + COMMON),
]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("lmtrain")
    outs = _spawn(TRAIN_WORKER, 2, d, d, GROUP_TIMEOUT_S,
                  json.dumps(TRAIN_RUNS))
    return d, outs


def test_train_lm_mesh_plan_equals_reference(trained, tmp_path):
    """``train_lm --mesh data=2 --budget-gb ...`` solves per device: the
    plan in ``train_log.json`` is the reference's ``for_model(mesh=)``
    plan, and the 2-rank losses are one process's."""
    from repro_torch.launch import train as T
    d, outs = trained
    r = subprocess.run(
        [sys.executable, "-c", PLAN_CHILD, str(tmp_path / "ref.json")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                           JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    ref = json.load(open(tmp_path / "ref.json"))
    for name, arch in (("gemma_plan", "gemma3_4b"),
                       ("zamba_plan", "zamba2_7b")):
        log = json.load(open(d / name / "train_log.json"))
        assert log["plan"] == ref[arch]
        flags = next(f for n, f in TRAIN_RUNS if n == name)
        single = [x["loss"] for x in T.main(
            [f for f in flags if f not in ("--mesh", "data=2")]
            + ["--out", str(tmp_path / name)])]
        for rank in range(2):
            got = json.load(open(d / f"{name}_losses{rank}.json"))
            assert np.allclose(got, single, rtol=1e-5, atol=0), (got, single)
    assert "plan: ExecutionPlan(engine=seq_swa_overlap" in outs[0]
    assert "mesh=data=2" in outs[0] and "loss" not in outs[1]


# ---------------------------------------------------------------------------
# (d) a sharded --save restores in one process, in both packages
# ---------------------------------------------------------------------------


def test_sharded_save_restores_in_one_process(trained):
    """``--save`` under ``data=1,model=2`` writes each split leaf shard by
    shard; the port restores it whole in one process, bit-equal to what
    the reference's ``restore`` reads, and it equals one process's run
    to float tolerance."""
    d, _ = trained
    ck = str(d / "gemma_save")
    cfg = get_reduced("gemma3_4b")
    template = steps.params_specs(cfg)
    got = store.restore(ck, template)
    ref = ref_store.restore(ck, ref_steps.params_specs(
        ref_reduced("gemma3_4b")))
    for a, b in zip(tree_leaves(got), jax.tree.leaves(ref)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    meta = store.restore_meta(ck)
    assert meta["step"] == 2
    layout = meta["shard_layout"]["params"]
    assert "embed/table" in layout and len(
        layout["embed/table"]["indices"]) == 2
    opt = store.restore(ck, adamw_init(template), kind="opt")
    assert opt["step"] == 2
    # the state of a one-process run of the same two steps
    from repro_torch.launch import train as T
    flags = next(f for n, f in TRAIN_RUNS if n == "gemma_save")
    one = str(d / "one")
    T.main([f for f in flags if f not in ("--mesh", "data=1,model=2")]
           + ["--out", one])
    want = store.restore(one, template)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert _max_rel(a.numpy(), b.numpy()) < 1e-3
