"""Sharded serving against the JAX package: ``Planner.for_serve(mesh=)``,
the decode caches' shapes and placements (``launch/steps.py``),
``serve(mesh=...)`` with the decode-slot pool split over the batch axes,
the server's ``--mesh``, and the ``ctx=`` prefill and decode steps with
the parameters and the caches sharded over the model axis.

``repro.launch.steps`` and ``repro.models.lm`` import only JAX, so the
reference's placements (over an ``AbstractMesh``), cache shapes and
shapes are computed here.  Its ``repro.serve`` and ``Planner`` need the
``TransferToMemoryKind`` name JAX 0.9 dropped, so two child processes
install a stand-in for it: one answers the plans, the ``ValueError``
texts and the unsharded served streams, the other the one-device prefill
and decode logits; the stand-in never enters this process.  The port's
ranks are separate processes meeting through a ``file://`` store: one
group of 2 runs ``data=2`` then ``data=1,model=2``, one of 4
``data=2,model=2`` then ``data=1,model=4``.  Every process reads the same
seeded weights, which the port's store writes and both packages' stores
read; the children and the groups all start with the module's first test
and work while the in-process tests run.  Tolerances: greedy streams
equal token for token; the logits of every prefill and decode step
within 1e-5 of the largest |logit| (fp32 reduced configs) of both the
port's one process and the reference's one device.
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

from repro.configs import get_config as ref_config
from repro.configs import get_reduced as ref_reduced
from repro.launch import steps as ref_steps
from repro_torch.ckpt import store
from repro_torch.configs import get_config, get_reduced
from repro_torch.exec import ExecutionPlan, MeshSpec, Planner
from repro_torch.launch import sharding as sh
from repro_torch.launch import steps
from repro_torch.serve import make_requests, serve

ROOT = pathlib.Path(__file__).resolve().parents[1]
GROUP_TIMEOUT_S = 240
ARCHS = ["qwen3_moe_235b_a22b", "llava_next_34b", "qwen1_5_110b",
         "xlstm_125m", "deepseek_moe_16b", "llama3_2_3b", "gemma3_4b",
         "zamba2_7b", "seamless_m4t_medium", "qwen1_5_4b"]
OPTIMIZED = ["llama3_2_3b", "qwen1_5_110b", "qwen3_moe_235b_a22b"]

# ---------------------------------------------------------------------------
# what the reference child answers
# ---------------------------------------------------------------------------

PLAN_MESHES = ["data=2", "data=2,model=2", "pod=2,data=2"]
PLAN_MAX_LEN, PLAN_ENC_LEN = 48, 12

#: request specs: make_requests kwargs (+ n); lists stay choice sets
REQS = {
    "mixed": dict(n=5, seed=1, traffic="poisson", prompt_len=[8, 16],
                  max_new_tokens=[3, 4, 5, 6], mean_interarrival=1.5),
    # rids 0, 1 arrive at t=0 with low priority; 2, 3 just after with high
    # priority: in a 2-slot pool they evict an in-flight prefill
    "preempt": dict(n=4, seed=6, traffic="static", prompt_len=16,
                    max_new_tokens=3,
                    override=[[0.0, 0], [0.0, 0], [0.5, 4], [0.5, 4]]),
    "audio": dict(n=4, seed=4, traffic="poisson", prompt_len=[6, 12],
                  max_new_tokens=[2, 3, 4], mean_interarrival=1.5,
                  frontend="audio", n_feature_tokens=12, feature_dim=128),
}
#: name -> (arch, request spec, serve kwargs, meshes it is served on)
SERVED = {
    "qwen_cont": ("qwen1_5_4b", "mixed", dict(n_slots=4),
                  ["data=2", "data=2,model=2"]),
    "gemma_static": ("gemma3_4b", "mixed", dict(n_slots=4, mode="static"),
                     ["data=2"]),
    "gemma_cohort": ("gemma3_4b", "mixed", dict(n_slots=4, decode_batch=2),
                     ["data=2"]),
    "gemma_preempt": ("gemma3_4b", "preempt", dict(
        n_slots=2, prefill_budget=200_000, preemptible_prefill=True),
        ["data=2"]),
    "zamba_cont": ("zamba2_7b", "mixed", dict(n_slots=4), ["data=2"]),
    "dsmoe_cont": ("deepseek_moe_16b", "mixed", dict(n_slots=2),
                   ["data=2"]),
    "seamless_cont": ("seamless_m4t_medium", "audio",
                      dict(n_slots=2, enc_len=12), ["data=2"]),
}
SERVED_ARCHS = sorted({a for a, _, _, _ in SERVED.values()})
#: scenarios whose reference streams are another's (the same requests;
#: greedy streams do not depend on the schedule): the child skips them
SAME_STREAMS = {"gemma_cohort": "gemma_static"}


def _unsharded(kw, meshes):
    """The one-process serve of a sharded scenario: its prefill budget
    divided by the batch extent, as ``serve(mesh=)`` divides it (a
    scenario's meshes share one extent)."""
    extent, = {MeshSpec.parse(m).batch_extent for m in meshes}
    if kw.get("prefill_budget"):
        kw = dict(kw, prefill_budget=kw["prefill_budget"] // extent)
    return kw

CHILD = r'''
import dataclasses, json, sys
import numpy as np
import jax, jax.memory, jax.sharding, jax.numpy as jnp
if not hasattr(jax.sharding, "TransferToMemoryKind"):
    # JAX 0.9 dropped the name repro.exec.rowprog imports; this process only
    jax.sharding.TransferToMemoryKind = lambda kind: (
        jax.memory.Space.Host if "host" in kind else jax.memory.Space.Device)
from repro.ckpt import store
from repro.configs import get_reduced
from repro.exec import ExecutionPlan, MeshSpec, Planner
from repro.launch import steps
from repro.models.lm import encdec as ED
from repro.models.lm import model as LM
from repro.serve import make_requests, serve
from repro.serve.cache_pool import PagedCachePool, QuantCachePool

d, part = sys.argv[1:3]
spec = json.load(open(d + "/spec.json"))
out = {"plans": {}, "errors": {}, "served": {}}

# the step cases' one-device logits, teacher-forced
arrays = {}
for name, arch, over, B, S, L, n_dec in spec["steps"] * (part == "steps"):
    cfg = dataclasses.replace(get_reduced(arch), **over)
    params = store.restore(d + "/w_" + name, steps.params_specs(cfg))
    hb = dict(np.load(d + "/b_" + name + ".npz"))
    teacher = hb.pop("teacher")
    encdec = cfg.family == "encdec"
    prefill = ED.encdec_prefill if encdec else LM.lm_prefill
    decode = ED.encdec_decode if encdec else LM.lm_decode
    logits, caches = prefill(params, {k: jnp.asarray(v)
                                      for k, v in hb.items()}, cfg, L)
    rows = [np.asarray(logits[:, -1], np.float32)]
    for i in range(n_dec):
        logits, caches = decode(params, jnp.asarray(teacher[i][:, None]),
                                caches, cfg)
        rows.append(np.asarray(logits[:, -1], np.float32))
    arrays[name] = np.stack(rows)
if part == "steps":
    np.savez(d + "/ref_steps.npz", **arrays)
    sys.exit(0)

for arch in spec["archs"]:
    cfg = get_reduced(arch)
    enc = spec["enc_len"] if cfg.family == "encdec" else 0
    slot = Planner.decode_slot_bytes(cfg, spec["max_len"], enc)
    for m in spec["meshes"]:
        mesh = MeshSpec.parse(m)
        for kind, kw in (("budget", dict(budget=5 * slot + 7)),
                         ("pinned", dict(n_slots=3)),
                         ("pinned_budget", dict(n_slots=5, budget=slot))):
            out["plans"][f"{arch}|{m}|{kind}"] = Planner.for_serve(
                cfg, spec["max_len"], enc_len=enc, mesh=mesh, **kw).to_dict()
cfg = get_reduced("gemma3_4b")
mesh = MeshSpec.parse("data=2")
for name, kw in (("paged", dict(cache_kind="paged_kv")),
                 ("quant", dict(cache_kind="quant_kv")),
                 ("host", dict(decode_residency="host"))):
    try:
        Planner.for_serve(cfg, 32, n_slots=2, mesh=mesh, **kw)
    except ValueError as e:
        out["errors"][name] = str(e)
for name, cls in (("paged_pool", PagedCachePool),
                  ("quant_pool", QuantCachePool)):
    plan = ExecutionPlan(engine="serve_pool", n_rows=2, in_shape=None,
                         batch=2, mesh=mesh, extras=(
                             ("max_len", 32), ("cache_kind", cls.kind)))
    try:
        cls(cfg, plan)
    except ValueError as e:
        out["errors"][name] = str(e)


def requests(arch, name):
    kw = dict(spec["reqs"][name])
    n = kw.pop("n")
    over = kw.pop("override", None)
    reqs = make_requests(n, get_reduced(arch).vocab, **kw)
    if over:
        reqs = [dataclasses.replace(r, arrival=a, priority=p)
                for r, (a, p) in zip(reqs, over)]
    return reqs


params = {a: store.restore(d + "/w_" + a, steps.params_specs(get_reduced(a)))
          for a in spec["served_archs"]}
for name, (arch, rname, kw) in spec["served"].items():
    rep, plan = serve(params[arch], get_reduced(arch), requests(arch, rname),
                      **kw)
    out["served"][name] = {
        "tokens": {str(s.rid): list(map(int, s.generated))
                   for s in rep.states},
        "summary": rep.summary(), "events": rep.events}
json.dump(out, open(d + "/ref.json", "w"))
'''

#: (case, arch, config overrides, batch, prompt, cache length, decode
#: steps, meshes).  Prompts of 20 tokens overrun Gemma's 16-token ring;
#: on ``model=4`` Gemma's and LLaVA's 2 kv heads split the positions
#: (``_kv_fallback``), Gemma's at cache length 30 only the ring's (30
#: does not divide), and the 2-kv-head enc-dec's cross K/V too
STEP_MESHES = ["data=2", "data=1,model=2", "data=2,model=2",
               "data=1,model=4"]
STEP_CASES = [
    ("gemma", "gemma3_4b", {}, 2, 20, 32, 4, STEP_MESHES),
    ("gemma_l30", "gemma3_4b", {}, 2, 20, 30, 3, ["data=1,model=4"]),
    ("qwen", "qwen1_5_4b", {}, 2, 12, 24, 3, STEP_MESHES),
    ("moe", "deepseek_moe_16b", {}, 2, 12, 24, 3, STEP_MESHES),
    ("hybrid", "zamba2_7b", {}, 2, 12, 24, 3, STEP_MESHES),
    ("xlstm", "xlstm_125m", {}, 2, 12, 24, 3, STEP_MESHES),
    ("vlm", "llava_next_34b", {}, 2, 12, 40, 3, STEP_MESHES),
    ("encdec", "seamless_m4t_medium", {}, 2, 12, 24, 3, STEP_MESHES),
    ("encdec_kv2", "seamless_m4t_medium", {"n_kv_heads": 2}, 2, 12, 24, 2,
     ["data=1,model=4"]),
]
#: the server's --mesh on the data=2 group (rank 0 alone prints)
CLI = ["--arch", "qwen1_5_4b", "--preset", "reduced", "--mesh", "data=2",
       "--device", "cpu", "--requests", "6", "--traffic", "poisson",
       "--mixed-prompts", "--prompt-len", "32", "--gen", "8",
       "--budget-gb", "0.001"]


WORKER = r'''
import dataclasses, datetime, io, json, sys, contextlib
import numpy as np
import torch
import torch.distributed as dist


def pl_leaves(tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from pl_leaves(tree[k], out[k])
    elif isinstance(tree, (list, tuple)):
        for t, o in zip(tree, out):
            yield from pl_leaves(t, o)
    elif tree is not None:
        yield out


rank, world, init, src, out_dir, timeout = sys.argv[1:7]
rank, world = int(rank), int(world)
jobs = json.loads(sys.argv[7])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=float(timeout)))
from repro_torch import obs
from repro_torch.ckpt import store
from repro_torch.configs import get_reduced
from repro_torch.exec import MeshSpec
from repro_torch.launch import sharding as sh
from repro_torch.launch import steps
from repro_torch.launch.mesh import build_mesh
from repro_torch.optim.adamw import tree_leaves
from repro_torch.serve import make_pool, make_requests, serve


def run(mesh_s, job, d):
    spec = MeshSpec.parse(mesh_s)
    mesh = build_mesh(spec)
    out = {}
    for name, (arch, rname, kw) in job["served"].items():
        cfg = get_reduced(arch)
        params = store.restore(f"{src}/w_{arch}", steps.params_specs(cfg))
        rk = dict(job["reqs"][rname])
        n, over = rk.pop("n"), rk.pop("override", None)
        reqs = make_requests(n, cfg.vocab, **rk)
        if over:
            reqs = [dataclasses.replace(r, arrival=a, priority=p)
                    for r, (a, p) in zip(reqs, over)]
        with obs.capture():
            rep, plan = serve(params, cfg, reqs, mesh=spec, **kw)
        pool = make_pool(cfg, plan, device="cpu")
        out[name] = {
            "tokens": {str(s.rid): list(map(int, s.generated))
                       for s in rep.states},
            "summary": rep.summary(), "events": rep.events,
            "slot_history": {str(k): v for k, v in rep.slot_history.items()},
            "chunks": [s.prefill_chunks for s in rep.states],
            "plan": plan.to_dict(), "audit": rep.plan_audit,
            "slot_dims": sorted({t.shape[ax] for t, ax in zip(
                tree_leaves(pool.caches), pool._axes) if ax >= 0}),
            "slot_lo": pool.slot_lo}
    if job["cli"]:
        from repro_torch.launch import serve as S
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            S.main(job["cli"])
        out["cli"] = buf.getvalue()
    for name, arch, over, B, S, L, n_dec in job["steps"]:
        cfg = dataclasses.replace(get_reduced(arch), **over)
        glob = store.restore(f"{src}/w_{name}", steps.params_specs(cfg))
        hb = dict(np.load(f"{src}/b_{name}.npz"))
        teacher = hb.pop("teacher")
        enc = hb["frames"].shape[1] if "frames" in hb else 0
        ctx = sh.bind_groups(steps.make_shape_ctx(
            mesh, cfg, steps.ShapeSpec("t", "decode", L, B)))
        places = steps.state_sharding(ctx, {"params": glob})["params"]
        local = sh.local_shards(glob, places, mesh)
        del glob
        lo, hi = sh.local_bounds((B,), mesh, ctx.sharding(("batch",)))[0]
        rows = {k: torch.from_numpy(v[lo:hi]) for k, v in hb.items()}
        tok, caches, lg = steps.make_prefill_step(
            cfg, L, ctx=ctx)(local, rows)
        shapes = steps._cache_shapes(cfg, B, L, enc)
        cp = steps.cache_sharding(ctx, cfg, shapes)
        want = [tuple(sh.shard_of(t, p, mesh).shape) for t, p in zip(
            tree_leaves(shapes), pl_leaves(shapes, cp))]
        got = [tuple(t.shape) for t in tree_leaves(caches)]
        logits, toks = [lg[:, -1]], [tok]
        step = steps.make_serve_step(cfg, ctx=ctx, cache_len=L, enc_len=enc)
        for i in range(n_dec):
            tok, caches, lg = step(
                local, caches, {"tokens": torch.from_numpy(
                    teacher[i][lo:hi, None]).long()})
            logits.append(lg[:, -1])
            toks.append(tok)
        np.savez(f"{d}/{name}_rank{rank}.npz",
                 logits=torch.stack(logits).numpy(),
                 tokens=torch.stack(toks).numpy(), rows=np.asarray([lo, hi]),
                 shapes_ok=np.asarray(got == want),
                 param_elems=np.asarray(sum(t.numel()
                                            for t in tree_leaves(local))))
    json.dump(out, open(f"{d}/served_rank{rank}.json", "w"))


try:
    for mesh_s, job in jobs.items():
        run(mesh_s, job, f"{out_dir}/{job['tag']}")
finally:
    dist.destroy_process_group()
'''




def _init(cfg, seed):
    """Seeded weights of ``cfg`` (the port's init; both packages' stores
    read what the port's writes)."""
    from repro_torch.models.lm.model import family_fns
    return family_fns(cfg).init(torch.Generator().manual_seed(seed), cfg)


def _requests(arch, name):
    """The port's traffic of a request spec (the reference's, field for
    field: ``tests/test_torch_serve_pool.py``)."""
    kw = dict(REQS[name])
    n = kw.pop("n")
    over = kw.pop("override", None)
    reqs = make_requests(n, get_reduced(arch).vocab, **kw)
    if over:
        reqs = [dataclasses.replace(r, arrival=a, priority=p)
                for r, (a, p) in zip(reqs, over)]
    return reqs


def _case_cfgs(arch, over):
    return (dataclasses.replace(get_reduced(arch), **over),
            dataclasses.replace(ref_reduced(arch), **over))


def _batch(cfg, B, S, n_dec, seed):
    """Seeded prompts (patch embeddings or frames too) and the decode
    steps' teacher tokens."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "teacher": rng.integers(0, cfg.vocab, (n_dec, B)).astype(
               np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.normal(
            0, 1, (B, cfg.n_frontend_tokens, cfg.frontend_dim)) \
            .astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.normal(0, 1, (B, S, cfg.d_model)) \
            .astype(np.float32)
    return out


def _start(script, world, d, *args):
    """``world`` ranks of ``script`` meeting through a file store in
    ``d`` (each mesh of a group one after another)."""
    return [subprocess.Popen(
        [sys.executable, "-c", script, str(rank), str(world),
         str(d / "init"), *map(str, args)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(world)]


def _wait(procs, timeout):
    """Each process's stdout; every one must end in time with code 0."""
    outs = [p.communicate(timeout=timeout) for p in procs]
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}: {err[-4000:]}"
    return [out for out, _ in outs]


@pytest.fixture(scope="module", autouse=True)
def _started(tmp_path_factory):
    """With the module's first test: the weights (the reference's seeded
    init, written by its own store) and batches of every case, then the
    reference child and every mesh's process group, all at once, so they
    work while the in-process tests run."""
    d = tmp_path_factory.mktemp("serve_mesh")
    for i, (name, arch, over, B, S, L, n_dec, _) in enumerate(STEP_CASES):
        cfg, _ = _case_cfgs(arch, over)
        store.save(str(d / f"w_{name}"), 0, _init(cfg, 10 + i))
        np.savez(d / f"b_{name}.npz", **_batch(cfg, B, S, n_dec, 100 + i))
    for arch in SERVED_ARCHS:
        store.save(str(d / f"w_{arch}"), 0, _init(get_reduced(arch), 0))
    (d / "spec.json").write_text(json.dumps(dict(
        archs=ARCHS, meshes=PLAN_MESHES, max_len=PLAN_MAX_LEN,
        enc_len=PLAN_ENC_LEN, reqs=REQS,
        served={n: (a, r, _unsharded(kw, ms))
                for n, (a, r, kw, ms) in SERVED.items()
                if n not in SAME_STREAMS},
        served_archs=SERVED_ARCHS,
        steps=[c[:7] for c in STEP_CASES])))
    children = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(d), part], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for part in ("steps", "serve")]
    groups = {}
    for world in sorted({MeshSpec.parse(m).n_devices for m in STEP_MESHES}):
        g = d / f"group{world}"
        jobs = {}
        for mesh_s in STEP_MESHES:
            if MeshSpec.parse(mesh_s).n_devices != world:
                continue
            tag = mesh_s.replace(",", "_").replace("=", "")
            (g / tag).mkdir(parents=True)
            jobs[mesh_s] = dict(
                tag=tag, reqs=REQS, cli=CLI if mesh_s == "data=2" else [],
                served={n: [a, r, kw] for n, (a, r, kw, ms)
                        in SERVED.items() if mesh_s in ms},
                steps=[c[:7] for c in STEP_CASES if mesh_s in c[7]])
        procs = _start(WORKER, world, g, d, g, GROUP_TIMEOUT_S,
                       json.dumps(jobs))
        for mesh_s, job in jobs.items():
            groups[mesh_s] = (g / job["tag"], procs)
    procs = children + list({id(p): p for _, ps in groups.values()
                             for p in ps}.values())
    try:
        yield d, children, groups
    finally:
        for p in procs:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def reference(_started):
    """The child's answers: plans, error texts, served streams and the
    step cases' one-device logits."""
    d, children, _ = _started
    _wait(children, 600)
    return (json.load(open(d / "ref.json")),
            dict(np.load(d / "ref_steps.npz")))


_GROUPS = {}


def group_run(started, mesh_s):
    """Each rank's answers of one mesh's group: its served reports (and
    the CLI's output on ``data=2``) and its step cases' logits."""
    if mesh_s not in _GROUPS:
        _, _, groups = started
        g, procs = groups[mesh_s]
        if not all(p.returncode == 0 for p in procs):
            _wait(procs, GROUP_TIMEOUT_S + 120)
        world = len(procs)
        served = [json.load(open(g / f"served_rank{r}.json"))
                  for r in range(world)]
        stepped = {c[0]: [dict(np.load(g / f"{c[0]}_rank{r}.npz"))
                          for r in range(world)]
                   for c in STEP_CASES if mesh_s in c[7]}
        _GROUPS[mesh_s] = (served, stepped)
    return _GROUPS[mesh_s]


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _full(arch, optimized):
    import importlib
    if not optimized:
        return get_config(arch), ref_config(arch)
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    ref = importlib.import_module(f"repro.configs.{arch}")
    return mod.OPTIMIZED, ref.OPTIMIZED


def _leaves(tree):
    """Leaves in the reference's order (dict keys sorted, None empty)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _leaves(t)
    elif tree is not None:
        yield tree


def _placement_leaves(tree, out):
    """``out``'s per-leaf placements (tuples themselves) in ``tree``'s
    leaf order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _placement_leaves(tree[k], out[k])
    elif isinstance(tree, (list, tuple)):
        for t, o in zip(tree, out):
            yield from _placement_leaves(t, o)
    elif tree is not None:
        yield out


def _sig(leaf):
    dtype = leaf.dtype
    name = str(dtype).replace("torch.", "") if isinstance(
        dtype, torch.dtype) else str(jnp.dtype(dtype))
    return tuple(leaf.shape), name


CONFIGS = [(a, False) for a in ARCHS] + [(a, True) for a in OPTIMIZED]
CONFIG_IDS = ARCHS + [f"{a}-OPTIMIZED" for a in OPTIMIZED]


@pytest.mark.parametrize("arch,optimized", CONFIGS, ids=CONFIG_IDS)
def test_input_specs_and_applicability_equal_reference(arch, optimized):
    """``shape_applicable``, ``cache_shape_specs`` and ``input_specs`` (at
    every shape) give the reference's answers, shapes and dtypes."""
    cfg, ref_cfg = _full(arch, optimized)
    for name, shape in steps.SHAPES.items():
        ref_shape = ref_steps.SHAPES[name]
        assert steps.shape_applicable(cfg, shape) \
            == ref_steps.shape_applicable(ref_cfg, ref_shape)
        got = [_sig(t) for t in _leaves(steps.input_specs(cfg, shape))
               if isinstance(t, torch.Tensor)]
        want = [_sig(t) for t in jax.tree.leaves(
            ref_steps.input_specs(ref_cfg, ref_shape))
            if hasattr(t, "shape")]
        assert got == want, name
        if shape.kind == "decode":
            assert [_sig(t) for t in _leaves(
                steps.cache_shape_specs(cfg, shape))] == [
                _sig(t) for t in jax.tree.leaves(
                    ref_steps.cache_shape_specs(ref_cfg, ref_shape))]


PLACEMENT_MESHES = {"data=16,model=16": {"data": 16, "model": 16},
                    "pod=2,data=16,model=16": {"pod": 2, "data": 16,
                                               "model": 16}}


@pytest.mark.parametrize("arch,optimized", CONFIGS, ids=CONFIG_IDS)
def test_cache_placements_equal_reference(arch, optimized):
    """``cache_sharding`` at ``decode_32k`` (and ``long_500k`` where it
    applies) on the production meshes: the reference's
    ``NamedSharding`` specs mapped through :func:`placements`, leaf for
    leaf, ``_kv_fallback`` included (kv heads that do not divide the
    model axis put the positions over it)."""
    cfg, ref_cfg = _full(arch, optimized)
    fallbacks = 0
    for mesh_s, sizes in PLACEMENT_MESHES.items():
        mesh = MeshSpec.parse(mesh_s)
        ref_mesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
        for name in ("decode_32k", "long_500k"):
            shape, ref_shape = steps.SHAPES[name], ref_steps.SHAPES[name]
            if not steps.shape_applicable(cfg, shape)[0]:
                continue
            ctx = steps.make_shape_ctx(mesh, cfg, shape)
            ref_ctx = ref_steps.make_shape_ctx(ref_mesh, ref_cfg, ref_shape)
            shapes = steps.cache_shape_specs(cfg, shape)
            got = list(_placement_leaves(
                shapes, steps.cache_sharding(ctx, cfg, shapes)))
            want = [s.spec for s in jax.tree.leaves(
                ref_steps.cache_sharding(
                    ref_ctx, ref_cfg,
                    ref_steps.cache_shape_specs(ref_cfg, ref_shape)),
                is_leaf=lambda x: hasattr(x, "spec"))]
            assert got == [sh.placements(tuple(w), mesh) for w in want], \
                (mesh_s, name)
            fallbacks += sum(
                len(w) > 3 and w[-2] is None and w[-3] is not None
                and "model" in (w[-3] if isinstance(w[-3], tuple)
                                else (w[-3],)) for w in want)
    if cfg.family != "ssm" and cfg.n_kv_heads % 16:
        assert fallbacks, "no cache took the _kv_fallback"


# ---------------------------------------------------------------------------
# (b) Planner.for_serve(mesh=)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_for_serve_mesh_plans_equal_reference(reference, arch):
    """The pool plan's JSON under a budget, a pinned slot count (rounded
    up to a multiple of the batch extent) and both, on ``data=2``,
    ``data=2,model=2`` and ``pod=2,data=2``: ``slots_per_device``, the
    per-device and global estimates and the mesh equal the reference's."""
    cfg = get_reduced(arch)
    enc = PLAN_ENC_LEN if cfg.family == "encdec" else 0
    slot = Planner.decode_slot_bytes(cfg, PLAN_MAX_LEN, enc)
    for m in PLAN_MESHES:
        for kind, kw in (("budget", dict(budget=5 * slot + 7)),
                         ("pinned", dict(n_slots=3)),
                         ("pinned_budget", dict(n_slots=5, budget=slot))):
            got = Planner.for_serve(cfg, PLAN_MAX_LEN, enc_len=enc,
                                    mesh=MeshSpec.parse(m), **kw)
            assert got.to_dict() \
                == reference[0]["plans"][f"{arch}|{m}|{kind}"]
            per = got.get("slots_per_device")
            assert got.n_rows == per * MeshSpec.parse(m).batch_extent
            assert got.est_bytes == got.est_bytes_per_device \
                * MeshSpec.parse(m).batch_extent


def test_single_host_pools_raise_as_the_reference(reference):
    """Paged, quantised and host-resident pools are single-host: the
    planner and the pool classes raise the reference's ``ValueError``."""
    from repro_torch.serve import PagedCachePool, QuantCachePool
    cfg = get_reduced("gemma3_4b")
    mesh = MeshSpec.parse("data=2")
    errors = reference[0]["errors"]
    for name, kw in (("paged", dict(cache_kind="paged_kv")),
                     ("quant", dict(cache_kind="quant_kv")),
                     ("host", dict(decode_residency="host"))):
        with pytest.raises(ValueError) as e:
            Planner.for_serve(cfg, 32, n_slots=2, mesh=mesh, **kw)
        assert str(e.value) == errors[name]
    for name, cls in (("paged_pool", PagedCachePool),
                      ("quant_pool", QuantCachePool)):
        plan = ExecutionPlan(engine="serve_pool", n_rows=2, in_shape=None,
                             batch=2, mesh=mesh, extras=(
                                 ("max_len", 32), ("cache_kind", cls.kind)))
        with pytest.raises(ValueError) as e:
            cls(cfg, plan, device="cpu")
        assert str(e.value) == errors[name]


# ---------------------------------------------------------------------------
# (c) ranks in spawned gloo groups: serve(mesh=), --mesh, ctx= steps
# ---------------------------------------------------------------------------

_ONE = {}


def _one_process_serve(d, name):
    """The port's one-process run of a served scenario (prefill budget
    per device, :func:`_unsharded`)."""
    if name not in _ONE:
        arch, rname, kw, meshes = SERVED[name]
        kw = _unsharded(kw, meshes)
        params = store.restore(str(d / f"w_{arch}"),
                               steps.params_specs(get_reduced(arch)))
        rep, plan = serve(params, get_reduced(arch), _requests(arch, rname),
                          **kw)
        _ONE[name] = ({str(s.rid): list(s.generated) for s in rep.states},
                      rep.summary(), rep.events)
    return _ONE[name]


@pytest.mark.parametrize(
    "mesh_s,name", [(m, n) for n, (_, _, _, ms) in SERVED.items()
                    for m in ms],
    ids=[f"{m}-{n}" for n, (_, _, _, ms) in SERVED.items() for m in ms])
def test_sharded_serve_matches_one_process_and_reference(
        _started, reference, mesh_s, name):
    """``serve(mesh=...)``: every rank's greedy streams equal the port's
    one process and the reference's unsharded ``serve``, token for token;
    every rank's report (summary, tick events, slot histories, prefill
    chunks) equals rank 0's and one process's; each rank's pool leaves
    hold ``slots_per_device`` slots, its own block of them; the pool
    audit sums the ranks' bytes against the global estimate."""
    served, _ = group_run(_started, mesh_s)
    arch, _, kw, _ = SERVED[name]
    spec = MeshSpec.parse(mesh_s)
    tokens, summary, events = _one_process_serve(_started[0], name)
    want = reference[0]["served"][SAME_STREAMS.get(name, name)]
    assert tokens == want["tokens"]
    if name not in SAME_STREAMS:
        assert summary == want["summary"]
    r0 = served[0][name]
    per = r0["plan"]["extras"]["slots_per_device"] \
        if isinstance(r0["plan"]["extras"], dict) else \
        dict(r0["plan"]["extras"])["slots_per_device"]
    for rank, ranks in enumerate(served):
        got = ranks[name]
        assert got["tokens"] == want["tokens"], rank
        for k in ("summary", "events", "slot_history", "chunks", "plan",
                  "audit"):
            assert got[k] == r0[k], (rank, k)
        assert got["summary"] == summary and got["events"] == events
        assert got["slot_dims"] == [per]
        b = rank // spec.model  # row-major: model is the minor axis
        assert got["slot_lo"] == b * per
    assert per * spec.batch_extent == kw["n_slots"]
    assert 0.95 <= r0["audit"]["ratio"] <= 1.10


def test_serve_cli_mesh(_started):
    """``launch.serve --mesh data=2`` under a process group: rank 0
    prints the sharded pool plan, its audit and ``serve OK``; the other
    rank prints nothing."""
    served, _ = group_run(_started, "data=2")
    out0, out1 = served[0]["cli"], served[1]["cli"]
    assert "pool plan: ExecutionPlan(engine=serve_pool N=6 mesh=data=2" \
        in out0 and "slots_per_device=3" in out0
    assert "serve OK" in out0 and out1 == ""


def _control_calls():
    """The scheduler's control collectives, each on the host tensor it
    builds: the slot holder's token broadcast, the all-gather of the
    drawn int32 tokens, the pool audit's byte sum and the completion
    stamps' broadcast."""
    from types import SimpleNamespace

    from repro_torch.exec.collectives import all_reduce_, broadcast_
    from repro_torch.serve.scheduler import Scheduler
    sched = object.__new__(Scheduler)
    sched.pool = SimpleNamespace(batch_group="batch", n_local=2, slot_lo=2)
    return {
        "token": lambda: sched._from_holder(3, 7),
        "drawn": lambda: sched._gathered({2: 5}),
        "pool_bytes": lambda: all_reduce_(
            torch.tensor([11], dtype=torch.int64), "batch"),
        "stamps": lambda: broadcast_(
            torch.tensor([0.5, 1.5], dtype=torch.float64), 0)}


@pytest.mark.parametrize("call", ["token", "drawn", "pool_bytes", "stamps"])
@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_control_collectives_run_where_the_backend_takes_them(
        monkeypatch, backend, call):
    """Each collective hands the backend its tensor where the backend
    takes it (``collectives.wire_device``): the scheduler's host tensors
    stay on the host under gloo and go through the rank's card under
    nccl, which rejects host tensors (``serve --mesh`` under torchrun
    picks nccl when each rank has a card).  Without a card the move to
    it is what fails, before NCCL is reached."""
    import torch.distributed as dist
    seen = []

    def record(t, *a, **k):
        seen.append(t.device.type)

    def gather(parts, t, **k):
        seen.append(t.device.type)
        for p in parts:
            p.copy_(t)

    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_global_rank", lambda group, r: r)
    monkeypatch.setattr(dist, "broadcast", record)
    monkeypatch.setattr(dist, "all_reduce", record)
    monkeypatch.setattr(dist, "all_gather", gather)
    run = _control_calls()[call]
    if backend == "nccl" and not torch.cuda.is_available():
        with pytest.raises(AssertionError, match="CUDA"):
            run()
        assert seen == []
        return
    run()
    assert seen == ["cuda" if backend == "nccl" else "cpu"]


_ONE_STEP = {}


def _one_process_steps(d, name):
    """The port's one-process prefill and decode logits of a step case,
    teacher-forced like the ranks."""
    if name not in _ONE_STEP:
        _, arch, over, B, S, L, n_dec, _ = next(
            c for c in STEP_CASES if c[0] == name)
        cfg, _ = _case_cfgs(arch, over)
        params = store.restore(str(d / f"w_{name}"),
                               steps.params_specs(cfg))
        hb = dict(np.load(d / f"b_{name}.npz"))
        teacher = hb.pop("teacher")
        enc = hb["frames"].shape[1] if "frames" in hb else 0
        batch = {k: torch.from_numpy(v) for k, v in hb.items()}
        _, caches, lg = steps.make_prefill_step(cfg, L)(
            params, batch)
        rows = [lg[:, -1]]
        step = steps.make_serve_step(cfg, cache_len=L, enc_len=enc)
        for i in range(n_dec):
            _, caches, lg = step(params, caches, {"tokens": torch.from_numpy(
                teacher[i][:, None]).long()})
            rows.append(lg[:, -1])
        _ONE_STEP[name] = torch.stack(rows).numpy()
    return _ONE_STEP[name]


@pytest.mark.parametrize(
    "mesh_s,name", [(m, c[0]) for c in STEP_CASES for m in c[7]],
    ids=[f"{m}-{c[0]}" for c in STEP_CASES for m in c[7]])
def test_ctx_steps_match_one_process_and_reference(_started, reference,
                                                   mesh_s, name):
    """``make_prefill_step(ctx=)`` and ``make_serve_step(ctx=)`` with each
    rank holding its shard of the parameters and of the caches (shapes
    those of ``cache_sharding``'s placements): every step's logits of the
    rank's rows within 1e-5 of the largest |logit| of the port's one
    process and of the reference's one device."""
    _, stepped = group_run(_started, mesh_s)
    one = _one_process_steps(_started[0], name)
    want = reference[1][name]
    scale = float(np.abs(want).max())
    assert float(np.abs(one - want).max()) <= 1e-5 * scale
    full = None
    for rank, got in enumerate(stepped[name]):
        lo, hi = got["rows"]
        assert bool(got["shapes_ok"]), rank
        assert float(np.abs(got["logits"] - one[:, lo:hi]).max()) \
            <= 1e-5 * scale, rank
        assert float(np.abs(got["logits"] - want[:, lo:hi]).max()) \
            <= 1e-5 * scale, rank
        full = int(got["param_elems"]) if full is None else full
    if MeshSpec.parse(mesh_s).model > 1:
        # the model axis splits the parameters: a rank holds less
        cfg, _ = _case_cfgs(*next((c[1], c[2]) for c in STEP_CASES
                                  if c[0] == name))
        assert full < sum(t.numel() for t in _leaves(
            steps.params_specs(cfg)))
