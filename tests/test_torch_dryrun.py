"""The dry run and its analysis against the JAX package:
``launch/dryrun.py``, ``launch/steps.py::build_step``,
``obs/audit.py::trace_step``, ``analysis/{costmodel,roofline,report}.py``,
the collectives' byte counts, and the position-split decode write
(``models/lm/attention.py::attn_decode``).

``repro.analysis.costmodel`` and the reference's ``Planner`` import
``repro.exec``, which needs the ``TransferToMemoryKind`` name JAX 0.9
dropped, so one child process installs a stand-in for it and answers the
analytic counts, ``model_flops``, the plans and ``shape_applicable`` for
every arch x shape x mesh; the stand-in never enters this process.  The
position-split decode runs on four ``gloo`` ranks (``data=1,model=4``)
meeting through a ``file://`` store, against the reference's one-device
decode in this process.  The child and the group start with the module's
first test and work while the in-process tests run.

Tolerances: analytic counts, plans, skip reasons and traced counts equal;
the analytic times equal the counts over the H100 constants to 1e-12
relative; decode logits within 1e-5 of the largest |logit| and caches
within 1e-5 of the largest |entry| of the reference's (fp32 reduced
config).
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
import torch.distributed as dist

from repro.analysis import report as ref_report
from repro.ckpt import store as ref_store
from repro.configs import get_reduced as ref_reduced
from repro.launch import steps as ref_steps
from repro.models.lm import model as ref_model
from repro_torch import obs
from repro_torch.analysis import costmodel, report, roofline
from repro_torch.ckpt import store
from repro_torch.configs import get_config, get_reduced, list_configs
from repro_torch.exec import ExecutionPlan, MeshSpec
from repro_torch.exec import collectives as coll
from repro_torch.launch import dryrun, steps
from repro_torch.launch import mesh as M
from repro_torch.launch.steps import SHAPES, ShapeSpec
from repro_torch.models.lm.model import family_fns, init_caches
from repro_torch.obs.audit import trace_step
from repro_torch.optim.adamw import tree_leaves, tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
GROUP_TIMEOUT_S = 240

REF_CHILD = r'''
import json, sys
import jax, jax.memory, jax.sharding
if not hasattr(jax.sharding, "TransferToMemoryKind"):
    # JAX 0.9 dropped the name repro.exec.rowprog imports; this process only
    jax.sharding.TransferToMemoryKind = lambda kind: (
        jax.memory.Space.Host if "host" in kind else jax.memory.Space.Device)
from repro.analysis.costmodel import analyze
from repro.analysis.roofline import model_flops
from repro.configs import get_config, list_configs
from repro.exec import Planner, kernelize_plan
from repro.launch.mesh import production_mesh_spec
from repro.launch.steps import SHAPES, shape_applicable

meshes = json.loads(sys.argv[2])
out = {"cost": {}, "model_flops": {}, "plans": {}, "applicable": {}}
for arch in list_configs():
    cfg = get_config(arch)
    for sn, shape in SHAPES.items():
        key = f"{arch}/{sn}"
        out["model_flops"][key] = model_flops(cfg, shape)
        out["applicable"][key] = list(shape_applicable(cfg, shape))
        for mn, ms in meshes.items():
            for fsdp in (0, 1):
                cb = analyze(cfg, shape, ms, fsdp=bool(fsdp))
                out["cost"][f"{key}/{mn}/{fsdp}"] = [
                    cb.flops, cb.hbm_bytes, cb.coll_bytes, cb.detail,
                    cb.bottleneck]
            base = Planner.for_model(cfg, shape.batch, shape.seq,
                                     mesh=production_mesh_spec(
                                         multi_pod=mn != "16x16"))
            for kernel in ("lax", "pallas"):
                plan = kernelize_plan(base, kernel)
                out["plans"][f"{key}/{mn}/{kernel}"] = [
                    plan.to_dict(), plan.per_device().to_dict()]
json.dump(out, open(sys.argv[1], "w"))
'''

#: the position-split decode: reduced Gemma-3 (2 kv heads) on model=4,
#: cache length 32 (8 positions a rank; the 16-token ring, 4), rows at
#: positions 13 and 21, so each step's two slots lie on different ranks
SPLIT_B, SPLIT_L, SPLIT_POS, SPLIT_STEPS = 2, 32, (13, 21), 3

SPLIT_WORKER = r'''
import datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, init, src = sys.argv[1:5]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=240))
from repro_torch.ckpt import store
from repro_torch.configs import get_reduced
from repro_torch.exec import MeshSpec
from repro_torch.launch import sharding as sh
from repro_torch.launch import steps
from repro_torch.launch.mesh import build_mesh
from repro_torch.models.lm.model import init_caches
from repro_torch.optim.adamw import tree_leaves, tree_map


def pl_leaves(tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from pl_leaves(tree[k], out[k])
    elif isinstance(tree, (list, tuple)):
        for t, o in zip(tree, out):
            yield from pl_leaves(t, o)
    elif tree is not None:
        yield out


try:
    spec = json.load(open(src + "/split.json"))
    B, L = spec["B"], spec["L"]
    cfg = get_reduced("gemma3_4b")
    mesh = build_mesh(MeshSpec.parse("data=1,model=4"))
    ctx = sh.bind_groups(steps.make_shape_ctx(
        mesh, cfg, steps.ShapeSpec("t", "decode", L, B)))
    glob = store.restore(src + "/w", steps.params_specs(cfg))
    places = steps.state_sharding(ctx, {"params": glob})["params"]
    params = sh.local_shards(glob, places, mesh)
    arrays = np.load(src + "/caches.npz")
    it = iter([torch.from_numpy(arrays[str(i)]) for i in range(len(arrays))])
    caches = tree_map(lambda _: next(it), init_caches(cfg, B, L, "meta"))
    cp = steps.cache_sharding(ctx, cfg, caches)
    bounds = [sh.local_bounds(t.shape, mesh, p) for t, p in zip(
        tree_leaves(caches), pl_leaves(caches, cp))]
    local = sh.local_shards(caches, cp, mesh)
    step = steps.make_serve_step(cfg, ctx=ctx, cache_len=L)
    teacher = np.load(src + "/teacher.npy")
    logits = []
    for i in range(len(teacher)):
        _, local, lg = step(params, local, {"tokens": torch.from_numpy(
            teacher[i][:, None]).long()})
        logits.append(lg[:, -1])
    np.savez(f"{src}/split_rank{rank}.npz",
             logits=torch.stack(logits).numpy(),
             **{str(i): t.numpy() for i, t in enumerate(tree_leaves(local))})
    json.dump(bounds, open(f"{src}/split_bounds{rank}.json", "w"))
finally:
    dist.destroy_process_group()
'''


def _split_inputs(d):
    """Seeded weights, caches (random K/V, rows at ``SPLIT_POS``) and
    teacher tokens of the position-split case, written to ``d``."""
    cfg = get_reduced("gemma3_4b")
    store.save(str(d / "w"), 0, family_fns(cfg).init(
        torch.Generator().manual_seed(7), cfg))
    rng = np.random.default_rng(8)
    leaves = []
    for t in tree_leaves(init_caches(cfg, SPLIT_B, SPLIT_L, "cpu")):
        a = t.numpy()
        if a.dtype == np.float32:
            a = rng.normal(0, 1, a.shape).astype(np.float32)
        elif a.dtype == np.int32 and a.shape[-1:] == (SPLIT_B,):
            a = np.broadcast_to(np.asarray(SPLIT_POS, np.int32),
                                a.shape).copy()
        leaves.append(a)
    np.savez(d / "caches.npz", **{str(i): a for i, a in enumerate(leaves)})
    np.save(d / "teacher.npy", rng.integers(
        0, cfg.vocab, (SPLIT_STEPS, SPLIT_B)).astype(np.int32))
    (d / "split.json").write_text(json.dumps({"B": SPLIT_B, "L": SPLIT_L}))


@pytest.fixture(scope="module", autouse=True)
def _started(tmp_path_factory):
    """With the module's first test: the reference child and the
    position-split group, so they work while the in-process tests run."""
    d = tmp_path_factory.mktemp("dryrun")
    _split_inputs(d)
    child = subprocess.Popen(
        [sys.executable, "-c", REF_CHILD, str(d / "ref.json"),
         json.dumps(MESHES)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    group = [subprocess.Popen(
        [sys.executable, "-c", SPLIT_WORKER, str(rank), "4",
         str(d / "init"), str(d)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(4)]
    try:
        yield d, child, group
    finally:
        for p in [child] + group:
            p.kill()
            p.wait()


def _wait(procs, timeout):
    for rank, p in enumerate(procs):
        _, err = p.communicate(timeout=timeout)
        assert p.returncode == 0, f"process {rank}: {err[-4000:]}"


@pytest.fixture(scope="module")
def reference(_started):
    d, child, _ = _started
    _wait([child], 600)
    return json.load(open(d / "ref.json"))


# ---------------------------------------------------------------------------
# the analytic model and MODEL_FLOPS: the reference's counts, H100 times
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list_configs())
def test_analytic_counts_equal_reference(reference, arch):
    """Every shape x {16x16, 2x16x16} x fsdp: FLOPs, HBM bytes, collective
    bytes and the per-component detail equal the reference's; the three
    times are the counts over the H100's constants."""
    cfg = get_config(arch)
    for sn, shape in SHAPES.items():
        key = f"{arch}/{sn}"
        assert roofline.model_flops(cfg, shape) \
            == reference["model_flops"][key]
        for mn, ms in MESHES.items():
            for fsdp in (0, 1):
                cb = costmodel.analyze(cfg, shape, ms, fsdp=bool(fsdp))
                flops, hbm, cbytes, detail, _ = \
                    reference["cost"][f"{key}/{mn}/{fsdp}"]
                assert (cb.flops, cb.hbm_bytes, cb.coll_bytes) \
                    == (flops, hbm, cbytes), (key, mn, fsdp)
                assert cb.detail == detail
                d = cb.as_dict()
                for t, n, peak in (
                        ("t_compute_s", flops, M.PEAK_FLOPS_BF16),
                        ("t_memory_s", hbm, M.HBM_BW),
                        ("t_collective_s", cbytes, M.LINK_BW)):
                    assert d[t] == pytest.approx(n / peak, rel=1e-12)
                assert d["bottleneck"] == max(
                    ("compute", "memory", "collective"),
                    key=lambda k: d[f"t_{k}_s"])


def test_h100_constants():
    assert (M.PEAK_FLOPS_BF16, M.HBM_BW, M.LINK_BW, M.HBM_BYTES) \
        == (989e12, 3.35e12, 450e9, 80e9)


# ---------------------------------------------------------------------------
# plans and skips: the reference's under the JSON name mapping
# ---------------------------------------------------------------------------


def _ref_plan(d):
    """A reference plan dict as the port reads it (lax -> plain, pallas
    -> cuda, the engines renamed)."""
    return ExecutionPlan.from_dict(dict(d)).to_dict()


def _kernel_free(d):
    """A plan dict without what the kernel pass adds by design (shared
    memory on the card, VMEM on the TPU; tiles, retiles, fallbacks)."""
    d = dict(d, kernel=None)
    d["extras"] = {k: v for k, v in (d["extras"] or {}).items()
                   if not k.startswith("kernel_")}
    return d


@pytest.mark.parametrize("kernel", ["plain", "cuda"])
@pytest.mark.parametrize("arch", list_configs())
def test_plans_equal_reference(reference, arch, kernel):
    """``resolve_plan`` (what ``run_one`` records) against the
    reference's ``Planner.for_model(..., mesh=production_mesh_spec)``,
    kernelized: whole under ``plain``; under ``cuda`` the engine swap, N
    and the estimates (the fields the planner tests hold equal)."""
    ref_kernel = {"plain": "lax", "cuda": "pallas"}[kernel]
    cfg = get_config(arch)
    for sn, shape in SHAPES.items():
        for mn in MESHES:
            plan = dryrun.resolve_plan(cfg, shape, mn != "16x16", kernel)
            want, want_dev = (_ref_plan(p) for p in reference["plans"][
                f"{arch}/{sn}/{mn}/{ref_kernel}"])
            got, got_dev = plan.to_dict(), plan.per_device().to_dict()
            if kernel == "plain":
                assert (got, got_dev) == (want, want_dev), (sn, mn)
            else:
                assert _kernel_free(got) == _kernel_free(want), (sn, mn)
                assert _kernel_free(got_dev) == _kernel_free(want_dev)
                assert got["kernel"]["backend"] \
                    == want["kernel"]["backend"]


def test_skip_records_equal_reference(reference, tmp_path):
    """``shape_applicable`` for every arch x shape, and ``run_one``'s skip
    records: the reason, the plan and the file the reference writes."""
    for arch in list_configs():
        for sn, shape in SHAPES.items():
            ok, why = steps.shape_applicable(get_config(arch), shape)
            assert [ok, why] == reference["applicable"][f"{arch}/{sn}"]
            if ok:
                continue
            rec = dryrun.run_one(arch, sn, True, False, str(tmp_path))
            assert rec["status"] == "skipped" and rec["reason"] == why
            assert rec["exec_plan"] == _ref_plan(
                reference["plans"][f"{arch}/{sn}/2x16x16/lax"][0])
            assert json.loads((tmp_path / f"{arch}_{sn}_2x16x16.json")
                              .read_text()) == rec
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"{a}_long_500k_2x16x16.json" for a in (
            "deepseek_moe_16b", "llama3_2_3b", "llava_next_34b",
            "qwen1_5_110b", "qwen1_5_4b", "qwen3_moe_235b_a22b",
            "seamless_m4t_medium")]


# ---------------------------------------------------------------------------
# the published-width combo, no card
# ---------------------------------------------------------------------------


def test_run_one_gemma_decode_published_width(reference, tmp_path):
    """``gemma3_4b x decode_32k x 16x16`` at published widths traces on
    ``meta`` (the position-split decode among it), records the traced
    counts, the plan audit and the analytic terms, and never asks for the
    card."""
    with obs.capture() as s:
        rec = dryrun.run_one("gemma3_4b", "decode_32k", False, False,
                             str(tmp_path), verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert not torch.cuda.is_initialized()
    assert not dist.is_initialized()
    assert rec["exec_plan"] == _ref_plan(
        reference["plans"]["gemma3_4b/decode_32k/16x16/lax"][0])
    assert rec["analytic"]["flops_per_chip"] == reference["cost"][
        "gemma3_4b/decode_32k/16x16/0"][0]
    audit = rec["plan_audit"]
    assert audit["source"] == "dryrun"
    assert audit["measured"]["method"] == "meta_trace"
    peak = audit["measured"]["peak_bytes"]
    assert peak == rec["traced_peak_bytes_per_chip"] > 0
    assert peak == audit["measured"]["argument_size_in_bytes"] \
        + audit["measured"]["temp_size_in_bytes"]
    assert rec["traced_flops_per_chip"] == sum(
        rec["traced_flops_by_op"].values()) > 0
    assert rec["traced_coll_bytes_per_chip"] == sum(
        rec["traced_coll_detail"].values()) > 0
    assert rec["n_chips"] == 256
    for k in ("t_compute_s", "t_memory_s", "t_collective_s"):
        assert rec[f"traced_{k}"] > 0
    assert not any(k.startswith("hlo_") for k in rec)
    assert [r["kind"] for r in s.tracer.records[1:]] == ["plan_audit"]
    on_disk = json.loads((tmp_path / "gemma3_4b_decode_32k_16x16.json")
                         .read_text())
    assert on_disk["status"] == "ok"


def test_plan_cache_keys_on_the_host(tmp_path):
    """``--plan-cache``: a miss solves and stores, a hit replays the same
    plan, and the key's fingerprint is the host's (no card asked for)."""
    kw = dict(plan_cache=str(tmp_path / "cache"), verbose=False)
    first = dryrun.run_one("llama3_2_3b", "long_500k", False, False, "",
                           **kw)
    again = dryrun.run_one("llama3_2_3b", "long_500k", False, False, "",
                           **kw)
    assert (first["plan_cache_hit"], again["plan_cache_hit"]) \
        == (False, True)
    assert again["exec_plan"] == first["exec_plan"]
    stored = [json.loads(p.read_text()) for p in
              (tmp_path / "cache").rglob("*.json")
              if p.name != "cost_table.json"]
    assert any("cpu:cpu:x1" in json.dumps(d) for d in stored)
    assert not torch.cuda.is_initialized()


def test_main_counts_and_exits_1_on_an_error(tmp_path, capsys,
                                            monkeypatch):
    dryrun.main(["--arch", "llama3_2_3b", "--shape", "long_500k",
                 "--mesh", "both", "--out", str(tmp_path)])
    assert "done: 0 ok, 2 skipped (documented), 0 errors" \
        in capsys.readouterr().out

    def broken(*a, **k):
        raise RuntimeError("no step")

    monkeypatch.setattr(dryrun, "build_step", broken)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "gemma3_4b", "--shape", "decode_32k",
                     "--mesh", "single", "--out", str(tmp_path)])
    assert e.value.code == 1
    rec = json.loads((tmp_path / "gemma3_4b_decode_32k_16x16.json")
                     .read_text())
    assert rec["status"] == "error"
    assert rec["error"] == "RuntimeError: no step"
    assert "no step" in rec["traceback"]
    assert not dist.is_initialized()  # the combo left the fake group


# ---------------------------------------------------------------------------
# traces: meta against real CPU tensors, and the tracer's memo
# ---------------------------------------------------------------------------

#: (family, arch, shape kind): a reduced config of each family, 2 rows a
#: rank of a fake 16x16 mesh, 32 tokens
TRACE_CASES = [("dense", "llama3_2_3b", "train"),
               ("ssm", "xlstm_125m", "train"),
               ("hybrid", "zamba2_7b", "train"),
               ("moe", "deepseek_moe_16b", "train"),
               ("vlm", "llava_next_34b", "train"),
               ("encdec", "seamless_m4t_medium", "train"),
               ("dense", "qwen1_5_4b", "prefill"),
               ("dense", "gemma3_4b", "decode"),
               ("hybrid", "zamba2_7b", "decode")]


def _real(tree, seed):
    """``tree``'s ``meta`` tensors as CPU tensors: floats small and
    seeded, the rest zero."""
    g = torch.Generator().manual_seed(seed)

    def one(t):
        if t.dtype.is_floating_point:
            return (torch.randn(t.shape, generator=g) * 0.02).to(t.dtype)
        return torch.zeros(t.shape, dtype=t.dtype)

    return tree_map(one, tree)


def _trace(cfg, shape, device):
    mesh = M.join_fake_group(M.production_mesh_spec())
    try:
        fn, args = steps.build_step(cfg, shape, mesh)
        if device == "cpu":
            args = _real(args, 0)
        return trace_step(fn, *args)
    finally:
        M.leave_fake_group()


@pytest.mark.parametrize("family,arch,kind", TRACE_CASES,
                         ids=[f"{f}-{a}-{k}" for f, a, k in TRACE_CASES])
def test_meta_trace_equals_cpu_run(family, arch, kind):
    """The same rank-0 step on ``meta`` tensors and on real CPU tensors
    under the same fake group: equal FLOPs (by op), bytes accessed,
    collective bytes, and peak, argument, temporary, output and aliased
    bytes (only ``meta`` results are memoized, so the CPU run is the
    unmemoized side)."""
    torch.set_num_threads(1)
    shape = ShapeSpec(f"{kind}_small", kind, 32, 32)
    cfg = get_reduced(arch)
    meta = _trace(cfg, shape, "meta")
    assert meta.pop("method") == "meta_trace"
    assert meta["flops"] > 0 and meta["peak_bytes"] > 0
    assert meta["collective_bytes"]
    cpu = _trace(cfg, shape, "cpu")
    if family == "moe":
        # F.one_hot's CPU kernel checks its classes' bounds (aminmax and a
        # scatter, a few KiB of traffic) where the meta kernel does not
        assert cpu.pop("bytes_accessed") == pytest.approx(
            meta.pop("bytes_accessed"), rel=1e-4)
    assert {k: v for k, v in cpu.items() if k != "method"} == meta
    assert not torch.cuda.is_initialized()


def test_trace_step_counts_storages_flops_and_loops():
    """A hand-counted call: two temporaries of N bytes live at once (a
    view of one adds nothing), an in-place update aliases the argument,
    and a product in a loop of 3 counts 3 times."""
    x = torch.empty(64, 32, device="meta")
    w = torch.empty(32, 32, device="meta")
    n = 64 * 32 * 4

    def f(x, w):
        a = x * 2.0
        b = (a + 1.0).t()
        del a
        c = b.t() * 3.0
        del b
        x.add_(1.0)
        for _ in range(3):
            c = c @ w
        return c, x

    got = trace_step(f, x, w)
    assert got["argument_size_in_bytes"] == n + 32 * 32 * 4
    assert got["temp_size_in_bytes"] == 2 * n
    assert got["output_size_in_bytes"] == n
    assert got["alias_size_in_bytes"] == n
    assert got["flops"] == 3 * 2 * 64 * 32 * 32
    assert got["flops_by_op"] == {"aten.mm": 3 * 2 * 64 * 32 * 32}
    # x*2, a+1, b.t()*3, x.add_, 3 mm: inputs read and outputs written
    assert got["bytes_accessed"] == 2 * n + 2 * n + 2 * n + 2 * n \
        + 3 * (2 * n + 32 * 32 * 4)
    assert got["collective_bytes"] == {}


def test_memo_keeps_storage_sharing():
    """``x @ w`` on a 3-d ``x`` is an ``mm`` whose result
    ``aten._unsafe_view`` reshapes without a copy, though its schema
    declares no alias: the memo must not give the second product a
    storage of its own.  The same call on CPU tensors, whose results are
    never memoized, is the unmemoized side."""
    x = torch.empty(4, 8, 16, device="meta")
    w = torch.empty(16, 32, device="meta")

    def f(x, w):
        return x @ w, x @ w

    got = trace_step(f, x, w)
    assert got == trace_step(f, torch.randn(4, 8, 16), torch.randn(16, 32))
    assert got["temp_size_in_bytes"] == got["output_size_in_bytes"] \
        == 2 * 4 * 8 * 32 * 4


# ---------------------------------------------------------------------------
# the collectives' byte counts
# ---------------------------------------------------------------------------


def test_collective_bytes_by_kind_on_a_fake_group():
    """A 4-rank fake group: a tally counts each kind's result buffer, as
    the reference's ``collective_bytes`` does (an all-gather the group's
    size times its input; a half-precision sum its fp32 wire), the obs
    counters the tensor each call sends, and every tensor stays on its
    own device, ``meta`` included."""
    M.join_fake_group(MeshSpec(axes=(("data", 4),)))
    try:
        t = torch.empty(3, 5, device="meta")
        assert coll.wire_device(t, None) == torch.device("meta")
        with obs.capture() as s, coll.tally() as got:
            y = coll.all_gather_cat(t, 0, None)
            coll.all_reduce_(torch.empty(7, device="meta"), None)
            coll.all_reduce_(torch.empty(7, dtype=torch.bfloat16,
                                         device="meta"), None)
            coll.broadcast_(torch.zeros(2, 2, dtype=torch.int64), 0)
        assert y.shape == (12, 5) and y.device.type == "meta"
        assert got == {"all-gather": 4 * 60, "all-reduce": 28 + 28,
                       "broadcast": 32}
        # the obs counters keep the bytes each call sends
        c = s.metrics.to_dict()["counters"]
        assert c["collectives.calls"] == 4
        assert c["collectives.bytes"] == 60 + 28 + 14 + 32
        assert not [k for k in c if k.startswith("collectives.bytes.")]
    finally:
        M.leave_fake_group()
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the position-split decode (module 3) against the reference
# ---------------------------------------------------------------------------


def _ref_split(d):
    """The reference's one-device decode of the position-split case:
    every step's logits and the final caches' leaves."""
    cfg = ref_reduced("gemma3_4b")
    params = ref_store.restore(str(d / "w"), ref_steps.params_specs(cfg))
    arrays = np.load(d / "caches.npz")
    treedef = jax.tree.structure(ref_model.init_caches(cfg, SPLIT_B,
                                                       SPLIT_L))
    caches = jax.tree.unflatten(treedef, [jnp.asarray(arrays[str(i)])
                                          for i in range(len(arrays))])
    logits = []
    for tok in np.load(d / "teacher.npy"):
        lg, caches = ref_model.lm_decode(params, jnp.asarray(tok[:, None]),
                                         caches, cfg)
        logits.append(np.asarray(lg[:, -1]))
    return np.stack(logits), [np.asarray(t) for t in jax.tree.leaves(caches)]


def test_position_split_decode_equals_reference(_started):
    """Reduced Gemma-3 on ``data=1,model=4``: its 2 kv heads split the
    cache positions over the model axis, and the rows sit at positions 13
    and 21, so each step writes its two rows' slots on different ranks
    (global layers: ranks 1 and 2; the 16-token ring: ranks 3 and 1).
    Every step's logits and every rank's final cache shard equal the
    reference's one-device decode."""
    d, _, group = _started
    want_logits, want_caches = _ref_split(d)
    _wait(group, GROUP_TIMEOUT_S + 60)
    scale = float(np.abs(want_logits).max())
    for rank in range(4):
        got = np.load(d / f"split_rank{rank}.npz")
        bounds = json.loads((d / f"split_bounds{rank}.json").read_text())
        assert float(np.abs(got["logits"] - want_logits).max()) \
            <= 1e-5 * scale, rank
        for i, (want, bd) in enumerate(zip(want_caches, bounds)):
            part = want[tuple(slice(a, b) for a, b in bd)]
            leaf = got[str(i)]
            assert leaf.shape == part.shape, (rank, i)
            if leaf.dtype == np.float32:
                tol = 1e-5 * max(1.0, float(np.abs(part).max()))
                assert float(np.abs(leaf - part).max()) <= tol, (rank, i)
            else:
                assert np.array_equal(leaf, part), (rank, i)
    # the slots written were split: every rank holds a quarter of the
    # positions of each K/V leaf
    assert any(b[-3] != [0, want.shape[-3]] for b, want in zip(
        bounds, want_caches) if want.ndim >= 4)


# ---------------------------------------------------------------------------
# report: the reference's assertions on the port's tables
# ---------------------------------------------------------------------------


def test_fmt_bytes():
    assert report.fmt_bytes(None) == "-"
    assert report.fmt_bytes(512) == "512.0B"
    assert report.fmt_bytes(2048) == "2.0KiB"
    assert report.fmt_bytes(3 * 2**20) == "3.0MiB"
    assert report.fmt_bytes(5 * 2**30) == "5.0GiB"
    assert report.fmt_bytes(2 * 2**40) == "2.0TiB"


def test_fmt_s():
    assert report.fmt_s(None) == "-"
    assert report.fmt_s(2.5) == "2.50s"
    assert report.fmt_s(0.0042) == "4.20ms"
    assert report.fmt_s(7e-6) == "7.0us"


def _ok_rec(arch="llama", shape="train_4k", mesh="16x16"):
    return {
        "arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
        "traced_peak_bytes_per_chip": 2**31,
        "traced_flops_per_chip": 1.5e12, "traced_coll_bytes_per_chip": 2**20,
        "traced_model_flops_global": 2.0e14, "traced_bottleneck": "memory",
        "t_trace_s": 3.0, "n_chips": 256,
        "analytic": {"flops_per_chip": 1.0e12, "t_compute_s": 0.01,
                     "t_memory_s": 0.002, "t_collective_s": 3e-4,
                     "bottleneck": "compute"},
    }


def _skip_rec(arch="moe", shape="serve_8k", mesh="16x16"):
    return {"arch": arch, "shape": shape, "mesh": mesh,
            "status": "skipped", "reason": "decode shape N/A for encoder"}


def test_dryrun_table_rows_and_mesh_filter():
    recs = [_ok_rec(), _skip_rec(), _ok_rec(mesh="2x16x16"),
            dict(_skip_rec(arch="ssm"), status="error")]
    md = report.dryrun_table(recs, "16x16")
    lines = md.splitlines()
    assert lines[0].startswith("| arch | shape | status ")
    assert "traced peak/rank" in lines[0] and "of 80 GB" in lines[0]
    assert "analytic flops/rank" in lines[0]
    assert len(lines) == 5  # header + separator + ok + skip + error
    assert "| llama | train_4k | ok | 2.0GiB | 2.7% | 1.50e+12 | 1.00e+12 " \
        "| 1.0MiB | 3.0s |" in md
    assert "SKIP (documented)" in md
    assert "| ssm | serve_8k | error |" in md
    assert "2x16x16" not in md


def test_roofline_table_ratio_and_notes():
    md = report.roofline_table([_ok_rec()], "16x16")
    # MODEL_FLOPS/analytic = 2e14 / (1e12 * 256); traced/analytic 1.5
    assert "| 0.78 | 1.50 | memory |" in md
    assert "**compute**" in md
    assert "10.00ms" in md and "2.00ms" in md
    assert len(report.roofline_table([_skip_rec()], "16x16")
               .splitlines()) == 2


def test_roofline_analytic_columns_equal_reference():
    """For equal ``analytic`` dicts the reference's table and the port's
    agree cell for cell on the analytic columns and the note."""
    for bn in ("compute", "memory", "collective"):
        rec = _ok_rec()
        rec["analytic"]["bottleneck"] = bn
        ref = dict(rec, hlo_model_flops_global=rec[
            "traced_model_flops_global"])
        want = ref_report.roofline_table([ref], "16x16").splitlines()[2] \
            .split("|")
        got = report.roofline_table([rec], "16x16").splitlines()[2] \
            .split("|")
        assert got[:8] == want[:8]
        assert got[-2] == want[-2]


def test_note_covers_every_bottleneck():
    for bn, frag in [("compute", "arithmetic intensity"),
                     ("memory", "streaming bound"),
                     ("collective", "TP traffic")]:
        rec = _ok_rec()
        rec["analytic"]["bottleneck"] = bn
        assert frag in report._note(rec)
        assert report._note(rec) == ref_report._note(rec)


def test_skips_table_dedupes():
    recs = [_skip_rec(), _skip_rec(), _skip_rec(arch="ssm")]
    md = report.skips_table(recs)
    assert len(md.splitlines()) == 4
    assert "decode shape N/A" in md
    assert md == ref_report.skips_table(recs)


def test_report_cli_renders_records(tmp_path, capsys):
    for i, r in enumerate([_ok_rec(), _skip_rec(),
                           _ok_rec(mesh="2x16x16")]):
        (tmp_path / f"r{i}.json").write_text(json.dumps(r))
    report.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "2 ok, 1 documented skips, 0 errors" in out
    assert "### Dry-run mesh 2x16x16 (traced, rank 0)" in out
    assert "**compute**" in out


# ---------------------------------------------------------------------------
# the example
# ---------------------------------------------------------------------------


def test_example_prints_the_h100_terms():
    """``examples/torch_dryrun_roofline.py`` at a 2-layer override."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_dryrun_roofline.py"),
         "--arch", "gemma3_4b", "--shape", "long_500k", "--set",
         "n_layers=2"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "(H100 constants)" in out.stdout
    for term in ("t_compute", "t_memory", "t_collective", "bottleneck",
                 "traced per rank: peak"):
        assert term in out.stdout
