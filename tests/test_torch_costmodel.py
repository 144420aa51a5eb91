"""The port's cost model, plan cache, costed Planner and kernel autotuner
against the JAX package's.

All of them live in ``repro.exec``, which cannot be imported where
``jax.sharding`` lacks ``TransferToMemoryKind``: one child process installs
a stand-in for it and answers ``QUERIES`` with the reference; this process
answers the same script with the port.  Integers and strings must be
equal, floats equal to 1e-6 relative.  The reference's names
(``pallas``/``lax``, ``overlap_pallas``, ...) are mapped to the port's
before comparing, and the kernels' memory pricing extras (VMEM there,
shared memory here) are left out of the comparison.
"""

import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import obs
from repro_torch.exec import (
    CostTable, ExecutionPlan, PlanRequest, Planner,
    ResidencySpec, cached_plan, plan_cache_key, trunk_fwd_flops,
)
from repro_torch.exec.costmodel import (
    audit_ratio_key, hardware_fingerprint, load_or_calibrate,
    register_cost_table, resolve_cost_table,
)
from repro_torch.exec.plancache import PlanCache

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: one query script, run here against the port and in the child against
#: the reference; ``ns`` supplies each package's names and the trunks
QUERIES = r'''
import dataclasses
import json

TABLE = {"schema": 1, "fingerprint": "test:fixed:x1", "dtype": "float32",
         "flops_per_s": 2.5e13, "h2d_bytes_per_s": 2.0e10,
         "d2h_bytes_per_s": 1.5e10, "row_overhead_us": 35.0,
         "ratios": [["train_step/twophase_h/host,prefetch=1/-", 1.3]],
         "sources": ["calibrate"]}
AUDIT = [
    {"source": "train_step", "engine": "base", "residency": "device",
     "cache_kind": "", "ratio": 1.33},
    {"source": "train_step", "engine": "base", "residency": "device",
     "cache_kind": "", "ratio": 1.25},
    {"source": "train_step", "engine": "base", "residency": "device",
     "cache_kind": "", "ratio": 1.5},
    {"source": "train_step", "engine": "twophase", "residency": "host",
     "cache_kind": "", "ratio": 2.0},
    {"source": "train_step_lm", "engine": "x", "ratio": None},
]


def run(ns):
    Planner, CostTable = ns["Planner"], ns["CostTable"]
    ResidencySpec, PlanRequest = ns["ResidencySpec"], ns["PlanRequest"]
    obs = ns["obs"]
    res = {"none": None, "host": ResidencySpec("host"),
           "host2": ResidencySpec("host", prefetch_depth=2),
           "recompute": ResidencySpec("recompute"),
           "mixed": ResidencySpec("host", placements=(("sd_l1",
                                                       "recompute"),))}
    engines = ("base", "ckp", "overlap", "twophase", "overlap_h",
               "twophase_h")
    table = CostTable.from_dict(TABLE)
    seeded = table.seed_from_audit(AUDIT)
    out = {"version": table.version(), "table": table.to_dict(),
           "seeded": seeded.to_dict(), "seeded_version": seeded.version(),
           "reseeded": seeded.seed_from_audit(AUDIT[3:]).to_dict(),
           "ratio_key": ns["audit_ratio_key"]("train_step", "base", "",
                                              ""),
           "step_us": [table.predict_step_us(1e12, 1e8, 2e8, 4, key)
                       for key in ("", TABLE["ratios"][0][0], "missing")],
           "compute_copy": [table.compute_us(5e12), table.copy_us(1e9, 0),
                            table.copy_us(0, 1e9),
                            CostTable(fingerprint="z").compute_us(1.0)]}

    def guard(fn):
        try:
            v = fn()
        except ValueError:
            return "ValueError"
        return v.to_dict() if hasattr(v, "to_dict") else v

    for name, (mods, shape, batch, xi, full) in ns["trunks"].items():
        pl = Planner(mods, shape, batch, xi=xi)
        out[name + "|flops"] = ns["trunk_fwd_flops"](mods, shape, batch)
        for engine in engines + ("KERNEL",):
            for rk, r in res.items():
                for n in ((1, 2, 3, 8) if not full else (1, 8)):
                    def pred():
                        p = pl.plan("overlap" if engine == "KERNEL"
                                    else engine, n, residency=r)
                        if engine == "KERNEL":
                            p = dataclasses.replace(
                                p, engine=ns["OVERLAP_KERNEL"])
                        return pl.predict_plan_us(p, seeded)
                    out[f"{name}|pred|{engine}|{n}|{rk}"] = guard(pred)
        base = pl.estimate("base", 1)
        fracs = (0.26,) if full else (0.2, 0.35, 0.6, 1.2)
        for f in fracs:
            b = int(base * f)
            for rk in ("none", "host"):
                out[f"{name}|costed|{f}|{rk}"] = guard(
                    lambda: Planner.for_budget(mods, shape, batch, b, xi=xi,
                                               residency=res[rk],
                                               cost_table=seeded))
            out[f"{name}|costed_resolve|{f}"] = guard(
                lambda: Planner(mods, shape, batch, xi=xi,
                                cost_table=seeded).resolve(
                                    PlanRequest(budget_gb=b / 2**30)))
        with obs.capture() as s:
            guard(lambda: Planner.for_budget(mods, shape, batch,
                                             int(base * 0.6), xi=xi,
                                             cost_table=table))
            pl.resolve(PlanRequest(engine="twophase_h", n_rows=2))
            pl.resolve(PlanRequest(budget_gb=base * 0.6 / 2**30))
        out[name + "|solves"] = s.metrics.to_dict()["counters"]

    # the plan cache: keys, then miss / hit / stale miss with counters
    fields = [dict(mode="cnn", arch="vgg16", batch=32, budget_gb=1.0,
                   mesh="", residency="", kernel="", n_segments=None),
              dict(batch=32, arch="vgg16", mode="cnn", budget_gb=1.0,
                   mesh="", residency="", kernel="", n_segments=None),
              dict(mode="lm", arch="gemma3_4b", seq=4096, shape=(1, 2),
                   fingerprint="cuda:H100:x1")]
    out["keys"] = [ns["plan_cache_key"](**f) for f in fields]
    base_plan = Planner(*list(ns["trunks"].values())[0][:3]).plan("base")
    calls = []

    def solve():
        calls.append(1)
        return base_plan

    with obs.capture() as s:
        got = []
        for version in ("v1", "v1", "v2", "v2"):
            plan, hit, key = ns["cached_plan"](ns["tmp"], fields[0], solve,
                                               cost_version=version)
            got.append([plan.to_dict(), hit, key])
    out["cache"] = {"got": got, "solves": len(calls),
                    "records": s.tracer.records[1:],
                    "counters": s.metrics.to_dict()["counters"],
                    "entry": json.load(open(ns["PlanCache"](ns["tmp"]).path(
                        out["keys"][0])))}

    # the autotuner under a deterministic timer
    def tuned(plan, pl):
        timed = []

        def timer(c):
            k = c.kernel
            timed.append([k.block_h, k.bq, k.bk, k.chunk])
            return 40.0 + (k.block_h * 7 + k.bq * 3 + k.bk + k.chunk * 5) \
                % 11 + 0.25
        p = pl.autotune_kernel(plan, time_fn=timer)
        return {"plan": p.to_dict(), "timed": timed}

    mods, shape, batch, xi, _ = ns["trunks"]["vgg_reduced"]
    pl = Planner(mods, shape, batch, xi=xi)
    out["tune|conv"] = tuned(pl.plan("overlap", 2), pl)
    out["tune|conv_base"] = tuned(pl.plan("base", 1), pl)
    out["tune|conv_noshape"] = tuned(
        dataclasses.replace(pl.plan("overlap", 2), in_shape=None), pl)
    out["tune|twophase"] = tuned(pl.plan("twophase", 2), pl)
    explicit = ns["ExecutionPlan"].explicit
    for seq in (256, 96):
        out[f"tune|swa|{seq}"] = tuned(explicit(
            "seq_swa_overlap", 4, seq=seq, head_dim=64, window=64), pl)
        out[f"tune|ssd|{seq}"] = tuned(explicit(ns["SSD_KERNEL"], 1,
                                                seq=seq), pl)
    out["tune|swa_noseq"] = tuned(explicit("seq_swa_overlap", 4), pl)
    return out
'''

CHILD_XLA_FLAGS = ("--xla_cpu_multi_thread_eigen=false "
                   "intra_op_parallelism_threads=1")

CHILD = r'''
import json, sys
import jax, jax.memory, jax.sharding
import numpy as np
if not hasattr(jax.sharding, "TransferToMemoryKind"):
    # JAX 0.9 dropped the name repro.exec.rowprog imports; this process only
    jax.sharding.TransferToMemoryKind = lambda kind: (
        jax.memory.Space.Host if "host" in kind else jax.memory.Space.Device)
from repro import obs
from repro.exec import (CostTable, ExecutionPlan, PlanCache, PlanRequest,
                        Planner, ResidencySpec, cached_plan, plan_cache_key,
                        trunk_fwd_flops)
from repro.exec.costmodel import audit_ratio_key
from repro.models.cnn import resnet, vgg

def n_params(init, key):
    tree = jax.eval_shape(lambda k: init(k)[1], key)
    return sum(int(np.prod(l.shape)) for l in jax.tree.leaves(tree))

full = (224, 224, 3)
trunks = {
    "vgg_reduced": (vgg.vgg16_modules(0.125), (64, 64, 3), 2, 1000, False),
    "resnet_reduced": (resnet.resnet50_modules(0.125, [1, 1, 1, 1]),
                       (64, 64, 3), 2, 1000, False),
    "vgg_full": (vgg.vgg16_modules(1.0), full, 32, 12 * n_params(
        lambda k: vgg.init_vgg16(k, full), jax.random.PRNGKey(0)), True),
}
ns = dict(Planner=Planner, CostTable=CostTable, ResidencySpec=ResidencySpec,
          PlanRequest=PlanRequest, ExecutionPlan=ExecutionPlan,
          PlanCache=PlanCache, cached_plan=cached_plan,
          plan_cache_key=plan_cache_key, trunk_fwd_flops=trunk_fwd_flops,
          audit_ratio_key=audit_ratio_key, obs=obs, trunks=trunks,
          OVERLAP_KERNEL="overlap_pallas", SSD_KERNEL="seq_ssd_pallas",
          tmp=sys.argv[2])
exec(open(sys.argv[1]).read(), ns)
json.dump(ns["run"](ns), open(sys.argv[3], "w"))
'''

#: pricing extras of the two backends' memory models (VMEM / shared
#: memory): different quantities by design, left out of the comparison
PRICING_EXTRAS = ("kernel_vmem_bytes", "kernel_smem_bytes")


def _normalize(x, key=""):
    """Reference names as the port spells them; the kernels' memory
    pricing and the reference-only ``interpret`` field dropped."""
    if isinstance(x, str):
        return x.replace("pallas", "cuda")
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            if k in PRICING_EXTRAS or (key == "kernel" and k == "interpret"):
                continue
            if key == "kernel" and k == "backend":
                v = {"lax": "plain"}.get(v, v)
            out[k] = _normalize(v, k)
        return out
    if isinstance(x, (list, tuple)):
        return [_normalize(v, key) for v in x]
    return x


def _close(a, b, path=""):
    """Equal, floats to 1e-6 relative; returns the first difference."""
    if isinstance(a, float) or isinstance(b, float):
        if isinstance(a, (int, float)) and isinstance(b, (int, float)) \
                and math.isclose(a, b, rel_tol=1e-6, abs_tol=1e-9):
            return None
        return (path, a, b)
    if isinstance(a, dict) and isinstance(b, dict):
        if sorted(a) != sorted(b):
            return (path, sorted(a), sorted(b))
        for k in a:
            d = _close(a[k], b[k], f"{path}.{k}")
            if d:
                return d
        return None
    if isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            return (path, a, b)
        for i, (u, v) in enumerate(zip(a, b)):
            d = _close(u, v, f"{path}[{i}]")
            if d:
                return d
        return None
    return None if a == b else (path, a, b)


def _port_trunks():
    from repro_torch.models.cnn import resnet, vgg
    from repro_torch.optim.adamw import tree_leaves
    full = (224, 224, 3)
    _, p = vgg.init_vgg16(torch.Generator().manual_seed(0), full,
                          device="meta")
    return {
        "vgg_reduced": (vgg.vgg16_modules(0.125), (64, 64, 3), 2, 1000,
                        False),
        "resnet_reduced": (resnet.resnet50_modules(0.125, [1, 1, 1, 1]),
                           (64, 64, 3), 2, 1000, False),
        "vgg_full": (vgg.vgg16_modules(1.0), full, 32,
                     12 * sum(t.numel() for t in tree_leaves(p)), True),
    }


@pytest.fixture(scope="module")
def answers(tmp_path_factory):
    """(reference, port) answers to ``QUERIES``, normalised."""
    d = tmp_path_factory.mktemp("ref_costmodel")
    (d / "queries.py").write_text(QUERIES)
    (d / "ref_cache").mkdir()
    child = subprocess.Popen(
        [sys.executable, "-c", CHILD, str(d / "queries.py"),
         str(d / "ref_cache"), str(d / "ref.json")], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 JAX_PLATFORMS="cpu", XLA_FLAGS=CHILD_XLA_FLAGS),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:  # the port answers while the child works
        ns = dict(Planner=Planner, CostTable=CostTable,
                  ResidencySpec=ResidencySpec, PlanRequest=PlanRequest,
                  ExecutionPlan=ExecutionPlan, PlanCache=PlanCache,
                  cached_plan=cached_plan, plan_cache_key=plan_cache_key,
                  trunk_fwd_flops=trunk_fwd_flops,
                  audit_ratio_key=audit_ratio_key, obs=obs,
                  trunks=_port_trunks(), OVERLAP_KERNEL="overlap_cuda",
                  SSD_KERNEL="seq_ssd_cuda", tmp=str(d / "port_cache"))
        exec(QUERIES, ns)
        port = json.loads(json.dumps(ns["run"](ns)))
        _, err = child.communicate(timeout=600)
    finally:
        child.kill()
        child.wait()
    assert child.returncode == 0, err[-4000:]
    return _normalize(json.load(open(d / "ref.json"))), _normalize(port)


KINDS = ["version", "table", "seeded", "seeded_version", "reseeded",
         "ratio_key", "step_us", "compute_copy", "flops", "pred", "costed",
         "costed_resolve", "solves", "keys", "cache", "tune"]


def _kind(key):
    return key.split("|")[1] if "|" in key and key.split("|")[0] not in (
        "tune",) else key.split("|")[0]


@pytest.mark.parametrize("kind", KINDS)
def test_answers_equal_reference(answers, kind):
    """Equal wherever the reference answers.  Where it raises because an
    OverL-H or 2PS-H candidate asks its halo or SD term for more rows than
    the trunk's last level has, the port answers
    (``Planner.predict_plan_us``); those keys are pinned by
    ``test_hybrid_terms_are_priced_at_the_last_level`` and counted
    here."""
    ref, port = answers
    keys = sorted(k for k in ref if _kind(k) == kind)
    assert keys and keys == sorted(k for k in port if _kind(k) == kind)
    diverge = [k for k in keys
               if ref[k] == "ValueError" and port[k] != "ValueError"]
    bad = [(k, _close(ref[k], port[k])) for k in keys
           if k not in diverge and _close(ref[k], port[k])]
    assert not bad, bad[:3]
    assert all(isinstance(port[k], dict) for k in diverge)
    if kind == "pred":
        # exactly the overlap_h predictions past the last level's rows
        assert diverge and all("|overlap_h|" in k or "|twophase_h|" in k
                               for k in diverge), diverge


@pytest.mark.parametrize("engine,residency", [("overlap_h", None),
                                              ("twophase_h", "host")])
def test_hybrid_terms_are_priced_at_the_last_level(engine, residency):
    """An OverL-H or 2PS-H plan asking for more rows than the trunk's last
    level has is priced as the split the trunk can make (the reference
    raises there): the halo's FLOPs, the SD volume's copies."""
    mods, shape, batch, xi, _ = _port_trunks()["vgg_reduced"]
    pl = Planner(mods, shape, batch, xi=xi)
    table = CostTable(fingerprint="t", flops_per_s=1e12,
                      h2d_bytes_per_s=1e9, d2h_bytes_per_s=1e9)
    h_last = 2  # 64² after five pools
    plan = pl.plan(engine, 8, residency=residency and ResidencySpec.parse(
        residency))
    over = pl.predict_plan_us(plan, table)
    at_cap = pl.predict_plan_us(dataclasses.replace(plan, n_rows=h_last),
                                table)
    assert (over["flops"], over["copy_bytes"]) \
        == (at_cap["flops"], at_cap["copy_bytes"])
    assert over["flops"] > 4 * trunk_fwd_flops(mods, shape, batch) \
        if engine == "overlap_h" else over["copy_bytes"] > 0


def test_answers_exercise_each_path(answers):
    """The compared answers cover what they claim to: offloaded and
    device-only picks under the costed chooser, a hit that solves
    nothing, a stale miss, and a timed winner for each kernel."""
    _, port = answers
    costed = [v for k, v in port.items() if "|costed|" in k
              and isinstance(v, dict)]
    assert any("predicted_step_us" in p["extras"] for p in costed)
    assert any(p["residency"] and p["residency"]["default"] != "device"
               for p in costed)
    assert any(p["residency"] is None for p in costed)
    cache = port["cache"]
    assert [g[1] for g in cache["got"]] == [False, True, False, True]
    assert cache["solves"] == 2
    assert cache["counters"] == {"plancache.hit": 2, "plancache.miss": 2,
                                 "plancache.stale": 1,
                                 "plancache.store": 2}
    assert port["keys"][0] == port["keys"][1] != port["keys"][2]
    for kind in ("conv", "swa|256", "ssd|256"):
        p = port[f"tune|{kind}"]["plan"]
        assert p["engine"].endswith("_cuda") and "autotune" in p["extras"]
        assert port[f"tune|{kind}"]["timed"]
    assert "kernel_fallback" in port["tune|twophase"]["plan"]["extras"]
    assert port["vgg_reduced|solves"] == {"planner.solves": 4}


def test_table_round_trip_and_registry(tmp_path, monkeypatch):
    t = CostTable(fingerprint="cuda:NVIDIA_H100:x1", flops_per_s=1e13,
                  ratios=(("b", 2.0), ("a", 1.0)), sources=("calibrate",))
    assert t.ratios == (("a", 1.0), ("b", 2.0))
    path = t.save(str(tmp_path / "t.json"))
    assert CostTable.load(path) == t and CostTable.load(path).version() \
        == t.version()
    with pytest.raises(ValueError, match="schema"):
        CostTable.from_dict({"schema": 0, "fingerprint": "x"})
    assert hardware_fingerprint() == ("cpu:cpu:x1"
                                      if not torch.cuda.is_available()
                                      else hardware_fingerprint())
    mine = CostTable(fingerprint="test:registered:x1", flops_per_s=1.0)
    monkeypatch.setattr("repro_torch.exec.costmodel._COST_TABLES", {})
    assert resolve_cost_table("test:registered:x1") is None
    register_cost_table(mine)
    assert resolve_cost_table("test:registered:x1") is mine


def test_load_or_calibrate_persists_and_reloads(tmp_path, monkeypatch):
    monkeypatch.setattr("repro_torch.exec.costmodel._COST_TABLES", {})
    first = load_or_calibrate(str(tmp_path))
    assert first.sources == ("calibrate",)
    assert first.fingerprint == hardware_fingerprint()
    for f in ("flops_per_s", "h2d_bytes_per_s", "d2h_bytes_per_s",
              "row_overhead_us"):
        v = getattr(first, f)
        assert math.isfinite(v) and v > 0, f
    again = load_or_calibrate(str(tmp_path))
    assert again == first  # loaded, not re-measured
    (tmp_path / "cost_table.json").write_text('{"schema": 0}')
    assert load_or_calibrate(str(tmp_path)).fingerprint \
        == hardware_fingerprint()  # a stale file recalibrates


def test_calibrate_sizes_on_cpu():
    t = CostTable.calibrate(matmul_dim=32, copy_bytes=4096, iters=1,
                            device="cpu")
    assert t.flops_per_s > 0 and t.h2d_bytes_per_s > 0
    assert t.dtype == "float32" and t.sources == ("calibrate",)


def test_plan_cache_entry_replays_bit_identically(tmp_path):
    plan = Planner.for_budget(*_port_trunks()["vgg_reduced"][:3],
                              2**22, xi=1000)
    cache = PlanCache(str(tmp_path))
    cache.store("k", plan, "v")
    first = (tmp_path / "plan_k.json").read_bytes()
    cache.store("k", plan, "v")
    assert (tmp_path / "plan_k.json").read_bytes() == first
    assert cache.lookup("k", "v") == plan
    assert cache.lookup("k", "other") is None
    (tmp_path / "plan_k.json").write_text("{not json")
    assert cache.lookup("k", "v") is None


def test_trainer_plan_cache_hit_skips_the_solve(tmp_path, capsys):
    from repro_torch.launch import train as T
    argv = ["--arch", "vgg16", "--preset", "reduced", "--budget-gb",
            "0.004", "--steps", "1", "--device", "cpu", "--plan-cache",
            str(tmp_path / "pc"), "--out", str(tmp_path / "o")]
    metrics = []
    for i in range(2):
        metrics.append(str(tmp_path / f"m{i}.json"))
        T.main(argv + ["--metrics-out", metrics[-1]])
    out = capsys.readouterr().out
    assert out.count("plan cache: miss") == 1
    assert out.count("plan cache: hit") == 1
    c0, c1 = (json.load(open(m))["counters"] for m in metrics)
    assert c0["plancache.miss"] == 1 and c0["planner.solves"] >= 1
    assert c1["plancache.hit"] == 1 and "planner.solves" not in c1
    plans = [json.load(open(tmp_path / "o" / "train_log.json"))["plan"]]
    assert "cost_table_version" in plans[0]["extras"]


def _pretend_card(monkeypatch):
    """Make the process look as if it had one H100 (nothing launches)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)


def test_fingerprint_and_cost_table_follow_the_device(tmp_path,
                                                      monkeypatch):
    """On a machine with a card, a run on the CPU is priced and keyed by
    CPU measurements, not the card's."""
    _pretend_card(monkeypatch)
    monkeypatch.setattr("repro_torch.exec.costmodel._COST_TABLES", {})
    assert hardware_fingerprint() == "cuda:NVIDIA_H100_80GB_HBM3:x1"
    assert hardware_fingerprint("cuda") == hardware_fingerprint()
    assert hardware_fingerprint("cpu") == "cpu:cpu:x1"
    assert hardware_fingerprint(torch.device("cpu")) == "cpu:cpu:x1"
    t = load_or_calibrate(str(tmp_path), device="cpu")
    assert t.fingerprint == "cpu:cpu:x1" and t.sources == ("calibrate",)
    assert load_or_calibrate(str(tmp_path), device="cpu") == t


def test_trainer_on_the_cpu_keys_its_plan_cache_by_the_cpu(tmp_path,
                                                           monkeypatch,
                                                           capsys):
    from repro_torch.launch import train as T
    _pretend_card(monkeypatch)
    monkeypatch.setattr("repro_torch.exec.costmodel._COST_TABLES", {})
    T.main(["--arch", "vgg16", "--preset", "reduced", "--budget-gb",
            "0.004", "--steps", "1", "--device", "cpu", "--plan-cache",
            str(tmp_path / "pc"), "--out", str(tmp_path / "o")])
    assert "plan cache: miss" in capsys.readouterr().out
    table = CostTable.load(str(tmp_path / "pc" / "cost_table.json"))
    assert table.fingerprint == "cpu:cpu:x1"
    entries = [json.load(open(p)) for p in (tmp_path / "pc").glob(
        "plan_*.json")]
    assert len(entries) == 1
    assert entries[0]["meta"]["fingerprint"] == "cpu:cpu:x1"


def test_default_kernel_timer_needs_a_card(monkeypatch):
    """The default timer times the CUDA kernels: without a card
    ``autotune_kernel`` raises instead of choosing a tile from the plain
    versions' CPU times; a caller's ``time_fn`` still tunes."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mods, shape, batch, xi, _ = _port_trunks()["vgg_reduced"]
    pl = Planner(mods, shape, batch, xi=xi)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        pl.autotune_kernel(pl.plan("overlap", 2))
    tuned = pl.autotune_kernel(pl.plan("overlap", 2), time_fn=lambda c: 1.0)
    assert tuned.engine == "overlap_cuda" and tuned.get("autotune_us") == 1.0
