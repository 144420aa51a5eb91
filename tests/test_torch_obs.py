"""The port's observability layer against the JAX package's.

``repro.obs`` (metrics, trace, the session, the CLI wiring and the step
log) imports nothing of ``repro.exec``, so it is compared in this process.
The row executor's records come from ``repro.exec``, which cannot be
imported where ``jax.sharding`` lacks ``TransferToMemoryKind``: one child
process installs a stand-in for it and traces the reference.  Records and
dumps must be equal; tracing must change no value a step computes.
"""

import contextlib
import json
import os
import pathlib
import subprocess
import sys
import types

import pytest
import torch

from repro import obs as ref_obs
from repro.obs import cli as ref_cli
from repro.obs import steplog as ref_steplog
from repro.obs.metrics import MetricsRegistry as RefRegistry
from repro.obs.trace import Tracer as RefTracer
from repro.obs.trace import read_jsonl as ref_read_jsonl
from repro_torch import obs
from repro_torch.obs import cli
from repro_torch.obs import steplog
from repro_torch.obs.audit import measure_step
from repro_torch.obs.metrics import (METRICS_SCHEMA, NULL_METRIC,
                                     MetricsRegistry, merge_counts)
from repro_torch.obs.trace import TRACE_SCHEMA, Tracer, read_jsonl

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _metric_calls(reg, merge):
    reg.counter("rows").inc()
    reg.counter("rows").inc(2)
    reg.gauge("bytes").set(128)
    reg.gauge("ratio").set(1.25)
    for v in (3.0, 1.0, 7.5, 2.0, 9.0, 4.0, 0.5):
        reg.histogram("lat").observe(v)
    reg.histogram("empty")
    merge(reg, {"admit": 3, "rows": 4})
    merge(reg, None)


def test_metrics_dump_equals_reference(tmp_path):
    from repro.obs.metrics import merge_counts as ref_merge
    ref, port = RefRegistry(), MetricsRegistry()
    _metric_calls(ref, ref_merge)
    _metric_calls(port, merge_counts)
    assert port.to_dict() == ref.to_dict()
    ref.dump(str(tmp_path / "r" / "m.json"))
    port.dump(str(tmp_path / "p" / "m.json"))
    assert (tmp_path / "p" / "m.json").read_bytes() \
        == (tmp_path / "r" / "m.json").read_bytes()
    assert MetricsRegistry.load(str(tmp_path / "p" / "m.json")) \
        == RefRegistry.load(str(tmp_path / "r" / "m.json"))
    assert METRICS_SCHEMA == 1


@pytest.mark.parametrize("loader", ["port", "reference"])
def test_metrics_load_rejects_other_schema(tmp_path, loader):
    path = tmp_path / "m.json"
    path.write_text(json.dumps({"schema": 99}))
    load = MetricsRegistry.load if loader == "port" else RefRegistry.load
    with pytest.raises(ValueError, match="schema 99"):
        load(str(path))


def _trace_calls(tr):
    tr.span("fp_row", tick=0, n_rows=3, carry_bytes=0)
    tr.event("offload", tick=2.0, bytes=4096)
    tr.emit("plan_audit", "train_step", engine="base", ratio=1.5)
    tr.event("arrive", tick=1.25)
    tr.span("decode", tick=None)
    tr.emit("span", "x", tick=3, nested={"a": [1, 2]})


def test_trace_file_equals_reference(tmp_path):
    meta = {"arch": "vgg16", "engine": "twophase_h", "tool": "train"}
    ref = RefTracer(str(tmp_path / "r" / "t.jsonl"), meta=meta)
    port = Tracer(str(tmp_path / "p" / "t.jsonl"), meta=meta)
    for tr in (ref, port):
        _trace_calls(tr)
        tr.flush()
        tr.close()
    assert port.records == ref.records
    assert (tmp_path / "p" / "t.jsonl").read_bytes() \
        == (tmp_path / "r" / "t.jsonl").read_bytes()
    assert read_jsonl(str(tmp_path / "p" / "t.jsonl")) \
        == ref_read_jsonl(str(tmp_path / "r" / "t.jsonl"))
    assert TRACE_SCHEMA == 1


@pytest.mark.parametrize("content,match", [
    ('{"kind": "span", "name": "x"}\n', "no header"),
    ('{"kind": "header", "schema": 7}\n', "schema 7"),
    ("", "no header"),
])
def test_read_jsonl_rejects_like_reference(tmp_path, content, match):
    path = tmp_path / "t.jsonl"
    path.write_text(content)
    for reader in (read_jsonl, ref_read_jsonl):
        with pytest.raises(ValueError, match=match):
            reader(str(path))


def _session_calls(o):
    o.span("fp_row", tick=0, n_rows=2)
    o.event("prefetch", tick=1, row=0, depth=1, bytes=64)
    o.emit("plan_audit", "train_step", ratio=2.0)
    o.counter("rowprog.fp_rows").inc()
    o.counter("rowprog.fp_rows").inc(3)
    o.gauge("audit.train_step.ratio").set(2.0)
    o.histogram("train.loss").observe(1.5)


def test_session_equals_reference(tmp_path):
    meta = {"tool": "train", "arch": "vgg16"}
    out = {}
    for name, o in (("ref", ref_obs), ("port", obs)):
        path = tmp_path / name
        with o.capture(trace=str(path / "t.jsonl"),
                       metrics=str(path / "m.json"), meta=meta) as s:
            assert o.enabled() and o.session() is s
            _session_calls(o)
            out[name] = (s.tracer.records, s.metrics.to_dict())
        assert not o.enabled()
    assert out["port"] == out["ref"]
    for f in ("t.jsonl", "m.json"):
        assert (tmp_path / "port" / f).read_bytes() \
            == (tmp_path / "ref" / f).read_bytes()


def test_disabled_session_is_a_no_op():
    assert not obs.enabled() and obs.session() is None
    assert obs.counter("a") is NULL_METRIC
    assert obs.gauge("a") is NULL_METRIC
    assert obs.histogram("a") is NULL_METRIC
    obs.counter("a").inc()
    obs.gauge("a").set(1)
    obs.histogram("a").observe(1)
    obs.emit("span", "x", tick=0)  # nothing to write to


def test_configure_replaces_and_shutdown_writes(tmp_path):
    first = obs.configure(metrics=str(tmp_path / "a.json"))
    obs.counter("c").inc()
    second = obs.configure(metrics=str(tmp_path / "b.json"))
    assert obs.session() is second and second is not first
    assert json.loads((tmp_path / "a.json").read_text())["counters"] \
        == {"c": 1}
    obs.shutdown()
    assert not obs.enabled()
    assert json.loads((tmp_path / "b.json").read_text())["counters"] == {}
    obs.shutdown()  # a second shutdown is a no-op


# ---------------------------------------------------------------------------
# step log
# ---------------------------------------------------------------------------


CNN_RECS = [{"step": 0, "loss": 2.5, "elapsed_s": 0.25},
            {"step": 1, "loss": 1.75, "elapsed_s": 0.5}]
LM_RECS = [{"loss": 6.25, "ce": 6.25, "grad_norm": 2.5, "step": 0,
            "elapsed_s": 1.5}]


@pytest.mark.parametrize("recs", [CNN_RECS, LM_RECS], ids=["cnn", "lm"])
def test_steplog_session_records_equal_reference(recs, capsys):
    out = {}
    for name, o, mod in (("ref", ref_obs, ref_steplog),
                         ("port", obs, steplog)):
        with o.capture(meta={"tool": "train"}) as s:
            log = mod.StepLog("train")
            for r in recs:
                log.log(dict(r))
            log.log(dict(recs[0]), echo=False)
            out[name] = (s.tracer.records, s.metrics.to_dict(),
                         log.records, capsys.readouterr().out)
    assert out["port"] == out["ref"]
    assert out["port"][3].count("\n") == len(recs)


def test_steplog_prefix_names_span_and_metrics():
    with obs.capture() as s:
        steplog.StepLog("serve").log({"step": 3, "loss": 1.0,
                                      "elapsed_s": 0.1, "tag": "x"},
                                     echo=False)
    assert s.tracer.records[1] == {"kind": "span", "name": "serve_step",
                                   "tick": 3, "attrs": {"loss": 1.0,
                                                        "elapsed_s": 0.1,
                                                        "tag": "x"}}
    d = s.metrics.to_dict()
    assert d["counters"] == {"serve.steps_logged": 1}
    assert sorted(d["histograms"]) == ["serve.elapsed_s", "serve.loss"]


def test_steplog_dump_and_load_round_trip(tmp_path):
    log = steplog.StepLog()
    for r in CNN_RECS:
        log.log(dict(r), echo=False)
    log.dump(str(tmp_path / "log.json"), arch="vgg16", mode="cnn",
             plan=None, plan_audit={"ratio": 1.5})
    d = json.loads((tmp_path / "log.json").read_text())
    assert d["schema"] == steplog.STEPLOG_SCHEMA == 1
    assert d["plan_audit"] == {"ratio": 1.5}
    assert steplog.load_steps(str(tmp_path / "log.json")) == CNN_RECS
    assert ref_steplog.load_steps(str(tmp_path / "log.json")) == CNN_RECS
    (tmp_path / "bare.json").write_text(json.dumps(CNN_RECS))
    assert steplog.load_steps(str(tmp_path / "bare.json")) == CNN_RECS
    (tmp_path / "bad.json").write_text(json.dumps({"schema": 2,
                                                   "steps": []}))
    with pytest.raises(ValueError, match="schema 2"):
        steplog.load_steps(str(tmp_path / "bad.json"))


# ---------------------------------------------------------------------------
# CLI wiring
# ---------------------------------------------------------------------------


def test_cli_flags_and_configure(tmp_path):
    import argparse
    ap = argparse.ArgumentParser()
    cli.add_obs_args(ap)
    args = ap.parse_args([])
    assert (args.trace, args.metrics_out, args.torch_profile) == ("", "",
                                                                  "")
    assert not cli.configure_from_args(args)
    rap = argparse.ArgumentParser()
    ref_cli.add_obs_args(rap)
    ref_flags = {a.dest for a in rap._actions} - {"help"}
    assert {a.dest for a in ap._actions} - {"help"} \
        == ref_flags - {"jax_profile"} | {"torch_profile"}
    args = ap.parse_args(["--trace", str(tmp_path / "t.jsonl")])
    try:
        assert cli.configure_from_args(args, tool="train", arch="vgg16")
        assert obs.session().tracer.records[0] == {
            "schema": 1, "kind": "header", "tool": "train",
            "arch": "vgg16"}
    finally:
        obs.shutdown()


@pytest.mark.parametrize("session", [False, True])
def test_profiled_exports_only_inside_a_session(tmp_path, session):
    args = types.SimpleNamespace(torch_profile=str(tmp_path / "prof"))
    if session:
        obs.configure()
    try:
        with cli.profiled(args):
            torch.ones(4).add_(1)
    finally:
        obs.shutdown()
    exported = tmp_path / "prof" / "trace.json"
    assert exported.exists() == session
    if session:
        assert "traceEvents" in json.loads(exported.read_text())


def test_profile_range_only_while_profiling(tmp_path):
    """A session alone opens no profiler range (a traced run pays nothing
    for them); inside ``profiled`` the range is named in the Chrome
    trace."""
    args = types.SimpleNamespace(torch_profile=str(tmp_path / "prof"))
    obs.configure()
    try:
        assert isinstance(obs.profile_range("r"), contextlib.nullcontext)
        with cli.profiled(args):
            assert not isinstance(obs.profile_range("r"),
                                  contextlib.nullcontext)
            with obs.profile_range("probe_range"):
                torch.ones(4).add_(1)
        assert isinstance(obs.profile_range("r"), contextlib.nullcontext)
    finally:
        obs.shutdown()
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any(e.get("name") == "probe_range"
               for e in events["traceEvents"])


# ---------------------------------------------------------------------------
# measure_step on the CPU
# ---------------------------------------------------------------------------


def test_measure_step_on_cpu():
    calls = []
    x = torch.ones(8)
    assert measure_step(lambda t: calls.append(t.sum()), x) is None
    assert len(calls) == 1  # the measured call ran once
    m = measure_step(lambda t: calls.append(t.sum()), x, time_iters=3)
    assert m["peak_bytes"] == 0 and m["wall_us"] >= 0.0
    assert "method" not in m
    assert len(calls) == 1 + 1 + 3  # measured call + the timed ones
    held = []
    assert measure_step(lambda: held.append(1), device="cpu") is None
    assert held == [1]


# ---------------------------------------------------------------------------
# the row executor's records against one trace of the reference
# ---------------------------------------------------------------------------

RESIDENCIES = ["device", "host", "recompute"]
ROWS, IMAGE, BATCH = 3, 64, 2

CHILD_XLA_FLAGS = ("--xla_cpu_multi_thread_eigen=false "
                   "intra_op_parallelism_threads=1")

#: one traced step of the reduced VGG trunk under twophase_h N=3 per
#: residency: the records after the header and the counters
ROWPROG_CHILD = r'''
import json, sys
import jax, jax.numpy as jnp
import jax.memory, jax.sharding
if not hasattr(jax.sharding, "TransferToMemoryKind"):
    # JAX 0.9 dropped the name repro.exec.rowprog imports; this process only
    jax.sharding.TransferToMemoryKind = lambda kind: (
        jax.memory.Space.Host if "host" in kind else jax.memory.Space.Device)
from repro import obs
from repro.exec import Planner, ResidencySpec, build_apply
from repro.models.cnn.layers import init_trunk
from repro.models.cnn.vgg import vgg16_modules

rows, image, batch = (int(a) for a in sys.argv[2:5])
mods = vgg16_modules(0.125)
shape = (image, image, 3)
params, _ = init_trunk(mods, jax.random.PRNGKey(0), shape)
x = jnp.ones((batch,) + shape, jnp.float32)
out = {}
for policy in ("device", "host", "recompute"):
    plan = Planner(mods, shape, batch).plan(
        "twophase_h", rows, residency=ResidencySpec(default=policy))
    apply = build_apply(mods, plan)
    with obs.capture(meta={"policy": policy}) as s:
        jax.block_until_ready(jax.jit(jax.value_and_grad(
            lambda p, xx: jnp.sum(apply(p, xx))))(params, x))
    out[policy] = {"records": s.tracer.records[1:],
                   "counters": s.metrics.to_dict()["counters"],
                   "segments": [list(t) for t in plan.segments]}
json.dump(out, open(sys.argv[1], "w"))
'''


@pytest.fixture(scope="module")
def ref_rowprog(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_obs")
    r = subprocess.run(
        [sys.executable, "-c", ROWPROG_CHILD, str(d / "out.json"),
         str(ROWS), str(IMAGE), str(BATCH)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 JAX_PLATFORMS="cpu", XLA_FLAGS=CHILD_XLA_FLAGS),
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads((d / "out.json").read_text())


def _port_trunk():
    from repro_torch.models.cnn.layers import init_trunk
    from repro_torch.models.cnn.vgg import vgg16_modules
    mods = vgg16_modules(0.125)
    params, _ = init_trunk(mods, torch.Generator().manual_seed(0),
                           (IMAGE, IMAGE, 3), device="cpu")
    return mods, params


def _port_step(mods, params, policy):
    """Loss and gradients of one step of the trunk's sum; the plan."""
    from repro_torch.exec import Planner, ResidencySpec, build_apply
    from repro_torch.optim.adamw import tree_leaves, tree_map
    plan = Planner(mods, (IMAGE, IMAGE, 3), BATCH).plan(
        "twophase_h", ROWS, residency=ResidencySpec(default=policy))
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = tree_leaves(p)
    x = torch.ones((BATCH, IMAGE, IMAGE, 3))
    loss = build_apply(mods, plan)(p, x).sum()
    return loss, torch.autograd.grad(loss, leaves), plan


@pytest.mark.parametrize("policy", RESIDENCIES)
def test_rowprog_records_equal_reference(ref_rowprog, policy):
    mods, params = _port_trunk()
    with obs.capture(meta={"policy": policy}) as s:
        _, _, plan = _port_step(mods, params, policy)
    ref = ref_rowprog[policy]
    assert [list(t) for t in plan.segments] == ref["segments"]
    assert s.tracer.records[1:] == ref["records"]
    assert s.metrics.to_dict()["counters"] == ref["counters"]
    names = {r["name"] for r in ref["records"]}
    want = {"fp_row", "bp_row"} | {"host": {"offload", "prefetch"},
                                   "recompute": {"drop_recompute",
                                                 "recompute_chain"},
                                   "device": set()}[policy]
    assert names == want


@pytest.mark.parametrize("policy", RESIDENCIES)
def test_tracing_changes_no_value(policy):
    mods, params = _port_trunk()
    loss0, grads0, _ = _port_step(mods, params, policy)
    with obs.capture():
        loss1, grads1, _ = _port_step(mods, params, policy)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(grads0, grads1))


def test_trainer_trace_on_off_bit_identical(tmp_path, monkeypatch):
    """Losses, and the parameters and optimizer state every step returns,
    are bit-identical with tracing on or off."""
    from repro_torch.launch import train as T
    from repro_torch.optim.adamw import tree_leaves
    real, states = T.sgd_update, []

    def update(*args, **kwargs):
        out = real(*args, **kwargs)
        states[-1].append([t.clone() for t in tree_leaves(out[:2])])
        return out

    monkeypatch.setattr(T, "sgd_update", update)
    base = ["--arch", "vgg16", "--preset", "reduced", "--strategy",
            "twophase_h", "--rows", "3", "--residency", "host", "--steps",
            "2", "--device", "cpu", "--log-every", "1"]
    states.append([])
    off = T.main(base + ["--out", str(tmp_path / "off")])
    states.append([])
    on = T.main(base + ["--out", str(tmp_path / "on"), "--trace",
                        str(tmp_path / "t.jsonl"), "--metrics-out",
                        str(tmp_path / "m.json")])
    assert [r["loss"] for r in on] == [r["loss"] for r in off]
    assert len(states[0]) == len(states[1]) == 2
    for a, b in zip(states[0], states[1]):
        assert len(a) == len(b) and all(map(torch.equal, a, b))
    assert not obs.enabled()  # main closed its session
    recs = read_jsonl(str(tmp_path / "t.jsonl"))
    assert recs[0]["tool"] == "train" and recs[0]["arch"] == "vgg16"
    assert sum(r.get("name") == "train_step" for r in recs) == 2
    counters = json.loads((tmp_path / "m.json").read_text())["counters"]
    assert counters["train.steps_logged"] == 2
    assert counters["rowprog.fp_rows"] == counters["rowprog.bp_rows"] > 0
    assert counters["rowprog.offload_bytes"] \
        == counters["rowprog.prefetch_bytes"] > 0
    log = json.loads((tmp_path / "on" / "train_log.json").read_text())
    assert log["plan_audit"] is None  # no memory measurement on the CPU
    # the carries moved are the SD bytes the Planner priced, less the
    # input level's, which each row slices from its segment's input
    sd = log["plan_sd"]
    assert counters["rowprog.offload_bytes"] \
        == 2 * (sd["sd_bytes"] - sd["input_level_bytes"])
    assert sum(log["plan_terms"].values()) \
        == log["plan"]["est_bytes_per_device"]
