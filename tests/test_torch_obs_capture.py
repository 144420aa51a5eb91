"""The obs capture (``obs.profiling``, ``obs.profile_range``): outside one
a range is the shared null context; inside one a 2PS-H VGG step at small
widths records its segments, rows, recomputed rows and SGD update with
their nesting, counts what its plan implies, and computes the same bits
as without it.  On the CPU every device field is None."""

import contextlib
import json
import types

import pytest
import torch

from repro_torch import obs
from repro_torch.exec import Planner, ResidencySpec, build_apply
from repro_torch.models.cnn.layers import init_trunk
from repro_torch.models.cnn.vgg import vgg16_modules
from repro_torch.obs.capture import Capture, Record
from repro_torch.obs.metrics import NULL_METRIC
from repro_torch.optim.adamw import (SGDConfig, sgd_init, sgd_update,
                                     tree_leaves, tree_map)

ROWS, IMAGE, BATCH = 3, 64, 2
RESIDENCIES = ["device", "host", "recompute"]


def _setup(policy="device"):
    mods = vgg16_modules(0.125)
    shape = (IMAGE, IMAGE, 3)
    params, _ = init_trunk(mods, torch.Generator().manual_seed(0), shape,
                           device="cpu")
    plan = Planner(mods, shape, BATCH).plan(
        "twophase_h", ROWS, residency=ResidencySpec(default=policy))
    return mods, params, plan


def _step(mods, params, plan):
    """One SGD step of the trunk's squared mean: loss, gradients and the
    updated parameters and velocity."""
    apply = build_apply(mods, plan)
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    x = torch.randn((BATCH, IMAGE, IMAGE, 3),
                    generator=torch.Generator().manual_seed(1))
    loss = apply(p, x).square().mean()
    grads = torch.autograd.grad(loss, tree_leaves(p))
    it = iter(grads)
    new_p, vel, _ = sgd_update(params, tree_map(lambda _: next(it), p),
                               sgd_init(params), SGDConfig())
    return loss.detach(), grads, tree_leaves(new_p) + tree_leaves(vel)


def test_outside_a_capture_ranges_are_the_null_context():
    assert obs.profile_range("segment", index=0) is obs.NULL_RANGE
    assert isinstance(obs.NULL_RANGE, contextlib.nullcontext)
    assert obs.span("fp_row", tick=0) is obs.NULL_RANGE
    assert not obs.counting() and obs.counter("x") is NULL_METRIC
    with obs.profiling() as cap:
        assert obs.counting()
        rng = obs.profile_range("r")
        assert rng is not obs.NULL_RANGE
        with rng:
            pass
    assert obs.last_capture() is cap
    assert obs.profile_range("r") is obs.NULL_RANGE
    assert [r.name for r in cap.records] == ["r"]


def test_step_records_nesting_and_update_with_no_device_times():
    mods, params, plan = _setup()
    with obs.profiling() as cap:
        _step(mods, params, plan)
    recs = cap.records
    parent = [None if r.parent is None else recs[r.parent].name
              for r in recs]
    pairs = {(r.name, p) for r, p in zip(recs, parent)}
    assert ("fp_row", "segment") in pairs
    assert ("row_recompute", "bp_row") in pairs
    assert ("sgd_update", None) in pairs
    assert ("bp_row", None) in pairs  # the backward runs outside segments
    assert {r.name for r in recs} == {"segment", "fp_row", "bp_row",
                                      "row_recompute", "sgd_update"}
    segments = [r for r in recs if r.name == "segment"]
    assert [(s.attrs["index"], s.attrs["strategy"], s.attrs["n_rows"])
            for s in segments] == [(i, "twophase", n) for i, (_, _, n)
                                   in enumerate(plan.segments)]
    assert [r.attrs["tick"] for r in recs if r.name == "fp_row"] \
        == [t for _, _, n in plan.segments for t in range(n)]
    for r in recs:
        assert r.device_ns is None
        assert r.host_ns[0] <= r.host_ns[1]
        if r.parent is not None:
            a, b = recs[r.parent].host_ns
            assert a <= r.host_ns[0] and r.host_ns[1] <= b
    assert cap.idle_lag_ns is None
    assert cap.device_ms("row_recompute") is None  # no device times


@pytest.mark.parametrize("policy", RESIDENCIES)
def test_capture_counts_what_the_plan_implies(policy):
    mods, params, plan = _setup(policy)
    with obs.capture() as s, obs.profiling() as cap:
        _step(mods, params, plan)
    rows = [n for _, _, n in plan.segments]
    want = {"rowprog.fp_rows": sum(rows), "rowprog.bp_rows": sum(rows)}
    if policy == "host":
        sd = Planner(mods, (IMAGE, IMAGE, 3), BATCH).sd_volume(plan)
        moved = sd["sd_bytes"] - sd["input_level_bytes"]
        want.update({"rowprog.offload_bytes": moved,
                     "rowprog.prefetch_bytes": moved,
                     "rowprog.prefetches": sum(n - 1 for n in rows)})
    if policy == "recompute":
        want["rowprog.recompute_rows"] = sum(n * (n - 1) // 2 for n in rows)
    assert cap.metrics.to_dict()["counters"] == want
    assert s.metrics.to_dict()["counters"] == want  # the session's too
    names = [r.name for r in cap.records]
    chains = sum(n - 1 for n in rows) if policy == "recompute" else 0
    assert names.count("row_recompute") == sum(rows) + chains


@pytest.mark.parametrize("policy", RESIDENCIES)
def test_capture_changes_no_value(policy):
    mods, params, plan = _setup(policy)
    loss0, grads0, state0 = _step(mods, params, plan)
    with obs.profiling():
        loss1, grads1, state1 = _step(mods, params, plan)
    assert torch.equal(loss0, loss1)
    assert all(map(torch.equal, grads0, grads1))
    assert all(map(torch.equal, state0, state1))


def test_counters_count_into_session_and_capture():
    with obs.profiling() as cap:
        obs.counter("a").inc(2)
        with obs.capture() as s:
            obs.counter("a").inc()
            obs.counter("b").inc(3)
    assert cap.count("a") == 3 and cap.count("b") == 3
    assert cap.count("missing") == 0
    assert s.metrics.to_dict()["counters"] == {"a": 1, "b": 3}
    with obs.capture() as s:
        obs.counter("a").inc()
    assert cap.count("a") == 3  # closed: counts no more


def test_span_emits_the_record_and_opens_the_range():
    with obs.capture() as s, obs.profiling() as cap:
        with obs.span("bp_row", tick=2, n_rows=3):
            with obs.profile_range("row_recompute"):
                pass
    assert s.tracer.records[1] == {"kind": "span", "name": "bp_row",
                                   "tick": 2, "attrs": {"n_rows": 3}}
    assert [(r.name, r.parent, r.attrs) for r in cap.records] == [
        ("bp_row", None, {"tick": 2, "n_rows": 3}),
        ("row_recompute", 0, {})]


def test_device_ms_counts_nested_ranges_of_a_name_once():
    cap = Capture()
    cap.records = [
        Record("row_recompute", None, {}, (0, 10), (100, 400)),
        Record("row_recompute", 0, {}, (1, 2), (150, 250)),  # inside it
        Record("bp_row", None, {}, (11, 20), (400, 1_400)),
        Record("row_recompute", 2, {}, (12, 13), (500, 1_000)),
    ]
    assert cap.device_ms("row_recompute") == pytest.approx(800e-6)
    assert cap.device_ms("bp_row") == pytest.approx(1e-3)
    assert cap.device_ms("sgd_update") is None
    cap.records.append(Record("sgd_update", None, {}, (21, 22)))
    assert cap.device_ms("sgd_update") is None  # no device time


def test_ranges_close_when_the_work_raises():
    with obs.profiling() as cap:
        with pytest.raises(ValueError):
            with obs.profile_range("outer"):
                with obs.profile_range("inner"):
                    raise ValueError("boom")
        with obs.profile_range("after"):
            pass
    assert [(r.name, r.parent) for r in cap.records] == [
        ("outer", None), ("inner", 0), ("after", None)]
    assert all(r.host_ns[1] is not None for r in cap.records)


def test_trainer_torch_profile_keeps_the_capture(tmp_path):
    """``--torch-profile`` opens the capture: the program's ranges are in
    both the Chrome trace and ``obs.last_capture()``."""
    from repro_torch.launch import train as T
    T.main(["--arch", "vgg16", "--preset", "reduced", "--strategy",
            "twophase_h", "--rows", "3", "--steps", "1", "--device", "cpu",
            "--out", str(tmp_path / "out"), "--metrics-out",
            str(tmp_path / "m.json"), "--torch-profile",
            str(tmp_path / "prof")])
    cap = obs.last_capture()
    names = {r.name for r in cap.records}
    assert {"segment", "fp_row", "bp_row", "row_recompute", "sgd_update",
            "forward", "backward", "optimizer"} <= names
    opt = next(r for r in cap.records if r.name == "sgd_update")
    assert cap.records[opt.parent].name == "optimizer"
    assert cap.count("rowprog.fp_rows") > 0
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    traced = {e.get("name") for e in events["traceEvents"]}
    assert {"fp_row", "bp_row", "segment", "sgd_update"} <= traced


def test_profiled_on_the_cpu_records_no_device_times(tmp_path):
    """The trainer's capture follows its ``--device``: a CPU run records
    host times only, on any machine."""
    from repro_torch.obs import cli
    args = types.SimpleNamespace(torch_profile=str(tmp_path / "p"),
                                 device="cpu")
    obs.configure()
    try:
        with cli.profiled(args):
            with obs.profile_range("r"):
                torch.ones(2).add_(1)
    finally:
        obs.shutdown()
    cap = obs.last_capture()
    assert [r.name for r in cap.records] == ["r"]
    assert cap.records[0].device_ns is None and cap.idle_lag_ns is None


# -- the depthwise convs' ranges and counter ---------------------------------

def _trunk(arch):
    from repro_torch.models.cnn import convnext, resnet
    mods = {"convnext": lambda: convnext.convnext_modules(1 / 16,
                                                          [1, 1, 2, 1]),
            "vgg16": lambda: vgg16_modules(0.125),
            "resnet50": lambda: resnet.resnet50_modules(0.125, [1, 1, 1, 1])
            }[arch]()
    params, _ = init_trunk(mods, torch.Generator().manual_seed(0),
                           (IMAGE, IMAGE, 3), device="cpu")
    return mods, params


@pytest.mark.parametrize("engine,n", [("base", 1), ("twophase_h", 2)])
def test_depthwise_convs_open_their_ranges(engine, n):
    """Each of the ConvNeXt trunk's depthwise convs opens a ``dwconv``
    range (``phase`` ``fwd``) around its forward call and counts it in
    ``conv.depthwise_calls``, and opens one (``bwd``) around its
    gradient; under 2PS-H the rows' forward and their recomputation
    each call it."""
    from repro_torch.models.cnn.layers import ConvNeXtBlock
    mods, params = _trunk("convnext")
    plan = Planner(mods, (IMAGE, IMAGE, 3), BATCH).plan(engine, n)
    with obs.profiling() as cap:
        _step(mods, params, plan)
    dw = [r for r in cap.records if r.name == "dwconv"]
    fwd = [r for r in dw if r.attrs == {"phase": "fwd"}]
    bwd = [r for r in dw if r.attrs == {"phase": "bwd"}]
    assert len(fwd) + len(bwd) == len(dw)
    assert cap.count("conv.depthwise_calls") == len(fwd)
    blocks = sum(isinstance(m, ConvNeXtBlock) for m in mods)
    if engine == "base":
        assert len(fwd) == len(bwd) == blocks
    else:  # each row runs forward, then again under the recomputation
        rows = sum(n_r * sum(isinstance(m, ConvNeXtBlock)
                             for m in mods[a:b])
                   for a, b, n_r in plan.segments)
        assert len(fwd) == 2 * rows and len(bwd) == rows
        assert all(cap.records[r.parent].name == "row_recompute"
                   for r in fwd[rows:] if r.parent is not None)


@pytest.mark.parametrize("arch", ["vgg16", "resnet50"])
def test_dense_trunks_open_no_depthwise_range(arch):
    mods, params = _trunk(arch)
    plan = Planner(mods, (IMAGE, IMAGE, 3), BATCH).plan("twophase_h", 2)
    with obs.profiling() as cap:
        _step(mods, params, plan)
    assert not any(r.name == "dwconv" for r in cap.records)
    assert cap.count("conv.depthwise_calls") == 0
