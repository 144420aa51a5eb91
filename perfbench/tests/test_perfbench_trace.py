"""The reduction of a profiler trace to busy time, launches, kernel time
and idle gaps by host range, on a hand-made trace; and, on the card, the
control (TF32 in the reference's place) at each cell's own size, and a
short traced run of each cell, as the benchmark's command makes it, that
reads every per-layer metric."""

import json
import os
import subprocess
import sys

import pytest
from conftest import BENCH, CELLS

from harness import check, runner, spec, trace


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_reduce_counts_busy_launches_and_gaps():
    events = [
        _x("user_annotation", "pb_step", 0, 100),
        _x("user_annotation", "forward", 0, 40),
        _x("user_annotation", "backward", 40, 60),
        _x("kernel", "conv2d_rows_kernel<8>", 10, 20),
        _x("kernel", "conv2d_rows_kernel<8>", 25, 10),   # overlaps
        _x("gpu_memcpy", "Memcpy HtoD", 50, 10),
        _x("kernel", "sgemm", 70, 50),                   # past the host range
        _x("cuda_runtime", "cudaLaunchKernel", 11, 2),
        {"ph": "i", "name": "marker", "ts": 5},
    ]
    r = trace.reduce(events, steps=1)
    assert r["window_s"] == pytest.approx(120e-6)
    assert r["busy_s"] == pytest.approx((25 + 10 + 50) * 1e-6)
    assert r["launches"] == 3
    assert r["kernels"]["conv2d_rows_kernel<8>"] == (pytest.approx(30e-6), 2)
    # a gap goes to the range open when it began: 0-10 and 35-50 to
    # forward, 60-70 to backward
    assert r["idle"] == {"forward": pytest.approx(25e-6),
                         "backward": pytest.approx(10e-6)}
    b = trace.breakdown(r)
    assert b["device_ops"][0][0] == "sgemm"
    assert b["idle_gaps"][0][0] == "forward"


def test_reduce_without_device_work_reads_nothing():
    assert trace.reduce([_x("user_annotation", "pb_step", 0, 10)], 1) == {}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_every_per_layer_metric(name, cuda, tmp_path):
    # before any test of this process holds the card: the batch-768 cell
    # needs all of it, as a run of the benchmark has
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", name,
         "--seed", str(2**33 + 5), "--seconds", "3", "--trace", "1"],
        capture_output=True, text=True, timeout=600, cwd=BENCH.parent,
        env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["check"]
    assert set(result["metrics"]) == {m["name"] for m in
                                      spec.cell(name).per_layer}
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", CELLS)
def test_tf32_control_fails_on_the_card(name, cuda):
    cell = spec.cell(name)
    _, batches = runner.inputs(cell, 7, cuda)
    ref = runner.reference(cell, 7, batches, cuda)
    low = runner.reference(cell, 7, batches, cuda, low="tf32")
    values, _ = check.gaps(low, ref)
    assert not check.verdict(values, cell.limits), values
