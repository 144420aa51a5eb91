#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, imports only ``torch`` and the port
(``src/repro_torch``), and exits non-zero when any phase fails, when no
CUDA device is present, or when the port is not beside it.  Phases, each
printing one line:

1. env          torch/CUDA versions; TF32 off for convs and matmuls.
2. build        compile every kernel from ``src/repro_torch/kernels/csrc``.
3. kernel       ``conv2d_rows`` against its plain version at the 9 distinct
                VGG-16/224 conv shapes (batch 2 and the main path's batch
                32) and the geometry cases of the repo's kernel tests;
                max |kernel - plain| <= 1e-4 * max |plain| (fp32 sums of
                up to 4608 terms in another order).  Times the kernel, the
                plain version and ``F.conv2d`` (the library yardstick,
                never called by the port) at each VGG shape, beside the
                card's bound.
4. train_kernel the main path: ``repro_torch.launch.train --arch vgg16
                --preset full --strategy overlap --rows 4 --kernel cuda
                --steps 3`` (full width, batch 32); the plan must be
                ``overlap_cuda`` and the kernel must launch 13 times per
                forward (39), with finite losses.
5. train_rows   ``--strategy overlap --rows 4`` and ``--strategy base``, 2
                steps each: step-0 losses of all three runs agree within
                1e-4 relative, and OverL's measured peak memory is below
                base's (the paper's claim).

Then it prints the card's name and power limit (nvidia-smi), one JSON line
of per-kernel numbers, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

#: the 9 distinct VGG-16/224 conv shapes (H, W, Cin, Cout) with how many of
#: the 13 convs of one forward have each; k=3, s=1, p=1 throughout
VGG_SHAPES = [
    ((224, 224, 3, 64), 1), ((224, 224, 64, 64), 1),
    ((112, 112, 64, 128), 1), ((112, 112, 128, 128), 1),
    ((56, 56, 128, 256), 1), ((56, 56, 256, 256), 2),
    ((28, 28, 256, 512), 1), ((28, 28, 512, 512), 2),
    ((14, 14, 512, 512), 3),
]
#: geometry cases (H, W, Cin, Cout, k, s, p, block_h), as in the kernel
#: tests' shared table: stride 2, k 5 and 7, p=0, odd sizes
KERNEL_CONV_CASES = [
    (16, 16, 8, 16, 3, 1, 1, 4),
    (17, 13, 4, 8, 3, 1, 0, 8),
    (32, 32, 8, 8, 5, 1, 2, 8),
    (16, 16, 8, 16, 3, 2, 1, 4),
    (24, 24, 4, 8, 7, 2, 3, 4),
    (14, 14, 16, 32, 1, 1, 0, 8),
    (9, 9, 3, 4, 3, 1, 1, 2),
    (64, 8, 4, 4, 3, 1, 1, 16),
]
BLOCK_H = 8
TRAIN_BATCH = 32
CHECK_BATCH = 2
KERNEL_TOL = 1e-4
LOSS_TOL = 1e-4
#: VGG-16 without normalisation diverges at the trainer's default 0.05
TRAIN_LR = 1e-3


def _timed_ms(torch, fn, iters=5, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_parts(B, H, W, cin, cout, k=3, s=1, p=1):
    """(ms for the FLOPs at the fp32 peak, ms for the bytes at the HBM
    rate): each input read once and the output written once."""
    ho, wo = (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1
    flops = 2 * B * ho * wo * cout * k * k * cin
    nbytes = 4 * (B * H * W * cin + k * k * cin * cout + B * ho * wo * cout)
    return 1e3 * flops / PEAK_FP32_FLOPS, 1e3 * nbytes / PEAK_HBM_BYTES


def _bound(t_ops, t_bytes):
    """The least time the card could take, and which of the two sets it."""
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _inputs(torch, B, H, W, cin, cout, k, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, H, W, cin), generator=g).cuda()
    w = (torch.randn((k, k, cin, cout), generator=g)
         * math.sqrt(2.0 / (k * k * cin))).cuda()
    return x, w


def phase_env(torch, out):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out["smi"] = smi
    print(f"env: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()} tf32 off", flush=True)


def phase_build(torch, out):
    from repro_torch.kernels import build
    t0 = time.time()
    res = build.build_all()
    secs = time.time() - t0
    for name, r in res.items():
        for line in r["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", file=sys.stderr)
    print(f"build: {sorted(res)} in {secs:.3f}s "
          f"(fresh: {[n for n, r in res.items() if r['built']]})",
          flush=True)


def phase_kernel(torch, out):
    import torch.nn.functional as F
    from repro_torch.kernels import conv2d_rows as cr

    max_err = 0.0
    worst_rel = 0.0

    def check(x, w, s, p, bh, what):
        nonlocal max_err, worst_rel
        got = cr.conv2d_rows(x, w, stride=s, padding=p, block_h=bh)
        torch.cuda.synchronize()
        want = cr.conv2d_rows_plain(x, w, s, p, bh)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        max_err = max(max_err, err)
        worst_rel = max(worst_rel, err / scale)
        if not err <= KERNEL_TOL * scale:
            raise AssertionError(f"{what}: max abs err {err} > "
                                 f"{KERNEL_TOL} * {scale}")

    for i, ((H, W, cin, cout), _) in enumerate(VGG_SHAPES):
        x, w = _inputs(torch, CHECK_BATCH, H, W, cin, cout, 3, i)
        check(x, w, 1, 1, BLOCK_H, f"vgg {H}x{W}x{cin}->{cout}")
    for i, (H, W, cin, cout, k, s, p, bh) in enumerate(KERNEL_CONV_CASES):
        x, w = _inputs(torch, CHECK_BATCH, H, W, cin, cout, k, 100 + i)
        check(x, w, s, p, bh, f"case {(H, W, cin, cout, k, s, p, bh)}")

    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    ops_ms = bytes_ms = 0.0
    rows = []
    for batch in (CHECK_BATCH, TRAIN_BATCH):
        for i, ((H, W, cin, cout), mult) in enumerate(VGG_SHAPES):
            x, w = _inputs(torch, batch, H, W, cin, cout, 3, 200 + i)
            if batch == TRAIN_BATCH:
                check(x, w, 1, 1, BLOCK_H, f"vgg b{batch} {H}x{cin}->{cout}")
            xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
            t = {
                "ms": _timed_ms(torch, lambda: cr.conv2d_rows(
                    x, w, stride=1, padding=1, block_h=BLOCK_H)),
                "plain_ms": _timed_ms(torch, lambda: cr.conv2d_rows_plain(
                    x, w, 1, 1, BLOCK_H)),
                "library_ms": _timed_ms(torch, lambda: F.conv2d(
                    xc, wc, padding=1)),
            }
            t_ops, t_bytes = _bound_parts(batch, H, W, cin, cout)
            bound_ms, bound_by = _bound(t_ops, t_bytes)
            rows.append({"batch": batch, "shape": [H, W, cin, cout],
                         "convs_per_forward": mult, "bound_ms": bound_ms,
                         "bound_by": bound_by, **t})
            print(f"  kernel b={batch} {H}x{W} {cin}->{cout} x{mult}: "
                  f"ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
                  f"library_ms={t['library_ms']:.4f} "
                  f"bound_ms={bound_ms:.4f} ({bound_by})", flush=True)
            if batch == TRAIN_BATCH:
                for key in totals:
                    totals[key] += mult * t[key]
                ops_ms += mult * t_ops
                bytes_ms += mult * t_bytes
            del x, w, xc, wc
    # the function timed is one batch-32 forward's 13 convs: its bound
    # counts all their FLOPs and all their bytes
    totals["bound_ms"], bound_by = _bound(ops_ms, bytes_ms)
    out["kernel"] = {"max_abs_err": max_err, "rows": rows,
                     "bound_by": bound_by, **totals}
    print(f"kernel: conv2d_rows matches plain at {len(VGG_SHAPES)} VGG "
          f"shapes + {len(KERNEL_CONV_CASES)} geometry cases "
          f"(max abs err {max_err:.3e}, worst err/max|plain| "
          f"{worst_rel:.3e}); one batch-{TRAIN_BATCH} forward's 13 convs: "
          f"kernel {totals['ms']:.3f} ms, plain {totals['plain_ms']:.3f} ms,"
          f" F.conv2d {totals['library_ms']:.3f} ms, bound "
          f"{totals['bound_ms']:.3f} ms", flush=True)


def _train(torch, tmp, name, *flags, steps):
    from repro_torch.launch import train as T
    out_dir = os.path.join(tmp, name)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    recs = T.main(["--arch", "vgg16", "--preset", "full", "--steps",
                   str(steps), "--lr", str(TRAIN_LR), "--log-every", "1",
                   "--out", out_dir, *flags])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(out_dir, "train_log.json")) as f:
        plan = json.load(f)["plan"]
    losses = [r["loss"] for r in recs]
    if len(losses) != steps or not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"{name}: losses {losses}")
    # seconds per step on the host clock (loss.item() syncs each step);
    # step 0 includes first-call set-up
    ends = [r["elapsed_s"] for r in recs]
    step_s = [b - a for a, b in zip([0.0] + ends, ends)]
    return {"losses": losses, "peak": peak, "plan": plan, "step_s": step_s}


def phase_train_kernel(torch, out, tmp):
    from repro_torch.kernels import ops
    ops.conv2d.launches = 0
    run = _train(torch, tmp, "kernel", "--strategy", "overlap", "--rows",
                 "4", "--kernel", "cuda", steps=3)
    launches = ops.conv2d.launches
    out["launches"] = launches
    out["kernel_run"] = run
    if run["plan"]["engine"] != "overlap_cuda":
        raise AssertionError(f"plan engine {run['plan']['engine']}")
    if launches != 13 * 3:
        raise AssertionError(f"conv2d_rows launched {launches} times, "
                             f"expected 39 (13 convs x 3 forwards)")
    print(f"train_kernel: engine=overlap_cuda launches={launches} "
          f"losses={run['losses']} peak={run['peak']} "
          f"est={run['plan']['est_bytes']} step_s={run['step_s']}",
          flush=True)


def phase_train_rows(torch, out, tmp):
    runs = {"overlap": _train(torch, tmp, "overlap", "--strategy", "overlap",
                              "--rows", "4", steps=2),
            "base": _train(torch, tmp, "base", "--strategy", "base",
                           steps=2)}
    base0 = runs["base"]["losses"][0]
    rel = {n: abs(l - base0) / abs(base0) for n, l in (
        ("overlap", runs["overlap"]["losses"][0]),
        ("overlap_cuda", out["kernel_run"]["losses"][0]))}
    out["rows"] = {n: {"peak": r["peak"], "est": r["plan"]["est_bytes"],
                       "losses": r["losses"]} for n, r in runs.items()}
    print(f"train_rows: step-0 loss base={base0} rel diff {rel}; peak "
          f"overlap={runs['overlap']['peak']} (est "
          f"{runs['overlap']['plan']['est_bytes']}) base="
          f"{runs['base']['peak']} (est {runs['base']['plan']['est_bytes']})"
          f"; step_s overlap={runs['overlap']['step_s']} "
          f"base={runs['base']['step_s']}", flush=True)
    bad = {n: r for n, r in rel.items() if not r <= LOSS_TOL}
    if bad:
        raise AssertionError(f"step-0 loss differs from base: {bad}")
    if not runs["overlap"]["peak"] < runs["base"]["peak"]:
        raise AssertionError("OverL's peak memory is not below base's")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        phases = [("env", lambda: phase_env(torch, out)),
                  ("build", lambda: phase_build(torch, out)),
                  ("kernel", lambda: phase_kernel(torch, out)),
                  ("train_kernel", lambda: phase_train_kernel(torch, out,
                                                              tmp)),
                  ("train_rows", lambda: phase_train_rows(torch, out, tmp))]
        for name, fn in phases:
            try:
                fn()
            except Exception as e:  # report which phase failed, then stop
                import traceback
                traceback.print_exc()
                print(f"FAILED phase {name}: {e}", flush=True)
                return 1
    k = out["kernel"]
    print(out["smi"])
    print(json.dumps({"kernels": [{
        "name": "conv2d_rows", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/conv2d_rows.cu",
        "replaces": "src/repro/kernels/conv2d_rows.py:101",
        "launches": out["launches"], "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": k["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
