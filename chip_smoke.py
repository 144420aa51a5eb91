#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, imports only ``torch`` and the port
(``src/repro_torch``), and exits non-zero when any phase fails, when no
CUDA device is present, or when the port is not beside it.  Phases, each
printing one line:

1. env          torch/CUDA versions; TF32 off for convs and matmuls.
2. build        compile every kernel from ``src/repro_torch/kernels/csrc``;
                print each instantiation's ``ptxas`` registers and spills
                and the kernels' dynamic shared memory per CTA.
3. kernel       ``conv2d_rows`` against its plain version at the 9 distinct
                VGG-16/224 conv shapes (batch 2 and the main path's batch
                32) and the geometry cases of the repo's kernel tests;
                max |kernel - plain| <= 1e-4 * max |plain| (fp32 sums of
                up to 4608 terms in another order).  Times the kernel, the
                plain version and ``F.conv2d`` (the library yardstick,
                never called by the port) at each VGG shape, beside the
                card's bound; then the same at ResNet-50's stem (batch 32,
                224² x 3 -> 112² x 64, k 7, s 2, p 3).
4. train_kernel the main path: ``repro_torch.launch.train --arch vgg16
                --preset full --strategy overlap --rows 4 --kernel cuda
                --steps 3`` (full width, batch 32); the plan must be
                ``overlap_cuda`` and the kernel must launch 13 times per
                forward (39), with finite losses.
5. train_rows   ``--strategy overlap --rows 4`` and ``--strategy base``, 2
                steps each: step-0 losses of all three runs agree within
                1e-4 relative, and OverL's measured peak memory is below
                base's (the paper's claim).
   train_2ps    VGG-16 with no ``--strategy``: the config's own request
                must resolve to ``twophase_h`` at N=8 with the Planner's
                segments and ``est_bytes`` (``VGG_PLANS``), 3 steps; then
                ``twophase`` N=2, ``overlap_h`` N=8 and ``ckp``, 2 steps
                each.  Every step-0 loss within 1e-4 relative of base's;
                each run's peak printed beside its estimate, with its step
                times.
   residency    the same ``twophase_h`` N=8 under ``--residency host``
                (pinned host memory, prefetch 1) and ``recompute``, 2 steps
                each: step-0 loss within 1e-6 relative of device
                residency's, ``est_bytes`` 1,087,145,848, host's peak no
                higher than device's; step times printed.
   budget       ``--budget-gb 1.0``: ``Planner.for_budget`` must pick
                ``twophase_h`` N=11, 2 steps, peak beside the estimate.
   train_resnet ResNet-50 at published widths (224², batch 32, lr 1e-5):
                the config's request (``twophase_h`` N=8 and its segments,
                ``RESNET_PLAN``) and ``base``, 2 steps each, then
                ``--strategy overlap --rows 4 --kernel cuda``, 3 steps: the
                engine must be ``overlap_cuda`` and ``conv2d_rows`` (the
                stem) must launch 3 times; step-0 losses within 1e-4 of
                base's.
6. kernel_swa   ``swa_attention`` against its plain version at Gemma-3 4B's
                local-layer shape (B 1, H 8 after the GQA repeat, S 4096,
                D 256, window 1024): bf16 at the plan's bq/bk, ``allclose``
                atol 4e-3 / rtol 1e-2 (about twice the measured error), and
                fp32 at bq 128 / bk 64 (the fp32 tiles that fit at D 256),
                at 2e-5; then at the six shared SWA cases in fp32 and bf16
                at fp32 2e-5 / bf16 2e-2.  Times the kernel, the plain
                version and ``F.scaled_dot_product_attention`` with the same
                boolean window mask (the library yardstick, never called by
                the port) at the Gemma shape, beside the card's bound.
7. kernel_ssd   ``ssd_scan`` (the chunked SSD) against its chunked plain
                version at Zamba2-7B's Mamba2 widths (H 32, P 224, N 64; Bt
                1, S 4096) at every chunk of ``SSD_CHUNKS`` whose shared
                memory fits, and at the four shared SSD cases at their own
                chunk, atol 1e-3; against the sequential oracle once at the
                Zamba shape; times the kernel at each fitting chunk and the
                plain version at the plan's (no single PyTorch call computes
                this function); then the ``seq_ssd_cuda`` engine's op,
                forward and backward, at the Zamba shape through a plan with
                ``seq`` 4096 kernelized to ``"cuda"`` (so the plan's chunk is
                what launches), with the launch count from 0 (its main
                path).
8. train_lm_kernel  the LM main path: ``repro_torch.launch.train --arch
                gemma3_4b --preset full --batch 1 --seq 4096 --kernel cuda
                --steps 3`` at published widths, depth cut 34 -> 12 layers
                (10 local, 2 global); the plan must be ``seq_swa_cuda``
                with no ``kernel_fallback`` and the kernel must launch once
                per local layer per forward (30), with finite losses.
9. train_lm_rows    the same model with ``--kernel plain`` (the halo
                loop), 2 steps: its step-0 loss within 1e-4 relative of the
                kernel run's (bf16 activations).  Then a memory probe on
                one set of 12-layer parameters: ``build_lm_apply`` forward
                + backward, no optimizer, at the config's ``row_chunks=8``
                and at ``row_chunks=1``; the row-chunked peak must be below
                the unchunked one.

Every train run above carries ``--trace`` and ``--metrics-out`` (into a
temporary ``obs`` directory) and prints its step-0 ``plan audit:`` line.

10. memory      VGG-16 ``base``, ``overlap`` N=4, ``overlap_h`` N=8 and
                ``--budget-gb 1.0``, 2 steps each, under
                ``torch.cuda.memory._record_memory_history`` and a
                saved-tensor hook; the allocator trace is replayed to its
                peak and every live block classed by the module and function
                that allocated it (``MEM_CLASSES``), beside the terms the
                Planner priced (they must sum to its estimate); OverL N=4
                against ``base`` with and without the cuDNN workspace;
                snapshots under ``build/memory/``.
11. profile     ``--torch-profile`` over 2 steps of VGG-16 ``base``,
                ``overlap`` N=4, ``twophase_h`` N=8 and ``overlap_cuda``; the
                second step's host ranges, device-busy time, launches, top
                10 device operations and device time by category
                (``PROFILE_CATEGORIES``); Chrome traces under
                ``build/profile/``.
12. autotune    ``CostTable.calibrate()``; ``--budget-gb 1.0 --plan-cache``
                twice (a miss that solves, then a hit with no solve) with
                the costed plan's prediction beside the measured step;
                ``Planner.autotune_kernel`` over ``conv2d_rows``' block_h
                (VGG-16's batch-1 forward), ``swa_attention``'s bq/bk
                (Gemma's local layer) and ``ssd_scan``'s chunk (Zamba2's
                widths), each winner held against its plain version.
13. obs         ``python -m repro_torch.analysis.audit --check`` over every
                trace (the reference's bands), and the row executor's
                counters of ``twophase_h`` N=8 under host residency against
                the plan's rows and the SD bytes the Planner priced.

Then it prints the card's name and power limit (nvidia-smi), one JSON line
of per-kernel numbers (``conv2d_rows``' launches are train_kernel's 39 plus
train_resnet's 3), and last ``{"ok": true, "device": {...}}``.
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

#: H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, bf16
#: dense on the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
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

#: the shared SWA cases (S, D, window, bq, bk) and SSD cases
#: (Bt, S, H, P, N, chunk) of the kernel tests
KERNEL_SWA_CASES = [
    (256, 64, 64, 64, 32),
    (256, 64, 0, 128, 64),
    (512, 32, 128, 128, 128),
    (256, 64, 100, 64, 32),
    (128, 128, 32, 32, 32),
    (128, 64, 200, 64, 64),
]
KERNEL_SSD_CASES = [
    (2, 64, 4, 16, 8, 16),
    (1, 128, 2, 8, 4, 32),
    (2, 32, 4, 16, 8, 32),
    (1, 64, 8, 8, 16, 8),
]
SWA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: (atol, rtol) of the bf16 check at the Gemma shape: a few bf16 ulps of
#: the output, so a fault worth a few keys of a 1024-key window shows
SWA_GEMMA_BF16_TOL = (4e-3, 1e-2)
#: fp32 tiles at head_dim 256: q, k and v at bq = bk = 128 overflow shared
#: memory, bk = 64 fits
SWA_GEMMA_FP32_TILES = (128, 64)
SSD_ATOL = 1e-3
#: Gemma-3 4B on the card: published widths, 12 of 34 layers (two 5:1
#: local/global periods), batch 1, seq 4096
LM_LAYERS, LM_LOCAL_LAYERS, LM_BATCH, LM_SEQ = 12, 10, 1, 4096
LM_LOSS_TOL = 1e-4
#: the Planner's answers at full width (224², batch 32, xi = 3 * 4 *
#: n_params), which equal the JAX package's (tests/test_torch_planner.py):
#: (engine, N, est_bytes) by run, and the hybrids' segments
VGG_PLANS = {"twophase_h": ("twophase_h", 8, 1115531128),
             "twophase": ("twophase", 2, 2043471736),
             "overlap_h": ("overlap_h", 8, 1110112120),
             "ckp": ("ckp", 8, 2604353400),
             "host": ("twophase_h", 8, 1087145848),
             "recompute": ("twophase_h", 8, 1087145848)}
VGG_SEGMENTS = [[0, 6, 8], [6, 11, 8], [11, 16, 8], [16, 21, 8],
                [21, 26, 7], [26, 31, 3]]
RESNET_PLAN = ("twophase_h", 8, 657321336)
RESNET_SEGMENTS = [[0, 5, 8], [5, 10, 7], [10, 15, 3], [15, 20, 1]]
#: --budget-gb 1.0 on VGG-16: Planner.for_budget's pick
BUDGET_GB, BUDGET_PLAN = 1.0, ("twophase_h", 11)
#: host and recompute residency move bytes, never values
RESIDENCY_TOL = 1e-6
#: ResNet-50 at random init with BatchNorm at its running statistics
#: starts near loss 800 and diverges at VGG-16's 1e-3
RESNET_LR = 1e-5
#: Zamba2-7B's Mamba2 widths (configs/zamba2_7b.py: d_model 3584, expand 2,
#: 32 heads, state 64) at batch 1, seq 4096
SSD_SHAPE = (1, 4096, 32, 7168 // 32, 64)


def _timed_ms(torch, fn, iters=5, warmup=2):
    """Mean ms of ``iters`` calls between CUDA events, after ``warmup``."""
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


def _ptxas_report(log):
    """``[(kernel, registers, spill stores, spill loads)]`` from ``nvcc
    -Xptxas -v`` output, kernel names demangled where c++filt exists."""
    import re
    rows, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spills))
            name = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.splitlines()
        if len(names) == len(rows):
            rows = [(n.replace("(anonymous namespace)::", ""), *r[1:])
                    for n, r in zip(names, rows)]
    except (OSError, subprocess.SubprocessError):
        pass
    return rows


def phase_build(torch, out):
    from repro_torch.kernels import build
    t0 = time.time()
    res = build.build_all()
    secs = time.time() - t0
    ptxas = {}
    for name, r in res.items():
        ptxas[name] = _ptxas_report(r["ptxas"])
        for fn, regs, st, ld in ptxas[name]:
            print(f"  ptxas {name}: {fn}: {regs} registers, spill stores "
                  f"{st} B, spill loads {ld} B", flush=True)
    out["ptxas"] = ptxas
    from repro_torch.kernels import conv2d_rows as cr
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.kernels import swa_attention as sw
    n = SSD_SHAPE[-1]
    print(f"  dynamic shared memory per CTA: conv2d_rows at VGG-16 block_h "
          f"{BLOCK_H}: {cr.smem_bytes(BLOCK_H, 1, 3, 64)} B (Cout 64), "
          f"{cr.smem_bytes(BLOCK_H, 1, 3, 512)} B (Cout >= 128); "
          f"swa_attention at the Gemma shape: bf16 "
          f"{sw.smem_bytes(128, 128, 256, 2)} B (bq=bk=128), fp32 "
          f"{sw.smem_bytes(*SWA_GEMMA_FP32_TILES, 256, 4)} B "
          f"(bq={SWA_GEMMA_FP32_TILES[0]} bk={SWA_GEMMA_FP32_TILES[1]}); "
          f"ssd_scan at N {n}: "
          + ", ".join(f"chunk {c} {sc.smem_bytes(c, n)} B"
                      for c in (256, 128, 64, 32)),
          flush=True)
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
                  f"bound_ms={bound_ms:.4f} ({bound_by}) "
                  f"kernel/library={t['ms'] / t['library_ms']:.3f} "
                  f"bound/kernel={bound_ms / t['ms']:.3f}", flush=True)
            if batch == TRAIN_BATCH:
                for key in totals:
                    totals[key] += mult * t[key]
                ops_ms += mult * t_ops
                bytes_ms += mult * t_bytes
            del x, w, xc, wc
    # the function timed is one batch-32 forward's 13 convs: its bound
    # counts all their FLOPs and all their bytes
    totals["bound_ms"], bound_by = _bound(ops_ms, bytes_ms)
    # ResNet-50's stem, which overlap_cuda runs through the kernel: k 7,
    # s 2, p 3, Cin 3 -> 64, 224² -> 112²
    for batch in (CHECK_BATCH, TRAIN_BATCH):
        x, w = _inputs(torch, batch, 224, 224, 3, 64, 7, 300 + batch)
        check(x, w, 2, 3, BLOCK_H, f"resnet stem b{batch}")
    xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    stem = {
        "ms": _timed_ms(torch, lambda: cr.conv2d_rows(
            x, w, stride=2, padding=3, block_h=BLOCK_H), iters=20),
        "plain_ms": _timed_ms(torch, lambda: cr.conv2d_rows_plain(
            x, w, 2, 3, BLOCK_H)),
        "library_ms": _timed_ms(torch, lambda: F.conv2d(
            xc, wc, stride=2, padding=3), iters=20),
    }
    stem["bound_ms"], stem["bound_by"] = _bound(*_bound_parts(
        TRAIN_BATCH, 224, 224, 3, 64, k=7, s=2, p=3))
    del x, w, xc, wc
    print(f"  kernel resnet stem b={TRAIN_BATCH} 224x224 3->64 k7 s2 p3: "
          f"ms={stem['ms']:.4f} plain_ms={stem['plain_ms']:.4f} "
          f"library_ms={stem['library_ms']:.4f} "
          f"bound_ms={stem['bound_ms']:.4f} ({stem['bound_by']}) "
          f"kernel/library={stem['ms'] / stem['library_ms']:.3f} "
          f"bound/kernel={stem['bound_ms'] / stem['ms']:.3f}", flush=True)
    out["kernel"] = {"max_abs_err": max_err, "rows": rows, "stem": stem,
                     "bound_by": bound_by, **totals}
    print(f"kernel: conv2d_rows matches plain at {len(VGG_SHAPES)} VGG "
          f"shapes + {len(KERNEL_CONV_CASES)} geometry cases + the ResNet "
          f"stem "
          f"(max abs err {max_err:.3e}, worst err/max|plain| "
          f"{worst_rel:.3e}); one batch-{TRAIN_BATCH} forward's 13 convs: "
          f"kernel {totals['ms']:.3f} ms, plain {totals['plain_ms']:.3f} ms,"
          f" F.conv2d {totals['library_ms']:.3f} ms, bound "
          f"{totals['bound_ms']:.3f} ms (kernel/F.conv2d "
          f"{totals['ms'] / totals['library_ms']:.3f}, bound/kernel "
          f"{totals['bound_ms'] / totals['ms']:.3f})", flush=True)


def _obs_flags(tmp, name):
    """Every train run is traced: ``--trace`` and ``--metrics-out`` into
    ``tmp/obs`` (the obs phase gates the audit records there)."""
    d = os.path.join(tmp, "obs")
    return ["--trace", os.path.join(d, f"{name}.jsonl"),
            "--metrics-out", os.path.join(d, f"{name}.metrics.json")]


def _finish_run(torch, tmp, name, recs, steps):
    """Peak, plan, audit record, counters, losses and step times of a
    train run that just ended."""
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(tmp, name, "train_log.json")) as f:
        log = json.load(f)
    with open(os.path.join(tmp, "obs", f"{name}.metrics.json")) as f:
        counters = json.load(f)["counters"]
    losses = [r["loss"] for r in recs]
    if len(losses) != steps or not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"{name}: losses {losses}")
    if not log["plan_audit"]:
        raise AssertionError(f"{name}: no plan audit in train_log.json")
    # seconds per step on the host clock (loss.item() syncs each step);
    # step 0 includes first-call set-up
    ends = [r["elapsed_s"] for r in recs]
    step_s = [b - a for a, b in zip([0.0] + ends, ends)]
    return {"losses": losses, "peak": peak, "plan": log["plan"],
            "step_s": step_s, "audit": log["plan_audit"],
            "counters": counters, "plan_terms": log.get("plan_terms"),
            "plan_sd": log.get("plan_sd")}


def _train(torch, tmp, name, *flags, steps, arch="vgg16", lr=TRAIN_LR):
    from repro_torch.launch import train as T
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    recs = T.main(["--arch", arch, "--preset", "full", "--steps",
                   str(steps), "--lr", str(lr), "--log-every", "1",
                   "--out", os.path.join(tmp, name), *_obs_flags(tmp, name),
                   *flags])
    return _finish_run(torch, tmp, name, recs, steps)


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


def _check_plan(name, run, engine, n_rows, est=None, segments=None):
    plan = run["plan"]
    got = (plan["engine"], plan["n_rows"], plan["est_bytes"],
           plan["segments"])
    want = (engine, n_rows, plan["est_bytes"] if est is None else est,
            plan["segments"] if segments is None else segments)
    if got != want:
        raise AssertionError(f"{name}: plan (engine, N, est_bytes, "
                             f"segments) {got}, expected {want}")


def _rel0(run, ref):
    return abs(run["losses"][0] - ref) / abs(ref)


def _report(name, run, rel):
    plan = run["plan"]
    print(f"  {name}: engine={plan['engine']} N={plan['n_rows']} "
          f"residency={(plan.get('residency') or {}).get('default')} "
          f"peak={run['peak']} est={plan['est_bytes']} "
          f"peak-est={run['peak'] - plan['est_bytes']} "
          f"step_s={run['step_s']} step-0 loss {run['losses'][0]} "
          f"(rel {rel:.3e})", flush=True)


def phase_train_2ps(torch, out, tmp):
    """VGG-16's own plan request (no --strategy: twophase_h at N=8), then
    twophase N=2, overlap_h N=8 and ckp."""
    runs = {"twophase_h": _train(torch, tmp, "twophase_h", steps=3)}
    for name, flags in (("twophase", ["--rows", "2"]),
                        ("overlap_h", []), ("ckp", [])):
        runs[name] = _train(torch, tmp, name, "--strategy", name, *flags,
                            steps=2)
    base0 = out["rows"]["base"]["losses"][0]
    rel = {}
    for name, run in runs.items():
        _check_plan(name, run, *VGG_PLANS[name],
                    VGG_SEGMENTS if name == "twophase_h" else None)
        rel[name] = _rel0(run, base0)
        _report(name, run, rel[name])
    out["2ps"] = runs
    print(f"train_2ps: the config's request resolved to twophase_h N=8 "
          f"(est {VGG_PLANS['twophase_h'][2]}, segments {VGG_SEGMENTS}); "
          f"step-0 losses vs base {base0}: {rel}", flush=True)
    bad = {n: r for n, r in rel.items() if not r <= LOSS_TOL}
    if bad:
        raise AssertionError(f"step-0 loss differs from base: {bad}")


def phase_residency(torch, out, tmp):
    """twophase_h N=8 with its boundary caches in pinned host memory
    (prefetch 1) and regenerated (recompute), against device residency."""
    dev = out["2ps"]["twophase_h"]
    runs, rel = {}, {}
    for policy in ("host", "recompute"):
        runs[policy] = run = _train(torch, tmp, f"res_{policy}",
                                    "--residency", policy, steps=2)
        _check_plan(policy, run, *VGG_PLANS[policy], VGG_SEGMENTS)
        if run["plan"]["residency"]["default"] != policy:
            raise AssertionError(f"{policy}: plan residency "
                                 f"{run['plan']['residency']}")
        rel[policy] = _rel0(run, dev["losses"][0])
        _report(policy, run, rel[policy])
    out["residency"] = runs
    print(f"residency: step-0 loss vs device residency {rel}; peak device "
          f"{dev['peak']} host {runs['host']['peak']} recompute "
          f"{runs['recompute']['peak']}; steady step_s device "
          f"{dev['step_s'][-1]:.4f} host {runs['host']['step_s'][-1]:.4f} "
          f"recompute {runs['recompute']['step_s'][-1]:.4f}", flush=True)
    bad = {n: r for n, r in rel.items() if not r <= RESIDENCY_TOL}
    if bad:
        raise AssertionError(f"residency changed the loss: {bad}")
    if not runs["host"]["peak"] <= dev["peak"]:
        raise AssertionError("host residency's peak is above device "
                             "residency's")


def phase_budget(torch, out, tmp):
    run = _train(torch, tmp, "budget", "--budget-gb", str(BUDGET_GB),
                 steps=2)
    _check_plan("budget", run, *BUDGET_PLAN)
    if not run["plan"]["feasible"]:
        raise AssertionError(f"budget plan infeasible: {run['plan']}")
    rel = _rel0(run, out["rows"]["base"]["losses"][0])
    _report("budget", run, rel)
    out["budget"] = run
    print(f"budget: --budget-gb {BUDGET_GB} resolved to "
          f"{BUDGET_PLAN[0]} N={BUDGET_PLAN[1]}", flush=True)
    if not rel <= LOSS_TOL:
        raise AssertionError(f"step-0 loss differs from base by {rel}")


def phase_train_resnet(torch, out, tmp):
    """ResNet-50 at published widths: its config's request, base, and
    overlap N=4 kernelized to overlap_cuda (the stem runs conv2d_rows)."""
    from repro_torch.kernels import ops
    kw = dict(arch="resnet50", lr=RESNET_LR)
    runs = {"config": _train(torch, tmp, "resnet_config", steps=2, **kw),
            "base": _train(torch, tmp, "resnet_base", "--strategy", "base",
                           steps=2, **kw)}
    _check_plan("resnet config", runs["config"], *RESNET_PLAN,
                RESNET_SEGMENTS)
    ops.conv2d.launches = 0
    runs["overlap_cuda"] = _train(torch, tmp, "resnet_kernel", "--strategy",
                                  "overlap", "--rows", "4", "--kernel",
                                  "cuda", steps=3, **kw)
    launches = ops.conv2d.launches
    out["resnet_launches"] = launches
    _check_plan("resnet overlap_cuda", runs["overlap_cuda"], "overlap_cuda",
                4)
    base0 = runs["base"]["losses"][0]
    rel = {n: _rel0(r, base0) for n, r in runs.items()}
    for name, run in runs.items():
        _report(f"resnet {name}", run, rel[name])
    out["resnet"] = runs
    print(f"train_resnet: overlap_cuda launched conv2d_rows {launches} "
          f"times in 3 steps; step-0 losses vs base {base0}: {rel}",
          flush=True)
    if launches != 3:
        raise AssertionError(f"conv2d_rows launched {launches} times, "
                             f"expected 3 (the stem x 3 forwards)")
    bad = {n: r for n, r in rel.items() if not r <= LOSS_TOL}
    if bad:
        raise AssertionError(f"step-0 loss differs from base: {bad}")


def _gemma12(torch):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("gemma3_4b"), n_layers=LM_LAYERS)


def _swa_case(torch, B, H, S, D, dtype, seed):
    """(B, H, S, D) views of (B, S, H, D) tensors: the layout the LM path
    hands the kernel."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((B, S, H, D), generator=g).to(device="cuda",
                                                      dtype=dtype)
            .transpose(1, 2) for _ in range(3)]


def phase_kernel_swa(torch, out):
    import torch.nn.functional as F
    from repro_torch.exec import Planner
    from repro_torch.kernels import swa_attention as sw

    cfg = _gemma12(torch)
    spec = Planner.for_model(cfg, LM_BATCH, LM_SEQ, kernel="cuda").kernel
    H, S, D, window = cfg.n_heads, LM_SEQ, cfg.head_dim, cfg.sliding_window
    max_err = 0.0

    def check(q, k, v, window, bq, bk, what, tol=None):
        nonlocal max_err
        got = sw.swa_attention(q, k, v, window=window, bq=bq, bk=bk)
        torch.cuda.synchronize()
        want = sw.swa_attention_plain(q, k, v, window, bq, bk)
        err = (got.float() - want.float()).abs()
        max_err = max(max_err, float(err.max()))
        atol, rtol = tol or (SWA_TOL[str(q.dtype).split(".")[1]],) * 2
        if not bool((err <= atol + rtol * want.float().abs()).all()):
            raise AssertionError(f"{what}: max abs err {float(err.max())}")
        return float(err.max())

    q32 = _swa_case(torch, LM_BATCH, H, S, D, torch.float32, 0)
    err32 = check(*q32, window, *SWA_GEMMA_FP32_TILES,
                  "gemma local layer fp32")
    del q32
    q, k, v = _swa_case(torch, LM_BATCH, H, S, D, torch.bfloat16, 0)
    err16 = check(q, k, v, window, spec.bq, spec.bk, "gemma local layer",
                  SWA_GEMMA_BF16_TOL)
    for i, (cs, cd, cw, cbq, cbk) in enumerate(KERNEL_SWA_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            qc, kc, vc = _swa_case(torch, 2, 2, cs, cd, dtype, 10 + i)
            check(qc, kc, vc, cw, cbq, cbk, f"case {(cs, cd, cw, cbq, cbk)} "
                  f"{dtype}")
    pos = torch.arange(S, device="cuda")
    mask = (pos[None, :] <= pos[:, None]) \
        & (pos[None, :] > pos[:, None] - window)
    t = {
        "ms": _timed_ms(torch, lambda: sw.swa_attention(
            q, k, v, window=window, bq=spec.bq, bk=spec.bk), iters=20),
        "plain_ms": _timed_ms(torch, lambda: sw.swa_attention_plain(
            q, k, v, window, spec.bq, spec.bk)),
        "library_ms": _timed_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), iters=20),
    }
    # the window-clipped work: 2 FMAs per (query, visible key, d)
    visible = sum(min(i + 1, window) for i in range(S))
    flops = 4 * LM_BATCH * H * D * visible
    nbytes = 4 * LM_BATCH * H * S * D * 2
    t_ops = 1e3 * flops / PEAK_BF16_FLOPS
    t_bytes = 1e3 * nbytes / PEAK_HBM_BYTES
    bound_ms, bound_by = _bound(t_ops, t_bytes)
    out["swa"] = {"max_abs_err": max_err, "gemma_err_bf16": err16,
                  "gemma_err_fp32": err32, "bound_ms": bound_ms,
                  "bound_by": bound_by, "flops": flops, "bytes": nbytes,
                  "bq": spec.bq, "bk": spec.bk, **t}
    print(f"kernel_swa: swa_attention matches plain at the Gemma local "
          f"layer (1x{H}x{S}x{D}, window {window}; bf16 bq={spec.bq} "
          f"bk={spec.bk} max abs err {err16:.3e}, fp32 bq="
          f"{SWA_GEMMA_FP32_TILES[0]} bk={SWA_GEMMA_FP32_TILES[1]} max abs "
          f"err {err32:.3e}) + {len(KERNEL_SWA_CASES)} cases x fp32/bf16 "
          f"(max abs err {max_err:.3e}); at the Gemma shape: kernel "
          f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, SDPA+mask "
          f"{t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
          f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); kernel at "
          f"{100 * bound_ms / t['ms']:.2f} % of its bound, "
          f"{t['library_ms'] / t['ms']:.3f}x SDPA+mask's speed", flush=True)


def _ssd_inputs(torch, Bt, S, H, P, N, seed):
    g = torch.Generator().manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=g)  # noqa: E731
    x, B, C = r(Bt, S, H, P) * 0.5, r(Bt, S, N) * 0.5, r(Bt, S, N) * 0.5
    dt = torch.nn.functional.softplus(r(Bt, S, H))
    a = torch.exp(-dt * torch.exp(r(Bt, S, H) * 0.1))
    return [t.cuda() for t in (x, B, C, a, dt)]


def _ssd_flops(Bt, S, H, P, N, c):
    """FLOPs of the chunked SSD at chunk ``c``: the ``C Bᵀ`` Gram matrix,
    its causal half times ``dt x``, and the carried state's two products
    (``y`` from ``h`` and the update of ``h``), once each."""
    n_chunks = S // c
    gram = 2 * c * c * N
    intra = c * (c + 1) * H * P
    carry = 2 * (2 * c * N * H * P)
    return Bt * n_chunks * (gram + intra + carry)


def phase_kernel_ssd(torch, out):
    from repro_torch.exec import ExecutionPlan, build_apply
    from repro_torch.exec.planner import kernelize_plan
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.kernels.ref import ssd_scan_ref

    Bt, S, H, P, N = SSD_SHAPE
    # the plan the op runs: seq and state size as extras, kernelized to
    # "cuda" (the plan's chunk, or a retiled one, is what launches)
    plan = kernelize_plan(ExecutionPlan.explicit("seq_ssd_cuda", seq=S,
                                                 ssm_state=N), "cuda")
    if plan.engine != "seq_ssd_cuda" or plan.get("kernel_fallback"):
        raise AssertionError(f"seq_ssd_cuda plan: {plan.engine} "
                             f"{plan.extras}")
    chunk = min(plan.kernel.chunk, S)
    fitting = [c for c in ops.SSD_CHUNKS if not sc.launch_problem(c, N)]
    max_err = 0.0

    def check(ins, c, what):
        nonlocal max_err
        got = sc.ssd_scan(*ins, chunk=c)
        torch.cuda.synchronize()
        err = float((got - sc.ssd_scan_plain(*ins, chunk=c)).abs().max())
        max_err = max(max_err, err)
        if not err <= SSD_ATOL:
            raise AssertionError(f"ssd {what}: max abs err {err}")
        return got, err

    ins = _ssd_inputs(torch, *SSD_SHAPE, seed=20)
    errs = {c: check(ins, c, f"zamba chunk {c}")[1] for c in fitting}
    for i, (*case, c) in enumerate(KERNEL_SSD_CASES):
        check(_ssd_inputs(torch, *case, seed=21 + i), c, f"case {case} "
              f"chunk {c}")
    got = sc.ssd_scan(*ins, chunk=chunk)
    oracle_err = float((got - ssd_scan_ref(*ins)[0]).abs().max())
    del got
    if not oracle_err <= SSD_ATOL:
        raise AssertionError(f"ssd against the sequential oracle: max abs "
                             f"err {oracle_err}")
    max_err = max(max_err, oracle_err)
    per_chunk = {c: _timed_ms(torch, lambda c=c: sc.ssd_scan(*ins, chunk=c),
                              iters=20) for c in fitting}
    t = {"ms": per_chunk[chunk],
         "plain_ms": _timed_ms(torch, lambda: sc.ssd_scan_plain(
             *ins, chunk=chunk), iters=3, warmup=1)}
    # the bound: each input read once and y written once, or the chunked
    # form's FLOPs as three TF32 products each (3xTF32) at the TF32 peak
    flops = _ssd_flops(Bt, S, H, P, N, chunk)
    nbytes = 4 * (2 * Bt * S * H * P + 2 * Bt * S * N + 2 * Bt * S * H)
    bound_ms, bound_by = _bound(1e3 * 3 * flops / PEAK_TF32_FLOPS,
                                1e3 * nbytes / PEAK_HBM_BYTES)
    # the step-by-step recurrence's bound: ~5 FLOP per (t, h, p, n) in fp32
    # SIMT
    simt_flops = 5 * Bt * S * H * P * N + Bt * S * H * P
    simt_ms = 1e3 * simt_flops / PEAK_FP32_FLOPS
    # the op-level seq_ssd_cuda engine, forward + backward, counted from 0
    apply = build_apply(None, plan)
    leaves = [x.detach().requires_grad_() for x in ins]
    ops.ssd_scan.launches = 0
    y = apply(*leaves)
    grads = torch.autograd.grad(y.square().sum(), leaves)
    torch.cuda.synchronize()
    launches = ops.ssd_scan.launches
    finite = [bool(torch.isfinite(g).all()) for g in grads]
    if launches != 1 or not all(finite):
        raise AssertionError(f"seq_ssd_cuda: {launches} launches, finite "
                             f"grads {finite}")
    out["ssd"] = {"max_abs_err": max_err, "bound_ms": bound_ms,
                  "bound_by": bound_by, "launches": launches,
                  "flops": flops, "bytes": nbytes, "chunk": chunk,
                  "per_chunk_ms": per_chunk, "per_chunk_err": errs,
                  "oracle_err": oracle_err, "simt_bound_ms": simt_ms, **t}
    print(f"kernel_ssd: ssd_scan matches its chunked plain version at "
          f"{SSD_SHAPE} at chunks {fitting} (max abs err "
          + ", ".join(f"{c}: {e:.3e}" for c, e in errs.items())
          + f") + {len(KERNEL_SSD_CASES)} cases (max abs err over all "
          f"{max_err:.3e}), the sequential oracle at chunk {chunk} "
          f"({oracle_err:.3e}); plan chunk {chunk} "
          f"(kernel_smem_bytes={plan.get('kernel_smem_bytes')}): kernel "
          f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}; {nbytes} B, "
          f"{3 * flops / 1e9:.2f} GFLOP as 3xTF32), kernel at "
          f"{100 * bound_ms / t['ms']:.2f} % of its bound; the fp32-SIMT "
          f"step-by-step recurrence's bound {simt_ms:.4f} ms; kernel ms by "
          f"chunk " + ", ".join(f"{c}: {v:.4f}" for c, v in
                                 per_chunk.items())
          + f"; seq_ssd_cuda fwd+bwd launched the kernel {launches} "
          f"time(s)", flush=True)


def _train_lm(torch, tmp, name, kernel, steps):
    from repro_torch.launch import train as T
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    recs = T.main(["--arch", "gemma3_4b", "--preset", "full", "--batch",
                   str(LM_BATCH), "--seq", str(LM_SEQ), "--kernel", kernel,
                   "--steps", str(steps), "--log-every", "1", "--out",
                   os.path.join(tmp, name), *_obs_flags(tmp, name)],
                  cfg=_gemma12(torch))
    return _finish_run(torch, tmp, name, recs, steps)


def phase_train_lm_kernel(torch, out, tmp):
    from repro_torch.kernels import ops
    ops.swa_attention.launches = 0
    run = _train_lm(torch, tmp, "lm_kernel", "cuda", 3)
    launches = ops.swa_attention.launches
    out["swa_launches"] = launches
    out["lm_kernel"] = run
    plan = run["plan"]
    if plan["engine"] != "seq_swa_cuda" \
            or "kernel_fallback" in plan["extras"]:
        raise AssertionError(f"plan engine {plan['engine']} extras "
                             f"{plan['extras']}")
    if launches != LM_LOCAL_LAYERS * 3:
        raise AssertionError(f"swa_attention launched {launches} times, "
                             f"expected {LM_LOCAL_LAYERS * 3} "
                             f"({LM_LOCAL_LAYERS} local layers x 3 "
                             f"forwards)")
    print(f"train_lm_kernel: engine=seq_swa_cuda launches={launches} "
          f"losses={run['losses']} peak={run['peak']} "
          f"est={plan['est_bytes']} step_s={run['step_s']}", flush=True)


def _fwd_bwd_peak(torch, cfg, params, row_chunks):
    """Peak bytes of one forward + backward through ``build_lm_apply``
    (no optimizer) at ``row_chunks``, and the plan's estimate."""
    import dataclasses
    from repro_torch.data.pipeline import TokenDataset, TokenDatasetConfig
    from repro_torch.exec import Planner
    from repro_torch.models.lm.rowexec import build_lm_apply
    from repro_torch.optim.adamw import tree_leaves
    cfg = dataclasses.replace(cfg, row_chunks=row_chunks)
    plan = Planner.for_model(cfg, LM_BATCH, LM_SEQ, kernel="cuda")
    apply = build_lm_apply(cfg, plan)
    hb = TokenDataset(TokenDatasetConfig(vocab=cfg.vocab, seq_len=LM_SEQ,
                                         batch=LM_BATCH)).batch_at(0)
    batch = {k: torch.from_numpy(hb[k]).long().cuda()
             for k in ("tokens", "labels")}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    loss, _ = apply(params, batch)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del grads
    return peak, plan.est_bytes, loss.detach().item()


def phase_train_lm_rows(torch, out, tmp):
    from repro_torch.models.lm.model import init_lm
    from repro_torch.optim.adamw import tree_leaves
    run = _train_lm(torch, tmp, "lm_rows", "plain", 2)
    if run["plan"]["engine"] != "seq_swa_overlap":
        raise AssertionError(f"plan engine {run['plan']['engine']}")
    k0 = out["lm_kernel"]["losses"][0]
    rel = abs(run["losses"][0] - k0) / abs(k0)
    cfg = _gemma12(torch)
    params = init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    for t in tree_leaves(params):
        t.requires_grad_()
    peaks = {rc: _fwd_bwd_peak(torch, cfg, params, rc)
             for rc in (cfg.row_chunks, 1)}
    del params
    out["lm_rows"] = {"losses": run["losses"], "rel": rel,
                      "step_s": run["step_s"], "peak": run["peak"],
                      "probe": peaks}
    (p8, e8, _), (p1, e1, _) = peaks[cfg.row_chunks], peaks[1]
    print(f"train_lm_rows: step-0 loss kernel={k0} plain="
          f"{run['losses'][0]} rel diff {rel:.3e}; fwd+bwd peak "
          f"row_chunks={cfg.row_chunks} {p8} B (est {e8}) vs row_chunks=1 "
          f"{p1} B (est {e1}); whole-step peak kernel run "
          f"{out['lm_kernel']['peak']} B, plain run {run['peak']} B; step_s "
          f"plain={run['step_s']}", flush=True)
    if not rel <= LM_LOSS_TOL:
        raise AssertionError(f"step-0 loss of the halo loop differs from "
                             f"the kernel run's by {rel}")
    if not p8 < p1:
        raise AssertionError("the row-chunked fwd+bwd peak is not below "
                             "the unchunked one")


def _vgg_leaf_sizes(torch):
    """Byte sizes of VGG-16's parameter leaves at 224² (a block of one of
    these sizes allocated in a backward is a gradient)."""
    from repro_torch.models.cnn import vgg
    from repro_torch.optim.adamw import tree_leaves
    _, p = vgg.init_vgg16(torch.Generator().manual_seed(0), (224, 224, 3),
                          device="meta")
    return {4 * t.numel() for t in tree_leaves(p)}


def _frame_is(f, module, *names):
    """Whether the Python frame ``f`` runs one of ``names`` in the port's
    module whose path ends in ``module``."""
    return f["filename"].endswith(module) and f["name"] in names


#: the port's functions that allocate the parameters: the new tree of an
#: SGD step and the seeded init
PARAMETER_FRAMES = (("optim/adamw.py", ("descend",)),
                    ("models/cnn/layers.py", ("_he_init", "init",
                                              "init_trunk")),
                    ("models/cnn/vgg.py", ("init_vgg16",)),
                    ("models/cnn/resnet.py", ("init_resnet50",)))
#: the port's functions that allocate SGD's momentum
OPTIMIZER_FRAMES = (("optim/adamw.py", ("sgd_init", "momentum")),)


#: classes of the blocks live at the peak
MEM_CLASSES = ("parameters", "optimizer state", "gradients",
               "max-pool indices", "activations saved by autograd",
               "row carries/caches", "cuDNN workspace",
               "output of the op at the peak", "backward temporaries",
               "other")


def _peak_blocks(trace):
    """Replay an allocator trace: the blocks live when the allocated total
    was highest, with the index of that event, and the peak."""
    live, total, peak, at, best = {}, 0, -1, 0, {}
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            live[e["addr"]] = (i, e)
            total += e["size"]
            if total > peak:
                peak, at, best = total, i, dict(live)
        elif e["action"] == "free_completed" and e["addr"] in live:
            total -= live.pop(e["addr"])[1]["size"]
    return best, at, peak


def _classify_peak(trace, saved, param_sizes):
    """Bytes per class of the blocks live at the replayed peak.

    A block is matched, in order: to its allocating Python frames in the
    port (SGD's state and new parameters, parameter init); to a tensor
    autograd saved (int64: max-pool indices), by its storage's address at
    the time it was saved; to a 2PS cache export or the row executor's
    placement; to cuDNN's workspace — allocated inside a convolution's
    call and freed within 3 allocator events after the peak, before any
    other allocation (cuDNN allocates it, runs, and frees it); to the
    output the op at the peak allocated just before it (same frames, at
    most 3 events earlier); to a frame in a backward (a block the size of
    a parameter leaf is a gradient, the rest activation gradients and
    recomputed rows); else other."""
    best, at, peak = _peak_blocks(trace)
    freed_soon = set()
    for e in trace[at + 1:at + 4]:
        if e["action"] == "alloc":
            break
        if e["action"] in ("free_requested", "free_completed"):
            freed_soon.add(e["addr"])
    # the allocation each saved tensor's storage came from: the last
    # alloc at its address before it was saved
    saved_by_alloc = {}
    allocs_at = {}
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            allocs_at.setdefault(e["addr"], []).append((e.get("time_us", 0),
                                                        i))
    for ptr, nbytes, is_int64, t_us in saved:
        cands = [i for tt, i in allocs_at.get(ptr, ()) if tt <= t_us]
        if cands:
            saved_by_alloc.setdefault(cands[-1], is_int64)

    def cls(i, e):
        frames = [f for f in e.get("frames", ())
                  if "repro_torch" in f.get("filename", "")]
        for f in frames:
            if any(_frame_is(f, m, *names) for m, names in OPTIMIZER_FRAMES):
                return "optimizer state"
            if any(_frame_is(f, m, *names) for m, names in PARAMETER_FRAMES):
                return "parameters"
        if i in saved_by_alloc:
            pool = any(f["name"] == "_pool" for f in frames)
            return "max-pool indices" if saved_by_alloc[i] and pool \
                else "activations saved by autograd"
        in_fn_bwd = any(f["name"] == "backward" for f in frames)
        for f in frames:
            if _frame_is(f, "core/twophase.py", "_run_row") \
                    and not in_fn_bwd:
                return "row carries/caches"
            if _frame_is(f, "exec/rowprog.py", "offload", "fetch", "place"):
                return "row carries/caches"
        in_bwd = in_fn_bwd or any(
            _frame_is(f, "launch/train.py", "_loss_grads") for f in frames)
        in_conv = any(f["name"] == "_conv" for f in frames) or in_bwd
        if e["addr"] in freed_soon and in_conv and i == at:
            return "cuDNN workspace"
        if at - 3 <= i < at and e.get("frames") == trace[at].get("frames"):
            return "output of the op at the peak"
        if in_bwd:
            return "gradients" if e["size"] in param_sizes \
                else "backward temporaries"
        return "other"

    by = {c: 0 for c in MEM_CLASSES}
    for addr, (i, e) in best.items():
        by[cls(i, e)] += e["size"]
    return peak, by


def phase_memory(torch, out, tmp):
    """Allocator snapshots of four VGG-16 runs: every block live at the
    peak classed by what allocated it, beside the terms the Planner priced
    (``plan_terms`` in the train log); then OverL N=4 against ``base``
    with and without the cuDNN workspace class."""
    import pickle
    from torch.autograd.graph import saved_tensors_hooks
    param_sizes = {-(-b // 512) * 512 for b in _vgg_leaf_sizes(torch)}
    snap_dir = os.path.join(ROOT, "build", "memory")
    os.makedirs(snap_dir, exist_ok=True)
    runs = {}
    for name, flags in (("base", ["--strategy", "base"]),
                        ("overlap", ["--strategy", "overlap", "--rows",
                                     "4"]),
                        ("overlap_h", ["--strategy", "overlap_h"]),
                        ("budget", ["--budget-gb", str(BUDGET_GB)])):
        saved = []

        def pack(t):
            st = t.untyped_storage()
            saved.append((st.data_ptr(), st.nbytes(),
                          t.dtype == torch.int64, time.time_ns() // 1000))
            return t

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        # live before the recording starts, so in no trace event
        before = torch.cuda.memory_allocated()
        torch.cuda.memory._record_memory_history(max_entries=2_000_000,
                                                 stacks="python")
        try:
            with saved_tensors_hooks(pack, lambda t: t):
                run = _train(torch, tmp, f"mem_{name}", *flags, steps=2)
            snap = torch.cuda.memory._snapshot()
        finally:
            torch.cuda.memory._record_memory_history(enabled=None)
        path = os.path.join(snap_dir, f"vgg16_{name}.pickle")
        with open(path, "wb") as f:
            pickle.dump({"snapshot": snap, "saved": saved}, f)
        trace = snap["device_traces"][0]
        replay_peak, by = _classify_peak(trace, saved, param_sizes)
        est = run["plan"]["est_bytes"]
        terms = run["plan_terms"]
        if sum(terms.values()) != run["plan"]["est_bytes_per_device"]:
            raise AssertionError(f"memory {name}: the plan's terms {terms} "
                                 f"do not sum to its estimate {est}")
        runs[name] = {"peak": run["peak"], "replay_peak": replay_peak,
                      "plan_terms": terms,
                      "before_recording": before,
                      "unattributed": run["peak"] - replay_peak - before,
                      "classes": by, "est": est,
                      "plan": f"{run['plan']['engine']} "
                              f"N={run['plan']['n_rows']}",
                      "events": len(trace), "snapshot": path,
                      "saved_tensors": len(saved)}
        print(f"  memory {name} ({runs[name]['plan']}): peak "
              f"{run['peak']} B = replayed {replay_peak} B over "
              f"{len(trace)} events + {before} B live before the recording"
              f" + {runs[name]['unattributed']} B unattributed; plan est "
              f"{est}: " + ", ".join(f"{k} {v}" for k, v in terms.items()),
              flush=True)
        for c in MEM_CLASSES:
            print(f"    {c:48s} {by[c]:>14d} B "
                  f"({100 * by[c] / max(1, replay_peak):5.1f} %)",
                  flush=True)
    # the paper's claim that OverL peaks below Base holds on the card by a
    # margin that cuDNN's workspace choice can erase: show both
    b, o = runs["base"], runs["overlap"]
    ws = "cuDNN workspace"
    print(f"  OverL N=4 against base: peak {o['peak']} vs {b['peak']} B "
          f"({b['peak'] - o['peak']} B below, "
          f"{100 * (b['peak'] - o['peak']) / b['peak']:.3f} %); cuDNN "
          f"workspace at the peak {o['classes'][ws]} vs {b['classes'][ws]}"
          f" B; without it {o['peak'] - o['classes'][ws]} vs "
          f"{b['peak'] - b['classes'][ws]} B", flush=True)
    out["memory"] = runs
    print("memory: snapshots under build/memory/ "
          + ", ".join(f"{n} peak {r['peak']}" for n, r in runs.items()),
          flush=True)


#: device-time categories of a profiled step
PROFILE_CATEGORIES = ("copies", "conv2d_rows", "forward", "row_recompute",
                      "cudnn_backward", "backward_other", "optimizer",
                      "other")
#: kernel-name fragments of cuDNN's convolutions (implicit GEMM, FFT and
#: Winograd engines, their layout transforms)
CUDNN_NAMES = ("cudnn", "xmma", "fft", "dse::", "gemm", "dgrad", "wgrad",
               "pointwise_mult_and_sum_complex", "winograd")


def _op_category(name, cat, phase):
    """The category of one device operation: copies and ``conv2d_rows`` by
    name; else by the innermost trainer or executor range its launch fell
    in (``row_recompute`` inside the backward), the backward's split into
    cuDNN's kernels and the rest."""
    n = name.lower()
    if cat != "kernel" or "copy" in n or "catarray" in n:
        return "copies"
    if "conv2d_rows" in n and phase != "row_recompute":
        return "conv2d_rows"
    if phase == "backward":
        return "cudnn_backward" if any(t in n for t in CUDNN_NAMES) \
            else "backward_other"
    return phase if phase in PROFILE_CATEGORIES else "other"


def _chrome_step_split(path, step):
    """One step's split from a torch.profiler Chrome trace: host time of
    the ``train_step <step>`` range and of its data / forward / backward /
    optimizer ranges (the rest is the loss read, which waits for the
    device), device-busy time of the kernels, copies and sets launched
    inside it (union of their intervals), kernel launches, device time by
    category (:data:`PROFILE_CATEGORIES`) and the 10 device operations that
    took longest."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and "dur" in e]
    t0, t1 = next((e["ts"], e["ts"] + e["dur"]) for e in ranges
                  if e["name"] == f"train_step {step}")
    inner = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in ranges
             if e["name"] in ("data", "forward", "backward", "optimizer",
                              "row_recompute") and t0 <= e["ts"] <= t1]
    launch_ts = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") \
                and "correlation" in e.get("args", {}):
            launch_ts[e["args"]["correlation"]] = e["ts"]
    dev = []
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        lt = launch_ts.get(e.get("args", {}).get("correlation"))
        if lt is None or not t0 <= lt <= t1:
            continue
        # the innermost range holding the launch: the latest to start
        holding = [(a, name) for a, b, name in inner if a <= lt <= b]
        phase = max(holding)[1] if holding else "other"
        dev.append((e["ts"], e["ts"] + e["dur"], e["name"],
                    _op_category(e["name"], e["cat"], phase),
                    e["cat"] == "kernel"))
    busy, end = 0.0, -1.0
    for a, b, *_ in sorted(dev):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name, by_cat = {}, {c: 0.0 for c in PROFILE_CATEGORIES}
    for a, b, name, c, _ in dev:
        n, d = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, d + b - a)
        by_cat[c] += b - a
    host = {}
    for a, b, name in inner:
        if name != "row_recompute":
            host[name] = host.get(name, 0.0) + b - a
    host["loss_read"] = (t1 - t0) - sum(host.values())
    return {"host_us": t1 - t0, "host_phase_us": host,
            "device_busy_us": busy,
            "launches": sum(1 for d in dev if d[4]),
            "device_ops": len(dev), "category_us": by_cat,
            "top": sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]}


def phase_profile(torch, out, tmp):
    """torch.profiler over one steady step (the second of two) of four
    VGG-16 engines, through the trainer's --torch-profile."""
    runs = {}
    for name, flags in (("base", ["--strategy", "base"]),
                        ("overlap", ["--strategy", "overlap", "--rows",
                                     "4"]),
                        ("twophase_h", []),
                        ("overlap_cuda", ["--strategy", "overlap", "--rows",
                                          "4", "--kernel", "cuda"])):
        prof_dir = os.path.join(ROOT, "build", "profile", f"vgg16_{name}")
        run = _train(torch, tmp, f"prof_{name}", *flags, "--torch-profile",
                     prof_dir, steps=2)
        split = _chrome_step_split(os.path.join(prof_dir, "trace.json"), 1)
        split["plan"] = f"{run['plan']['engine']} N={run['plan']['n_rows']}"
        runs[name] = split
        host, busy = split["host_us"], split["device_busy_us"]
        print(f"  profile {name} ({split['plan']}), step 1: host wall "
              f"{host / 1e3:.3f} ms (" + ", ".join(
                  f"{k} {v / 1e3:.3f}"
                  for k, v in split["host_phase_us"].items())
              + f"), device busy {busy / 1e3:.3f} ms "
              f"({100 * busy / host:.1f} %), {split['launches']} kernel "
              f"launches ({split['device_ops']} device ops); device ms by "
              f"category: " + ", ".join(
                  f"{k} {v / 1e3:.3f}"
                  for k, v in split["category_us"].items()), flush=True)
        for op, (n, us) in split["top"]:
            print(f"    {us / 1e3:9.3f} ms x{n:<5d} {op[:110]}", flush=True)
    out["profile"] = runs
    print("profile: Chrome traces under build/profile/", flush=True)


def phase_autotune(torch, out, tmp):
    """CostTable.calibrate, the plan cache through the trainer (miss, then
    a hit with no solve), the costed --budget-gb 1.0 plan beside its step,
    and autotune_kernel over each kernel's tiles; each winner is launched
    and held against its plain version."""
    from repro_torch.exec import CostTable, ExecutionPlan, Planner
    from repro_torch.exec.planner import kernelize_plan
    from repro_torch.kernels import conv2d_rows as cr
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.kernels import swa_attention as sw
    from repro_torch.models.cnn import vgg

    t0 = time.time()
    table = CostTable.calibrate()
    print(f"  calibrate ({time.time() - t0:.2f} s): {table.fingerprint} "
          f"fp32 matmul {table.flops_per_s / 1e12:.3f} TFLOP/s, H2D "
          f"{table.h2d_bytes_per_s / 1e9:.3f} GB/s, D2H "
          f"{table.d2h_bytes_per_s / 1e9:.3f} GB/s, row overhead "
          f"{table.row_overhead_us:.2f} us (version {table.version()})",
          flush=True)
    res = {"table": table.to_dict()}

    cache = os.path.join(tmp, "plan_cache")
    cached = []
    for i in range(2):
        run = _train(torch, tmp, f"cache{i}", "--budget-gb", str(BUDGET_GB),
                     "--plan-cache", cache, steps=2)
        cached.append(run)
    c0, c1 = cached[0]["counters"], cached[1]["counters"]
    if not (c0.get("plancache.miss") == 1 and c0.get("planner.solves", 0)
            >= 1 and c1.get("plancache.hit") == 1
            and "planner.solves" not in c1):
        raise AssertionError(f"plan cache: counters {c0} then {c1}")
    if cached[0]["plan"] != cached[1]["plan"]:
        raise AssertionError("the cache hit replayed another plan")
    plan = cached[0]["plan"]
    pred = plan["extras"]["predicted_step_us"]
    res["costed"] = {"plan": plan, "predicted_step_us": pred,
                     "step_s": [r["step_s"] for r in cached],
                     "peak": cached[0]["peak"]}
    print(f"  plan cache: miss (planner.solves "
          f"{c0.get('planner.solves')}), then hit (no solve); costed "
          f"--budget-gb {BUDGET_GB}: {plan['engine']} N={plan['n_rows']} "
          f"residency={(plan.get('residency') or {}).get('default')} est "
          f"{plan['est_bytes']} peak {cached[0]['peak']}; predicted "
          f"{pred / 1e3:.3f} ms a step, measured steady "
          f"{cached[0]['step_s'][-1] * 1e3:.3f} / "
          f"{cached[1]['step_s'][-1] * 1e3:.3f} ms", flush=True)

    def report(what, tuned, times):
        print(f"  autotune {what}: " + ", ".join(
            f"{k} {v:.1f} us" for k, v in times) + f" -> {tuned.kernel} "
            f"({tuned.get('autotune')})", flush=True)

    # conv2d_rows: VGG-16's overlap_cuda plan, the trunk's batch-1 forward
    mods = vgg.vgg16_modules(1.0)
    planner = Planner(mods, (224, 224, 3), TRAIN_BATCH)
    timer = planner._default_kernel_timer()
    times = []

    def conv_timer(c):
        us = timer(c)
        times.append((f"block_h={c.kernel.block_h}", us))
        return us

    tuned = planner.autotune_kernel(planner.plan("overlap", 4),
                                    time_fn=conv_timer)
    if tuned.engine != "overlap_cuda":
        raise AssertionError(f"conv autotune: {tuned.describe()}")
    report("conv2d_rows (VGG-16 batch-1 forward)", tuned, times)
    bh = tuned.kernel.block_h
    x, w = _inputs(torch, CHECK_BATCH, 56, 56, 128, 256, 3, 300)
    err = float((cr.conv2d_rows(x, w, stride=1, padding=1, block_h=bh)
                 - cr.conv2d_rows_plain(x, w, 1, 1, bh)).abs().max())
    scale = float(cr.conv2d_rows_plain(x, w, 1, 1, bh).abs().max())
    if not err <= KERNEL_TOL * scale:
        raise AssertionError(f"conv winner block_h={bh}: err {err}")
    res["conv"] = {"times": times, "winner": bh, "err": err}

    # swa_attention: Gemma's local layer, timed by CUDA events
    cfg = _gemma12(torch)
    swa_plan = Planner.for_model(cfg, LM_BATCH, LM_SEQ, kernel="cuda")
    q, k, v = _swa_case(torch, LM_BATCH, cfg.n_heads, LM_SEQ, cfg.head_dim,
                        torch.bfloat16, 0)
    window = cfg.sliding_window
    times = []

    def swa_timer(c):
        ms = _timed_ms(torch, lambda: sw.swa_attention(
            q, k, v, window=window, bq=c.kernel.bq, bk=c.kernel.bk),
            iters=10)
        times.append((f"bq={c.kernel.bq} bk={c.kernel.bk}", ms * 1e3))
        return ms * 1e3

    tuned = planner.autotune_kernel(swa_plan, time_fn=swa_timer)
    if tuned.engine != "seq_swa_cuda":
        raise AssertionError(f"swa autotune: {tuned.describe()}")
    report("swa_attention (Gemma local layer, bf16)", tuned, times)
    got = sw.swa_attention(q, k, v, window=window, bq=tuned.kernel.bq,
                           bk=tuned.kernel.bk).float()
    want = sw.swa_attention_plain(q, k, v, window, tuned.kernel.bq,
                                  tuned.kernel.bk).float()
    atol, rtol = SWA_GEMMA_BF16_TOL
    if not bool(((got - want).abs() <= atol + rtol * want.abs()).all()):
        raise AssertionError("swa winner disagrees with its plain version")
    res["swa"] = {"times": times, "winner": [tuned.kernel.bq,
                                             tuned.kernel.bk],
                  "plan_tiles": [swa_plan.kernel.bq, swa_plan.kernel.bk],
                  "err": float((got - want).abs().max())}
    del q, k, v, got, want

    # ssd_scan: Zamba2's Mamba2 widths
    Bt, S, H, P, N = SSD_SHAPE
    ssd_plan = kernelize_plan(ExecutionPlan.explicit(
        "seq_ssd_cuda", seq=S, ssm_state=N), "cuda")
    ins = _ssd_inputs(torch, *SSD_SHAPE, seed=20)
    times = []

    def ssd_timer(c):
        ms = _timed_ms(torch, lambda: sc.ssd_scan(*ins, chunk=c.kernel.chunk),
                       iters=10)
        times.append((f"chunk={c.kernel.chunk}", ms * 1e3))
        return ms * 1e3

    # the sequence pricers look only at the plan, not the trunk
    tuned = planner.autotune_kernel(ssd_plan, time_fn=ssd_timer)
    if tuned.engine != "seq_ssd_cuda":
        raise AssertionError(f"ssd autotune: {tuned.describe()}")
    report("ssd_scan (Zamba2 Mamba2 widths)", tuned, times)
    chunk = tuned.kernel.chunk
    err = float((sc.ssd_scan(*ins, chunk=chunk)
                 - sc.ssd_scan_plain(*ins, chunk=chunk)).abs().max())
    if not err <= SSD_ATOL:
        raise AssertionError(f"ssd winner chunk={chunk}: err {err}")
    res["ssd"] = {"times": times, "winner": chunk,
                  "plan_chunk": ssd_plan.kernel.chunk, "err": err}
    out["autotune"] = res
    print(f"autotune: winners conv block_h={bh}, swa bq/bk="
          f"{res['swa']['winner']} (plan {res['swa']['plan_tiles']}), ssd "
          f"chunk={chunk} (plan {res['ssd']['plan_chunk']}); each launched "
          f"and held against its plain version", flush=True)


def phase_obs(torch, out, tmp):
    """The audit gate over every traced run, and the executor's counters
    of twophase_h N=8 under host residency against the plan: its rows and
    the SD bytes the Planner priced (``plan_sd`` in the train log) less
    the input level's, which each row slices from its segment's input."""
    traces = sorted(os.path.join(tmp, "obs", f)
                    for f in os.listdir(os.path.join(tmp, "obs"))
                    if f.endswith(".jsonl"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis.audit",
                        "--check", *traces], cwd=ROOT,
                       env=dict(os.environ,
                                PYTHONPATH=os.path.join(ROOT, "src")),
                       capture_output=True, text=True, timeout=300)
    print(r.stdout, flush=True)
    if r.returncode:
        raise AssertionError(f"analysis.audit --check exit {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    host = out["residency"]["host"]
    steps = len(host["losses"])
    segs = host["plan"]["segments"]
    sd = host["plan_sd"]
    want = {"rowprog.fp_rows": steps * sum(n for _, _, n in segs),
            "rowprog.bp_rows": steps * sum(n for _, _, n in segs),
            "rowprog.prefetches": steps * sum(n - 1 for _, _, n in segs),
            "rowprog.offload_bytes": steps * (sd["sd_bytes"]
                                              - sd["input_level_bytes"])}
    want["rowprog.prefetch_bytes"] = want["rowprog.offload_bytes"]
    got = {k: host["counters"].get(k) for k in want}
    print(f"obs: {len(traces)} traces gated; twophase_h N=8 host counters "
          f"{got} (plan implies {want})", flush=True)
    if got != want:
        raise AssertionError(f"host residency counters {got} != {want}")
    out["obs"] = {"traces": len(traces), "counters": got}


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
                  ("train_rows", lambda: phase_train_rows(torch, out, tmp)),
                  ("train_2ps", lambda: phase_train_2ps(torch, out, tmp)),
                  ("residency", lambda: phase_residency(torch, out, tmp)),
                  ("budget", lambda: phase_budget(torch, out, tmp)),
                  ("train_resnet", lambda: phase_train_resnet(torch, out,
                                                              tmp)),
                  ("kernel_swa", lambda: phase_kernel_swa(torch, out)),
                  ("kernel_ssd", lambda: phase_kernel_ssd(torch, out)),
                  ("train_lm_kernel", lambda: phase_train_lm_kernel(
                      torch, out, tmp)),
                  ("train_lm_rows", lambda: phase_train_lm_rows(
                      torch, out, tmp)),
                  ("memory", lambda: phase_memory(torch, out, tmp)),
                  ("profile", lambda: phase_profile(torch, out, tmp)),
                  ("autotune", lambda: phase_autotune(torch, out, tmp)),
                  ("obs", lambda: phase_obs(torch, out, tmp))]
        for name, fn in phases:
            t0 = time.time()
            try:
                fn()
                print(f"  ({name} took {time.time() - t0:.1f} s)",
                      flush=True)
            except Exception as e:  # report which phase failed, then stop
                import traceback
                traceback.print_exc()
                print(f"FAILED phase {name}: {e}", flush=True)
                return 1
    k, sw, sd = out["kernel"], out["swa"], out["ssd"]
    csrc = "src/repro_torch/kernels/csrc/"

    def row(name, replaces, launches, r, library_ms):
        return {"name": name, "route": "cuda", "source": f"{csrc}{name}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": library_ms}

    print(out["smi"])
    print(json.dumps({"kernels": [
        row("conv2d_rows", "src/repro/kernels/conv2d_rows.py:101",
            out["launches"] + out["resnet_launches"], k, k["library_ms"]),
        row("swa_attention", "src/repro/kernels/swa_attention.py:111",
            out["swa_launches"], sw, sw["library_ms"]),
        row("ssd_scan", "src/repro/kernels/ssd_chunk.py:78",
            sd["launches"], sd, None)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
