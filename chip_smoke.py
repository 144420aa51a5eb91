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
                224² x 3 -> 112² x 64, k 7, s 2, p 3).  Then
                ``dwconv_wgrad`` at ConvNeXt-B's four depthwise shapes at
                384² (batch 128: 96² x 128, 48² x 256, 24² x 512, 12² x
                1024; k 7, padding 3): its ``dw`` and ``db`` within 2e-6
                relative norm of a float64 sum (cuDNN's fp32 error
                printed beside it), timed beside its bound, its plain
                version and cuDNN's weight gradient
                (``aten.convolution_backward``, the yardstick the port no
                longer calls).  Then ``dwconv2d`` at the same shapes,
                forward (with a bias) and data gradient (the flipped conv
                of the output's gradient), and on rows of stage 1's map
                read in place: within 2e-6 relative norm of a float64 sum,
                two launches bit-equal, timed beside its bound, its plain
                version and cuDNN's (``F.conv2d``, and
                ``aten.convolution_backward`` for ``dx`` alone), with each
                pass's 36-conv sum.  Then one ConvNeXt-B training step at
                384² (batch 4, ``twophase_h`` N=8), in which every depthwise
                backward must launch ``dwconv_wgrad``, and every depthwise
                forward call and every depthwise backward that owes ``dx``
                ``dwconv2d``, with no copy.
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
   pipeline     the row pipeline: VGG-16 ``--strategy
                pipeline_rows --rows 4`` (N=4 rows through S=2 stages,
                0:16|16:31), 3 steps under ``--residency device``,
                ``host`` and ``recompute``, then ResNet-50 once (2 steps,
                lr 1e-5).  Each run's plan, step-0 loss against its
                ``base`` (1e-4 relative), peak beside
                ``estimate_staged``'s estimate, audit ratio (in
                ``train_step``'s [0.25, 4.0]), ``rowprog.*`` /
                ``pipeline.*`` counters, bubble gauge and step times;
                the three residencies' losses within 1e-6 (under cuDNN's
                deterministic algorithms: the default ones sum with
                atomics), and the host run's offloaded bytes equal to the
                stash the plan's OverL chains imply; steady steps against
                OverL N=4's.
   mesh         two trainer ranks on the one card in a ``gloo``
                group (NCCL refuses two ranks on one device), VGG-16 at
                224², batch 32 (16 a rank): ``--mesh data=2`` under
                ``overlap_cuda`` N=4 (``conv2d_rows`` runs under the shard
                wrapper) and under ``twophase_h``, 2 steps each, and
                ``--mesh data=1,model=2`` under ``pipeline_rows`` N=4 (S=2
                from the model extent; column-parallel convs), 1 step.
                Each step-0 loss within 1e-4 relative of its
                single-process run; each rank's peak printed.  NCCL stays
                unverified (the line says so).
   ckpt         VGG-16's full-width parameters and SGD momentum
                through ``store.save`` / ``store.restore`` on the card,
                every leaf bit-equal, seconds and bytes printed; then
                ``train_lm --save`` on xLSTM-125M (full preset, seq 256,
                2 steps, ``--residency device``), its parameters, AdamW
                state and plan restored and the third step taken through
                ``make_train_step``: loss within 1e-6 relative of an
                uninterrupted 3-step run's third, the plan equal.
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
   train_lm_ssm     Zamba2-7B at published widths (d 3584, Mamba2 H 32,
                P 224, N 64, the shared attention block 32 x 112, d_ff
                14336), depth cut 81 -> 12 (10 Mamba2, the shared block at
                layers 6 and 12), batch 1, seq 4096 (16 SSD chunks): 3
                steps under the config's plan (``--residency device``,
                ``seq_carry_scan`` N=8), 2 under ``host`` and 2 under
                ``recompute``.  Every step's loss and step 0's gradient
                norm within 1e-6 relative of device's; host's
                peak no higher than device's; the host run's ``rowprog.*``
                counters equal 2 steps x 10 layers x 16 chunks placed states
                of 1 x 32 x 224 x 64 fp32 (1,835,008 B) each way; audit
                ratios in ``train_step_lm``'s [0.2, 20].  Then xLSTM-125M
                at published widths and full depth (12 layers, d 768), seq
                1024 (4 chunks), one step under host and one under device
                residency, the same loss, peak and audit checks.  For
                each model (xLSTM cut to 6 layers), one device-resident
                fwd+bwd on each carried scan path, the checkpointed chunk
                loop (the default) and the row-program executor: its host
                seconds, and its kernel launches counted with
                torch.profiler.
   train_lm_dense   llama3_2_3b and qwen1_5_4b at published widths, 8
                layers, batch 1, seq 4096, 2 steps each through
                ``--budget-gb 0.05`` (``seq_chunked``, N from
                ``Planner.for_model``); qwen1_5_110b at published widths,
                2 layers, as a fwd+bwd probe with no optimizer state (one
                layer with fp32 AdamW is ~62 GB of xi, so the trainer
                cannot run it on one card; the line says so).
   train_lm_moe     DeepSeek-MoE-16B at published widths (64 experts
                top-6 of width 1408, 2 shared), 4 of 28 layers, batch 1,
                seq 4096, 2 steps under the config's plan (``--residency
                device``: ``seq_chunked`` N=8), its ``load_balance`` and
                ``z_loss`` printed and positive; Qwen3-MoE at published
                widths (128 experts top-8), 2 of 94 layers, as a fwd+bwd
                probe with no optimizer: finite loss and gradient norm,
                the peak beside the plan's estimate.
   train_lm_vlm_encdec  LLaVA-NeXT-34B at published widths, 4 of 60
                layers, 2880 zero patch embeddings before 1216 text tokens
                (4096 positions, which the plan's N divides), 2 steps;
                SeamlessM4T-medium at full depth (12 + 12 layers), seq 4096
                frames and tokens, 3 steps; both under the config's plan.
                Every train run of both phases has its audit in
                ``train_step_lm``'s band.
   mesh_lm      the LM's sharded train step: two ``train_lm`` ranks on
                the one card in a ``gloo`` group, each holding only its
                shard of the parameters and AdamW moments, seq 4096, 2
                steps (``MESH_LM_RUNS``): Gemma-3 4B at 12 layers, batch
                1, ``--mesh data=1,model=2 --kernel cuda`` (heads, ff and
                the vocabulary split; held to train_lm_kernel's run);
                Gemma-3 4B at 6 layers, batch 2, ``--mesh data=2`` (held to
                a one-process run of that depth and batch); DeepSeek-MoE-16B
                at 2 layers, ``--mesh data=1,model=2`` (its experts split;
                held to a one-process run).  Each rank's step-0 loss within
                1e-4 relative of its one-process run's, ``swa_attention``
                launched local layers × steps times on every Gemma rank,
                every rank's audit in ``train_step_lm``'s band; each rank's
                peak beside the single run's, step seconds and the bytes
                its collectives sent.  NCCL stays unverified.
   serve        serving at published widths and full depth through
                ``repro_torch.launch.serve``'s functions, each run traced
                with its artefact written (``--trace``/``--out`` into the
                ``obs`` directory) and its pool audited in the serve_pool
                band [0.95, 1.10].  Gemma-3 4B (34 layers), ``--budget-gb
                2``, 24 Poisson requests (prompts of 256, 512 and 1024
                tokens, 64 generated each): ``full`` (14 slots),
                ``paged_kv`` at the same slot count, ``quant_kv`` at its
                own, static mode, ``--decode-batch 4`` on the card and
                under ``--decode-residency host``, and 8 bursty requests
                with 3 priority levels and row-chunked prefills in 4 slots,
                with and without ``--preemptible-prefill`` (which must
                preempt).  Gates, bit for bit:
                paged and static give ``full``'s greedy streams, host
                residency the device cohort run's, preemptible prefill
                the plain bursty run's (equal slot counts, so equal decode
                shapes); printed only: ``quant_kv``'s and the cohort runs'
                agreement with ``full``, and a one-slot sequential loop's
                with the top-2 logit margin at its first mismatch (other
                batch shapes may round otherwise in bf16).  The first
                token's logits of a 1024-token prompt prefilled in 16 row
                chunks against unchunked, within SERVE_CHUNKED_TOL.  Then
                prefill ms per prompt length, the 14-slot decode step's ms,
                launches and device time, and the 4-slot cohort tick under
                device and host residency.  Zamba2-7B (81 layers), 8
                requests: decode batch 4 on the card and under host
                residency, identical streams.  xLSTM-125M (12 layers) under
                ``full``; ``paged_kv`` must raise.  Then the other
                families, each with its decode step timed alone (slots,
                ms, launches, device-busy ms, top kernels; for MoE the
                bound of casting every expert weight to bf16 each step):
                DeepSeek-MoE-16B at full depth (28 layers), 8 requests of
                128-512 prompt and 16 generated tokens; LLaVA-NeXT-34B, 24
                of 60 layers, 4 requests of 256 tokens with 2880 patch
                embeddings each; SeamlessM4T-medium at full depth, 8
                requests with frames as long as ``--prompt-len`` (the
                pool's enc_len), whose ``paged_kv`` pool must raise
                ``ValueError``; Qwen3-MoE, 4 of 94 layers, 4 requests.
   mesh_serve   sharded serving on two ``gloo`` ranks sharing the card
                (TF32 off).  (A) ``serve --mesh data=2`` through
                ``repro_torch.launch.serve``'s functions: the serve
                phase's Gemma-3 4B (34 layers) traffic and ``full`` pool,
                its one-process slot count pinned (14, 7 a rank); every
                rank's greedy streams bit-identical to the one-process
                ``full`` run's, each rank's pool bytes half of that run's
                (1e-3), the summed audit in [0.95, 1.10]; tok/s, the
                rank's 7-slot decode step ms, the gloo bytes and calls.
                Streams differ across decode widths in bf16 (the serve
                phase's cohort runs show it), so the gate is bit-identity
                with a one-process run at the rank's width (7 slots); the
                14-slot ``full`` run's agreement is printed.  (B)
                ``make_prefill_step(ctx=)`` and ``make_serve_step(ctx=)``
                over ``data=1,model=2``: batch 4, 512-token prompts, cache
                4096, 16 decode steps fed one process's greedy tokens,
                Gemma-3 4B (34 layers) then Zamba2-7B (12 layers), in the
                configs' bf16 and Zamba2 again with fp32 activations
                (``MESH_SERVE_STEPS``): logits within each run's tolerance
                of one process's relative to the largest |logit| (Gemma
                every step at SERVE_CHUNKED_TOL; Zamba2's bf16 prefill at
                it, every fp32 step at 1e-4).  Zamba2's Mamba2 state
                carries each step's bf16 rounding on, so its bf16 decode
                steps are held to exact arithmetic instead: one process
                with fp32 activations, fed the same tokens, is the truth,
                and every step's rank logits lie within
                MESH_SERVE_TRUTH_FACTOR times the one-process bf16
                logits' distance from it.  Each bf16 run's drift is
                printed beside a one-process run's that only splits its
                batch in two, greedy agreement beside the top-2 margin,
                each rank's parameter and cache bytes beside one
                process's, ms a step.
   dryrun       the dry run (no card): (a) ``python -m
                repro_torch.launch.dryrun`` for ``gemma3_4b x decode_32k``
                (the position-split decode) and ``deepseek_moe_16b x
                train_4k``, each on the 16x16 mesh, in a subprocess that
                sees no card (``CUDA_VISIBLE_DEVICES`` empty); each record
                must end ``ok``; its traced peak per rank against the
                card's 80 GB, traced and analytic FLOPs and the H100
                terms are printed.  (b) train_lm_kernel's Gemma-3 4B step
                (12 layers, batch 1, seq 4096) built with no plan on one
                device, traced on ``meta`` (``obs.audit.trace_step``) and
                run on the card under ``FlopCounterMode`` and
                ``measure_step``: the FLOP counts must be equal; the
                traced peak over ``cuda_max_allocated`` (a ``dryrun``
                audit, recorded, not gated) and the step's seconds against
                the H100 roofline's max(t_compute, t_memory) of the traced
                counts are printed.
   examples     the port's four examples (``examples/torch_*.py``), one
                after another, each a subprocess on the card run as its
                reference's docstring invokes it (``train_lm_100m`` with
                ``--steps 100``: its default 300 do not fit the phase's
                150 s; its checkpoint into the temporary directory): each
                must exit 0 and end with its ``<name> OK`` line.
                Printed: the quickstart's traced temporaries and measured
                peak per engine and its final loss; the
                large-image plan, its predicted step and each step's peak
                against the plan's ``est_bytes`` (recorded, not gated);
                serving's tok/s, decode steps and most concurrent
                requests; the 100M model's first -> final loss, ms a step
                and whether it printed ``LEARNED``.  No kernel is on an
                example's path (in the reference neither).

Every train run above carries ``--trace`` and ``--metrics-out`` (into a
temporary ``obs`` directory) and prints its step-0 ``plan audit:`` line.

10. memory      VGG-16 ``base``, ``overlap`` N=4, ``overlap_h`` N=8,
                ``--budget-gb 1.0`` and ``pipeline_rows`` N=4, 2 steps each, under
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
                trace and serve artefact (the reference's bands; the
                serve_pool band must appear), and the row executor's
                counters of ``twophase_h`` N=8 under host residency against
                the plan's rows and the SD bytes the Planner priced.

Then it prints the card's name and power limit (nvidia-smi), one JSON line
of per-kernel numbers (``conv2d_rows``' launches are train_kernel's 39 plus
train_resnet's 3), and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
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
#: ConvNeXt-B's depthwise 7x7 convs at 384², batch 128: (H, C, convs a
#: forward) per stage, and dwconv_wgrad's limit, the relative norm error of
#: dw and db against a float64 sum (fp32 sums in a fixed hierarchy)
DWCONV_SHAPES = [(96, 128, 3), (48, 256, 3), (24, 512, 27), (12, 1024, 3)]
DWCONV_BATCH, DWCONV_K = 128, 7
DWCONV_TOL = 2e-6
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
#: Zamba2-7B on the card: published widths, 12 of 81 layers (10 Mamba2,
#: the shared block at layers 6 and 12; fp32 AdamW of all 81 is over 100
#: GB), batch 1, seq 4096 (16 SSD chunks of 256); xLSTM-125M at full
#: depth, seq 1024 (4 chunks of 256), and at 6 layers for the two carried-
#: scan paths' fwd+bwd timing (its per-token loop makes each layer seconds;
#: the ratio of the two paths does not need all 12)
ZAMBA_LAYERS, ZAMBA_STEPS, XLSTM_SEQ, XLSTM_PATH_LAYERS = 12, 3, 1024, 6
#: the train_step_lm audit band (analysis/audit.py)
LM_AUDIT_BAND = (0.2, 20.0)
#: the dense configs on the card: published widths, 8 layers, batch 1,
#: seq 4096, through a --budget-gb plan; qwen1_5_110b as a 2-layer
#: forward + backward probe
DENSE_LAYERS, DENSE_BUDGET_GB, QWEN110_LAYERS = 8, 0.05, 2
#: the MoE, VLM and encoder-decoder families on the card, published
#: widths, batch 1, each cut by its bytes on one 80 GB card: the trainer's
#: in-place fp32 AdamW keeps 16 B a parameter, a fwd+bwd probe 8 B.
#: DeepSeek-MoE-16B 4 of 28 layers (2.77 B parameters, ~44 GB of state);
#: Qwen3-MoE 2 of 94 layers as a probe (6.2 B parameters, ~50 GB of
#: parameters and gradients, plus the bf16 expert casts autograd saves);
#: LLaVA-NeXT-34B 4 of 60 layers (~3.2 B, ~51 GB) with 2880 patch
#: embeddings and 1216 text tokens (4096 positions, which the plan's N
#: divides); SeamlessM4T-medium at full depth (12 + 12 layers, ~1 B)
MOE_LAYERS, MOE_STEPS, QWEN3_PROBE_LAYERS = 4, 2, 2
LLAVA_LAYERS, LLAVA_TEXT, LLAVA_STEPS = 4, 4096 - 2880, 2
SEAMLESS_STEPS = 3
#: serving at published widths and full depth, a 2 GiB pool budget:
#: Gemma-3 4B (34 layers), 24 Poisson requests with prompts of 256, 512
#: and 1024 tokens and 64 generated tokens each; the host-residency
#: cohort; Zamba2-7B (81 layers) and xLSTM-125M on smaller traffic
SERVE_BUDGET_GB = 2.0
SERVE_FLAGS = ["--requests", "24", "--traffic", "poisson", "--mixed-prompts",
               "--prompt-len", "1024", "--gen", "64"]
SERVE_COHORT = 4
ZAMBA_SERVE_FLAGS = ["--requests", "8", "--traffic", "poisson",
                     "--mixed-prompts", "--prompt-len", "512", "--gen", "16"]
XLSTM_SERVE_FLAGS = ["--requests", "6", "--traffic", "poisson",
                     "--mixed-prompts", "--prompt-len", "256", "--gen", "16"]
#: serving the other families in the same 2 GiB pool: DeepSeek-MoE-16B at
#: full depth (28 layers, 67.5 GB of fp32 parameters), LLaVA-NeXT-34B 24
#: of 60 layers (57 GB; each request carries 2880 patch embeddings),
#: SeamlessM4T-medium at full depth (frames as long as the prompt are the
#: pool's enc_len) and Qwen3-MoE 4 of 94 layers (45 GB)
MOE_SERVE_FLAGS = ["--requests", "8", "--traffic", "poisson",
                   "--mixed-prompts", "--prompt-len", "512", "--gen", "16"]
LLAVA_SERVE_LAYERS, QWEN3_SERVE_LAYERS = 24, 4
LLAVA_SERVE_FLAGS = ["--requests", "4", "--traffic", "poisson",
                     "--prompt-len", "256", "--gen", "16"]
SEAMLESS_SERVE_FLAGS = ["--requests", "8", "--traffic", "poisson",
                        "--mixed-prompts", "--prompt-len", "512", "--gen",
                        "16"]
QWEN3_SERVE_FLAGS = ["--requests", "4", "--traffic", "poisson",
                     "--mixed-prompts", "--prompt-len", "512", "--gen", "16"]
#: requests of the one-slot sequential loop held against the pooled run;
#: requests and pinned slots of the bursty pair (each prefill there runs in
#: row chunks): 4 slots fill, so a high-priority arrival evicts an
#: in-flight prefill (one preemption; the schedule does not depend on the
#: model's numbers)
SERVE_SEQ_REQUESTS, SERVE_BURSTY, SERVE_BURSTY_SLOTS = 2, 8, 4
#: the bursty runs' and the chunked-prefill gate's prefill budget, as a
#: share of ``Planner.for_model``'s unchunked estimate for the longest
#: prompt: at Gemma's widths it cuts a 1024-token prompt into 16 row chunks
#: (256: 2, 512: 4), so a preemptible prefill spans ticks
SERVE_PREFILL_SHARE = 0.99
#: |chunked - unchunked| / max |unchunked| of the first token's logits
#: of a 1024-token prompt in 16 row chunks (bf16 activations): about
#: twice the 7.716e-3 measured on an H100 80GB HBM3 at 700 W
SERVE_CHUNKED_TOL = 1.5e-2
#: the serve_pool audit band (analysis/audit.py)
SERVE_AUDIT_BAND = (0.95, 1.10)
#: the row pipeline on the card: VGG-16 at 224², batch 32, N=4 row
#: microbatches through S=2 stages (the default without a model axis), 3
#: steps under each residency; ResNet-50 once, 2 steps
PIPE_ROWS, PIPE_STEPS, PIPE_RESNET_STEPS = 4, 3, 2
#: the train_step audit band (analysis/audit.py)
TRAIN_AUDIT_BAND = (0.25, 4.0)
#: two ranks on the one card (gloo: NCCL refuses two ranks on one
#: device), VGG-16 at 224², batch 32 (16 a rank): (name, flags, steps, the
#: single-process run its step-0 loss is held to)
MESH_RUNS = [
    ("data2_overlap_cuda", ["--strategy", "overlap", "--rows", "4",
                            "--kernel", "cuda", "--mesh", "data=2"], 2,
     "kernel"),
    ("data2_twophase_h", ["--strategy", "twophase_h", "--mesh", "data=2"], 2,
     "twophase_h"),
    ("model2_pipeline", ["--strategy", "pipeline_rows", "--rows", "4",
                         "--mesh", "data=1,model=2"], 1, "pipeline"),
]
#: the group's own timeout, and how long the smoke waits for its ranks
MESH_GROUP_TIMEOUT_S, MESH_WAIT_S = 300, 420
#: the LM's sharded step on the card: two gloo ranks sharing it, each a
#: train_lm process at published widths, seq 4096, TF32 off:
#: (name, arch, layers, batch, flags, the one-process run it is held to).
#: Gemma-3 4B at 12 layers over the model axis (the train_lm_kernel run's
#: config); at 6 layers (5 local + 1 global), batch 2, over the data axis;
#: DeepSeek-MoE-16B at 2 layers over the model axis (its experts split)
MESH_LM_RUNS = [
    ("lm_model2", "gemma3_4b", LM_LAYERS, 1,
     ["--kernel", "cuda", "--mesh", "data=1,model=2"], "lm_kernel"),
    ("lm_data2", "gemma3_4b", 6, 2,
     ["--kernel", "cuda", "--mesh", "data=2"], "gemma6_b2"),
    ("moe_model2", "deepseek_moe_16b", 2, 1,
     ["--residency", "device", "--mesh", "data=1,model=2"], "moe2"),
]
MESH_LM_STEPS, MESH_LM_WAIT_S = 2, 600
#: sharded serving on the card, two gloo ranks sharing it: (A) the serve
#: phase's Gemma-3 4B traffic under ``--mesh data=2`` at its one-process
#: slot count; (B) the model-axis steps (``data=1,model=2``) at batch 4,
#: 512-token prompts, cache 4096, 16 decode steps, as (name, arch, layers,
#: activation dtype or None for the config's, tolerance, whether the
#: decode steps are held to an fp32 twin instead).  A recurrent state
#: carries each step's bf16 rounding into the next (Zamba2's drift grows
#: with the steps, 7.8e-3 to 2.8e-2 over 16 on an H100 80GB HBM3 at 700 W,
#: where fp32 on the CPU stays at 2e-6), so Zamba2's bf16 run gates its
#: prefill at the tolerance and each decode step against the truth of
#: one process in fp32 activations fed the same tokens: the ranks' logits
#: within MESH_SERVE_TRUTH_FACTOR times the one-process bf16 logits'
#: distance from it (sharding may round otherwise than one process, not
#: further from exact); an fp32-activation run gates every step
MESH_SERVE_STEPS = [
    ("gemma", "gemma3_4b", None, None, 1.5e-2, False),
    ("zamba", "zamba2_7b", 12, None, 1.5e-2, True),
    ("zamba_fp32", "zamba2_7b", 12, "float32", 1e-4, False)]
MESH_SERVE_TRUTH_FACTOR = 2.0
MESH_SERVE_BATCH, MESH_SERVE_PROMPT, MESH_SERVE_CACHE = 4, 512, 4096
MESH_SERVE_DECODES, MESH_SERVE_WAIT_S = 16, 600
#: the dry run's combos on the card's machine (16x16 mesh), and how long
#: their subprocesses may take
DRYRUN_COMBOS = (("gemma3_4b", "decode_32k"), ("deepseek_moe_16b", "train_4k"))
DRYRUN_WAIT_S = 240
#: how long one of the port's examples may take on the card, and the 100M
#: trainer's steps: its default 300 took 102.6 s of the phase's 161.1 s on
#: an H100 80GB HBM3 at 700 W (307 ms a step), over the phase's 150 s
EXAMPLE_WAIT_S = 120
EXAMPLE_LM_STEPS = 100
#: the LM checkpoint round trip: xLSTM-125M at its full preset, seq 256
CKPT_LM_ARCH, CKPT_LM_SEQ = "xlstm_125m", 256
CKPT_LM_TOL = 1e-6


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
    out["dwconv_wgrad"] = kernel_dwconv_wgrad(torch)
    out["dwconv2d"] = kernel_dwconv2d(torch)
    kernel_dwconv_step(torch, out)
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


def _rel_norm(got, want):
    return float((got.double() - want).norm() / want.norm())


def _convnext_step_dwconv_launches(torch):
    """``(dwconv_wgrad launches, depthwise backward ranges, dwconv2d
    launches, depthwise forward calls)`` of one ConvNeXt-B training step at
    384² on the main path (the benchmark cell's widths, depths and plan
    ``twophase_h`` N=8, batch 4), counted from a capture opened just before
    it; raises unless every depthwise backward launched ``dwconv_wgrad``,
    every depthwise forward call and every depthwise backward that owes
    ``dx`` launched ``dwconv2d`` once, and neither copied a tensor."""
    from repro_torch import obs
    from repro_torch.exec import Planner, build_apply
    from repro_torch.kernels import dwconv_wgrad as dk
    from repro_torch.models.cnn import convnext
    from repro_torch.models.cnn import layers
    from repro_torch.models.cnn.layers import flatten_params
    shape, batch = (384, 384, 3), 4
    mods, params = convnext.init_convnext(
        torch.Generator().manual_seed(0), shape, device="cuda")
    plan = Planner(mods, shape, batch).plan("twophase_h", 8)
    leaves, _ = flatten_params(params["trunk"])
    for t in leaves:
        t.requires_grad_(True)
    x = torch.randn((batch,) + shape, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(5))
    owes, backward = [], layers.conv_backward

    def spy(g, x, w, stride, padding, need, groups=1):
        if groups > 1:
            owes.append(need[0])
        return backward(g, x, w, stride, padding, need, groups)

    layers.conv_backward = spy
    try:
        with obs.profiling() as cap:
            loss = convnext.head_apply(params["head"], build_apply(mods, plan)(
                params["trunk"], x)).square().mean()
            torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
    finally:
        layers.conv_backward = backward
    bwd = sum(r.name == "dwconv" and r.attrs == {"phase": "bwd"}
              for r in cap.records)
    launches = cap.count("dwconv_wgrad")
    copies = cap.count("dwconv_wgrad.copies")
    if not (bwd > 0 and launches == dk.LAUNCHES * bwd and copies == 0):
        raise AssertionError(f"ConvNeXt-B step: {launches} dwconv_wgrad "
                             f"launches and {copies} copies for {bwd} "
                             f"depthwise backward ranges")
    fwd = cap.count("conv.depthwise_calls")
    conv_launches = cap.count("dwconv2d")
    if not (fwd > 0 and len(owes) == bwd
            and conv_launches == fwd + sum(owes)
            and cap.count("dwconv2d.copies") == 0):
        raise AssertionError(
            f"ConvNeXt-B step: {conv_launches} dwconv2d launches and "
            f"{cap.count('dwconv2d.copies')} copies for {fwd} depthwise "
            f"forward calls and {sum(owes)} of {len(owes)} backward ranges "
            f"owing dx")
    return launches, bwd, conv_launches, fwd


def kernel_dwconv_wgrad(torch):
    """``dwconv_wgrad`` through its wrapper at ConvNeXt-B's depthwise
    shapes: checked against a float64 sum (with its launches and no copy)
    and timed beside its bound, its plain version and cuDNN's weight
    gradient; the totals weigh each shape by its convs a forward.  Then
    one ConvNeXt-B step on the main path, whose launches it counts."""
    from repro_torch import obs
    from repro_torch.kernels import dwconv_wgrad as dk
    from repro_torch.kernels import ops
    k, p, n = DWCONV_K, DWCONV_K // 2, DWCONV_BATCH
    rows, worst = [], 0.0
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    ops_ms = bytes_ms = 0.0
    for i, (h, c, mult) in enumerate(DWCONV_SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(400 + i)
        x, g = (torch.randn((n, h, h, c), device="cuda", generator=gen)
                .permute(0, 3, 1, 2) for _ in range(2))
        w = torch.randn((k, k, 1, c), device="cuda",
                        generator=gen).permute(3, 2, 0, 1)
        with obs.profiling() as cap:
            dw, db = ops.dwconv_wgrad(g, x, (p, p), k)
            torch.cuda.synchronize()
        if (cap.count("dwconv_wgrad") != dk.LAUNCHES
                or cap.count("dwconv_wgrad.copies")):
            raise AssertionError(
                f"dwconv_wgrad {h}x{h}x{c}: "
                f"{cap.count('dwconv_wgrad')} launches and "
                f"{cap.count('dwconv_wgrad.copies')} copies a call")
        ref_w, ref_b = dk.dwconv_wgrad_plain(g.double(), x.double(), (p, p),
                                             k)
        lib = torch.ops.aten.convolution_backward(
            g, x, w, [c], [1, 1], [p, p], [1, 1], False, [0, 0], c,
            [False, True, True])
        err = max(_rel_norm(dw, ref_w), _rel_norm(db, ref_b))
        lib_err = max(_rel_norm(lib[1], ref_w), _rel_norm(lib[2], ref_b))
        del ref_w, ref_b, lib
        worst = max(worst, err)
        if not err <= DWCONV_TOL:
            raise AssertionError(f"dwconv_wgrad {h}x{h}x{c}: relative norm "
                                 f"error {err} > {DWCONV_TOL}")
        t = {"ms": _timed_ms(torch, lambda: ops.dwconv_wgrad(g, x, (p, p),
                                                            k)),
             "plain_ms": _timed_ms(torch, lambda: dk.dwconv_wgrad_plain(
                 g, x, (p, p), k), iters=2, warmup=1),
             "library_ms": _timed_ms(
                 torch, lambda: torch.ops.aten.convolution_backward(
                     g, x, w, [c], [1, 1], [p, p], [1, 1], False, [0, 0], c,
                     [False, True, True]), iters=3, warmup=1)}
        elems = n * h * h * c
        t_ops = 1e3 * 2 * k * k * elems / PEAK_FP32_FLOPS
        t_bytes = 1e3 * 4 * (2 * elems + k * k * c) / PEAK_HBM_BYTES
        bound_ms, bound_by = _bound(t_ops, t_bytes)
        rows.append({"shape": [n, h, h, c], "convs_per_forward": mult,
                     "rel_err": err, "library_rel_err": lib_err,
                     "bound_ms": bound_ms, "bound_by": bound_by, **t})
        print(f"  dwconv_wgrad b={n} {h}x{h}x{c} k{k} x{mult}: "
              f"ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
              f"library_ms={t['library_ms']:.4f} bound_ms={bound_ms:.4f} "
              f"({bound_by}) bound/kernel={bound_ms / t['ms']:.3f} "
              f"rel_err={err:.3e} library_rel_err={lib_err:.3e}",
              flush=True)
        for key in totals:
            totals[key] += mult * t[key]
        ops_ms += mult * t_ops
        bytes_ms += mult * t_bytes
        del x, g, w, dw, db
    totals["bound_ms"], bound_by = _bound(ops_ms, bytes_ms)
    print(f"kernel: dwconv_wgrad within {DWCONV_TOL} of float64 at "
          f"{len(DWCONV_SHAPES)} ConvNeXt-B shapes (worst {worst:.3e}); one "
          f"batch-{n} step's 36 convs: kernel {totals['ms']:.3f} ms, plain "
          f"{totals['plain_ms']:.3f} ms, cuDNN {totals['library_ms']:.3f} "
          f"ms, bound {totals['bound_ms']:.3f} ms ({bound_by})", flush=True)
    return {"rel_err": worst, "rows": rows, "bound_by": bound_by, **totals}


#: dwconv2d's passes: (name, flip); the forward with a bias
DWCONV2D_PASSES = [("fwd", False), ("dgrad", True)]


def _dwconv2d_check(torch, x, w, b, pad, flip, what):
    """``ops.dwconv2d`` once through its wrapper: one launch, no copy,
    within ``DWCONV_TOL`` of the plain version in float64, and a second
    launch bit-equal; returns the relative norm error."""
    from repro_torch import obs
    from repro_torch.kernels import dwconv2d as dc
    from repro_torch.kernels import ops
    with obs.profiling() as cap:
        y = ops.dwconv2d(x, w, b, pad, flip)
        torch.cuda.synchronize()
    if cap.count("dwconv2d") != dc.LAUNCHES or cap.count("dwconv2d.copies"):
        raise AssertionError(f"dwconv2d {what}: {cap.count('dwconv2d')} "
                             f"launches and {cap.count('dwconv2d.copies')} "
                             f"copies a call")
    ref = dc.dwconv2d_plain(x.double(), w.double(),
                            None if b is None else b.double(), pad, flip)
    err = _rel_norm(y, ref)
    del ref
    if not err <= DWCONV_TOL:
        raise AssertionError(f"dwconv2d {what}: relative norm error {err} "
                             f"> {DWCONV_TOL}")
    if not torch.equal(y, ops.dwconv2d(x, w, b, pad, flip)):
        raise AssertionError(f"dwconv2d {what}: two launches differ")
    return err


def kernel_dwconv2d(torch):
    """``dwconv2d`` through its wrapper at ConvNeXt-B's depthwise shapes,
    forward and data gradient: each checked against a float64 sum (one
    launch, no copy, two launches bit-equal) and timed beside its bound,
    its plain version and cuDNN's (``F.conv2d``; ``dx`` alone from
    ``aten.convolution_backward``); the totals weigh each shape by its
    convs a forward, a pass over all 36.  Then the forward and data
    gradient of rows 21-51 of stage 1's map, read in place, against
    float64."""
    import torch.nn.functional as F
    from repro_torch.kernels import dwconv2d as dc
    from repro_torch.kernels import ops
    k, p, n = DWCONV_K, DWCONV_K // 2, DWCONV_BATCH
    rows, worst = [], 0.0
    totals = {f"{name}_{key}": 0.0 for name, _ in DWCONV2D_PASSES
              for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    for i, (h, c, mult) in enumerate(DWCONV_SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(500 + i)
        x, g = (torch.randn((n, h, h, c), device="cuda", generator=gen)
                .permute(0, 3, 1, 2) for _ in range(2))
        w = torch.randn((k, k, 1, c), device="cuda",
                        generator=gen).permute(3, 2, 0, 1)
        b = torch.randn(c, device="cuda", generator=gen)
        library = {
            "fwd": lambda: F.conv2d(x, w, b, padding=p, groups=c),
            "dgrad": lambda: torch.ops.aten.convolution_backward(
                g, x, w, None, [1, 1], [p, p], [1, 1], False, [0, 0], c,
                [True, False, False])}
        elems = n * h * h * c
        t_ops = 1e3 * 2 * k * k * elems / PEAK_FP32_FLOPS
        t_bytes = 1e3 * 4 * (2 * elems + k * k * c + c) / PEAK_HBM_BYTES
        bound_ms, bound_by = _bound(t_ops, t_bytes)
        row = {"shape": [n, h, h, c], "convs_per_forward": mult,
               "bound_ms": bound_ms, "bound_by": bound_by}
        for name, flip in DWCONV2D_PASSES:
            src, bb = (g, None) if flip else (x, b)
            pad = (k - 1 - p,) * 2 if flip else (p, p)
            err = _dwconv2d_check(torch, src, w, bb, pad, flip,
                                  f"{name} {h}x{h}x{c}")
            worst = max(worst, err)
            t = {"ms": _timed_ms(torch, lambda: ops.dwconv2d(
                     src, w, bb, pad, flip), iters=10),
                 "plain_ms": _timed_ms(torch, lambda: dc.dwconv2d_plain(
                     src, w, bb, pad, flip), iters=2, warmup=1),
                 "library_ms": _timed_ms(torch, library[name], iters=10)}
            row[name] = {"rel_err": err, **t}
            for key in t:
                totals[f"{name}_{key}"] += mult * t[key]
            totals[f"{name}_bound_ms"] += mult * bound_ms
            print(f"  dwconv2d {name} b={n} {h}x{h}x{c} k{k} x{mult}: "
                  f"ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
                  f"library_ms={t['library_ms']:.4f} bound_ms={bound_ms:.4f} "
                  f"({bound_by}) bound/kernel={bound_ms / t['ms']:.3f} "
                  f"kernel/library={t['ms'] / t['library_ms']:.3f} "
                  f"rel_err={err:.3e}", flush=True)
        rows.append(row)
        del x, g, w, b
    # rows 21-51 of stage 1's map and of its output's gradient, in place
    h, c, _ = DWCONV_SHAPES[0]
    gen = torch.Generator(device="cuda").manual_seed(510)
    x, g = (torch.randn((8, h, h, c), device="cuda", generator=gen)
            [:, 21:51].permute(0, 3, 1, 2) for _ in range(2))
    w = torch.randn((k, k, 1, c), device="cuda",
                    generator=gen).permute(3, 2, 0, 1)
    b = torch.randn(c, device="cuda", generator=gen)
    worst = max(worst, _dwconv2d_check(torch, x, w, b, (p, p), False,
                                       "fwd rows 21-51"),
                _dwconv2d_check(torch, g, w, None, (k - 1 - p,) * 2, True,
                                "dgrad rows 21-51"))
    del x, g, w, b
    print(f"kernel: dwconv2d within {DWCONV_TOL} of float64 at "
          f"{len(DWCONV_SHAPES)} ConvNeXt-B shapes and a row slice, forward "
          f"and data gradient, two launches bit-equal (worst {worst:.3e}); "
          + "; ".join(
              f"a batch-{n} {name} pass over the 36 convs: kernel "
              f"{totals[name + '_ms']:.3f} ms, plain "
              f"{totals[name + '_plain_ms']:.3f} ms, cuDNN "
              f"{totals[name + '_library_ms']:.3f} ms, bound "
              f"{totals[name + '_bound_ms']:.3f} ms (bound/kernel "
              f"{totals[name + '_bound_ms'] / totals[name + '_ms']:.3f})"
              for name, _ in DWCONV2D_PASSES), flush=True)
    return {"rel_err": worst, "rows": rows, "bound_by": "bytes",
            "ms": totals["fwd_ms"] + totals["dgrad_ms"],
            "plain_ms": totals["fwd_plain_ms"] + totals["dgrad_plain_ms"],
            "library_ms": totals["fwd_library_ms"]
            + totals["dgrad_library_ms"],
            "bound_ms": totals["fwd_bound_ms"] + totals["dgrad_bound_ms"],
            **totals}


def kernel_dwconv_step(torch, out):
    """One ConvNeXt-B step on the main path: the launches of both
    depthwise kernels, into ``out``'s rows."""
    launches, bwd, conv_launches, fwd = _convnext_step_dwconv_launches(torch)
    out["dwconv_wgrad"]["launches"] = launches
    out["dwconv2d"]["launches"] = conv_launches
    print(f"kernel: a batch-4 ConvNeXt-B step at 384²: {launches} "
          f"dwconv_wgrad launches for {bwd} depthwise backward ranges; "
          f"{conv_launches} dwconv2d launches for {fwd} depthwise forward "
          f"calls and the backward ranges owing dx", flush=True)


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
        metrics = json.load(f)
    counters = metrics["counters"]
    losses = [r["loss"] for r in recs]
    grad_norms = [r.get("grad_norm") for r in recs]
    if len(losses) != steps or not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"{name}: losses {losses}")
    if not log["plan_audit"]:
        raise AssertionError(f"{name}: no plan audit in train_log.json")
    # seconds per step on the host clock (loss.item() syncs each step);
    # step 0 includes first-call set-up
    ends = [r["elapsed_s"] for r in recs]
    step_s = [b - a for a, b in zip([0.0] + ends, ends)]
    aux = [{k: r[k] for k in ("load_balance", "z_loss") if k in r}
           for r in recs]
    return {"losses": losses, "grad_norms": grad_norms, "peak": peak,
            "aux": aux, "plan": log["plan"],
            "step_s": step_s, "audit": log["plan_audit"],
            "counters": counters, "gauges": metrics["gauges"],
            "plan_terms": log.get("plan_terms"),
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
    run = _train(torch, tmp, "kernel", "--strategy", "overlap", "--rows",
                 "4", "--kernel", "cuda", steps=3)
    launches = run["counters"].get("conv2d_rows", 0)
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
                       "losses": r["losses"], "step_s": r["step_s"]}
                   for n, r in runs.items()}
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
    kw = dict(arch="resnet50", lr=RESNET_LR)
    runs = {"config": _train(torch, tmp, "resnet_config", steps=2, **kw),
            "base": _train(torch, tmp, "resnet_base", "--strategy", "base",
                           steps=2, **kw)}
    _check_plan("resnet config", runs["config"], *RESNET_PLAN,
                RESNET_SEGMENTS)
    runs["overlap_cuda"] = _train(torch, tmp, "resnet_kernel", "--strategy",
                                  "overlap", "--rows", "4", "--kernel",
                                  "cuda", steps=3, **kw)
    launches = runs["overlap_cuda"]["counters"].get("conv2d_rows", 0)
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


def _stash_bytes(plan):
    """Bytes of the GPipe stash one forward of a VGG-16 ``plan`` carries:
    every microbatch's activation at each stage input past the first, over
    its OverL interval (halo included), which is what the executor
    places."""
    from repro_torch.core.overlap import plan_overlap
    from repro_torch.core.rowplan import shape_chain
    from repro_torch.exec import StageSpec
    from repro_torch.models.cnn import vgg
    mods = vgg.vgg16_modules(1.0)
    shape = tuple(plan["in_shape"])
    ov = plan_overlap(mods, shape[0], plan["n_rows"])
    shapes = shape_chain(mods, shape)
    total = 0
    for a, _ in StageSpec.from_dict(plan["stage"]).stages[1:]:
        _, w, c = shapes[a]
        total += sum(ch[a][1] - ch[a][0] for ch in ov.chains) * w * c \
            * plan["dtype_bytes"] * plan["batch"]
    return total


def _pipe_report(name, run, ref0):
    plan, audit = run["plan"], run["audit"]
    est = plan["est_bytes_per_device"]
    rel = _rel0(run, ref0)
    counters = {k: v for k, v in sorted(run["counters"].items())
                if k.startswith(("rowprog.", "pipeline."))}
    print(f"  {name}: engine={plan['engine']} N={plan['n_rows']} "
          f"stages={plan['stage']['stages']} residency="
          f"{(plan.get('residency') or {}).get('default')} peak="
          f"{run['peak']} estimate_staged={est} peak/est="
          f"{run['peak'] / est:.3f} audit ratio {audit['ratio']:.3f} "
          f"bubble={run['gauges'].get('pipeline.bubble_fraction')} "
          f"step_s={run['step_s']} step-0 loss {run['losses'][0]} (rel "
          f"{rel:.3e}) counters {counters}", flush=True)
    lo, hi = TRAIN_AUDIT_BAND
    if not lo <= audit["ratio"] <= hi:
        raise AssertionError(f"{name}: audit ratio {audit['ratio']} "
                             f"outside {TRAIN_AUDIT_BAND}")
    return rel


def phase_pipeline(torch, out, tmp):
    """The row pipeline at full width: VGG-16 ``pipeline_rows`` N=4 (S=2)
    under device, host and recompute residency, then ResNet-50 once.
    cuDNN's default backward algorithms sum with atomics, so two runs of
    one plan differ after a step (without the deterministic ones this
    phase saw the residencies' losses 5.1e-6 apart by step 2 on an H100
    80GB HBM3 at 700 W, their step-0 losses equal); the phase picks
    cuDNN's deterministic algorithms, so that the residencies are held to
    each other and not to that noise."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _pipeline_runs(torch, out, tmp)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _pipeline_runs(torch, out, tmp):
    runs, rel = {}, {}
    base0 = out["rows"]["base"]["losses"][0]
    for res in ("device", "host", "recompute"):
        runs[res] = run = _train(torch, tmp, f"pipe_{res}", "--strategy",
                                 "pipeline_rows", "--rows", str(PIPE_ROWS),
                                 "--residency", res, steps=PIPE_STEPS)
        _check_plan(f"pipeline {res}", run, "pipeline_rows", PIPE_ROWS)
        if run["plan"]["stage"]["stages"] != [[0, 16], [16, 31]]:
            raise AssertionError(f"pipeline {res}: stages "
                                 f"{run['plan']['stage']}")
        rel[res] = _pipe_report(f"vgg16 {res}", run, base0)
    runs["resnet"] = _train(torch, tmp, "pipe_resnet", "--strategy",
                            "pipeline_rows", "--rows", str(PIPE_ROWS),
                            steps=PIPE_RESNET_STEPS, arch="resnet50",
                            lr=RESNET_LR)
    _check_plan("pipeline resnet", runs["resnet"], "pipeline_rows",
                PIPE_ROWS)
    rel["resnet"] = _pipe_report("resnet50 device", runs["resnet"],
                                 out["resnet"]["base"]["losses"][0])
    out["pipeline"] = runs
    host = runs["host"]
    stash = _stash_bytes(host["plan"])
    want = PIPE_STEPS * stash
    got = host["counters"].get("rowprog.offload_bytes")
    dev = runs["device"]["losses"]
    spread = max(abs(r["losses"][i] - dev[i]) / abs(dev[i])
                 for r in (runs["host"], runs["recompute"])
                 for i in range(PIPE_STEPS))
    over = out["rows"]["overlap"]["step_s"][-1]
    stretch = {res: runs[res]["step_s"][-1] / over - 1
               for res in ("device", "host", "recompute")}
    print(f"pipeline: step-0 losses vs base: {rel}; residencies agree to "
          f"{spread:.3e} relative; host offloaded {got} B in "
          f"{PIPE_STEPS} steps, the plan's chains imply {want} "
          f"({stash} B a step); steady step vs overlap N=4's {over:.4f} s: "
          f"{stretch} (the roofline's bubble charges (S-1)/N = "
          f"{1 / PIPE_ROWS})", flush=True)
    bad = {n: r for n, r in rel.items() if not r <= LOSS_TOL}
    if bad:
        raise AssertionError(f"step-0 loss differs from base: {bad}")
    if not spread <= RESIDENCY_TOL:
        raise AssertionError(f"residency changed the losses by {spread}")
    if got != want:
        raise AssertionError(f"host offload bytes {got} != {want}")


MESH_RANK = r'''
import datetime, json, os, sys
import torch
import torch.distributed as dist

rank, init, out, lr, timeout = sys.argv[1:6]
rank = int(rank)
runs = json.loads(sys.argv[6])
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=2,
                        timeout=datetime.timedelta(seconds=float(timeout)))
res = {}
try:
    from repro_torch import obs
    from repro_torch.launch import train as T
    for name, flags, steps, _ in runs:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with obs.profiling() as cap:
            recs = T.main(["--arch", "vgg16", "--preset", "full",
                           "--steps", str(steps), "--lr", lr,
                           "--log-every", "1", "--out",
                           os.path.join(out, name), *flags])
        ends = [r["elapsed_s"] for r in recs]
        res[name] = {"losses": [r["loss"] for r in recs],
                     "step_s": [b - a for a, b in zip([0.0] + ends, ends)],
                     "peak": torch.cuda.max_memory_allocated(),
                     "launches": cap.count("conv2d_rows"),
                     "backend": dist.get_backend()}
finally:
    dist.destroy_process_group()
json.dump(res, open(os.path.join(out, f"rank{rank}.json"), "w"))
'''


def phase_mesh(torch, out, tmp):
    """Two ranks on the one card in a gloo group, each a trainer process
    (``--mesh``): data=2 under ``overlap_cuda`` (``conv2d_rows`` under the
    shard wrapper) and ``twophase_h``, and data=1,model=2 under
    ``pipeline_rows`` (column-parallel convs, S=2 from the model extent);
    every step-0 loss against its single-process run."""
    d = os.path.join(tmp, "mesh")
    os.makedirs(d)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_RANK, str(rank),
         os.path.join(d, "init"), d, str(TRAIN_LR),
         str(MESH_GROUP_TIMEOUT_S), json.dumps(MESH_RUNS)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    try:
        outs = [p.communicate(timeout=MESH_WAIT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for rank, (p, (so, se)) in enumerate(zip(procs, outs)):
        if p.returncode:
            raise AssertionError(f"mesh rank {rank} exit {p.returncode}: "
                                 f"{so[-2000:]} {se[-3000:]}")
    ranks = []
    for rank in range(2):
        with open(os.path.join(d, f"rank{rank}.json")) as f:
            ranks.append(json.load(f))
    single = {"kernel": out["kernel_run"],
              "twophase_h": out["2ps"]["twophase_h"],
              "pipeline": out["pipeline"]["device"]}
    rel, res = {}, {}
    for name, _, _, ref in MESH_RUNS:
        with open(os.path.join(d, name, "train_log.json")) as f:
            plan = json.load(f)["plan"]
        ref0 = single[ref]["losses"][0]
        rel[name] = max(abs(r[name]["losses"][0] - ref0) / abs(ref0)
                        for r in ranks)
        res[name] = {"plan": plan, "ranks": [r[name] for r in ranks],
                     "single_peak": single[ref]["peak"]}
        print(f"  mesh {name}: engine={plan['engine']} N={plan['n_rows']} "
              f"mesh={plan['mesh']['axes']} est/dev="
              f"{plan['est_bytes_per_device']} backend="
              f"{ranks[0][name]['backend']} rank peaks="
              f"{[r[name]['peak'] for r in ranks]} (single process "
              f"{single[ref]['peak']}) conv2d_rows launches="
              f"{[r[name]['launches'] for r in ranks]} step-0 losses="
              f"{[r[name]['losses'][0] for r in ranks]} vs single {ref0} "
              f"(rel {rel[name]:.3e}) step_s="
              f"{[r[name]['step_s'] for r in ranks]}", flush=True)
    out["mesh"] = res
    print(f"mesh: two gloo ranks on one card agree with one process: "
          f"{rel}; NCCL is unverified: it needs a card a rank, and this "
          f"run has {torch.cuda.device_count()}", flush=True)
    bad = {n: r for n, r in rel.items() if not r <= LOSS_TOL}
    if bad:
        raise AssertionError(f"mesh step-0 loss differs: {bad}")
    if not all(r["data2_overlap_cuda"]["launches"] > 0 for r in ranks):
        raise AssertionError("conv2d_rows did not launch under the shard "
                             "wrapper")


def _dir_bytes(d, suffix):
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
               if f.endswith(suffix))


def phase_ckpt(torch, out, tmp):
    """Two checkpoint round trips: VGG-16's full-width parameters and SGD
    momentum through the store on the card, bit for bit; then
    ``train_lm --save`` on xLSTM-125M, resumed for its third step."""
    import importlib
    from repro_torch.ckpt import store
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenDataset, TokenDatasetConfig
    from repro_torch.exec import ExecutionPlan
    from repro_torch.launch import train as T
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.cnn import vgg
    from repro_torch.models.lm.model import family_fns
    from repro_torch.optim.adamw import (
        AdamWConfig, adamw_init, sgd_init, tree_leaves, tree_map,
    )
    dev = torch.device("cuda")
    ccfg = importlib.import_module("repro_torch.configs.vgg16").CONFIG
    _, params = vgg.init_vgg16(torch.Generator().manual_seed(0),
                               (224, 224, 3), ccfg.width_mult,
                               ccfg.n_classes, device=dev)
    opt = sgd_init(params)
    opt["vel"] = tree_map(torch.randn_like, opt["vel"])
    d = os.path.join(tmp, "ckpt_vgg")
    torch.cuda.synchronize()
    t0 = time.time()
    store.save(d, 1, params, opt)
    write_s = time.time() - t0
    t0 = time.time()
    p2 = store.restore(d, params)
    o2 = store.restore(d, opt, kind="opt")
    torch.cuda.synchronize()
    read_s = time.time() - t0
    pairs = list(zip(tree_leaves(params) + tree_leaves(opt),
                     tree_leaves(p2) + tree_leaves(o2)))
    bad = [i for i, (a, b) in enumerate(pairs)
           if b.device.type != "cuda" or not torch.equal(a, b)]
    leaf_bytes = sum(int(a.nbytes) for a, _ in pairs)
    file_bytes = _dir_bytes(d, ".npz")
    print(f"  ckpt vgg16: {len(pairs)} leaves, {leaf_bytes} B of tensors, "
          f"{file_bytes} B of npz; write {write_s:.3f} s, read "
          f"{read_s:.3f} s; {len(pairs) - len(bad)} bit-equal on the card",
          flush=True)
    if bad:
        raise AssertionError(f"ckpt: leaves {bad} differ after restore")
    del params, opt, p2, o2, pairs
    torch.cuda.empty_cache()

    common = ["--arch", CKPT_LM_ARCH, "--preset", "full", "--seq",
              str(CKPT_LM_SEQ), "--residency", "device", "--log-every", "1"]
    full = T.main(common + ["--steps", "3", "--out",
                            os.path.join(tmp, "ckpt_lm_full")])
    d = os.path.join(tmp, "ckpt_lm")
    t0 = time.time()
    T.main(common + ["--steps", "2", "--save", "--out", d])
    train_save_s = time.time() - t0
    cfg = get_config(CKPT_LM_ARCH)
    template = family_fns(cfg).init(
        torch.Generator(device=dev).manual_seed(1), cfg)
    t0 = time.time()
    params = store.restore(d, template)
    opt = store.restore(d, adamw_init(template), kind="opt")
    plan = store.restore_plan(d)
    torch.cuda.synchronize()
    read_s = time.time() - t0
    with open(os.path.join(d, "train_log.json")) as f:
        saved = ExecutionPlan.from_dict(json.load(f)["plan"])
    restored_step = opt["step"]
    step = make_train_step(cfg, AdamWConfig(lr=T.LM_LR), plan=plan)
    ds = TokenDataset(TokenDatasetConfig(vocab=cfg.vocab,
                                         seq_len=CKPT_LM_SEQ, batch=8,
                                         seed=0))
    _, metrics = step({"params": params, "opt": opt},
                      T.lm_batch(cfg, ds.batch_at(2), 2, 0, dev))
    loss, want = float(metrics["loss"]), full[2]["loss"]
    rel = abs(loss - want) / abs(want)
    out["ckpt"] = {"vgg_leaf_bytes": leaf_bytes, "vgg_file_bytes": file_bytes,
                   "vgg_write_s": write_s, "lm_rel": rel,
                   "lm_bytes": _dir_bytes(d, ".npz")}
    print(f"ckpt: xlstm_125m --save after 2 steps ({train_save_s:.1f} s "
          f"with the save), {out['ckpt']['lm_bytes']} B of npz read in "
          f"{read_s:.3f} s; restored plan {plan.describe()}; resumed "
          f"third loss {loss} vs uninterrupted {want} (rel {rel:.3e}; "
          f"AdamW step {restored_step} restored)", flush=True)
    if plan != saved:
        raise AssertionError(f"restored plan {plan} != saved {saved}")
    if not rel <= CKPT_LM_TOL:
        raise AssertionError(f"resumed loss differs by {rel}")


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
    from repro_torch import obs
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
    with obs.profiling() as cap:
        y = apply(*leaves)
        grads = torch.autograd.grad(y.square().sum(), leaves)
    launches = cap.count("ssd_scan")
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


def _train_lm_arch(torch, tmp, name, arch, cfg, seq, steps, *flags,
                   batch=LM_BATCH):
    """``steps`` trainer steps of LM ``arch`` with the config ``cfg`` (a
    depth cut of the full preset), batch 1 unless ``batch`` says
    otherwise."""
    from repro_torch.launch import train as T
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    recs = T.main(["--arch", arch, "--preset", "full", "--batch",
                   str(batch), "--seq", str(seq), "--steps", str(steps),
                   "--log-every", "1", "--out", os.path.join(tmp, name),
                   *_obs_flags(tmp, name), *flags], cfg=cfg)
    return _finish_run(torch, tmp, name, recs, steps)


def _train_lm(torch, tmp, name, kernel, steps):
    return _train_lm_arch(torch, tmp, name, "gemma3_4b", _gemma12(torch),
                          LM_SEQ, steps, "--kernel", kernel)


def phase_train_lm_kernel(torch, out, tmp):
    run = _train_lm(torch, tmp, "lm_kernel", "cuda", 3)
    launches = run["counters"].get("swa_attention", 0)
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


def _fwd_bwd_peak(torch, cfg, params, row_chunks, kernel="cuda"):
    """Peak bytes of one forward + backward through ``build_lm_apply``
    (no optimizer) at ``row_chunks``, and the plan's estimate."""
    import dataclasses
    from repro_torch.data.pipeline import TokenDataset, TokenDatasetConfig
    from repro_torch.exec import Planner
    from repro_torch.models.lm.rowexec import build_lm_apply
    from repro_torch.optim.adamw import tree_leaves
    cfg = dataclasses.replace(cfg, row_chunks=row_chunks)
    plan = Planner.for_model(cfg, LM_BATCH, LM_SEQ, kernel=kernel)
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
    # a norm per leaf, then of those: no squared copy of a large leaf
    gnorm = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads])))
    del grads
    return peak, plan.est_bytes, loss.detach().item(), gnorm


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
    (p8, e8, _, _), (p1, e1, _, _) = peaks[cfg.row_chunks], peaks[1]
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


def _lm_config(arch, n_layers=None):
    """The full preset of ``arch``, its depth cut to ``n_layers``."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if n_layers is None \
        else dataclasses.replace(cfg, n_layers=n_layers)


def _device_launches(torch, fn):
    """Kernels launched on the card while ``fn()`` runs (torch.profiler,
    CUDA activity only; copies and sets not counted)."""
    return _device_profile(torch, fn)["launches"]


@contextlib.contextmanager
def _executor_on_device():
    """Make a device-resident plan's carried scans run on the row-program
    executor too (a residency that places nothing off the device), in
    place of the default checkpointed chunk loop, to time the one against
    the other."""
    from repro_torch.core import seqrow
    keep = seqrow._offloading
    seqrow._offloading = lambda residency: True
    try:
        yield
    finally:
        seqrow._offloading = keep


def _carry_scan_paths(torch, cfg, seq):
    """One fwd+bwd of ``cfg`` under a device-resident plan on each carried
    scan path, the checkpointed chunk loop (``loop``) and the executor
    (``executor``): host seconds (synchronised) of a timed call, then the
    kernel launches of a profiled one."""
    res = {}
    for path in ("loop", "executor"):
        step = _lm_fwd_bwd(torch, cfg, seq)
        with (_executor_on_device() if path == "executor"
              else contextlib.nullcontext()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            res[path] = {"s": time.perf_counter() - t0,
                         "launches": _device_launches(torch, step)}
        del step
    return res


def _lm_fwd_bwd(torch, cfg, seq, residency=""):
    """One forward + backward of ``cfg`` (random init) through its
    sequence plan, no optimizer: what ``_device_launches`` counts."""
    from repro_torch.data.pipeline import TokenDataset, TokenDatasetConfig
    from repro_torch.exec import Planner, ResidencySpec
    from repro_torch.models.lm.model import init_lm
    from repro_torch.models.lm.rowexec import build_lm_apply
    from repro_torch.optim.adamw import tree_leaves
    params = init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    plan = Planner.for_model(cfg, LM_BATCH, seq,
                             residency=ResidencySpec.parse(residency))
    apply = build_lm_apply(cfg, plan)
    hb = TokenDataset(TokenDatasetConfig(vocab=cfg.vocab, seq_len=seq,
                                         batch=LM_BATCH)).batch_at(0)
    batch = {k: torch.from_numpy(hb[k]).long().cuda()
             for k in ("tokens", "labels")}

    def step():
        loss, _ = apply(params, batch)
        torch.autograd.grad(loss, leaves)
    return step


def _lm_report(name, run):
    audit = run["audit"]
    rp = {k: v for k, v in run["counters"].items()
          if k.startswith("rowprog.")}
    print(f"  {name}: plan {run['plan']['engine']} "
          f"N={run['plan']['n_rows']} residency="
          f"{(run['plan']['residency'] or {}).get('default', 'device')} "
          f"losses={run['losses']} step_s={run['step_s']} peak="
          f"{run['peak']} est={run['plan']['est_bytes']} audit est (plan + "
          f"xi) {audit['est_bytes_per_device']} ratio {audit['ratio']:.3f}"
          f" rowprog counters {rp}", flush=True)


def _check_lm_runs(name, runs, ref):
    """Finite losses (``_finish_run``); every step's loss and step 0's
    gradient norm within RESIDENCY_TOL of run ``ref``'s, so the backward
    that reads the placed states (fetched back or recomputed) and the
    update it feeds are held too, not only the forward; audit ratios in
    the LM band."""
    want = runs[ref]
    rel = {}
    for p, r in runs.items():
        pairs = [(f"loss {i}", a, b) for i, (a, b) in
                 enumerate(zip(r["losses"], want["losses"]))]
        pairs.append(("grad_norm 0", r["grad_norms"][0],
                      want["grad_norms"][0]))
        rel[p] = {k: abs(a - b) / abs(b) for k, a, b in pairs}
    ratios = {p: r["audit"]["ratio"] for p, r in runs.items()}
    print(f"{name}: rel diff vs {ref}: {rel}; audit ratios {ratios}",
          flush=True)
    bad = {p: {k: v for k, v in d.items() if not v <= RESIDENCY_TOL}
           for p, d in rel.items()}
    bad = {p: d for p, d in bad.items() if d}
    if bad:
        raise AssertionError(f"{name}: losses or gradient norms differ by "
                             f"residency: {bad}")
    lo, hi = LM_AUDIT_BAND
    bad = {p: r for p, r in ratios.items() if not lo <= r <= hi}
    if bad:
        raise AssertionError(f"{name}: audit ratios out of {LM_AUDIT_BAND}:"
                             f" {bad}")
    return rel


def phase_train_lm_ssm(torch, out, tmp):
    """Zamba2-7B (12 layers) under the config's plan and under host and
    recompute residency; the host counters against the carry's shape and
    the executor's rule (every chunk's incoming state is placed, so each
    Mamba2 layer offloads and fetches one state per chunk); then
    xLSTM-125M under device and host residency."""
    from repro_torch.models.lm.blocks import ssm_dims
    cfg = _lm_config("zamba2_7b", ZAMBA_LAYERS)
    runs = {"device": _train_lm_arch(torch, tmp, "zamba_device",
                                     "zamba2_7b", cfg, LM_SEQ, ZAMBA_STEPS,
                                     "--residency", "device")}
    for policy in ("host", "recompute"):
        runs[policy] = _train_lm_arch(torch, tmp, f"zamba_{policy}",
                                      "zamba2_7b", cfg, LM_SEQ, 2,
                                      "--residency", policy)
    for p, r in runs.items():
        _lm_report(f"zamba2_7b {p}", r)
        if r["plan"]["engine"] != "seq_carry_scan":
            raise AssertionError(f"zamba2 {p}: plan {r['plan']['engine']}")
    rel = _check_lm_runs("train_lm_ssm zamba2_7b", runs, "device")
    dims = ssm_dims(cfg)
    chunks = LM_SEQ // dims.chunk
    carry = 4 * LM_BATCH * dims.n_heads * dims.head_p * dims.state_n
    rows = 2 * cfg.layer_kinds().count("mamba") * chunks
    want = {"rowprog.fp_rows": rows, "rowprog.bp_rows": rows,
            "rowprog.prefetches": rows, "rowprog.offload_bytes": rows * carry,
            "rowprog.prefetch_bytes": rows * carry}
    got = {k: runs["host"]["counters"].get(k) for k in want}
    paths = _carry_scan_paths(torch, cfg, LM_SEQ)
    out["zamba"] = {"runs": runs, "rel": rel, "counters": got,
                    "carry_bytes": carry, "paths": paths}
    print(f"train_lm_ssm: zamba2_7b peaks device {runs['device']['peak']} "
          f"host {runs['host']['peak']} recompute "
          f"{runs['recompute']['peak']} B; host counters {got} (carry "
          f"{carry} B x {rows} placed states; plan implies {want}); "
          f"device-resident fwd+bwd by carried-scan path {paths}",
          flush=True)

    # host first: its step 0 then carries the first-call set-up, so the
    # device run's step is not flattered by it
    xcfg = _lm_config("xlstm_125m")
    xruns = {p: _train_lm_arch(torch, tmp, f"xlstm_{p}", "xlstm_125m", xcfg,
                               XLSTM_SEQ, 1, "--residency", p)
             for p in ("host", "device")}
    for p, r in xruns.items():
        _lm_report(f"xlstm_125m {p}", r)
    xrel = _check_lm_runs("train_lm_ssm xlstm_125m", xruns, "device")
    xpaths = _carry_scan_paths(
        torch, _lm_config("xlstm_125m", XLSTM_PATH_LAYERS), XLSTM_SEQ)
    out["xlstm"] = {"runs": xruns, "rel": xrel, "paths": xpaths}
    print(f"train_lm_ssm: xlstm_125m (12 layers, seq {XLSTM_SEQ}) step_s "
          f"device {xruns['device']['step_s']} host "
          f"{xruns['host']['step_s']}; device-resident fwd+bwd of "
          f"{XLSTM_PATH_LAYERS} layers by carried-scan path {xpaths}",
          flush=True)
    if got != want:
        raise AssertionError(f"host residency counters {got} != {want}")
    for name, r in (("zamba2_7b", runs), ("xlstm_125m", xruns)):
        if not r["host"]["peak"] <= r["device"]["peak"]:
            raise AssertionError(f"{name}: host residency's peak is above "
                                 f"device's")


def phase_train_lm_dense(torch, out, tmp):
    """llama3_2_3b and qwen1_5_4b (8 layers) through --budget-gb plans;
    qwen1_5_110b (2 layers) as a forward + backward probe with no
    optimizer state."""
    from repro_torch.models.lm.model import init_lm
    from repro_torch.optim.adamw import tree_leaves
    runs = {}
    for arch in ("llama3_2_3b", "qwen1_5_4b"):
        run = _train_lm_arch(torch, tmp, f"dense_{arch}", arch,
                             _lm_config(arch, DENSE_LAYERS), LM_SEQ, 2,
                             "--budget-gb", str(DENSE_BUDGET_GB))
        _lm_report(arch, run)
        if run["plan"]["engine"] != "seq_chunked" \
                or not run["plan"]["feasible"]:
            raise AssertionError(f"{arch}: plan {run['plan']}")
        lo, hi = LM_AUDIT_BAND
        if not lo <= run["audit"]["ratio"] <= hi:
            raise AssertionError(f"{arch}: audit ratio "
                                 f"{run['audit']['ratio']}")
        runs[arch] = run
    cfg = _lm_config("qwen1_5_110b", QWEN110_LAYERS)
    params = init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    for t in tree_leaves(params):
        t.requires_grad_()
    n_all = sum(t.numel() for t in tree_leaves(params))
    n_stack = sum(t.numel() for t in tree_leaves(params["stack"]))
    # one layer and the embeddings, with params, grads and two AdamW
    # moments in fp32
    xi_one_layer = 16 * (n_all - n_stack + n_stack // QWEN110_LAYERS)
    peak, est, loss, _ = _fwd_bwd_peak(torch, cfg, params, cfg.row_chunks,
                                       kernel="plain")
    del params
    out["dense"] = {"runs": runs, "qwen110b": {
        "params": n_all, "peak": peak, "est": est, "loss": loss,
        "xi_one_layer": xi_one_layer}}
    print(f"train_lm_dense: qwen1_5_110b at published widths, "
          f"{QWEN110_LAYERS} layers ({n_all} params), seq {LM_SEQ}: fwd+bwd "
          f"peak {peak} B (plan est {est}), loss {loss}; the trainer cannot "
          f"run it on one card: one layer with fp32 AdamW is "
          f"{xi_one_layer} B of xi", flush=True)
    if not math.isfinite(loss):
        raise AssertionError(f"qwen1_5_110b probe loss {loss}")


def _lm_params(torch, cfg):
    """Seeded parameters of ``cfg``'s family on the card."""
    from repro_torch.models.lm.model import family_fns
    return family_fns(cfg).init(torch.Generator(device="cuda").manual_seed(0),
                                cfg)


def _n_params(params):
    from repro_torch.optim.adamw import tree_leaves
    return sum(t.numel() for t in tree_leaves(params))


def _check_lm_run(name, run):
    """The plan audit in ``train_step_lm``'s band (finite losses are
    ``_finish_run``'s)."""
    _lm_report(name, run)
    lo, hi = LM_AUDIT_BAND
    if not lo <= run["audit"]["ratio"] <= hi:
        raise AssertionError(f"{name}: audit ratio {run['audit']['ratio']} "
                             f"out of {LM_AUDIT_BAND}")


def phase_train_lm_moe(torch, out, tmp):
    """DeepSeek-MoE-16B (4 layers) under the config's plan, with its
    router's aux terms; Qwen3-MoE (2 layers) as a forward + backward
    probe with no optimizer state."""
    from repro_torch.optim.adamw import tree_leaves
    cfg = _lm_config("deepseek_moe_16b", MOE_LAYERS)
    print(f"train_lm_moe: deepseek_moe_16b at published widths, "
          f"{MOE_LAYERS} of 28 layers (fp32 AdamW of all 28 is ~262 GB)",
          flush=True)
    run = _train_lm_arch(torch, tmp, "moe_deepseek", "deepseek_moe_16b", cfg,
                         LM_SEQ, MOE_STEPS, "--residency", "device")
    _check_lm_run("deepseek_moe_16b", run)
    if run["plan"]["engine"] != "seq_chunked":
        raise AssertionError(f"deepseek: plan {run['plan']['engine']}")
    bad = [a for a in run["aux"] if not (
        math.isfinite(a["load_balance"]) and a["load_balance"] > 0
        and math.isfinite(a["z_loss"]) and a["z_loss"] > 0)]
    if bad:
        raise AssertionError(f"deepseek: aux terms {run['aux']}")
    cfg = _lm_config("qwen3_moe_235b_a22b", QWEN3_PROBE_LAYERS)
    params = _lm_params(torch, cfg)
    for t in tree_leaves(params):
        t.requires_grad_()
    n = _n_params(params)
    peak, est, loss, gnorm = _fwd_bwd_peak(torch, cfg, params,
                                           cfg.row_chunks, kernel="plain")
    del params
    torch.cuda.empty_cache()
    out["moe"] = {"deepseek": run, "qwen3": {
        "params": n, "peak": peak, "est": est, "loss": loss,
        "grad_norm": gnorm}}
    print(f"train_lm_moe: deepseek_moe_16b aux per step {run['aux']}; "
          f"qwen3_moe_235b_a22b at published widths, {QWEN3_PROBE_LAYERS} "
          f"of 94 layers ({n} params), seq {LM_SEQ}: fwd+bwd peak {peak} B "
          f"(plan est {est}), loss {loss}, gradient norm {gnorm}; the "
          f"trainer cannot hold it on one card (16 B a parameter)",
          flush=True)
    if not (math.isfinite(loss) and math.isfinite(gnorm)):
        raise AssertionError(f"qwen3 probe loss {loss} grad norm {gnorm}")


MESH_LM_RANK = r'''
import datetime, json, os, sys
import torch
import torch.distributed as dist

rank, init, out, timeout, seq, steps = sys.argv[1:7]
rank = int(rank)
runs = json.loads(sys.argv[7])
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=2,
                        timeout=datetime.timedelta(seconds=float(timeout)))
res = {}
try:
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import train as T
    for name, arch, layers, batch, flags, _ in runs:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        d = os.path.join(out, name)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        recs = T.main(["--arch", arch, "--preset", "full", "--batch",
                       str(batch), "--seq", seq, "--steps", steps,
                       "--log-every", "1", "--out", d,
                       "--trace", os.path.join(d, f"rank{rank}.jsonl"),
                       "--metrics-out",
                       os.path.join(d, f"rank{rank}.metrics.json"),
                       *flags], cfg=cfg)
        torch.cuda.synchronize()
        with open(os.path.join(d, f"rank{rank}.metrics.json")) as f:
            m = json.load(f)
        launches = m["counters"].get("swa_attention", 0)
        ends = [r["elapsed_s"] for r in recs]
        res[name] = {"losses": [r["loss"] for r in recs],
                     "step_s": [b - a for a, b in zip([0.0] + ends, ends)],
                     "peak": torch.cuda.max_memory_allocated(),
                     "launches": launches,
                     "audit": m["gauges"].get("audit.train_step_lm.ratio"),
                     "gloo_bytes": m["counters"].get("collectives.bytes",
                                                     0),
                     "gloo_calls": m["counters"].get("collectives.calls",
                                                     0),
                     "backend": dist.get_backend()}
finally:
    dist.destroy_process_group()
json.dump(res, open(os.path.join(out, f"rank{rank}.json"), "w"))
'''


def phase_mesh_lm(torch, out, tmp):
    """The LM's sharded train step: two ``train_lm`` ranks on the one card
    in a gloo group (``MESH_LM_RUNS``), each step-0 loss against its
    one-process run, ``swa_attention`` launched on every Gemma rank (local
    layers x steps), every rank's audit in ``train_step_lm``'s band; each
    rank's peak beside the single run's, step seconds and the bytes the
    collectives sent."""
    single = {"lm_kernel": out["lm_kernel"]}
    single["gemma6_b2"] = _train_lm_arch(
        torch, tmp, "mesh_lm_gemma6", "gemma3_4b", _lm_config("gemma3_4b", 6),
        LM_SEQ, MESH_LM_STEPS, "--kernel", "cuda", batch=2)
    single["moe2"] = _train_lm_arch(
        torch, tmp, "mesh_lm_moe2", "deepseek_moe_16b",
        _lm_config("deepseek_moe_16b", 2), LM_SEQ, MESH_LM_STEPS,
        "--residency", "device")
    d = os.path.join(tmp, "mesh_lm")
    os.makedirs(d)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_LM_RANK, str(rank),
         os.path.join(d, "init"), d, str(MESH_GROUP_TIMEOUT_S), str(LM_SEQ),
         str(MESH_LM_STEPS), json.dumps(MESH_LM_RUNS)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    try:
        outs = [p.communicate(timeout=MESH_LM_WAIT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for rank, (p, (so, se)) in enumerate(zip(procs, outs)):
        if p.returncode:
            raise AssertionError(f"mesh_lm rank {rank} exit {p.returncode}: "
                                 f"{so[-2000:]} {se[-3000:]}")
    ranks = []
    for rank in range(2):
        with open(os.path.join(d, f"rank{rank}.json")) as f:
            ranks.append(json.load(f))
    print(f"mesh_lm: rank 0's output: {outs[0][0][-1500:]}", flush=True)
    rel, bad = {}, []
    lo, hi = LM_AUDIT_BAND
    for name, arch, layers, batch, flags, ref in MESH_LM_RUNS:
        with open(os.path.join(d, name, "train_log.json")) as f:
            plan = json.load(f)["plan"]
        ref0 = single[ref]["losses"][0]
        rs = [r[name] for r in ranks]
        rel[name] = max(abs(r["losses"][0] - ref0) / abs(ref0) for r in rs)
        peaks = [r["peak"] for r in rs]
        print(f"  mesh_lm {name}: {arch} {layers} layers batch {batch} "
              f"{flags[-1]} engine={plan['engine']} N={plan['n_rows']} "
              f"backend={rs[0]['backend']} rank peaks={peaks} (single "
              f"process {single[ref]['peak']}: "
              f"{[round(p / single[ref]['peak'], 3) for p in peaks]}) "
              f"audits={[r['audit'] for r in rs]} swa_attention launches="
              f"{[r['launches'] for r in rs]} step-0 losses="
              f"{[r['losses'][0] for r in rs]} vs single {ref0} (rel "
              f"{rel[name]:.3e}) step_s={[r['step_s'] for r in rs]} "
              f"(single {single[ref]['step_s']}) collective bytes sent="
              f"{[r['gloo_bytes'] for r in rs]} in "
              f"{[r['gloo_calls'] for r in rs]} calls", flush=True)
        if arch == "gemma3_4b":
            local = sum(k == "local" for k in
                        _lm_config(arch, layers).layer_kinds())
            want = local * MESH_LM_STEPS
            if any(r["launches"] != want for r in rs):
                bad.append(f"{name}: swa_attention launches "
                           f"{[r['launches'] for r in rs]}, expected {want}")
        if not all(r["audit"] is not None and lo <= r["audit"] <= hi
                   for r in rs):
            bad.append(f"{name}: audit ratios {[r['audit'] for r in rs]} "
                       f"out of {LM_AUDIT_BAND}")
        if not rel[name] <= LM_LOSS_TOL:
            bad.append(f"{name}: step-0 loss differs by {rel[name]}")
    out["mesh_lm"] = {"ranks": ranks, "rel": rel,
                      "single": {k: {"peak": v["peak"],
                                     "step_s": v["step_s"],
                                     "losses": v["losses"]}
                                 for k, v in single.items()}}
    print(f"mesh_lm: two gloo ranks on one card agree with one process: "
          f"{rel}; NCCL is unverified: it needs a card a rank, and this "
          f"run has {torch.cuda.device_count()}", flush=True)
    if bad:
        raise AssertionError("; ".join(bad))


def phase_train_lm_vlm_encdec(torch, out, tmp):
    """LLaVA-NeXT-34B (4 layers; 2880 patch embeddings before 1216 text
    tokens) and SeamlessM4T-medium (12 + 12 layers, 4096 frames and
    tokens) under the config's plan."""
    cfg = _lm_config("llava_next_34b", LLAVA_LAYERS)
    print(f"train_lm_vlm_encdec: llava_next_34b at published widths, "
          f"{LLAVA_LAYERS} of 60 layers, {cfg.n_frontend_tokens} patch "
          f"embeddings + {LLAVA_TEXT} text tokens", flush=True)
    llava = _train_lm_arch(torch, tmp, "vlm_llava", "llava_next_34b", cfg,
                           LLAVA_TEXT, LLAVA_STEPS, "--residency", "device")
    _check_lm_run("llava_next_34b", llava)
    n_pos = cfg.n_frontend_tokens + LLAVA_TEXT
    if n_pos % llava["plan"]["n_rows"]:
        raise AssertionError(f"llava: {n_pos} positions do not divide by "
                             f"N={llava['plan']['n_rows']}")
    cfg = _lm_config("seamless_m4t_medium")
    seamless = _train_lm_arch(torch, tmp, "encdec_seamless",
                              "seamless_m4t_medium", cfg, LM_SEQ,
                              SEAMLESS_STEPS, "--residency", "device")
    _check_lm_run("seamless_m4t_medium", seamless)
    out["vlm_encdec"] = {"llava": llava, "seamless": seamless}


def _decode_step(torch, cfg, params, plan, reqs):
    """The whole-pool decode step of ``plan``'s slots, each holding the
    longest request's prefilled cache: its ms (median of 5), kernel
    launches, device-busy ms and top kernels."""
    from repro_torch.serve import ServeEngine, make_pool
    engine = ServeEngine(params, cfg, plan)
    longest = max(reqs, key=lambda r: r.prompt_len)
    _, cache, _ = engine.prefill(longest)
    pool = make_pool(cfg, plan, device="cuda")
    for slot in range(plan.n_rows):
        pool.acquire(slot, longest.prompt_len)
        pool.write(slot, cache)
    del cache
    view = pool.decode_view()
    tokens = [int(t) for t in longest.prompt[:plan.n_rows]]
    tokens += tokens[:1] * (plan.n_rows - len(tokens))
    engine.decode_step(tokens, view)          # warm
    ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.decode_step(tokens, view)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    prof = _device_profile(torch, lambda: engine.decode_step(tokens, view))
    del pool, view
    torch.cuda.empty_cache()
    return {"slots": plan.n_rows, "decode_step_ms": sorted(ms)[2], **prof}


def _serve_family(torch, tmp, name, arch, cfg, flags, cut="",
                  paged_raises=False):
    """One model of another family served through the CLI's functions:
    the run, then its decode step alone; with ``paged_raises`` a
    ``paged_kv`` pool must raise ``ValueError`` (enc-dec pools are full
    only, as in the reference).  ``cut`` says why the depth is cut."""
    from repro_torch.exec import Planner
    from repro_torch.launch.serve import make_serve_requests
    from repro_torch.models.lm.blocks import moe_dims
    params = _lm_params(torch, cfg)
    n = _n_params(params)
    print(f"serve: {arch} at published widths, {cfg.n_layers} layers"
          + (f" + {cfg.n_enc_layers} encoder" if cfg.n_enc_layers else "")
          + f", {n} params" + (f" ({cut})" if cut else ""), flush=True)
    run = _serve(torch, tmp, name, arch, params, flags, cfg=cfg)
    if paged_raises:
        try:
            _serve(torch, tmp, f"{name}_paged", arch, params,
                   flags + ["--cache-kind", "paged_kv"], cfg=cfg)
        except ValueError as e:
            print(f"  {arch} paged_kv raises as it must: {e}", flush=True)
        else:
            raise AssertionError(f"serve: {arch} paged_kv did not raise")
    reqs = make_serve_requests(_serve_args(arch, flags), cfg)
    plan = Planner.for_serve(
        cfg, max(r.prompt_len + r.max_new_tokens for r in reqs)
        + (cfg.n_frontend_tokens if cfg.frontend == "vision" else 0),
        budget=int(SERVE_BUDGET_GB * 2**30), n_max=len(reqs),
        enc_len=reqs[0].features.shape[0] if cfg.family == "encdec" else 0)
    step = _decode_step(torch, cfg, params, plan, reqs)
    if cfg.family == "moe":
        # every decode step casts each expert weight to bf16: 4 B read and
        # 2 B written per expert parameter, at the card's HBM rate
        d = moe_dims(cfg)
        experts = cfg.n_layers * 3 * d.n_experts * d.d * d.d_expert
        step["expert_cast_bound_ms"] = 6 * experts / PEAK_HBM_BYTES * 1e3
    print(f"  {arch} decode step at {step['slots']} slots: "
          f"{step['decode_step_ms']:.2f} ms, {step['launches']} launches, "
          f"device busy {step['busy_ms']:.2f} ms"
          + (f", expert casts' bound {step['expert_cast_bound_ms']:.2f} ms"
             if "expert_cast_bound_ms" in step else "")
          + f"; top kernels {step['top_us']}", flush=True)
    del params
    torch.cuda.empty_cache()
    return {**{k: run[k] for k in ("slots", "wall_s", "tok_s", "audit_ratio",
                                   "summary", "peak", "chunks")},
            "params": n, "decode": step}


def _serve(torch, tmp, name, arch, params, flags, **over):
    """One run of ``repro_torch.launch.serve``'s own functions at the full
    preset on ``params``, traced into ``tmp/obs`` with its artefact under
    ``tmp/obs/serve``: every request done, its pool audit in the
    serve_pool band."""
    from repro_torch import obs
    from repro_torch.launch.serve import (
        build_parser, serve_from_args, write_artefact,
    )
    d = os.path.join(tmp, "obs")
    args = build_parser().parse_args(
        ["--arch", arch, "--preset", "full", "--budget-gb",
         str(SERVE_BUDGET_GB), "--trace", os.path.join(d, f"serve_{name}"
                                                     ".jsonl"),
         "--out", os.path.join(d, "serve", name), *flags])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        report, plan, rec, wall = serve_from_args(args, params=params,
                                                  **over)
    finally:
        obs.shutdown()
    write_artefact(args, rec)
    s, a = rec["summary"], report.plan_audit
    run = {"tokens": {st.rid: list(st.generated) for st in report.states},
           "slots": plan.n_rows, "summary": s, "wall_s": wall,
           "tok_s": s["generated_tokens"] / wall, "audit_ratio": a["ratio"],
           "pool_bytes": a["measured"]["peak_bytes"],
           "plan": plan.describe(),
           "peak": torch.cuda.max_memory_allocated(),
           "chunks": sorted({st.prefill_chunks for st in report.states})}
    print(f"  serve {name}: {run['plan']} slots={run['slots']} "
          f"generated {s['generated_tokens']} in {wall:.2f} s "
          f"({run['tok_s']:.1f} tok/s wall), {s['prefills']} prefills "
          f"(chunks {run['chunks']}), {s['decode_steps']} decode steps, "
          f"max_active={s['max_active']} preemptions={s['preemptions']} "
          f"prefetch_hits={s['prefetch_hits']}; audit "
          f"{a['audited_term']} est {a['est_bytes_per_device']} measured "
          f"{a['measured']['peak_bytes']} ratio {a['ratio']:.4f}; card "
          f"peak {run['peak']}", flush=True)
    lo, hi = SERVE_AUDIT_BAND
    if not lo <= a["ratio"] <= hi:
        raise AssertionError(f"serve {name}: audit ratio {a['ratio']} out "
                             f"of {SERVE_AUDIT_BAND}")
    short = [st.rid for st in report.states
             if not st.done or st.n_generated != st.request.max_new_tokens]
    if short:
        raise AssertionError(f"serve {name}: requests {short} unfinished")
    return run


def _same_tokens(what, got, want):
    bad = [rid for rid in want["tokens"]
           if got["tokens"][rid] != want["tokens"][rid]]
    if bad:
        raise AssertionError(f"serve: {what}: token streams differ for "
                             f"requests {bad}")


def _agreement(got, want):
    """Share of generated positions whose token equals ``want``'s."""
    same = total = 0
    for rid, ts in want.items():
        same += sum(a == b for a, b in zip(got[rid], ts))
        total += len(ts)
    return same / max(1, total)


def _serve_args(arch, flags):
    from repro_torch.launch.serve import build_parser
    return build_parser().parse_args(["--arch", arch, "--preset", "full",
                                      "--budget-gb", str(SERVE_BUDGET_GB),
                                      *flags])


def _sequential_loop(torch, cfg, params, plan, reqs, want):
    """Each request alone at batch 1, greedy: the pool's prefill (the
    engine's, with ``plan``'s cache length and the run's prefill budget),
    then its tokens decoded one by one.  Per request: its agreement with
    ``want`` and, at the first mismatch, the top-2 logit margin of the
    loop's logits."""
    from repro_torch.models.lm import model as LM
    from repro_torch.serve import ServeEngine
    engine = ServeEngine(params, cfg, plan,
                         prefill_budget=int(SERVE_BUDGET_GB * 2**30))
    out = {}
    with torch.no_grad():
        for r in reqs:
            row, caches, _ = engine.prefill(r)
            logits = row[None, None]
            gen, first, margin = [], None, None
            for step in range(r.max_new_tokens):
                row = logits[0, -1].float()
                top = torch.topk(row, 2).values
                tok = int(torch.argmax(row))
                gen.append(tok)
                if first is None and tok != want[r.rid][step]:
                    first, margin = step, float(top[0] - top[1])
                if step + 1 < r.max_new_tokens:
                    logits, caches = LM.lm_decode(
                        engine.params,
                        torch.tensor([[tok]], device="cuda"), caches,
                        cfg)
            out[r.rid] = {"agreement": _agreement({0: gen},
                                                  {0: want[r.rid]}),
                          "first_mismatch": first, "top2_margin": margin}
    return out


def _chunked_prefill(torch, cfg, params, prompt):
    """The first token's logits of a 1024-token prompt prefilled whole
    and in the row chunks ``Planner.for_model`` picks under
    SERVE_PREFILL_SHARE of the unchunked estimate (N > 1)."""
    from repro_torch.exec import Planner
    from repro_torch.serve import ServeEngine
    plan = Planner.for_serve(cfg, len(prompt) + 1, n_slots=1)
    engine = ServeEngine(params, cfg, plan)
    S = len(prompt)
    n = Planner.for_model(cfg, 1, S, budget=int(
        SERVE_PREFILL_SHARE * Planner.for_model(cfg, 1, S).est_bytes)).n_rows
    if n <= 1:
        raise AssertionError(f"for_model picked N={n} for the chunked "
                             f"prefill")
    batch = {"tokens": torch.tensor(prompt[None].astype("int64"),
                                    device="cuda")}
    with torch.no_grad():
        whole, chunked = (engine._prefill_fn(S, k)(engine.params, batch)[0]
                          [0, -1].float() for k in (1, n))
    err = float((chunked - whole).abs().max() / whole.abs().max())
    return {"n_chunks": n, "rel_err": err,
            "argmax_equal": int(whole.argmax()) == int(chunked.argmax())}


def _device_profile(torch, fn):
    """One call of ``fn`` under torch.profiler (CUDA activity): its kernel
    launches, the device time they sum to, and the five kernels with the
    most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    n = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA \
                or e.name().startswith(("Memcpy", "Memset")):
            continue
        n += 1
        us = (e.end_ns() - e.start_ns()) / 1e3
        by_name[e.name()[:60]] = by_name.get(e.name()[:60], 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"launches": n, "busy_ms": sum(by_name.values()) / 1e3,
            "top_us": [(k, round(v, 1)) for k, v in top]}


def _serve_timings(torch, cfg, params, plan, reqs):
    """Prefill ms per prompt length; then a pool of ``plan``'s slots, each
    holding a prefilled 1024-token prompt: the whole-pool decode step's
    ms and its kernel launches; then the cohort tick (decode_view, decode,
    absorb, prefetch of the next cohort) of SERVE_COHORT slots under
    device and under host residency, in turns."""
    import dataclasses as dc
    from repro_torch.exec.plan import ResidencySpec
    from repro_torch.serve import ServeEngine, make_pool
    engine = ServeEngine(params, cfg, plan)
    res = {"prefill_ms": {}}
    by_len = {}
    for r in reqs:
        by_len.setdefault(r.prompt_len, r)
    for n, r in sorted(by_len.items()):
        engine.prefill(r)                     # warm
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.prefill(r)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        res["prefill_ms"][n] = sorted(ms)[1]
    longest = by_len[max(by_len)]
    _, cache, _ = engine.prefill(longest)
    tokens = [int(t) for t in longest.prompt[:plan.n_rows]]

    def filled(p):
        pool = make_pool(cfg, p, device="cuda")
        for slot in range(p.n_rows):
            pool.acquire(slot, longest.prompt_len)
            pool.write(slot, cache)
        return pool

    pool = filled(plan)
    view = pool.decode_view()
    engine.decode_step(tokens, view)          # warm
    ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.decode_step(tokens, view)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    res["decode_step_ms"] = sorted(ms)[2]
    res["decode_profile"] = _device_profile(
        torch, lambda: engine.decode_step(tokens, view))
    res["decode_launches"] = res["decode_profile"]["launches"]
    res["prefill_profile"] = _device_profile(
        torch, lambda: engine.prefill(longest))
    del pool, view
    torch.cuda.empty_cache()
    ticks = {}
    cohorts = [list(range(i, min(i + SERVE_COHORT, plan.n_rows)))
               for i in range(0, plan.n_rows, SERVE_COHORT)]
    cohorts = [c for c in cohorts if len(c) == SERVE_COHORT]
    pools = {}
    for residency in ("device", "host"):
        p = dc.replace(plan.with_extras(decode_batch=SERVE_COHORT),
                       residency=ResidencySpec.parse(residency))
        pools[residency] = filled(p)
    for residency in ("device", "host", "host", "device"):
        pool = pools[residency]
        times = []
        for i in range(2 * len(cohorts) + 1):
            c = cohorts[i % len(cohorts)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v = pool.decode_view(c)
            _, v = engine.decode_step([tokens[s] for s in c], v)
            pool.absorb(v, c)
            pool.prefetch(cohorts[(i + 1) % len(cohorts)])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ticks.setdefault(residency, []).append(sorted(times[1:])[
            len(times[1:]) // 2])
    res["cohort_tick_ms"] = {k: min(v) for k, v in ticks.items()}
    res["prefetch_hits"] = pools["host"].prefetch_hits
    return res


def phase_serve(torch, out, tmp):
    """Serving at published widths and full depth through
    ``repro_torch.launch.serve``'s functions: Gemma-3 4B (34 layers)
    under every cache kind, host decode residency, static mode and
    preemptible prefill with bit-identical greedy streams at one slot
    count; the chunked-prefill gate; the serving timings; Zamba2-7B (81
    layers) under device and host residency; xLSTM-125M, whose paged pool
    must raise."""
    from repro_torch.exec import Planner
    from repro_torch.launch.serve import make_serve_requests
    from repro_torch.models.lm.model import init_lm
    from repro_torch.optim.adamw import tree_leaves
    budget = int(SERVE_BUDGET_GB * 2**30)
    res = {}

    # ---- Gemma-3 4B, 34 layers
    cfg = _lm_config("gemma3_4b")
    params = init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    print(f"serve: gemma3_4b at published widths, {cfg.n_layers} layers, "
          f"{sum(t.numel() for t in tree_leaves(params))} params",
          flush=True)
    reqs = make_serve_requests(_serve_args("gemma3_4b", SERVE_FLAGS), cfg)
    need = [r.prompt_len + r.max_new_tokens for r in reqs]
    max_len, avg = max(need), -(-sum(need) // len(need))
    slots = {kind: Planner.for_serve(
        cfg, max_len, budget=budget, n_max=len(reqs), cache_kind=kind,
        avg_len=avg if kind == "paged_kv" else 0).n_rows
        for kind in ("full", "paged_kv", "quant_kv")}
    print(f"  slots bought by {SERVE_BUDGET_GB} GiB: {slots}", flush=True)
    g = {}
    g["full"] = _serve(torch, tmp, "gemma_full", "gemma3_4b", params,
                       SERVE_FLAGS)
    S = g["full"]["slots"]
    g["paged_kv"] = _serve(torch, tmp, "gemma_paged", "gemma3_4b", params,
                           SERVE_FLAGS + ["--cache-kind", "paged_kv"],
                           n_slots=S)
    g["quant_kv"] = _serve(torch, tmp, "gemma_quant", "gemma3_4b", params,
                           SERVE_FLAGS + ["--cache-kind", "quant_kv"])
    g["static"] = _serve(torch, tmp, "gemma_static", "gemma3_4b", params,
                         SERVE_FLAGS, mode="static")
    g["cohort"] = _serve(torch, tmp, "gemma_cohort", "gemma3_4b", params,
                         SERVE_FLAGS + ["--decode-batch",
                                        str(SERVE_COHORT)])
    g["host"] = _serve(torch, tmp, "gemma_host", "gemma3_4b", params,
                       SERVE_FLAGS + ["--decode-residency", "host",
                                      "--decode-batch", str(SERVE_COHORT)])
    bursty = [("bursty" if f == "poisson" else f) for f in SERVE_FLAGS] \
        + ["--priority-levels", "3", "--requests", str(SERVE_BURSTY)]
    pb = int(SERVE_PREFILL_SHARE * Planner.for_model(
        cfg, 1, max(r.prompt_len for r in reqs)).est_bytes)
    g["bursty"] = _serve(torch, tmp, "gemma_bursty", "gemma3_4b", params,
                         bursty, n_slots=SERVE_BURSTY_SLOTS,
                         prefill_budget=pb)
    g["preempt"] = _serve(torch, tmp, "gemma_preempt", "gemma3_4b", params,
                          bursty + ["--preemptible-prefill"],
                          n_slots=SERVE_BURSTY_SLOTS, prefill_budget=pb)
    _same_tokens("paged_kv vs full", g["paged_kv"], g["full"])
    _same_tokens("static vs full", g["static"], g["full"])
    _same_tokens("host residency vs device residency (decode batch "
                 f"{SERVE_COHORT})", g["host"], g["cohort"])
    _same_tokens("preemptible prefill vs not (bursty)", g["preempt"],
                 g["bursty"])
    if g["host"]["summary"]["prefetch_hits"] <= 0:
        raise AssertionError("serve: host residency served no prefetch")
    if g["preempt"]["summary"]["preemptions"] < 1:
        raise AssertionError("serve: the preemptible run preempted nothing")
    agree = {k: _agreement(g[k]["tokens"], g["full"]["tokens"])
             for k in ("quant_kv", "cohort", "host")}
    plan = Planner.for_serve(cfg, max_len, budget=budget, n_max=len(reqs))
    seq = _sequential_loop(torch, cfg, params, plan,
                           reqs[:SERVE_SEQ_REQUESTS], g["full"]["tokens"])
    print(f"  token agreement with full (printed, not gated): {agree}; "
          f"one-slot sequential loop per request {seq}", flush=True)
    chunked = _chunked_prefill(torch, cfg, params,
                               max(reqs, key=lambda r: r.prompt_len).prompt)
    print(f"  chunked prefill: N={chunked['n_chunks']} first-token logits "
          f"rel err {chunked['rel_err']:.3e} (tolerance "
          f"{SERVE_CHUNKED_TOL}), argmax equal {chunked['argmax_equal']}",
          flush=True)
    if not chunked["rel_err"] <= SERVE_CHUNKED_TOL:
        raise AssertionError(f"serve: chunked prefill {chunked}")
    timings = _serve_timings(torch, cfg, params, plan, reqs)
    print(f"  gemma timings at {plan.n_rows} slots: {timings}", flush=True)
    res["gemma"] = {"slots_by_kind": slots, "runs": {
        k: {kk: v[kk] for kk in ("slots", "wall_s", "tok_s", "audit_ratio",
                                 "summary", "peak", "chunks")}
        for k, v in g.items()}, "agreement": agree, "sequential": seq,
        "chunked_prefill": chunked, "timings": timings,
        # what mesh_serve holds its data=2 run to
        "full": {k: g["full"][k] for k in ("tokens", "slots", "pool_bytes",
                                           "chunks", "tok_s")}}
    del params, g
    torch.cuda.empty_cache()

    # ---- Zamba2-7B, 81 layers
    cfg = _lm_config("zamba2_7b")
    params = init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    print(f"serve: zamba2_7b at published widths, {cfg.n_layers} layers, "
          f"{sum(t.numel() for t in tree_leaves(params))} params",
          flush=True)
    z = {"cohort": _serve(torch, tmp, "zamba_cohort", "zamba2_7b", params,
                          ZAMBA_SERVE_FLAGS + ["--decode-batch",
                                               str(SERVE_COHORT)]),
         "host": _serve(torch, tmp, "zamba_host", "zamba2_7b", params,
                        ZAMBA_SERVE_FLAGS + ["--decode-residency", "host",
                                             "--decode-batch",
                                             str(SERVE_COHORT)])}
    _same_tokens("zamba2 host vs device residency", z["host"], z["cohort"])
    res["zamba"] = {k: {kk: v[kk] for kk in ("slots", "wall_s", "tok_s",
                                             "audit_ratio", "summary")}
                    for k, v in z.items()}
    del params, z
    torch.cuda.empty_cache()

    # ---- xLSTM-125M, 12 layers: full pool; paged has nothing to page
    cfg = _lm_config("xlstm_125m")
    params = init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    x = _serve(torch, tmp, "xlstm_full", "xlstm_125m", params,
               XLSTM_SERVE_FLAGS)
    try:
        _serve(torch, tmp, "xlstm_paged", "xlstm_125m", params,
               XLSTM_SERVE_FLAGS + ["--cache-kind", "paged_kv"])
    except ValueError as e:
        print(f"  xlstm paged_kv raises as it must: {e}", flush=True)
    else:
        raise AssertionError("serve: xlstm_125m paged_kv did not raise")
    res["xlstm"] = {kk: x[kk] for kk in ("slots", "wall_s", "tok_s",
                                         "audit_ratio", "summary")}
    del params
    torch.cuda.empty_cache()

    # ---- the MoE, VLM and encoder-decoder families
    res["deepseek"] = _serve_family(
        torch, tmp, "deepseek_full", "deepseek_moe_16b",
        _lm_config("deepseek_moe_16b"), MOE_SERVE_FLAGS)
    res["llava"] = _serve_family(
        torch, tmp, "llava_full", "llava_next_34b",
        _lm_config("llava_next_34b", LLAVA_SERVE_LAYERS), LLAVA_SERVE_FLAGS,
        cut="all 60 layers are 138 GB of fp32 parameters")
    res["seamless"] = _serve_family(
        torch, tmp, "seamless_full", "seamless_m4t_medium",
        _lm_config("seamless_m4t_medium"), SEAMLESS_SERVE_FLAGS,
        paged_raises=True)
    res["qwen3"] = _serve_family(
        torch, tmp, "qwen3_full", "qwen3_moe_235b_a22b",
        _lm_config("qwen3_moe_235b_a22b", QWEN3_SERVE_LAYERS),
        QWEN3_SERVE_FLAGS, cut="all 94 layers are ~940 GB of fp32 "
                                "parameters")
    out["serve"] = res


MESH_SERVE_RANK = r'''
import dataclasses, datetime, json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist

rank, init, d, obs_dir, timeout = sys.argv[1:6]
rank = int(rank)
job = json.loads(sys.argv[6])
torch.cuda.set_device(0)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=2,
                        timeout=datetime.timedelta(seconds=float(timeout)))
res = {}


def config(arch, layers, dtype):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def counters(path):
    with open(path) as f:
        c = json.load(f)["counters"]
    return c.get("collectives.bytes", 0), c.get("collectives.calls", 0)


def ms_of(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, (time.perf_counter() - t0) * 1e3


try:
    from repro_torch import obs
    from repro_torch.exec import MeshSpec
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.launch.serve import build_parser, serve_from_args
    from repro_torch.models.lm.model import init_lm
    from repro_torch.obs.audit import live_bytes
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.serve import ServeEngine, make_pool

    # (A) serve --mesh data=2: the rank's half of the decode-slot pool
    a = job["serve"]
    cfg = config("gemma3_4b", None, None)
    params = init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    metrics = os.path.join(d, f"serve_rank{rank}.metrics.json")
    args = build_parser().parse_args(
        ["--arch", "gemma3_4b", "--preset", "full", "--budget-gb",
         str(a["budget_gb"]), "--mesh", "data=2", "--trace",
         os.path.join(obs_dir, f"serve_mesh_rank{rank}.jsonl"),
         "--metrics-out", metrics, *a["flags"]])
    torch.cuda.reset_peak_memory_stats()
    try:
        report, plan, rec, wall = serve_from_args(args, cfg=cfg,
                                                  params=params,
                                                  n_slots=a["n_slots"])
    finally:
        obs.shutdown()
    gloo = counters(metrics)
    engine = ServeEngine(params, cfg, plan)
    pool = make_pool(cfg, plan, device="cuda")
    longest = max((s.request for s in report.states),
                  key=lambda r: r.prompt_len)
    _, cache, _ = engine.prefill(longest)
    for s in range(plan.n_rows):
        pool.acquire(s, longest.prompt_len)
    for s in pool.local_slots():
        pool.write(s, cache)
    del cache
    view = pool.decode_view()
    tokens = [int(t) for t in longest.prompt[:pool.n_local]]
    engine.decode_step(tokens, view)          # warm
    ms = sorted(ms_of(lambda: engine.decode_step(tokens, view))[1]
                for _ in range(5))
    s = report.summary()
    res["serve"] = {
        "tokens": {str(st.rid): list(st.generated) for st in report.states},
        "summary": s, "wall_s": wall,
        "tok_s": s["generated_tokens"] / wall, "plan": plan.describe(),
        "slots_per_device": plan.get("slots_per_device"),
        "n_local": pool.n_local, "slot_lo": pool.slot_lo,
        "chunks": sorted({st.prefill_chunks for st in report.states}),
        "audit_ratio": report.plan_audit["ratio"],
        "audit_measured": report.plan_audit["measured"]["peak_bytes"],
        "pool_bytes": live_bytes(pool.caches), "decode_step_ms": ms[2],
        "gloo_bytes": gloo[0], "gloo_calls": gloo[1],
        "peak": torch.cuda.max_memory_allocated()}
    del engine, pool, view, params, report
    torch.cuda.empty_cache()

    # (B) the model-axis prefill and decode steps
    mesh = build_mesh(MeshSpec.parse("data=1,model=2"))
    for name, arch, layers, dtype, _, _ in job["steps"]:
        ref = np.load(os.path.join(d, f"{name}_ref.npz"))
        want = torch.from_numpy(ref["logits"]).cuda()
        cfg = config(arch, layers, dtype)
        B, L = job["batch"], job["cache"]
        params = init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
        ctx = sh.bind_groups(steps.make_shape_ctx(
            mesh, cfg, steps.ShapeSpec("serve", "decode", L, B)))
        places = steps.state_sharding(ctx, {"params": params})["params"]
        local = sh.local_shards(params, places, mesh)
        del params
        torch.cuda.empty_cache()
        metrics = os.path.join(d, f"{name}_rank{rank}.metrics.json")
        obs.configure(metrics=metrics)
        prompt = torch.from_numpy(ref["prompt"]).cuda()
        teacher = torch.from_numpy(ref["teacher"]).cuda()
        (tok, caches, lg), prefill_ms = ms_of(
            lambda: steps.make_prefill_step(cfg, L, ctx=ctx)(
                local, {"tokens": prompt}))

        truth = torch.from_numpy(ref["truth"]).cuda() \
            if "truth" in ref.files else None

        def rel(got, i, w=None):
            w = (want if w is None else w)[i].float()
            return float((got[:, -1].float() - w).abs().max()
                         / w.abs().max())

        errs, agree = [rel(lg, 0)], [float(
            (tok == want[0].argmax(-1)).float().mean())]
        truth_rel = [] if truth is None else [rel(lg, 0, truth)]
        step = steps.make_serve_step(cfg, ctx=ctx, cache_len=L)
        step_ms = []
        for i in range(len(teacher)):
            (tok, caches, lg), t = ms_of(lambda: step(
                local, caches, {"tokens": teacher[i][:, None]}))
            step_ms.append(t)
            errs.append(rel(lg, i + 1))
            if truth is not None:
                truth_rel.append(rel(lg, i + 1, truth))
            agree.append(float((tok == want[i + 1].argmax(-1)).float()
                               .mean()))
        obs.shutdown()
        gloo = counters(metrics)
        res[name] = {"rel": errs, "truth_rel": truth_rel,
                     "agreement": agree,
                     "prefill_ms": prefill_ms, "step_ms": step_ms,
                     "param_bytes": live_bytes(local),
                     "cache_bytes": live_bytes(caches),
                     "gloo_bytes": gloo[0], "gloo_calls": gloo[1]}
        del local, caches, lg, want
        torch.cuda.empty_cache()
finally:
    dist.destroy_process_group()
json.dump(res, open(os.path.join(d, f"rank{rank}.json"), "w"))
'''


def _mesh_serve_reference(torch, d, name, arch, layers, dtype,
                          params=None, truth=False):
    """One process's prefill of MESH_SERVE_BATCH seeded 512-token prompts
    into caches of MESH_SERVE_CACHE positions and MESH_SERVE_DECODES
    greedy decode steps: the prompts, its greedy tokens (the ranks'
    teacher), every step's last-position logits and top-2 margin, its ms,
    parameter and cache bytes (``{name}_ref.npz`` for the ranks); then the
    same rows in two batches of half the size, teacher-forced alike: its
    drift from the whole batch per step (what a change of decode width
    alone does to the logits).  ``truth``: also the same parameters with
    fp32 activations, fed the same tokens (the npz's ``truth``), and each
    step's distance of this run's logits from them.  ``params``: seed 0's,
    when the caller has them."""
    import dataclasses

    import numpy as np

    from repro_torch.launch import steps
    from repro_torch.models.lm.model import init_lm
    from repro_torch.obs.audit import live_bytes
    cfg = _lm_config(arch, layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if params is None:
        params = init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    prompt = np.random.default_rng(7).integers(
        0, cfg.vocab, (MESH_SERVE_BATCH, MESH_SERVE_PROMPT))
    t0 = time.perf_counter()
    tok, caches, lg = steps.make_prefill_step(
        cfg, MESH_SERVE_CACHE)(
        params, {"tokens": torch.from_numpy(prompt).cuda()})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    step = steps.make_serve_step(cfg)
    logits, toks, step_ms = [lg[:, -1].float().cpu()], [], []
    for _ in range(MESH_SERVE_DECODES):
        toks.append(tok)
        t0 = time.perf_counter()
        tok, caches, lg = step(params, caches, {"tokens": tok[:, None]})
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(lg[:, -1].float().cpu())
    logits = torch.stack(logits)
    top2 = torch.topk(logits, 2, dim=-1).values
    res = {"prefill_ms": prefill_ms, "step_ms": step_ms,
           "margin": (top2[..., 0] - top2[..., 1]).min(dim=-1).values
           .tolist(),
           "param_bytes": live_bytes(params),
           "cache_bytes": live_bytes(caches), "layers": cfg.n_layers}
    teacher = torch.stack(toks)
    exact = {}
    if truth:
        del caches, lg
        fp32 = dataclasses.replace(cfg, dtype="float32")
        _, caches, lg = steps.make_prefill_step(fp32, MESH_SERVE_CACHE)(
            params, {"tokens": torch.from_numpy(prompt).cuda()})
        got = [lg[:, -1].float().cpu()]
        step32 = steps.make_serve_step(fp32)
        for t in teacher:
            _, caches, lg = step32(params, caches, {"tokens": t[:, None]})
            got.append(lg[:, -1].float().cpu())
        exact["truth"] = torch.stack(got)
        res["truth_rel"] = ((logits - exact["truth"]).abs().amax(
            dim=(1, 2)) / exact["truth"].abs().amax(dim=(1, 2))).tolist()
    np.savez(os.path.join(d, f"{name}_ref.npz"), prompt=prompt,
             teacher=teacher.cpu().numpy(), logits=logits.numpy(),
             **{k: v.numpy() for k, v in exact.items()})
    del caches, lg
    halves = []
    h = MESH_SERVE_BATCH // 2
    for rows in (slice(0, h), slice(h, MESH_SERVE_BATCH)):
        _, caches, lg = steps.make_prefill_step(
            cfg, MESH_SERVE_CACHE)(
            params, {"tokens": torch.from_numpy(prompt[rows]).cuda()})
        got = [lg[:, -1].float().cpu()]
        for t in teacher[:, rows]:
            _, caches, lg = step(params, caches, {"tokens": t[:, None]})
            got.append(lg[:, -1].float().cpu())
        halves.append(torch.stack(got))
        del caches, lg
    split = torch.cat(halves, dim=1)
    res["split_rel"] = ((split - logits).abs().amax(dim=(1, 2))
                        / logits.abs().amax(dim=(1, 2))).tolist()
    del params
    torch.cuda.empty_cache()
    return res


def phase_mesh_serve(torch, out, tmp):
    """Sharded serving on two gloo ranks sharing the card: (A) the
    serve phase's Gemma-3 4B traffic under ``--mesh data=2`` held to its
    one-process ``full`` run; (B) the model-axis prefill and decode steps
    of Gemma-3 4B and Zamba2-7B held to one process
    (``MESH_SERVE_STEPS``)."""
    from repro_torch.models.lm.model import init_lm
    full = out["serve"]["gemma"]["full"]
    d = os.path.join(tmp, "mesh_serve")
    os.makedirs(d)
    # one process at a rank's decode width (the streams' gate), and the
    # model-axis runs' references; Gemma's parameters serve both
    params = init_lm(torch.Generator(device="cuda").manual_seed(0),
                     _lm_config("gemma3_4b"))
    width = _serve(torch, tmp, "gemma_full_half", "gemma3_4b", params,
                   SERVE_FLAGS, n_slots=full["slots"] // 2)
    single = {}
    for name, arch, layers, dtype, _, truth in MESH_SERVE_STEPS:
        single[name] = _mesh_serve_reference(
            torch, d, name, arch, layers, dtype,
            params=params if (arch, layers, dtype) == ("gemma3_4b", None,
                                                       None) else None,
            truth=truth)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    job = {"serve": {"budget_gb": SERVE_BUDGET_GB, "flags": SERVE_FLAGS,
                     "n_slots": full["slots"]},
           "steps": MESH_SERVE_STEPS, "batch": MESH_SERVE_BATCH,
           "cache": MESH_SERVE_CACHE}
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_SERVE_RANK, str(rank),
         os.path.join(d, "init"), d, os.path.join(tmp, "obs"),
         str(MESH_GROUP_TIMEOUT_S), json.dumps(job)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    try:
        outs = [p.communicate(timeout=MESH_SERVE_WAIT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for rank, (p, (so, se)) in enumerate(zip(procs, outs)):
        if p.returncode:
            raise AssertionError(f"mesh_serve rank {rank} exit "
                                 f"{p.returncode}: {so[-2000:]} "
                                 f"{se[-3000:]}")
    ranks = []
    for rank in range(2):
        with open(os.path.join(d, f"rank{rank}.json")) as f:
            ranks.append(json.load(f))
    print(f"mesh_serve: rank 0's output: {outs[0][0][-800:]}", flush=True)
    bad = []
    # (A)
    want = {str(k): v for k, v in width["tokens"].items()}
    wide = {str(k): v for k, v in full["tokens"].items()}
    lo, hi = SERVE_AUDIT_BAND
    for rank, r in enumerate(ranks):
        a = r["serve"]
        diff = [rid for rid in want if a["tokens"][rid] != want[rid]]
        half = a["pool_bytes"] / (full["pool_bytes"] / 2)
        print(f"  mesh_serve (A) rank {rank}: {a['plan']} slots "
              f"{a['slot_lo']}..{a['slot_lo'] + a['n_local'] - 1} "
              f"generated {a['summary']['generated_tokens']} in "
              f"{a['wall_s']:.2f} s ({a['tok_s']:.1f} tok/s wall; one "
              f"process {full['tok_s']:.1f}), {a['summary']['prefills']} "
              f"prefills (chunks {a['chunks']}; one process "
              f"{full['chunks']}), {a['summary']['decode_steps']} decode "
              f"steps; its {a['n_local']}-slot decode step "
              f"{a['decode_step_ms']:.2f} ms; pool {a['pool_bytes']} B = "
              f"{half:.4f} x half of one process's {full['pool_bytes']}; "
              f"summed audit {a['audit_measured']} ratio "
              f"{a['audit_ratio']:.4f}; gloo {a['gloo_bytes']} B in "
              f"{a['gloo_calls']} calls; peak {a['peak']}; streams differ "
              f"from one process's at {width['slots']} slots for "
              f"{len(diff)} of {len(want)} requests; agreement with the "
              f"{full['slots']}-slot run {_agreement(a['tokens'], wide):.4f}"
              f" (the {width['slots']}-slot one process's "
              f"{_agreement({str(k): v for k, v in width['tokens'].items()}, wide):.4f})",
              flush=True)
        if diff:
            bad.append(f"(A) rank {rank}: streams differ for {diff}")
        if a["tokens"] != ranks[0]["serve"]["tokens"] \
                or a["summary"] != ranks[0]["serve"]["summary"]:
            bad.append(f"(A) rank {rank}'s report differs from rank 0's")
        if a["slots_per_device"] * 2 != full["slots"]:
            bad.append(f"(A) {a['slots_per_device']} slots a rank")
        if abs(half - 1.0) > 1e-3:
            bad.append(f"(A) rank {rank}: pool {half} x half")
        if not lo <= a["audit_ratio"] <= hi:
            bad.append(f"(A) audit {a['audit_ratio']}")
    # (B)
    for name, arch, layers, dtype, tol, truth in MESH_SERVE_STEPS:
        one = single[name]
        rs = [r[name] for r in ranks]
        worst = max(max(r["rel"][:1 if truth else None]) for r in rs)
        if truth:
            # every decode step against the fp32 twin: a rank's distance
            # over MESH_SERVE_TRUTH_FACTOR x one process's
            over = max(max(g / (MESH_SERVE_TRUTH_FACTOR * w)
                           for g, w in zip(r["truth_rel"][1:],
                                           one["truth_rel"][1:]))
                       for r in rs)
            print(f"  mesh_serve (B) {name}: distance from one process "
                  f"with fp32 activations per step, rank 0 "
                  f"{[f'{x:.2e}' for x in rs[0]['truth_rel']]}, one "
                  f"bf16 process {[f'{x:.2e}' for x in one['truth_rel']]}"
                  f"; decode steps held to {MESH_SERVE_TRUTH_FACTOR} x one "
                  f"process's: worst ratio {over:.3f} of the bound",
                  flush=True)
            if not over <= 1.0:
                bad.append(f"(B) {name}: a decode step {over:.3f} x "
                           f"{MESH_SERVE_TRUTH_FACTOR} x one process's "
                           f"distance from fp32")
        print(f"  mesh_serve (B) {name}: {arch} ({one['layers']} layers, "
              f"{dtype or 'config'} activations) data=1,model=2, batch "
              f"{MESH_SERVE_BATCH}, prompt {MESH_SERVE_PROMPT}, cache "
              f"{MESH_SERVE_CACHE}, {MESH_SERVE_DECODES} decode steps: "
              f"logits rel per step (rank 0) "
              f"{[f'{x:.2e}' for x in rs[0]['rel']]} (one process split "
              f"in two batches {[f'{x:.2e}' for x in one['split_rel']]}), "
              f"gated {'the prefill' if truth else 'every step'}: worst "
              f"{worst:.3e} (tolerance {tol}); greedy "
              f"agreement per step {rs[0]['agreement']} beside the "
              f"one-process top-2 margin {[round(m, 4) for m in one['margin']]}"
              f"; param bytes {[r['param_bytes'] for r in rs]} (one "
              f"process {one['param_bytes']}: "
              f"{[round(r['param_bytes'] / one['param_bytes'], 4) for r in rs]})"
              f", cache bytes {[r['cache_bytes'] for r in rs]} (one "
              f"process {one['cache_bytes']}: "
              f"{[round(r['cache_bytes'] / one['cache_bytes'], 4) for r in rs]})"
              f"; prefill ms {[round(r['prefill_ms'], 1) for r in rs]} (one "
              f"process {one['prefill_ms']:.1f}), decode ms a step "
              f"{[round(sorted(r['step_ms'])[len(r['step_ms']) // 2], 2) for r in rs]}"
              f" (one process "
              f"{sorted(one['step_ms'])[len(one['step_ms']) // 2]:.2f}); "
              f"gloo {[r['gloo_bytes'] for r in rs]} B in "
              f"{[r['gloo_calls'] for r in rs]} calls", flush=True)
        if not worst <= tol:
            bad.append(f"(B) {name}: logits rel {worst}")
    out["mesh_serve"] = {"ranks": ranks, "single": single}
    if bad:
        raise AssertionError("; ".join(bad))


def _terms(t_compute, t_memory, t_collective):
    return (f"compute {t_compute:.4e} s, memory {t_memory:.4e} s, "
            f"collective {t_collective:.4e} s")


def phase_dryrun(torch, out, tmp):
    """(a) Two dry-run combos in subprocesses that see no card; (b) the
    train_lm_kernel Gemma-3 4B step (no plan) traced on meta and run on
    the card: equal FLOP counts."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis.roofline import analyze
    from repro_torch.data.pipeline import TokenDataset, TokenDatasetConfig
    from repro_torch.exec import Planner
    from repro_torch.launch.mesh import HBM_BYTES
    from repro_torch.launch.steps import (
        ShapeSpec, make_train_step, params_specs,
    )
    from repro_torch.launch.train import lm_batch
    from repro_torch.models.lm.model import init_lm
    from repro_torch.obs.audit import measure_step, plan_audit, trace_step
    from repro_torch.optim.adamw import adamw_init
    smi = out["smi"]
    d = os.path.join(tmp, "dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single", "--out", d], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch, shape in DRYRUN_COMBOS]
    try:
        outs = [p.communicate(timeout=DRYRUN_WAIT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    recs = {}
    for (arch, shape), p, (so, se) in zip(DRYRUN_COMBOS, procs, outs):
        if p.returncode:
            raise AssertionError(f"dryrun {arch} x {shape} exit "
                                 f"{p.returncode}: {so[-2000:]} "
                                 f"{se[-3000:]}")
        with open(os.path.join(d, f"{arch}_{shape}_16x16.json")) as f:
            rec = json.load(f)
        if rec["status"] != "ok":
            raise AssertionError(f"dryrun {arch} x {shape}: "
                                 f"{rec['status']} {rec.get('error')}")
        a = rec["analytic"]
        peak = rec["traced_peak_bytes_per_chip"]
        print(f"dryrun (a) {arch} x {shape} x 16x16, rank 0 of 256 traced "
              f"on meta with no card in {rec['t_trace_s']} s: peak {peak} B"
              f" = {peak / HBM_BYTES:.4f} of the card's 80 GB (args "
              f"{rec['traced_arg_bytes_per_chip']}, temp "
              f"{rec['traced_temp_bytes_per_chip']}); flops "
              f"{rec['traced_flops_per_chip']:.4e} traced, "
              f"{a['flops_per_chip']:.4e} analytic "
              f"({rec['traced_flops_per_chip'] / a['flops_per_chip']:.3f}x);"
              f" collective bytes {rec['traced_coll_detail']}; H100 terms, "
              f"analytic: {_terms(a['t_compute_s'], a['t_memory_s'], a['t_collective_s'])}"
              f" -> {a['bottleneck']}; traced: "
              f"{_terms(rec['traced_t_compute_s'], rec['traced_t_memory_s'], rec['traced_t_collective_s'])}"
              f" -> {rec['traced_bottleneck']} [{smi}]", flush=True)
        recs[f"{arch}/{shape}"] = {k: v for k, v in rec.items()
                                   if k != "traced_flops_by_op"}
    # (b) the same step traced on meta and run on the card
    cfg = _gemma12(torch)
    hb = TokenDataset(TokenDatasetConfig(vocab=cfg.vocab, seq_len=LM_SEQ,
                                         batch=LM_BATCH)).batch_at(0)
    step = make_train_step(cfg)
    meta = params_specs(cfg)
    t0 = time.time()
    traced = trace_step(step, {"params": meta, "opt": adamw_init(meta)},
                        lm_batch(cfg, hb, 0, 0, "meta"))
    t_trace = time.time() - t0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    state = {"params": params, "opt": adamw_init(params)}
    batch = lm_batch(cfg, hb, 0, 0, "cuda")
    with FlopCounterMode(display=False) as fc:
        step(state, batch)
    torch.cuda.synchronize()
    card_flops = fc.get_total_flops()
    m = measure_step(lambda: step(state, batch), time_iters=3,
                     device="cuda")
    del params, state, batch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    card_peak = m["peak_bytes"] - base
    step_s = m["wall_us"] / 1e6
    roof = analyze(traced, cfg, ShapeSpec("gemma12_4k", "train", LM_SEQ,
                                          LM_BATCH), "1", 1)
    bound = max(roof.t_compute, roof.t_memory)
    ratio = traced["peak_bytes"] / card_peak
    audit = plan_audit(
        Planner.for_model(cfg, LM_BATCH, LM_SEQ),
        {k: traced[k] for k in ("peak_bytes", "argument_size_in_bytes",
                                "temp_size_in_bytes", "method")},
        "dryrun", extra={"arch": "gemma3_4b", "layers": LM_LAYERS,
                         "cuda_max_allocated": card_peak,
                         "trace_over_cuda": ratio})
    print(f"dryrun (b) Gemma-3 4B, {LM_LAYERS} layers, batch {LM_BATCH}, "
          f"seq {LM_SEQ}, no plan, one device: flops traced on meta "
          f"{traced['flops']} (in {t_trace:.1f} s), on the card "
          f"(FlopCounterMode) {card_flops}: "
          f"{'equal' if traced['flops'] == card_flops else 'DIFFER'}; "
          f"peak traced {traced['peak_bytes']} B (args "
          f"{traced['argument_size_in_bytes']}, temp "
          f"{traced['temp_size_in_bytes']}), card "
          f"{card_peak} B above the {base} B already allocated "
          f"(cuda_max_allocated): traced/card {ratio:.4f}, recorded as a "
          f"dryrun audit; step {step_s:.4f} s (median of 3, CUDA events) "
          f"against the H100 roofline's max(t_compute, t_memory) "
          f"{bound:.4f} s of the traced counts (compute "
          f"{roof.t_compute:.4f} s, {traced['flops']:.4e} FLOP; memory "
          f"{roof.t_memory:.4f} s, {traced['bytes_accessed']:.4e} B "
          f"accessed): {bound / step_s:.4f} of the bound [{smi}]",
          flush=True)
    out["dryrun"] = {"combos": recs, "flops": [traced["flops"], card_flops],
                     "peaks": [traced["peak_bytes"], card_peak],
                     "audit": audit, "step_s": step_s, "bound_s": bound}
    if traced["flops"] != card_flops:
        by_card = {str(k): v for k, v in fc.get_flop_counts()
                   .get("Global", {}).items()}
        raise AssertionError(f"dryrun (b): traced flops {traced['flops']} "
                             f"{traced['flops_by_op']} != card "
                             f"{card_flops} {by_card}")


def _run_example(name, *flags):
    """Run ``examples/torch_<name>.py`` on the card; returns its stdout
    and seconds.  It must exit 0 and end with its ``<name> OK`` line."""
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, os.path.join("examples", f"torch_{name}.py"),
         *flags], cwd=ROOT, env=dict(os.environ,
                                     PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=EXAMPLE_WAIT_S)
    lines = r.stdout.strip().splitlines()
    if r.returncode or not lines or lines[-1] != f"{name} OK":
        raise AssertionError(f"example {name} exit {r.returncode}: "
                             f"{r.stdout[-3000:]} {r.stderr[-3000:]}")
    return r.stdout, time.time() - t0


def _matches(pattern, text, what):
    found = re.findall(pattern, text, re.M)
    if not found:
        raise AssertionError(f"no {what} line in {text[-2000:]}")
    return found


def phase_examples(torch, out, tmp):
    """The four examples of the port, each a subprocess on the card run as
    its reference's docstring invokes it (the 100M trainer at
    ``EXAMPLE_LM_STEPS`` of its default 300, its checkpoint into the
    smoke's temporary directory), one after another so that each has the
    card to itself; the numbers each prints that are worth keeping."""
    smi = out["smi"]
    res = {}
    text, s = _run_example("quickstart")
    mem = _matches(r"^traced temp bytes \[(.+?)\s*\]:.*; traced (\d+) B, "
                   r"measured peak (\d+) B", text, "memory")
    loss = _matches(r"^step\s+(\d+) loss (\S+)$", text, "loss")[-1]
    res["quickstart"] = {"s": s, "final_loss": float(loss[1]),
                         "memory": {n: [int(t), int(p)] for n, t, p in mem}}
    print(f"examples quickstart ({s:.1f} s): "
          + "; ".join(f"{n} traced temp {t} B, measured peak {p} B"
                      for n, t, p in mem)
          + f" (the peaks include the arguments and cuDNN's workspace); "
          f"final loss {float(loss[1]):.4f} at step {loss[0]} [{smi}]",
          flush=True)
    text, s = _run_example("large_image_cnn")
    plan = _matches(r"^residencized:\s+(.*)$", text, "plan")[0]
    pred = float(_matches(r"^  predicted step: (\S+) us", text,
                          "predicted step")[0])
    steps = _matches(r"^  step (\d) loss (\S+)  peak (\d+) B vs est_bytes "
                     r"(\d+) B", text, "step")
    res["large_image_cnn"] = {
        "s": s, "plan": plan, "predicted_step_us": pred,
        "steps": [[float(l), int(p), int(e)] for _, l, p, e in steps]}
    print(f"examples large_image_cnn ({s:.1f} s): "
          f"{plan.split(' cost_model')[0]});"
          f" predicted step {pred:.0f} us on the card's calibrated table; "
          + "; ".join(f"step {i} loss {l} peak {p} B = {int(p) / int(e):.2f}x"
                      f" est_bytes {e} B" for i, l, p, e in steps)
          + f" (an audit: parameters, batch and cuDNN's workspace are "
          f"outside the estimate) [{smi}]", flush=True)
    text, s = _run_example("serve_batched")
    toks, wall, rate, active, decode = _matches(
        r"^served \d+ requests / (\d+) tokens in (\S+)s \((\S+) tok/s\); "
        r"max (\d+) concurrent, (\d+) decode steps", text, "served")[0]
    res["serve_batched"] = {"s": s, "tokens": int(toks),
                            "wall_s": float(wall), "tok_s": float(rate),
                            "max_active": int(active),
                            "decode_steps": int(decode)}
    print(f"examples serve_batched ({s:.1f} s): {toks} tokens in {wall} s, "
          f"{rate} tok/s, {decode} decode steps, at most {active} "
          f"concurrent [{smi}]", flush=True)
    text, s = _run_example("train_lm_100m", "--steps",
                           str(EXAMPLE_LM_STEPS), "--out",
                           os.path.join(tmp, "train_100m_torch"))
    first, final, verdict = _matches(r"^loss (\S+) -> (\S+) \((.*)\)$",
                                     text, "loss")[0]
    n = int(_matches(r" steps=(\d+)$", text, "arch")[0])
    ms = int(_matches(r"^step\s+\d+ loss \S+ \(\d+s, (\d+) ms/step\)$",
                      text, "step")[-1])
    res["train_lm_100m"] = {"s": s, "first": float(first),
                            "final": float(final), "steps": n,
                            "ms_per_step": ms,
                            "learned": verdict == "LEARNED"}
    print(f"examples train_lm_100m ({s:.1f} s): loss {first} -> {final} "
          f"({verdict}), {ms} ms a step over {n} steps (host clock, "
          f"synchronised at logged steps) [{smi}]", flush=True)
    out["examples"] = res


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
    """Allocator snapshots of five VGG-16 runs: every block live at the
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
                        ("budget", ["--budget-gb", str(BUDGET_GB)]),
                        ("pipeline", ["--strategy", "pipeline_rows",
                                      "--rows", str(PIPE_ROWS)])):
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
    serve_dir = os.path.join(tmp, "obs", "serve")
    artefacts = sorted(os.path.join(dp, f)
                       for dp, _, fs in os.walk(serve_dir)
                       for f in fs if f.endswith(".json"))
    if not artefacts:
        raise AssertionError("obs: no serve artefacts to audit")
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis.audit",
                        "--check", *traces, *artefacts], cwd=ROOT,
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
    if "| serve_pool |" not in r.stdout:
        raise AssertionError("obs: the audit saw no serve_pool records")
    print(f"obs: {len(traces)} traces and {len(artefacts)} serve artefacts "
          f"gated; twophase_h N=8 host counters "
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
                  ("pipeline", lambda: phase_pipeline(torch, out, tmp)),
                  ("mesh", lambda: phase_mesh(torch, out, tmp)),
                  ("ckpt", lambda: phase_ckpt(torch, out, tmp)),
                  ("kernel_swa", lambda: phase_kernel_swa(torch, out)),
                  ("kernel_ssd", lambda: phase_kernel_ssd(torch, out)),
                  ("train_lm_kernel", lambda: phase_train_lm_kernel(
                      torch, out, tmp)),
                  ("train_lm_rows", lambda: phase_train_lm_rows(
                      torch, out, tmp)),
                  ("train_lm_ssm", lambda: phase_train_lm_ssm(
                      torch, out, tmp)),
                  ("train_lm_dense", lambda: phase_train_lm_dense(
                      torch, out, tmp)),
                  ("train_lm_moe", lambda: phase_train_lm_moe(
                      torch, out, tmp)),
                  ("train_lm_vlm_encdec", lambda: phase_train_lm_vlm_encdec(
                      torch, out, tmp)),
                  ("mesh_lm", lambda: phase_mesh_lm(torch, out, tmp)),
                  ("serve", lambda: phase_serve(torch, out, tmp)),
                  ("mesh_serve", lambda: phase_mesh_serve(torch, out, tmp)),
                  ("dryrun", lambda: phase_dryrun(torch, out, tmp)),
                  ("examples", lambda: phase_examples(torch, out, tmp)),
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
    k, sw, sd, dw = out["kernel"], out["swa"], out["ssd"], \
        out["dwconv_wgrad"]
    csrc = "src/repro_torch/kernels/csrc/"

    def row(name, replaces, launches, r, library_ms):
        return {"name": name, "route": "cuda", "source": f"{csrc}{name}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": r.get("max_abs_err"),
                "rel_err": r.get("rel_err"), "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": library_ms}

    print(out["smi"])
    print(json.dumps({"kernels": [
        row("conv2d_rows", "src/repro/kernels/conv2d_rows.py:101",
            out["launches"] + out["resnet_launches"], k, k["library_ms"]),
        row("swa_attention", "src/repro/kernels/swa_attention.py:111",
            out["swa_launches"], sw, sw["library_ms"]),
        row("ssd_scan", "src/repro/kernels/ssd_chunk.py:78",
            sd["launches"], sd, None),
        row("dwconv_wgrad", None, dw["launches"], dw, dw["library_ms"]),
        row("dwconv2d", None, out["dwconv2d"]["launches"], out["dwconv2d"],
            out["dwconv2d"]["library_ms"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
