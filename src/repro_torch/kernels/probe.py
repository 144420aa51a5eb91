"""Probes of the SSD scan kernel on the card: where its time goes.

    PYTHONPATH=src python -m repro_torch.kernels.probe

No path of the port runs this.  It builds two libraries beside the
kernels' (``build/repro_torch_kernels``):

* ``csrc/mma_tf32_probe.cu`` — the rate of ``mma.sync.m16n8k8`` TF32 at 1,
  2 and 4 warps per SM sub-partition, the ceiling of the products the scan
  issues;
* ``csrc/ssd_scan.cu`` with ``-DSSD_PHASES`` — the scan summing
  ``clock64()`` cycles per phase of each chunk for every warp.

and prints, at Zamba2-7B's Mamba2 widths (1 x 4096 x 32 x 224, N 64) and
each chunk of ``SSD_CHUNKS`` whose shared memory fits: the instrumented
call's time, CTAs per SM, and the cycles per chunk of each of the 4 warps
(averaged over the CTAs) by phase — copies and wait, y, state update,
next chunk's Prep, closing barrier — beside the loop's total.  The
counters slow the scan a little; chip_smoke.py times the kernel itself.
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ssd_chunk as sc
from repro_torch.kernels.ops import SSD_CHUNKS

ZAMBA = (1, 4096, 32, 224, 64)
PHASES = ("copy+wait", "y", "state", "next prep", "barrier")


def _build(src: str, name: str, flags=()) -> ctypes.CDLL:
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / f"lib{name}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *flags, "-o", str(out),
                    str(build.CSRC / src)], check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def _ms(fn, iters=10):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def mma_rate():
    lib = _build("mma_tf32_probe.cu", "mma_tf32_probe")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mma_tf32_probe_launch.argtypes = [p, i, i, i, p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 20000
    for wps in (1, 2, 4):
        out = torch.empty(sms * 128 * wps, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        ms = _ms(lambda: lib.mma_tf32_probe_launch(out.data_ptr(), sms, wps,
                                                   iters, stream), iters=3)
        flops = sms * 4 * wps * iters * 8 * 2 * 16 * 8 * 8
        print(f"mma.sync m16n8k8 tf32, {wps} warp(s) per SM sub-partition: "
              f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)


def ssd_phases():
    lib = _build("ssd_scan.cu", "ssd_scan_phases", ("-DSSD_PHASES",))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_launch.argtypes = [p] * 7 + [i] * 6 + [p]
    lib.ssd_scan_set_phases.argtypes = [p]
    Bt, S, H, P, N = ZAMBA
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(Bt, S, H, P, generator=g) * 0.5).cuda()
    B, C = ((torch.randn(Bt, S, N, generator=g) * 0.5).cuda()
            for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn(Bt, S, H, generator=g))
    a = torch.exp(-dt * torch.exp(torch.randn(Bt, S, H, generator=g) * 0.1))
    a, dt = a.cuda(), dt.cuda()
    y = torch.empty_like(x)
    tiles = -(-P // sc.P_TILE)
    phases = torch.zeros(Bt * H * tiles * 4 * 6, dtype=torch.int64,
                         device="cuda")
    lib.ssd_scan_set_phases(phases.data_ptr())
    props = torch.cuda.get_device_properties(0)
    for chunk in SSD_CHUNKS:
        if sc.launch_problem(chunk, N):
            continue
        gram = torch.empty(sc.gram_floats(Bt, S, chunk), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            err = lib.ssd_scan_launch(x.data_ptr(), B.data_ptr(),
                                      C.data_ptr(), a.data_ptr(),
                                      dt.data_ptr(), y.data_ptr(),
                                      gram.data_ptr(), Bt, S, H, P, N, chunk,
                                      stream)
            if err:
                raise RuntimeError(f"ssd_scan (phases) launch: cudaError "
                                   f"{err}")

        ms = _ms(call)
        err = float((y - sc.ssd_scan_plain(x, B, C, a, dt, chunk)).abs()
                    .max())
        per = phases.view(-1, 4, 6).double().mean(0) / (S // chunk)
        smem = sc.smem_bytes(chunk, N)
        per_sm = min(2 if smem <= sc.TWO_PER_SM else 1,
                     props.max_threads_per_multi_processor // 128)
        rows = "; ".join(
            f"warp {w}: " + " ".join(f"{n} {per[w, k]:.0f}"
                                     for k, n in enumerate(PHASES))
            + f" (loop {per[w, 5]:.0f})" for w in range(4))
        print(f"ssd_scan phases at chunk {chunk} ({sc.stages(chunk, N)} "
              f"stage(s), {smem} B: {per_sm} CTA(s) per SM by shared memory): "
              f"{ms:.4f} ms, "
              f"max abs err {err:.2e}; cycles per chunk: {rows}",
              flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe: no CUDA device")
    print(torch.cuda.get_device_name(0), flush=True)
    mma_rate()
    ssd_phases()


if __name__ == "__main__":
    main()
