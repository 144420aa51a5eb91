"""The whole step's share of the H100's fp32 peak (67 TFLOP/s, TF32 off):
the analytic model FLOPs of the window's images (forward convolutions and
classifier from the plain reference's count, times 3 for forward and
backward; recomputed rows not counted) over the window's seconds."""

from harness import spec
from harness.peaks import PEAK_FP32_FLOPS


def read(run):
    cfg, w = run.cell.cfg, run.window
    flops = spec.reference(cfg["arch"]).flops_per_image(cfg)
    return 100.0 * 3 * flops * w.images / w.seconds / PEAK_FP32_FLOPS
