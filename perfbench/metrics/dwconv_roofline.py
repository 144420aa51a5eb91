"""The depthwise convolutions' share of their roofline in the profiled
steps: the least time the card needs for the model's depthwise work at the
cell's batch, over the device time inside the program's ``dwconv`` ranges
(``dwconv_ms``).  The work is each block's depthwise conv over whole
images, three times: its forward, its data gradient and its weight
gradient, each ``2 k^2`` FLOPs an output element and each reading two
maps of the conv's size and writing (or reading) its weights once.  The
least time is the larger of the FLOPs at the fp32 peak and the bytes at
the HBM rate (harness/peaks.py).  Rows recomputed and halos add time, not
work, so the same work counts whatever runs it.  Nothing where the model
has no depthwise conv or the run no ``dwconv`` range."""

from typing import List, Tuple

from harness import spec
from harness.peaks import PEAK_FP32_FLOPS, PEAK_HBM_BYTES, bound

#: forward, data gradient, weight gradient
PASSES = 3


def convs(cfg) -> List[Tuple[int, int, int, int]]:
    """``(C, H, W, k)`` of each block's depthwise conv (stride 1, 'same'):
    a ConvNeXt configuration's blocks after the stem and each stage's
    downsampling."""
    if "dw_kernel" not in cfg:
        return []
    h = cfg["image"] // cfg["stem"]["s"]
    out = []
    for i, (c, n) in enumerate(cfg["stages"]):
        if i:
            h //= cfg["downsample"]["s"]
        out += [(c, h, h, cfg["dw_kernel"])] * n
    return out


def work(cfg, batch: int, itemsize: int = 4) -> Tuple[float, float]:
    """(FLOPs, bytes) of one step's depthwise work."""
    flops = nbytes = 0
    for c, h, w, k in convs(cfg):
        n = batch * h * w * c
        flops += PASSES * 2 * k * k * n
        nbytes += PASSES * itemsize * (2 * n + k * k * c)
    return float(flops), float(nbytes)


def read(run):
    ms = spec.metric("dwconv_ms", run.cell.root).device_ms(run)
    flops, nbytes = work(run.cell.cfg, run.cell.traffic["batch"])
    if not ms or not flops:
        return None
    need_ms, _ = bound(1e3 * flops / PEAK_FP32_FLOPS,
                       1e3 * nbytes / PEAK_HBM_BYTES)
    return 100.0 * need_ms * run.profile["steps"] / ms
