"""``conv2d_rows``' share of its roofline in the profiled steps: the larger
of the operation and byte times that the convolutions it runs need at the
fp32 peak and the HBM rate (each input byte read once, the output written
once; harness/peaks.py), over the kernel's profiled device time.  Read
only where every profiled launch of the kernel is one of those
convolutions, once a step."""

from harness.peaks import bound, bound_parts

KERNEL = "conv2d_rows"


def _vgg16(cfg, batch):
    k, h, cin, out = cfg["conv_kernel"], cfg["image"], cfg["channels"], []
    for cout, n in cfg["stages"]:
        for _ in range(n):
            out.append((batch, h, h, cin, cout, k, 1, k // 2))
            cin = cout
        h //= cfg["pool"]
    return out


def _resnet50(cfg, batch):
    st, hw = cfg["stem"], cfg["image"]
    return [(batch, hw, hw, cfg["channels"], st["cout"], st["k"], st["s"],
             st["p"])]


#: ``(B, H, W, cin, cout, k, s, p)`` of the top-level convolutions the
#: kernel-backed engines hand to the kernel, by architecture: every VGG-16
#: trunk convolution; ResNet-50's stem (the blocks' sit inside blocks)
CONVS = {"vgg16": _vgg16, "resnet50": _resnet50}


def convs(cfg, batch):
    shapes = CONVS.get(cfg["arch"])
    return shapes(cfg, batch) if shapes else []


def read(run):
    p = run.profile
    if not p:
        return None
    secs = sum(s for n, (s, _) in p["kernels"].items() if KERNEL in n)
    count = sum(c for n, (_, c) in p["kernels"].items() if KERNEL in n)
    shapes = convs(run.cell.cfg, run.cell.traffic["batch"])
    if not count or count != len(shapes) * p["steps"]:
        return None
    ops = sum(bound_parts(*c)[0] for c in shapes)
    nbytes = sum(bound_parts(*c)[1] for c in shapes)
    need_ms, _ = bound(ops, nbytes)
    return 100.0 * need_ms * p["steps"] / (1e3 * secs)
