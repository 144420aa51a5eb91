"""The port's VGG-16 as the benchmark drives it: its module list and head,
and where each of the reference's leaves lies in its parameter tree."""

from __future__ import annotations

from repro_torch.models.cnn import vgg
from repro_torch.models.cnn.layers import Conv

head_apply = vgg.head_apply


def modules(cfg):
    """``vgg.vgg16_modules`` at the configuration's widths (raises if the
    port's layer list differs from the configuration)."""
    mods = vgg.vgg16_modules(cfg["stages"][0][0] / 64)
    got = [m.cout for m in mods if isinstance(m, Conv)]
    want = [c for c, n in cfg["stages"] for _ in range(n)]
    if got != want:
        raise ValueError(f"the port's VGG-16 widths {got} are not the "
                         f"configuration's {want}")
    return mods


def paths(mods):
    """``{reference leaf: path in the port's tree}``."""
    out, i = {}, 0
    for j, m in enumerate(mods):
        if isinstance(m, Conv):
            out[f"conv{i}.w"] = ("trunk", j, "w")
            out[f"conv{i}.b"] = ("trunk", j, "b")
            i += 1
    out["head.w"] = ("head", "w")
    out["head.b"] = ("head", "b")
    return out
