"""The port's ResNet-50 as the benchmark drives it: its module list and
head, and where each of the reference's leaves lies in its parameter
tree."""

from __future__ import annotations

from repro_torch.models.cnn import resnet
from repro_torch.models.cnn.layers import Bottleneck

head_apply = resnet.head_apply

_BN = ("scale", "bias", "mean", "var")


def modules(cfg):
    """``resnet.resnet50_modules`` at the configuration's widths (raises if
    the port's blocks differ from the configuration)."""
    mods = resnet.resnet50_modules(cfg["stem"]["cout"] / 64)
    got = [(m.cout, m.s, m.project) for m in mods
           if isinstance(m, Bottleneck)]
    want, first = [], cfg["stages"][0][0]
    for cout, n in cfg["stages"]:
        want += [(cout, 2 if (i == 0 and cout != first) else 1, i == 0)
                 for i in range(n)]
    if got != want or mods[0].cout != cfg["stem"]["cout"]:
        raise ValueError(f"the port's ResNet-50 blocks {got} are not the "
                         f"configuration's {want}")
    return mods


def paths(mods):
    """``{reference leaf: path in the port's tree}``: the stem conv and its
    BatchNorm are modules 0 and 1, block ``j`` is module ``4 + j``."""
    out = {"stem.w": ("trunk", 0, "w")}
    out.update({f"stem_bn.{k}": ("trunk", 1, k) for k in _BN})
    blocks = [j for j, m in enumerate(mods) if isinstance(m, Bottleneck)]
    for b, j in enumerate(blocks):
        parts = ("c1", "c2", "c3") + (("sc",) if mods[j].project else ())
        for part in parts:
            out[f"block{b}.{part}.w"] = ("trunk", j, part, "w")
            out.update({f"block{b}.{part}_bn.{k}": ("trunk", j,
                                                    f"{part}_bn", k)
                        for k in _BN})
    out["head.w"] = ("head", "w")
    out["head.b"] = ("head", "b")
    return out
