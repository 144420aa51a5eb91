"""The port's ConvNeXt as the benchmark drives it: its module list and
head, and where each of the reference's leaves lies in its parameter
tree."""

from __future__ import annotations

from repro_torch.models.cnn import convnext
from repro_torch.models.cnn.layers import Conv, ConvNeXtBlock, LayerNorm

head_apply = convnext.head_apply


def modules(cfg):
    """``convnext.convnext_modules`` at the configuration's widths and
    depths (raises if the port's layers differ from the configuration)."""
    mods = convnext.convnext_modules(cfg["stages"][0][0] / 128,
                                     [n for _, n in cfg["stages"]])
    got = [(m.dim, m.k, m.expansion, m.eps) for m in mods
           if isinstance(m, ConvNeXtBlock)]
    want = [(c, cfg["dw_kernel"], cfg["expansion"], cfg["norm_eps"])
            for c, n in cfg["stages"] for _ in range(n)]
    convs = [(m.cout, m.k, m.s) for m in mods if isinstance(m, Conv)]
    st, ds = cfg["stem"], cfg["downsample"]
    want_convs = [(st["cout"], st["k"], st["s"])] + [
        (c, ds["k"], ds["s"]) for c, _ in cfg["stages"][1:]]
    if got != want or convs != want_convs:
        raise ValueError(f"the port's ConvNeXt {got} {convs} is not the "
                         f"configuration's {want} {want_convs}")
    return mods


def paths(mods):
    """``{reference leaf: path in the port's tree}``: the stem conv and its
    LayerNorm are modules 0 and 1; a stage's downsampling LayerNorm and
    conv come before its blocks."""
    out, block, stage = {}, 0, 0
    for j, m in enumerate(mods):
        if isinstance(m, ConvNeXtBlock):
            b = f"block{block}"
            for part in ("dw", "pw1", "pw2"):
                out.update({f"{b}.{part}.{k}": ("trunk", j, part, k)
                            for k in ("w", "b")})
            out.update({f"{b}.ln.{k}": ("trunk", j, "ln", k)
                        for k in ("scale", "bias")})
            out[f"{b}.gamma"] = ("trunk", j, "gamma")
            block += 1
        elif isinstance(m, Conv):
            name = "stem" if j == 0 else f"down{stage}"
            out.update({f"{name}.{k}": ("trunk", j, k) for k in ("w", "b")})
        elif isinstance(m, LayerNorm):
            if j == 1:
                name = "stem_ln"
            else:
                stage += 1
                name = f"down{stage}.ln"
            out.update({f"{name}.{k}": ("trunk", j, k)
                        for k in ("scale", "bias")})
    out.update({f"head_ln.{k}": ("head", "ln", k) for k in ("scale", "bias")})
    out["head.w"] = ("head", "w")
    out["head.b"] = ("head", "b")
    return out
