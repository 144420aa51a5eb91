"""Plain ConvNeXt (Liu et al., A ConvNet for the 2020s) in NCHW, as the
paper's code computes it: a 4x4/4 stem conv and a channel LayerNorm; the
configuration's stages of blocks, each stage but the first after a
LayerNorm and a 2x2/2 conv; a block is a depthwise 7x7 conv
(``F.conv2d(groups=C)``), then channels-last LayerNorm, ``F.linear`` to
4C, GELU (erf), ``F.linear`` back, the layer scale and the residual add;
the head is global average pooling, LayerNorm and a linear layer.  fp32,
column-centric, nothing of the program under test.

Departures, as the configuration states: stochastic depth off; the layer
scale gamma drawn on [0.5, 1.5) in place of the paper's 1e-6 (at 1e-6 a
block's branch adds a millionth of the residual stream, and a wrong row of
a block would pass every comparison).

Leaves: ``stem.{w,b}`` (OIHW), ``stem_ln.{scale,bias}``; for stage ``i >=
1`` ``down{i}.ln.{scale,bias}``, ``down{i}.{w,b}``; for block ``j``
``block{j}.dw.{w,b}`` (w: C x 1 x 7 x 7), ``block{j}.ln.{scale,bias}``,
``block{j}.pw1.{w,b}`` (w: C x 4C), ``block{j}.pw2.{w,b}`` (w: 4C x C),
``block{j}.gamma``; ``head_ln.{scale,bias}``, ``head.w`` (C x classes),
``head.b``."""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from reference.common import Params, classifier, follow, he_normal


def dims(cfg) -> List[int]:
    return [c for c, _ in cfg["stages"]]


def blocks(cfg) -> List[Tuple[int, int, int]]:
    """``(stage, C, H at its input)`` of each block."""
    out, h = [], cfg["image"] // cfg["stem"]["s"]
    for i, (c, n) in enumerate(cfg["stages"]):
        if i:
            h //= cfg["downsample"]["s"]
        out += [(i, c, h)] * n
    return out


def init_params(cfg, gen: torch.Generator, device) -> Params:
    st, ds, k = cfg["stem"], cfg["downsample"], cfg["dw_kernel"]
    ds_ = dims(cfg)
    e = cfg["expansion"]
    specs = [("stem.w", (ds_[0], cfg["channels"], st["k"], st["k"]),
              st["k"] ** 2 * cfg["channels"])]
    for i in range(1, len(ds_)):
        specs.append((f"down{i}.w", (ds_[i], ds_[i - 1], ds["k"], ds["k"]),
                      ds["k"] ** 2 * ds_[i - 1]))
    for j, (_, c, _) in enumerate(blocks(cfg)):
        specs += [(f"block{j}.dw.w", (c, 1, k, k), k * k),
                  (f"block{j}.pw1.w", (c, e * c), c),
                  (f"block{j}.pw2.w", (e * c, c), e * c)]
    params = he_normal(specs, gen, device)
    zeros = lambda c: torch.zeros(c, device=device)
    ones = lambda c: torch.ones(c, device=device)
    params["stem.b"] = zeros(ds_[0])
    norms = [("stem_ln", ds_[0])]
    for i in range(1, len(ds_)):
        params[f"down{i}.b"] = zeros(ds_[i])
        norms.append((f"down{i}.ln", ds_[i - 1]))
    bl = blocks(cfg)
    gammas = 0.5 + torch.rand(sum(c for _, c, _ in bl), generator=gen,
                              device=device)
    at = 0
    for j, (_, c, _) in enumerate(bl):
        params[f"block{j}.dw.b"] = zeros(c)
        params[f"block{j}.pw1.b"] = zeros(e * c)
        params[f"block{j}.pw2.b"] = zeros(c)
        params[f"block{j}.gamma"] = gammas[at:at + c]
        at += c
        norms.append((f"block{j}.ln", c))
    norms.append(("head_ln", ds_[-1]))
    for name, c in norms:
        params[f"{name}.scale"] = ones(c)
        params[f"{name}.bias"] = zeros(c)
    params.update(classifier(ds_[-1], cfg["n_classes"], gen, device))
    return params


def logits_fn(cfg):
    st, ds, k, eps = (cfg["stem"], cfg["downsample"], cfg["dw_kernel"],
                      cfg["norm_eps"])
    layout = blocks(cfg)

    def ln(params, name, x):
        """LayerNorm over the last (channel) axis."""
        return F.layer_norm(x, (x.shape[-1],), params[f"{name}.scale"],
                            params[f"{name}.bias"], eps)

    def ln_nchw(params, name, x):
        return ln(params, name, x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)

    def fn(params: Params, x: torch.Tensor) -> torch.Tensor:
        x = F.conv2d(x, params["stem.w"], params["stem.b"], stride=st["s"])
        x = ln_nchw(params, "stem_ln", x)
        stage = 0
        for j, (i, c, _) in enumerate(layout):
            if i != stage:
                stage = i
                x = ln_nchw(params, f"down{i}.ln", x)
                x = F.conv2d(x, params[f"down{i}.w"], params[f"down{i}.b"],
                             stride=ds["s"])
            b = f"block{j}"
            y = F.conv2d(x, params[f"{b}.dw.w"], params[f"{b}.dw.b"],
                         padding=k // 2, groups=c)
            y = ln(params, f"{b}.ln", y.permute(0, 2, 3, 1))
            y = F.gelu(F.linear(y, params[f"{b}.pw1.w"].t(),
                                params[f"{b}.pw1.b"]))
            y = F.linear(y, params[f"{b}.pw2.w"].t(), params[f"{b}.pw2.b"])
            x = x + (y * params[f"{b}.gamma"]).permute(0, 3, 1, 2)
        pooled = ln(params, "head_ln", x.mean(dim=(2, 3)))
        return pooled @ params["head.w"] + params["head.b"]

    return fn


def train(cfg, params: Params, batches, chunk: int) -> dict:
    """Three SGD steps of the configuration's optimizer (common.follow)."""
    return follow(logits_fn(cfg), params, batches, cfg["optimizer"], chunk)


def flops_per_image(cfg) -> int:
    """Forward FLOPs of one image: the stem's, the downsampling convs',
    each block's depthwise and two 1x1 convs' and the classifier's
    multiply-adds, counted twice (LayerNorm, GELU, the layer scale and the
    pool not counted)."""
    st, ds, k, e = (cfg["stem"], cfg["downsample"], cfg["dw_kernel"],
                    cfg["expansion"])
    d = dims(cfg)
    h = cfg["image"] // st["s"]
    macs = h * h * cfg["channels"] * d[0] * st["k"] ** 2
    for i in range(1, len(d)):
        h //= ds["s"]
        macs += h * h * d[i - 1] * d[i] * ds["k"] ** 2
    for _, c, hb in blocks(cfg):
        macs += hb * hb * c * (k * k + 2 * e * c)
    macs += d[-1] * cfg["n_classes"]
    return 2 * macs
