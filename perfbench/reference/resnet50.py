"""Plain ResNet-50 (He et al., Table 1) in NCHW: a 7x7/2 stem with
BatchNorm and ReLU, a 3x3/2 max pool, bottleneck blocks (1x1, 3x3, 1x1,
each with BatchNorm; projection shortcut on a stage's first block) in the
configuration's stages, then the repo's classifier.  BatchNorm normalises
with the running statistics, which are leaves like the rest, as the
configuration states; a stage's stride sits on its first block's 3x3
convolution (torchvision's v1.5), as the configuration states.  fp32,
column-centric, nothing of the program under test.

Leaves: ``stem.w``, ``stem_bn.{scale,bias,mean,var}``, and for block ``j``
``block{j}.{c1,c2,c3,sc}.w`` with ``block{j}.{c1,c2,c3,sc}_bn.*``;
``head.w``, ``head.b``."""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from reference.common import Params, classifier, follow, he_normal, head


def blocks(cfg) -> List[Tuple[int, int, int, int, bool, int]]:
    """``(cin, cmid, cout, stride, project, H at its input)`` per block."""
    out = []
    st, sp = cfg["stem"], cfg["stem_pool"]
    h = (cfg["image"] + 2 * st["p"] - st["k"]) // st["s"] + 1
    h = (h + 2 * sp["p"] - sp["k"]) // sp["s"] + 1
    cin, first = st["cout"], cfg["stages"][0][0]
    for cout, n in cfg["stages"]:
        for i in range(n):
            stride = 2 if (i == 0 and cout != first) else 1
            out.append((cin, cout // cfg["bottleneck_expansion"], cout,
                        stride, i == 0, h))
            h = (h + 2 - 3) // stride + 1
            cin = cout
    return out


def _block_convs(cin, cmid, cout, s, project):
    """``(part, cin, cout, k, stride, padding)`` of one block."""
    parts = [("c1", cin, cmid, 1, 1, 0), ("c2", cmid, cmid, 3, s, 1),
             ("c3", cmid, cout, 1, 1, 0)]
    if project:
        parts.append(("sc", cin, cout, 1, s, 0))
    return parts


def init_params(cfg, gen: torch.Generator, device) -> Params:
    st = cfg["stem"]
    specs = [("stem.w", (st["cout"], cfg["channels"], st["k"], st["k"]),
              st["k"] * st["k"] * cfg["channels"])]
    bns = [("stem_bn", st["cout"])]
    for j, (cin, cmid, cout, s, proj, _) in enumerate(blocks(cfg)):
        for part, ci, co, k, _, _ in _block_convs(cin, cmid, cout, s, proj):
            specs.append((f"block{j}.{part}.w", (co, ci, k, k), k * k * ci))
            bns.append((f"block{j}.{part}_bn", co))
    params = he_normal(specs, gen, device)
    for name, c in bns:
        params[f"{name}.scale"] = torch.ones(c, device=device)
        params[f"{name}.bias"] = torch.zeros(c, device=device)
        params[f"{name}.mean"] = torch.zeros(c, device=device)
        params[f"{name}.var"] = torch.ones(c, device=device)
    params.update(classifier(cfg["stages"][-1][0], cfg["n_classes"], gen,
                             device))
    return params


def logits_fn(cfg):
    st, sp, eps = cfg["stem"], cfg["stem_pool"], cfg["norm_eps"]
    layout = [_block_convs(cin, cmid, cout, s, proj)
              for cin, cmid, cout, s, proj, _ in blocks(cfg)]

    def bn(params, name, x):
        inv = torch.rsqrt(params[f"{name}.var"] + eps) * params[
            f"{name}.scale"]
        shift = params[f"{name}.bias"] - params[f"{name}.mean"] * inv
        return x * inv[:, None, None] + shift[:, None, None]

    def fn(params: Params, x: torch.Tensor) -> torch.Tensor:
        x = F.conv2d(x, params["stem.w"], stride=st["s"], padding=st["p"])
        x = torch.relu(bn(params, "stem_bn", x))
        x = F.max_pool2d(x, sp["k"], sp["s"], sp["p"])
        for j, parts in enumerate(layout):
            y, r = x, x
            for part, _, _, _, s, p in parts:
                src = x if part == "sc" else y
                out = bn(params, f"block{j}.{part}_bn",
                         F.conv2d(src, params[f"block{j}.{part}.w"],
                                  stride=s, padding=p))
                if part == "sc":
                    r = out
                else:
                    y = torch.relu(out) if part != "c3" else out
            x = torch.relu(y + r)
        return head(params, x)

    return fn


def train(cfg, params: Params, batches, chunk: int) -> dict:
    """Three SGD steps of the configuration's optimizer (common.follow)."""
    return follow(logits_fn(cfg), params, batches, cfg["optimizer"], chunk)


def flops_per_image(cfg) -> int:
    """Forward FLOPs of one image: every convolution's multiply-adds and the
    classifier's, counted twice (BatchNorm, ReLU and pools not counted)."""
    st = cfg["stem"]
    h = (cfg["image"] + 2 * st["p"] - st["k"]) // st["s"] + 1
    macs = h * h * cfg["channels"] * st["cout"] * st["k"] ** 2
    for cin, cmid, cout, s, proj, hin in blocks(cfg):
        hout = (hin + 2 - 3) // s + 1
        macs += hin * hin * cin * cmid + hout * hout * cmid * cmid * 9 \
            + hout * hout * cmid * cout
        if proj:
            macs += hout * hout * cin * cout
    macs += cfg["stages"][-1][0] * cfg["n_classes"]
    return 2 * macs
