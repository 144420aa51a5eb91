"""Plain VGG-16 (Simonyan & Zisserman, configuration D) in NCHW: the
configuration's stages of 3x3 convolutions with ReLU, each stage closed by
a 2x2 max pool, then the repo's classifier (global average pool, one
linear layer).  fp32, column-centric, nothing of the program under test.

Leaves: ``conv{i}.w`` (OIHW), ``conv{i}.b``, ``head.w`` (C, classes),
``head.b``."""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from reference.common import Params, classifier, follow, he_normal, head


def convs(cfg) -> List[Tuple[int, int, int, bool]]:
    """``(cin, cout, H at its input, pool after)`` for each convolution."""
    out, cin, h = [], cfg["channels"], cfg["image"]
    for cout, n in cfg["stages"]:
        for j in range(n):
            out.append((cin, cout, h, j == n - 1))
            cin = cout
        h //= cfg["pool"]
    return out


def init_params(cfg, gen: torch.Generator, device) -> Params:
    k = cfg["conv_kernel"]
    layers = convs(cfg)
    params = he_normal([(f"conv{i}.w", (cout, cin, k, k), k * k * cin)
                        for i, (cin, cout, _, _) in enumerate(layers)],
                       gen, device)
    for i, (_, cout, _, _) in enumerate(layers):
        params[f"conv{i}.b"] = torch.zeros(cout, device=device)
    params.update(classifier(layers[-1][1], cfg["n_classes"], gen, device))
    return params


def logits_fn(cfg):
    k, pool = cfg["conv_kernel"], cfg["pool"]
    layers = convs(cfg)

    def fn(params: Params, x: torch.Tensor) -> torch.Tensor:
        for i, (_, _, _, pooled) in enumerate(layers):
            x = torch.relu(F.conv2d(x, params[f"conv{i}.w"],
                                    params[f"conv{i}.b"], padding=k // 2))
            if pooled:
                x = F.max_pool2d(x, pool, pool)
        return head(params, x)

    return fn


def train(cfg, params: Params, batches, chunk: int) -> dict:
    """Three SGD steps of the configuration's optimizer (common.follow)."""
    return follow(logits_fn(cfg), params, batches, cfg["optimizer"], chunk)


def flops_per_image(cfg) -> int:
    """Forward FLOPs of one image: the convolutions' multiply-adds and the
    classifier's, counted twice."""
    k = cfg["conv_kernel"]
    macs = sum(h * h * cin * cout * k * k for cin, cout, h, _ in convs(cfg))
    macs += cfg["stages"][-1][0] * cfg["n_classes"]
    return 2 * macs
