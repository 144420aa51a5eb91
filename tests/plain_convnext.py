"""Plain ConvNeXt (Liu et al., 2022) for the CPU tests of the port's: NCHW,
fp32, ``F.conv2d(groups=C)``, ``F.layer_norm``, ``F.gelu`` (erf) and
``F.linear``, column-centric, as the paper's code computes a block
(depthwise conv in NCHW, the rest channels-last).  It imports nothing of
the program under test and nothing of the JAX package.

Departures, all on purpose: no stochastic depth (a step is deterministic);
every leaf is drawn at random, biases and LayerNorm affines included, and
the layer scale ``gamma`` at O(1) where the paper starts it at 1e-6: at
1e-6 each block's branch adds a millionth of the residual stream, and a
wrong row of a block would pass every comparison.

Leaves: ``stem.{w,b}`` (OIHW), ``stem_ln.{w,b}``; ``down{i}.ln.{w,b}``,
``down{i}.{w,b}`` for stages i >= 1; ``block{j}.dw.{w,b}`` (C, 1, k, k),
``block{j}.ln.{w,b}``, ``block{j}.pw1.{w,b}`` (w: C x 4C),
``block{j}.pw2.{w,b}`` (w: 4C x C), ``block{j}.gamma``; ``head_ln.{w,b}``,
``head.w`` (C x classes), ``head.b``."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-6
K = 7


def blocks(dims: Sequence[int], depths: Sequence[int]) -> List[Tuple[int, int]]:
    """``(stage, dim)`` of each block in order."""
    return [(i, d) for i, (d, n) in enumerate(zip(dims, depths))
            for _ in range(n)]


def init_leaves(dims, depths, n_classes: int, seed: int,
                cin: int = 3) -> Dict[str, torch.Tensor]:
    gen = torch.Generator().manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=gen) * std

    def affine(name, c):
        out[f"{name}.w"] = 1 + normal((c,), 0.2)
        out[f"{name}.b"] = normal((c,), 0.2)

    out: Dict[str, torch.Tensor] = {}
    out["stem.w"] = normal((dims[0], cin, 4, 4), math.sqrt(2 / (16 * cin)))
    out["stem.b"] = normal((dims[0],), 0.1)
    affine("stem_ln", dims[0])
    for i in range(1, len(dims)):
        affine(f"down{i}.ln", dims[i - 1])
        out[f"down{i}.w"] = normal((dims[i], dims[i - 1], 2, 2),
                                   math.sqrt(2 / (4 * dims[i - 1])))
        out[f"down{i}.b"] = normal((dims[i],), 0.1)
    for j, (_, d) in enumerate(blocks(dims, depths)):
        out[f"block{j}.dw.w"] = normal((d, 1, K, K), math.sqrt(2 / K ** 2))
        out[f"block{j}.dw.b"] = normal((d,), 0.1)
        affine(f"block{j}.ln", d)
        out[f"block{j}.pw1.w"] = normal((d, 4 * d), math.sqrt(2 / d))
        out[f"block{j}.pw1.b"] = normal((4 * d,), 0.1)
        out[f"block{j}.pw2.w"] = normal((4 * d, d), math.sqrt(2 / (4 * d)))
        out[f"block{j}.pw2.b"] = normal((d,), 0.1)
        out[f"block{j}.gamma"] = 0.5 + torch.rand((d,), generator=gen)
    affine("head_ln", dims[-1])
    out["head.w"] = normal((dims[-1], n_classes), 1 / math.sqrt(dims[-1]))
    out["head.b"] = normal((n_classes,), 0.1)
    return out


def _ln_cl(p, name, x):
    """LayerNorm over the last (channel) axis."""
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.w"], p[f"{name}.b"],
                        EPS)


def _ln_nchw(p, name, x):
    return _ln_cl(p, name, x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def block(p, j: int, x):
    """One block on NCHW ``x``."""
    y = F.conv2d(x, p[f"block{j}.dw.w"], p[f"block{j}.dw.b"], padding=K // 2,
                 groups=x.shape[1])
    y = _ln_cl(p, f"block{j}.ln", y.permute(0, 2, 3, 1))
    y = F.gelu(F.linear(y, p[f"block{j}.pw1.w"].t(), p[f"block{j}.pw1.b"]))
    y = F.linear(y, p[f"block{j}.pw2.w"].t(), p[f"block{j}.pw2.b"])
    y = y * p[f"block{j}.gamma"]
    return x + y.permute(0, 3, 1, 2)


def trunk(p, x, dims, depths):
    """NCHW features of NCHW images ``x``."""
    x = F.conv2d(x, p["stem.w"], p["stem.b"], stride=4)
    x = _ln_nchw(p, "stem_ln", x)
    j = 0
    for i, n in enumerate(depths):
        if i:
            x = _ln_nchw(p, f"down{i}.ln", x)
            x = F.conv2d(x, p[f"down{i}.w"], p[f"down{i}.b"], stride=2)
        for _ in range(n):
            x = block(p, j, x)
            j += 1
    return x


def head(p, feats):
    pooled = _ln_cl(p, "head_ln", feats.mean(dim=(2, 3)))
    return pooled @ p["head.w"] + p["head.b"]


def logits(p, x, dims, depths):
    return head(p, trunk(p, x, dims, depths))
