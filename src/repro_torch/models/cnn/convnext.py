"""ConvNeXt (Liu et al., "A ConvNet for the 2020s", CVPR'22) — a
demanding CNN for row-centric training: at 384² its blocks' 4x-wide inner
tensors make the column-centric step's activations outgrow one card.

Trunk modules: the stem (4x4 stride-4 conv, LayerNorm), then per stage a
downsampling layer (LayerNorm, 2x2 stride-2 conv) before all but the first,
and the stage's :class:`~repro_torch.models.cnn.layers.ConvNeXtBlock` s
(depthwise 7x7, LayerNorm, 1x1 to 4C, GELU, 1x1 back, layer scale,
residual).  Each block is one row-engine module whose 3-row halo is
replicated; the strided convs have k = s and no halo.  The head is global
average pooling, LayerNorm and a linear layer.  ``width_mult`` and
``depths`` shrink the model for tests while keeping every geometry.
Stochastic depth is not ported (a step is deterministic).
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F

from repro_torch.models.cnn.layers import (
    Conv, ConvNeXtBlock, LayerNorm, init_trunk,
)

#: ConvNeXt-B: (channels, blocks) per stage
_STAGES = [(128, 3), (256, 3), (512, 27), (1024, 3)]
EPS = 1e-6


def convnext_modules(width_mult: float = 1.0,
                     depths: Sequence[int] | None = None) -> List:
    depths = list(depths or [n for _, n in _STAGES])
    dims = [max(4, int(c * width_mult)) for c, _ in _STAGES]
    mods: List = [Conv(dims[0], k=4, s=4, p=0, bias=True), LayerNorm(EPS)]
    for i, (dim, n) in enumerate(zip(dims, depths)):
        if i:
            mods += [LayerNorm(EPS), Conv(dim, k=2, s=2, p=0, bias=True)]
        mods += [ConvNeXtBlock(dim, eps=EPS) for _ in range(n)]
    return mods


def init_convnext(generator: torch.Generator, in_shape=(384, 384, 3),
                  width_mult: float = 1.0, n_classes: int = 1000,
                  depths: Sequence[int] | None = None, device="cuda"):
    """Random He-initialised trunk (layer scale at the paper's 1e-6) and
    head from ``generator`` (a CPU ``torch.Generator``; tensors are drawn
    on the CPU and moved to ``device``)."""
    mods = convnext_modules(width_mult, depths)
    trunk_params, feat_shape = init_trunk(mods, generator, in_shape, device)
    c = feat_shape[-1]
    head = {
        "ln": LayerNorm(EPS).init(generator, feat_shape, device),
        "w": (torch.randn((c, n_classes), generator=generator)
              / math.sqrt(c)).to(device),
        "b": torch.zeros(n_classes, device=device),
    }
    return mods, {"trunk": trunk_params, "head": head}


def head_apply(head, feats):
    """Global average pool, LayerNorm over the channels, linear."""
    pooled = feats.mean(dim=(1, 2))
    pooled = F.layer_norm(pooled, (pooled.shape[-1],), head["ln"]["scale"],
                          head["ln"]["bias"], EPS)
    return pooled @ head["w"] + head["b"]

