"""ResNet-50 (He et al.) — the paper's branching-trunk benchmark.

Counterpart of ``repro.models.cnn.resnet``.  Trunk modules: stem conv (7x7
s2 p3) + BatchNorm + ReLU + maxpool (3x3 s2 p1) + 16 bottleneck blocks in
stages [3, 4, 6, 3].  Each Bottleneck is one row-engine module (internal
halo replicated); BatchNorm normalises with the running statistics in the
parameter tree, so row and column execution agree
(:mod:`repro_torch.models.cnn.layers`).  ``stage_blocks`` cuts the depth
for tests while keeping every geometry.
"""

from __future__ import annotations

import math
from typing import List

import torch

from repro_torch.models.cnn.layers import (
    BatchNorm, Bottleneck, Conv, MaxPool, ReLU, apply_trunk, init_trunk,
)

_STAGES = [(256, 3), (512, 4), (1024, 6), (2048, 3)]


def resnet50_modules(width_mult: float = 1.0, stage_blocks=None) -> List:
    blocks = stage_blocks or [n for _, n in _STAGES]
    mods: List = [
        Conv(max(4, int(64 * width_mult)), k=7, s=2, p=3, bias=False),
        BatchNorm(),
        ReLU(),
        MaxPool(k=3, s=2, p=1),
    ]
    first = max(8, int(256 * width_mult))
    for (cout, _), n in zip(_STAGES, blocks):
        cout = max(8, int(cout * width_mult))
        for i in range(n):
            stride = 2 if (i == 0 and cout != first) else 1
            mods.append(Bottleneck(cout // 4, cout, s=stride,
                                   project=(i == 0)))
    return mods


def init_resnet50(generator: torch.Generator, in_shape=(224, 224, 3),
                  width_mult: float = 1.0, n_classes: int = 10,
                  stage_blocks=None, device="cuda"):
    """Random He-initialised trunk + GAP head from ``generator`` (a CPU
    ``torch.Generator``; tensors are drawn on the CPU and moved to
    ``device``)."""
    mods = resnet50_modules(width_mult, stage_blocks)
    trunk_params, feat_shape = init_trunk(mods, generator, in_shape, device)
    c = feat_shape[-1]
    head = {
        "w": (torch.randn((c, n_classes), generator=generator)
              / math.sqrt(c)).to(device),
        "b": torch.zeros(n_classes, device=device),
    }
    return mods, {"trunk": trunk_params, "head": head}


def head_apply(head, feats):
    pooled = feats.mean(dim=(1, 2))
    return pooled @ head["w"] + head["b"]


def forward(mods, params, x):
    return head_apply(params["head"], apply_trunk(mods, params["trunk"], x))
