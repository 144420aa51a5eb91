"""VGG-16 (Simonyan & Zisserman) — the paper's chain-trunk benchmark.

Counterpart of ``repro.models.cnn.vgg``: the conv trunk is a chain of
Conv/ReLU/MaxPool modules and the classifier head is a column-centric
global-average-pool + linear layer.  ``vgg16_modules(width_mult)`` lets
tests shrink channels while keeping the exact layer geometry.
"""

from __future__ import annotations

import math
from typing import List

import torch

from repro_torch.models.cnn.layers import (  # noqa: F401  (re-exported)
    Conv, MaxPool, ReLU, init_trunk, params_from_reference,
)

# (channels, n_convs) per VGG-16 stage
_STAGES = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]


def vgg16_modules(width_mult: float = 1.0, n_stages: int = 5) -> List:
    mods: List = []
    for c, n in _STAGES[:n_stages]:
        cc = max(4, int(c * width_mult))
        for _ in range(n):
            mods.append(Conv(cc, k=3, s=1, p=1, bias=True))
            mods.append(ReLU())
        mods.append(MaxPool(k=2, s=2))
    return mods


def init_vgg16(generator: torch.Generator, in_shape=(224, 224, 3),
               width_mult: float = 1.0, n_classes: int = 10,
               n_stages: int = 5, device="cuda"):
    """Random He-initialised trunk + GAP head from ``generator`` (a CPU
    ``torch.Generator``; tensors are drawn on the CPU and moved to
    ``device``, so a seed gives the same weights on every device)."""
    mods = vgg16_modules(width_mult, n_stages)
    trunk_params, feat_shape = init_trunk(mods, generator, in_shape, device)
    c = feat_shape[2]
    head = {
        "w": (torch.randn((c, n_classes), generator=generator)
              / math.sqrt(c)).to(device),
        "b": torch.zeros(n_classes, device=device),
    }
    return mods, {"trunk": trunk_params, "head": head}


def head_apply(head, feats):
    pooled = feats.mean(dim=(1, 2))
    return pooled @ head["w"] + head["b"]
