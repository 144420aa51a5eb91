"""Plain PyTorch oracles for the kernels (the allclose ground truth).

Counterpart of ``repro.kernels.ref``; only the conv oracle is ported so far.
"""

from __future__ import annotations

import torch.nn.functional as F


def conv2d_ref(x, w, stride: int = 1, padding: int = 0):
    """NHWC x HWIO -> NHWC, symmetric padding."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)
