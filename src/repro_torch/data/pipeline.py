"""Deterministic synthetic image data (counterpart of the image half of
``repro.data.pipeline``).

The reference's generator is numpy only, and so is this copy: the same
config and step give bit-identical batches in both packages.  Each batch
is derived from ``(seed, step)`` alone — no state, perfectly resumable.
Callers move the numpy arrays to their device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class ImageDatasetConfig:
    h: int = 32
    w: int = 32
    c: int = 3
    n_classes: int = 10
    batch: int = 32
    seed: int = 0


class ImageDataset:
    """Class-conditional low-frequency patterns + noise; linearly separable
    enough that small CNNs reach low loss in a few hundred steps."""

    def __init__(self, cfg: ImageDatasetConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # one smooth template per class
        yy, xx = np.mgrid[0:cfg.h, 0:cfg.w].astype(np.float32)
        self._templates = np.stack([
            np.sin(2 * np.pi * ((k + 1) * xx / cfg.w + k * yy / cfg.h))
            [..., None] * rng.uniform(0.5, 1.0, size=(1, 1, cfg.c))
            for k in range(cfg.n_classes)
        ]).astype(np.float32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        labels = rng.integers(0, cfg.n_classes, size=cfg.batch)
        imgs = self._templates[labels]
        imgs = imgs + rng.normal(0, 0.3, size=imgs.shape).astype(np.float32)
        return {"images": imgs.astype(np.float32),
                "labels": labels.astype(np.int32)}
