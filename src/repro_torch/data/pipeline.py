"""Deterministic synthetic data (counterpart of ``repro.data.pipeline``):
token streams for LM training and labelled images for CNN training.

The reference's generators are numpy only, and so is this copy: the same
config and step give bit-identical batches in both packages.  Each batch
is derived from ``(seed, step)`` alone — no state, perfectly resumable.
Callers move the numpy arrays to their device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenDatasetConfig:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    n_gram: int = 3         # learnable structure order
    noise_p: float = 0.15   # fraction of positions replaced by noise


class TokenDataset:
    """Synthetic Markov-style token stream: next token is a deterministic
    function of the previous ``n_gram`` tokens, corrupted with noise."""

    def __init__(self, cfg: TokenDatasetConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # deterministic transition: hash of context -> next token
        self._mix = rng.integers(1, cfg.vocab, size=cfg.n_gram, dtype=np.int64)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S, V = cfg.batch, cfg.seq_len, cfg.vocab
        toks = np.empty((B, S + 1), dtype=np.int64)
        toks[:, :cfg.n_gram] = rng.integers(0, V, size=(B, cfg.n_gram))
        for t in range(cfg.n_gram, S + 1):
            ctx = toks[:, t - cfg.n_gram:t]
            toks[:, t] = (ctx * self._mix).sum(axis=1) % V
        noise = rng.random((B, S + 1)) < cfg.noise_p
        toks = np.where(noise, rng.integers(0, V, size=(B, S + 1)), toks)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


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


def device_put_global(batch: Dict[str, np.ndarray], mesh,
                      batch_axes=("pod", "data"), device="cpu"):
    """This rank's slice of a host batch, each array's leading dim split
    over the ``DeviceMesh``'s ``batch_axes`` (major to minor), as tensors
    on ``device`` (counterpart of the reference's ``device_put_global``,
    which places the global array; here each rank holds its own shard).
    Only the slice is copied.  A batch the axes do not divide raises, as
    the reference's placement does."""
    import torch

    from repro_torch.launch.sharding import (
        axis_names, axis_sizes, placements, shard_of,
    )
    axes = tuple(a for a in batch_axes if a in axis_names(mesh))
    extent = int(np.prod([axis_sizes(mesh)[a] for a in axes]))
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        if t.ndim >= 1:
            if t.shape[0] % extent:
                raise ValueError(f"batch {k!r} of {t.shape[0]} does not "
                                 f"divide over the mesh axes {axes} "
                                 f"({extent})")
            t = shard_of(t, placements((axes,) + (None,) * (t.ndim - 1),
                                       mesh), mesh)
        out[k] = t.to(device)
    return out
