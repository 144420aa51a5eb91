"""The one generator of traffic: a pool of distinct batches of images and
labels, drawn on the device from the run's generator.  A traffic file
(``perfbench/traffic/<name>.json``) gives ``batch`` (images a step) and
``pool`` (distinct batches; step ``i`` takes batch ``i % pool``, so the
first ``pool`` steps see rows that all differ); the configuration gives
the image size, channels and classes."""

from __future__ import annotations

import torch


def pool(cfg, traffic, gen: torch.Generator, device):
    n, b = traffic["pool"], traffic["batch"]
    hw, c = cfg["image"], cfg["channels"]
    images = torch.randn((n, b, hw, hw, c), generator=gen, device=device)
    labels = torch.randint(0, cfg["n_classes"], (n, b), generator=gen,
                           device=device)
    return [(images[i], labels[i]) for i in range(n)]
