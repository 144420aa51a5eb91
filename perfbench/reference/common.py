"""What the plain references share: seeded weights made on the device in a
few large draws, the classifier, the loss, and plain SGD with momentum.

Plain PyTorch in NCHW, fp32.  Nothing here imports the program under
test, the JAX package, or the harness."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Params = Dict[str, torch.Tensor]


def he_normal(specs: List[Tuple[str, tuple, int]], gen: torch.Generator,
              device) -> Params:
    """``{name: N(0, 2 / fan_in)}`` for ``(name, shape, fan_in)`` specs,
    drawn as one block from ``gen`` and cut into leaves in spec order."""
    sizes = [math.prod(shape) for _, shape, _ in specs]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape, fan_in), n in zip(specs, sizes):
        out[name] = flat[at:at + n].view(shape) * math.sqrt(2.0 / fan_in)
        at += n
    return out


def classifier(c: int, n_classes: int, gen: torch.Generator,
               device) -> Params:
    w = torch.randn((c, n_classes), generator=gen, device=device)
    return {"head.w": w / math.sqrt(c),
            "head.b": torch.zeros(n_classes, device=device)}


def head(params: Params, feats: torch.Tensor) -> torch.Tensor:
    """Global average pool over H and W, then one linear layer."""
    return feats.mean(dim=(2, 3)) @ params["head.w"] + params["head.b"]


def nll_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -torch.log_softmax(logits, dim=-1).gather(
        1, labels[:, None]).sum()


def loss_and_grads(logits_fn, params: Params, images: torch.Tensor,
                   labels: torch.Tensor, chunk: int):
    """The batch-mean cross-entropy and its gradient, in blocks of
    ``chunk`` images so that a large batch fits; ``images`` NHWC."""
    B = images.shape[0]
    names = sorted(params)
    leaves = [params[n].detach().requires_grad_() for n in names]
    live = dict(zip(names, leaves))
    total = 0.0
    grads = [torch.zeros_like(l) for l in leaves]
    for at in range(0, B, chunk):
        x = images[at:at + chunk].permute(0, 3, 1, 2)
        part = nll_sum(logits_fn(live, x), labels[at:at + chunk]) / B
        for g, d in zip(grads, torch.autograd.grad(part, leaves)):
            g += d
        total += float(part.detach())
    return total, dict(zip(names, grads))


def sgd(params: Params, grads: Params, vel: Params, opt: dict):
    """``v = m v + (g + wd p)``, ``p = p - lr v``."""
    new_v = {n: opt["momentum"] * vel[n] + (grads[n]
                                            + opt["weight_decay"] * params[n])
             for n in params}
    return {n: params[n] - opt["lr"] * new_v[n] for n in params}, new_v


@torch.no_grad()
def _norms(tree: Params) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t)) for n, t in tree.items()}


def follow(logits_fn, params: Params, batches, opt: dict, chunk: int,
           steps: int = 3) -> dict:
    """``steps`` SGD steps from ``params`` over ``batches``: each step's
    loss, the first gradient's norm by leaf, and the norm of each leaf's
    change after the last step."""
    p0, p = params, dict(params)
    vel = {n: torch.zeros_like(t) for n, t in params.items()}
    losses, first = [], None
    for images, labels in batches[:steps]:
        loss, grads = loss_and_grads(logits_fn, p, images, labels, chunk)
        losses.append(loss)
        if first is None:
            first = _norms(grads)
        with torch.no_grad():
            p, vel = sgd(p, grads, vel, opt)
        del grads
    change = _norms({n: p[n] - p0[n] for n in p})
    return {"loss": losses, "grad": first, "update": change}
