"""The system under test: one SGD training step of ``repro_torch``, built
from the program's public pieces as ``launch/train.py::_train_cnn``
builds it (``Planner.resolve`` for the plan, ``build_apply`` for the
trunk, the model's ``head_apply`` and the log-softmax loss,
``torch.autograd.grad``, ``optim.adamw.sgd_update``).  The weights are the
benchmark's, laid out as the port's tree."""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]


def _import_program():
    """The port from this checkout's ``src`` and nowhere else."""
    import repro_torch
    where = Path(repro_torch.__file__).resolve()
    if ROOT / "src" not in where.parents:
        raise ImportError(f"repro_torch comes from {where}, not from "
                          f"{ROOT / 'src'}")


_import_program()

from repro_torch.exec import PlanRequest, Planner, build_apply  # noqa: E402
from repro_torch.optim.adamw import (  # noqa: E402
    SGDConfig, sgd_init, sgd_update, tree_leaves, tree_map,
)


def no_probe(name):
    return contextlib.nullcontext()


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def port_tree(mods, paths, ref_params):
    """The reference's leaves as the port's tree: conv weights OIHW ->
    HWIO, each leaf a fresh contiguous tensor."""
    tree = {"trunk": [{} for _ in mods], "head": {}}
    for name, path in paths.items():
        t = ref_params[name]
        if t.dim() == 4:
            t = t.permute(2, 3, 1, 0)
        node = tree
        for k in path[:-1]:
            node = node[k] if isinstance(k, int) else node.setdefault(k, {})
        node[path[-1]] = t.contiguous().clone()
    return tree


class Job:
    """The program's training state and its step.  ``step`` takes one batch
    and returns the loss (a 0-d tensor, not synchronised); ``update`` is
    the optimizer call the step makes."""

    def __init__(self, adapter, cfg, traffic, ref_params):
        self.mods = adapter.modules(cfg)
        self.paths = adapter.paths(self.mods)
        params = port_tree(self.mods, self.paths, ref_params)
        shape = (cfg["image"], cfg["image"], cfg["channels"])
        n_params = sum(l.numel() for l in tree_leaves(params))
        # the paper's xi, as the trainer passes it: params, grads, velocity
        self.plan = Planner(self.mods, shape, traffic["batch"],
                            xi=3 * 4 * n_params).resolve(
                                PlanRequest(**traffic["plan"]))
        opt = cfg["optimizer"]
        self.opt_cfg = SGDConfig(lr=opt["lr"], momentum=opt["momentum"],
                                 weight_decay=opt["weight_decay"])
        self.update = sgd_update
        trunk_apply = build_apply(self.mods, self.plan)
        head_apply = adapter.head_apply

        def step(state, images, labels, probe):
            params, vel = state
            p = tree_map(lambda t: t.detach().requires_grad_(), params)
            with probe("forward"):
                logits = head_apply(p["head"], trunk_apply(p["trunk"],
                                                           images))
                loss = -torch.log_softmax(logits, dim=-1).gather(
                    1, labels[:, None]).mean()
            with probe("backward"):
                flat = iter(torch.autograd.grad(loss, tree_leaves(p)))
                grads = tree_map(lambda _: next(flat), p)
            with probe("optimizer"):
                params, vel, _ = self.update(params, grads, vel,
                                             self.opt_cfg)
            return (params, vel), loss.detach()

        self._step = step
        self.state = (params, sgd_init(params))

    def step(self, images, labels, probe=no_probe):
        self.state, loss = self._step(self.state, images, labels, probe)
        return loss

    def leaves(self):
        return {n: _get(self.state[0], p) for n, p in self.paths.items()}

    def velocity(self):
        return {n: _get(self.state[1]["vel"], p)
                for n, p in self.paths.items()}

    def follow(self, batches, steps: int = 3) -> dict:
        """Take the first ``steps`` steps, one batch each, and read what the
        check compares: each step's loss, the first gradient as the
        optimizer got it (``v1 - wd p0``: the velocity starts at zero) and
        each leaf's change after the last step, by leaf norm."""
        norm = lambda t: float(torch.linalg.vector_norm(t.float()))
        p0 = self.leaves()
        wd = self.opt_cfg.weight_decay
        losses, grad = [], None
        for images, labels in batches[:steps]:
            losses.append(self.step(images, labels))
            if grad is None:
                vel = self.velocity()
                grad = {n: norm(vel[n] - wd * p0[n].float()) for n in vel}
        now = self.leaves()
        return {"loss": [float(l) for l in losses], "grad": grad,
                "update": {n: norm(now[n].float() - p0[n].float())
                           for n in now}}
