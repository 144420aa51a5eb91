"""Quickstart on the port: train a small CNN with LR-CNN row-centric
execution through the ``repro_torch.exec`` Plan/Engine API and check the
headline properties (the PyTorch counterpart of ``examples/quickstart.py``):

1. budget-driven planning: ``Planner.for_budget`` picks strategy and
   granularity N under a byte budget (Eqs. 7-16) and returns a
   serializable ``ExecutionPlan``;
2. row-centric forward == column-centric forward, engines built uniformly
   via ``build_apply(modules, plan)``;
3. gradients match => training trajectories match (Fig. 11);
4. a gradient step's temporaries, traced on ``meta`` tensors, are fewer
   under the row engines (the paper's whole point); on the card each
   engine's measured peak is printed beside them.

  PYTHONPATH=src python examples/torch_quickstart.py               # card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse

import torch

from repro_torch.core.rowplan import estimate_bytes
from repro_torch.data.pipeline import ImageDataset, ImageDatasetConfig
from repro_torch.exec import ExecutionPlan, Planner, build_apply
from repro_torch.launch.mesh import require_device
from repro_torch.models.cnn.vgg import head_apply, init_vgg16
from repro_torch.obs.audit import measure_step, trace_step
from repro_torch.optim.adamw import (
    SGDConfig, sgd_init, sgd_update, tree_leaves, tree_map,
)

IMAGE, BATCH = 64, 8
SHAPE = (IMAGE, IMAGE, 3)
BUDGET = 10 * 2**20  # pretend we only have 10 MiB for activations
STEPS, LR = 30, 0.05


def planning(mods, budget=BUDGET):
    """Hand the planner a byte budget; it auto-selects the cheapest engine
    that fits (Table I order) and the minimal granularity N.  Returns the
    plan and the analytic Ω_BP of each strategy, by name."""
    plan = Planner.for_budget(mods, SHAPE, BATCH, budget)
    print(f"planner: budget={budget / 2**20:.0f}MiB -> {plan.describe()}")
    print(f"         (JSON round-trip: "
          f"{plan == ExecutionPlan.from_json(plan.to_json())})")
    omegas = {}
    for strat in ("base", "twophase", "overlap"):
        n = max(2, plan.n_rows) if strat != "base" else 1
        omegas[strat] = estimate_bytes(mods, SHAPE, BATCH, strat, n)
        print(f"  analytic Ω_BP[{strat:9s} N={n}]: "
              f"{omegas[strat] / 2**20:6.1f} MiB")
    return plan, omegas


def engines(mods, plan):
    """Column-centric ``base``, OverL N=4 and 2PS at the plan's N, by the
    names the memory lines print."""
    n = max(2, plan.n_rows)
    return {"base": build_apply(mods, ExecutionPlan.explicit("base", 1,
                                                             SHAPE)),
            "overlap N=4": build_apply(mods, ExecutionPlan.explicit(
                "overlap", 4, SHAPE)),
            "2PS": build_apply(mods, ExecutionPlan.explicit("twophase", n,
                                                            SHAPE))}


@torch.no_grad()
def exactness(trunks, trunk_params, x):
    """Every row engine's forward against ``base``'s: max |Δ| by engine."""
    want = trunks["base"](trunk_params, x)
    deltas = {}
    for name, label in (("overlap N=4", "overlap:"), ("2PS", "2PS:    ")):
        deltas[name] = float((trunks[name](trunk_params, x) - want)
                             .abs().max())
        print(f"forward max|Δ| {label}", deltas[name])
    return deltas


def grad_step(trunk):
    """The memory section's step: the gradients of sum(logits²)."""
    def step(params, x):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = torch.sum(head_apply(p["head"], trunk(p["trunk"], x)) ** 2)
        return torch.autograd.grad(loss, tree_leaves(p))
    return step


def memory(trunks, params, x):
    """Each engine's gradient step traced on ``meta`` copies of the
    parameters and the input; on the card also run and measured.  Returns
    ``{name: (traced temp bytes, measured peak or None)}``."""
    meta = lambda t: torch.empty_like(t, device="meta")  # noqa: E731
    meta_params, meta_x = tree_map(meta, params), meta(x)
    out = {}
    # the trace counts the storages the step makes beyond its arguments,
    # at their peak: no allocator rounding and no library workspace
    for name, trunk in trunks.items():
        step = grad_step(trunk)
        tb = trace_step(step, meta_params, meta_x)["temp_size_in_bytes"]
        measured = measure_step(lambda: step(params, x), device=x.device)
        peak = None if measured is None else measured["peak_bytes"]
        line = f"traced temp bytes [{name:12s}]: {tb / 2**20:8.1f} MiB"
        if peak is not None:
            line += (f"; traced {tb} B, measured peak {peak} B "
                     f"(max_memory_allocated: arguments and cuDNN's "
                     f"workspace included)")
        print(line)
        out[name] = (tb, peak)
    return out


def training(trunk, params, device, steps=STEPS, lr=LR, log_every=10):
    """SGD on the synthetic image data through ``trunk``; prints and
    returns the loss of every ``log_every``-th step and the last (read
    from the device only there), with the final parameters."""
    cfg = SGDConfig(lr=lr)
    opt = sgd_init(params)

    def step(params, opt, images, labels):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        logits = head_apply(p["head"], trunk(p["trunk"], images))
        logp = torch.log_softmax(logits, dim=-1)
        loss = -logp.gather(1, labels[:, None]).mean()
        leaves = iter(torch.autograd.grad(loss, tree_leaves(p)))
        grads = tree_map(lambda _: next(leaves), p)
        params, opt, _ = sgd_update(params, grads, opt, cfg)
        return params, opt, loss.detach()

    ds = ImageDataset(ImageDatasetConfig(h=IMAGE, w=IMAGE, batch=BATCH))
    losses = {}
    for i in range(steps):
        b = ds.batch_at(i)
        params, opt, loss = step(
            params, opt, torch.from_numpy(b["images"]).to(device),
            torch.from_numpy(b["labels"]).long().to(device))
        if i % log_every == 0 or i == steps - 1:
            losses[i] = float(loss)
            print(f"step {i:3d} loss {losses[i]:.4f}")
    return params, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default cuda; cpu runs "
                         "the same code on the host)")
    args = ap.parse_args(argv)
    device = require_device(args.device, "run on the host")
    # exactness is fp32: cuDNN and cuBLAS default to TF32 on the card
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    mods, params = init_vgg16(gen, SHAPE, width_mult=0.25, n_classes=10,
                              n_stages=3, device=device)
    plan, _ = planning(mods)
    x = torch.randn((BATCH, IMAGE, IMAGE, 3), generator=gen).to(device)
    trunks = engines(mods, plan)
    exactness(trunks, params["trunk"], x)
    memory(trunks, params, x)
    training(trunks["2PS"], params, device)
    print("quickstart OK")


if __name__ == "__main__":
    main()
