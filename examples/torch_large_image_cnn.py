"""The paper's motivating scenario on the port: high-resolution inputs
(climate-model imagery at 3600x2400) blow past accelerator memory under
column-centric training.  This example shows the feasibility frontier
across resolutions, then deliberately requests a budget so tight that NO
device-resident plan fits — the Planner's ``residencize`` fallback moves
the 2PS boundary caches to pinned host memory (copied on a side stream,
with the next row's prefetched) and the training steps run under the
residencized plan.  On the card each step's measured peak is printed
beside the plan's estimate.  (The PyTorch counterpart of
``examples/large_image_cnn.py``.)

  PYTHONPATH=src python examples/torch_large_image_cnn.py            # card
  PYTHONPATH=src python examples/torch_large_image_cnn.py --device cpu
"""

import argparse

import torch

from repro_torch.core.rowplan import omega_column, solve_n
from repro_torch.exec import (
    CostTable, ExecutionPlan, Planner, ResidencySpec, build_apply,
)
from repro_torch.launch.mesh import require_device
from repro_torch.models.cnn.vgg import head_apply, init_vgg16, vgg16_modules
from repro_torch.obs.audit import measure_step
from repro_torch.optim.adamw import (
    SGDConfig, sgd_init, sgd_update, tree_leaves, tree_map,
)

BATCH = 2
H = 768
# 28 MiB sits BELOW the minimum estimate of every device-resident engine
# at H=768 (best: OverL at ~33 MiB) but above what 2PS needs once its SD
# caches live on the host — the budget region residency exists for.
BUDGET = 28 * 2**20
HEIGHTS = (256, 384, 512, 768, 1024)
STEPS, LR = 3, 0.05


def trunk_modules():
    return vgg16_modules(width_mult=0.25, n_stages=3)


def feasibility(heights=HEIGHTS, budget=BUDGET):
    """The frontier: column Ω and the 2PS / OverL solves at each height.
    Returns ``{h: (base Ω, 2PS result, OverL result)}``."""
    print(f"activation budget {budget / 2**20:.0f} MiB, batch {BATCH}\n")
    print(f"{'H':>6} {'base Ω (MiB)':>14} {'base fits':>10} "
          f"{'2PS N':>6} {'2PS est (MiB)':>14} {'OverL N':>8}")
    rows = {}
    for h in heights:
        mods = trunk_modules()
        shape = (h, h, 3)
        base = omega_column(mods, shape, BATCH)
        r2 = solve_n(mods, shape, BATCH, budget, "twophase")
        ro = solve_n(mods, shape, BATCH, budget, "overlap")
        est = r2.est_bytes / 2**20 if r2.feasible else float("nan")
        print(f"{h:>6} {base / 2**20:>14.1f} {str(base < budget):>10} "
              f"{r2.n_rows if r2.feasible else '-':>6} {est:>14.1f} "
              f"{ro.n_rows if ro.feasible else '-':>8}")
        rows[h] = (base, r2, ro)
    return rows


def device_only(mods, shape, budget=BUDGET):
    """Device-only solve: every engine is over budget at this resolution."""
    plan = Planner.for_budget(mods, shape, BATCH, budget,
                              residency=ResidencySpec())
    if plan.feasible:
        raise AssertionError("budget should reject device-only plans")
    print(f"\ndevice-only best at H={shape[0]}: {plan.describe()}")
    return plan


def residencized(mods, shape, table, budget=BUDGET):
    """The full solve through the measured-cost roofline chooser: the
    calibrated ``table`` ranks every feasible (engine, N, residency)
    candidate by predicted step time instead of the static Table-I order,
    and still residencizes — no device-resident plan fits.  Returns the
    plan replayed from its JSON, as a logged plan replays on any host."""
    plan = Planner.for_budget(mods, shape, BATCH, budget, cost_table=table)
    if not plan.feasible or plan.residency is None:
        raise AssertionError(f"expected a residencized plan: "
                             f"{plan.describe()}")
    print(f"residencized:             {plan.describe()}")
    print(f"  -> {plan.get('residencized')}")
    print(f"  cost model: {plan.get('cost_model')}")
    print(f"  predicted step: {plan.get('predicted_step_us'):.0f} us "
          f"(table {table.fingerprint}, version "
          f"{plan.get('cost_table_version')})")
    plan = ExecutionPlan.from_json(plan.to_json())
    if plan.residency is None:
        raise AssertionError("the JSON replay lost the residency")
    return plan


def training(mods, plan, params, batches, device, lr=LR):
    """SGD steps through the plan's trunk, one for each ``(images,
    labels)`` of ``batches``; prints each step's loss and, on the card,
    its measured peak beside the plan's ``est_bytes``.  Returns the
    losses and the peaks (None on the CPU)."""
    trunk = build_apply(mods, plan)
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

    losses, peaks = [], []
    for i, (x, y) in enumerate(batches):
        held = []
        measured = measure_step(
            lambda: held.append(step(params, opt, x, y)), device=device)
        params, opt, loss = held.pop()
        losses.append(float(loss))
        line = f"  step {i} loss {losses[-1]:.4f}"
        if measured is not None:
            peak = measured["peak_bytes"]
            # an audit, not a gate: the plan prices activations and caches
            # only; the peak holds the parameters, the batch and cuDNN's
            # workspace too
            line += (f"  peak {peak} B vs est_bytes {plan.est_bytes} B "
                     f"(audit {peak / plan.est_bytes:.2f}x)")
            peaks.append(peak)
        else:
            peaks.append(None)
        print(line)
    return losses, peaks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default cuda; cpu runs "
                         "the same code on the host)")
    args = ap.parse_args(argv)
    device = require_device(args.device, "run on the host")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    feasibility()
    mods = trunk_modules()
    shape = (H, H, 3)
    device_only(mods, shape)
    table = CostTable.calibrate(iters=1, device=device)
    plan = residencized(mods, shape, table)

    print(f"\ntraining at H={H} with {plan.engine} N={plan.n_rows}, "
          f"SD caches {plan.residency.default}-resident "
          f"(prefetch_depth={plan.residency.prefetch_depth})")
    _, params = init_vgg16(torch.Generator().manual_seed(0), shape,
                           width_mult=0.25, n_classes=4, n_stages=3,
                           device=device)
    batches = ((torch.randn((BATCH, H, H, 3), device=device,
                            generator=torch.Generator(device=device)
                            .manual_seed(i)),
                torch.tensor([i % 4, (i + 1) % 4], device=device))
               for i in range(STEPS))
    training(mods, plan, params, batches, device)
    print("large_image_cnn OK")


if __name__ == "__main__":
    main()
