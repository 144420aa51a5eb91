"""Training driver (counterpart of ``repro.launch.train``).  Two modes:

* CNN (``--arch vgg16`` or ``resnet50``)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch vgg16 \\
        --preset full --steps 3

  resolves the config's plan request (the full presets ask for
  ``twophase_h`` at N=8) to an ExecutionPlan through ``Planner.resolve``,
  builds the trunk through ``build_apply``, and takes SGD steps on the
  synthetic image data.  ``--budget-gb`` lets ``Planner.for_budget`` pick
  engine and N; ``--strategy``/``--rows`` pin them; ``--residency
  host|recompute`` places the 2PS boundary caches; ``--kernel cuda`` swaps
  ``base``/``overlap`` for ``overlap_cuda``, whose convs run the
  hand-written CUDA kernel.
* LM::

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3_4b \\
        --preset full --batch 1 --seq 4096 --kernel cuda --steps 3

  ``--kernel`` plans the sequence axis (``Planner.for_model``): ``cuda``
  kernelizes gemma's ``seq_swa_overlap`` plan to ``seq_swa_cuda``, whose
  local attention layers run the hand-written ``swa_attention`` kernel;
  ``plain`` keeps the halo chunk loop.  Without ``--kernel`` (or with
  ``--row-chunks``) the config's own chunking applies.  Then AdamW steps
  on ``TokenDataset`` batches.

Both print ``plan: ...`` and the loss per step and write ``train_log.json``
(schema-1 envelope) into ``--out``.  They run on ``cuda`` unless
``--device cpu``.

Differences from the reference: ``--batch`` defaults to the config's batch
for CNNs (32 for the full preset), ``--lr`` to 0.05 for CNNs and 3e-4 for
LMs, and the kernel backends are named ``plain``/``cuda``.
``--mesh``, ``--plan-cache``, ``--trace``, ``--metrics-out``, the LM
archs other than gemma3_4b, and ``--budget-gb``/``--residency`` on the LM
path are not ported yet and raise; ``--save`` (checkpoints) is not there
yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from repro_torch.data.pipeline import (
    ImageDataset, ImageDatasetConfig, TokenDataset, TokenDatasetConfig,
)
from repro_torch.obs.steplog import StepLog
from repro_torch.optim.adamw import (
    AdamWConfig, SGDConfig, adamw_init, sgd_init, sgd_update, tree_leaves,
    tree_map,
)

#: flags of the reference trainer that wait for later slices of the port
_NOT_PORTED_FLAGS = ("mesh", "plan_cache", "trace", "metrics_out")
CNN_ARCHS = ("vgg16", "resnet50")
#: the reference's CNN learning rate; LMs take AdamW's 3e-4
CNN_LR, LM_LR = 0.05, 3e-4


#: CNN flags the LM trainer does not take yet
_NOT_PORTED_LM_FLAGS = ("budget_gb", "residency")


def _check_flags(args, names=_NOT_PORTED_FLAGS, where="") -> None:
    for name in names:
        if getattr(args, name) not in (None, ""):
            raise NotImplementedError(
                f"--{name.replace('_', '-')} is not ported yet{where}")


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available; "
                           "pass --device cpu to run the plain versions")
    return device


def train_cnn(args, params=None):
    """Train ``args.steps`` SGD steps; returns the step records.  ``params``
    (a tree on the target device) replaces the seeded init — the parity
    tests pass the reference's init through it."""
    _check_flags(args)
    if args.arch not in CNN_ARCHS:
        raise ValueError(f"--arch {args.arch} is not a CNN; CNN archs: "
                         f"{list(CNN_ARCHS)}")
    import importlib
    from repro_torch.exec import Planner, build_apply
    from repro_torch.models.cnn import resnet, vgg

    device = _device(args.device)
    # the parity the port is held to is fp32 (1e-5): cuDNN convolutions
    # default to TF32 on the card, which keeps ~3 decimal digits
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    cfgmod = importlib.import_module(f"repro_torch.configs.{args.arch}")
    ccfg = cfgmod.reduced() if args.preset == "reduced" else cfgmod.CONFIG
    shape = (ccfg.image, ccfg.image, ccfg.channels)
    gen = torch.Generator().manual_seed(args.seed)
    if ccfg.arch == "vgg16":
        mods, init = vgg.init_vgg16(gen, shape, ccfg.width_mult,
                                    ccfg.n_classes, device=device)
        head_apply = vgg.head_apply
    else:
        mods, init = resnet.init_resnet50(gen, shape, ccfg.width_mult,
                                          ccfg.n_classes, device=device)
        head_apply = resnet.head_apply
    params = init if params is None else params

    # the reference's precedence: --budget-gb clears engine and N (the
    # Planner picks them), then --strategy / --rows pin them; an omitted
    # flag leaves the config's request
    batch = args.batch or ccfg.batch
    req = ccfg.plan
    if args.budget_gb is not None:
        req = dataclasses.replace(req, engine="", n_rows=0,
                                  budget_gb=args.budget_gb)
    if args.strategy is not None:
        req = dataclasses.replace(req, engine=args.strategy)
    if args.rows is not None:
        req = dataclasses.replace(req, n_rows=args.rows)
    if args.kernel:
        req = dataclasses.replace(req, kernel=args.kernel)
    if args.residency:
        req = dataclasses.replace(req, residency=args.residency)
    # the paper's xi: params + grads + optimizer state live beside activations
    n_params = sum(l.numel() for l in tree_leaves(params))
    plan = Planner(mods, shape, batch, xi=3 * 4 * n_params).resolve(req)
    print("plan:", plan.describe(), flush=True)
    trunk_apply = build_apply(mods, plan)
    print(f"arch={ccfg.arch} engine={plan.engine} N={plan.n_rows} "
          f"params={n_params / 1e6:.1f}M image={ccfg.image} batch={batch} "
          f"device={device}", flush=True)

    def loss_fn(p, images, labels):
        logits = head_apply(p["head"], trunk_apply(p["trunk"], images))
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(1, labels[:, None]).mean()

    opt_cfg = SGDConfig(lr=CNN_LR if args.lr is None else args.lr)
    opt = sgd_init(params)
    ds = ImageDataset(ImageDatasetConfig(
        h=ccfg.image, w=ccfg.image, c=ccfg.channels,
        n_classes=ccfg.n_classes, batch=batch, seed=args.seed))
    os.makedirs(args.out, exist_ok=True)
    steplog = StepLog()
    t0 = time.time()
    for step in range(args.steps):
        hb = ds.batch_at(step)
        images = torch.from_numpy(hb["images"]).to(device)
        labels = torch.from_numpy(hb["labels"]).long().to(device)
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = loss_fn(p, images, labels)
        leaves = iter(torch.autograd.grad(loss, tree_leaves(p)))
        grads = tree_map(lambda _: next(leaves), p)
        params, opt, _ = sgd_update(params, grads, opt, opt_cfg)
        if step % args.log_every == 0 or step == args.steps - 1:
            steplog.log({"step": step, "loss": loss.item(),
                         "elapsed_s": round(time.time() - t0, 3)})
    steplog.dump(os.path.join(args.out, "train_log.json"),
                 arch=ccfg.arch, mode="cnn", plan=plan.to_dict(),
                 plan_audit=None)
    return steplog.records


def train_lm(args, cfg=None, params=None):
    """Train ``args.steps`` AdamW steps of a decoder-only LM; returns the
    step records.  ``cfg`` (a ModelConfig) replaces the preset's and
    ``params`` (a tree on the target device) the seeded init: the chip
    smoke cuts the depth through the first, the parity tests pass the
    reference's init through the second."""
    _check_flags(args)
    _check_flags(args, _NOT_PORTED_LM_FLAGS, " on the LM path")
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.exec import Planner
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.lm.model import init_lm

    device = _device(args.device)
    # fp32 matmuls stay fp32 (bf16 activations are the config's choice)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if cfg is None:
        cfg = get_reduced(args.arch) if args.preset == "reduced" \
            else get_config(args.arch)
    if args.row_chunks:
        cfg = dataclasses.replace(cfg, row_chunks=args.row_chunks)
    batch = args.batch or 8
    plan = None
    if args.kernel and not args.row_chunks:  # explicit --row-chunks wins
        plan = Planner.for_model(cfg, batch, args.seq, kernel=args.kernel)
        print("plan:", plan.describe(), flush=True)
    if params is None:
        params = init_lm(torch.Generator(device=device).manual_seed(
            args.seed), cfg)
    n_params = sum(l.numel() for l in tree_leaves(params))
    row_chunks = plan.n_rows if plan is not None else cfg.row_chunks
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M "
          f"row_chunks={row_chunks} remat={cfg.remat} batch={batch} "
          f"seq={args.seq} device={device}", flush=True)

    opt_cfg = AdamWConfig(lr=LM_LR if args.lr is None else args.lr)
    state = {"params": params, "opt": adamw_init(params)}
    del params
    step_fn = make_train_step(cfg, opt_cfg, plan=plan)
    ds = TokenDataset(TokenDatasetConfig(vocab=cfg.vocab, seq_len=args.seq,
                                         batch=batch, seed=args.seed))
    os.makedirs(args.out, exist_ok=True)
    steplog = StepLog()
    t0 = time.time()
    for step in range(args.steps):
        hb = ds.batch_at(step)
        data = {k: torch.from_numpy(hb[k]).long().to(device)
                for k in ("tokens", "labels")}
        state, metrics = step_fn(state, data)
        if step % args.log_every == 0 or step == args.steps - 1:
            rec = {k: float(v) for k, v in metrics.items()}
            rec.update(step=step, elapsed_s=round(time.time() - t0, 3))
            steplog.log(rec)
    steplog.dump(os.path.join(args.out, "train_log.json"),
                 arch=cfg.name, mode="lm",
                 plan=plan.to_dict() if plan is not None else None,
                 plan_audit=None)
    return steplog.records


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", default="reduced",
                    choices=["reduced", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default: the CNN config's, 8 for "
                         "LMs)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=None,
                    help=f"default {CNN_LR} (CNN) or {LM_LR} (LM)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--strategy", default=None,
                    help="pin the engine: base | ckp | overlap | twophase "
                         "| overlap_h | twophase_h (overlap_cuda via "
                         "--kernel cuda)")
    ap.add_argument("--rows", type=int, default=None,
                    help="pin the row granularity N")
    ap.add_argument("--row-chunks", type=int, default=0,
                    help="LM: the sequence chunk count (overrides the "
                         "config's and skips the plan)")
    ap.add_argument("--kernel", default="", choices=["", "plain", "cuda"],
                    help="'cuda' swaps the resolved engine for its "
                         "CUDA-kernel alternate when the kernel can run "
                         "it, recording kernel_fallback otherwise (LM: "
                         "plans the sequence axis, then kernelizes)")
    ap.add_argument("--budget-gb", type=float, default=None,
                    help="activation byte budget; Planner.for_budget picks "
                         "engine and granularity under it")
    ap.add_argument("--residency", default="",
                    choices=["", "device", "host", "recompute"],
                    help="boundary-cache residency of the carry-based "
                         "engines: 'host' offloads the 2PS caches to "
                         "pinned memory with prefetch, 'recompute' "
                         "regenerates them in the backward")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--out", default="experiments/train")
    for flag in _NOT_PORTED_FLAGS:
        ap.add_argument("--" + flag.replace("_", "-"), default=None,
                        help="not ported yet")
    return ap


def main(argv=None, **kwargs):
    """Parse ``argv`` and train; ``kwargs`` go to ``train_cnn`` or
    ``train_lm`` (``params``, and ``cfg`` for an LM)."""
    args = build_parser().parse_args(argv)
    if args.arch in CNN_ARCHS:
        return train_cnn(args, **kwargs)
    return train_lm(args, **kwargs)


if __name__ == "__main__":
    main()
