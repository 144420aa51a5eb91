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
(schema-1 envelope) into ``--out``; the CNN trainer's also holds the
plan's estimate split into its terms (``plan_terms``,
``Planner.estimate_terms``) and a 2PS plan's SD volume (``plan_sd``,
``Planner.sd_volume``).  They run on ``cuda`` unless ``--device cpu``.

Observability and planning flags, on both trainers:

* ``--trace PATH`` / ``--metrics-out PATH`` open an obs session
  (:mod:`repro_torch.obs`): the row executor's spans and counters, a
  ``train_step`` span per logged step, and a plan audit of step 0 — on the
  card, step 0 itself runs between ``reset_peak_memory_stats`` and
  ``max_memory_allocated``, and ``plan audit: est/dev ... measured peak
  ... ratio ...`` is printed and written into ``train_log.json``.
  Tracing changes no value a step computes.
* ``--torch-profile DIR`` (with a session) wraps the run in
  ``torch.profiler`` and exports a Chrome trace into ``DIR``; each step is
  a ``train_step <i>`` range with ``data`` / ``forward`` / ``backward`` /
  ``optimizer`` ranges inside (the CNN's; the LM's step has ``data``
  only), and the row engines mark each recomputed row ``row_recompute``.
* ``--plan-cache DIR`` resolves the plan through a persistent cache: a
  hit replays the stored plan without a planner solve; a miss loads, or
  calibrates on the run's device, the ``CostTable`` in ``DIR`` and solves
  with it, so a budget-driven CNN solve ranks candidates by predicted
  step time.

Differences from the reference: ``--batch`` defaults to the config's batch
for CNNs (32 for the full preset), ``--lr`` to 0.05 for CNNs and 3e-4 for
LMs, the kernel backends are named ``plain``/``cuda``, and
``--torch-profile`` stands for ``--jax-profile``.  ``--mesh``, the LM
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

from repro_torch import obs
from repro_torch.data.pipeline import (
    ImageDataset, ImageDatasetConfig, TokenDataset, TokenDatasetConfig,
)
from repro_torch.exec.plancache import add_plan_cache_arg
from repro_torch.obs.audit import measure_step, plan_audit
from repro_torch.obs.cli import add_obs_args, configure_from_args, profiled
from repro_torch.obs.steplog import StepLog
from repro_torch.optim.adamw import (
    AdamWConfig, SGDConfig, adamw_init, sgd_init, sgd_update, tree_leaves,
    tree_map,
)

#: flags of the reference trainer that wait for later slices of the port
_NOT_PORTED_FLAGS = ("mesh",)
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


def _resolve_plan(args, key_fields, solve, device):
    """Resolve a plan through the persistent cache when ``--plan-cache``
    is set, else solve directly.  The cost table is measured on, and the
    cache keyed by, the run's own ``device``.

    ``solve(table)`` performs the planner solve; ``table`` is the
    calibrated :class:`~repro_torch.exec.costmodel.CostTable` under the
    cache directory (None without a cache: the static path).  A hit
    replays the stored plan without calling ``solve`` (zero planner
    solves, visible in the obs counters); a stale cost-table version is a
    miss, so cached decisions never outlive their measurements."""
    if not getattr(args, "plan_cache", ""):
        return solve(None)
    from repro_torch.exec import cached_plan, load_or_calibrate
    from repro_torch.exec.costmodel import hardware_fingerprint
    table = load_or_calibrate(args.plan_cache, device=device)
    key_fields = dict(key_fields, fingerprint=hardware_fingerprint(device))
    plan, hit, key = cached_plan(args.plan_cache, key_fields,
                                 lambda: solve(table),
                                 cost_version=table.version())
    print(f"plan cache: {'hit' if hit else 'miss'} key={key}", flush=True)
    return plan


def _audit_step(call, plan, source_extra, device, source="train_step",
                est_bytes=None):
    """Run step 0, ``call()``, under
    :func:`~repro_torch.obs.audit.measure_step` and record its peak bytes
    against the plan's estimate; returns ``(call's result, audit record)``.
    The audited call is the step itself, so a traced run computes what an
    untraced one does.  ``est_bytes`` overrides the plan's per-device
    estimate when the comparable quantity includes terms outside the
    plan's solve (the LM path adds the paper's ξ).  Without a plan, or on
    the CPU (no memory measurement), the record is None."""
    held = []
    measured = measure_step(lambda: held.append(call()), device=device)
    if plan is None or measured is None:
        return held[0], None
    rec = plan_audit(plan, measured, source, extra=source_extra,
                     est_bytes=est_bytes)
    ratio = rec["ratio"]
    print(f"plan audit: est/dev {rec['est_bytes_per_device']} "
          f"measured peak {measured['peak_bytes']}"
          + (f" ratio {ratio:.3f}" if ratio is not None else ""),
          flush=True)
    return held[0], rec


def _loss_grads(loss, params):
    """The gradients of ``loss`` with respect to the tree ``params``, as a
    tree of the same layout."""
    leaves = iter(torch.autograd.grad(loss, tree_leaves(params)))
    return tree_map(lambda _: next(leaves), params)


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
    # the steps replace the tree: a second name for the initial one would
    # keep a parameter-sized copy alive for the whole run
    params = init if params is None else params
    del init

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
    xi = 3 * 4 * n_params
    plan = _resolve_plan(
        args,
        dict(mode="cnn", arch=ccfg.arch, preset=args.preset,
             image=ccfg.image, channels=ccfg.channels, batch=batch, xi=xi,
             engine=req.engine, n_rows=req.n_rows,
             budget_gb=req.budget_gb, n_segments=req.n_segments,
             mesh=args.mesh or req.mesh, kernel=req.kernel,
             residency=req.residency),
        lambda table: Planner(mods, shape, batch, xi=xi,
                              cost_table=table).resolve(req), device)
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
    def train_step(params, opt, images, labels):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        with obs.profile_range("forward"):
            loss = loss_fn(p, images, labels)
        with obs.profile_range("backward"):
            grads = _loss_grads(loss, p)
        with obs.profile_range("optimizer"):
            params, opt, _ = sgd_update(params, grads, opt, opt_cfg)
        # detached: the loss's graph would hold this step's leaves, which
        # alias its input parameters, until the next step's loss replaces it
        return params, opt, loss.detach()

    os.makedirs(args.out, exist_ok=True)
    steplog = StepLog("train")
    audit = None
    t0 = time.time()
    for step in range(args.steps):
        with obs.profile_range(f"train_step {step}"):
            with obs.profile_range("data"):
                hb = ds.batch_at(step)
                images = torch.from_numpy(hb["images"]).to(device)
                labels = torch.from_numpy(hb["labels"]).long().to(device)
            if step == 0 and obs.enabled():
                (params, opt, loss), audit = _audit_step(
                    lambda: train_step(params, opt, images, labels), plan,
                    {"arch": ccfg.arch, "batch": batch}, device)
            else:
                params, opt, loss = train_step(params, opt, images, labels)
            if step % args.log_every == 0 or step == args.steps - 1:
                steplog.log({"step": step, "loss": loss.item(),
                             "elapsed_s": round(time.time() - t0, 3)})
    # the estimate's terms, so a measured peak can be read against each
    priced = Planner(mods, shape, batch, xi=xi)
    steplog.dump(os.path.join(args.out, "train_log.json"),
                 arch=ccfg.arch, mode="cnn", plan=plan.to_dict(),
                 plan_audit=audit, plan_terms=priced.estimate_terms(plan),
                 plan_sd=priced.sd_volume(plan))
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
        plan = _resolve_plan(
            args,
            dict(mode="lm", arch=cfg.name, preset=args.preset, batch=batch,
                 seq=args.seq, budget_gb=args.budget_gb,
                 mesh=args.mesh or "", residency=args.residency,
                 kernel=args.kernel),
            lambda table: Planner.for_model(cfg, batch, args.seq,
                                            kernel=args.kernel), device)
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
    steplog = StepLog("train")
    audit = None
    t0 = time.time()
    for step in range(args.steps):
        with obs.profile_range(f"train_step {step}"):
            with obs.profile_range("data"):
                hb = ds.batch_at(step)
                data = {k: torch.from_numpy(hb[k]).long().to(device)
                        for k in ("tokens", "labels")}
            if step == 0 and obs.enabled():
                # the plan prices the sequence-chunk term; the paper's ξ
                # (params + grads + two AdamW moments, fp32 beside the
                # activations) makes it comparable to the step's peak
                est = None if plan is None else plan.est_bytes_per_device \
                    + 4 * sum(int(t.nbytes)
                              for t in tree_leaves(state["params"]))
                (state, metrics), audit = _audit_step(
                    lambda: step_fn(state, data), plan,
                    {"arch": cfg.name, "batch": batch, "seq": args.seq},
                    device, source="train_step_lm", est_bytes=est)
            else:
                state, metrics = step_fn(state, data)
            if step % args.log_every == 0 or step == args.steps - 1:
                rec = {k: float(v) for k, v in metrics.items()}
                rec.update(step=step, elapsed_s=round(time.time() - t0, 3))
                steplog.log(rec)
    steplog.dump(os.path.join(args.out, "train_log.json"),
                 arch=cfg.name, mode="lm",
                 plan=plan.to_dict() if plan is not None else None,
                 plan_audit=audit)
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
    add_plan_cache_arg(ap)
    add_obs_args(ap)
    return ap


def main(argv=None, **kwargs):
    """Parse ``argv`` and train; ``kwargs`` go to ``train_cnn`` or
    ``train_lm`` (``params``, and ``cfg`` for an LM).  ``--trace`` /
    ``--metrics-out`` open the obs session for the run and close it (and
    write the metrics dump) when it ends."""
    args = build_parser().parse_args(argv)
    configure_from_args(args, tool="train", arch=args.arch,
                        preset=args.preset)
    try:
        with profiled(args):
            if args.arch in CNN_ARCHS:
                return train_cnn(args, **kwargs)
            return train_lm(args, **kwargs)
    finally:
        obs.shutdown()


if __name__ == "__main__":
    main()
