"""Training driver (counterpart of ``repro.launch.train``).  Two modes:

* CNN (``--arch vgg16``, ``resnet50`` or ``convnext_b384``)::

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

  ``--arch`` is any of the ten LM configs: dense (``gemma3_4b``,
  ``llama3_2_3b``, ``qwen1_5_4b``, ``qwen1_5_110b``), MoE
  (``deepseek_moe_16b``, ``qwen3_moe_235b_a22b``), SSM and hybrid
  (``zamba2_7b``, ``xlstm_125m``), VLM (``llava_next_34b``: zero patch
  embeddings of ``n_frontend_tokens`` go before the ``--seq`` text tokens)
  and encoder-decoder (``seamless_m4t_medium``: ``--seq`` frames drawn
  from ``np.random.default_rng((seed, step))``, the reference's, and
  ``--seq`` tokens).  ``--budget-gb``, ``--residency`` or ``--kernel``
  plans the sequence axis (``Planner.for_model``; an explicit
  ``--row-chunks`` wins and skips the plan): the budget picks the chunk
  count, ``--residency host|recompute`` places the carried state of the
  SSM/xLSTM chunk scans (``seq_carry_scan``) through the row-program
  executor, and ``--kernel cuda`` kernelizes gemma's ``seq_swa_overlap``
  plan to ``seq_swa_cuda``, whose local attention layers run the
  hand-written ``swa_attention`` kernel (``plain`` keeps the halo chunk
  loop; a plan with no CUDA alternate records ``kernel_fallback``).
  Without these flags the config's own chunking applies.  Then AdamW
  steps on ``TokenDataset`` batches.

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

Sharding and checkpoints:

* ``--mesh data=2`` (or ``data=1,model=2``, ``pod=...``) runs one rank
  per mesh coordinate, on both trainers.  Under ``torchrun`` the
  trainer joins the group the environment describes (``nccl`` when each
  rank has a card, ``gloo`` on the CPU or when ranks share a card;
  :mod:`repro_torch.launch.mesh`); a caller that spawned its ranks joins
  the group itself first.  The Planner solves per device, the plan's mesh
  makes ``build_apply`` wrap the engine in the CNN shard wrapper, and each
  rank takes its slice of ``ImageDataset.batch_at(step)`` through
  ``device_put_global``.  Only rank 0 prints and writes ``train_log.json``;
  every rank returns the records::

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch vgg16 --preset reduced --strategy overlap --rows 2 \
        --mesh data=2 --batch 4 --steps 3 --device cpu --out /tmp/t

  On the LM trainer the Planner solves per device too (the plan's JSON
  is the reference's), and each rank holds only its shard of the
  parameters and the AdamW moments, the one ``state_sharding`` places on
  its mesh coordinate (:mod:`repro_torch.launch.steps`): heads, the MLP's
  ff, the vocabulary and the experts split over ``model`` (Megatron's
  column/row pairs, a vocab-parallel embedding and cross-entropy), the
  batch over ``data``, the leaves a layer cannot compute on split
  gathered at use.  Each rank takes its rows of the step's batch; the
  loss, the gradients and the updated shards are one process's::

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch gemma3_4b --preset reduced --seq 64 --batch 2 \
        --mesh data=1,model=2 --steps 3 --device cpu --out /tmp/t
* ``--save`` on the LM trainer writes the params, the AdamW state,
  ``{"arch": ...}`` and the plan into ``--out`` after the last step
  (:mod:`repro_torch.ckpt.store`), as the reference does; under a mesh
  each split leaf is written shard by shard (``DTensor`` s over the
  state's placements).  The CNN trainer saves nothing, as in the
  reference.

Differences from the reference: ``--batch`` defaults to the config's batch
for CNNs (32 for the full preset), ``--lr`` to 0.05 for CNNs and 3e-4 for
LMs, the kernel backends are named ``plain``/``cuda``, and
``--torch-profile`` stands for ``--jax-profile``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
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

CNN_ARCHS = ("vgg16", "resnet50", "convnext_b384")
#: the reference's CNN learning rate; LMs take AdamW's 3e-4
CNN_LR, LM_LR = 0.05, 3e-4



def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


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
                est_bytes=None, echo=True):
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
    if echo:
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
    tests pass the reference's init through it.  Under ``--mesh`` a
    process group the run joins from the environment ends with the run."""
    import torch.distributed as dist

    from repro_torch.exec import MeshSpec
    from repro_torch.launch.mesh import (
        init_from_env, rank_device, require_device,
    )
    if args.arch not in CNN_ARCHS:
        raise ValueError(f"--arch {args.arch} is not a CNN; CNN archs: "
                         f"{list(CNN_ARCHS)}")
    device = require_device(args.device, "run the plain versions")
    mesh_spec = MeshSpec.parse(args.mesh) if args.mesh else None
    if mesh_spec is not None and init_from_env(device):
        try:
            return _train_cnn(args, params, rank_device(device), mesh_spec)
        finally:
            dist.destroy_process_group()
    return _train_cnn(args, params, rank_device(device), mesh_spec)


def _train_cnn(args, params, device, mesh_spec):
    import importlib
    from repro_torch.data.pipeline import device_put_global
    from repro_torch.exec import Planner, build_apply
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.models.cnn import convnext, resnet, vgg

    say = print if _rank() == 0 else (lambda *a, **k: None)
    # the parity the port is held to is fp32 (1e-5): cuDNN convolutions
    # default to TF32 on the card, which keeps ~3 decimal digits
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    cfgmod = importlib.import_module(f"repro_torch.configs.{args.arch}")
    ccfg = cfgmod.reduced() if args.preset == "reduced" else cfgmod.CONFIG
    shape = (ccfg.image, ccfg.image, ccfg.channels)
    gen = torch.Generator().manual_seed(args.seed)
    model = {"vgg16": (vgg.init_vgg16, vgg.head_apply),
             "resnet50": (resnet.init_resnet50, resnet.head_apply),
             "convnext_b384": (convnext.init_convnext,
                               convnext.head_apply)}
    init_fn, head_apply = model[ccfg.arch]
    mods, init = init_fn(gen, shape, ccfg.width_mult, ccfg.n_classes,
                         device=device)
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
        lambda table: Planner(mods, shape, batch, xi=xi, mesh=mesh_spec,
                              cost_table=table).resolve(req), device)
    say("plan:", plan.describe(), flush=True)
    # plan.mesh makes build_apply wrap the engine in the CNN shard wrapper;
    # the trainer holds no sharding code beyond its batch slice
    trunk_apply = build_apply(mods, plan)
    mesh = build_mesh(mesh_spec) if mesh_spec is not None else None
    say(f"arch={ccfg.arch} engine={plan.engine} N={plan.n_rows} "
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
                if mesh is not None:
                    # this rank's slice of the global batch; the trunk's
                    # output comes back whole, and so do the labels
                    images = device_put_global(hb, mesh,
                                               device=device)["images"]
                else:
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
                             "elapsed_s": round(time.time() - t0, 3)},
                            echo=_rank() == 0)
    if _rank() == 0:
        # the estimate's terms, so a measured peak can be read against each
        priced = Planner(mods, shape, batch, xi=xi, mesh=mesh_spec)
        steplog.dump(os.path.join(args.out, "train_log.json"),
                     arch=ccfg.arch, mode="cnn", plan=plan.to_dict(),
                     plan_audit=audit,
                     plan_terms=priced.estimate_terms(plan),
                     plan_sd=priced.sd_volume(plan))
    return steplog.records


def lm_host_batch(cfg, hb, step: int, seed: int):
    """The step's LM batch as host arrays, as the reference builds it: the
    token dataset's tokens and labels (int64), plus zero patch embeddings
    (B, n_frontend_tokens, frontend_dim) for a VLM, or for the
    encoder-decoder the frames (B, seq, d_model) drawn from
    ``default_rng((seed, step))``."""
    batch = {k: np.asarray(hb[k], dtype=np.int64)
             for k in ("tokens", "labels")}
    B, S = hb["tokens"].shape
    if cfg.family == "vlm":
        batch["patch_embeds"] = np.zeros(
            (B, cfg.n_frontend_tokens, cfg.frontend_dim), np.float32)
    if cfg.family == "encdec":
        batch["frames"] = np.random.default_rng((seed, step)).normal(
            0, 1, (B, S, cfg.d_model)).astype(np.float32)
    return batch


def lm_batch(cfg, hb, step: int, seed: int, device):
    """:func:`lm_host_batch` on ``device``."""
    return {k: torch.from_numpy(v).to(device)
            for k, v in lm_host_batch(cfg, hb, step, seed).items()}


def train_lm(args, cfg=None, params=None):
    """Train ``args.steps`` AdamW steps of an LM; returns the step
    records.  ``cfg`` (a ModelConfig) replaces the preset's and
    ``params`` (a global tree on the target device) the seeded init: the
    chip smoke cuts the depth through the first, the parity tests pass the
    reference's init through the second.  Under ``--mesh`` a process group
    the run joins from the environment ends with the run."""
    import torch.distributed as dist

    from repro_torch.exec import MeshSpec
    from repro_torch.launch.mesh import (
        init_from_env, rank_device, require_device,
    )
    device = require_device(args.device, "run the plain versions")
    mesh_spec = MeshSpec.parse(args.mesh) if args.mesh else None
    if mesh_spec is not None and init_from_env(device):
        try:
            return _train_lm(args, cfg, params, rank_device(device),
                             mesh_spec)
        finally:
            dist.destroy_process_group()
    return _train_lm(args, cfg, params, rank_device(device), mesh_spec)


def _shard_state(params, cfg, args, batch, mesh_spec):
    """``(state, ctx, placements)`` of a sharded run: the context of
    ``cfg`` at the run's shape, bound to this rank's groups, and this
    rank's shards of ``params`` (copies; the global tree is dropped by the
    caller) with AdamW moments of their shapes."""
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.launch.sharding import bind_groups, local_shards
    from repro_torch.launch.steps import (
        ShapeSpec, make_shape_ctx, state_sharding,
    )
    mesh = build_mesh(mesh_spec)
    ctx = bind_groups(make_shape_ctx(
        mesh, cfg, ShapeSpec("cli", "train", args.seq, batch)))
    places = state_sharding(ctx, {"params": params})["params"]
    local = local_shards(params, places, mesh)
    return {"params": local, "opt": adamw_init(local)}, ctx, places


def _as_dtensors(state, places, mesh):
    """The state's shards as ``DTensor`` s over their placements, which
    :func:`repro_torch.ckpt.store.save` writes shard by shard."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.sharding import zip_map

    def one(t, pl):
        return DTensor.from_local(t, mesh, pl, run_check=False)

    opt = state["opt"]
    return (zip_map(one, state["params"], places),
            {"mu": zip_map(one, opt["mu"], places),
             "nu": zip_map(one, opt["nu"], places), "step": opt["step"]})


def _train_lm(args, cfg, params, device, mesh_spec):
    from repro_torch.ckpt import store
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.exec import Planner, ResidencySpec
    from repro_torch.data.pipeline import device_put_global
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.lm.model import family_fns

    root = _rank() == 0
    say = print if root else (lambda *a, **k: None)
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
    # the reference's precedence: a budget, a residency or a kernel asks
    # for a sequence plan, and an explicit --row-chunks wins over it
    wants_plan = args.budget_gb is not None or args.residency or args.kernel
    if wants_plan and not args.row_chunks:
        plan = _resolve_plan(
            args,
            dict(mode="lm", arch=cfg.name, preset=args.preset, batch=batch,
                 seq=args.seq, budget_gb=args.budget_gb,
                 mesh=args.mesh or "", residency=args.residency,
                 kernel=args.kernel),
            lambda table: Planner.for_model(
                cfg, batch, args.seq,
                budget=int((args.budget_gb or 0.0) * 2**30),
                mesh=mesh_spec, residency=ResidencySpec.parse(args.residency),
                kernel=args.kernel or None), device)
        say("plan:", plan.describe(), flush=True)
    if params is None:
        params = family_fns(cfg).init(torch.Generator(
            device=device).manual_seed(args.seed), cfg)
    n_params = sum(l.numel() for l in tree_leaves(params))
    # the paper's ξ: 4 × the global parameter bytes (params, grads, two
    # AdamW moments), the reference's integer under a mesh too
    xi = 4 * sum(int(t.nbytes) for t in tree_leaves(params))
    row_chunks = plan.n_rows if plan is not None else cfg.row_chunks
    say(f"arch={cfg.name} params={n_params / 1e6:.1f}M "
        f"row_chunks={row_chunks} remat={cfg.remat} batch={batch} "
        f"seq={args.seq} device={device}"
        + (f" mesh={mesh_spec.describe()}" if mesh_spec else ""),
        flush=True)

    opt_cfg = AdamWConfig(lr=LM_LR if args.lr is None else args.lr)
    ctx = places = None
    if mesh_spec is not None:
        # each rank keeps only its shard of the parameters and moments
        state, ctx, places = _shard_state(params, cfg, args, batch,
                                          mesh_spec)
    else:
        state = {"params": params, "opt": adamw_init(params)}
    del params
    step_fn = make_train_step(cfg, opt_cfg, ctx=ctx, plan=plan)
    ds = TokenDataset(TokenDatasetConfig(vocab=cfg.vocab, seq_len=args.seq,
                                         batch=batch, seed=args.seed))
    os.makedirs(args.out, exist_ok=True)
    steplog = StepLog("train")
    audit = None
    t0 = time.time()
    for step in range(args.steps):
        with obs.profile_range(f"train_step {step}"):
            with obs.profile_range("data"):
                if ctx is None:
                    data = lm_batch(cfg, ds.batch_at(step), step, args.seed,
                                    device)
                else:  # this rank's rows, over the context's batch axes
                    data = device_put_global(
                        lm_host_batch(cfg, ds.batch_at(step), step,
                                      args.seed), ctx.mesh,
                        batch_axes=ctx.logical["batch"] or (),
                        device=device)
            if step == 0 and obs.enabled():
                # the plan prices the sequence-chunk term; the paper's ξ
                # (params + grads + two AdamW moments, fp32 beside the
                # activations) makes it comparable to the step's peak
                est = None if plan is None \
                    else plan.est_bytes_per_device + xi
                (state, metrics), audit = _audit_step(
                    lambda: step_fn(state, data), plan,
                    {"arch": cfg.name, "batch": batch, "seq": args.seq},
                    device, source="train_step_lm", est_bytes=est,
                    echo=root)
            else:
                state, metrics = step_fn(state, data)
            if step % args.log_every == 0 or step == args.steps - 1:
                rec = {k: float(v) for k, v in metrics.items()}
                rec.update(step=step, elapsed_s=round(time.time() - t0, 3))
                steplog.log(rec, echo=root)
    if args.save:
        # the executed plan rides along as a JSON sidecar, so the
        # checkpoint replays its own policy; a sharded state saves per
        # shard
        p, o = (state["params"], state["opt"]) if ctx is None \
            else _as_dtensors(state, places, ctx.mesh)
        store.save(args.out, args.steps, p, o, {"arch": cfg.name},
                   plan=plan)
    if root:
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
                         "engine and granularity under it (LM: "
                         "Planner.for_model picks the chunk count)")
    ap.add_argument("--residency", default="",
                    choices=["", "device", "host", "recompute"],
                    help="boundary-cache residency of the carry-based "
                         "engines: 'host' offloads the 2PS caches (LM: the "
                         "SSM/xLSTM carried state) to pinned memory with "
                         "prefetch, 'recompute' regenerates them in the "
                         "backward")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--out", default="experiments/train")
    ap.add_argument("--mesh", default="",
                    help="device mesh, e.g. data=2 or data=1,model=2: one "
                         "rank per coordinate (torchrun), the budget per "
                         "device; an LM rank holds only its shard of the "
                         "parameters and AdamW moments")
    ap.add_argument("--save", action="store_true",
                    help="LM: checkpoint params, AdamW state and plan into "
                         "--out after the last step")
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
