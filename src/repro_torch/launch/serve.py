"""Serving CLI — a thin front end over :mod:`repro_torch.serve`
(counterpart of ``repro.launch.serve``).

Continuous batching by default: requests are admitted into decode slots as
they free up, under the byte budget the Planner turns into a slot count.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3_4b \\
      --preset full --requests 24 --traffic poisson --mixed-prompts \\
      --prompt-len 1024 --gen 64 --budget-gb 2

``--arch`` is any of the ten LM configs.  As in the reference, a VLM's
requests carry ``n_frontend_tokens`` patch embeddings each, and an
encoder-decoder's carry frames as long as ``--prompt-len`` (the pool's
``enc_len``; enc-dec pools are ``--cache-kind full`` only).  Every flag of
the reference is here; ``--torch-profile DIR`` stands for
``--jax-profile``, and ``--device`` (default ``cuda``; it raises when no
card is present and never falls back to the CPU) picks where parameters,
pool and decode live.  Parameters are initialised from ``--seed`` on
that device.  The old one-shot flags still work (``--batch 4
--prompt-len 64 --gen 32`` serves a static batch of identical-length
prompts arriving together).  Prints the pool plan, a summary and ``serve
OK``; ``--out DIR`` writes the reference's artefact JSON.

``--mesh data=D[,model=M]`` runs one rank per mesh coordinate, as
``train --mesh`` does: start the ranks with ``torchrun --nproc-per-node
D*M`` (the group is joined from its environment and ended with the run)
or join a group before calling :func:`main`.  The decode-slot pool's slot
axis is split over the batch axes (each rank holds ``slots_per_device``
slots, :mod:`repro_torch.serve.cache_pool`), the parameters are whole on
every rank, and rank 0 alone prints and writes the artefact; the streams
equal one process's::

  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
      --arch qwen1_5_4b --preset reduced --mesh data=2 --device cpu \\
      --requests 6 --traffic poisson --mixed-prompts --prompt-len 32 \\
      --gen 8 --budget-gb 0.001
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.exec.plancache import add_plan_cache_arg
    from repro_torch.obs.cli import add_obs_args
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", default="reduced", choices=["reduced", "full"])
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slots when --budget-gb is 0 (old flag; "
                         "also the default --requests count)")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--budget-gb", type=float, default=0.0,
                    help="serving byte budget: sizes the decode cache pool "
                         "(slot count) and bounds each prompt's chunked "
                         "prefill")
    ap.add_argument("--requests", type=int, default=0,
                    help="number of requests (default: --batch)")
    ap.add_argument("--traffic", default="static",
                    choices=["static", "poisson", "bursty"])
    ap.add_argument("--mean-interarrival", type=float, default=2.0,
                    help="poisson/bursty mean inter-arrival, in scheduler "
                         "ticks")
    ap.add_argument("--burst", type=int, default=4,
                    help="bursty traffic: mean requests per arrival clump")
    ap.add_argument("--mixed-prompts", action="store_true",
                    help="sample prompt lengths from {P/4, P/2, P} instead "
                         "of a fixed --prompt-len P")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--mesh", default="",
                    help="device mesh spec (e.g. data=2): the global "
                         "budget is divided by the batch extent and the "
                         "decode-slot pool is sharded over it")
    ap.add_argument("--residency", default="",
                    choices=["", "device", "host", "recompute"],
                    help="boundary-cache residency policy recorded on "
                         "each prompt's budget-chunked prefill plan")
    ap.add_argument("--cache-kind", default="full",
                    choices=["full", "paged_kv", "quant_kv"],
                    help="decode cache pool layout: contiguous worst-case "
                         "slots, paged KV behind a block table, or int8 "
                         "quantised KV")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per page (paged_kv)")
    ap.add_argument("--decode-residency", default="",
                    choices=["", "device", "host"],
                    help="decode-state residency: 'host' keeps pool "
                         "buffers in pinned host memory and fetches the "
                         "decode cohort one tick ahead")
    ap.add_argument("--decode-batch", type=int, default=0,
                    help="cap the per-tick decode cohort (0 = whole pool)")
    ap.add_argument("--preemptible-prefill", action="store_true",
                    help="chunked prefill spends one tick per row chunk "
                         "and can be evicted by higher-priority arrivals")
    ap.add_argument("--priority-levels", type=int, default=1,
                    help="sample request priorities from [0, levels)")
    ap.add_argument("--slo-p50", type=float, default=0.0,
                    help="p50 latency SLO target, in scheduler ticks")
    ap.add_argument("--slo-p95", type=float, default=0.0,
                    help="p95 latency SLO target, in scheduler ticks")
    ap.add_argument("--out", default="",
                    help="write a serve artefact JSON (args + resolved "
                         "pool plan + cache kind/decode residency + "
                         "summary) to this directory")
    ap.add_argument("--device", default="cuda",
                    help="where parameters, the pool and decode live "
                         "(default cuda; cpu runs the same code on the "
                         "host)")
    add_plan_cache_arg(ap)
    add_obs_args(ap)
    return ap


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available; "
                           "pass --device cpu to serve on the host")
    return device


def _enc_len(args, cfg) -> int:
    """The encoder-decoder pool's frames per request: ``--prompt-len``."""
    return args.prompt_len if cfg.family == "encdec" else 0


def make_serve_requests(args, cfg):
    """The run's traffic, from the flags (the reference's mapping)."""
    from repro_torch.serve import make_requests
    prompt_len = args.prompt_len
    if args.mixed_prompts:
        # a list is a choice set for make_requests even when the buckets
        # collapse to 2 distinct lengths (only a tuple means a range)
        prompt_len = sorted({max(4, args.prompt_len // 4),
                             max(4, args.prompt_len // 2), args.prompt_len})
    priority = 0 if args.priority_levels <= 1 \
        else (0, args.priority_levels - 1)
    # per-request feature stubs: patch embeddings for a VLM, frames as
    # long as --prompt-len (the pool's enc_len) for the encoder-decoder
    feature = {}
    if cfg.frontend == "vision":
        feature = {"frontend": "vision",
                   "n_feature_tokens": cfg.n_frontend_tokens}
    elif cfg.family == "encdec":
        feature = {"frontend": "audio",
                   "n_feature_tokens": _enc_len(args, cfg),
                   "feature_dim": cfg.d_model}
    return make_requests(
        args.requests or args.batch, cfg.vocab, seed=args.seed,
        traffic=args.traffic, prompt_len=prompt_len,
        max_new_tokens=args.gen, mean_interarrival=args.mean_interarrival,
        temperature=args.temperature, top_k=args.top_k,
        priority=priority, burst_size=args.burst, **feature)


def serve_from_args(args, cfg=None, params=None, **overrides):
    """Serve what the flags describe; returns ``(report, plan, record,
    wall seconds)``, ``record`` being the artefact JSON's content.  An obs
    session the flags open stays open for the caller to shut down.  ``cfg``
    replaces the preset's config and ``params`` (a tree on the target
    device) the seeded init; ``overrides`` go to
    :func:`repro_torch.serve.serve` (``n_slots=`` pins the pool's slot
    count under a budget, as the card check does to compare cache kinds
    at one decode shape)."""
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models.lm.model import family_fns
    from repro_torch.obs.cli import configure_from_args, profiled
    from repro_torch.serve import SLO, serve

    from repro_torch.exec import MeshSpec
    from repro_torch.launch.mesh import rank_device
    mesh_spec = MeshSpec.parse(args.mesh) if args.mesh else None
    device = rank_device(_device(args.device))
    if mesh_spec is not None:
        import torch.distributed as dist
        have = dist.get_world_size() if dist.is_initialized() else 1
        if have != mesh_spec.n_devices:
            raise ValueError(
                f"--mesh {args.mesh} needs {mesh_spec.n_devices} ranks, "
                f"one a mesh coordinate, but the process group has {have}; "
                f"start them with torchrun --nproc-per-node "
                f"{mesh_spec.n_devices}")
    if cfg is None:
        cfg = get_reduced(args.arch) if args.preset == "reduced" \
            else get_config(args.arch)
    fns = family_fns(cfg)
    configure_from_args(args, tool="serve", arch=args.arch,
                        cache_kind=args.cache_kind, traffic=args.traffic)
    budget = int(args.budget_gb * 2**30)
    requests = make_serve_requests(args, cfg)
    if params is None:
        params = fns.init(torch.Generator(device=device).manual_seed(
            args.seed), cfg)
    slo = None
    if args.slo_p50 or args.slo_p95:
        slo = SLO(p50_latency=args.slo_p50, p95_latency=args.slo_p95)
    kw = dict(budget=budget, n_slots=0 if budget else args.batch,
              enc_len=_enc_len(args, cfg),
              prefill_budget=budget, mesh=mesh_spec,
              residency=args.residency,
              cache_kind=args.cache_kind, page_size=args.page_size,
              decode_residency=args.decode_residency,
              decode_batch=args.decode_batch,
              preemptible_prefill=args.preemptible_prefill, slo=slo,
              plan_cache=args.plan_cache)
    kw.update(overrides)

    def walltime():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    t0 = walltime()
    with profiled(args):
        report, plan = serve(params, cfg, requests, walltime_fn=walltime,
                             **kw)
    wall = walltime() - t0
    s = report.summary()
    rec = {
        "arch": cfg.name, "preset": args.preset,
        "traffic": args.traffic, "requests": len(requests),
        "budget_bytes": budget, "mesh": args.mesh,
        "cache_kind": args.cache_kind,
        "prefill_residency": args.residency,
        "decode_residency": (plan.residency.describe()
                             if plan.residency is not None else ""),
        "exec_plan": plan.to_dict(),
        "exec_plan_per_device": plan.per_device().to_dict(),
        "slo": s.get("slo"),
        "summary": s,
        "plan_audit": report.plan_audit,
    }
    return report, plan, rec, wall


def write_artefact(args, rec) -> str:
    """Write the serve artefact JSON into ``--out``; returns its path."""
    os.makedirs(args.out, exist_ok=True)
    tag = f"{rec['arch']}_{args.cache_kind}_{args.traffic}"
    path = os.path.join(args.out, tag + ".json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    return path


def main(argv=None):
    """Serve what ``argv`` says and print the summary (rank 0 alone under
    ``--mesh``); returns the report.  Under ``--mesh`` a process group the
    run joins from the environment (``torchrun``) ends with the run."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_from_env
    args = build_parser().parse_args(argv)
    joined = bool(args.mesh) and init_from_env(_device(args.device))
    try:
        return _main(args)
    finally:
        if joined:
            dist.destroy_process_group()


def _main(args):
    import torch.distributed as dist

    from repro_torch import obs
    report, plan, rec, wall = serve_from_args(args)
    # numeric health is enforced inside the engine: ServeEngine.sample
    # raises FloatingPointError on non-finite logits, so reaching this
    # point means every generated token came from finite logits
    assert all(st.done for st in report.states)
    if dist.is_initialized() and dist.get_rank() != 0:
        obs.shutdown()
        return report
    s = rec["summary"]
    print("pool plan:", plan.describe())
    if report.plan_audit is not None:
        a = report.plan_audit
        print(f"plan audit: {a['audited_term']} {a['est_bytes_per_device']} "
              f"measured pool {a['measured']['peak_bytes']}"
              + (f" ratio {a['ratio']:.3f}"
                 if a['ratio'] is not None else ""))
    print(f"arch={rec['arch']} requests={s['requests']} "
          f"traffic={args.traffic} cache_kind={args.cache_kind} "
          f"slots={plan.n_rows} device={args.device}")
    print(f"generated {s['generated_tokens']} tokens in {wall:.2f}s "
          f"({s['generated_tokens'] / max(wall, 1e-9):.1f} tok/s wall); "
          f"{s['prefills']} prefills, {s['decode_steps']} decode steps, "
          f"max_active={s['max_active']}, "
          f"preemptions={s['preemptions']}")
    print(f"latency ticks: p50={s['p50_latency_ticks']:.1f} "
          f"p95={s['p95_latency_ticks']:.1f} "
          f"ttft p50={s['p50_ttft_ticks']:.1f} "
          f"p95={s['p95_ttft_ticks']:.1f}")
    if "slo" in s:
        print(f"SLO: met={s['slo']['met']} "
              f"attainment={s['slo']['attainment']}")
    for st in report.states[:4]:
        print(f"  request {st.rid}: prompt={st.request.prompt_len} "
              f"slot={st.slot} chunks={st.prefill_chunks} "
              f"tokens={st.generated[:8]}...")
    if args.out:
        # the artefact pins how the run executed: the pool plan (cache
        # kind, page geometry, decode residency) and the summary
        print(f"artefact: {write_artefact(args, rec)}")
    obs.shutdown()
    print("serve OK")
    return report


if __name__ == "__main__":
    main()
