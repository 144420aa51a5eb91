"""Multi-pod dry run: trace every (arch x shape x mesh) combo as rank 0 of
the production mesh, on ``meta`` tensors, and record the rank's peak
bytes, FLOPs and collective bytes for the roofline report (counterpart of
``repro.launch.dryrun``).

The reference lowers and compiles each step for 256 or 512 placeholder
CPU devices and reads XLA's memory and cost analyses.  Here one process
joins torch's ``fake`` process group as rank 0 of 256 (16x16) or 512
(2x16x16) ranks (:func:`repro_torch.launch.mesh.join_fake_group`), builds
its sharded step with its local shards as ``meta`` tensors
(:func:`repro_torch.launch.steps.build_step`) and runs it once under
:func:`repro_torch.obs.audit.trace_step`: nothing is computed, no memory is
taken, every collective returns at once, and no card is asked for.

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
          --shape all --mesh both --out experiments/dryrun_torch
      PYTHONPATH=src python -m repro_torch.analysis.report \\
          --dir experiments/dryrun_torch
"""

import argparse
import dataclasses
import json
import os
import time
import traceback

from repro_torch import obs
from repro_torch.analysis.costmodel import analyze as cost_analyze
from repro_torch.analysis.roofline import analyze
from repro_torch.configs import get_config, list_configs
from repro_torch.exec import Planner, ResidencySpec, kernelize_plan
from repro_torch.launch.mesh import (
    join_fake_group, leave_fake_group, production_mesh_spec,
)
from repro_torch.launch.steps import SHAPES, build_step, shape_applicable
from repro_torch.obs.audit import plan_audit, trace_step
from repro_torch.obs.cli import add_obs_args, configure_from_args

#: the trace's memory keys the plan audit records (the reference's
#: ``memory_metrics`` keys a trace has)
_AUDIT_KEYS = ("peak_bytes", "argument_size_in_bytes", "temp_size_in_bytes",
               "output_size_in_bytes", "alias_size_in_bytes", "method")


def _write(rec: dict, out_dir: str, tag: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=2, default=str)


def resolve_plan(cfg, shape, multi_pod: bool, kernel: str = "plain",
                 residency: str = ""):
    """The row-centric plan a record carries: solved against the
    production mesh (per-device batch), kernelized for ``kernel`` (the
    KernelSpec, or its plain fallback and the reason)."""
    plan = Planner.for_model(cfg, shape.batch, shape.seq,
                             mesh=production_mesh_spec(multi_pod=multi_pod),
                             residency=ResidencySpec.parse(residency))
    return kernelize_plan(plan, kernel) if kernel else plan


def run_one(arch: str, shape_name: str, multi_pod: bool, fsdp: bool,
            out_dir: str, verbose: bool = True, overrides: dict = None,
            tag_suffix: str = "", kernel: str = "plain",
            residency: str = "", plan_cache: str = "") -> dict:
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    spec = production_mesh_spec(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "fsdp": fsdp, "overrides": overrides or {},
           "status": "skipped"}

    # the plan is part of the record, with its single-device projection
    # beside it so the record replays on one card
    def _solve():
        return resolve_plan(cfg, shape, multi_pod, kernel, residency)

    if plan_cache:
        from repro_torch.exec.costmodel import hardware_fingerprint
        from repro_torch.exec.plancache import cached_plan
        plan, hit, _ = cached_plan(plan_cache, dict(
            mode="dryrun", arch=arch, shape=shape_name, mesh=mesh_name,
            kernel=kernel, residency=residency,
            overrides=overrides or {},
            fingerprint=hardware_fingerprint("cpu")), _solve)
        rec["plan_cache_hit"] = hit
    else:
        plan = _solve()
    rec["exec_plan"] = plan.to_dict()
    rec["exec_plan_per_device"] = plan.per_device().to_dict()
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec["reason"] = why
        if out_dir:
            _write(rec, out_dir, f"{arch}_{shape_name}_{mesh_name}")
        return rec
    t0 = time.time()
    try:
        mesh = join_fake_group(spec)
        try:
            fn, args = build_step(cfg, shape, mesh, fsdp=fsdp)
            traced = trace_step(fn, *args)
        finally:
            leave_fake_group()
        t_trace = time.time() - t0
        # traced peak bytes beside the plan's estimate: recorded in every
        # record (and emitted to the trace when an obs session is open),
        # never gated
        rec["plan_audit"] = plan_audit(
            plan, {k: traced[k] for k in _AUDIT_KEYS}, "dryrun",
            extra={"arch": arch, "shape": shape_name,
                   "mesh_name": mesh_name})
        if verbose:
            print(f"[{arch} x {shape_name} x {mesh_name}] trace: "
                  f"peak={traced['peak_bytes']} "
                  f"args={traced['argument_size_in_bytes']} "
                  f"temp={traced['temp_size_in_bytes']} "
                  f"flops={traced['flops']:.3e} "
                  f"bytes={traced['bytes_accessed']:.3e} "
                  f"coll={traced['collective_bytes']}")
        roof = analyze(traced, cfg, shape, mesh_name, spec.n_devices)
        rec.update({f"traced_{k}" if not k.startswith(
            ("arch", "shape", "mesh", "n_chips")) else k: v
            for k, v in roof.as_dict().items()})
        rec["traced_flops_by_op"] = traced["flops_by_op"]
        model = cost_analyze(cfg, shape, dict(zip(spec.axis_names,
                                                  spec.shape)))
        rec["analytic"] = model.as_dict()
        rec["bottleneck"] = model.bottleneck
        rec["status"] = "ok"
        rec["t_trace_s"] = round(t_trace, 2)
    except Exception as e:  # a failure here is a fault of the port
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    if out_dir:
        tag = f"{arch}_{shape_name}_{mesh_name}" \
            + ("_fsdp" if fsdp else "") + tag_suffix
        _write(rec, out_dir, tag)
    return rec


def _parse_overrides(pairs):
    out = {}
    for kv in pairs or []:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        out[k] = v
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--set", nargs="*", default=[],
                    help="config overrides, e.g. remat=block_rows "
                         "param_dtype=bfloat16 capacity_factor=1.0")
    ap.add_argument("--tag", default="", help="output filename suffix")
    ap.add_argument("--kernel", default="plain", choices=["plain", "cuda"],
                    help="kernel backend recorded on the exec plan (cuda "
                         "swaps in the kernel-backed engine when the "
                         "tiling is feasible)")
    ap.add_argument("--residency", default="",
                    choices=["", "device", "host", "recompute"],
                    help="boundary-cache residency policy recorded on "
                         "the exec plan (records replay it verbatim)")
    from repro_torch.exec.plancache import add_plan_cache_arg
    add_plan_cache_arg(ap)
    add_obs_args(ap)
    args = ap.parse_args(argv)
    overrides = _parse_overrides(args.set)
    configure_from_args(args, tool="dryrun", arch=args.arch,
                        shape=args.shape)

    archs = list_configs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    n_ok = n_err = n_skip = 0
    for arch in archs:
        for sh in shapes:
            for mp in meshes:
                t0 = time.time()
                rec = run_one(arch, sh, mp, args.fsdp, args.out,
                              overrides=overrides, tag_suffix=args.tag,
                              kernel=args.kernel,
                              residency=args.residency,
                              plan_cache=args.plan_cache)
                dt = time.time() - t0
                print(f"{rec['status']:8s} {arch:24s} {sh:12s} "
                      f"{rec['mesh']:8s} {dt:7.1f}s "
                      f"{rec.get('bottleneck', rec.get('reason', rec.get('error', '')))[:80]}",
                      flush=True)
                n_ok += rec["status"] == "ok"
                n_err += rec["status"] == "error"
                n_skip += rec["status"] == "skipped"
    print(f"done: {n_ok} ok, {n_skip} skipped (documented), {n_err} errors")
    obs.shutdown()
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
