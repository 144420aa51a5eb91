"""How fast the dry run traces one (arch, shape) step, at cut sequence
lengths, and the time it would take at the shape's own.

For each ``--seq`` the step of rank 0 of the production mesh is built as
the dry run builds it (``fake`` process group, ``meta`` tensors) with the
shape's sequence cut to that length, run once bare (no dispatch mode: the
floor any tracer pays) and once under ``obs.audit.trace_step``.  It prints
one JSON line per length (seconds, the rank's tokens per second traced)
and, from a straight line through the traced times, the projected time at
the shape's full length (a per-token loop, as xLSTM's sLSTM runs, costs
the same per token at every length).  No card is needed.

  PYTHONPATH=src python tools/trace_rate.py --arch xlstm_125m \
      --shape train_4k --seq 256 512
"""

import argparse
import dataclasses
import json
import time

import torch


def _timed(cfg, shape, multi_pod: bool, traced: bool):
    """``(seconds, the rank's batch rows)`` of one run of the step."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch.steps import build_step
    from repro_torch.obs.audit import trace_step
    mesh = M.join_fake_group(M.production_mesh_spec(multi_pod=multi_pod))
    try:
        fn, args = build_step(cfg, shape, mesh)
        rows = args[-1]["tokens"].shape[0]
        t0 = time.perf_counter()
        if traced:
            trace_step(fn, *args)
        else:
            fn(*args)
        return time.perf_counter() - t0, rows
    finally:
        M.leave_fake_group()


def main(argv=None):
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import SHAPES
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm_125m")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--seq", type=int, nargs="+", default=[256, 512])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-bare", action="store_true",
                    help="skip the bare run (the tracer's time only)")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    cfg = get_config(args.arch)
    full = SHAPES[args.shape]
    points = []
    for seq in args.seq:
        shape = dataclasses.replace(full, seq=seq)
        bare = None if args.no_bare \
            else _timed(cfg, shape, args.multi_pod, False)[0]
        traced, rows = _timed(cfg, shape, args.multi_pod, True)
        tokens = rows * (seq if full.kind != "decode" else 1)
        points.append((seq, traced))
        print(json.dumps({"arch": args.arch, "shape": args.shape,
                          "seq": seq, "rows_per_rank": rows,
                          "bare_s": bare, "traced_s": traced,
                          "tracer_over_bare": traced / bare if bare
                          else None,
                          "traced_tokens_per_s": tokens / traced}),
              flush=True)
    if len(points) >= 2:
        (s0, t0), (s1, t1) = points[0], points[-1]
        slope = (t1 - t0) / (s1 - s0)
        print(json.dumps({"arch": args.arch, "shape": args.shape,
                          "full_seq": full.seq,
                          "traced_s_per_token_per_rank": slope / rows,
                          "projected_traced_s": t1 + slope * (full.seq - s1)}),
              flush=True)


if __name__ == "__main__":
    main()
