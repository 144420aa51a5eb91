"""Production-mesh dry run + roofline for one (arch, shape), on the port.

Traces rank 0's sharded step of a 16x16 (or, with --multi-pod, 2x16x16)
mesh on ``meta`` tensors under torch's ``fake`` process group, and prints
the three roofline terms on one H100's constants and the rank's traced
bytes.  No card is needed.  (The full 10x4x2 sweep is ``python -m
repro_torch.launch.dryrun``; the PyTorch counterpart of
``examples/dryrun_roofline.py``.)

  PYTHONPATH=src python examples/torch_dryrun_roofline.py \
      --arch gemma3_4b --shape long_500k
  ... --set n_layers=2    (config overrides, as the dry run's --set)
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3_4b")
    ap.add_argument("--shape", default="long_500k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--set", nargs="*", default=[],
                    help="config overrides, e.g. n_layers=2")
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun import _parse_overrides, run_one
    rec = run_one(args.arch, args.shape, args.multi_pod, fsdp=False,
                  out_dir="", verbose=False,
                  overrides=_parse_overrides(args.set))
    if rec["status"] != "ok":
        print(rec.get("reason") or rec.get("error"))
        raise SystemExit(rec["status"] != "skipped")
    a = rec["analytic"]
    gib = 2**30
    print(f"{args.arch} x {args.shape} x {rec['mesh']} (H100 constants)")
    print(f"  t_compute    = {a['t_compute_s']*1e3:9.3f} ms")
    print(f"  t_memory     = {a['t_memory_s']*1e3:9.3f} ms")
    print(f"  t_collective = {a['t_collective_s']*1e3:9.3f} ms")
    print(f"  bottleneck   = {a['bottleneck']}")
    print(f"  traced per rank: peak {rec['traced_peak_bytes_per_chip']/gib:.2f}"
          f" GiB (args {rec['traced_arg_bytes_per_chip']/gib:.2f} GiB, "
          f"temp {rec['traced_temp_bytes_per_chip']/gib:.2f} GiB), "
          f"flops {rec['traced_flops_per_chip']:.3e}, collectives "
          f"{rec['traced_coll_bytes_per_chip']/gib:.2f} GiB")


if __name__ == "__main__":
    main()
