"""The readings the comparison's limits are set from, on the card at a
cell's own sizes (no window; the benchmark's runs do not run this):

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        --modes program,control,half [--out readings.jsonl]

For each seed: ``program`` takes the program's first three steps as a run
does and compares them with the reference's; ``control`` puts the
reference in the program's place at the precision below the
configuration's (TF32 on); ``half`` plants the half-batch fault
(harness/faults.py).  One JSON line a seed and mode, then the largest and
smallest reading of each number by mode."""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

from run import fixed_caches  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program,control,half")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    fixed_caches()
    import torch
    from harness import check, runner, spec
    from harness.faults import FAULTS

    cell = spec.cell(args.workload)
    device = torch.device("cuda")
    modes = args.modes.split(",")
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        readings = {}
        for mode in modes:
            if mode == "control":
                continue
            faults = () if mode == "program" else (FAULTS[mode],)
            job, batches, prog = runner.setup(cell, seed, device, faults)
            del job, batches
            gc.collect()
            # the program's blocks go back to the card before the next side
            torch.cuda.empty_cache()
            readings[mode] = prog
        _, batches = runner.inputs(cell, seed, device)
        ref = runner.reference(cell, seed, batches, device)
        if "control" in modes:
            readings["control"] = runner.reference(cell, seed, batches,
                                                   device, low="tf32")
        for mode, got in readings.items():
            values, where = check.gaps(got, ref)
            row = {"workload": cell.name, "seed": seed, "mode": mode,
                   "values": values, "where": where,
                   "correct": check.verdict(values, cell.limits),
                   "loss": got["loss"], "ref_loss": ref["loss"],
                   "s": round(time.time() - t0, 3)}
            rows.append(row)
            print(json.dumps(row), flush=True)
        del batches, ref, readings
        gc.collect()
        torch.cuda.empty_cache()
    summary = {}
    for mode in modes:
        got = [r["values"] for r in rows if r["mode"] == mode]
        summary[mode] = {k: [min(v[k] for v in got), max(v[k] for v in got)]
                         for k in got[0]}
    print(json.dumps({"workload": cell.name, "summary": summary}),
          flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
            f.write(json.dumps({"workload": cell.name,
                                "summary": summary}) + "\n")


if __name__ == "__main__":
    main()
