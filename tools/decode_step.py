"""Time the PyTorch port's whole-pool decode step, one process, on the card.

A ``full`` pool of ``--slots`` slots at the config's published widths
(``--layers`` cuts the depth), every slot holding the same prefilled
``--prompt-len``-token prompt, and ``ServeEngine.decode_step`` over all of
them, timed on the host clock around a synchronised step, as
``chip_smoke.py``'s serve phase times it, with more repeats:

    PYTHONPATH=src python tools/decode_step.py --arch gemma3_4b --slots 14

Prints one JSON line: the median ms, every step's ms, one more step under
``torch.profiler`` (kernel launches, device-busy ms, and the CUDA runtime
calls by name with their counts: a synchronising call shows there), and
the card's name and power limit.  The script uses only ``repro_torch``
APIs that every tree since serving was ported has, so pointing
``PYTHONPATH`` at another
checkout's ``src`` times that tree's port; compare two trees only within
one run on one card, interleaved (A, B, B, A).
"""

import argparse
import dataclasses
import json
import subprocess
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma3_4b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--slots", type=int, default=14)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--steps", type=int, default=21)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_step: needs a CUDA device")

    from repro_torch.configs import get_config
    from repro_torch.exec import Planner
    from repro_torch.models.lm.model import init_lm
    from repro_torch.serve import ServeEngine, make_pool, make_requests
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    plan = Planner.for_serve(cfg, args.prompt_len + args.gen,
                             n_slots=args.slots)
    engine = ServeEngine(params, cfg, plan)
    req, = make_requests(1, cfg.vocab, seed=0, prompt_len=args.prompt_len,
                         max_new_tokens=args.gen)
    _, cache, _ = engine.prefill(req)
    pool = make_pool(cfg, plan, device="cuda")
    for slot in range(plan.n_rows):
        pool.acquire(slot, req.prompt_len)
        pool.write(slot, cache)
    del cache
    view = pool.decode_view()
    tokens = [int(t) for t in req.prompt[:plan.n_rows]]
    engine.decode_step(tokens, view)          # warm
    ms = []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.decode_step(tokens, view)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.decode_step(tokens, view)
        torch.cuda.synchronize()
    launches, busy_us, runtime = 0, 0.0, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.name().startswith(("Memcpy", "Memset")):
                launches += 1
            busy_us += (e.end_ns() - e.start_ns()) / 1e3
        elif e.name().startswith("cuda"):
            runtime[e.name()] = runtime.get(e.name(), 0) + 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"tag": args.tag, "arch": args.arch,
                      "layers": cfg.n_layers, "slots": plan.n_rows,
                      "median_ms": sorted(ms)[len(ms) // 2], "ms": ms,
                      "launches": launches, "busy_ms": busy_us / 1e3,
                      "runtime_calls": runtime,
                      "card": smi.strip()}), flush=True)


if __name__ == "__main__":
    main()
