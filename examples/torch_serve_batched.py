"""Continuous-batching serving on the port: Poisson traffic with mixed
prompt lengths through a reduced gemma3-family model (sliding-window local
+ global layers), scheduled by ``repro_torch.serve`` — requests borrow
decode slots from a budget-sized cache pool (ring buffers for local
layers, full KV for global layers) and freed slots are refilled on the
fly.  (The PyTorch counterpart of ``examples/serve_batched.py``.)

  PYTHONPATH=src python examples/torch_serve_batched.py              # card
  PYTHONPATH=src python examples/torch_serve_batched.py --device cpu
"""

import argparse
import time

import torch

from repro_torch.configs import get_reduced
from repro_torch.exec import Planner
from repro_torch.launch.mesh import require_device
from repro_torch.models.lm import model as LM
from repro_torch.serve import make_requests, serve

N_REQUESTS, GEN = 8, (8, 24)
ARCH = "gemma3_4b"


def traffic(cfg):
    """The requests, and a budget worth ~3 slots: later arrivals queue
    until a slot frees up."""
    requests = make_requests(N_REQUESTS, cfg.vocab, seed=0,
                             traffic="poisson", prompt_len=(16, 32, 48),
                             max_new_tokens=GEN, mean_interarrival=2.0)
    max_len = max(r.prompt_len + r.max_new_tokens for r in requests)
    budget = int(3.5 * Planner.decode_slot_bytes(cfg, max_len))
    return requests, budget


def serving(params, cfg, requests, budget):
    """Serve ``requests`` in a ``budget``-sized pool and print the run;
    returns ``(report, plan, wall seconds)``.  Every tick reads its greedy
    tokens back to the host, which waits for the card, so the wall clock
    covers the device's work and the printed tok/s is the real rate."""
    t0 = time.perf_counter()
    report, plan = serve(params, cfg, requests, budget=budget,
                         walltime_fn=time.perf_counter)
    wall = time.perf_counter() - t0

    print("pool plan:", plan.describe())
    s = report.summary()
    print(f"served {s['requests']} requests / {s['generated_tokens']} "
          f"tokens in {wall:.2f}s ({s['generated_tokens'] / wall:.1f} "
          f"tok/s); max {s['max_active']} concurrent, "
          f"{s['decode_steps']} decode steps")
    for st in report.states:
        print(f"  request {st.rid}: arrival={st.request.arrival:5.1f} "
              f"prompt={st.request.prompt_len:3d} slot={st.slot} "
              f"tokens={st.generated[:10]}")
    reused = {i: h for i, h in report.slot_history.items() if len(h) > 1}
    print(f"slot reuse: {reused} (continuous batching refills freed rows)")
    if not all(st.done for st in report.states):
        raise AssertionError("a request did not finish")
    return report, plan, wall


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where parameters, the pool and decode live "
                         "(default cuda; cpu runs the same code on the "
                         "host)")
    args = ap.parse_args(argv)
    device = require_device(args.device, "serve on the host")
    cfg = get_reduced(ARCH)
    print(f"arch={cfg.name} layers={cfg.layer_kinds()} "
          f"window={cfg.sliding_window}")
    params = LM.init_lm(torch.Generator(device=device).manual_seed(0), cfg)
    requests, budget = traffic(cfg)
    serving(params, cfg, requests, budget)
    print("serve_batched OK")


if __name__ == "__main__":
    main()
