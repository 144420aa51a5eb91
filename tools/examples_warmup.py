"""First use against warm runs of the port's serving and 100M examples, in
one process, on the card.

    PYTHONPATH=src python tools/examples_warmup.py

Serves ``examples/torch_serve_batched.py``'s traffic in its pool
``--runs`` times over the same parameters (each run's wall seconds and
tok/s: the first pays the process's first use of the card), then once
more under ``torch.profiler`` (kernel launches and their device-busy ms).
Then takes ``--lm-steps`` steps of ``examples/torch_train_lm_100m.py``'s
``dense-100m`` model (seq 128, batch 4), each synchronised and timed on
the host clock, one more under the profiler, and times the host's
synthetic batch.  Prints one JSON line with the card's name and power
limit.
"""

import argparse
import contextlib
import importlib.util
import io
import json
import pathlib
import subprocess
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _profiled(fn):
    """Kernel launches (copies and fills left out) of one call of ``fn``
    and the device ms they sum to."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches, busy_us = 0, 0.0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA \
                and not e.name().startswith(("Memcpy", "Memset")):
            launches += 1
            busy_us += (e.end_ns() - e.start_ns()) / 1e3
    return {"launches": launches, "busy_ms": busy_us / 1e3}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--lm-steps", type=int, default=25)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("examples_warmup: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}

    S = _example("torch_serve_batched")
    cfg = S.get_reduced(S.ARCH)
    params = S.LM.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    requests, budget = S.traffic(cfg)

    def serve():
        with contextlib.redirect_stdout(io.StringIO()):
            return S.serving(params, cfg, requests, budget)

    out["serve_runs"] = []
    for _ in range(args.runs):
        report, _, wall = serve()
        out["serve_runs"].append({
            "wall_s": wall,
            "tok_s": report.summary()["generated_tokens"] / wall,
            "decode_steps": report.n_decode_steps})
    out["serve_profiled"] = _profiled(serve)

    T = _example("torch_train_lm_100m")
    from repro_torch.data.pipeline import TokenDataset, TokenDatasetConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import lm_batch
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    cfg = T.config()
    params = T.LM.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    state = {"params": params, "opt": adamw_init(params)}
    step = make_train_step(cfg, AdamWConfig(lr=T.LR))
    ds = TokenDataset(TokenDatasetConfig(vocab=cfg.vocab, seq_len=128,
                                         batch=4, seed=0, n_gram=1,
                                         noise_p=0.05))
    out["lm_step_s"] = []
    for i in range(args.lm_steps):
        batch = lm_batch(cfg, ds.batch_at(i), i, 0, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        out["lm_step_s"].append(time.perf_counter() - t0)
    batch = lm_batch(cfg, ds.batch_at(args.lm_steps), args.lm_steps, 0,
                     "cuda")
    t0 = time.perf_counter()
    out["lm_profiled"] = _profiled(lambda: step(state, batch))
    out["lm_profiled"]["host_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(20):
        ds.batch_at(i)
    out["lm_host_batch_ms"] = (time.perf_counter() - t0) / 20 * 1e3
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
