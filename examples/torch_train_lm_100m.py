"""End-to-end driver on the port: train a ~100M-parameter LM for a few
hundred steps with the row-centric activation policy (sequence-chunked
remat + chunked CE head), on the synthetic pipeline, then save it.  (The
PyTorch counterpart of ``examples/train_lm_100m.py``.)

Default invocation trains a ~100M-param dense llama-family model (12
layers, d_model 640, a 50,304-token vocabulary) at seq 128 for 300 steps:

  PYTHONPATH=src python examples/torch_train_lm_100m.py             # card
  PYTHONPATH=src python examples/torch_train_lm_100m.py --steps 20 \\
      --device cpu                                                  # smoke

Any assigned arch works via --arch (at its full size, fp32, 4 row
chunks).
"""

import argparse
import dataclasses
import time

import torch

from repro_torch.ckpt import store
from repro_torch.data.pipeline import TokenDataset, TokenDatasetConfig
from repro_torch.launch.mesh import require_device
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import lm_batch
from repro_torch.models.lm import model as LM
from repro_torch.models.lm.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_leaves

# ~100M-param dense llama-family model (--arch xlstm_125m for the assigned
# SSM geometry)
DENSE_100M = ModelConfig(
    name="dense-100m", family="dense", n_layers=12, d_model=640,
    n_heads=10, n_kv_heads=5, d_ff=1792, vocab=50304,
    tie_embeddings=True, dtype="float32", row_chunks=4, remat="rows")
LR, LOG_EVERY = 1e-3, 20


def config(arch=None):
    if arch:
        from repro_torch.configs import get_config
        return dataclasses.replace(get_config(arch), dtype="float32",
                                   row_chunks=4)
    return DENSE_100M


def training(cfg, params, steps, batch, seq, device, lr=LR,
             log_every=LOG_EVERY):
    """AdamW steps of ``cfg`` from ``params`` (updated in place, as the
    reference's jitted step donates its state).  The loss is read from the
    device only on every ``log_every``-th step and the last, where it is
    printed.  Returns the state and the logged losses by step."""
    state = {"params": params, "opt": adamw_init(params)}
    step_fn = make_train_step(cfg, AdamWConfig(lr=lr))
    ds = TokenDataset(TokenDatasetConfig(vocab=cfg.vocab, seq_len=seq,
                                         batch=batch, seed=0, n_gram=1,
                                         noise_p=0.05))
    t0 = time.time()
    losses = {}
    for i in range(steps):
        state, m = step_fn(state, lm_batch(cfg, ds.batch_at(i), i, 0,
                                           device))
        if i % log_every == 0 or i == steps - 1:
            losses[i] = float(m["loss"])
            dt = time.time() - t0
            print(f"step {i:4d} loss {losses[i]:.4f} "
                  f"({dt:.0f}s, {dt / max(1, i + 1) * 1e3:.0f} ms/step)")
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--out", default="experiments/train_100m_torch")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default cuda; cpu runs "
                         "the same code on the host)")
    args = ap.parse_args(argv)
    device = require_device(args.device, "train on the host")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config(args.arch)
    params = LM.init_lm(torch.Generator(device=device).manual_seed(0), cfg)
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"arch={cfg.name} params={n / 1e6:.1f}M seq={args.seq} "
          f"batch={args.batch} steps={args.steps}")

    state, losses = training(cfg, params, args.steps, args.batch, args.seq,
                             device)
    first, final = losses[0], losses[args.steps - 1]
    print(f"loss {first:.3f} -> {final:.3f} "
          f"({'LEARNED' if final < first - 0.5 else 'check lr/steps'})")
    store.save(args.out, args.steps, state["params"],
               extra={"arch": cfg.name, "final_loss": final})
    print(f"checkpoint saved to {args.out}")
    print("train_lm_100m OK")


if __name__ == "__main__":
    main()
