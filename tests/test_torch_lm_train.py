"""The port's LM trainer and token data against the JAX package.

``TokenDataset`` batches must be identical.  The trajectory test runs the
port's ``train_lm`` (reduced Gemma-3 preset, batch 2, seq 64,
``--device cpu``) from the reference's ``init_lm`` parameters against a
reference loop built from ``lm_loss`` + ``repro.optim.adamw.adamw_update``
on the same batches.  The loss tolerance grows with the step (fp32
differences compound through the updates): 1e-5 relative at step 0, times
10 per step.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.data.pipeline import TokenDataset as RefTokenDataset
from repro.data.pipeline import TokenDatasetConfig as RefTokenDatasetConfig
from repro.models.lm import model as ref_model
from repro.optim import adamw as ref_opt
from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import TokenDataset, TokenDatasetConfig
from repro_torch.launch import train as T
from repro_torch.models.lm.model import params_from_reference

BATCH, SEQ = 2, 64


@pytest.mark.parametrize("step", [0, 1, 9])
@pytest.mark.parametrize("vocab,seq,batch,seed", [(512, 64, 2, 0),
                                                  (262144, 33, 3, 7)])
def test_token_batches_identical(step, vocab, seq, batch, seed):
    kw = dict(vocab=vocab, seq_len=seq, batch=batch, seed=seed)
    a = RefTokenDataset(RefTokenDatasetConfig(**kw)).batch_at(step)
    b = TokenDataset(TokenDatasetConfig(**kw)).batch_at(step)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype


def _reference_losses(tree, steps):
    cfg = ref_get_reduced("gemma3_4b")
    opt_cfg = ref_opt.AdamWConfig(lr=3e-4)

    @jax.jit
    def step_fn(p, opt, batch):
        (loss, _), g = jax.value_and_grad(
            lambda p: ref_model.lm_loss(p, batch, cfg), has_aux=True)(p)
        p, opt, _ = ref_opt.adamw_update(p, g, opt, opt_cfg)
        return p, opt, loss

    params = jax.tree.map(jnp.asarray, tree)
    opt = ref_opt.adamw_init(params)
    ds = RefTokenDataset(RefTokenDatasetConfig(vocab=cfg.vocab, seq_len=SEQ,
                                               batch=BATCH, seed=0))
    losses = []
    for step in range(steps):
        hb = ds.batch_at(step)
        params, opt, loss = step_fn(params, opt,
                                    {k: jnp.asarray(hb[k])
                                     for k in ("tokens", "labels")})
        losses.append(float(loss))
    return losses


def _args(out, *extra):
    return T.build_parser().parse_args(
        ["--arch", "gemma3_4b", "--preset", "reduced", "--device", "cpu",
         "--batch", str(BATCH), "--seq", str(SEQ), "--log-every", "1",
         "--out", str(out), *extra])


@pytest.mark.parametrize("kernel", ["", "cuda"])
def test_three_step_trajectory_matches_reference(tmp_path, kernel):
    cfg = ref_get_reduced("gemma3_4b")
    tree = jax.tree.map(np.asarray,
                        ref_model.init_lm(jax.random.PRNGKey(1), cfg))
    want = _reference_losses(tree, 3)
    extra = ("--kernel", kernel) if kernel else ()
    recs = T.train_lm(_args(tmp_path, "--steps", "3", *extra),
                      params=params_from_reference(tree, "cpu"))
    got = [r["loss"] for r in recs]
    assert [r["step"] for r in recs] == [0, 1, 2]
    for step, (a, b) in enumerate(zip(want, got)):
        assert abs(a - b) / abs(a) < 1e-5 * 10 ** step, (step, want, got)
    log = json.load(open(os.path.join(tmp_path, "train_log.json")))
    assert log["schema"] == 1 and log["mode"] == "lm"
    assert [s["loss"] for s in log["steps"]] == got
    if kernel:
        assert log["plan"]["engine"] == "seq_swa_cuda"
        assert log["plan"]["kernel"]["backend"] == "cuda"
        assert "kernel_fallback" not in log["plan"]["extras"]
    else:
        assert log["plan"] is None


def test_cli_plain_kernel_keeps_the_halo_loop(tmp_path):
    recs = T.main(["--arch", "gemma3_4b", "--preset", "reduced", "--device",
                   "cpu", "--batch", "2", "--seq", "64", "--steps", "1",
                   "--kernel", "plain", "--out", str(tmp_path)])
    assert np.isfinite(recs[0]["loss"])
    plan = json.load(open(tmp_path / "train_log.json"))["plan"]
    assert plan["engine"] == "seq_swa_overlap"
    assert plan["kernel"]["backend"] == "plain" and plan["n_rows"] == 2


def test_unported_lm_archs_and_flags_raise(tmp_path):
    """The MoE, VLM and encoder-decoder archs train since the slice that
    ported them (one step each, finite; their parity with the reference
    trainer is in ``tests/test_torch_{moe,encdec,lm}.py``); ``--mesh``
    in one process raises, pointing at the plan's per-device projection,
    as the CNN trainer does (a group of ranks trains:
    ``tests/test_torch_lm_sharding.py``; ``--budget-gb`` and
    ``--residency`` run on the LM path since the SSM slice:
    ``tests/test_torch_seqrow.py``)."""
    for arch in ("deepseek_moe_16b", "llava_next_34b",
                 "seamless_m4t_medium"):
        args = _args(tmp_path, "--steps", "1")
        args.arch = arch
        recs = T.train_lm(args)
        assert len(recs) == 1 and np.isfinite(recs[0]["loss"])
        log = json.load(open(os.path.join(tmp_path, "train_log.json")))
        assert log["arch"] == get_reduced(arch).name
    with pytest.raises(ValueError, match=r"needs 2 devices .*per_device"):
        T.train_lm(_args(tmp_path, "--steps", "1", "--mesh", "data=2"))


def test_lm_cuda_device_without_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _args(tmp_path, "--steps", "1")
    args.device = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.train_lm(args)
