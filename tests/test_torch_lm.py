"""The port's dense LM stack against the JAX package, on the CPU.

``get_reduced("gemma3_4b")`` (fp32, 3 layers: local, local, global;
window 16), batch 2, seq 64, with the reference's ``init_lm`` parameters
converted by ``params_from_reference``.  Primitives (``rms_norm``,
``rope``, ``_attend``, ``attn_train`` for local and global layers,
``mlp_apply``) are compared at 1e-5 relative; ``lm_loss`` and every
parameter gradient against ``repro.models.lm.model.lm_loss`` under
``jax.value_and_grad`` at 1e-5 relative for the loss and 1e-4 of each
leaf's max |grad|.  Chunk counts 1, 2, 4 and 8 put the chunk (64 to 8
tokens) above, at and below the 16-token window, and each runs three
ways: the config's own chunking, the ``seq_swa_overlap`` plan (the halo
loop) and the ``seq_swa_cuda`` plan (the kernel op, which takes its plain
version on CPU tensors).  ``repro.exec`` does not import under JAX 0.9, so
the reference side is the model code without a plan.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.models.lm import attention as ref_attn
from repro.models.lm import common as ref_common
from repro.models.lm import mlp as ref_mlp
from repro.models.lm import model as ref_model
from repro_torch.configs import get_reduced
from repro_torch.exec import Planner, build_apply
from repro_torch import obs
from repro_torch.kernels import ops
from repro_torch.models.lm import attention, common, mlp, model
from repro_torch.models.lm.blocks import attn_dims
from repro_torch.optim.adamw import tree_leaves

B, S = 2, 64
CHUNKS = [1, 2, 4, 8]


def _rel(want, got):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape, (want.shape, got.shape)
    return float(np.abs(want - got).max()) / max(
        float(np.abs(want).max()), 1e-30)


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale) \
        .astype(np.float32)


def test_config_is_the_references():
    ref, cfg = ref_get_reduced("gemma3_4b"), get_reduced("gemma3_4b")
    assert dataclasses.asdict(ref) == dataclasses.asdict(cfg)
    assert cfg.layer_kinds() == ["local", "local", "global"]
    assert cfg.scan_segments() == ref.scan_segments()


def test_rms_norm_and_rope():
    x = _np(0, B, S, 4, 64)
    scale = _np(1, 64, scale=0.1)
    assert _rel(ref_common.rms_norm(jnp.asarray(x), jnp.asarray(scale)),
                common.rms_norm(torch.tensor(x), torch.tensor(scale))) < 1e-5
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    for theta in (10_000.0, 1_000_000.0):
        assert _rel(ref_common.rope(jnp.asarray(x), jnp.asarray(pos), theta),
                    common.rope(torch.tensor(x), torch.tensor(pos), theta)) \
            < 1e-5


@pytest.mark.parametrize("window", [0, 16, 100])
def test_attend(window):
    q, k, v = _np(2, B, S, 4, 64), _np(3, B, S, 2, 64), _np(4, B, S, 2, 64)
    pos = np.arange(S, dtype=np.int32)
    want = ref_attn._attend(*(jnp.asarray(a) for a in (q, k, v, pos, pos)),
                            window, 2)
    got = attention._attend(*(torch.tensor(a) for a in (q, k, v)),
                            torch.arange(S), torch.arange(S), window, 2)
    assert _rel(want, got) < 1e-5


@functools.lru_cache(maxsize=None)
def _ref_params():
    cfg = ref_get_reduced("gemma3_4b")
    tree = ref_model.init_lm(jax.random.PRNGKey(0), cfg)
    return jax.tree.map(np.asarray, tree)


def _block_params(j):
    """Layer j of the reduced config's one segment (pattern local, local,
    global), as numpy."""
    return jax.tree.map(lambda a: a[0], _ref_params()["stack"]["segments"][0][j])


@pytest.mark.parametrize("n_chunks", CHUNKS)
@pytest.mark.parametrize("kind,j", [("local", 0), ("global", 2)])
def test_attn_train(kind, j, n_chunks):
    cfg = get_reduced("gemma3_4b")
    p = _block_params(j)["attn"]
    x = _np(5, B, S, cfg.d_model, scale=0.5)
    want = ref_attn.attn_train(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                               ref_attn.AttnDims(**dataclasses.asdict(
                                   attn_dims(cfg, kind))), n_chunks)
    got = attention.attn_train(model.params_from_reference(p, "cpu"),
                               torch.tensor(x), attn_dims(cfg, kind),
                               n_chunks)
    assert _rel(want, got.detach()) < 1e-5


@pytest.mark.parametrize("n_chunks", [1, 4])
def test_mlp_apply(n_chunks):
    p = _block_params(1)["mlp"]
    x = _np(6, B, S, 256, scale=0.5)
    want = ref_mlp.mlp_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                             n_chunks)
    got = mlp.mlp_apply(model.params_from_reference(p, "cpu"),
                        torch.tensor(x), n_chunks)
    assert _rel(want, got.detach()) < 1e-5


def _batch():
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 512, size=(B, S)).astype(np.int32)
    labels = rng.integers(0, 512, size=(B, S)).astype(np.int32)
    labels[:, -3:] = -1  # ignored positions
    return tokens, labels


@functools.lru_cache(maxsize=None)
def _ref_loss_grads(row_chunks):
    cfg = dataclasses.replace(ref_get_reduced("gemma3_4b"),
                              row_chunks=row_chunks)
    tokens, labels = _batch()
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    params = jax.tree.map(jnp.asarray, _ref_params())
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: ref_model.lm_loss(p, batch, cfg), has_aux=True))(params)
    return float(loss), float(aux["ce"]), \
        [np.asarray(g) for g in jax.tree.leaves(grads)]


@pytest.mark.parametrize("mode", ["config", "seq_swa_overlap",
                                  "seq_swa_cuda"])
@pytest.mark.parametrize("row_chunks", CHUNKS)
def test_lm_loss_and_grads(row_chunks, mode):
    want_loss, want_ce, want_grads = _ref_loss_grads(row_chunks)
    cfg = dataclasses.replace(get_reduced("gemma3_4b"),
                              row_chunks=row_chunks)
    if mode == "config":
        loss_fn = lambda p, b: model.lm_loss(p, b, cfg)  # noqa: E731
    else:
        plan = Planner.for_model(
            cfg, B, S, kernel="cuda" if mode == "seq_swa_cuda" else "plain")
        assert plan.engine == mode and plan.n_rows == row_chunks
        loss_fn = build_apply((None, cfg), plan)
    params = model.params_from_reference(_ref_params(), "cpu")
    leaves = tree_leaves(params)
    assert len(leaves) == len(want_grads)
    for t in leaves:
        t.requires_grad_()
    tokens, labels = _batch()
    with obs.profiling() as cap:
        loss, aux = loss_fn(params, {"tokens": torch.tensor(tokens),
                                     "labels": torch.tensor(labels)})
        grads = torch.autograd.grad(loss, leaves)
    # CPU tensors: no launch, no kernel range
    assert cap.count("swa_attention") == 0
    assert "swa_attention" not in {r.name for r in cap.records}
    assert abs(loss.item() - want_loss) / abs(want_loss) < 1e-5
    assert abs(aux["ce"].item() - want_ce) / abs(want_ce) < 1e-5
    for w, g in zip(want_grads, grads):
        assert _rel(w, g) < 1e-4


def test_params_tree_and_init_match_reference_layout():
    cfg = get_reduced("gemma3_4b")
    ours = model.init_lm(torch.Generator().manual_seed(0), cfg)
    ref = _ref_params()
    assert [tuple(t.shape) for t in tree_leaves(ours)] \
        == [a.shape for a in jax.tree.leaves(ref)]
    assert ours["stack"]["shared"] is None
    assert sum(t.numel() for t in tree_leaves(ours)) \
        == sum(a.size for a in jax.tree.leaves(ref))
    # 1/sqrt(fan_in) scaling as the reference's dense_init
    wq = ours["stack"]["segments"][0][0]["attn"]["wq"]
    assert abs(float(wq.std()) - 256 ** -0.5) < 0.01


def test_unported_families_raise():
    """Every LM arch of the reference now has its config and runs (the
    MoE, VLM and encoder-decoder families since the slice that ported
    them); an unknown arch still raises, and ``model.py`` refuses the
    encoder-decoder family, which runs through ``encdec.py``."""
    import repro_torch.configs as C
    from repro.configs import list_configs as ref_list
    for arch in ref_list():
        assert dataclasses.asdict(C.get_reduced(arch)) \
            == dataclasses.asdict(ref_get_reduced(arch))
    with pytest.raises(KeyError, match="unknown arch"):
        C.get_config("nope")
    for arch in ("deepseek_moe_16b", "llava_next_34b"):
        cfg = C.get_reduced(arch)
        assert model.family_fns(cfg).init is model.init_lm
        model.init_lm(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="encdec"):
        model.init_lm(torch.Generator(), C.get_reduced("seamless_m4t_medium"))


def test_seq_engine_forms():
    """Both forms of the seq engines: a chunk-body callable gives the
    ``core/seqrow.py`` apply of its shape (held against the reference's
    helpers in ``tests/test_torch_seqrow.py``), the LM form the stack's
    loss."""
    from repro_torch.exec import ExecutionPlan
    cfg = get_reduced("gemma3_4b")
    x = torch.tensor(_np(8, B, S, 16))
    chunked = build_apply(torch.tanh, ExecutionPlan.explicit("seq_chunked",
                                                            4))
    assert torch.equal(chunked(x), torch.tanh(x))
    attend = build_apply(lambda q, k, v, q_offset, k_offset: q,
                         ExecutionPlan.explicit("seq_swa_overlap", 2,
                                                window=16))
    q = x[..., None]
    assert torch.equal(attend(q, q, q), q)
    for name in ("seq_swa_overlap", "seq_swa_cuda"):
        with pytest.raises(ValueError, match="'window' extra"):
            build_apply((None, cfg), ExecutionPlan.explicit(name, 2))
    # the MoE family's LM form is its loss with the router's aux terms
    moe = get_reduced("deepseek_moe_16b")
    params = model.init_lm(torch.Generator().manual_seed(0), moe)
    tokens, labels = _batch()
    batch = {"tokens": torch.tensor(tokens) % moe.vocab,
             "labels": torch.tensor(labels) % moe.vocab}
    loss, aux = build_apply((None, moe), ExecutionPlan.explicit(
        "seq_chunked", 2))(params, batch)
    assert torch.isfinite(loss) and float(aux["load_balance"]) > 0


# ---------------------------------------------------------------------------
# the VLM frontend (reduced LLaVA-NeXT: 16 patch embeddings of width 1152
# before the text tokens)
# ---------------------------------------------------------------------------

VLM = "llava_next_34b"


@pytest.fixture
def one_cpu_thread():
    """One torch CPU thread: bit-reproducible reductions (the 1e-5
    gradient tests below)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel64(want, got):
    w = np.asarray(want, np.float64)
    g = got.detach().numpy().astype(np.float64) \
        if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    assert w.shape == g.shape, (w.shape, g.shape)
    return float(np.abs(w - g).max() / max(np.abs(w).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def _vlm_ref_params():
    tree = ref_model.init_lm(jax.random.PRNGKey(0), ref_get_reduced(VLM))
    return jax.tree.map(np.asarray, tree)


def _vlm_batch(S=16):
    cfg = get_reduced(VLM)
    rng = np.random.default_rng(12)
    pe = rng.standard_normal((B, cfg.n_frontend_tokens, cfg.frontend_dim)) \
        .astype(np.float32)
    tokens = rng.integers(0, 512, size=(B, S)).astype(np.int32)
    labels = rng.integers(0, 512, size=(B, S)).astype(np.int32)
    labels[:, -2:] = -1
    return pe, tokens, labels


def test_vlm_config_and_projector_layout():
    ref, cfg = ref_get_reduced(VLM), get_reduced(VLM)
    assert dataclasses.asdict(ref) == dataclasses.asdict(cfg)
    ours = model.init_lm(torch.Generator().manual_seed(0), cfg)
    assert [tuple(t.shape) for t in tree_leaves(ours)] \
        == [a.shape for a in jax.tree.leaves(_vlm_ref_params())]
    assert tuple(ours["projector"]["w1"].shape) == (1152, 256)
    assert tuple(ours["projector"]["w2"].shape) == (256, 256)


def test_vlm_embed_inputs_put_image_tokens_first():
    """The projector (two matmuls around the tanh GELU) and the order:
    image tokens, then text."""
    cfg = get_reduced(VLM)
    pe, tokens, _ = _vlm_batch()
    want = ref_model._embed_inputs(
        jax.tree.map(jnp.asarray, _vlm_ref_params()),
        {"tokens": jnp.asarray(tokens), "patch_embeds": jnp.asarray(pe)},
        ref_get_reduced(VLM), jnp.float32)
    got = model._embed_inputs(
        model.params_from_reference(_vlm_ref_params(), "cpu"),
        {"tokens": torch.tensor(tokens), "patch_embeds": torch.tensor(pe)},
        cfg, torch.float32)
    assert got.shape == (B, cfg.n_frontend_tokens + tokens.shape[1], 256)
    assert _rel64(want, got) < 1e-5


@pytest.mark.usefixtures("one_cpu_thread")
@pytest.mark.parametrize("S,row_chunks", [(16, 1), (16, 2), (15, 2)])
def test_vlm_loss_and_every_grad(S, row_chunks):
    """``lm_loss`` (image positions dropped before the chunked head) and
    every gradient leaf, the projector's included; at 16 + 15 positions
    the attention and MLP cannot chunk (31 % 2), as in the reference."""
    rcfg = dataclasses.replace(ref_get_reduced(VLM), row_chunks=row_chunks)
    cfg = dataclasses.replace(get_reduced(VLM), row_chunks=row_chunks)
    pe, tokens, labels = _vlm_batch(S)
    rb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
          "patch_embeds": jnp.asarray(pe)}
    (rl, raux), rg = jax.value_and_grad(
        lambda p: ref_model.lm_loss(p, rb, rcfg), has_aux=True)(
        jax.tree.map(jnp.asarray, _vlm_ref_params()))
    params = model.params_from_reference(_vlm_ref_params(), "cpu")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    loss, aux = model.lm_loss(params, {
        "tokens": torch.tensor(tokens), "labels": torch.tensor(labels),
        "patch_embeds": torch.tensor(pe)}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    assert _rel64(rl, loss) < 1e-5 and _rel64(raux["ce"], aux["ce"]) < 1e-5
    want = jax.tree.leaves(rg)
    assert len(want) == len(grads)
    bad = [(i, _rel64(a, b)) for i, (a, b) in enumerate(zip(want, grads))
           if not _rel64(a, b) < 1e-5]
    assert not bad, bad


@pytest.mark.usefixtures("one_cpu_thread")
def test_vlm_prefill_then_greedy_decode():
    """``lm_prefill`` with patch embeddings (the image tokens take cache
    positions 0-15), then six greedy decode steps: logits, caches and
    the token streams equal the reference's."""
    rcfg, cfg = ref_get_reduced(VLM), get_reduced(VLM)
    pe, tokens, _ = _vlm_batch(12)
    params = jax.tree.map(jnp.asarray, _vlm_ref_params())
    tp = model.params_from_reference(_vlm_ref_params(), "cpu")
    rl, rc = ref_model.lm_prefill(params, {"tokens": jnp.asarray(tokens),
                                           "patch_embeds": jnp.asarray(pe)},
                                  rcfg, 40)
    with torch.no_grad():
        lg, c = model.lm_prefill(tp, {"tokens": torch.tensor(tokens),
                                      "patch_embeds": torch.tensor(pe)},
                                 cfg, 40)
    assert _rel64(rl, lg) < 1e-5
    assert c[0][0]["pos"].tolist() == [[28, 28]] * 2  # 2 layers, 2 rows
    want, got = [], []
    rt = np.argmax(np.asarray(rl)[:, -1], -1).astype(np.int32)
    gt = torch.argmax(lg[:, -1], -1)
    for step in range(6):
        want.append(rt.tolist())
        got.append(gt.tolist())
        rl, rc = ref_model.lm_decode(params, jnp.asarray(rt[:, None]), rc,
                                     rcfg)
        with torch.no_grad():
            lg, c = model.lm_decode(tp, gt[:, None], c, cfg)
        assert _rel64(rl, lg) < 1e-5, step
        rt = np.argmax(np.asarray(rl)[:, -1], -1).astype(np.int32)
        gt = torch.argmax(lg[:, -1], -1)
    assert got == want
    for a, b in zip(jax.tree.leaves(rc), tree_leaves(c)):
        a = np.asarray(a)
        if a.dtype.kind in "biu":
            assert np.array_equal(a, b.numpy())
        else:
            assert _rel64(a, b) < 1e-5


@pytest.mark.usefixtures("one_cpu_thread")
def test_vlm_trainer_losses_equal_reference_loop(tmp_path):
    """``repro_torch.launch.train --arch llava_next_34b`` (batch 2, seq
    16, 3 steps, zero patch embeddings as the reference's trainer feeds)
    from the reference's parameters against the reference's ``lm_loss`` +
    ``adamw_update`` on the same batches; 1e-5 relative at step 0, times
    10 per step."""
    from repro.data.pipeline import TokenDataset as RefTokenDataset
    from repro.data.pipeline import TokenDatasetConfig as RefTokenConfig
    from repro.optim import adamw as ref_opt
    from repro_torch.launch import train as T
    rcfg = ref_get_reduced(VLM)
    opt_cfg = ref_opt.AdamWConfig(lr=3e-4)

    @jax.jit
    def step_fn(p, opt, b):
        (loss, _), g = jax.value_and_grad(
            lambda p: ref_model.lm_loss(p, b, rcfg), has_aux=True)(p)
        p, opt, _ = ref_opt.adamw_update(p, g, opt, opt_cfg)
        return p, opt, loss

    p = jax.tree.map(jnp.asarray, _vlm_ref_params())
    opt = ref_opt.adamw_init(p)
    ds = RefTokenDataset(RefTokenConfig(vocab=512, seq_len=16, batch=2))
    want = []
    for step in range(3):
        hb = ds.batch_at(step)
        p, opt, loss = step_fn(p, opt, {
            "tokens": jnp.asarray(hb["tokens"]),
            "labels": jnp.asarray(hb["labels"]),
            "patch_embeds": jnp.zeros((2, 16, 1152), jnp.float32)})
        want.append(float(loss))
    args = T.build_parser().parse_args(
        ["--arch", VLM, "--preset", "reduced", "--device", "cpu", "--batch",
         "2", "--seq", "16", "--steps", "3", "--log-every", "1", "--out",
         str(tmp_path)])
    recs = T.train_lm(args, params=model.params_from_reference(
        _vlm_ref_params(), "cpu"))
    got = [r["loss"] for r in recs]
    for step, (a, b) in enumerate(zip(want, got)):
        assert abs(a - b) / abs(a) < 1e-5 * 10 ** step, (step, want, got)
