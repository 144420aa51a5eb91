"""The port's MoE family against the JAX package, on the CPU: ``moe.py``
(``_capacity``, the routing integers, ``moe_apply``'s output, aux terms
and gradients), the ``moe`` block's training, prefill and decode halves,
and the reduced DeepSeek-MoE and Qwen3-MoE models' loss with every
gradient leaf, prefill-then-decode greedy streams and trainer losses.

Inputs come from numpy with a seed; parameters are the reference's
``init_*`` trees converted by ``params_from_reference``.  fp32 with one
torch thread: each output and each gradient leaf within 1e-5 of its own
largest reference magnitude (max |diff| / max |reference|); the routing
integers (top-k indices, kept mask, queue ranks) equal.  The reference's
``moe_apply`` keeps its routing inside, so its integers are recomputed
here with the reference's own lines (``src/repro/models/lm/moe.py:61-80``)
on the reference's router probabilities.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.configs import qwen3_moe_235b_a22b as ref_qwen3
from repro.models.lm import blocks as ref_blocks
from repro.models.lm import model as ref_model
from repro.models.lm import moe as ref_moe
from repro.optim import adamw as ref_opt
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs import qwen3_moe_235b_a22b as qwen3
from repro_torch.models.lm import blocks, model, moe
from repro_torch.optim.adamw import tree_leaves

TOL = 1e-5
ARCHS = ["deepseek_moe_16b", "qwen3_moe_235b_a22b"]


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """One torch CPU thread: bit-reproducible reductions, and no stall
    beside other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel(want, got) -> float:
    w = np.asarray(want, np.float64)
    g = got.detach().cpu().numpy().astype(np.float64) \
        if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    assert w.shape == g.shape, (w.shape, g.shape)
    return float(np.abs(w - g).max() / max(np.abs(w).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def _dims(arch, **over):
    rd = ref_blocks.moe_dims(ref_get_reduced(arch))
    return dataclasses.replace(rd, **over), \
        dataclasses.replace(blocks.moe_dims(get_reduced(arch)), **over)


def _ref_routing(params, x, dims):
    """The reference's routing integers for ``x`` (its lines 61-80)."""
    B, S, d = x.shape
    sg = dims.seq_groups if S % dims.seq_groups == 0 else 1
    G, t = B * sg, S // sg
    xt = jnp.asarray(x).reshape(G, t, d)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ params["router"], -1)
    C = ref_moe._capacity(t, dims)
    k, E = dims.top_k, dims.n_experts
    _, topi = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(topi, E, dtype=jnp.float32)
    pos = jnp.cumsum(onehot.reshape(G, t * k, E), axis=1) \
        .reshape(G, t, k, E)
    pos = (pos - 1.0) * onehot
    keep = (pos < C) & (onehot > 0)
    return np.asarray(probs), C, np.asarray(topi), np.asarray(keep), \
        np.asarray(pos).astype(np.int64)


def test_configs_are_the_references():
    for arch in ARCHS:
        assert dataclasses.asdict(get_reduced(arch)) \
            == dataclasses.asdict(ref_get_reduced(arch))
    assert dataclasses.asdict(get_config("qwen3_moe_235b_a22b")) \
        == dataclasses.asdict(ref_qwen3.CONFIG)
    assert dataclasses.asdict(qwen3.OPTIMIZED) \
        == dataclasses.asdict(ref_qwen3.OPTIMIZED)
    cfg = get_config("deepseek_moe_16b")
    assert cfg.layer_kinds() == ["moe"] * 28
    assert (cfg.n_experts, cfg.top_k, cfg.n_shared_experts) == (64, 6, 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_equals_reference(arch):
    for factor in (0.25, 1.0, 1.25, 2.0):
        rd, d = _dims(arch, capacity_factor=factor)
        for t in (1, 2, 3, 7, 16, 33, 512, 1024, 4096):
            assert moe._capacity(t, d) == ref_moe._capacity(t, rd)
    full = blocks.moe_dims(get_config(arch))
    # decode always gets the floor of 4
    assert moe._capacity(1, full) == 4
    assert moe._capacity(1024, full) == {"deepseek_moe_16b": 120,
                                         "qwen3_moe_235b_a22b": 80}[arch]


#: (name, batch, seq, dims overrides): with drops, decode (S = 1), a
#: length that is not a multiple of seq_groups, and the config's own
ROUTING_CASES = [("drops", 2, 32, dict(capacity_factor=0.25)),
                 ("decode", 3, 1, {}),
                 ("odd_len", 2, 13, {}),
                 ("config", 2, 24, {})]


@functools.lru_cache(maxsize=None)
def _moe_params(arch):
    rcfg = ref_get_reduced(arch)
    p = ref_moe.init_moe(jax.random.PRNGKey(3), ref_blocks.moe_dims(rcfg),
                         "float32")
    return jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name,B,S,over", ROUTING_CASES)
def test_routing_integers_equal_reference(arch, name, B, S, over):
    rd, d = _dims(arch, **over)
    p = _moe_params(arch)
    x = _np(1, B, S, rd.d)
    probs, C, topi, keep, pos = _ref_routing(p, x, rd)
    sg = d.seq_groups if S % d.seq_groups == 0 else 1
    if name in ("decode", "odd_len"):
        assert sg == 1
    if name == "decode":
        assert C == 4
    tp = model.params_from_reference(p, "cpu")
    got_probs = torch.softmax(
        _t(x).reshape(B * sg, S // sg, -1) @ tp["router"], -1)
    assert _rel(probs, got_probs) <= TOL
    r = moe.route(got_probs, d, moe._capacity(S // sg, d))
    assert np.array_equal(r["topi"].numpy(), topi)
    assert np.array_equal(r["keep"].numpy(), keep)
    assert np.array_equal(r["pos"].numpy().astype(np.int64), pos)
    if name == "drops":
        chosen = r["onehot"] > 0
        assert (chosen & ~r["keep"]).any(), "no choice was dropped"


def test_routing_ties_take_the_lower_index():
    """Equal router probabilities: the reference's ``lax.top_k`` takes the
    lower expert index first, and so does the port (a stable sort)."""
    rd, d = _dims("qwen3_moe_235b_a22b")
    p = dict(_moe_params("qwen3_moe_235b_a22b"))
    router = np.array(p["router"])
    router[:, 2] = router[:, 1]           # experts 1 and 2 always tie
    for r in (router, np.zeros_like(router)):   # and then every expert
        p["router"] = r
        x = _np(2, 2, 16, rd.d)
        probs, C, topi, keep, pos = _ref_routing(p, x, rd)
        got = moe.route(_t(probs), d, C)
        assert np.array_equal(got["topi"].numpy(), topi)
        assert np.array_equal(got["pos"].numpy().astype(np.int64), pos)
    assert (topi == np.arange(rd.top_k)).all()   # all tied: 0, 1, ...


@pytest.mark.parametrize("n_chunks", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name,B,S,over", ROUTING_CASES)
def test_moe_apply_values_aux_and_grads(arch, name, B, S, over, n_chunks):
    """Output, both aux terms and the gradients of a scalar of all three
    with respect to every parameter and the input."""
    rd, d = _dims(arch, **over)
    p = _moe_params(arch)
    x = _np(4, B, S, rd.d)
    w = _np(5, B, S, rd.d)

    def ref_obj(p, x):
        y, aux = ref_moe.moe_apply(p, x, rd, n_chunks)
        return jnp.sum(y * w) + aux["load_balance"] + aux["z_loss"], \
            (y, aux)

    (_, (ry, raux)), (rgp, rgx) = jax.value_and_grad(
        ref_obj, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = model.params_from_reference(p, "cpu")
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_()
    tx = _t(x).requires_grad_()
    y, aux = moe.moe_apply(tp, tx, d, n_chunks)
    obj = torch.sum(y * _t(w)) + aux["load_balance"] + aux["z_loss"]
    grads = torch.autograd.grad(obj, leaves + [tx])
    assert _rel(ry, y) <= TOL
    for k in ("load_balance", "z_loss"):
        assert _rel(raux[k], aux[k]) <= TOL, k
    want = jax.tree.leaves(rgp) + [rgx]
    assert len(want) == len(grads)
    for i, (a, b) in enumerate(zip(want, grads)):
        assert _rel(a, b) <= TOL, (i, _rel(a, b))


@functools.lru_cache(maxsize=None)
def _block_params(arch):
    rcfg = ref_get_reduced(arch)
    return jax.tree.map(np.asarray, ref_blocks.init_block(
        jax.random.PRNGKey(6), "moe", rcfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_train_equals_reference(arch):
    rcfg, cfg = ref_get_reduced(arch), get_reduced(arch)
    p = _block_params(arch)
    x = _np(7, 2, 16, rcfg.d_model)
    rx, raux = ref_blocks.block_train(jax.tree.map(jnp.asarray, p),
                                      jnp.asarray(x), "moe", rcfg)
    y, aux = blocks.block_train(model.params_from_reference(p, "cpu"),
                                _t(x), "moe", cfg)
    assert _rel(rx, y) <= TOL
    for k in ("load_balance", "z_loss"):
        assert _rel(raux[k], aux[k]) <= TOL
        assert float(aux[k]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_prefill_then_decode_equals_reference(arch):
    """``block_prefill`` of 20 tokens into a 24-position cache, then three
    ``block_decode`` steps (S = 1: one group, capacity 4)."""
    from repro_torch.optim.adamw import tree_leaves as leaves_of
    rcfg, cfg = ref_get_reduced(arch), get_reduced(arch)
    p = _block_params(arch)
    tp = model.params_from_reference(p, "cpu")
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 20, rcfg.d_model)).astype(np.float32)
    rx, rc = ref_blocks.block_prefill(jax.tree.map(jnp.asarray, p),
                                      jnp.asarray(x), "moe", rcfg, 24,
                                      jnp.float32)
    y, c = blocks.block_prefill(tp, _t(x), "moe", cfg, 24, torch.float32)

    def same_tree(want, got):
        for a, b in zip(jax.tree.leaves(want), leaves_of(got)):
            a = np.asarray(a)
            if a.dtype.kind in "biu":
                assert np.array_equal(a, b.numpy())
            else:
                assert _rel(a, b) <= TOL
    assert _rel(rx, y) <= TOL
    same_tree(rc, c)
    for step in range(3):
        xt = rng.standard_normal((2, 1, rcfg.d_model)).astype(np.float32)
        rx, rc = ref_blocks.block_decode(jax.tree.map(jnp.asarray, p),
                                         jnp.asarray(xt), rc, "moe", rcfg)
        with torch.no_grad():
            y, c = blocks.block_decode(tp, _t(xt), c, "moe", cfg)
        assert _rel(rx, y) <= TOL, step
        same_tree(rc, c)
    same_tree(ref_blocks.init_block_cache("moe", rcfg, 3, 24, jnp.float32),
              blocks.init_block_cache("moe", cfg, 3, 24, torch.float32))


# ---------------------------------------------------------------------------
# whole reduced models
# ---------------------------------------------------------------------------

B, S = 2, 32


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jax.tree.map(np.asarray, ref_model.init_lm(
        jax.random.PRNGKey(0), ref_get_reduced(arch)))


def _batch():
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, 512, size=(B, S)).astype(np.int32)
    labels = rng.integers(0, 512, size=(B, S)).astype(np.int32)
    labels[:, -3:] = -1
    return tokens, labels


@pytest.mark.parametrize("row_chunks", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_aux_and_every_grad(arch, row_chunks):
    rcfg = dataclasses.replace(ref_get_reduced(arch), row_chunks=row_chunks)
    cfg = dataclasses.replace(get_reduced(arch), row_chunks=row_chunks)
    tokens, labels = _batch()
    (rl, raux), rg = jax.value_and_grad(
        lambda p: ref_model.lm_loss(p, {"tokens": jnp.asarray(tokens),
                                        "labels": jnp.asarray(labels)},
                                    rcfg), has_aux=True)(
        jax.tree.map(jnp.asarray, _ref_params(arch)))
    params = model.params_from_reference(_ref_params(arch), "cpu")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    loss, aux = model.lm_loss(params, {"tokens": _t(tokens),
                                       "labels": _t(labels)}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    assert _rel(rl, loss) <= TOL
    for k in ("ce", "load_balance", "z_loss"):
        assert _rel(raux[k], aux[k]) <= TOL, k
    want = jax.tree.leaves(rg)
    assert len(want) == len(grads)
    bad = [(i, _rel(a, b)) for i, (a, b) in enumerate(zip(want, grads))
           if not _rel(a, b) <= TOL]
    assert not bad, bad


@pytest.mark.parametrize("arch", ARCHS)
def test_params_tree_matches_reference_layout(arch):
    ours = model.init_lm(torch.Generator().manual_seed(0), get_reduced(arch))
    ref = _ref_params(arch)
    assert [tuple(t.shape) for t in tree_leaves(ours)] \
        == [a.shape for a in jax.tree.leaves(ref)]
    assert [t.dtype for t in tree_leaves(ours)] \
        == [torch.float32] * len(jax.tree.leaves(ref))
    router = ours["stack"]["segments"][0][0]["moe"]["router"]
    assert abs(float(router.std()) - 0.02) < 0.005


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_greedy_decode_equals_reference(arch):
    """``lm_prefill`` of a batch of 2 prompts (20 tokens: one routing
    group per row), then six greedy ``lm_decode`` steps: logits, every
    cache leaf and the token streams."""
    rcfg, cfg = ref_get_reduced(arch), get_reduced(arch)
    params = jax.tree.map(jnp.asarray, _ref_params(arch))
    tp = model.params_from_reference(_ref_params(arch), "cpu")
    toks = np.random.default_rng(10).integers(0, 512, (2, 20)) \
        .astype(np.int32)
    rl, rc = ref_model.lm_prefill(params, {"tokens": jnp.asarray(toks)},
                                  rcfg, 28)
    with torch.no_grad():
        lg, c = model.lm_prefill(tp, {"tokens": _t(toks)}, cfg, 28)
    assert _rel(rl, lg) <= TOL
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
        assert _rel(rl, lg) <= TOL, step
        rt = np.argmax(np.asarray(rl)[:, -1], -1).astype(np.int32)
        gt = torch.argmax(lg[:, -1], -1)
    assert got == want
    for a, b in zip(jax.tree.leaves(rc), tree_leaves(c)):
        a = np.asarray(a)
        if a.dtype.kind in "biu":
            assert np.array_equal(a, b.numpy())
        else:
            assert _rel(a, b) <= TOL


def _reference_losses(arch, tree, steps, seq, batch):
    from repro.data.pipeline import TokenDataset, TokenDatasetConfig
    cfg = ref_get_reduced(arch)
    opt_cfg = ref_opt.AdamWConfig(lr=3e-4)

    @jax.jit
    def step_fn(p, opt, b):
        (loss, _), g = jax.value_and_grad(
            lambda p: ref_model.lm_loss(p, b, cfg), has_aux=True)(p)
        p, opt, _ = ref_opt.adamw_update(p, g, opt, opt_cfg)
        return p, opt, loss

    params = jax.tree.map(jnp.asarray, tree)
    opt = ref_opt.adamw_init(params)
    ds = TokenDataset(TokenDatasetConfig(vocab=cfg.vocab, seq_len=seq,
                                         batch=batch, seed=0))
    losses = []
    for step in range(steps):
        hb = ds.batch_at(step)
        params, opt, loss = step_fn(params, opt, {
            k: jnp.asarray(hb[k]) for k in ("tokens", "labels")})
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_losses_equal_reference_loop(tmp_path, arch):
    """``repro_torch.launch.train`` at the reduced preset (batch 2, seq
    32, 3 steps) from the reference's parameters against the reference's
    ``lm_loss`` + ``adamw_update`` on the same batches; 1e-5 relative at
    step 0, times 10 per step (fp32 differences compound through the
    updates)."""
    from repro_torch.launch import train as T
    tree = _ref_params(arch)
    want = _reference_losses(arch, tree, 3, 32, 2)
    args = T.build_parser().parse_args(
        ["--arch", arch, "--preset", "reduced", "--device", "cpu",
         "--batch", "2", "--seq", "32", "--steps", "3", "--log-every", "1",
         "--out", str(tmp_path)])
    recs = T.train_lm(args, params=model.params_from_reference(tree, "cpu"))
    got = [r["loss"] for r in recs]
    for step, (a, b) in enumerate(zip(want, got)):
        assert abs(a - b) / abs(a) < 1e-5 * 10 ** step, (step, want, got)
    assert all(r["load_balance"] > 0 and r["z_loss"] > 0 for r in recs)
