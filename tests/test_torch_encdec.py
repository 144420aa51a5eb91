"""The port's encoder-decoder family against the JAX package, on the CPU:
``attn_bidir`` (chunked and not), ``cross_kv`` and ``attn_cross``,
``encode``, ``encdec_loss`` with every gradient leaf, the prefill and its
greedy decode, the decode caches and pool, and the trainer — the reduced
SeamlessM4T-medium preset (2 + 2 layers, d 128).

Inputs come from numpy with a seed; parameters are the reference's
``init_*`` trees converted by ``params_from_reference``.  fp32 with one
torch thread: each output and each gradient leaf within 1e-5 of its own
largest reference magnitude (max |diff| / max |reference|); greedy token
streams and integer cache leaves equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced as ref_get_reduced
from repro.models.lm import attention as ref_attn
from repro.models.lm import encdec as ref_ed
from repro.optim import adamw as ref_opt
from repro_torch.configs import get_config, get_reduced
from repro_torch.exec import Planner
from repro_torch.models.lm import attention, encdec, model
from repro_torch.optim.adamw import tree_leaves

TOL = 1e-5
ARCH = "seamless_m4t_medium"


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
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


def _assert_tree(want, got, what=""):
    wl, gl = jax.tree.leaves(want), tree_leaves(got)
    assert len(wl) == len(gl), what
    for i, (w, g) in enumerate(zip(wl, gl)):
        w = np.asarray(w)
        assert tuple(w.shape) == tuple(g.shape), (what, i)
        if w.dtype.kind in "biu":
            assert np.array_equal(w, g.cpu().numpy()), (what, i)
        else:
            assert _rel(w, g) <= TOL, (what, i, _rel(w, g))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def test_config_is_the_references():
    assert dataclasses.asdict(get_reduced(ARCH)) \
        == dataclasses.asdict(ref_get_reduced(ARCH))
    assert dataclasses.asdict(get_config(ARCH)) \
        == dataclasses.asdict(ref_get_config(ARCH))


# ---------------------------------------------------------------------------
# attention: bidirectional and cross
# ---------------------------------------------------------------------------

DIMS = dict(d=48, n_heads=4, n_kv=2, head_dim=16)


@functools.lru_cache(maxsize=None)
def _attn_params(qkv_bias):
    rdims = ref_attn.AttnDims(**DIMS, qkv_bias=qkv_bias)
    p = ref_attn.init_attn(jax.random.PRNGKey(2), rdims, "float32")
    if qkv_bias:  # the reference initialises biases at zero
        p = {k: v + 0.1 * jax.random.normal(jax.random.PRNGKey(3), v.shape)
             if k.startswith("b") else v for k, v in p.items()}
    return jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("n_chunks", [1, 2, 4, 5])
def test_attn_bidir_values_and_grads(n_chunks, qkv_bias):
    """Chunked and unchunked (5 does not divide S = 12: one chunk), with
    the gradient of a weighted sum for every parameter and the input."""
    rdims = ref_attn.AttnDims(**DIMS, qkv_bias=qkv_bias)
    dims = attention.AttnDims(**DIMS, qkv_bias=qkv_bias)
    p = _attn_params(qkv_bias)
    x, w = _np(4, 2, 12, 48), _np(5, 2, 12, 48)
    _, (rgp, rgx) = jax.value_and_grad(
        lambda p, x: jnp.sum(ref_attn.attn_bidir(p, x, rdims, n_chunks) * w),
        argnums=(0, 1))(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    want = ref_attn.attn_bidir(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                               rdims, n_chunks)
    tp = model.params_from_reference(p, "cpu")
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_()
    tx = _t(x).requires_grad_()
    y = attention.attn_bidir(tp, tx, dims, n_chunks)
    grads = torch.autograd.grad(torch.sum(y * _t(w)), leaves + [tx])
    assert _rel(want, y) <= TOL
    for i, (a, b) in enumerate(zip(jax.tree.leaves(rgp) + [rgx], grads)):
        assert _rel(a, b) <= TOL, i


def test_attn_bidir_attends_both_ways():
    """Not causal: the first position's output depends on the last
    input."""
    dims = attention.AttnDims(**DIMS)
    tp = model.params_from_reference(_attn_params(False), "cpu")
    x = _t(_np(6, 1, 8, 48)).requires_grad_()
    y = attention.attn_bidir(tp, x, dims)
    g, = torch.autograd.grad(y[0, 0].sum(), x)
    assert g[0, -1].abs().sum() > 0


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_cross_kv_and_attn_cross_values_and_grads(qkv_bias):
    rdims = ref_attn.AttnDims(**DIMS, qkv_bias=qkv_bias)
    dims = attention.AttnDims(**DIMS, qkv_bias=qkv_bias)
    p = _attn_params(qkv_bias)
    x, y, w = _np(7, 2, 5, 48), _np(8, 2, 9, 48), _np(9, 2, 5, 48)

    def ref_obj(p, x, y):
        kv = ref_attn.cross_kv(p, y, rdims)
        out = ref_attn.attn_cross(p, x, kv, rdims)
        return jnp.sum(out * w), (kv, out)

    (_, (rkv, rout)), rg = jax.value_and_grad(
        ref_obj, argnums=(0, 1, 2), has_aux=True)(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(y))
    tp = model.params_from_reference(p, "cpu")
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_()
    tx, ty = _t(x).requires_grad_(), _t(y).requires_grad_()
    kv = attention.cross_kv(tp, ty, dims)
    out = attention.attn_cross(tp, tx, kv, dims)
    grads = torch.autograd.grad(torch.sum(out * _t(w)), leaves + [tx, ty])
    _assert_tree(rkv, kv, "cross_kv")
    assert _rel(rout, out) <= TOL
    names = sorted(p) + ["x", "y"]
    want = dict(zip(names, jax.tree.leaves(rg[0]) + [rg[1], rg[2]]))
    got = dict(zip(names, grads))
    if qkv_bias:
        # a key bias shifts every score of a query alike, so its gradient
        # is zero in exact arithmetic: both sides hold rounding noise only
        top = max(float(np.abs(np.asarray(a)).max()) for a in want.values())
        assert float(np.abs(np.asarray(want.pop("bk"))).max()) <= TOL * top
        assert float(got.pop("bk").abs().max()) <= TOL * top
    for name, a in want.items():
        assert _rel(a, got[name]) <= TOL, name


# ---------------------------------------------------------------------------
# the reduced model
# ---------------------------------------------------------------------------

B, S, T_ENC = 2, 24, 20


@functools.lru_cache(maxsize=None)
def _ref_params():
    return jax.tree.map(np.asarray, ref_ed.init_encdec(
        jax.random.PRNGKey(0), ref_get_reduced(ARCH)))


def _params():
    return model.params_from_reference(_ref_params(), "cpu")


def _batch():
    rng = np.random.default_rng(11)
    frames = rng.standard_normal((B, T_ENC, 128)).astype(np.float32)
    tokens = rng.integers(0, 512, (B, S)).astype(np.int32)
    labels = rng.integers(0, 512, (B, S)).astype(np.int32)
    labels[:, -4:] = -1
    return frames, tokens, labels


def test_params_tree_matches_reference_layout():
    cfg = get_reduced(ARCH)
    ours = encdec.init_encdec(torch.Generator().manual_seed(0), cfg)
    ref = _ref_params()
    assert [tuple(t.shape) for t in tree_leaves(ours)] \
        == [a.shape for a in jax.tree.leaves(ref)]
    assert ours["enc"]["attn"]["wq"].shape[0] == cfg.n_enc_layers
    assert ours["dec"]["cross_attn"]["wq"].shape[0] == cfg.n_layers
    assert model.family_fns(cfg).init is encdec.init_encdec


@pytest.mark.parametrize("row_chunks", [1, 2])
def test_encode_equals_reference(row_chunks):
    rcfg = dataclasses.replace(ref_get_reduced(ARCH), row_chunks=row_chunks)
    cfg = dataclasses.replace(get_reduced(ARCH), row_chunks=row_chunks)
    frames, _, _ = _batch()
    want = ref_ed.encode(jax.tree.map(jnp.asarray, _ref_params()),
                         jnp.asarray(frames), rcfg)
    with torch.no_grad():
        got = encdec.encode(_params(), _t(frames), cfg)
    assert _rel(want, got) <= TOL


@pytest.mark.parametrize("row_chunks", [1, 2])
def test_encdec_loss_and_every_grad(row_chunks):
    rcfg = dataclasses.replace(ref_get_reduced(ARCH), row_chunks=row_chunks)
    cfg = dataclasses.replace(get_reduced(ARCH), row_chunks=row_chunks)
    frames, tokens, labels = _batch()
    rb = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens),
          "labels": jnp.asarray(labels)}
    (rl, raux), rg = jax.value_and_grad(
        lambda p: ref_ed.encdec_loss(p, rb, rcfg), has_aux=True)(
        jax.tree.map(jnp.asarray, _ref_params()))
    params = _params()
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    loss, aux = encdec.encdec_loss(params, {
        "frames": _t(frames), "tokens": _t(tokens), "labels": _t(labels)},
        cfg)
    grads = torch.autograd.grad(loss, leaves)
    assert _rel(rl, loss) <= TOL and _rel(raux["ce"], aux["ce"]) <= TOL
    want = jax.tree.leaves(rg)
    assert len(want) == len(grads)
    bad = [(i, _rel(a, b)) for i, (a, b) in enumerate(zip(want, grads))
           if not _rel(a, b) <= TOL]
    assert not bad, bad


def test_build_lm_apply_runs_the_encdec_loss():
    """A sequence plan's LM form runs ``encdec_loss`` with the plan's chunk
    count (the reference's ``build_lm_apply`` branch)."""
    from repro_torch.exec import build_apply
    cfg = get_reduced(ARCH)
    plan = Planner.for_model(cfg, B, S)
    assert plan.engine == "seq_chunked"
    frames, tokens, labels = _batch()
    batch = {"frames": _t(frames), "tokens": _t(tokens),
             "labels": _t(labels)}
    loss, aux = build_apply((None, cfg), plan)(_params(), batch)
    run = dataclasses.replace(cfg, row_chunks=plan.n_rows)
    want, _ = encdec.encdec_loss(_params(), batch, run)
    assert set(aux) == {"ce"} and torch.equal(loss, want)


@pytest.mark.parametrize("row_chunks", [1, 2])
def test_prefill_then_greedy_decode_equals_reference(row_chunks):
    """``encdec_prefill`` into a 32-position self cache, then six greedy
    ``encdec_decode`` steps: logits, every cache leaf (self and cross) and
    the token streams."""
    rcfg = dataclasses.replace(ref_get_reduced(ARCH), row_chunks=row_chunks)
    cfg = dataclasses.replace(get_reduced(ARCH), row_chunks=row_chunks)
    frames, tokens, _ = _batch()
    params = jax.tree.map(jnp.asarray, _ref_params())
    tp = _params()
    rl, rc = ref_ed.encdec_prefill(params, {"frames": jnp.asarray(frames),
                                            "tokens": jnp.asarray(tokens)},
                                   rcfg, 32)
    with torch.no_grad():
        lg, c = encdec.encdec_prefill(tp, {"frames": _t(frames),
                                           "tokens": _t(tokens)}, cfg, 32)
    assert _rel(rl, lg) <= TOL
    _assert_tree(rc, c, "prefill")
    want, got = [], []
    rt = np.argmax(np.asarray(rl)[:, -1], -1).astype(np.int32)
    gt = torch.argmax(lg[:, -1], -1)
    for step in range(6):
        want.append(rt.tolist())
        got.append(gt.tolist())
        rl, rc = ref_ed.encdec_decode(params, jnp.asarray(rt[:, None]), rc,
                                      rcfg)
        with torch.no_grad():
            lg, c = encdec.encdec_decode(tp, gt[:, None], c, cfg)
        assert _rel(rl, lg) <= TOL, step
        _assert_tree(rc, c, f"decode {step}")
        rt = np.argmax(np.asarray(rl)[:, -1], -1).astype(np.int32)
        gt = torch.argmax(lg[:, -1], -1)
    assert got == want


def test_decode_from_converted_reference_caches_and_steps():
    """A reference prefill's caches convert leaf for leaf and the port's
    serve step decodes on from them; the prefill step is greedy."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    rcfg, cfg = ref_get_reduced(ARCH), get_reduced(ARCH)
    frames, tokens, _ = _batch()
    params = jax.tree.map(jnp.asarray, _ref_params())
    rl, rc = ref_ed.encdec_prefill(params, {"frames": jnp.asarray(frames),
                                            "tokens": jnp.asarray(tokens)},
                                   rcfg, 30)
    tok, _, _ = make_prefill_step(cfg, 30)(_params(), {
        "frames": _t(frames), "tokens": _t(tokens)})
    want = np.argmax(np.asarray(rl)[:, -1], -1)
    assert tok.dtype == torch.int32 and tok.tolist() == want.tolist()
    c = model.caches_from_reference(rc, "cpu")
    rl, _ = ref_ed.encdec_decode(params, jnp.asarray(
        want[:, None].astype(np.int32)), rc, rcfg)
    tok, _, _ = make_serve_step(cfg)(_params(), c, {"tokens": tok[:, None]})
    assert tok.tolist() == np.argmax(np.asarray(rl)[:, -1], -1).tolist()


def test_init_caches_and_pool_bytes_equal_reference():
    """``encdec_init_caches`` is the reference's tree; a pool slot holds
    exactly what ``decode_slot_bytes`` prices, self KV plus cross K/V."""
    from repro_torch.serve.cache_pool import init_pool_caches
    rcfg, cfg = ref_get_reduced(ARCH), get_reduced(ARCH)
    _assert_tree(ref_ed.encdec_init_caches(rcfg, 3, 24, 10),
                 encdec.encdec_init_caches(cfg, 3, 24, 10))

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    one = init_pool_caches(cfg, 1, 24, enc_len=10, device="meta")
    two = init_pool_caches(cfg, 2, 24, enc_len=10, device="meta")
    assert nbytes(two) - nbytes(one) \
        == Planner.decode_slot_bytes(cfg, 24, enc_len=10)
    for kind in ("paged_kv", "quant_kv"):
        with pytest.raises(ValueError, match="enc-dec"):
            Planner.decode_slot_bytes(cfg, 24, enc_len=10, cache_kind=kind)
        with pytest.raises(ValueError, match="enc-dec"):
            init_pool_caches(cfg, 1, 24, enc_len=10, cache_kind=kind)


def test_engine_checks_frames():
    """An enc-dec request needs frames, as long as the pool's enc_len."""
    import dataclasses as dc
    from repro_torch.serve import ServeEngine, make_requests
    cfg = get_reduced(ARCH)
    engine = ServeEngine(_params(), cfg,
                         Planner.for_serve(cfg, 40, n_slots=1, enc_len=12))
    req = make_requests(1, cfg.vocab, prompt_len=8, max_new_tokens=4,
                        frontend="audio", n_feature_tokens=12,
                        feature_dim=cfg.d_model)[0]
    logits, cache, n = engine.prefill(req)
    assert logits.shape == (cfg.vocab,) and n >= 1
    assert cache["cross"]["k"].shape == (2, 1, 12, 4, 32)
    with pytest.raises(ValueError, match="needs frame"):
        engine.prefill(dc.replace(req, features=None))
    with pytest.raises(ValueError, match="enc_len"):
        engine.prefill(dc.replace(req, features=req.features[:5]))


def _reference_losses(tree, steps, seq, batch, seed=0):
    """The reference's ``encdec_loss`` + ``adamw_update`` on the trainer's
    batches: the token data and the frames of ``default_rng((seed,
    step))`` (``src/repro/launch/train.py:192-197``)."""
    from repro.data.pipeline import TokenDataset, TokenDatasetConfig
    cfg = ref_get_reduced(ARCH)
    opt_cfg = ref_opt.AdamWConfig(lr=3e-4)

    @jax.jit
    def step_fn(p, opt, b):
        (loss, _), g = jax.value_and_grad(
            lambda p: ref_ed.encdec_loss(p, b, cfg), has_aux=True)(p)
        p, opt, _ = ref_opt.adamw_update(p, g, opt, opt_cfg)
        return p, opt, loss

    params = jax.tree.map(jnp.asarray, tree)
    opt = ref_opt.adamw_init(params)
    ds = TokenDataset(TokenDatasetConfig(vocab=cfg.vocab, seq_len=seq,
                                         batch=batch, seed=seed))
    losses = []
    for step in range(steps):
        hb = ds.batch_at(step)
        frames = np.random.default_rng((seed, step)).normal(
            0, 1, (batch, seq, cfg.d_model)).astype(np.float32)
        params, opt, loss = step_fn(params, opt, {
            "frames": jnp.asarray(frames), "tokens": jnp.asarray(hb["tokens"]),
            "labels": jnp.asarray(hb["labels"])})
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("flags", [(), ("--budget-gb", "0.0001")])
def test_trainer_losses_equal_reference_loop(tmp_path, flags):
    """``repro_torch.launch.train --arch seamless_m4t_medium`` (batch 2,
    seq 32, 3 steps), unplanned and through a budget's ``seq_chunked``
    plan, from the reference's parameters; 1e-5 relative at step 0, times
    10 per step."""
    from repro_torch.launch import train as T
    want = _reference_losses(_ref_params(), 3, 32, 2)
    args = T.build_parser().parse_args(
        ["--arch", ARCH, "--preset", "reduced", "--device", "cpu",
         "--batch", "2", "--seq", "32", "--steps", "3", "--log-every", "1",
         "--out", str(tmp_path), *flags])
    recs = T.train_lm(args, params=_params())
    got = [r["loss"] for r in recs]
    for step, (a, b) in enumerate(zip(want, got)):
        assert abs(a - b) / abs(a) < 1e-5 * 10 ** step, (step, want, got)
