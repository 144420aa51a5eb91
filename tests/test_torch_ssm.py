"""The port's SSM and xLSTM layers, and the dense, SSM and hybrid LMs built
from them, against the JAX package on the CPU.

Inputs come from numpy with a seed; parameters are the reference's
``init_*`` trees converted by ``params_from_reference``.  fp32 throughout:
values at 1e-5 relative (max |diff| over max |reference|), and each
gradient leaf at 1e-5 of that leaf's largest reference gradient — except
the SSD decay rates ``a_log`` and ``dt_bias``, held at 5e-5: their
gradients are sums through ``log``, ``cumsum`` and ``exp`` that cancel,
and the reference's own fp32 gradient of the decay lies 1e-5 to 2e-5 from
a float64 evaluation (``test_ssd_chunk_long_chunk`` measures both packages
against the port in float64, where ``_ssd_chunk`` runs with no casts).

Module cases run at chunks small enough to carry the state across several
chunks; the whole-model cases run the reduced Zamba2 and xLSTM presets at
batch 1, seq 512 (two 256-token chunks, the reference's own cases) and
the three reduced dense presets at batch 2, seq 64.  Under host residency
the carried chunk scans run on the row-program executor, and sLSTM's
recurrent weights ``r_h`` reach it as explicit ``consts``: their gradient
is checked there too.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.models.lm import model as ref_model
from repro.models.lm import ssm as ref_ssm
from repro.models.lm import xlstm as ref_xlstm
from repro_torch.configs import get_config, get_reduced
from repro_torch.exec import ExecutionPlan, ResidencySpec
from repro_torch.models.lm import model, rowexec, ssm, xlstm
from repro_torch.models.lm.blocks import ssm_dims, xlstm_dims
from repro_torch.optim.adamw import tree_leaves

NEW_ARCHS = ["llama3_2_3b", "qwen1_5_4b", "qwen1_5_110b", "zamba2_7b",
             "xlstm_125m"]
#: gradient leaves whose fp32 value is noisy in both packages (docstring)
DECAY_LEAVES = ("a_log", "dt_bias")


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """One torch CPU thread for this module: its many small ops (xLSTM's
    per-token loop above all) take the same time alone on one thread and
    do not stall beside other test workers, and multi-threaded CPU
    reductions are not bit-reproducible from run to run, while some
    cases here compare runs bit for bit."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel(want, got):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape, (want.shape, got.shape)
    if not want.size:
        return 0.0
    return float(np.abs(want - got).max()) / max(
        float(np.abs(want).max()), 1e-30)


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale) \
        .astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_are_the_references(arch):
    from repro.configs import get_config as ref_get_config
    for ref, cfg in ((ref_get_reduced(arch), get_reduced(arch)),
                     (ref_get_config(arch), get_config(arch))):
        assert dataclasses.asdict(ref) == dataclasses.asdict(cfg)
        assert cfg.layer_kinds() == ref.layer_kinds()
        assert cfg.scan_segments() == ref.scan_segments()


# ---------------------------------------------------------------------------
# Mamba2 / SSD
# ---------------------------------------------------------------------------

#: small SSD widths: 2 heads of 8 channels, state 4
SD = ssm.SSMDims(d=16, n_heads=2, head_p=8, state_n=4, chunk=16)


def _ref_dims(dims):
    cls = ref_ssm.SSMDims if isinstance(dims, ssm.SSMDims) \
        else ref_xlstm.XLSTMDims
    return cls(**dataclasses.asdict(dims))


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("state", [False, True])
def test_causal_conv(k, state):
    u, w = _np(0, 2, 12, 6), _np(1, k, 1, 6)
    st = _np(2, 2, k - 1, 6) if state else None
    want = ref_ssm._causal_conv(jnp.asarray(u), jnp.asarray(w),
                                None if st is None else jnp.asarray(st))
    tu, tw = _t(u).requires_grad_(), _t(w).requires_grad_()
    got = ssm._causal_conv(tu, tw, None if st is None else _t(st))
    for a, b in zip(want, got):
        assert _rel(a, b.detach()) < 1e-5
    gu, gw = jax.grad(lambda u, w: jnp.sum(ref_ssm._causal_conv(
        u, w, None if st is None else jnp.asarray(st))[0] ** 2),
        argnums=(0, 1))(jnp.asarray(u), jnp.asarray(w))
    got[0].square().sum().backward()
    assert _rel(gu, tu.grad) < 1e-5 and _rel(gw, tw.grad) < 1e-5


def _chunk_inputs(seed, Bt, c, H, P, N, decay):
    """x, B, C, a, dt, h0 for ``_ssd_chunk``; ``a`` near ``decay``."""
    x, B, C = _np(seed, Bt, c, H, P), _np(seed + 1, Bt, c, N), \
        _np(seed + 2, Bt, c, N)
    dt = np.abs(_np(seed + 3, Bt, c, H, scale=0.5)) + 0.1
    a = np.clip(decay + _np(seed + 4, Bt, c, H, scale=0.05), 0.05, 0.99) \
        .astype(np.float32)
    h0 = _np(seed + 5, Bt, H, P, N, scale=0.5)
    return x, B, C, a, dt, h0


def _ref_chunk_grads(inputs, dims):
    def loss(*args):
        y, h = ref_ssm._ssd_chunk(*args, _ref_dims(dims))
        return jnp.sum(y ** 2) + jnp.sum(h ** 2)
    args = [jnp.asarray(a) for a in inputs]
    y, h = jax.jit(ref_ssm._ssd_chunk, static_argnums=6)(
        *args, _ref_dims(dims))
    return (y, h), jax.jit(jax.grad(loss, argnums=tuple(range(6))))(*args)


def _port_chunk_grads(inputs, dims, dtype=torch.float32, chunk_fn=None):
    ts = [_t(a).to(dtype).requires_grad_() for a in inputs]
    y, h = (chunk_fn or ssm._ssd_chunk)(*ts, dims)
    (y.square().sum() + h.square().sum()).backward()
    return (y.detach(), h.detach()), [t.grad for t in ts]


@pytest.mark.parametrize("c,decay", [(8, 0.9), (16, 0.5), (64, 0.97)])
def test_ssd_chunk(c, decay):
    inputs = _chunk_inputs(10, 2, c, 2, 8, 4, decay)
    want, want_g = _ref_chunk_grads(inputs, SD)
    got, got_g = _port_chunk_grads(inputs, SD)
    for a, b in zip(want, got):
        assert _rel(a, b) < 1e-5
    for a, b in zip(want_g, got_g):
        assert _rel(a, b) < 1e-5


def _mask_after_exp(x, B, C, a, dt, h0, dims):
    """``_ssd_chunk`` with the mask applied after ``exp`` (the fault the
    reference's comment warns of)."""
    cum = torch.cumsum(torch.log(a + 1e-12), dim=1)
    diff = cum[:, :, None, :] - cum[:, None, :, :]
    mask = torch.tril(torch.ones((x.shape[1],) * 2, dtype=torch.bool))
    w = torch.where(mask[None, :, :, None], torch.exp(diff), 0.0)
    scores = torch.einsum("btn,bsn->bts", C, B)[..., None] * w
    y = torch.einsum("btsh,bshp->bthp", scores, x * dt[..., None])
    return y, h0 * 1.0


def test_ssd_chunk_long_chunk():
    """A 256-token chunk at decay 0.5 spans ~177 in log decay: the acausal
    ``exp(diff)`` overflows, so masking after ``exp`` would turn every
    gradient upstream of it (the decay's) to NaN.  The port masks first:
    its values and gradients are finite, and against the port's float64
    evaluation (where ``_ssd_chunk`` runs with no casts) each is no
    further off than the reference's own fp32 result — which here lies up
    to ~1e-5 from it (the outgoing state, the decay's gradient), so the
    two fp32 results are compared through float64, not with each other."""
    inputs = _chunk_inputs(20, 1, 256, 2, 8, 4, 0.5)
    _, bad = _port_chunk_grads(inputs, SD, chunk_fn=_mask_after_exp)
    assert torch.isnan(bad[3]).all()  # the decay's gradient: all NaN
    want, want_g = _ref_chunk_grads(inputs, SD)
    got, got_g = _port_chunk_grads(inputs, SD)
    exact, exact_g = _port_chunk_grads(inputs, SD, dtype=torch.float64)
    for ref, port, ex in zip((*want, *want_g), (*got, *got_g),
                             (*exact, *exact_g)):
        assert torch.isfinite(port).all()
        ex = ex.numpy()
        ref_err = _rel(ex, np.asarray(ref, np.float64))
        port_err = _rel(ex, port.double())
        assert port_err <= 2 * ref_err + 1e-6, (port_err, ref_err)


def _ssm_params(seed, dims):
    p = ref_ssm.init_ssm(jax.random.PRNGKey(seed), _ref_dims(dims),
                         jnp.float32)
    # non-zero decay and step biases, so a_log / dt_bias gradients matter
    rng = np.random.default_rng(seed)
    p["a_log"] = jnp.asarray(rng.normal(size=dims.n_heads) * 0.3,
                             jnp.float32)
    p["dt_bias"] = jnp.asarray(rng.normal(size=dims.n_heads) * 0.3,
                               jnp.float32)
    return jax.tree.map(np.asarray, p)


@functools.lru_cache(maxsize=None)
def _ref_module(kind, seed, x_seed, shape):
    """The reference layer ``kind``'s output and gradients (parameters,
    x) under ``sum(out ** 2)``, jitted; cached across residencies."""
    if kind == "mamba":
        params, dims = _ssm_params(seed, SD), SD
        fn = ref_ssm.ssm_train
    else:
        params, dims = _xlstm_params(kind, seed), XD
        fn = ref_xlstm.mlstm_train if kind == "mlstm" \
            else ref_xlstm.slstm_train
    x = _np(x_seed, *shape, scale=0.5)

    def out(p, xx):
        return fn(p, xx, _ref_dims(dims))
    jp = jax.tree.map(jnp.asarray, params)
    want = jax.jit(out)(jp, jnp.asarray(x))
    gp, gx = jax.jit(jax.grad(lambda p, xx: jnp.sum(out(p, xx) ** 2),
                              argnums=(0, 1)))(jp, jnp.asarray(x))
    return params, x, want, gp, gx


def _module_parity(kind, seed, x_seed, shape, port_fn, plan=None,
                   tol=1e-5, loose=()):
    """Output and gradients (every parameter leaf and x) of the port's
    ``port_fn(params, x)`` against :func:`_ref_module`'s; the port's side
    runs with ``plan`` active."""
    params, x, want, gp, gx = _ref_module(kind, seed, x_seed, shape)
    tp = model.params_from_reference(params, "cpu")
    for t in tree_leaves(tp):
        t.requires_grad_()
    tx = _t(x).requires_grad_()
    with rowexec.use_plan(plan):
        got = port_fn(tp, tx)
        got.square().sum().backward()
    assert _rel(want, got.detach()) < tol
    assert _rel(gx, tx.grad) < tol
    names = sorted(params)
    for name, a, b in zip(names, (gp[k] for k in names),
                          (tp[k].grad for k in names)):
        lim = 5e-5 if name in loose else tol
        assert _rel(a, b) < lim, name


def _host_plan(n):
    return ExecutionPlan.explicit("seq_carry_scan", n,
                                  residency=ResidencySpec.parse("host"))


@pytest.mark.parametrize("S", [16, 64])
@pytest.mark.parametrize("residency", ["", "host", "recompute"])
def test_ssm_train(S, residency):
    plan = None if not residency else ExecutionPlan.explicit(
        "seq_carry_scan", 2, residency=ResidencySpec.parse(residency))
    _module_parity("mamba", 0, 5, (2, S, SD.d),
                   lambda p, x: ssm.ssm_train(p, x, SD), plan,
                   loose=DECAY_LEAVES)


def test_ssm_train_return_state():
    params = _ssm_params(1, SD)
    x = _np(6, 2, 48, SD.d, scale=0.5)
    want_y, want_s = ref_ssm.ssm_train(jax.tree.map(jnp.asarray, params),
                                       jnp.asarray(x), _ref_dims(SD),
                                       return_state=True)
    got_y, got_s = ssm.ssm_train(model.params_from_reference(params, "cpu"),
                                 _t(x), SD, return_state=True)
    assert _rel(want_y, got_y) < 1e-5
    for k in ("h", "conv"):
        assert _rel(want_s[k], got_s[k]) < 1e-5


def test_softplus_has_no_linear_cut_over():
    x = np.array([-30.0, -1.0, 0.0, 1.0, 19.0, 20.5, 40.0], np.float32)
    assert _rel(jax.nn.softplus(jnp.asarray(x)), ssm.softplus(_t(x))) < 1e-7


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------

XD = xlstm.XLSTMDims(d=16, n_heads=2, chunk=8)


def _xlstm_params(kind, seed):
    init = ref_xlstm.init_mlstm if kind == "mlstm" else ref_xlstm.init_slstm
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed),
                                         _ref_dims(XD), jnp.float32))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("S", [8, 32])
@pytest.mark.parametrize("residency", ["", "host"])
def test_xlstm_train(kind, S, residency):
    """mLSTM and sLSTM with every parameter's gradient — sLSTM's ``r_h``
    included, which under host residency reaches the executor as a
    ``consts`` arg (a closure would get no gradient)."""
    port_fn = xlstm.mlstm_train if kind == "mlstm" else xlstm.slstm_train
    _module_parity(kind, 2, 7, (2, S, XD.d),
                   lambda p, x: port_fn(p, x, XD),
                   _host_plan(S // XD.chunk) if residency else None)


def test_slstm_recurrent_weights_reach_the_executor():
    """Under host residency the sLSTM chunk scan runs on the executor and
    ``r_h``'s gradient is non-zero and equal to device residency's."""
    params = model.params_from_reference(_xlstm_params("slstm", 3), "cpu")
    x = _t(_np(8, 1, 32, XD.d, scale=0.5))
    grads = {}
    for name, plan in (("device", None), ("host", _host_plan(4))):
        r_h = params["r_h"].detach().requires_grad_()
        with rowexec.use_plan(plan):
            y = xlstm.slstm_train(dict(params, r_h=r_h), x, XD)
        (g,) = torch.autograd.grad(y.square().sum(), [r_h])
        grads[name] = g
    assert float(grads["host"].abs().max()) > 0
    assert _rel(grads["device"], grads["host"]) < 1e-6


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_return_state(kind):
    ref_fn = ref_xlstm.mlstm_train if kind == "mlstm" \
        else ref_xlstm.slstm_train
    port_fn = xlstm.mlstm_train if kind == "mlstm" else xlstm.slstm_train
    params = _xlstm_params(kind, 4)
    x = _np(9, 2, 24, XD.d, scale=0.5)
    want_y, want_s = ref_fn(jax.tree.map(jnp.asarray, params),
                            jnp.asarray(x), _ref_dims(XD), return_state=True)
    got_y, got_s = port_fn(model.params_from_reference(params, "cpu"),
                           _t(x), XD, return_state=True)
    assert _rel(want_y, got_y) < 1e-5
    assert sorted(want_s) == sorted(got_s)
    for k in want_s:
        assert _rel(want_s[k], got_s[k]) < 1e-5


def test_block_dims_are_the_references():
    from repro.configs import get_config as ref_get_config
    from repro.models.lm import blocks as ref_blocks
    for arch in ("zamba2_7b", "xlstm_125m"):
        cfg, ref = get_config(arch), ref_get_config(arch)
        assert dataclasses.asdict(ssm_dims(cfg)) \
            == dataclasses.asdict(ref_blocks.ssm_dims(ref))
        assert dataclasses.asdict(xlstm_dims(cfg)) \
            == dataclasses.asdict(ref_blocks.xlstm_dims(ref))


# ---------------------------------------------------------------------------
# Whole models: loss and every gradient of the reduced presets
# ---------------------------------------------------------------------------

#: arch -> (batch, seq): the recurrent presets at two 256-token chunks
SHAPES = {"zamba2_7b": (1, 512), "xlstm_125m": (1, 512),
          "llama3_2_3b": (2, 64), "qwen1_5_4b": (2, 64),
          "qwen1_5_110b": (2, 64)}


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    tree = ref_model.init_lm(jax.random.PRNGKey(0), ref_get_reduced(arch))
    return jax.tree.map(np.asarray, tree)


def _batch(arch):
    B, S = SHAPES[arch]
    vocab = get_reduced(arch).vocab
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    labels[:, -3:] = -1  # ignored positions
    return tokens, labels


def _leaf_names(tree, prefix=""):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree)
                for n in _leaf_names(t, f"{prefix}/{i}")]
    return [prefix]


@functools.lru_cache(maxsize=None)
def _ref_loss_grads(arch):
    cfg = ref_get_reduced(arch)
    tokens, labels = _batch(arch)
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: ref_model.lm_loss(p, batch, cfg), has_aux=True))(
            jax.tree.map(jnp.asarray, _ref_params(arch)))
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_lm_loss_and_grads(arch):
    want_loss, want_grads = _ref_loss_grads(arch)
    cfg = get_reduced(arch)
    params = model.params_from_reference(_ref_params(arch), "cpu")
    leaves = tree_leaves(params)
    names = _leaf_names(_ref_params(arch))
    assert len(leaves) == len(want_grads) == len(names)
    for t in leaves:
        t.requires_grad_()
    tokens, labels = _batch(arch)
    loss, _ = model.lm_loss(params, {"tokens": _t(tokens),
                                     "labels": _t(labels)}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - want_loss) / abs(want_loss) < 1e-5
    for name, w, g in zip(names, want_grads, grads):
        lim = 5e-5 if name.split("/")[-1] in DECAY_LEAVES else 1e-5
        assert _rel(w, g) < lim, name


@pytest.mark.parametrize("arch", ["zamba2_7b", "xlstm_125m"])
def test_params_tree_matches_reference_layout(arch):
    cfg = get_reduced(arch)
    ours = model.init_lm(torch.Generator().manual_seed(0), cfg)
    ref = _ref_params(arch)
    assert _leaf_names(ours) == _leaf_names(ref)
    assert [tuple(t.shape) for t in tree_leaves(ours)] \
        == [a.shape for a in jax.tree.leaves(ref)]
    assert [t.dtype for t in tree_leaves(ours)] \
        == [torch.float32] * len(tree_leaves(ours))
    shared = ours["stack"]["shared"]
    if arch == "zamba2_7b":
        assert shared is not None and ours["stack"]["segments"][0][1] is None
    else:
        assert shared is None


def test_shared_block_gradient_sums_its_occurrences():
    """Zamba2's shared block is one set of parameters used at every
    shared position: its gradient is the sum over them (the reference's
    tree has it once, under ``stack/shared``)."""
    cfg = get_reduced("zamba2_7b")
    assert cfg.layer_kinds().count("shared_attn") == 2
    params = model.params_from_reference(_ref_params("zamba2_7b"), "cpu")
    wq = params["stack"]["shared"]["attn"]["wq"].requires_grad_()
    tokens, labels = _batch("zamba2_7b")
    batch = {"tokens": _t(tokens)[:, :64], "labels": _t(labels)[:, :64]}
    loss, _ = model.lm_loss(params, batch, cfg)
    (g,) = torch.autograd.grad(loss, [wq])
    # the same loss with each occurrence given its own copy
    from repro_torch.models.lm import blocks
    copies = []
    real = blocks.block_train

    def spy(p, x, kind, c):
        if kind == "shared_attn":
            p = dict(p, attn=dict(p["attn"], wq=p["attn"]["wq"].detach()
                                  .requires_grad_()))
            copies.append(p["attn"]["wq"])
        return real(p, x, kind, c)
    blocks.block_train = spy
    try:
        loss2, _ = model.lm_loss(params, batch, cfg)
    finally:
        blocks.block_train = real
    parts = torch.autograd.grad(loss2, copies)
    assert len(parts) == 2
    assert torch.allclose(g, parts[0] + parts[1], rtol=1e-5, atol=1e-8)


def test_unported_families_name_their_slice():
    """The four archs that waited for the MoE, VLM and encoder-decoder
    slice now have their configs and models: each reduced preset's
    parameters have the reference's leaf shapes (their values are held in
    ``tests/test_torch_{moe,encdec,lm}.py``), and ``model.py`` sends the
    encoder-decoder family to ``encdec.py``."""
    import repro_torch.configs as C
    from repro.models.lm import encdec as ref_encdec
    for arch in ("deepseek_moe_16b", "qwen3_moe_235b_a22b",
                 "llava_next_34b", "seamless_m4t_medium"):
        rcfg, cfg = ref_get_reduced(arch), C.get_reduced(arch)
        ref_init = ref_encdec.init_encdec if rcfg.family == "encdec" \
            else ref_model.init_lm
        want = jax.eval_shape(lambda: ref_init(jax.random.PRNGKey(0), rcfg))
        got = model.family_fns(cfg).init(torch.Generator().manual_seed(0),
                                         cfg)
        assert [tuple(a.shape) for a in jax.tree.leaves(want)] \
            == [tuple(t.shape) for t in tree_leaves(got)], arch
    cfg = dataclasses.replace(get_reduced("llama3_2_3b"), family="encdec")
    with pytest.raises(ValueError, match="encdec"):
        model.init_lm(torch.Generator(), cfg)
