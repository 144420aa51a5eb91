"""The port's serving layers against the JAX package on the CPU: the
decode and prefill halves of every ported layer kind, whole reduced
models through ``lm_prefill`` then ``lm_decode``, the serve planner's
integers and plan JSON, and the serve CLI.

Inputs come from numpy with a seed; parameters are the reference's
``init_*`` trees converted by ``params_from_reference``, and reference
caches convert leaf for leaf through ``caches_from_reference``.  fp32
throughout: each output and each cache leaf within 1e-5 of its own
largest reference magnitude (max |diff| / max |reference|).  The
reference's layers import in this process; its Planner needs the
``TransferToMemoryKind`` name JAX 0.9 dropped, so the planner's numbers
come from one child process that installs a stand-in for that name (the
stand-in never enters this process).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.models.lm import attention as ref_attn
from repro.models.lm import blocks as ref_blocks
from repro.models.lm import model as ref_model
from repro.models.lm import ssm as ref_ssm
from repro.models.lm import xlstm as ref_xlstm
from repro_torch.configs import get_config, get_reduced
from repro_torch.exec import Planner, build_apply, list_engines
from repro_torch.models.lm import attention, blocks, model, ssm, xlstm
from repro_torch.optim.adamw import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
SERVE_ARCHS = ["gemma3_4b", "qwen1_5_4b", "zamba2_7b", "xlstm_125m",
               "deepseek_moe_16b", "qwen3_moe_235b_a22b"]
ALL_PORTED = ["gemma3_4b", "llama3_2_3b", "qwen1_5_4b", "qwen1_5_110b",
              "zamba2_7b", "xlstm_125m", "deepseek_moe_16b",
              "qwen3_moe_235b_a22b", "llava_next_34b", "seamless_m4t_medium"]


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


def _assert_tree(want, got, what=""):
    """Leaf for leaf: shapes, dtypes' kinds and values (1e-5 relative per
    leaf; integer and boolean leaves exactly)."""
    wl, gl = jax.tree.leaves(want), tree_leaves(got)
    assert len(wl) == len(gl), what
    for i, (w, g) in enumerate(zip(wl, gl)):
        w = np.asarray(w)
        if w.dtype.kind in "biu":
            assert np.array_equal(w, g.cpu().numpy()), (what, i)
        else:
            assert _rel(w, g) <= TOL, (what, i, _rel(w, g))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# attention: prefill into a cache, then decode from it
# ---------------------------------------------------------------------------

ATTN_DIMS = dict(d=48, n_heads=4, n_kv=2, head_dim=16)
S = 12


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("cache_len", [8, S, 20])
def test_attn_prefill_then_decode_matches_reference(ring, cache_len):
    """``attn_prefill`` (cache shorter than the prompt: the rolled tail;
    equal; longer: zero padding) then three ``attn_decode`` steps, ring and
    non-ring, windowed when the cache is a ring."""
    window = 6 if ring else 0
    rdims = ref_attn.AttnDims(**ATTN_DIMS, window=window)
    dims = attention.AttnDims(**ATTN_DIMS, window=window)
    params = ref_attn.init_attn(jax.random.PRNGKey(3), rdims, "float32")
    tp = model.params_from_reference(params, "cpu")
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, S, 48)).astype(np.float32)
    ry, rc = ref_attn.attn_prefill(params, jnp.asarray(x), rdims, cache_len,
                                   n_chunks=2, ring=ring)
    y, c = attention.attn_prefill(tp, _t(x), dims, cache_len, n_chunks=2,
                                  ring=ring)
    assert _rel(ry, y) <= TOL
    _assert_tree(rc, c, "prefill cache")
    for step in range(3):
        xt = rng.standard_normal((2, 1, 48)).astype(np.float32)
        ry, rc = ref_attn.attn_decode(params, jnp.asarray(xt), rc, rdims)
        y, c = attention.attn_decode(tp, _t(xt), c, dims)
        assert _rel(ry, y) <= TOL, step
        _assert_tree(rc, c, f"decode {step}")


def test_init_cache_matches_reference():
    for ring in (False, True):
        want = ref_attn.init_cache(3, 10, 2, 8, jnp.float32, ring=ring)
        _assert_tree(want, attention.init_cache(3, 10, 2, 8, torch.float32,
                                                ring=ring))


def test_attn_decode_ring_wraps_with_floor_modulo():
    """A ring cache past its length: the slot arithmetic wraps with a
    floor modulo of a negative difference (never ``fmod``), so every
    decode step keeps matching the reference."""
    rdims = ref_attn.AttnDims(**ATTN_DIMS, window=4)
    dims = attention.AttnDims(**ATTN_DIMS, window=4)
    params = ref_attn.init_attn(jax.random.PRNGKey(5), rdims, "float32")
    tp = model.params_from_reference(params, "cpu")
    rc = ref_attn.init_cache(1, 4, 2, 16, jnp.float32, ring=True)
    c = model.caches_from_reference(rc, "cpu")
    rng = np.random.default_rng(1)
    for step in range(9):  # more than twice around the ring
        xt = rng.standard_normal((1, 1, 48)).astype(np.float32)
        ry, rc = ref_attn.attn_decode(params, jnp.asarray(xt), rc, rdims)
        y, c = attention.attn_decode(tp, _t(xt), c, dims)
        assert _rel(ry, y) <= TOL, step
        _assert_tree(rc, c, f"step {step}")


# ---------------------------------------------------------------------------
# SSM and xLSTM: the prefill's state, then decode
# ---------------------------------------------------------------------------


def test_ssm_decode_continues_prefill_state():
    rdims = ref_ssm.SSMDims(d=32, n_heads=4, head_p=16, state_n=8,
                            chunk=8)
    dims = ssm.SSMDims(d=32, n_heads=4, head_p=16, state_n=8, chunk=8)
    params = ref_ssm.init_ssm(jax.random.PRNGKey(2), rdims, "float32")
    tp = model.params_from_reference(params, "cpu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 24, 32)).astype(np.float32)
    ry, rs = ref_ssm.ssm_train(params, jnp.asarray(x), rdims,
                               return_state=True)
    y, s = ssm.ssm_train(tp, _t(x), dims, return_state=True)
    assert _rel(ry, y) <= TOL
    _assert_tree(rs, s, "prefill state")
    for step in range(4):
        xt = rng.standard_normal((2, 1, 32)).astype(np.float32)
        ry, rs = ref_ssm.ssm_decode(params, jnp.asarray(xt), rs, rdims)
        y, s = ssm.ssm_decode(tp, _t(xt), s, dims)
        assert _rel(ry, y) <= TOL, step
        _assert_tree(rs, s, f"decode {step}")
    _assert_tree(ref_ssm.init_ssm_state(3, rdims),
                 ssm.init_ssm_state(3, dims))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_decode_continues_prefill_state(kind):
    rdims = ref_xlstm.XLSTMDims(d=32, n_heads=4, chunk=8)
    dims = xlstm.XLSTMDims(d=32, n_heads=4, chunk=8)
    init = getattr(ref_xlstm, f"init_{kind}")
    params = init(jax.random.PRNGKey(4), rdims, "float32")
    tp = model.params_from_reference(params, "cpu")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    ry, rs = getattr(ref_xlstm, f"{kind}_train")(
        params, jnp.asarray(x), rdims, return_state=True)
    y, s = getattr(xlstm, f"{kind}_train")(tp, _t(x), dims,
                                           return_state=True)
    assert _rel(ry, y) <= TOL
    _assert_tree(rs, s, "prefill state")
    for step in range(4):
        xt = rng.standard_normal((2, 1, 32)).astype(np.float32)
        ry, rs = getattr(ref_xlstm, f"{kind}_decode")(
            params, jnp.asarray(xt), rs, rdims)
        y, s = getattr(xlstm, f"{kind}_decode")(tp, _t(xt), s, dims)
        assert _rel(ry, y) <= TOL, step
        _assert_tree(rs, s, f"decode {step}")
    if kind == "mlstm":
        want = ref_xlstm.init_mlstm_state(3, rdims)
        got = xlstm.init_mlstm_state(3, dims)
    else:
        want = ref_xlstm.init_slstm_state(3, 32)
        got = xlstm.init_slstm_state(3, 32)
    _assert_tree(want, got)


# ---------------------------------------------------------------------------
# blocks, and whole models
# ---------------------------------------------------------------------------

BLOCK_KINDS = [("gemma3_4b", "local"), ("gemma3_4b", "global"),
               ("qwen1_5_4b", "attn"), ("zamba2_7b", "shared_attn"),
               ("zamba2_7b", "mamba"), ("xlstm_125m", "mlstm"),
               ("xlstm_125m", "slstm"), ("deepseek_moe_16b", "moe")]


@pytest.mark.parametrize("arch,kind", BLOCK_KINDS)
def test_block_prefill_then_decode_matches_reference(arch, kind):
    rcfg, cfg = ref_get_reduced(arch), get_reduced(arch)
    params = ref_blocks.init_block(jax.random.PRNGKey(6), kind, rcfg)
    tp = model.params_from_reference(params, "cpu")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 20, rcfg.d_model)).astype(np.float32)
    rx, rc = ref_blocks.block_prefill(params, jnp.asarray(x), kind, rcfg,
                                      24, jnp.float32)
    y, c = blocks.block_prefill(tp, _t(x), kind, cfg, 24, torch.float32)
    assert _rel(rx, y) <= TOL
    _assert_tree(rc, c, "prefill")
    for step in range(3):
        xt = rng.standard_normal((2, 1, rcfg.d_model)).astype(np.float32)
        rx, rc = ref_blocks.block_decode(params, jnp.asarray(xt), rc, kind,
                                         rcfg)
        y, c = blocks.block_decode(tp, _t(xt), c, kind, cfg)
        assert _rel(rx, y) <= TOL, step
        _assert_tree(rc, c, f"decode {step}")
    _assert_tree(ref_blocks.init_block_cache(kind, rcfg, 3, 24, jnp.float32),
                 blocks.init_block_cache(kind, cfg, 3, 24, torch.float32))


def test_moe_block_cache_raises_naming_its_slice():
    """The ``moe`` kind's decode cache is a full-attention KV cache, since
    the MoE slice ported it (it raised before); the pool's init and the
    planner's bytes use it."""
    from repro_torch.serve.cache_pool import CACHE_INITS
    rcfg, cfg = ref_get_reduced("qwen3_moe_235b_a22b"), \
        get_reduced("qwen3_moe_235b_a22b")
    want = ref_blocks.init_block_cache("moe", rcfg, 2, 8, jnp.float32)
    _assert_tree(want, blocks.init_block_cache("moe", cfg, 2, 8,
                                               torch.float32))
    _assert_tree(want, CACHE_INITS["moe"](cfg, 2, 8, torch.float32))
    with pytest.raises(ValueError, match="unknown layer kind"):
        blocks.init_block_cache("nope", cfg, 1, 8, torch.float32)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_lm_prefill_then_decode_matches_reference(arch):
    """``lm_prefill`` then five ``lm_decode`` steps of the reduced model,
    greedy, at batch 2 with a prompt longer than gemma's window (its
    ring caches hold the rolled tail): logits and every cache leaf."""
    rcfg, cfg = ref_get_reduced(arch), get_reduced(arch)
    params = ref_model.init_lm(jax.random.PRNGKey(0), rcfg)
    tp = model.params_from_reference(params, "cpu")
    toks = np.random.default_rng(0).integers(
        0, rcfg.vocab, (2, 40)).astype(np.int32)
    rl, rc = ref_model.lm_prefill(params, {"tokens": jnp.asarray(toks)},
                                  rcfg, 48)
    with torch.no_grad():
        lg, c = model.lm_prefill(tp, {"tokens": _t(toks)}, cfg, 48)
    assert _rel(rl, lg) <= TOL
    _assert_tree(rc, c, "prefill")
    _assert_tree(ref_model.init_caches(rcfg, 2, 48),
                 model.init_caches(cfg, 2, 48), "init_caches")
    tok = np.argmax(np.asarray(rl)[:, -1], -1).astype(np.int32)[:, None]
    for step in range(5):
        rl, rc = ref_model.lm_decode(params, jnp.asarray(tok), rc, rcfg)
        with torch.no_grad():
            lg, c = model.lm_decode(tp, _t(tok), c, cfg)
        assert _rel(rl, lg) <= TOL, step
        _assert_tree(rc, c, f"decode {step}")
        tok = np.argmax(np.asarray(rl)[:, -1], -1).astype(np.int32)[:, None]


def test_decode_from_converted_reference_caches():
    """A reference cache tree converts leaf for leaf
    (``caches_from_reference``) and the port decodes on from it."""
    rcfg, cfg = ref_get_reduced("zamba2_7b"), get_reduced("zamba2_7b")
    params = ref_model.init_lm(jax.random.PRNGKey(0), rcfg)
    tp = model.params_from_reference(params, "cpu")
    toks = np.random.default_rng(3).integers(
        0, rcfg.vocab, (1, 16)).astype(np.int32)
    _, rc = ref_model.lm_prefill(params, {"tokens": jnp.asarray(toks)},
                                 rcfg, 24)
    c = model.caches_from_reference(rc, "cpu")
    tok = np.array([[5]], np.int32)
    rl, rc = ref_model.lm_decode(params, jnp.asarray(tok), rc, rcfg)
    with torch.no_grad():
        lg, c = model.lm_decode(tp, _t(tok), c, cfg)
    assert _rel(rl, lg) <= TOL
    _assert_tree(rc, c)


def test_prefill_and_serve_steps_are_greedy():
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    rcfg, cfg = ref_get_reduced("qwen1_5_4b"), get_reduced("qwen1_5_4b")
    params = ref_model.init_lm(jax.random.PRNGKey(0), rcfg)
    tp = model.params_from_reference(params, "cpu")
    toks = np.random.default_rng(9).integers(
        0, rcfg.vocab, (2, 16)).astype(np.int32)
    rl, rc = ref_model.lm_prefill(params, {"tokens": jnp.asarray(toks)},
                                  rcfg, 24)
    tok, c = make_prefill_step(cfg, 24)(tp, {"tokens": _t(toks)})
    want = np.argmax(np.asarray(rl)[:, -1], -1)
    assert tok.dtype == torch.int32 and tok.tolist() == want.tolist()
    rl, _ = ref_model.lm_decode(params, jnp.asarray(want[:, None]
                                                    .astype(np.int32)),
                                rc, rcfg)
    tok, _ = make_serve_step(cfg)(tp, c, {"tokens": tok[:, None]})
    assert tok.tolist() == np.argmax(np.asarray(rl)[:, -1], -1).tolist()


# ---------------------------------------------------------------------------
# the serve planner against the reference's (child process)
# ---------------------------------------------------------------------------

CACHE_KINDS = ("full", "paged_kv", "quant_kv")
MAX_LENS = (48, 1088)
PAGE_SIZES = (8, 16)
#: (preset, max_len, for_serve kwargs) — budgets, pinned n_slots, cache
#: kinds, decode residency and cohorts
SERVE_QUERIES = [
    (preset, max_len, kw)
    for preset in ("reduced", "full")
    for max_len in (48, 1088)
    for kw in (
        {"budget": 0},
        {"budget": 2**20},
        {"budget": 2**31},
        {"n_slots": 3},
        {"budget": 2**31, "n_max": 24},
        {"budget": 2**31, "cache_kind": "quant_kv", "n_max": 24},
        {"budget": 2**31, "cache_kind": "paged_kv", "avg_len": 700,
         "n_max": 24},
        {"n_slots": 4, "cache_kind": "paged_kv", "page_size": 8},
        {"budget": 2**20, "cache_kind": "paged_kv", "n_pages": 7},
        {"n_slots": 4, "decode_residency": "host", "decode_batch": 1},
        {"budget": 2**31, "decode_residency": "host", "decode_batch": 4},
        {"n_slots": 6, "cache_kind": "quant_kv",
         "decode_residency": "host"},
        {"budget": 2**31, "enc_len": 40, "n_max": 24},
        {"n_slots": 3, "enc_len": 24, "decode_residency": "host",
         "decode_batch": 1},
    )]

PLANNER_CHILD = r'''
import json, sys
import jax, jax.memory, jax.sharding
if not hasattr(jax.sharding, "TransferToMemoryKind"):
    # JAX 0.9 dropped the name repro.exec.rowprog imports; this process only
    jax.sharding.TransferToMemoryKind = lambda kind: (
        jax.memory.Space.Host if "host" in kind else jax.memory.Space.Device)
from repro.configs import get_config, get_reduced
from repro.exec.planner import Planner, serve_cache_kinds
from repro.serve.cache_pool import init_pool_caches

spec = json.load(open(sys.argv[1]))
out = {"kinds": list(serve_cache_kinds())}
nbytes = lambda t: sum(int(l.size) * l.dtype.itemsize
                       for l in jax.tree.leaves(t))
for arch in spec["archs"]:
    for preset in ("reduced", "full"):
        cfg = get_reduced(arch) if preset == "reduced" else get_config(arch)
        for m in spec["max_lens"]:
            for kind in spec["kinds"]:
                try:
                    v = Planner.decode_slot_bytes(cfg, m, cache_kind=kind)
                except Exception as e:
                    v = type(e).__name__
                out[f"slot|{arch}|{preset}|{m}|{kind}"] = v
        for ps in spec["page_sizes"]:
            out[f"page|{arch}|{preset}|{ps}"] = Planner.page_bytes(cfg, ps)
        for i, (p, m, kw) in enumerate(spec["queries"]):
            if p != preset:
                continue
            try:
                v = Planner.for_serve(cfg, m, **kw).to_dict()
            except Exception as e:
                v = type(e).__name__
            out[f"plan|{arch}|{i}"] = v
    cfg = get_reduced(arch)
    one = jax.eval_shape(lambda: init_pool_caches(cfg, 1, 48))
    two = jax.eval_shape(lambda: init_pool_caches(cfg, 2, 48))
    out[f"pool|{arch}"] = nbytes(two) - nbytes(one)
json.dump(out, open(sys.argv[2], "w"))
'''


@pytest.fixture(scope="module")
def _planner_child(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_serve_planner")
    (d / "spec.json").write_text(json.dumps(dict(
        archs=ALL_PORTED, max_lens=MAX_LENS, kinds=CACHE_KINDS,
        page_sizes=PAGE_SIZES, queries=SERVE_QUERIES)))
    child = subprocess.Popen(
        [sys.executable, "-c", PLANNER_CHILD, str(d / "spec.json"),
         str(d / "ref.json")], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        yield child, d
    finally:
        child.kill()
        child.wait()


@pytest.fixture(scope="module")
def planner_ref(_planner_child):
    child, d = _planner_child
    _, err = child.communicate(timeout=600)
    assert child.returncode == 0, err[-4000:]
    return json.load(open(d / "ref.json"))


def _cfg(arch, preset):
    return get_reduced(arch) if preset == "reduced" else get_config(arch)


@pytest.mark.parametrize("arch", ALL_PORTED)
def test_decode_slot_and_page_bytes_equal_reference(planner_ref, arch):
    from repro_torch.exec.planner import serve_cache_kinds
    assert list(serve_cache_kinds()) == planner_ref["kinds"]
    for preset in ("reduced", "full"):
        cfg = _cfg(arch, preset)
        for m in MAX_LENS:
            for kind in CACHE_KINDS:
                try:
                    got = Planner.decode_slot_bytes(cfg, m, cache_kind=kind)
                except Exception as e:
                    got = type(e).__name__
                assert got == planner_ref[f"slot|{arch}|{preset}|{m}|{kind}"]
        for ps in PAGE_SIZES:
            assert Planner.page_bytes(cfg, ps) \
                == planner_ref[f"page|{arch}|{preset}|{ps}"]


@pytest.mark.parametrize("arch", ALL_PORTED)
def test_for_serve_plan_json_equals_reference(planner_ref, arch):
    bad = []
    for i, (preset, m, kw) in enumerate(SERVE_QUERIES):
        try:
            got = Planner.for_serve(_cfg(arch, preset), m, **kw).to_dict()
        except Exception as e:
            got = type(e).__name__
        if got != planner_ref[f"plan|{arch}|{i}"]:
            bad.append((preset, m, kw, got, planner_ref[f"plan|{arch}|{i}"]))
    assert not bad, bad[:2]


@pytest.mark.parametrize("arch", ALL_PORTED)
def test_decode_slot_bytes_exact(planner_ref, arch):
    """The estimate equals the real marginal bytes of one pool slot (ring
    flags excluded) in the port's pool and in the reference's."""
    from repro_torch.serve.cache_pool import init_pool_caches

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    cfg = get_reduced(arch)
    one = init_pool_caches(cfg, 1, 48, device="meta")
    two = init_pool_caches(cfg, 2, 48, device="meta")
    assert Planner.decode_slot_bytes(cfg, 48) == nbytes(two) - nbytes(one) \
        == planner_ref[f"pool|{arch}"]


@pytest.mark.parametrize("kind", CACHE_KINDS)
def test_pool_bytes_equal_the_plans_estimate(kind):
    """A pool holds exactly what ``for_serve`` priced, plus one boolean
    ring flag per attention layer (shared, not per slot)."""
    from repro_torch.serve.cache_pool import make_pool
    cfg = get_reduced("qwen1_5_4b")
    plan = Planner.for_serve(cfg, 40, n_slots=3, cache_kind=kind,
                             page_size=8)
    pool = make_pool(cfg, plan, device="cpu")
    held = sum(t.nbytes for t in tree_leaves(pool.caches)
               if t.dtype != torch.bool)
    assert held == plan.est_bytes


def test_serve_planner_unported_parts_raise():
    from repro_torch.exec import MeshSpec
    cfg = get_reduced("qwen1_5_4b")
    with pytest.raises(NotImplementedError, match="sharding slice"):
        Planner.for_serve(cfg, 32, mesh=MeshSpec.parse("data=2"))
    with pytest.raises(ValueError, match="paged"):
        Planner.for_serve(get_reduced("xlstm_125m"), 32,
                          cache_kind="paged_kv")
    with pytest.raises(ValueError, match="recompute"):
        Planner.for_serve(cfg, 32, n_slots=2, decode_residency="recompute")
    with pytest.raises(KeyError, match="unknown pool cache kind"):
        Planner.for_serve(cfg, 32, cache_kind="nope")


# ---------------------------------------------------------------------------
# the engine registry and the CLI
# ---------------------------------------------------------------------------


def test_serve_pool_is_a_registered_engine():
    from repro_torch.exec.registry import NOT_PORTED
    from repro_torch.serve import ServeEngine
    assert "serve_pool" not in NOT_PORTED
    cfg = get_reduced("qwen1_5_4b")
    params = model.init_lm(torch.Generator().manual_seed(0), cfg)
    engine = build_apply((params, cfg), Planner.for_serve(cfg, 32,
                                                          n_slots=2))
    assert isinstance(engine, ServeEngine)
    assert "serve_pool" in list_engines("serve")


def test_serve_cli_on_cpu(tmp_path):
    """``python -m repro_torch.launch.serve --device cpu`` on a reduced
    arch serves, writes the reference's artefact keys, and audits its
    pool at ratio 1 under a trace."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "zamba2_7b", "--preset", "reduced", "--device", "cpu",
         "--requests", "4", "--traffic", "poisson", "--mixed-prompts",
         "--prompt-len", "32", "--gen", "4", "--cache-kind", "paged_kv",
         "--page-size", "8", "--budget-gb", "0.001", "--out",
         str(tmp_path), "--trace", str(tmp_path / "t.jsonl")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.rstrip().endswith("serve OK")
    assert "plan audit: est_bytes" in r.stdout and "ratio 1.000" in r.stdout
    rec = json.load(open(tmp_path / "zamba2-reduced_paged_kv_poisson.json"))
    assert sorted(rec) == sorted([
        "arch", "preset", "traffic", "requests", "budget_bytes", "mesh",
        "cache_kind", "prefill_residency", "decode_residency", "exec_plan",
        "exec_plan_per_device", "slo", "summary", "plan_audit"])
    assert rec["summary"]["generated_tokens"] == 16


def _main(argv):
    from repro_torch.launch import serve as cli
    return cli.main(argv)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine with no card")
def test_serve_cli_without_a_card_raises_for_cuda():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _main(["--arch", "qwen1_5_4b"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _main(["--arch", "qwen1_5_4b", "--device", "cuda"])


@pytest.mark.parametrize("argv,match", [
    (["--arch", "qwen1_5_4b", "--mesh", "data=2"], "--mesh"),
    (["--arch", "seamless_m4t_medium"], None),
    (["--arch", "llava_next_34b"], None),
])
def test_serve_cli_unported_raise(argv, match, capsys):
    """``--mesh`` still raises; the encoder-decoder and VLM archs serve
    since the slice that ported them (they raised before): frames of
    ``--prompt-len`` as the pool's ``enc_len``, patch embeddings before
    each prompt."""
    argv = argv + ["--device", "cpu", "--requests", "3", "--prompt-len",
                   "12", "--gen", "3"]
    if match:
        with pytest.raises(NotImplementedError, match=match):
            _main(argv)
        return
    _main(argv)
    out = capsys.readouterr().out
    assert out.rstrip().endswith("serve OK")
    if "seamless" in argv[1]:
        assert "enc_len=12" in out
    else:  # 16 image tokens + 12 prompt + 3 generated
        assert "max_len=31" in out
