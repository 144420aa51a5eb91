"""The port's serving subsystem — traffic, pages, the int8 codec, the cache
pools, the engine and the continuous-batching scheduler — against the JAX
package's on the CPU, and the properties of ``tests/test_serve.py``,
``tests/test_serve_pages.py`` and ``tests/test_serve_slo.py`` for the
ported families.

The reference's ``repro.serve`` imports its Planner, which needs the
``TransferToMemoryKind`` name JAX 0.9 dropped, so one child process
installs a stand-in for that name and serves the scenarios below; its
answers (token streams, ``ServeReport`` integers, slot histories, event
streams, plans, plan audits, traffic, codec and page-table traces) come
back as JSON and numpy arrays.  The stand-in never enters this process.
Both packages start from the same parameters: the reference's
``init_lm(PRNGKey(0))``, converted by ``params_from_reference`` here.

Greedy streams must be equal token for token under every cache kind and
scheduling policy.  Sampled streams cannot be: the reference draws with
threefry, the port with a ``torch.Generator`` (``sample_seed``); so the
port's logits are held at 1e-5 relative along the reference's sampled
stream, and the port's own sampled streams must show the reference's
property — independent of slot and batch.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.models.lm import encdec as ref_encdec
from repro.models.lm import model as ref_model
from repro_torch import obs
from repro_torch.configs import get_reduced
from repro_torch.exec import ExecutionPlan, Planner
from repro_torch.models.lm import model
from repro_torch.optim.adamw import tree_leaves
from repro_torch.serve import (
    CachePool, PagedCachePool, QuantCachePool, Scheduler, ServeEngine,
    make_pool, make_requests, serve,
)
from repro_torch.serve.pages import (
    PageGeometry, PageManager, dequantise, gather_pages, quantise,
    scatter_pages,
)
from repro_torch.serve.scheduler import SLO, percentile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: request specs: make_requests kwargs (+ n and the arch's vocab)
REQS = {
    "mixed": dict(n=5, seed=1, traffic="poisson", prompt_len=[8, 16],
                  max_new_tokens=(3, 6), mean_interarrival=1.5),
    "bursty": dict(n=6, seed=5, traffic="bursty", prompt_len=[8, 16],
                   max_new_tokens=(2, 5), mean_interarrival=1.0,
                   burst_size=3, priority=(0, 2)),
    "pressure": dict(n=4, seed=11, traffic="static", prompt_len=[12, 20],
                     max_new_tokens=6),
    # rids 0, 1 arrive at t=0 with low priority; 2, 3 just after with high
    # priority: in a 2-slot pool they evict an in-flight prefill
    "preempt": dict(n=4, seed=6, traffic="static", prompt_len=16,
                    max_new_tokens=3,
                    override=[[0.0, 0], [0.0, 0], [0.5, 4], [0.5, 4]]),
    "admit": dict(n=10, seed=2, traffic="static", prompt_len=[4, 8, 24],
                  max_new_tokens=4),
    "sampled": dict(n=4, seed=1, traffic="poisson", prompt_len=[8, 16],
                    max_new_tokens=(3, 6), mean_interarrival=1.5,
                    temperature=0.8, top_k=5),
    # VLM requests carry 16 patch embeddings, enc-dec ones 12 frames
    "vision": dict(n=4, seed=3, traffic="poisson", prompt_len=[8, 12],
                   max_new_tokens=(2, 5), mean_interarrival=1.5,
                   frontend="vision", n_feature_tokens=16),
    "audio": dict(n=5, seed=4, traffic="poisson", prompt_len=[6, 12],
                  max_new_tokens=(2, 5), mean_interarrival=1.5,
                  frontend="audio", n_feature_tokens=12, feature_dim=128),
}
#: name -> (arch, request spec, serve kwargs)
SCENARIOS = {
    "gemma_full": ("gemma3_4b", "mixed", dict(n_slots=2)),
    "gemma_paged": ("gemma3_4b", "mixed", dict(n_slots=2,
                                               cache_kind="paged_kv",
                                               page_size=8)),
    # three contiguous slots' bytes (prompt 24 + 4 tokens) as the budget
    "qwen_paged_budget": ("qwen1_5_4b", "admit", dict(
        budget=3 * Planner.decode_slot_bytes(get_reduced("qwen1_5_4b"), 28),
        cache_kind="paged_kv", page_size=4)),
    "qwen_full_budget": ("qwen1_5_4b", "admit", dict(
        budget=3 * Planner.decode_slot_bytes(get_reduced("qwen1_5_4b"),
                                             28))),
    "gemma_quant": ("gemma3_4b", "mixed", dict(n_slots=2,
                                               cache_kind="quant_kv")),
    "gemma_static": ("gemma3_4b", "mixed", dict(n_slots=2, mode="static")),
    "gemma_host": ("gemma3_4b", "mixed", dict(
        n_slots=3, decode_residency="host", decode_batch=2)),
    "gemma_preempt": ("gemma3_4b", "preempt", dict(
        n_slots=2, prefill_budget=100_000, preemptible_prefill=True)),
    "gemma_bursty_slo": ("gemma3_4b", "bursty", dict(
        n_slots=2, prefill_budget=100_000, preemptible_prefill=True,
        slo=dict(p50_latency=6.0, p95_latency=12.0))),
    "qwen_pressure": ("qwen1_5_4b", "pressure", dict(
        n_slots=3, cache_kind="paged_kv", page_size=4, n_pages=12)),
    "qwen_quant_host": ("qwen1_5_4b", "mixed", dict(
        n_slots=3, cache_kind="quant_kv", decode_residency="host",
        decode_batch=2)),
    "zamba_full": ("zamba2_7b", "mixed", dict(n_slots=2)),
    "zamba_paged": ("zamba2_7b", "mixed", dict(n_slots=2,
                                               cache_kind="paged_kv",
                                               page_size=8)),
    "zamba_host": ("zamba2_7b", "mixed", dict(
        n_slots=3, decode_residency="host", decode_batch=2)),
    "xlstm_full": ("xlstm_125m", "mixed", dict(n_slots=2)),
    "dsmoe_full": ("deepseek_moe_16b", "mixed", dict(n_slots=2)),
    "qwen3moe_paged": ("qwen3_moe_235b_a22b", "mixed", dict(
        n_slots=2, cache_kind="paged_kv", page_size=8)),
    "llava_full": ("llava_next_34b", "vision", dict(n_slots=2)),
    # paged: the scheduler pre-allocates pages for the image tokens too
    "llava_paged": ("llava_next_34b", "vision", dict(
        n_slots=2, cache_kind="paged_kv", page_size=8)),
    "seamless_full": ("seamless_m4t_medium", "audio", dict(n_slots=2,
                                                           enc_len=12)),
    "seamless_host": ("seamless_m4t_medium", "audio", dict(
        n_slots=3, enc_len=12, decode_residency="host", decode_batch=2)),
}
ARCHS = sorted({a for a, _, _ in SCENARIOS.values()})
#: (n, traffic, kwargs) of the traffic comparisons
TRAFFIC = [(12, "static", dict(prompt_len=(4, 40), max_new_tokens=[2, 7])),
           (12, "poisson", dict(prompt_len=[8, 16, 32], max_new_tokens=5,
                                mean_interarrival=2.5, priority=[0, 3])),
           (16, "bursty", dict(prompt_len=20, max_new_tokens=(1, 9),
                               mean_interarrival=1.5, burst_size=4,
                               temperature=0.7, top_k=3))]
#: PageManager op trace: (op, slot, tokens)
PAGE_OPS = [("alloc", 0, 6), ("alloc", 1, 16), ("grow", 0, 0),
            ("alloc", 2, 8), ("grow", 1, 0), ("free", 1, 0),
            ("alloc", 2, 4), ("grow", 2, 0), ("grow", 2, 0),
            ("alloc", 1, 11), ("free", 0, 0), ("grow", 1, 0),
            ("alloc", 0, 3), ("free", 2, 0)]

CHILD = r'''
import dataclasses, json, sys
import numpy as np
import jax, jax.memory, jax.sharding, jax.numpy as jnp
if not hasattr(jax.sharding, "TransferToMemoryKind"):
    # JAX 0.9 dropped the name repro.exec.rowprog imports; this process only
    jax.sharding.TransferToMemoryKind = lambda kind: (
        jax.memory.Space.Host if "host" in kind else jax.memory.Space.Device)
from repro import obs
from repro.configs import get_reduced
from repro.models.lm import encdec as ED
from repro.models.lm import model as LM
from repro.serve import SLO, make_requests, serve
from repro.serve.pages import PageManager, gather_pages, quantise, \
    scatter_pages

d = sys.argv[1]
spec = json.load(open(d + "/spec.json"))
out, arrays = {}, {}


def requests(arch, name):
    kw = dict(spec["reqs"][name])
    n = kw.pop("n")
    over = kw.pop("override", None)
    for k in ("prompt_len", "max_new_tokens", "priority"):
        if isinstance(kw.get(k), list) and kw.pop("_tuple_" + k, False):
            kw[k] = tuple(kw[k])
    reqs = make_requests(n, get_reduced(arch).vocab, **kw)
    if over:
        reqs = [dataclasses.replace(r, arrival=a, priority=p)
                for r, (a, p) in zip(reqs, over)]
    return reqs


params = {a: (ED.init_encdec if get_reduced(a).family == "encdec"
              else LM.init_lm)(jax.random.PRNGKey(0), get_reduced(a))
          for a in spec["archs"]}
for name, (arch, rname, kw) in spec["scenarios"].items():
    cfg = get_reduced(arch)
    # host decode residency fails here (JAX 0.9 gathers a host-memory
    # pool with a device index); the same cohorts on the device instead
    kw = {k: v for k, v in kw.items() if k != "decode_residency"}
    if "slo" in kw:
        kw["slo"] = SLO(**kw["slo"])
    with obs.capture():
        rep, plan = serve(params[arch], cfg, requests(arch, rname), **kw)
    out[name] = {"tokens": {str(s.rid): list(map(int, s.generated))
                            for s in rep.states},
                 "summary": rep.summary(), "events": rep.events,
                 "slot_history": {str(k): v
                                  for k, v in rep.slot_history.items()},
                 "chunks": [s.prefill_chunks for s in rep.states],
                 "plan": plan.to_dict(), "audit": rep.plan_audit}

# logits along the sampled stream of one request (teacher forced)
cfg = get_reduced("gemma3_4b")
r = requests("gemma3_4b", "sampled")[0]
rep, _ = serve(params["gemma3_4b"], cfg, [r], n_slots=1)
stream = list(map(int, rep.tokens(r.rid)))
logits, caches = LM.lm_prefill(params["gemma3_4b"],
                               {"tokens": jnp.asarray(r.prompt[None])}, cfg,
                               r.prompt_len + r.max_new_tokens)
rows = [np.asarray(logits[0, -1])]
for tok in stream[:-1]:
    logits, caches = LM.lm_decode(params["gemma3_4b"],
                                  jnp.asarray([[tok]], jnp.int32), caches,
                                  cfg)
    rows.append(np.asarray(logits[0, -1]))
out["sampled_stream"] = stream
arrays["sampled_logits"] = np.stack(rows)

# traffic, field for field
for i, (n, traffic, kw) in enumerate(spec["traffic"]):
    kw = {k: tuple(v) if k in spec["tuples"][i] else v
          for k, v in kw.items()}
    for j, q in enumerate(make_requests(n, 512, seed=3, traffic=traffic,
                                        **kw)):
        out[f"traffic|{i}|{j}"] = dict(
            rid=q.rid, max_new_tokens=q.max_new_tokens, arrival=q.arrival,
            temperature=q.temperature, top_k=q.top_k, seed=q.seed,
            priority=q.priority)
        arrays[f"traffic|{i}|{j}"] = q.prompt

# the int8 codec
x = np.load(d + "/codec.npy")
q, s = quantise(jnp.asarray(x))
arrays["codec_q"], arrays["codec_s"] = np.asarray(q), np.asarray(s)

# page tables along an op trace, then a gather/scatter round trip
pm = PageManager(n_pages=10, page_size=4, n_slots=3, max_len=20)
trace = []
for op, slot, n in spec["page_ops"]:
    got = pm.alloc(slot, n) if op == "alloc" else \
        pm.grow(slot) if op == "grow" else pm.free(slot)
    trace.append({"got": got, "table": pm.table.tolist(),
                  "owner": pm.owner.tolist(), "free": list(pm._free),
                  "seq_len": pm.seq_len.tolist()})
out["page_trace"] = trace
pages = jnp.asarray(np.load(d + "/pages.npy"))
dense = gather_pages(pages, jnp.asarray(pm.table), max_len=18)
arrays["gathered"] = np.asarray(dense)
arrays["scattered"] = np.asarray(scatter_pages(
    jnp.zeros_like(pages), jnp.asarray(pm.table), dense * 2 + 1))

json.dump(out, open(d + "/ref.json", "w"))
np.savez(d + "/ref.npz", **arrays)
'''


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _codec_input():
    x = np.random.default_rng(12).standard_normal((3, 7, 2, 16)) * 3
    x[0, 1] = 0.0                      # all-zero rows quantise to (0, 0)
    x[1, 2, 0, 5] = 127.5 / 40         # ties land on .5 after the divide
    return x.astype(np.float32)


def _pages_input():
    return np.random.default_rng(13).standard_normal(
        (2, 10, 4, 3)).astype(np.float32)


def _tuples(kw):
    return [k for k, v in kw.items() if isinstance(v, tuple)]


@pytest.fixture(scope="module", autouse=True)
def _reference_child(tmp_path_factory):
    """Start the reference child with the module's first test, so that it
    works while the in-process tests run; ``reference`` waits for it."""
    d = tmp_path_factory.mktemp("ref_serve")
    reqs = {}
    for name, kw in REQS.items():
        kw = dict(kw)
        for k in _tuples(kw):
            kw[k] = list(kw[k])
            kw["_tuple_" + k] = True
        reqs[name] = kw
    np.save(d / "codec.npy", _codec_input())
    np.save(d / "pages.npy", _pages_input())
    (d / "spec.json").write_text(json.dumps(dict(
        archs=ARCHS, reqs=reqs, scenarios=SCENARIOS,
        traffic=TRAFFIC, tuples=[_tuples(kw) for _, _, kw in TRAFFIC],
        page_ops=PAGE_OPS)))
    child = subprocess.Popen(
        [sys.executable, "-c", CHILD, str(d)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        yield child, d
    finally:
        child.kill()
        child.wait()


@pytest.fixture(scope="module")
def reference(_reference_child):
    child, d = _reference_child
    _, err = child.communicate(timeout=900)
    assert child.returncode == 0, err[-4000:]
    return json.load(open(d / "ref.json")), dict(np.load(d / "ref.npz"))


_PARAMS = {}


def _params(arch):
    """The reference's init_lm(PRNGKey(0)) parameters (init_encdec's for
    the encoder-decoder), as torch tensors."""
    if arch not in _PARAMS:
        rcfg = ref_get_reduced(arch)
        init = ref_encdec.init_encdec if rcfg.family == "encdec" \
            else ref_model.init_lm
        _PARAMS[arch] = model.params_from_reference(
            init(jax.random.PRNGKey(0), rcfg), "cpu")
    return _PARAMS[arch]


def _requests(arch, name):
    kw = dict(REQS[name])
    n = kw.pop("n")
    over = kw.pop("override", None)
    reqs = make_requests(n, get_reduced(arch).vocab, **kw)
    if over:
        reqs = [dataclasses.replace(r, arrival=a, priority=p)
                for r, (a, p) in zip(reqs, over)]
    return reqs


def _serve(arch, reqs, **kw):
    if isinstance(kw.get("slo"), dict):
        kw["slo"] = SLO(**kw["slo"])
    return serve(_params(arch), get_reduced(arch), reqs, **kw)


def _tokens(rep):
    return {str(s.rid): list(s.generated) for s in rep.states}


# ---------------------------------------------------------------------------
# traffic, the codec and page bookkeeping against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("i", range(len(TRAFFIC)))
def test_make_requests_equal_reference(reference, i):
    ref, arrays = reference
    n, traffic, kw = TRAFFIC[i]
    for j, q in enumerate(make_requests(n, 512, seed=3, traffic=traffic,
                                        **kw)):
        assert dict(rid=q.rid, max_new_tokens=q.max_new_tokens,
                    arrival=q.arrival, temperature=q.temperature,
                    top_k=q.top_k, seed=q.seed, priority=q.priority) \
            == ref[f"traffic|{i}|{j}"]
        assert np.array_equal(q.prompt, arrays[f"traffic|{i}|{j}"])
        assert q.prompt.dtype == np.int32


def test_unknown_traffic_rejected():
    with pytest.raises(ValueError, match="unknown traffic"):
        make_requests(2, 64, traffic="weird")


def test_quantise_codes_equal_reference_bit_for_bit(reference):
    _, arrays = reference
    q, s = quantise(torch.from_numpy(_codec_input()))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), arrays["codec_q"])
    assert np.array_equal(s.numpy(), arrays["codec_s"])
    back = dequantise(q, s, dtype="float32")
    err = np.abs(back.numpy() - _codec_input()).max(axis=-1)
    assert np.all(err <= s.numpy() / 2 + 1e-6)
    assert not back[0, 1].any()


def test_page_manager_trace_equals_reference(reference):
    ref, arrays = reference
    pm = PageManager(n_pages=10, page_size=4, n_slots=3, max_len=20)
    for (op, slot, n), want in zip(PAGE_OPS, ref["page_trace"]):
        got = pm.alloc(slot, n) if op == "alloc" else \
            pm.grow(slot) if op == "grow" else pm.free(slot)
        assert {"got": got, "table": pm.table.tolist(),
                "owner": pm.owner.tolist(), "free": list(pm._free),
                "seq_len": pm.seq_len.tolist()} == want, (op, slot, n)
        pm.check()
    pages = torch.from_numpy(_pages_input())
    dense = gather_pages(pages, pm.table, max_len=18)
    assert np.array_equal(dense.numpy(), arrays["gathered"])
    out = scatter_pages(torch.zeros_like(pages), pm.table, dense * 2 + 1)
    assert np.array_equal(out.numpy(), arrays["scattered"])


def test_page_manager_invariants_under_random_ops():
    rng = np.random.default_rng(0)
    pm = PageManager(n_pages=12, page_size=3, n_slots=4, max_len=20)
    for _ in range(300):
        slot = int(rng.integers(4))
        op = rng.integers(3)
        if op == 0:
            got = pm.alloc(slot, int(rng.integers(1, 21)))
            assert got is None or all(pm.owner[p] == slot for p in got)
        elif op == 1:
            pm.grow(slot)
        else:
            pm.free(slot)
        pm.check()
        assert pm.n_free + sum(len(pm.pages_of(s)) for s in range(4)) == 12
    with pytest.raises(ValueError):
        PageGeometry(0, 4, 4)


# ---------------------------------------------------------------------------
# served scenarios against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_serve_scenario_equals_reference(reference, name):
    """Greedy token streams, every ``ServeReport.summary()`` field, the
    slot history, the tick-by-tick event stream, each prompt's prefill
    chunks, the pool plan and the pool's plan audit equal the
    reference's."""
    ref, _ = reference
    want = ref[name]
    arch, rname, kw = SCENARIOS[name]
    with obs.capture():
        rep, plan = _serve(arch, _requests(arch, rname), **dict(kw))
    assert _tokens(rep) == want["tokens"]
    got = rep.summary()
    if kw.get("decode_residency") == "host":
        # held against the reference's same cohorts on the device (the
        # child's note); the port's prefetch stashes serve every cohort
        # after the first, and its pool holds the plan's host bytes
        assert got.pop("prefetch_hits") > 0
        want = dict(want, summary={k: v for k, v in want["summary"].items()
                                   if k != "prefetch_hits"})
        assert plan.residency.default == "host"
        audit = rep.plan_audit
        assert audit["audited_term"] == "host_bytes"
        assert 0.95 <= audit["ratio"] <= 1.10
        assert got == want["summary"]
        assert {str(k): v for k, v in rep.slot_history.items()} \
            == want["slot_history"]
        assert json.loads(json.dumps(rep.events)) == want["events"]
        return
    assert got == want["summary"]
    assert {str(k): v for k, v in rep.slot_history.items()} \
        == want["slot_history"]
    assert json.loads(json.dumps(rep.events)) == want["events"]
    assert [s.prefill_chunks for s in rep.states] == want["chunks"]
    assert plan.to_dict() == want["plan"]
    audit = json.loads(json.dumps(rep.plan_audit))
    assert audit == want["audit"]
    assert 0.95 <= audit["ratio"] <= 1.10


def test_cache_kinds_and_policies_keep_full_pool_tokens(reference):
    """Within the reference's own answers and the port's: paged, quantised
    (at these widths), static, host residency and preemptible prefill
    leave every greedy stream as the contiguous pool's."""
    ref, _ = reference
    base = ref["gemma_full"]["tokens"]
    for name in ("gemma_paged", "gemma_static", "gemma_host"):
        assert ref[name]["tokens"] == base, name
    assert ref["qwen_paged_budget"]["tokens"] \
        == ref["qwen_full_budget"]["tokens"]
    assert ref["zamba_paged"]["tokens"] == ref["zamba_full"]["tokens"] \
        == ref["zamba_host"]["tokens"]
    assert ref["seamless_host"]["tokens"] == ref["seamless_full"]["tokens"]
    assert ref["llava_paged"]["tokens"] == ref["llava_full"]["tokens"]


def test_paged_pool_admits_more_at_one_budget(reference):
    ref, _ = reference
    paged, full = ref["qwen_paged_budget"], ref["qwen_full_budget"]
    assert paged["plan"]["n_rows"] > full["plan"]["n_rows"]
    assert paged["summary"]["max_active"] > full["summary"]["max_active"]


def test_preemption_and_prefetch_happened(reference):
    ref, _ = reference
    assert ref["qwen_pressure"]["summary"]["preemptions"] >= 1
    assert ref["gemma_preempt"]["summary"]["preemptions"] >= 1
    assert all(c > 1 for c in ref["gemma_preempt"]["chunks"])
    assert "slo" in ref["gemma_bursty_slo"]["summary"]


def test_sampled_logits_follow_reference_stream(reference):
    """The port's logits along the reference's sampled stream (its tokens
    fed back one by one) equal the reference's at 1e-5 relative."""
    ref, arrays = reference
    cfg = get_reduced("gemma3_4b")
    r = _requests("gemma3_4b", "sampled")[0]
    p = _params("gemma3_4b")
    with torch.no_grad():
        lg, c = model.lm_prefill(p, {"tokens": torch.from_numpy(
            r.prompt[None].astype(np.int64))}, cfg,
            r.prompt_len + r.max_new_tokens)
        rows = [lg[0, -1]]
        for tok in ref["sampled_stream"][:-1]:
            lg, c = model.lm_decode(p, torch.tensor([[tok]]), c, cfg)
            rows.append(lg[0, -1])
    got = torch.stack(rows).numpy()
    want = arrays["sampled_logits"]
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# properties of the port's own runs
# ---------------------------------------------------------------------------


def test_sampled_decode_is_batching_invariant():
    """Temperature/top-k tokens depend on (request seed, step) only:
    identical whether requests share the pool or run alone, and the draw
    differs from greedy somewhere."""
    reqs = _requests("gemma3_4b", "sampled")
    pooled, _ = _serve("gemma3_4b", reqs, n_slots=3)
    alone, _ = _serve("gemma3_4b", reqs, n_slots=1)
    assert _tokens(pooled) == _tokens(alone)
    greedy, _ = _serve("gemma3_4b", [dataclasses.replace(r, temperature=0.0)
                                     for r in reqs], n_slots=3)
    assert _tokens(greedy) != _tokens(pooled)
    vocab = get_reduced("gemma3_4b").vocab
    assert all(0 <= t < vocab for ts in _tokens(pooled).values()
               for t in ts)


def test_sample_raises_on_non_finite_logits():
    cfg = get_reduced("qwen1_5_4b")
    engine = ServeEngine(_params("qwen1_5_4b"), cfg,
                         Planner.for_serve(cfg, 32, n_slots=1))
    req = _requests("qwen1_5_4b", "mixed")[0]
    row = torch.zeros(cfg.vocab)
    row[3] = float("nan")
    with pytest.raises(FloatingPointError, match="non-finite"):
        engine.sample(row, req, 0)
    with pytest.raises(FloatingPointError, match="non-finite"):
        engine.sample(row, dataclasses.replace(req, temperature=0.5), 0)


def test_budget_chunked_prefill_is_exact():
    cfg = get_reduced("qwen1_5_4b")
    reqs = make_requests(3, cfg.vocab, seed=2, prompt_len=32,
                         max_new_tokens=4)
    free, _ = _serve("qwen1_5_4b", reqs, n_slots=2)
    budget = Planner.seq_estimate(32, cfg.d_model, 1, 4, cfg.d_ff) + 1
    tight, _ = _serve("qwen1_5_4b", reqs, n_slots=2, prefill_budget=budget)
    assert all(st.prefill_chunks > 1 for st in tight.states)
    assert _tokens(tight) == _tokens(free)


def test_slots_are_reused_and_freed():
    cfg = get_reduced("qwen1_5_4b")
    reqs = make_requests(5, cfg.vocab, seed=4, prompt_len=16,
                         max_new_tokens=(2, 5))
    plan = Planner.for_serve(cfg, 16 + 5, n_slots=2)
    pool = CachePool(cfg, plan, device="cpu")
    report = Scheduler(ServeEngine(_params("qwen1_5_4b"), cfg, plan), pool,
                       reqs).run()
    served = sorted(r for h in report.slot_history.values() for r in h)
    assert served == [r.rid for r in reqs]
    assert all(len(h) >= 2 for h in report.slot_history.values())
    assert pool.n_free == pool.n_slots and pool.owner == [-1, -1]


@pytest.mark.parametrize("kind", ["full", "paged_kv", "quant_kv"])
def test_slot_recycling_resets_state(kind):
    """Several requests back to back through ONE slot decode exactly like
    each alone in a fresh pool — impossible if a recycled slot leaked its
    predecessor's state or pages."""
    cfg = get_reduced("zamba2_7b")
    reqs = make_requests(3, cfg.vocab, seed=7, prompt_len=(10, 18),
                         max_new_tokens=4)
    rep, _ = _serve("zamba2_7b", reqs, n_slots=1, cache_kind=kind,
                    page_size=4)
    assert rep.slot_history[0] == [0, 1, 2]
    for r in reqs:
        alone, _ = _serve("zamba2_7b", [r], n_slots=1, cache_kind=kind,
                          page_size=4)
        assert rep.tokens(r.rid) == alone.tokens(r.rid), r.rid


@pytest.mark.parametrize("kind", ["full", "paged_kv", "quant_kv"])
def test_release_zeroes_slot_state(kind):
    """release() zeroes the freed slot's slices (and a paged slot's freed
    pages): stale state is unreadable by design."""
    cfg = get_reduced("zamba2_7b")
    plan = Planner.for_serve(cfg, 24, n_slots=2, cache_kind=kind,
                             page_size=4)
    engine = ServeEngine(_params("zamba2_7b"), cfg, plan)
    pool = make_pool(cfg, plan, device="cpu")
    req = make_requests(1, cfg.vocab, seed=3, prompt_len=16,
                        max_new_tokens=4)[0]
    slot = pool.acquire(req.rid, seq_len=req.prompt_len)
    _, cache, _ = engine.prefill(req)
    pool.write(slot, cache)
    assert any(t.any() for t in tree_leaves(pool.caches))
    pool.release(slot)
    for leaf, ax in zip(tree_leaves(pool.caches), pool._axes):
        if ax >= 0:
            assert not leaf.select(ax, slot).any()
    if kind == "paged_kv":
        assert pool.pages.n_free == pool.pages.geom.n_pages
        for kind_, (c,) in pool._groups(pool.caches):
            if pool._is_paged(kind_):
                assert not c["k"].any() and not c["v"].any()


def test_make_pool_dispatch_and_guards():
    cfg = get_reduced("qwen1_5_4b")
    plan = Planner.for_serve(cfg, 16, n_slots=1, cache_kind="paged_kv",
                             page_size=8)
    assert isinstance(make_pool(cfg, plan, device="cpu"), PagedCachePool)
    with pytest.raises(ValueError, match="make_pool"):
        CachePool(cfg, plan, device="cpu")
    qplan = Planner.for_serve(cfg, 16, n_slots=1, cache_kind="quant_kv")
    assert isinstance(make_pool(cfg, qplan, device="cpu"), QuantCachePool)
    with pytest.raises(KeyError, match="register_pool_kind"):
        make_pool(cfg, plan.with_extras(cache_kind="nope"), device="cpu")


def test_host_residency_plan_accounting():
    cfg = get_reduced("qwen1_5_4b")
    full = Planner.for_serve(cfg, 32, n_slots=4)
    host = Planner.for_serve(cfg, 32, n_slots=4, decode_residency="host",
                             decode_batch=1)
    assert host.get("host_bytes") == full.est_bytes_per_device
    assert host.est_bytes_per_device < full.est_bytes_per_device
    back = ExecutionPlan.from_json(host.to_json())
    assert back == host and back.residency.default == "host"


def test_slo_accounting_and_percentile():
    assert percentile([], 0.5) == 0.0
    assert percentile([5.0], 0.95) == 5.0
    assert percentile([1, 2, 3, 4], 0.5) == 3
    assert percentile(list(range(1, 101)), 0.95) == 95
    slo = SLO(p50_latency=3, p95_latency=5)
    chk = slo.check([1, 2, 3, 10], [0, 1, 1, 2])
    assert chk["met"] == {"p50_latency": True, "p95_latency": False}
    assert chk["attainment"] == 0.75
