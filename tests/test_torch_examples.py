"""The port's examples (``examples/torch_*.py``) against the JAX package's
on the CPU, section by section.

The reference side is built from ``repro``'s own functions, as the
reference scripts build it; no reference script's ``main`` runs (each
takes minutes).  Both sides start from the same weights (numpy for the
CNN sections, the reference's ``PRNGKey(0)`` init for the LMs, carried by
``params_from_reference``) and the same inputs (numpy, from a seed).  The
reference's ``repro.exec`` and ``repro.serve`` need the
``TransferToMemoryKind`` name JAX 0.9 dropped, so three child processes
install a stand-in for it: one makes the large-image example's costed
768² solve (the reference's solver takes ~40 s there), one the CNN
sections, one serving and the LM.  All start with the module's first
test and work while the port's side runs here; a test runs the port
first and then waits for its child.  Integers and plan JSON must be
equal; a forward within 1e-5 relative; losses within ``1e-5 * 10**step``
relative, as in
``tests/test_torch_train.py::test_three_step_trajectory_matches_reference``.
"""

import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import store as ref_store
from repro.configs import get_reduced as ref_get_reduced
from repro.core import rowplan as ref_rowplan
from repro.models.cnn import layers as ref_layers
from repro.models.cnn.vgg import vgg16_modules as ref_vgg16_modules
from repro.models.lm import model as ref_model
from repro.models.lm.config import ModelConfig as RefModelConfig
from repro_torch.configs import get_reduced
from repro_torch.exec import CostTable
from repro_torch.models.cnn.layers import params_from_reference
from repro_torch.models.cnn.vgg import vgg16_modules
from repro_torch.models.lm import model
from repro_torch.models.lm.config import ModelConfig
from repro_torch.obs.audit import trace_step
from repro_torch.optim.adamw import tree_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("torch_quickstart", "torch_large_image_cnn",
            "torch_serve_batched", "torch_train_lm_100m")

#: the cost table both sides' costed solves are given
TABLE = {"schema": 1, "fingerprint": "test:fixed:x1", "dtype": "float32",
         "flops_per_s": 2.5e13, "h2d_bytes_per_s": 2.0e10,
         "d2h_bytes_per_s": 1.5e10, "row_overhead_us": 35.0,
         "ratios": [], "sources": ["calibrate"]}
#: the large-image training step's smaller scenario: at 192², batch 2, a
#: 5.5 MiB budget rejects every device-resident plan (the best, 2PS N=8,
#: needs 6.4 MiB) and admits 2PS N=8 with its caches on the host
SMALL_H, SMALL_BUDGET = 192, int(5.5 * 2**20)
#: the quickstart's input and the small large-image batch: numpy seeds
QS_SEED, LI_SEED = 7, 11
#: a narrowed dense LM for the 100M example's trajectory
LM_NARROW = dict(name="dense-narrow", family="dense", n_layers=2,
                 d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
                 tie_embeddings=True, dtype="float32", row_chunks=4,
                 remat="rows")
LM_STEPS, LM_BATCH, LM_SEQ = 3, 2, 32
QS_STEPS = 3
#: the weights both sides start from: numpy He init for the CNN sections
#: (the quickstart's 64², 10 classes; the large-image step's, 4 classes),
#: the reference's init for the LMs
CNN_WEIGHTS = {"qs": ((64, 64, 3), 10), "small": ((SMALL_H, SMALL_H, 3), 4)}
LM_CONFIGS = {"gemma": lambda: ref_get_reduced("gemma3_4b"),
              "narrow": lambda: RefModelConfig(**LM_NARROW)}

_STANDIN = r'''
import json, sys
import numpy as np
import jax, jax.memory, jax.sharding, jax.numpy as jnp
if not hasattr(jax.sharding, "TransferToMemoryKind"):
    # JAX 0.9 dropped the name repro.exec.rowprog imports; this process only
    jax.sharding.TransferToMemoryKind = lambda kind: (
        jax.memory.Space.Host if "host" in kind else jax.memory.Space.Device)
from repro.exec import CostTable, ExecutionPlan, Planner, ResidencySpec
from repro.models.cnn.vgg import vgg16_modules
d, part = sys.argv[1:3]
spec = json.load(open(d + "/spec.json"))
table = CostTable.from_dict(spec["table"])
mods = vgg16_modules(width_mult=0.25, n_stages=3)
out = {}


def device_only(name, h, budget):
    dev = Planner.for_budget(mods, (h, h, 3), 2, budget,
                             residency=ResidencySpec())
    out[name + "|device_only"] = dev.to_json()


def costed(name, h, budget):
    plan = Planner.for_budget(mods, (h, h, 3), 2, budget, cost_table=table)
    replayed = ExecutionPlan.from_json(plan.to_json())
    out[name + "|plan"] = plan.to_json()
    out[name + "|replayed"] = replayed.to_json()
    return replayed
'''

#: the large-image example's costed solve at 768², 28 MiB (~40 s alone)
COSTED_CHILD = _STANDIN + r'''
costed("large", 768, 28 * 2**20)
'''

#: the quickstart, then the large-image example's device-only solve at
#: 768² and its smaller scenario
CNN_CHILD = _STANDIN + r'''
from repro.core.rowplan import estimate_bytes
from repro.data.pipeline import ImageDataset, ImageDatasetConfig
from repro.exec import build_apply
from repro.models.cnn.vgg import head_apply
from repro.optim.adamw import SGDConfig, sgd_init, sgd_update


def cnn_params(name):
    """The test's numpy weights, in the reference's tree layout."""
    w = np.load(f"{d}/{name}.npz")
    n = len(mods)
    return {"trunk": tuple({k: jnp.asarray(w[f"trunk/{i}/{k}"])
                            for k in ("w", "b") if f"trunk/{i}/w" in w}
                           for i in range(n)),
            "head": {k: jnp.asarray(w[f"head/{k}"]) for k in ("w", "b")}}


def sgd_step(trunk, lr=0.05):
    cfg = SGDConfig(lr=lr)

    @jax.jit
    def step(p, opt, images, labels):
        def loss_fn(p):
            logits = head_apply(p["head"], trunk(p["trunk"], images))
            logp = jax.nn.log_softmax(logits)
            return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], 1))
        loss, g = jax.value_and_grad(loss_fn)(p)
        p, opt, _ = sgd_update(p, g, opt, cfg)
        return p, opt, loss
    return step


# the quickstart: planning, the base forward, SGD through 2PS
shape = (64, 64, 3)
qmods, params = mods, cnn_params("qs")
plan = Planner.for_budget(qmods, shape, 8, 10 * 2**20)
out["qs_plan"] = plan.to_json()
out["qs_omega"] = [estimate_bytes(qmods, shape, 8, s,
                                  max(2, plan.n_rows) if s != "base" else 1)
                   for s in ("base", "twophase", "overlap")]
x = np.random.default_rng(spec["qs_seed"]).standard_normal(
    (8,) + shape).astype(np.float32)
base = build_apply(qmods, ExecutionPlan.explicit("base", 1, shape))
out["qs_base"] = np.asarray(base(params["trunk"], jnp.asarray(x))).tolist()
tps = build_apply(qmods, ExecutionPlan.explicit(
    "twophase", max(2, plan.n_rows), shape))
step = sgd_step(tps)
opt = sgd_init(params)
ds = ImageDataset(ImageDatasetConfig(h=64, w=64, batch=8))
losses = []
for i in range(spec["qs_steps"]):
    b = ds.batch_at(i)
    params, opt, loss = step(params, opt, jnp.asarray(b["images"]),
                             jnp.asarray(b["labels"]))
    losses.append(float(loss))
out["qs_losses"] = losses

# the large-image example: its device-only solve, then at a smaller
# height its solves and one step
device_only("large", 768, 28 * 2**20)
h = spec["small_h"]
device_only("small", h, spec["small_budget"])
plan = costed("small", h, spec["small_budget"])
params = cnn_params("small")
x = np.random.default_rng(spec["li_seed"]).standard_normal(
    (2, h, h, 3)).astype(np.float32)
_, _, loss = sgd_step(build_apply(mods, plan))(
    params, sgd_init(params), jnp.asarray(x), jnp.array([0, 1]))
out["small_loss"] = float(loss)
'''

#: serving and the 100M example's trajectory
LM_CHILD = _STANDIN + r'''
from repro.configs import get_reduced
from repro.data.pipeline import TokenDataset, TokenDatasetConfig
from repro.launch.steps import make_train_step
from repro.models.lm import model as LM
from repro.models.lm.config import ModelConfig
from repro.optim.adamw import AdamWConfig, adamw_init
from repro.serve import make_requests, serve


def lm_params(name, cfg):
    """The test's weights (the reference's init, made there), leaf for
    leaf in the reference's order."""
    w = np.load(f"{d}/{name}.npz")
    shapes = jax.eval_shape(lambda: LM.init_lm(jax.random.PRNGKey(0), cfg))
    return jax.tree.unflatten(jax.tree.structure(shapes),
                              [jnp.asarray(w[str(i)])
                               for i in range(len(w.files))])


# serving: the example's traffic and budget
cfg = get_reduced("gemma3_4b")
reqs = make_requests(8, cfg.vocab, seed=0, traffic="poisson",
                     prompt_len=(16, 32, 48), max_new_tokens=(8, 24),
                     mean_interarrival=2.0)
max_len = max(r.prompt_len + r.max_new_tokens for r in reqs)
budget = int(3.5 * Planner.decode_slot_bytes(cfg, max_len))
rep, plan = serve(lm_params("gemma", cfg), cfg, reqs, budget=budget)
s = rep.summary()
out["serve"] = {"budget": budget, "plan": plan.to_json(),
                "tokens": {str(st.rid): list(map(int, st.generated))
                           for st in rep.states},
                "slots": {str(st.rid): st.slot for st in rep.states},
                "slot_history": {str(k): v
                                 for k, v in rep.slot_history.items()},
                "decode_steps": s["decode_steps"],
                "max_active": s["max_active"]}

# the 100M example's trajectory on a narrowed config
cfg = ModelConfig(**spec["lm_cfg"])
params = lm_params("narrow", cfg)
state = {"params": params, "opt": adamw_init(params)}
step_fn = jax.jit(make_train_step(cfg, AdamWConfig(lr=1e-3)),
                  donate_argnums=(0,))
ds = TokenDataset(TokenDatasetConfig(vocab=cfg.vocab,
                                     seq_len=spec["lm_seq"],
                                     batch=spec["lm_batch"], seed=0,
                                     n_gram=1, noise_p=0.05))
losses = []
for i in range(spec["lm_steps"]):
    hb = ds.batch_at(i)
    state, m = step_fn(state, {"tokens": jnp.asarray(hb["tokens"]),
                               "labels": jnp.asarray(hb["labels"])})
    losses.append(float(m["loss"]))
out["lm_losses"] = losses
'''
_DUMP = '''json.dump(out, open(f"{d}/{part}.json", "w"))
'''
CHILDREN = {"costed": COSTED_CHILD + _DUMP, "cnn": CNN_CHILD + _DUMP,
            "lm": LM_CHILD + _DUMP}


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def _reference_children(tmp_path_factory):
    """Write the weights both sides start from and start the reference
    children with the module's first test, so that they work while the
    port's side runs (the LM child once its weights exist)."""
    d = tmp_path_factory.mktemp("ref_examples")
    (d / "spec.json").write_text(json.dumps(dict(
        table=TABLE, small_h=SMALL_H, small_budget=SMALL_BUDGET,
        qs_seed=QS_SEED, li_seed=LI_SEED, qs_steps=QS_STEPS,
        lm_cfg=LM_NARROW, lm_steps=LM_STEPS, lm_batch=LM_BATCH,
        lm_seq=LM_SEQ)))
    for name, (shape, n_classes) in CNN_WEIGHTS.items():
        tree = _cnn_tree(shape, n_classes)
        np.savez(d / f"{name}.npz",
                 **{f"trunk/{i}/{k}": v for i, p in enumerate(tree["trunk"])
                    for k, v in p.items()},
                 **{f"head/{k}": v for k, v in tree["head"].items()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")

    def start(part):
        return subprocess.Popen(
            [sys.executable, "-c", CHILDREN[part], str(d), part], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)

    children = {}
    try:
        children["costed"], children["cnn"] = start("costed"), start("cnn")
        for name in LM_CONFIGS:
            np.savez(d / f"{name}.npz", **{
                str(i): a for i, a in enumerate(jax.tree.leaves(
                    _lm_tree(name)))})
        children["lm"] = start("lm")
        yield children, d
    finally:
        for child in children.values():
            child.kill()
            child.wait()


@pytest.fixture(scope="module")
def reference(_reference_children):
    """``reference(part)`` waits for that child (once) and returns its
    answers: a test computes the port's side first."""
    children, d = _reference_children
    done = {}

    def wait(part):
        if part not in done:
            _, err = children[part].communicate(timeout=600)
            assert children[part].returncode == 0, err[-4000:]
            done[part] = json.load(open(d / f"{part}.json"))
        return done[part]
    return wait


_MODULES = {}


def _example(name):
    """An example script as a module (they are scripts, not a package)."""
    if name not in _MODULES:
        spec = importlib.util.spec_from_file_location(
            f"_example_{name}", ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[name] = mod
    return _MODULES[name]


def _rel(a, b):
    return abs(a - b) / abs(b)


def _cnn_tree(shape, n_classes, seed=0):
    """He-initialised numpy weights of the examples' trunk (VGG-16 ×0.25,
    3 stages) and head, in the reference's tree layout."""
    rng = np.random.default_rng(seed)
    trunk = []
    for m in ref_vgg16_modules(width_mult=0.25, n_stages=3):
        p = {}
        if isinstance(m, ref_layers.Conv):
            fan_in = m.k * m.k * shape[2]
            p["w"] = (rng.normal(size=(m.k, m.k, shape[2], m.cout))
                      * np.sqrt(2.0 / fan_in)).astype(np.float32)
            p["b"] = np.zeros(m.cout, np.float32)
        trunk.append(p)
        shape = m.out_shape(shape)
    head = {"w": (rng.normal(size=(shape[2], n_classes))
                  / np.sqrt(shape[2])).astype(np.float32),
            "b": np.zeros(n_classes, np.float32)}
    return {"trunk": tuple(trunk), "head": head}


def _cnn_params(shape, n_classes):
    return params_from_reference(_cnn_tree(shape, n_classes), "cpu")


_LM_TREES = {}


def _lm_tree(name):
    """The reference's ``init_lm(PRNGKey(0))`` of a config, as numpy (one
    jitted compile instead of an eager one per leaf)."""
    if name not in _LM_TREES:
        cfg = LM_CONFIGS[name]()
        _LM_TREES[name] = jax.tree.map(np.asarray, jax.jit(
            lambda k: ref_model.init_lm(k, cfg))(jax.random.PRNGKey(0)))
    return _LM_TREES[name]


# ---------------------------------------------------------------------------
# what needs no reference child: these run while the children work
# ---------------------------------------------------------------------------


def _quickstart():
    Q = _example("torch_quickstart")
    mods = vgg16_modules(0.25, 3)
    plan, omegas = Q.planning(mods)
    x = np.random.default_rng(QS_SEED).standard_normal(
        (Q.BATCH,) + Q.SHAPE).astype(np.float32)
    return Q, mods, plan, omegas, torch.from_numpy(x)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_raises_without_a_card(name, monkeypatch):
    """(i) ``--device`` defaults to ``cuda``; with no card the script
    raises before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main([])


@pytest.mark.parametrize("engine", ["base", "overlap N=4", "2PS"])
def test_quickstart_meta_trace_equals_cpu_trace(engine, capsys):
    """(d) The memory section's temporaries, traced on ``meta`` copies,
    equal the same trace on the CPU tensors."""
    Q, mods, plan, _, x = _quickstart()
    params = _cnn_params(Q.SHAPE, 10)
    trunks = Q.engines(mods, plan)
    tb, peak = Q.memory({engine: trunks[engine]}, params, x)[engine]
    assert peak is None  # no memory measurement on the CPU
    cpu = trace_step(Q.grad_step(trunks[engine]), params, x)
    assert cpu["temp_size_in_bytes"] == tb > 0
    assert f"traced temp bytes [{engine:12s}]" in capsys.readouterr().out


def test_large_image_table_equals_reference():
    """(e) The feasibility table's integers at all five heights."""
    L = _example("torch_large_image_cnn")
    rows = L.feasibility()
    assert sorted(rows) == sorted(L.HEIGHTS)
    mods = ref_vgg16_modules(width_mult=0.25, n_stages=3)
    for h, (base, r2, ro) in rows.items():
        shape = (h, h, 3)
        assert base == ref_rowplan.omega_column(mods, shape, L.BATCH)
        for got, strategy in ((r2, "twophase"), (ro, "overlap")):
            want = ref_rowplan.solve_n(mods, shape, L.BATCH, L.BUDGET,
                                       strategy)
            assert (got.n_rows, got.est_bytes, got.feasible) \
                == (want.n_rows, want.est_bytes, want.feasible)


def test_train_lm_100m_config_is_the_reference_dense_100m():
    """The default model is the reference's ``dense-100m``, field for
    field; ``--arch`` replaces an assigned config as the reference does."""
    T = _example("torch_train_lm_100m")
    want = RefModelConfig(
        name="dense-100m", family="dense", n_layers=12, d_model=640,
        n_heads=10, n_kv_heads=5, d_ff=1792, vocab=50304,
        tie_embeddings=True, dtype="float32", row_chunks=4, remat="rows")
    assert dataclasses.asdict(T.config()) == dataclasses.asdict(want)
    got = T.config("gemma3_4b")
    assert (got.dtype, got.row_chunks, got.d_model) == ("float32", 4, 2560)


# ---------------------------------------------------------------------------
# against the reference children (each test runs the port first)
# ---------------------------------------------------------------------------


def test_serve_batched_equals_reference(reference):
    """(g) The example's traffic in its ~3.5-slot pool on the reduced
    Gemma-3 4B: streams, slots, slot history, decode steps, concurrency."""
    S = _example("torch_serve_batched")
    cfg = get_reduced(S.ARCH)
    params = model.params_from_reference(_lm_tree("gemma"), "cpu")
    requests, budget = S.traffic(cfg)
    report, plan, _ = S.serving(params, cfg, requests, budget)
    want = reference("lm")["serve"]
    assert budget == want["budget"]
    assert json.loads(plan.to_json()) == json.loads(want["plan"])
    assert {str(s.rid): list(map(int, s.generated))
            for s in report.states} == want["tokens"]
    assert {str(s.rid): s.slot for s in report.states} == want["slots"]
    assert {str(k): v for k, v in report.slot_history.items()} \
        == want["slot_history"]
    s = report.summary()
    assert (s["decode_steps"], s["max_active"]) \
        == (want["decode_steps"], want["max_active"])
    assert s["max_active"] == 3  # the budget holds 3 slots


def test_train_lm_100m_matches_reference_and_restores(reference, tmp_path):
    """(h) 3 AdamW steps of a narrowed dense config against the
    reference's jitted, donated ``make_train_step``; the checkpoint the
    example's ``store.save`` writes restores bit for bit through the
    reference's ``repro.ckpt.store``."""
    T = _example("torch_train_lm_100m")
    cfg = ModelConfig(**LM_NARROW)
    params = model.params_from_reference(_lm_tree("narrow"), "cpu")
    state, losses = T.training(cfg, params, LM_STEPS, LM_BATCH, LM_SEQ,
                               "cpu", log_every=1)
    T.store.save(str(tmp_path), LM_STEPS, state["params"],
                 extra={"arch": cfg.name,
                        "final_loss": losses[LM_STEPS - 1]})
    restored = ref_store.restore(str(tmp_path), _lm_tree("narrow"))
    got = [np.asarray(a) for a in jax.tree.leaves(restored)]
    mine = [t.numpy() for t in tree_leaves(state["params"])]
    assert len(got) == len(mine)
    for a, b in zip(got, mine):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert ref_store.restore_meta(str(tmp_path))["final_loss"] \
        == losses[LM_STEPS - 1]
    want = reference("lm")["lm_losses"]
    assert sorted(losses) == list(range(LM_STEPS))
    for step in range(LM_STEPS):
        assert _rel(losses[step], want[step]) < 1e-5 * 10 ** step, \
            (losses, want)


def test_quickstart_planning_and_exactness(reference):
    """(a) The plan JSON of ``for_budget(mods, (64, 64, 3), 8, 10 MiB)``
    and the three Ω integers equal the reference's.  (b) The row engines'
    forwards equal ``base`` within 1e-5, and the port's ``base`` the
    reference's within 1e-5 relative."""
    Q, mods, plan, omegas, x = _quickstart()
    params = _cnn_params(Q.SHAPE, 10)
    trunks = Q.engines(mods, plan)
    deltas = Q.exactness(trunks, params["trunk"], x)
    with torch.no_grad():
        base = trunks["base"](params["trunk"], x).numpy()
    ref = reference("cnn")
    assert json.loads(plan.to_json()) == json.loads(ref["qs_plan"])
    assert [omegas[s] for s in ("base", "twophase", "overlap")] \
        == ref["qs_omega"]
    scale = float(np.abs(base).max())
    assert set(deltas) == {"overlap N=4", "2PS"}
    assert all(d <= 1e-5 * scale for d in deltas.values()), deltas
    want = np.asarray(ref["qs_base"], np.float32)
    assert base.shape == want.shape
    assert float(np.abs(base - want).max()) <= 1e-5 * float(
        np.abs(want).max())


def test_quickstart_training_matches_reference(reference):
    """(c) SGD through 2PS at the plan's N: 3 losses against the
    reference's."""
    Q, mods, plan, _, _ = _quickstart()
    _, losses = Q.training(Q.engines(mods, plan)["2PS"],
                           _cnn_params(Q.SHAPE, 10), "cpu", steps=QS_STEPS,
                           log_every=1)
    want = reference("cnn")["qs_losses"]
    assert sorted(losses) == list(range(QS_STEPS))
    for step in range(QS_STEPS):
        assert _rel(losses[step], want[step]) < 1e-5 * 10 ** step, \
            (losses, want)


@pytest.mark.parametrize("name", ["large", "small"])
def test_large_image_plans_equal_reference(reference, name):
    """(e) Both device-only solves are infeasible; given one fixed
    ``CostTable``, ``for_budget`` residencizes to equal plan JSON, before
    and after the replay (the example's 768², 28 MiB, and the training
    test's smaller scenario)."""
    L = _example("torch_large_image_cnn")
    h, budget = (L.H, L.BUDGET) if name == "large" \
        else (SMALL_H, SMALL_BUDGET)
    mods, shape = L.trunk_modules(), (h, h, 3)
    dev = L.device_only(mods, shape, budget)
    plan = L.residencized(mods, shape, CostTable.from_dict(TABLE), budget)
    ref = {**reference("cnn"), **reference("costed")}
    assert json.loads(dev.to_json()) \
        == json.loads(ref[name + "|device_only"])
    assert not dev.feasible
    assert json.loads(plan.to_json()) \
        == json.loads(ref[name + "|replayed"]) \
        == json.loads(ref[name + "|plan"])
    assert plan.residency.default == "host" and plan.get("residencized")


def test_large_image_step_matches_reference(reference):
    """(f) One training step under the residencized plan at 192², 5.5 MiB
    (host-resident 2PS N=8 boundary caches): the loss within 1e-5."""
    L = _example("torch_large_image_cnn")
    mods, shape = L.trunk_modules(), (SMALL_H, SMALL_H, 3)
    plan = L.residencized(mods, shape, CostTable.from_dict(TABLE),
                          SMALL_BUDGET)
    assert (plan.engine, plan.n_rows) == ("twophase", 8)
    x = np.random.default_rng(LI_SEED).standard_normal(
        (L.BATCH,) + shape).astype(np.float32)
    losses, peaks = L.training(
        mods, plan, _cnn_params(shape, 4),
        [(torch.from_numpy(x), torch.tensor([0, 1]))], "cpu")
    assert peaks == [None]
    assert _rel(losses[0], reference("cnn")["small_loss"]) < 1e-5
