"""The port's CNN trainer, optimizers and data against the JAX package.

The trajectory test runs the port's ``train_cnn`` (reduced VGG-16 preset,
``--strategy overlap --rows 2``, ``--device cpu``) from the same numpy
init as a reference step built from ``make_column_apply`` +
``head_apply`` + ``sgd_update``, on the same ``ImageDataset`` batches.
The loss tolerance grows with the step (fp32 differences compound through
the updates): 1e-5 relative at step 0, times 10 per step.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.overlap import make_column_apply
from repro.data.pipeline import ImageDataset as RefImageDataset
from repro.data.pipeline import ImageDatasetConfig as RefImageDatasetConfig
from repro.models.cnn import layers as ref_layers
from repro.models.cnn.vgg import head_apply as ref_head_apply
from repro.models.cnn.vgg import vgg16_modules as ref_vgg16_modules
from repro.optim import adamw as ref_opt
from repro_torch.data.pipeline import ImageDataset, ImageDatasetConfig
from repro_torch.launch import train as T
from repro_torch.models.cnn.vgg import params_from_reference
from repro_torch.optim import adamw as pt_opt

IMAGE, BATCH, LR = 64, 2, 0.05


def _np_tree(seed=0, width=0.125, stages=5, image=IMAGE):
    rng = np.random.default_rng(seed)
    trunk, shape = [], (image, image, 3)
    for m in ref_vgg16_modules(width, stages):
        p = {}
        if isinstance(m, ref_layers.Conv):
            fan_in = m.k * m.k * shape[2]
            p["w"] = (rng.normal(size=(m.k, m.k, shape[2], m.cout))
                      * np.sqrt(2.0 / fan_in)).astype(np.float32)
            p["b"] = np.zeros(m.cout, np.float32)
        trunk.append(p)
        shape = m.out_shape(shape)
    head = {"w": (rng.normal(size=(shape[2], 10)) / np.sqrt(shape[2]))
            .astype(np.float32), "b": np.zeros(10, np.float32)}
    return {"trunk": tuple(trunk), "head": head}


def _reference_losses(tree, steps):
    mods = ref_vgg16_modules(0.125, 5)
    trunk = make_column_apply(mods)

    def loss_fn(p, images, labels):
        logp = jax.nn.log_softmax(ref_head_apply(p["head"],
                                                 trunk(p["trunk"], images)))
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], 1))

    cfg = ref_opt.SGDConfig(lr=LR)

    @jax.jit
    def step_fn(p, opt, images, labels):
        loss, g = jax.value_and_grad(loss_fn)(p, images, labels)
        p, opt, _ = ref_opt.sgd_update(p, g, opt, cfg)
        return p, opt, loss

    params = jax.tree.map(jnp.asarray, tree)
    opt = ref_opt.sgd_init(params)
    ds = RefImageDataset(RefImageDatasetConfig(h=IMAGE, w=IMAGE, c=3,
                                               n_classes=10, batch=BATCH))
    losses = []
    for step in range(steps):
        hb = ds.batch_at(step)
        params, opt, loss = step_fn(params, opt, jnp.asarray(hb["images"]),
                                    jnp.asarray(hb["labels"]))
        losses.append(float(loss))
    return losses


def _args(out, *extra, arch="vgg16"):
    return T.build_parser().parse_args(
        ["--arch", arch, "--preset", "reduced", "--device", "cpu",
         "--log-every", "1", "--out", str(out), *extra])


def test_three_step_trajectory_matches_reference(tmp_path):
    tree = _np_tree()
    want = _reference_losses(tree, 3)
    recs = T.train_cnn(_args(tmp_path, "--steps", "3", "--strategy",
                             "overlap", "--rows", "2"),
                       params=params_from_reference(tree, device="cpu"))
    got = [r["loss"] for r in recs]
    assert [r["step"] for r in recs] == [0, 1, 2]
    for step, (a, b) in enumerate(zip(want, got)):
        assert abs(a - b) / abs(a) < 1e-5 * 10 ** step, (step, want, got)
    log = json.load(open(os.path.join(tmp_path, "train_log.json")))
    assert log["schema"] == 1 and log["mode"] == "cnn"
    assert log["plan"]["engine"] == "overlap" and log["plan"]["n_rows"] == 2
    assert [s["loss"] for s in log["steps"]] == got


def test_kernel_engine_trajectory_on_cpu_equals_overlap(tmp_path):
    tree = _np_tree(seed=3)
    runs = {}
    for name, extra in (("overlap", ()), ("cuda", ("--kernel", "cuda"))):
        recs = T.train_cnn(
            _args(tmp_path / name, "--steps", "2", "--strategy", "overlap",
                  "--rows", "2", *extra),
            params=params_from_reference(tree, device="cpu"))
        runs[name] = [r["loss"] for r in recs]
    plan = json.load(open(tmp_path / "cuda" / "train_log.json"))["plan"]
    assert plan["engine"] == "overlap_cuda"
    assert plan["kernel"]["backend"] == "cuda"
    for a, b in zip(runs["overlap"], runs["cuda"]):
        assert abs(a - b) / abs(a) < 1e-5


@pytest.mark.parametrize("flags,match", [
    (["--metrics-out", "{tmp}/m.json"], None),
    (["--strategy", "base", "--mesh", "data=2"], "needs 2 devices"),
    (["--budget-gb", "1", "--mesh", "data=2"], "needs 2 devices"),
    (["--plan-cache", "{tmp}/x"], None),
    (["--trace", "{tmp}/t.jsonl"], None),
])
def test_unported_flags_raise(tmp_path, flags, match):
    """``--mesh`` runs one rank per mesh device: in one process with no
    group, ``data=2`` raises and points to the plan's per-device
    projection (``tests/test_torch_sharding.py`` trains under it in a
    process group); ``--metrics-out``, ``--plan-cache`` and ``--trace``
    are ported (``tests/test_torch_obs.py`` and ``test_torch_costmodel.py``
    hold them against the reference) and run."""
    flags = [f.format(tmp=tmp_path) for f in flags]
    if match is None:
        assert len(T.main(["--arch", "vgg16", "--preset", "reduced",
                           "--strategy", "base",
                           "--steps", "1", "--device", "cpu", "--out",
                           str(tmp_path / "out"), *flags])) == 1
        return
    with pytest.raises(ValueError, match=match):
        T.train_cnn(_args(tmp_path, "--steps", "1", *flags))


def test_earlier_parameters_are_released(tmp_path, monkeypatch):
    """Each step leaves only its output tree alive: no second name for the
    initial tree, and no step's graph (through its loss) holding the
    leaves it differentiated, which alias the step's input parameters.
    Either kept a parameter-sized copy beside the current one."""
    import weakref
    real_update, real_grad = T.sgd_update, torch.autograd.grad
    refs, alive = {"params": [], "leaves": []}, []

    def update(params, *args, **kwargs):
        alive.append(sum(w() is not None for w in refs["params"]))
        refs["params"] = [weakref.ref(t) for t in pt_opt.tree_leaves(params)]
        return real_update(params, *args, **kwargs)

    def grad(outputs, inputs, *args, **kwargs):
        alive.append(sum(w() is not None for w in refs["leaves"]))
        refs["leaves"] = [weakref.ref(t) for t in inputs]
        return real_grad(outputs, inputs, *args, **kwargs)

    monkeypatch.setattr(T, "sgd_update", update)
    monkeypatch.setattr(torch.autograd, "grad", grad)
    T.main(["--arch", "vgg16", "--preset", "reduced", "--strategy", "base",
            "--steps", "3", "--device", "cpu", "--out", str(tmp_path)])
    assert alive == [0] * 6


def test_unported_arch_and_engine_raise(tmp_path):
    args = _args(tmp_path, "--steps", "1")
    args.arch = "gemma3_4b"
    with pytest.raises(ValueError, match="not a CNN"):
        T.train_cnn(args)
    # the reduced config's own request (twophase N=2 at 64²) exceeds 2PS's
    # granularity bound, in the reference as here
    with pytest.raises(ValueError, match="granularity bound"):
        T.train_cnn(_args(tmp_path, "--steps", "1"))
    # --residency runs on the LM path since the SSM slice, and the MoE
    # archs (which raised here before) since the MoE slice: a host
    # residency rides along on their seq_chunked plan
    recs = T.train_lm(T.build_parser().parse_args(
        ["--arch", "deepseek_moe_16b", "--residency", "host", "--device",
         "cpu", "--steps", "1", "--batch", "2", "--seq", "32", "--out",
         str(tmp_path)]))
    assert len(recs) == 1 and recs[0]["load_balance"] > 0
    plan = json.load(open(tmp_path / "train_log.json"))["plan"]
    assert plan["engine"] == "seq_chunked"
    assert plan["residency"]["default"] == "host"


def test_cuda_device_without_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _args(tmp_path, "--steps", "1", "--strategy", "base")
    args.device = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.train_cnn(args)


@pytest.mark.parametrize("step", [0, 1, 7])
def test_image_batches_identical(step):
    kw = dict(h=24, w=20, c=3, n_classes=10, batch=4, seed=5)
    a = RefImageDataset(RefImageDatasetConfig(**kw)).batch_at(step)
    b = ImageDataset(ImageDatasetConfig(**kw)).batch_at(step)
    for k in ("images", "labels"):
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype


def _opt_trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": [(3, 3, 2, 4), (4,)], "b": [(5, 2)]}
    p = {k: [rng.normal(size=s).astype(np.float32) for s in v]
         for k, v in shapes.items()}
    g = {k: [rng.normal(size=s).astype(np.float32) for s in v]
         for k, v in shapes.items()}
    return p, g


def _cmp(ref_tree, pt_tree, tol=1e-6):
    for a, b in zip(jax.tree.leaves(ref_tree), pt_opt.tree_leaves(pt_tree)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_sgd_matches_reference(clip):
    p, g = _opt_trees(0)
    rc = ref_opt.SGDConfig(lr=0.1, clip_norm=clip)
    pc = pt_opt.SGDConfig(lr=0.1, clip_norm=clip)
    rp, rs = jax.tree.map(jnp.asarray, p), None
    tp = pt_opt.tree_map(torch.tensor, p)
    rs, ts = ref_opt.sgd_init(rp), pt_opt.sgd_init(tp)
    for _ in range(3):
        rp, rs, rm = ref_opt.sgd_update(rp, jax.tree.map(jnp.asarray, g),
                                        rs, rc)
        tp, ts, tm = pt_opt.sgd_update(tp, pt_opt.tree_map(torch.tensor, g),
                                       ts, pc)
    _cmp(rp, tp)
    _cmp(rs["vel"], ts["vel"])
    assert abs(float(rm["grad_norm"]) - float(tm["grad_norm"])) < 1e-5


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_adamw_matches_reference(clip):
    """``adamw_update_`` (the LM step's) gives the reference's values, in
    the tensors it was given."""
    p, g = _opt_trees(1)
    cfg_r = ref_opt.AdamWConfig(lr=1e-2, clip_norm=clip)
    cfg_p = pt_opt.AdamWConfig(lr=1e-2, clip_norm=clip)
    rp = jax.tree.map(jnp.asarray, p)
    tp = pt_opt.tree_map(torch.tensor, p)
    rs, ts = ref_opt.adamw_init(rp), pt_opt.adamw_init(tp)
    leaves = pt_opt.tree_leaves((tp, ts["mu"], ts["nu"]))
    for _ in range(3):
        rp, rs, rm = ref_opt.adamw_update(rp, jax.tree.map(jnp.asarray, g),
                                          rs, cfg_r)
        tp2, ts2, tm = pt_opt.adamw_update_(
            tp, pt_opt.tree_map(torch.tensor, g), ts, cfg_p)
        assert tp2 is tp and ts2 is ts
    _cmp(rp, tp, tol=1e-5)
    _cmp(rs["mu"], ts["mu"])
    _cmp(rs["nu"], ts["nu"])
    assert int(rs["step"]) == ts["step"] == 3
    assert abs(float(rm["grad_norm"]) - float(tm["grad_norm"])) < 1e-5
    # the same tensors, updated
    assert all(a is b for a, b in zip(
        leaves, pt_opt.tree_leaves((tp, ts["mu"], ts["nu"]))))


def test_global_norm_and_clip_match_reference():
    _, g = _opt_trees(2)
    want = float(ref_opt.global_norm(jax.tree.map(jnp.asarray, g)))
    tg = pt_opt.tree_map(torch.tensor, g)
    assert abs(float(pt_opt.global_norm(tg)) - want) / want < 1e-6
    clipped, norm = pt_opt.clip_by_global_norm(tg, want / 2)
    assert abs(float(pt_opt.global_norm(clipped)) - want / 2) / want < 1e-6


# ---------------------------------------------------------------------------
# 2PS-H, residency and ResNet-50 trajectories against the reference's
# engines (from a child process: they need repro.exec)
# ---------------------------------------------------------------------------

#: the child compiles many small programs; one XLA thread keeps it from
#: crowding other test workers, and is no slower
CHILD_XLA_FLAGS = ("--xla_cpu_multi_thread_eigen=false "
                   "intra_op_parallelism_threads=1")

TRAIN_CHILD = r'''
import json, sys
import numpy as np
import jax, jax.numpy as jnp, jax.memory, jax.sharding
if not hasattr(jax.sharding, "TransferToMemoryKind"):
    # JAX 0.9 dropped the name repro.exec.rowprog imports; this process only
    jax.sharding.TransferToMemoryKind = lambda kind: (
        jax.memory.Space.Host if "host" in kind else jax.memory.Space.Device)
from repro.data.pipeline import ImageDataset, ImageDatasetConfig
from repro.exec import Planner, PlanRequest, build_apply
from repro.models.cnn import resnet, vgg
from repro.optim import adamw

d = sys.argv[1]
runs = json.load(open(d + "/runs.json"))
out = {}
for name, r in runs.items():
    inp = np.load(f"{d}/{name}.npz")
    net = vgg if r["arch"] == "vgg16" else resnet
    mods = net.vgg16_modules(0.125) if r["arch"] == "vgg16" \
        else net.resnet50_modules(0.125)
    trunk, head = [{} for _ in mods], {}
    for k in inp.files:
        parts = k.split("|")
        node = head if parts[0] == "head" else trunk[int(parts[1])]
        for p in parts[1 if parts[0] == "head" else 2:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(inp[k])
    params = {"trunk": tuple(trunk), "head": head}
    xi = 12 * sum(int(np.prod(l.shape)) for l in jax.tree.leaves(params))
    plan = Planner(mods, (64, 64, 3), 2, xi=xi).resolve(PlanRequest(
        engine=r["engine"], n_rows=r["rows"], residency=r["residency"]))
    apply = build_apply(mods, plan)

    def loss_fn(p, images, labels):
        logp = jax.nn.log_softmax(net.head_apply(p["head"],
                                                 apply(p["trunk"], images)))
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], 1))

    cfg = adamw.SGDConfig(lr=r["lr"])

    @jax.jit
    def step_fn(p, opt, images, labels):
        loss, g = jax.value_and_grad(loss_fn)(p, images, labels)
        p, opt, _ = adamw.sgd_update(p, g, opt, cfg)
        return p, opt, loss

    opt = adamw.sgd_init(params)
    ds = ImageDataset(ImageDatasetConfig(h=64, w=64, c=3, n_classes=10,
                                         batch=2, seed=0))
    losses = []
    for step in range(3):
        hb = ds.batch_at(step)
        params, opt, loss = step_fn(params, opt, jnp.asarray(hb["images"]),
                                    jnp.asarray(hb["labels"]))
        losses.append(float(loss))
    out[name] = {"losses": losses, "plan": plan.to_dict()}
json.dump(out, open(d + "/out.json", "w"))
'''

#: name -> (arch, engine, rows, residency, lr, extra flags)
TRAJECTORIES = {
    "twophase_h": ("vgg16", "twophase_h", 3, "", 0.05,
                   ["--strategy", "twophase_h", "--rows", "3"]),
    "twophase_h_host": ("vgg16", "twophase_h", 3, "host", 0.05,
                        ["--strategy", "twophase_h", "--rows", "3",
                         "--residency", "host"]),
    # the reduced preset's own request (overlap N=2); at the default lr
    # 0.05 it diverges in both packages (BatchNorm at its running
    # statistics, 16 residual blocks), so the trajectory takes 1e-5
    "resnet50": ("resnet50", "overlap", 2, "", 1e-5, ["--lr", "1e-5"]),
}


def _np_resnet_tree():
    from repro.models.cnn.resnet import resnet50_modules
    from test_torch_resnet import np_trunk
    return np_trunk(resnet50_modules(0.125), (IMAGE, IMAGE, 3), seed=4)


def _flat_tree(prefix, tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flat_tree(f"{prefix}|{k}", tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            _flat_tree(f"{prefix}|{i}", t, out)
    else:
        out[prefix] = tree
    return out


@pytest.fixture(scope="module")
def reference_trajectories(tmp_path_factory):
    import subprocess
    import sys
    d = tmp_path_factory.mktemp("ref_train")
    runs, trees = {}, {}
    for name, (arch, engine, rows, res, lr, _) in TRAJECTORIES.items():
        tree = _np_tree(seed=5) if arch == "vgg16" else _np_resnet_tree()
        trees[name] = tree
        arrays = _flat_tree("trunk", tree["trunk"], {})
        arrays.update(_flat_tree("head", tree["head"], {}))
        np.savez(d / f"{name}.npz", **arrays)
        runs[name] = dict(arch=arch, engine=engine, rows=rows,
                          residency=res, lr=lr)
    (d / "runs.json").write_text(json.dumps(runs))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-c", TRAIN_CHILD, str(d)], cwd=root,
        env=dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
                 JAX_PLATFORMS="cpu", XLA_FLAGS=CHILD_XLA_FLAGS),
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.load(open(d / "out.json")), trees


@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_engine_trajectory_matches_reference(tmp_path,
                                             reference_trajectories, name):
    ref, trees = reference_trajectories
    arch, engine, rows, res, _, flags = TRAJECTORIES[name]
    recs = T.train_cnn(_args(tmp_path, "--steps", "3", *flags, arch=arch),
                       params=params_from_reference(trees[name],
                                                    device="cpu"))
    got = [r["loss"] for r in recs]
    want = ref[name]["losses"]
    assert all(np.isfinite(got)) and len(got) == 3
    for step, (a, b) in enumerate(zip(want, got)):
        assert abs(a - b) / abs(a) < 1e-5 * 10 ** step, (step, want, got)
    plan = json.load(open(os.path.join(tmp_path, "train_log.json")))["plan"]
    rp = ref[name]["plan"]
    assert (plan["engine"], plan["n_rows"], plan["est_bytes"]) \
        == (rp["engine"], rp["n_rows"], rp["est_bytes"]) \
        == (engine, rows, rp["est_bytes"])
    assert plan["segments"] == rp["segments"]
    assert plan["residency"] == rp["residency"]


def test_budget_flag_resolves_through_for_budget(tmp_path):
    """--budget-gb clears the config's engine and N; Planner.for_budget
    picks them (here: what fits 4 MiB of the reduced VGG-16)."""
    from repro_torch.exec import Planner
    from repro_torch.models.cnn.vgg import vgg16_modules
    from repro_torch.optim.adamw import tree_leaves
    tree = _np_tree(seed=5)
    params = params_from_reference(tree, device="cpu")
    xi = 12 * sum(t.numel() for t in tree_leaves(params))
    want = Planner.for_budget(vgg16_modules(0.125), (IMAGE, IMAGE, 3),
                              BATCH, 4 * 2**20, xi=xi)
    recs = T.train_cnn(_args(tmp_path, "--steps", "2", "--budget-gb",
                             str(4 / 1024)), params=params)
    plan = json.load(open(os.path.join(tmp_path, "train_log.json")))["plan"]
    assert (plan["engine"], plan["n_rows"], plan["est_bytes"]) \
        == (want.engine, want.n_rows, want.est_bytes)
    assert want.engine not in ("base", "twophase")  # it had to trade
    assert all(np.isfinite([r["loss"] for r in recs]))
