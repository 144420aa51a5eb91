"""Checkpoints and schedules: ``repro_torch.ckpt.store`` and the LR
schedules against the JAX package's.

``repro.ckpt.store`` and ``repro.optim.adamw`` import JAX only, so they
run in this process.  A checkpoint either package writes must restore in
the other key for key and value for value; the port's leaves restore bit
for bit.  The per-shard layout runs in a 4-rank ``gloo`` group (separate
processes meeting through a ``file://`` store under ``tmp_path``, with a
timeout of their own).
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import store as ref_store
from repro.models.cnn.vgg import init_vgg16 as ref_init_vgg16
from repro.optim import adamw as ref_opt
from repro_torch.ckpt import store
from repro_torch.exec import MeshSpec, Planner
from repro_torch.models.cnn.layers import params_from_reference
from repro_torch.models.cnn.vgg import init_vgg16
from repro_torch.optim.adamw import (
    AdamWConfig, SGDConfig, adamw_init, adamw_update_, constant, sgd_init,
    sgd_update, tree_leaves, tree_map, warmup_cosine,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GROUP_TIMEOUT_S = 120
SHAPE = (32, 32, 3)


def _vgg():
    return init_vgg16(torch.Generator().manual_seed(0), SHAPE, 0.125, 4,
                      n_stages=3, device="cpu")


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x == y if isinstance(x, int) else
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (7, 7),
                                          (3, 200), (100, 1000)])
def test_schedules_equal_reference(warmup, total):
    """fp32 values to 1e-6 relative: XLA's fp32 cosine and PyTorch's
    differ by a few ulps; every other operation is the same."""
    for step in range(0, total + 20, 3):
        want = float(ref_opt.warmup_cosine(jnp.array(step), warmup=warmup,
                                           total=total))
        for s in (step, torch.tensor(step)):
            got = warmup_cosine(s, warmup=warmup, total=total)
            assert got.dtype == torch.float32 and got.ndim == 0
            assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-7)
    assert constant(5) == ref_opt.constant(5) == 1.0


# ---------------------------------------------------------------------------
# the store, one process
# ---------------------------------------------------------------------------


def test_roundtrip_params_and_optimizer_state(tmp_path):
    mods, params = _vgg()
    sgd = sgd_init(params)
    sgd["vel"] = tree_map(lambda v: torch.randn_like(v), sgd["vel"])
    adam = adamw_init(params)
    adam["mu"] = tree_map(lambda v: torch.randn_like(v), adam["mu"])
    adam["step"] = 11
    plan = Planner(mods, SHAPE, 2).plan("pipeline_rows", 2)
    d = str(tmp_path)
    assert store.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        store.restore(d, params)
    store.save(d, 3, params, sgd, {"note": "sgd"})
    store.save(d, 7, params, adam, {"note": "adam"}, plan=plan)
    assert store.latest_step(d) == 7
    assert sorted(os.listdir(d)) == [
        "ckpt_00000003.meta.json", "ckpt_00000003.opt.npz",
        "ckpt_00000003.params.npz", "ckpt_00000007.meta.json",
        "ckpt_00000007.opt.npz", "ckpt_00000007.params.npz",
        "ckpt_00000007.plan.json", "latest.json"]
    assert _equal_trees(store.restore(d, params), params)
    got = store.restore(d, adamw_init(params), kind="opt")
    assert got["step"] == 11 and isinstance(got["step"], int)
    assert _equal_trees(got, adam)
    assert _equal_trees(store.restore(d, sgd_init(params), step=3,
                                      kind="opt"), sgd)
    assert store.restore_meta(d) == {"step": 7, "note": "adam"}
    assert store.restore_meta(d, 3)["note"] == "sgd"
    assert store.restore_plan(d) == plan
    assert store.restore_plan(d, 3) is None


def test_restored_state_steps_as_the_original(tmp_path):
    """The SGD momentum and the AdamW moments restore into the trees the
    updates take: one more step from the restored state equals one more
    step from the original, bit for bit (AdamW writes into them)."""
    _, params = _vgg()
    grads = tree_map(lambda p: torch.randn_like(p), params)
    sgd = sgd_init(params)
    params1, sgd, _ = sgd_update(params, grads, sgd, SGDConfig())
    store.save(str(tmp_path), 1, params1, sgd)
    p_r = store.restore(str(tmp_path), params)
    s_r = store.restore(str(tmp_path), sgd_init(params), kind="opt")
    want = sgd_update(params1, grads, sgd, SGDConfig())
    got = sgd_update(p_r, grads, s_r, SGDConfig())
    assert _equal_trees(got[0], want[0]) and _equal_trees(got[1], want[1])

    adam = adamw_init(params1)
    adamw_update_(params1, grads, adam, AdamWConfig())
    store.save(str(tmp_path / "a"), 1, params1, adam)
    p_r = store.restore(str(tmp_path / "a"), params1)
    a_r = store.restore(str(tmp_path / "a"), adamw_init(params1),
                        kind="opt")
    adamw_update_(params1, grads, adam, AdamWConfig())
    adamw_update_(p_r, grads, a_r, AdamWConfig())
    assert _equal_trees(p_r, params1) and _equal_trees(a_r, adam)


def test_restore_places_each_leaf_as_its_template(tmp_path):
    """A meta template restores on the CPU; a bfloat16 leaf is written as
    float32 and restores as bfloat16 without loss."""
    tree = {"a": torch.randn(3, 4).to(torch.bfloat16),
            "b": [torch.arange(5, dtype=torch.int32)]}
    store.save(str(tmp_path), 0, tree)
    with np.load(tmp_path / "ckpt_00000000.params.npz") as data:
        assert data["a"].dtype == np.float32
    got = store.restore(str(tmp_path), tree)
    assert got["a"].dtype == torch.bfloat16 and torch.equal(got["a"],
                                                            tree["a"])
    meta = {"a": torch.empty(3, 4, device="meta"),
            "b": [torch.empty(5, dtype=torch.int64, device="meta")]}
    got = store.restore(str(tmp_path), meta)
    assert got["a"].device.type == "cpu" and got["a"].dtype == torch.float32
    assert got["b"][0].tolist() == list(range(5))
    with pytest.raises(ValueError, match="shape"):
        store.restore(str(tmp_path), {"a": torch.empty(4, 3),
                                      "b": [torch.empty(5)]})


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    _, rp = ref_init_vgg16(jax.random.PRNGKey(0), SHAPE, 0.125, 4,
                           n_stages=3)
    ropt = ref_opt.adamw_init(rp)
    ropt = dict(ropt, mu=jax.tree.map(lambda v: v + 0.5, ropt["mu"]),
                step=jnp.array(4, jnp.int32))
    ref_store.save(str(tmp_path), 5, rp, ropt, {"arch": "vgg16"})
    tree = jax.tree.map(np.asarray, rp)
    tp = params_from_reference(tree, device="cpu")
    got = store.restore(str(tmp_path), tp)
    assert _equal_trees(got, tp)
    opt = store.restore(str(tmp_path), adamw_init(tp), kind="opt")
    assert opt["step"] == 4
    assert all(torch.equal(a, torch.tensor(np.asarray(b))) for a, b in
               zip(tree_leaves(opt["mu"]), jax.tree.leaves(ropt["mu"])))
    assert store.restore_meta(str(tmp_path)) == {"step": 5, "arch": "vgg16"}


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    _, rp = ref_init_vgg16(jax.random.PRNGKey(0), SHAPE, 0.125, 4,
                           n_stages=3)
    tp = params_from_reference(jax.tree.map(np.asarray, rp), device="cpu")
    tp = tree_map(lambda p: p * 2 + 1, tp)
    opt = adamw_init(tp)
    opt["nu"] = tree_map(lambda v: v + 3.0, opt["nu"])
    opt["step"] = 9
    store.save(str(tmp_path), 2, tp, opt, {"arch": "vgg16"})
    back = ref_store.restore(str(tmp_path), jax.eval_shape(lambda: rp))
    assert all(np.array_equal(np.asarray(a), b.numpy()) for a, b in
               zip(jax.tree.leaves(back), tree_leaves(tp)))
    ropt = ref_store.restore(str(tmp_path), jax.eval_shape(
        lambda: ref_opt.adamw_init(rp)), kind="opt")
    assert int(ropt["step"]) == 9
    assert all(np.array_equal(np.asarray(a), b.numpy()) for a, b in
               zip(jax.tree.leaves(ropt["nu"]), tree_leaves(opt["nu"])))
    assert ref_store.latest_step(str(tmp_path)) == 2


def _bits(t: torch.Tensor) -> np.ndarray:
    """A bfloat16 tensor's bits as ``uint16``."""
    return t.view(torch.int16).numpy().view(np.uint16)


def test_reference_bf16_checkpoint_restores_in_the_port(tmp_path):
    """A bfloat16 leaf ``repro.ckpt.store.save`` writes as it is (numpy
    stores it as the opaque ``|V2``) restores in the port as
    ``torch.bfloat16``, bit for bit, and into a float32 template as the
    same values."""
    w = jnp.arange(6, dtype=jnp.float32).reshape(2, 3) / 7 - 0.3
    tree = {"w": w.astype(jnp.bfloat16), "b": jnp.ones((3,), jnp.float32)}
    ref_store.save(str(tmp_path), 1, tree)
    with np.load(tmp_path / "ckpt_00000001.params.npz") as data:
        assert data["w"].dtype.str == "|V2"
    template = {"w": torch.empty(2, 3, dtype=torch.bfloat16),
                "b": torch.empty(3)}
    got = store.restore(str(tmp_path), template)
    assert got["w"].dtype == torch.bfloat16
    want = np.asarray(tree["w"]).view(np.uint16)
    assert np.array_equal(_bits(got["w"]), want)
    assert torch.equal(got["b"], torch.ones(3))
    as32 = store.restore(str(tmp_path), {"w": torch.empty(2, 3),
                                         "b": torch.empty(3)})
    assert torch.equal(as32["w"], got["w"].float())


BF16_SHARD_CHILD = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.ckpt import store
mesh = Mesh(np.array(jax.devices()[:2]), ("model",))
w = (jnp.arange(24, dtype=jnp.float32).reshape(4, 6) / 9 - 1.1) \
    .astype(jnp.bfloat16)
w = jax.device_put(w, NamedSharding(mesh, P(None, "model")))
store.save(sys.argv[1], 2, {"w": w})
np.save(sys.argv[1] + "/bits.npy", np.asarray(w).view(np.uint16))
'''


def test_reference_sharded_bf16_checkpoint_restores_in_the_port(tmp_path):
    """A bfloat16 leaf the reference saves per shard (two CPU devices in a
    child process) reassembles in the port (``_assemble`` keeps the
    shards' ``|V2``) and restores bit for bit."""
    d = tmp_path / "ck"
    r = subprocess.run([sys.executable, "-c", BF16_SHARD_CHILD, str(d)],
                       cwd=ROOT, env=dict(os.environ,
                                          PYTHONPATH=str(ROOT / "src"),
                                          JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(d / "ckpt_00000002.params.npz") as data:
        assert sorted(data.files) == ["w::shard0", "w::shard1"]
        assert data["w::shard0"].dtype.str == "|V2"
    got = store.restore(str(d), {"w": torch.empty(4, 6,
                                                  dtype=torch.bfloat16)})
    assert np.array_equal(_bits(got["w"]), np.load(d / "bits.npy"))


# ---------------------------------------------------------------------------
# per shard, in a 4-rank group
# ---------------------------------------------------------------------------

SHARD_WORKER = r'''
import datetime, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

rank, world, init, d, timeout = sys.argv[1:6]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=float(timeout)))
try:
    from repro_torch.ckpt import store
    from repro_torch.exec import MeshSpec, Planner
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.models.cnn.vgg import vgg16_modules
    spec = MeshSpec.parse("data=2,model=2")
    mesh = build_mesh(spec)
    k = torch.randn(3, 3, 8, 16, generator=torch.Generator().manual_seed(0))
    params = {
        "w": distribute_tensor(k, mesh, (Replicate(), Shard(3))),
        "b": distribute_tensor(torch.arange(8.0), mesh,
                               (Replicate(), Replicate())),
    }
    plan = Planner(vgg16_modules(0.125, 3), (64, 64, 3), 8,
                   mesh=spec).plan("pipeline_rows", 4)
    store.save(d, 3, params, plan=plan)
    back = store.restore(d, params)
    assert back["w"].placements == params["w"].placements
    assert torch.equal(back["w"].to_local(), params["w"].to_local())
    assert torch.equal(back["w"].full_tensor(), k)
    assert torch.equal(back["b"].to_local(), torch.arange(8.0))
    plain = store.restore(d, {"w": torch.empty(3, 3, 8, 16),
                              "b": torch.empty(8)})
    assert torch.equal(plain["w"], k)
    assert store.restore_plan(d) == plan
    if rank == 0:
        np.save(d + "/k.npy", k.numpy())
finally:
    dist.destroy_process_group()
'''


def test_sharded_checkpoint_saves_per_shard(tmp_path):
    """Model-axis-split leaves save per shard (never whole, each slice
    once however many data replicas hold it), restore re-places them
    against the template's placements, a one-device template restores
    the whole value, the plan rides along — and the reference reads the
    per-shard layout."""
    init = tmp_path / "init"
    d = tmp_path / "ckpt"
    procs = [subprocess.Popen(
        [sys.executable, "-c", SHARD_WORKER, str(r), "4", str(init), str(d),
         str(GROUP_TIMEOUT_S)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    try:
        errs = [p.communicate(timeout=GROUP_TIMEOUT_S + 60)[1]
                for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f"rank {r}: {err[-4000:]}"
    with np.load(d / "ckpt_00000003.params.npz") as data:
        files = sorted(data.files)
    assert files == ["b", "w::shard0", "w::shard1"]
    meta = store.restore_meta(str(d))
    assert meta["shard_layout"]["params"]["w"] == {
        "shape": [3, 3, 8, 16],
        "indices": [[[0, 3], [0, 3], [0, 8], [0, 8]],
                    [[0, 3], [0, 3], [0, 8], [8, 16]]]}
    k = np.load(d / "k.npy")
    ref = ref_store.restore(str(d), {
        "w": jax.ShapeDtypeStruct((3, 3, 8, 16), jnp.float32),
        "b": jax.ShapeDtypeStruct((8,), jnp.float32)})
    assert np.array_equal(np.asarray(ref["w"]), k)
    plan = store.restore_plan(str(d))
    assert plan.engine == "pipeline_rows"
    assert plan.mesh == MeshSpec.parse("data=2,model=2")


# ---------------------------------------------------------------------------
# train_lm --save, then a restore
# ---------------------------------------------------------------------------


def test_train_lm_save_then_resume(tmp_path):
    """``train_lm --save`` after 2 steps; the params, the AdamW state and
    the plan restored, the third step through ``make_train_step`` gives
    the third loss of an uninterrupted 3-step run."""
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import TokenDataset, TokenDatasetConfig
    from repro_torch.launch import train as T
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.lm.model import family_fns
    torch.set_num_threads(1)
    common = ["--arch", "xlstm_125m", "--preset", "reduced", "--seq", "64",
              "--batch", "2", "--device", "cpu", "--residency", "device",
              "--log-every", "1"]
    full = T.main(common + ["--steps", "3", "--out", str(tmp_path / "f")])
    T.main(common + ["--steps", "2", "--save", "--out",
                     str(tmp_path / "s")])
    d = str(tmp_path / "s")
    cfg = get_reduced("xlstm_125m")
    template = family_fns(cfg).init(torch.Generator().manual_seed(1), cfg)
    params = store.restore(d, template)
    opt = store.restore(d, adamw_init(template), kind="opt")
    plan = store.restore_plan(d)
    assert opt["step"] == 2
    assert store.restore_meta(d) == {"step": 2, "arch": cfg.name}
    log = json.load(open(tmp_path / "s" / "train_log.json"))
    assert plan.to_dict() == log["plan"]
    step = make_train_step(cfg, AdamWConfig(lr=T.LM_LR), plan=plan)
    ds = TokenDataset(TokenDatasetConfig(vocab=cfg.vocab, seq_len=64,
                                         batch=2, seed=0))
    _, metrics = step({"params": params, "opt": opt},
                      T.lm_batch(cfg, ds.batch_at(2), 2, 0, "cpu"))
    assert abs(float(metrics["loss"]) - full[2]["loss"]) \
        <= 1e-6 * abs(full[2]["loss"])
