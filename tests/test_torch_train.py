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


def _args(out, *extra):
    return T.build_parser().parse_args(
        ["--arch", "vgg16", "--preset", "reduced", "--device", "cpu",
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
    (["--budget-gb", "1"], "--budget-gb is not ported yet"),
    (["--mesh", "data=2"], "--mesh is not ported yet"),
    (["--residency", "host"], "--residency is not ported yet"),
    (["--plan-cache", "x"], "--plan-cache is not ported yet"),
    (["--trace", "t.jsonl"], "--trace is not ported yet"),
])
def test_unported_flags_raise(tmp_path, flags, match):
    with pytest.raises(NotImplementedError, match=match):
        T.train_cnn(_args(tmp_path, "--steps", "1", *flags))


def test_unported_arch_and_engine_raise(tmp_path):
    args = _args(tmp_path, "--steps", "1")
    args.arch = "resnet50"
    with pytest.raises(NotImplementedError, match="resnet50"):
        T.train_cnn(args)
    # the reduced config's own request is twophase, not ported yet
    with pytest.raises(KeyError, match="'twophase' is not ported yet"):
        T.train_cnn(_args(tmp_path, "--steps", "1"))


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


def test_adamw_matches_reference():
    p, g = _opt_trees(1)
    cfg_r, cfg_p = ref_opt.AdamWConfig(lr=1e-2), pt_opt.AdamWConfig(lr=1e-2)
    rp = jax.tree.map(jnp.asarray, p)
    tp = pt_opt.tree_map(torch.tensor, p)
    rs, ts = ref_opt.adamw_init(rp), pt_opt.adamw_init(tp)
    for _ in range(3):
        rp, rs, _ = ref_opt.adamw_update(rp, jax.tree.map(jnp.asarray, g),
                                         rs, cfg_r)
        tp, ts, _ = pt_opt.adamw_update(tp, pt_opt.tree_map(torch.tensor, g),
                                        ts, cfg_p)
    _cmp(rp, tp, tol=1e-5)
    _cmp(rs["mu"], ts["mu"])
    _cmp(rs["nu"], ts["nu"])
    assert int(rs["step"]) == ts["step"] == 3


def test_global_norm_and_clip_match_reference():
    _, g = _opt_trees(2)
    want = float(ref_opt.global_norm(jax.tree.map(jnp.asarray, g)))
    tg = pt_opt.tree_map(torch.tensor, g)
    assert abs(float(pt_opt.global_norm(tg)) - want) / want < 1e-6
    clipped, norm = pt_opt.clip_by_global_norm(tg, want / 2)
    assert abs(float(pt_opt.global_norm(clipped)) - want / 2) / want < 1e-6
