"""Loss and gradients of the port's CNN engines against the JAX package.

VGG-16 at width 0.125 with 3 stages, image 32, batch 2.  The same numpy
init and batch go to ``build_apply`` in the port and to the reference's
``make_column_apply`` / ``make_overlap_apply`` + ``head_apply``; loss and
every gradient (params and input) must agree to 1e-5 relative (fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.overlap import (
    make_column_apply, make_overlap_apply, plan_overlap as ref_plan_overlap,
)
from repro.models.cnn import layers as ref_layers
from repro.models.cnn.vgg import head_apply as ref_head_apply
from repro.models.cnn.vgg import vgg16_modules as ref_vgg16_modules
from repro_torch.core.overlap import plan_overlap
from repro_torch.exec import ExecutionPlan, MeshSpec, ResidencySpec, build_apply
from repro_torch import obs
from repro_torch.kernels import ops
from repro_torch.optim.adamw import tree_leaves
from repro_torch.models.cnn.vgg import (
    head_apply, params_from_reference, vgg16_modules,
)

TOL = 1e-5
H = 32
SHAPE = (H, H, 3)


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    trunk, shape = [], SHAPE
    for m in ref_vgg16_modules(0.125, 3):
        p = {}
        if isinstance(m, ref_layers.Conv):
            fan_in = m.k * m.k * shape[2]
            p["w"] = (rng.normal(size=(m.k, m.k, shape[2], m.cout))
                      * np.sqrt(2.0 / fan_in)).astype(np.float32)
            p["b"] = (0.1 * rng.normal(size=(m.cout,))).astype(np.float32)
        trunk.append(p)
        shape = m.out_shape(shape)
    head = {"w": (rng.normal(size=(shape[2], 10)) / np.sqrt(shape[2]))
            .astype(np.float32),
            "b": np.zeros(10, np.float32)}
    return {"trunk": tuple(trunk), "head": head}


TREE = _np_tree()
_RNG = np.random.default_rng(1)
X = _RNG.normal(size=(2,) + SHAPE).astype(np.float32)
LABELS = _RNG.integers(0, 10, size=2)


def _ref_loss_and_grads(trunk_apply):
    def loss(p, x):
        logits = ref_head_apply(p["head"], trunk_apply(p["trunk"], x))
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(LABELS)[:, None], 1))
    params = jax.tree.map(jnp.asarray, TREE)
    val, (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        params, jnp.asarray(X))
    return float(val), jax.tree.map(np.asarray, gp), np.asarray(gx)


def _port_loss_and_grads(plan):
    apply = build_apply(vgg16_modules(0.125, 3), plan)
    p = params_from_reference(TREE, device="cpu")
    for t in tree_leaves(p):
        t.requires_grad_()
    x = torch.tensor(X, requires_grad=True)
    logits = head_apply(p["head"], apply(p["trunk"], x))
    loss = -torch.log_softmax(logits, -1).gather(
        1, torch.tensor(LABELS)[:, None]).mean()
    loss.backward()
    gp = {"head": {k: v.grad.numpy() for k, v in p["head"].items()},
          "trunk": tuple({k: v.grad.numpy() for k, v in d.items()}
                         for d in p["trunk"])}
    return loss.item(), gp, x.grad.numpy()


def _assert_close(ref, got):
    (lr, gr, xr), (lp, gp, xp) = ref, got
    assert abs(lr - lp) / abs(lr) < TOL
    ref_leaves = jax.tree.leaves(gr)
    got_leaves = jax.tree.leaves(gp)
    assert len(ref_leaves) == len(got_leaves)
    for a, b in zip(ref_leaves + [xr], got_leaves + [xp]):
        assert a.shape == b.shape
        assert float(np.abs(a - b).max()) / float(np.abs(a).max()) < TOL


_REF_CACHE = {}


def _ref(kind, n_fp=0, n_bp=None):
    key = (kind, n_fp, n_bp)
    if key not in _REF_CACHE:
        mods = ref_vgg16_modules(0.125, 3)
        trunk = make_column_apply(mods) if kind == "column" \
            else make_overlap_apply(mods, H, n_fp, n_rows_bp=n_bp)
        _REF_CACHE[key] = _ref_loss_and_grads(trunk)
    return _REF_CACHE[key]


def test_base_matches_column_reference():
    got = _port_loss_and_grads(ExecutionPlan.explicit("base", 1,
                                                      in_shape=SHAPE))
    _assert_close(_ref("column"), got)


@pytest.mark.parametrize("n_fp,n_bp", [(2, None), (4, None), (2, 3)])
def test_overlap_matches_reference(n_fp, n_bp):
    extras = {"n_rows_bp": n_bp} if n_bp else {}
    plan = ExecutionPlan.explicit("overlap", n_fp, in_shape=SHAPE, **extras)
    _assert_close(_ref("overlap", n_fp, n_bp), _port_loss_and_grads(plan))


def test_overlap_cuda_on_cpu_is_plain_and_launches_nothing():
    from repro_torch.exec import KernelSpec
    plan = ExecutionPlan.explicit("overlap_cuda", 4, in_shape=SHAPE,
                                  kernel=KernelSpec(backend="cuda"))
    with obs.profiling() as cap:
        _assert_close(_ref("column"), _port_loss_and_grads(plan))
    assert cap.count("conv2d_rows") == 0
    assert "conv2d_rows" not in {r.name for r in cap.records}


@pytest.mark.parametrize("n_rows", [1, 2, 3, 4])
def test_plan_overlap_chains_equal(n_rows):
    got = plan_overlap(vgg16_modules(0.125, 3), H, n_rows)
    want = ref_plan_overlap(ref_vgg16_modules(0.125, 3), H, n_rows)
    assert got.heights == want.heights
    assert got.row_ivs == want.row_ivs
    assert got.chains == want.chains
    assert got.overlap_rows_level0() == want.overlap_rows_level0()


def test_unported_engine_says_so():
    """Every engine of the reference is ported (the row pipeline came
    last); an unknown engine names the ported ones."""
    from repro_torch.exec.registry import NOT_PORTED
    assert NOT_PORTED == {}
    plan = ExecutionPlan.explicit("pipeline_rows", 2, in_shape=SHAPE)
    assert callable(build_apply(vgg16_modules(0.125, 3), plan))
    with pytest.raises(KeyError, match="unknown engine") as e:
        build_apply([], ExecutionPlan.explicit("nope"))
    assert "base, ckp, overlap, overlap_cuda, overlap_h" in str(e.value)
    assert "pipeline_rows, pipeline_seq" in str(e.value)


def test_sharded_and_offloading_plans_raise():
    """A sharded plan needs as many ranks as its mesh has devices (one
    process here: it raises and points to the per-device projection;
    ``tests/test_torch_sharding.py`` runs them in process groups);
    offloading residencies run."""
    import dataclasses
    plan = ExecutionPlan.explicit("overlap", 2, in_shape=SHAPE)
    mods = vgg16_modules(0.125, 3)
    with pytest.raises(ValueError, match=r"per_device\(\)"):
        build_apply(mods, dataclasses.replace(
            plan, mesh=MeshSpec.parse("data=2")))
    # a one-device mesh is fine, and a residency reaches the engine (the
    # 2PS engines place their caches by it; OverL carries none)
    build_apply(mods, dataclasses.replace(
        plan, mesh=MeshSpec.parse("data=1"),
        residency=ResidencySpec(default="device")))
    host = dataclasses.replace(plan, residency=ResidencySpec(default="host"))
    _assert_close(_ref("overlap", 2), _port_loss_and_grads(host))
