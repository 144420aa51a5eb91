"""ResNet-50 in the port against the JAX package: ``BatchNorm``, the
moment helpers, ``Bottleneck`` (``apply`` and ``apply_row`` on random
intervals, stride 1 and 2, identity and projection shortcuts), the module
list and init shapes, and the ``base`` / ``overlap`` engines on the
reduced trunk (``stage_blocks=[1, 1, 1, 1]``, width 0.125, as the
reference's row-engine tests use it).

Inputs and parameters are made with numpy from a seed and handed to both
packages; values and gradients must agree to 1e-5 relative (fp32), every
interval must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.overlap import make_column_apply, make_overlap_apply
from repro.models.cnn import layers as ref_layers
from repro.models.cnn import resnet as ref_resnet
from repro_torch.exec import ExecutionPlan, build_apply
from repro_torch.models.cnn import layers as pt_layers
from repro_torch.models.cnn import resnet as pt_resnet
from repro_torch.optim.adamw import tree_leaves

TOL = 1e-5
H = 64
SHAPE = (H, H, 3)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max()) / max(float(np.abs(a).max()), 1e-30)


def _np_bn(rng, c):
    return {"scale": (1 + 0.1 * rng.normal(size=c)).astype(np.float32),
            "bias": (0.1 * rng.normal(size=c)).astype(np.float32),
            "mean": (0.1 * rng.normal(size=c)).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, size=c).astype(np.float32)}


def _np_conv(rng, m, cin):
    p = {"w": (rng.normal(size=(m.k, m.k, cin, m.cout))
               * np.sqrt(2.0 / (m.k * m.k * cin))).astype(np.float32)}
    if m.bias:
        p["b"] = (0.1 * rng.normal(size=m.cout)).astype(np.float32)
    return p


def np_module_params(rng, m, shape):
    """Random numpy params of one reference module at input ``shape``
    (non-trivial BatchNorm statistics so they are exercised)."""
    if isinstance(m, ref_layers.Conv):
        return _np_conv(rng, m, shape[2])
    if isinstance(m, ref_layers.BatchNorm):
        return _np_bn(rng, shape[2])
    if isinstance(m, ref_layers.Bottleneck):
        c1, c2, c3, sc = m._parts()
        p, s = {}, shape
        for name, conv in (("c1", c1), ("c2", c2), ("c3", c3)):
            p[name] = _np_conv(rng, conv, s[2])
            s = conv.out_shape(s)
            p[name + "_bn"] = _np_bn(rng, s[2])
        if sc is not None:
            p["sc"] = _np_conv(rng, sc, shape[2])
            p["sc_bn"] = _np_bn(rng, m.cout)
        return p
    return {}


def np_trunk(mods, shape, seed, n_classes=10):
    rng = np.random.default_rng(seed)
    trunk = []
    for m in mods:
        trunk.append(np_module_params(rng, m, shape))
        shape = m.out_shape(shape)
    head = {"w": (rng.normal(size=(shape[2], n_classes))
                  / np.sqrt(shape[2])).astype(np.float32),
            "b": np.zeros(n_classes, np.float32)}
    return {"trunk": tuple(trunk), "head": head}


def _pt(tree):
    return pt_layers.params_from_reference(tree, device="cpu")


def _x(shape, seed=1, batch=2):
    return np.random.default_rng(seed).normal(size=(batch,) + shape) \
        .astype(np.float32)


BLOCKS = {
    "identity": dict(cmid=4, cout=16, s=1, project=False),
    "project_s1": dict(cmid=4, cout=16, s=1, project=True),
    "project_s2": dict(cmid=8, cout=32, s=2, project=True),
}


def _block_pair(name, cin=16, seed=0):
    ref_m = ref_layers.Bottleneck(**BLOCKS[name])
    pt_m = pt_layers.Bottleneck(**BLOCKS[name])
    tree = np_module_params(np.random.default_rng(seed), ref_m,
                            (12, 10, cin))
    return ref_m, pt_m, tree


def test_batchnorm_apply_and_row_match_reference():
    rng = np.random.default_rng(0)
    p = _np_bn(rng, 4)
    x = _x((12, 10, 4))
    ref_m, pt_m = ref_layers.BatchNorm(), pt_layers.BatchNorm()
    pt_p = {k: torch.tensor(v) for k, v in p.items()}
    want = ref_m.apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    assert _rel(want, pt_m.apply(pt_p, torch.tensor(x))) < TOL
    for iv_in, out_iv in (((0, 12), (3, 9)), ((2, 7), (2, 7)),
                          ((4, 11), (5, 6))):
        xs = x[:, iv_in[0]:iv_in[1]]
        want = ref_m.apply_row(jax.tree.map(jnp.asarray, p), jnp.asarray(xs),
                               iv_in, 12, out_iv)
        got = pt_m.apply_row(pt_p, torch.tensor(xs), iv_in, 12, out_iv)
        assert _rel(want, got) < TOL
    init = pt_m.init(None, (12, 10, 4), device="cpu")
    ref_init = ref_m.init(jax.random.PRNGKey(0), (12, 10, 4))
    for k in ref_init:
        np.testing.assert_array_equal(np.asarray(ref_init[k]),
                                      init[k].numpy())


def test_moments_match_reference():
    xs = [_x((5, 6, 3), seed=s) for s in (1, 2, 3)]
    want = ref_layers.merge_moments(*[ref_layers.batch_moments(
        jnp.asarray(x)) for x in xs])
    got = pt_layers.merge_moments(*[pt_layers.batch_moments(
        torch.tensor(x)) for x in xs])
    for a, b in zip(want, got):
        assert _rel(a, b) < TOL
    whole = np.concatenate(xs, axis=1)
    assert _rel(whole.mean(axis=(0, 1, 2)), got[0]) < TOL
    assert _rel(whole.var(axis=(0, 1, 2)), got[1]) < 1e-4


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_bottleneck_apply_matches_reference(name):
    ref_m, pt_m, tree = _block_pair(name)
    x = _x((12, 10, 16))
    want = ref_m.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    got = pt_m.apply(pt_layers.params_from_reference(
        {"trunk": [tree], "head": {}}, "cpu")["trunk"][0], torch.tensor(x))
    assert _rel(want, got) < TOL
    assert pt_m.out_shape((12, 10, 16)) == ref_m.out_shape((12, 10, 16))


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_bottleneck_apply_row_matches_reference_on_random_intervals(name):
    ref_m, pt_m, tree = _block_pair(name, seed=3)
    pt_p = pt_layers.params_from_reference(
        {"trunk": [tree], "head": {}}, "cpu")["trunk"][0]
    h_in = 12
    x = _x((h_in, 10, 16), seed=4)
    h_out = ref_m.out_shape((h_in, 10, 16))[0]
    rng = np.random.default_rng(5)
    for _ in range(8):
        a = int(rng.integers(0, h_out))
        b = int(rng.integers(a + 1, h_out + 1))
        iv_in = ref_m.in_interval((a, b), h_in)
        assert pt_m.in_interval((a, b), h_in) == iv_in
        xs = x[:, iv_in[0]:iv_in[1]]
        want = ref_m.apply_row(jax.tree.map(jnp.asarray, tree),
                               jnp.asarray(xs), iv_in, h_in, (a, b))
        got = pt_m.apply_row(pt_p, torch.tensor(xs), iv_in, h_in, (a, b))
        assert _rel(want, got) < TOL, (a, b, iv_in)


@pytest.mark.parametrize("width,blocks", [(0.125, [1, 1, 1, 1]),
                                          (1.0, None)])
def test_resnet50_modules_and_init_shapes_match_reference(width, blocks):
    ref_m = ref_resnet.resnet50_modules(width, blocks)
    pt_m = pt_resnet.resnet50_modules(width, blocks)
    assert [type(m).__name__ for m in pt_m] \
        == [type(m).__name__ for m in ref_m]
    # every field the port keeps (the reference's Conv also has a dtype)
    assert [vars(m) for m in pt_m] \
        == [{k: getattr(r, k) for k in vars(m)} for m, r in zip(pt_m, ref_m)]
    assert pt_layers.trunk_heights(pt_m, 224) \
        == ref_layers.trunk_heights(ref_m, 224)
    if width == 1.0:
        return  # full-width init is the chip's; shapes are fixed above
    ref_p = jax.eval_shape(lambda k: ref_resnet.init_resnet50(
        k, SHAPE, width, stage_blocks=blocks)[1], jax.random.PRNGKey(0))
    _, pt_p = pt_resnet.init_resnet50(torch.Generator().manual_seed(0),
                                      SHAPE, width, stage_blocks=blocks,
                                      device="cpu")
    assert [tuple(l.shape) for l in jax.tree.leaves(ref_p)] \
        == [tuple(t.shape) for t in tree_leaves(pt_p)]


def _loss_and_grads_ref(trunk_apply, tree, x, labels):
    def loss(p, xx):
        logits = ref_resnet.head_apply(p["head"], trunk_apply(p["trunk"], xx))
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], 1))
    val, (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    return float(val), [np.asarray(l) for l in jax.tree.leaves(gp)], \
        np.asarray(gx)


def _loss_and_grads_pt(plan, mods, tree, x, labels):
    p = _pt(tree)
    for t in tree_leaves(p):
        t.requires_grad_()
    xt = torch.tensor(x, requires_grad=True)
    apply = build_apply(mods, plan)
    logits = pt_resnet.head_apply(p["head"], apply(p["trunk"], xt))
    loss = -torch.log_softmax(logits, -1).gather(
        1, torch.tensor(labels)[:, None]).mean()
    loss.backward()
    return loss.item(), [t.grad.numpy() for t in tree_leaves(p)], \
        xt.grad.numpy()


@pytest.mark.parametrize("engine,n", [("base", 1), ("overlap", 2)])
def test_engine_loss_and_grads_match_reference(engine, n):
    blocks = [1, 1, 1, 1]
    ref_m = ref_resnet.resnet50_modules(0.125, blocks)
    pt_m = pt_resnet.resnet50_modules(0.125, blocks)
    tree = np_trunk(ref_m, SHAPE, seed=0)
    x = _x(SHAPE)
    labels = np.array([3, 7])
    ref_apply = make_column_apply(ref_m) if engine == "base" \
        else make_overlap_apply(ref_m, H, n)
    want = _loss_and_grads_ref(ref_apply, tree, x, labels)
    got = _loss_and_grads_pt(ExecutionPlan.explicit(engine, n,
                                                    in_shape=SHAPE),
                             pt_m, tree, x, labels)
    assert abs(want[0] - got[0]) / abs(want[0]) < TOL
    assert len(want[1]) == len(got[1])
    for a, b in zip(want[1] + [want[2]], got[1] + [got[2]]):
        assert _rel(a, b) < TOL


def test_forward_matches_reference():
    blocks = [1, 1, 1, 1]
    ref_m = ref_resnet.resnet50_modules(0.125, blocks)
    pt_m = pt_resnet.resnet50_modules(0.125, blocks)
    tree = np_trunk(ref_m, SHAPE, seed=2)
    x = _x(SHAPE, seed=6)
    want = ref_resnet.forward(ref_m, jax.tree.map(jnp.asarray, tree),
                              jnp.asarray(x))
    got = pt_resnet.forward(pt_m, _pt(tree), torch.tensor(x))
    assert _rel(want, got) < TOL
