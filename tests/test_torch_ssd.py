"""The port's SSD scan and its op-level engine against the JAX package.

On the CPU the wrapper takes the kernel's plain version (the sequential
recurrence); it is held against the reference Pallas kernel in interpret
mode over the shared ``ssd_case`` table (tests/conftest.py) at the
reference kernel test's atol 1e-3 (the Pallas kernel's chunked form takes
``log(a + 1e-12)`` cumsums), and against the sequential oracle at 1e-5.
The ``seq_ssd_cuda`` op's gradients (plain forward, backward through the
oracle) are held against ``jax.vjp`` of ``ssd_scan_ref`` at 1e-5 relative.
The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssd_scan_ref as jax_ssd_ref
from repro.kernels.ssd_chunk import ssd_scan as jax_ssd
from repro_torch.exec import ExecutionPlan, KernelSpec, get_engine
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_chunk
from repro_torch.kernels.ref import ssd_scan_ref


def _inputs(Bt, S, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(Bt, S, H, P)) * 0.5
    B = rng.normal(size=(Bt, S, N)) * 0.5
    C = rng.normal(size=(Bt, S, N)) * 0.5
    dt = np.log1p(np.exp(rng.normal(size=(Bt, S, H))))
    a = np.exp(-dt * np.exp(rng.normal(size=(Bt, S, H)) * 0.1))
    return [v.astype(np.float32) for v in (x, B, C, a, dt)]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max()) / max(float(np.abs(a).max()), 1e-30)


def test_plain_matches_pallas_interpret(ssd_case):
    Bt, S, H, P, N, chunk = ssd_case
    arrs = _inputs(Bt, S, H, P, N)
    before = ops.ssd_scan.launches
    got = ops.ssd_scan(*(torch.tensor(a) for a in arrs))
    assert ops.ssd_scan.launches == before  # CPU: plain, no launch
    want = jax_ssd(*(jnp.asarray(a) for a in arrs), chunk=chunk,
                   interpret=True)
    assert float(np.abs(np.asarray(want) - got.numpy()).max()) < 1e-3


def test_oracle_matches_reference(ssd_case):
    Bt, S, H, P, N, _ = ssd_case
    arrs = _inputs(Bt, S, H, P, N, seed=1)
    y, h = ssd_scan_ref(*(torch.tensor(a) for a in arrs))
    wy, wh = jax_ssd_ref(*(jnp.asarray(a) for a in arrs))
    assert _rel(wy, y.numpy()) < 1e-5
    assert _rel(wh, h.numpy()) < 1e-5


@pytest.mark.parametrize("backend", ["cuda", "plain"])
def test_engine_op_gradients_match_jax_vjp(ssd_case, backend):
    Bt, S, H, P, N, _ = ssd_case
    arrs = _inputs(Bt, S, H, P, N, seed=2)
    g = np.random.default_rng(3).normal(size=(Bt, S, H, P)) \
        .astype(np.float32)
    want_y, vjp = jax.vjp(lambda *a: jax_ssd_ref(*a)[0],
                          *(jnp.asarray(a) for a in arrs))
    want = vjp(jnp.asarray(g))
    plan = ExecutionPlan.explicit("seq_ssd_cuda",
                                  kernel=KernelSpec(backend=backend))
    apply = get_engine("seq_ssd_cuda").build(None, plan)
    ins = [torch.tensor(a, requires_grad=True) for a in arrs]
    y = apply(*ins)
    y.backward(torch.tensor(g))
    assert _rel(want_y, y.detach().numpy()) < 1e-5
    for w, t in zip(want, ins):
        assert _rel(w, t.grad.numpy()) < 1e-5


def test_group_lanes_and_limits():
    assert [ssd_chunk.group_lanes(n) for n in (4, 8, 16, 64, 12, 7)] \
        == [4, 8, 8, 8, 4, 1]
    assert ssd_chunk.launch_problem(64) == ""
    assert ssd_chunk.launch_problem(128) == ""
    assert "per lane" in ssd_chunk.launch_problem(256)
    assert "per lane" in ssd_chunk.launch_problem(17)


def test_wrapper_raises_on_bad_input():
    x = torch.zeros(1, 8, 2, 4)
    bc, ad = torch.zeros(1, 8, 4), torch.zeros(1, 8, 2)
    with pytest.raises(TypeError, match="fp32"):
        ops.ssd_scan(x.double(), bc, bc, ad, ad)
    with pytest.raises(ValueError, match="do not fit"):
        ops.ssd_scan(x, bc, bc, ad[:, :4], ad)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.ssd_scan(*(t.to("meta") for t in (x, bc, bc, ad, ad)))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ssd_chunk.ssd_scan(x, bc, bc, ad, ad)
