"""The port's SSD scan and its op-level engine against the JAX package.

On the CPU the wrapper takes the kernel's plain version (the chunked SSD
form with the kernel's index math); it is held against the reference
Pallas kernel in interpret mode over the shared ``ssd_case`` table
(tests/conftest.py) at each case's own chunk, at 1e-5 relative (the same
chunked math in fp32, summed in another order), and against the
sequential oracle at every chunk of ``SSD_CHUNKS`` at 1e-5.  The
``seq_ssd_cuda`` op's gradients (plain forward, backward through the
oracle) are held against ``jax.vjp`` of ``ssd_scan_ref`` at 1e-5 relative.
The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.ref import ssd_scan_ref as jax_ssd_ref
from repro.kernels.ssd_chunk import ssd_scan as jax_ssd
from repro_torch.exec import ExecutionPlan, KernelSpec, get_engine
from repro_torch.exec.planner import kernelize_plan
from repro_torch import obs
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
    with obs.profiling() as cap:
        got = ops.ssd_scan(*(torch.tensor(a) for a in arrs), chunk=chunk)
    # CPU: plain, no launch, no kernel range
    assert cap.count("ssd_scan") == 0 and not cap.records
    want = jax_ssd(*(jnp.asarray(a) for a in arrs), chunk=chunk,
                   interpret=True)
    assert _rel(want, got.numpy()) < 1e-5


@pytest.mark.parametrize("chunk", ops.SSD_CHUNKS)
def test_plain_matches_oracle_at_every_chunk(ssd_case, chunk):
    Bt, S, H, P, N, _ = ssd_case
    arrs = [torch.tensor(a) for a in _inputs(Bt, S, H, P, N, seed=4)]
    got = ssd_chunk.ssd_scan_plain(*arrs, chunk=chunk)
    assert _rel(ssd_scan_ref(*arrs)[0].numpy(), got.numpy()) < 1e-5


def test_plain_finite_at_tiny_decay():
    """a down to 1e-30 at chunk 256: masking before exp keeps the acausal
    exp(cum_t - cum_s) (which overflows) out of the sum.  The in-chunk cum
    reaches about -2,300 here, where an fp32 ulp is 2.4e-4, so every decay
    of the chunked form carries ~1e-4 relative error: held at 1e-3."""
    arrs = [torch.tensor(a) for a in _inputs(1, 512, 2, 8, 16, seed=5)]
    arrs[3][:, ::3] = 1e-30
    got = ssd_chunk.ssd_scan_plain(*arrs, chunk=256)
    assert bool(torch.isfinite(got).all())
    assert _rel(ssd_scan_ref(*arrs)[0].numpy(), got.numpy()) < 1e-3


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


def test_smem_bytes_and_launch_limits():
    # Zamba2's N 64 (ldb 72): two stages of x (32 + 4 words a row), B and C
    # while they leave room for two CTAs per SM (115,712 B), the 32 x 72
    # state tile as hi and lo, an a/dt slot per stage and two Prep buffers
    # of three rows
    assert ssd_chunk.TWO_PER_SM == 115712
    assert ssd_chunk.stages(64, 64) == 2
    assert ssd_chunk.smem_bytes(64, 64) == 4 * (
        2 * 64 * (36 + 2 * 72) + 2 * 32 * 72 + 10 * 64) == 113152
    # two stages at chunk 128 would take 207,872 B (one CTA per SM): one
    assert 4 * (2 * 128 * (36 + 2 * 72) + 2 * 32 * 72 + 10 * 128) == 207872
    assert ssd_chunk.stages(128, 64) == 1
    assert ssd_chunk.smem_bytes(128, 64) == 4 * (
        128 * (36 + 2 * 72) + 2 * 32 * 72 + 8 * 128) == 114688
    assert ssd_chunk.smem_bytes(256, 64) == 210944
    # chunks under 16 rows pad to one 16-row m tile; N pads to 16, then to
    # 8 mod 16 words
    assert ssd_chunk.smem_bytes(8, 4) == ssd_chunk.smem_bytes(16, 16) \
        == 4 * (2 * 16 * (36 + 2 * 24) + 2 * 32 * 24 + 10 * 16)
    assert ssd_chunk.smem_bytes(32, 13) == ssd_chunk.smem_bytes(32, 16)
    for chunk in (256, 128, 64, 32, 16, 8):
        assert ssd_chunk.launch_problem(chunk, 64) == ""
        assert ssd_chunk.launch_problem(chunk, 16) == ""
    assert ssd_chunk.launch_problem(128, 128) == ""
    assert "shared memory" in ssd_chunk.launch_problem(256, 128)
    assert "outside" in ssd_chunk.launch_problem(64, 129)
    assert "outside" in ssd_chunk.launch_problem(64, 0)
    assert "shared memory" in ssd_chunk.launch_problem(64, 64, 100000)
    # the Gram pass's workspace: the causal 16 x 8 tiles of every chunk
    # (m tile i has 2i + 2), 128 floats each
    assert ssd_chunk.gram_floats(1, 4096, 128) == 32 * (8 * 9) * 128
    assert ssd_chunk.gram_floats(2, 64, 8) == 2 * 8 * (1 * 2) * 128


@pytest.mark.parametrize("seq", [0, 1, 8, 12, 48, 64, 96, 128, 200, 256,
                                 4096])
def test_candidate_tiles_ssd_equal(seq):
    assert ops.candidate_tiles("ssd", seq=seq) \
        == ref_ops.candidate_tiles("ssd", seq=seq)


def test_chunk_rows_clamps_and_raises():
    assert ssd_chunk.chunk_rows(128, 4096) == 128
    assert ssd_chunk.chunk_rows(256, 64) == 64   # min(chunk, S)
    with pytest.raises(ValueError, match="does not divide"):
        ssd_chunk.chunk_rows(64, 96)
    arrs = [torch.tensor(a) for a in _inputs(1, 96, 2, 4, 4)]
    with pytest.raises(ValueError, match="does not divide"):
        ops.ssd_scan(*arrs, chunk=64)


@pytest.mark.parametrize("spec,want", [
    (KernelSpec(backend="cuda", chunk=16), 16),
    (KernelSpec(backend="plain", chunk=8), 8),
    ("cuda", 64),     # retiled: chunk 128 at N 128 exceeds a 150,000 B limit
    (None, 128),      # a bare plan: the default spec
])
def test_engine_passes_plan_chunk(monkeypatch, spec, want):
    """The op launches ``ops.ssd_scan`` at the plan's chunk, as the
    reference's engine passes ``chunk=spec.chunk``."""
    seen = []
    real = ops.ssd_scan

    def spy(*args, chunk=128):
        seen.append(chunk)
        return real(*args, chunk=chunk)

    monkeypatch.setattr(ops, "ssd_scan", spy)
    plan = ExecutionPlan.explicit("seq_ssd_cuda", seq=256, ssm_state=128)
    if isinstance(spec, str):
        plan = kernelize_plan(plan, spec, smem_limit=150000)
        assert plan.get("kernel_retile")
    elif spec is not None:
        plan = dataclasses.replace(plan, kernel=spec)
    arrs = _inputs(1, 256, 2, 4, 8, seed=6)
    y = get_engine("seq_ssd_cuda").build(None, plan)(
        *(torch.tensor(a) for a in arrs))
    assert seen == [want]
    want_y = jax_ssd(*(jnp.asarray(a) for a in arrs), chunk=want,
                     interpret=True)
    assert _rel(want_y, y.numpy()) < 1e-5


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
