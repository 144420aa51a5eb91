"""The port's sliding-window attention against the JAX package.

On the CPU the wrapper takes the kernel's plain version (the blockwise
online-softmax loop with the kernel's index math); it is held against the
reference Pallas kernel in interpret mode and the dense oracle
``swa_attention_ref`` over the shared ``swa_case`` table
(tests/conftest.py), at the reference kernel tests' tolerances: fp32 2e-5,
bf16 2e-2 (``allclose`` atol and rtol).  The CUDA kernel itself runs only
on the card: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.ref import swa_attention_ref as jax_swa_ref
from repro.kernels.swa_attention import swa_attention as jax_swa
from repro_torch import obs
from repro_torch.kernels import ops
from repro_torch.kernels import swa_attention as sw
from repro_torch.kernels.ref import swa_attention_ref

DTYPES = {"fp32": (torch.float32, jnp.float32, 2e-5),
          "bf16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _inputs(S, D, seed=0, B=2, H=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, S, D)).astype(np.float32)
            for _ in range(3)]


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.allclose(got, want, atol=tol, rtol=tol), \
        float(np.abs(got - want).max())


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_pallas_interpret_and_oracle(swa_case, dtype):
    S, D, window, bq, bk = swa_case
    tdt, jdt, tol = DTYPES[dtype]
    arrs = _inputs(S, D)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in arrs)
    tq, tk, tv = (torch.tensor(a).to(tdt) for a in arrs)
    with obs.profiling() as cap:
        got = ops.swa_attention(tq, tk, tv, window, bq, bk)
    # CPU: plain, no launch, no kernel range
    assert cap.count("swa_attention") == 0 and not cap.records
    assert got.dtype == tdt
    got = got.float().numpy()
    pallas = jax_swa(jq, jk, jv, window=window, bq=bq, bk=bk,
                     interpret=True)
    _close(got, pallas.astype(jnp.float32), tol)
    _close(got, jax_swa_ref(jq, jk, jv, window).astype(jnp.float32), tol)


def test_dense_oracle_matches_reference(swa_case):
    S, D, window, _, _ = swa_case
    arrs = _inputs(S, D, seed=1)
    got = swa_attention_ref(*(torch.tensor(a) for a in arrs), window)
    want = jax_swa_ref(*(jnp.asarray(a) for a in arrs), window)
    _close(got.numpy(), want, 1e-5)


def test_plain_takes_strided_views():
    """The LM path hands (B, H, S, D) views of (B, S, H, D) tensors."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.tensor(rng.normal(size=(1, 128, 4, 64)),
                            dtype=torch.float32).transpose(1, 2)
               for _ in range(3))
    got = ops.swa_attention(q, k, v, 32, 64, 32)
    want = swa_attention_ref(q, k, v, 32)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("seq", [0, 8, 64, 96, 128, 4096])
def test_candidate_tiles_equal(seq):
    assert ops.candidate_tiles("swa", seq=seq) \
        == ref_ops.candidate_tiles("swa", seq=seq)


def test_tiles_follow_the_reference_contract():
    # n_kv = min(ceil((bq + window) / bk), S / bk); pad = n_kv*bk - bq
    assert sw.tiles(4096, 1024, 128, 128) == (128, 128, 9, 1024)
    assert sw.tiles(256, 0, 128, 64) == (128, 64, 4, 128)
    assert sw.tiles(128, 200, 64, 64) == (64, 64, 2, 64)
    assert sw.tiles(64, 16, 128, 128) == (64, 64, 1, 0)  # clamped to S
    for bad in ((256, 96, 32), (256, 64, 128), (256, 128, 48)):
        with pytest.raises(ValueError, match="does not tile"):
            sw.tiles(bad[0], 16, bad[1], bad[2])


def test_smem_pricing():
    # Gemma-3 4B at the default tiles, bf16 (tensor-core layout): the whole
    # q block + 2 stages of 64-row K and V tiles; bk does not enter
    assert sw.smem_bytes(128, 128, 256, 2) \
        == 2 * 256 * (128 + 2 * 2 * 64) == 196608
    assert sw.smem_bytes(128, 32, 256, 2) == 196608
    assert sw.launch_problem(128, 128, 256, 2) == ""
    # fp32 (SIMT layout): K (padded) + V + 32 fp32 q rows; bq does not enter
    assert sw.smem_bytes(256, 64, 256, 4) \
        == 4 * (64 * 257 + 64 * 256 + 32 * 256) == 164096
    assert "exceeds" in sw.launch_problem(128, 128, 256, 4)
    assert sw.launch_problem(256, 64, 256, 4) == ""
    assert "multiple of 32" in sw.launch_problem(64, 64, 80, 4)
    assert "fp32 or bf16" in sw.launch_problem(64, 64, 64, 8)


@pytest.mark.parametrize("bq,bk,d,db,problem", [
    (128, 128, 256, 2, ""),
    (16, 8, 64, 2, ""),           # the smallest q block: one warp
    (256, 128, 64, 2, "bq=256"),  # more than 8 warps
    (8, 8, 64, 2, "bq=8"),        # fewer than 16 query rows
    (48, 16, 64, 2, ""),
    (40, 8, 64, 2, "bq=40"),      # not a whole number of warps
    (256, 64, 64, 4, ""),         # fp32 takes any bq
    (512, 512, 32, 4, "bk=512 exceeds"),  # fp32: lanes own 8 key groups
])
def test_launch_problem_bf16_tensor_core_rules(bq, bk, d, db, problem):
    got = sw.launch_problem(bq, bk, d, db)
    assert (problem in got) if problem else got == ""


def test_wrapper_raises_on_bad_input():
    q = torch.zeros(1, 2, 64, 32)
    with pytest.raises(ValueError, match="does not tile"):
        ops.swa_attention(q, q, q, 16, bq=48, bk=16)
    with pytest.raises(TypeError):
        ops.swa_attention(q.double(), q.double(), q.double(), 16)
    meta = torch.empty(1, 2, 64, 32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.swa_attention(meta, meta, meta, 16)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        sw.swa_attention(q, q, q, window=16)
