"""The port's conv2d_rows against the JAX package's Pallas kernel.

On the CPU the wrapper takes the kernel's plain version; it is held
against ``repro.kernels.conv2d_rows.conv2d_rows`` in interpret mode over
the shared ``conv_case`` table (tests/conftest.py) at 1e-5 relative, fp32.
The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.conv2d_rows import conv2d_rows as ref_conv2d_rows
from repro.kernels.conv2d_rows import halo_ok as ref_halo_ok
from repro_torch.kernels import conv2d_rows as cr
from repro_torch import obs
from repro_torch.kernels import ops
from repro_torch.kernels.ref import conv2d_ref

TOL = 1e-5


def _inputs(case, seed=0, batch=2):
    H, W, Cin, Cout, k, s, p, bh = case
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, H, W, Cin)).astype(np.float32)
    w = rng.normal(size=(k, k, Cin, Cout)).astype(np.float32)
    return x, w


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max()) / float(np.abs(a).max())


def test_plain_matches_pallas_interpret(conv_case):
    H, W, Cin, Cout, k, s, p, bh = conv_case
    x, w = _inputs(conv_case)
    want = ref_conv2d_rows(jnp.asarray(x), jnp.asarray(w), stride=s,
                           padding=p, block_h=bh, interpret=True)
    got = cr.conv2d_rows_plain(torch.tensor(x), torch.tensor(w), s, p, bh)
    assert _rel(want, got.numpy()) < TOL


def test_wrapper_on_cpu_takes_plain_and_counts_nothing(conv_case):
    H, W, Cin, Cout, k, s, p, bh = conv_case
    x, w = _inputs(conv_case, seed=1)
    with obs.profiling() as cap:
        got = ops.conv2d(torch.tensor(x), torch.tensor(w), s, p, bh)
    assert cap.count("conv2d_rows") == 0 and not cap.records
    want = conv2d_ref(torch.tensor(x), torch.tensor(w), s, p)
    assert _rel(want.numpy(), got.numpy()) < TOL


@pytest.mark.parametrize("h_out", [0, 1, 7, 14, 16, 224])
def test_candidate_tiles_equal(h_out):
    assert ops.candidate_tiles("conv", h_out=h_out) \
        == ref_ops.candidate_tiles("conv", h_out=h_out)
    # the chunked CUDA ssd_scan takes the reference's "ssd" space as it is
    assert ops.candidate_tiles("ssd") == ref_ops.candidate_tiles("ssd")
    with pytest.raises(ValueError, match="unknown tile kind 'mlp'"):
        ops.candidate_tiles("mlp")


def test_halo_ok_equal():
    for k in range(1, 8):
        for s in range(1, 4):
            for bh in range(1, 10):
                for h_out in (None, 1, 3, 8):
                    assert cr.halo_ok(k, s, bh, h_out) \
                        == ref_halo_ok(k, s, bh, h_out)


def test_launch_limits():
    # VGG-16 at the default block (10 x 18 window): the offset table + 2
    # stages of an 8-channel chunk's window and weights, at the wide Cout
    # tile (85,968 B) and at the narrow one for Cout <= 64 (49,104 B)
    assert cr.smem_bytes(8, 1, 3, 128) \
        == 4 * (180 + 2 * (180 * 8 + 9 * 8 * 128)) == 85968
    assert cr.smem_bytes(8, 1, 3, 64) \
        == 4 * (180 + 2 * (180 * 8 + 9 * 8 * 64)) == 49104
    assert cr.smem_bytes(8, 1, 3, 512) == cr.smem_bytes(8, 1, 3, 65)
    assert cr.launch_problem(8, 1, 3, 512) == ""
    assert "fp32" in cr.launch_problem(8, 1, 3, 64, dtype_bytes=2)
    assert "block_h" in cr.launch_problem(cr.CTA_PIXELS + 1, 1, 3, 64)
    assert "shared memory" in cr.launch_problem(8, 1, 3, 64, smem_limit=1000)
    for bh in ops.CONV_BLOCK_HS:
        assert bh * cr.tile_w(bh) <= cr.CTA_PIXELS


@pytest.mark.parametrize("bh,s,k,cout,cc", [
    (8, 1, 3, 512, 8),    # VGG-16
    (16, 1, 3, 64, 8),
    (1, 1, 3, 128, 8),    # one row of 128 columns
    (8, 1, 5, 128, 8),    # 221,120 B: still fits
    (8, 1, 7, 512, 4),    # 8 channels would overflow a CTA's 227 KiB
    (4, 2, 7, 8, 4),      # the k=7 stride-2 geometry case
    (32, 1, 10, 4, 4),    # the planner's k=10 retile case
])
def test_cin_chunk_fits_shared_memory(bh, s, k, cout, cc):
    assert cr.cin_chunk(bh, s, k, cout) == cc
    assert cr.smem_bytes(bh, s, k, cout) <= cr.SMEM_LIMIT
    if cc == 4:
        assert cr._smem(bh, s, k, cr.cout_tile(cout), 8) > cr.SMEM_LIMIT


def test_wrapper_rejects_bad_inputs():
    x = torch.zeros(1, 8, 8, 4)
    with pytest.raises(ValueError):
        ops.conv2d(x, torch.zeros(3, 3, 5, 8))       # Cin mismatch
    with pytest.raises(TypeError):
        ops.conv2d(x.double(), torch.zeros(3, 3, 4, 8).double())
    with pytest.raises(ValueError):
        cr.conv2d_rows(x, torch.zeros(3, 3, 4, 8))   # CPU tensor: no launch
    with pytest.raises(ValueError):
        ops.conv2d(x.to("meta"), torch.zeros(3, 3, 4, 8, device="meta"))

