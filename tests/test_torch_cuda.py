"""The port's CUDA kernels and kernel engines on the card.

Every test here needs a CUDA device (marker ``requires_cuda``) and skips
without one.  The file imports neither JAX nor the JAX package, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m requires_cuda \\
        tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports JAX.)  The kernel is held
against its plain version at 1e-4 of the output's largest magnitude (fp32
sums in another order); the kernel engine's loss and gradients against the
``base`` engine at 1e-5 relative.  ``swa_attention`` is held against its
plain version at the reference kernel tests' tolerances (fp32 2e-5, bf16
2e-2, as ``allclose`` atol and rtol), and at Gemma-3 4B's local-layer
shape in bf16 at ``chip_smoke.py``'s atol 4e-3 / rtol 1e-2; ``ssd_scan``
against its chunked plain version (and once against the sequential oracle)
at atol 1e-3.  The row-program executor's host and recompute residencies
are held against device residency exactly (cuDNN in deterministic mode):
placement moves bytes, never values; the reduced Zamba2 and xLSTM
gradients under host and recompute residency are held against device
residency's at 1e-5 (another summation order), two steps' losses at 1e-6
relative.
"""

import numpy as np
import pytest
import torch

#: (H, W, Cin, Cout, k, s, p, block_h): the kernel tests' shared geometry
#: cases, then VGG-16/224 shapes (ragged H_out % 8 at 14, Cin = 3), then
#: the 28^2 and 14^2 layers with a ragged Cout (500: 16-byte weight copies,
#: a partial 128-wide tile; 510: 4-byte copies)
CASES = [
    (16, 16, 8, 16, 3, 1, 1, 4),
    (17, 13, 4, 8, 3, 1, 0, 8),
    (32, 32, 8, 8, 5, 1, 2, 8),
    (16, 16, 8, 16, 3, 2, 1, 4),
    (24, 24, 4, 8, 7, 2, 3, 4),
    (14, 14, 16, 32, 1, 1, 0, 8),
    (9, 9, 3, 4, 3, 1, 1, 2),
    (64, 8, 4, 4, 3, 1, 1, 16),
    (224, 224, 3, 64, 3, 1, 1, 8),
    (56, 56, 128, 256, 3, 1, 1, 8),
    (14, 14, 512, 512, 3, 1, 1, 8),
    (28, 28, 256, 512, 3, 1, 1, 8),
    (28, 28, 256, 500, 3, 1, 1, 8),
    (14, 14, 512, 510, 3, 1, 1, 8),
    # ResNet-50's stem: stride-2 halo'd window, Cin 3 of an 8-channel chunk
    (224, 224, 3, 64, 7, 2, 3, 8),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_kernel_matches_plain(case, cuda_device):
    from repro_torch.kernels import conv2d_rows as cr
    from repro_torch.kernels import ops
    H, W, cin, cout, k, s, p, bh = case
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(2, H, W, cin)), dtype=torch.float32,
                     device=cuda_device)
    w = torch.tensor(rng.normal(size=(k, k, cin, cout)), dtype=torch.float32,
                     device=cuda_device)
    before = ops.conv2d.launches
    got = ops.conv2d(x, w, s, p, bh)
    torch.cuda.synchronize()
    assert ops.conv2d.launches == before + 1
    want = cr.conv2d_rows_plain(x, w, s, p, bh)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.requires_cuda
def test_kernel_rejects_what_it_cannot_run(cuda_device):
    from repro_torch.kernels import conv2d_rows as cr
    x = torch.zeros(1, 8, 8, 4, device=cuda_device)
    w = torch.zeros(3, 3, 4, 8, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        cr.conv2d_rows(x.transpose(1, 2), w)
    with pytest.raises(TypeError):
        cr.conv2d_rows(x.half(), w.half())
    lib = cr._lib()
    for bh, st, kk, cout in ((8, 1, 3, 64), (8, 1, 3, 512), (4, 2, 7, 8),
                             (32, 1, 10, 4)):
        assert lib.conv2d_rows_smem_bytes(kk, st, bh, cr.tile_w(bh), cout) \
            == cr.smem_bytes(bh, st, kk, cout)


@pytest.mark.requires_cuda
def test_overlap_cuda_matches_base(cuda_device):
    from repro_torch.exec import ExecutionPlan, KernelSpec, build_apply
    from repro_torch.kernels import ops
    from repro_torch.models.cnn.vgg import head_apply, init_vgg16
    shape = (32, 32, 3)
    mods, params = init_vgg16(torch.Generator().manual_seed(0), shape,
                              0.25, 10, 3, device=cuda_device)
    x = torch.randn((2,) + shape, generator=torch.Generator().manual_seed(1))
    x = x.to(cuda_device)
    results = {}
    for engine in ("base", "overlap_cuda"):
        plan = ExecutionPlan.explicit(engine, 2, in_shape=shape,
                                      kernel=KernelSpec(backend="cuda"))
        apply = build_apply(mods, plan)
        p = [{k: v.detach().clone().requires_grad_() for k, v in d.items()}
             for d in params["trunk"]]
        before = ops.conv2d.launches
        loss = head_apply(params["head"], apply(p, x)).square().sum()
        loss.backward()
        results[engine] = (loss.item(), [v.grad for d in p
                                         for v in d.values()],
                           ops.conv2d.launches - before)
    (lb, gb, nb), (lk, gk, nk) = results["base"], results["overlap_cuda"]
    assert nb == 0 and nk == 7  # one launch per conv, none in backward
    assert abs(lb - lk) / abs(lb) < 1e-5
    for a, b in zip(gb, gk):
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())


#: (S, D, window, bq, bk): the kernel tests' shared SWA cases, then
#: Gemma-3 4B's local layers (D 256, window 1024) at the plan's tiles
SWA_CASES = [
    (256, 64, 64, 64, 32),
    (256, 64, 0, 128, 64),
    (512, 32, 128, 128, 128),
    (256, 64, 100, 64, 32),
    (128, 128, 32, 32, 32),
    (128, 64, 200, 64, 64),
    (4096, 256, 1024, 128, 128),
]
#: (atol, rtol) of chip_smoke.py's bf16 check at the Gemma shape
SWA_GEMMA_BF16_TOL = (4e-3, 1e-2)
#: (Bt, S, H, P, N, chunk): the kernel tests' shared SSD cases, then
#: Zamba2-7B's Mamba2 widths (H 32, P 224, N 64) at the default chunk, then
#: a ragged P and N (partial P tile, N padded to 8, 4-byte copies)
SSD_CASES = [
    (2, 64, 4, 16, 8, 16),
    (1, 128, 2, 8, 4, 32),
    (2, 32, 4, 16, 8, 32),
    (1, 64, 8, 8, 16, 8),
    (1, 4096, 32, 224, 64, 128),
    (1, 256, 3, 45, 13, 64),
]
#: every chunk the planner may pick (candidate_tiles("ssd"))
SSD_CHUNKS = (256, 128, 64, 32, 16, 8)


def _swa_inputs(S, D, dtype, device, B=1, H=8, seed=0):
    """(B, H, S, D) views of (B, S, H, D) tensors, the layout the LM path
    hands the kernel."""
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=(B, S, H, D)), dtype=torch.float32)
            .to(device=device, dtype=dtype).transpose(1, 2)
            for _ in range(3)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", SWA_CASES, ids=lambda c: "x".join(map(str, c)))
def test_swa_kernel_matches_plain(case, dtype, cuda_device):
    from repro_torch.kernels import ops
    from repro_torch.kernels.swa_attention import (
        launch_problem, swa_attention_plain,
    )
    S, D, window, bq, bk = case
    if launch_problem(min(bq, S), min(bk, S), D, dtype.itemsize):
        bk = 64  # fp32 at D=256: the planner retiles the same way
    q, k, v = _swa_inputs(S, D, dtype, cuda_device)
    before = ops.swa_attention.launches
    got = ops.swa_attention(q, k, v, window, bq, bk)
    torch.cuda.synchronize()
    assert ops.swa_attention.launches == before + 1
    assert got.stride() == q.stride()
    want = swa_attention_plain(q, k, v, window, bq, bk)
    atol = rtol = 2e-5 if dtype == torch.float32 else 2e-2
    if dtype == torch.bfloat16 and case == SWA_CASES[-1]:
        atol, rtol = SWA_GEMMA_BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32-simt", "bf16-tensor-core"])
@pytest.mark.parametrize("D", [64, 256])
def test_swa_each_instantiation_launches_and_matches(D, dtype, cuda_device):
    """The bf16 (tensor-core) and fp32 (SIMT) kernels at a narrow and at
    Gemma's head dim, over a window that spans several 64-key stages."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.swa_attention import swa_attention_plain
    S, window, bq, bk = 512, 200, 128, 64
    q, k, v = _swa_inputs(S, D, dtype, cuda_device, B=2, H=2, seed=D)
    before = ops.swa_attention.launches
    got = ops.swa_attention(q, k, v, window, bq, bk)
    torch.cuda.synchronize()
    assert ops.swa_attention.launches == before + 1
    want = swa_attention_plain(q, k, v, window, bq, bk)
    atol, rtol = (2e-5, 2e-5) if dtype == torch.float32 \
        else SWA_GEMMA_BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def _ssd_inputs(Bt, S, H, P, N, device, seed=1):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    x = t(rng.normal(size=(Bt, S, H, P)) * 0.5)
    B = t(rng.normal(size=(Bt, S, N)) * 0.5)
    C = t(rng.normal(size=(Bt, S, N)) * 0.5)
    dt = torch.nn.functional.softplus(t(rng.normal(size=(Bt, S, H))))
    a = torch.exp(-dt * torch.exp(t(rng.normal(size=(Bt, S, H)) * 0.1)))
    return x, B, C, a, dt


def _ssd_check(ins, chunk):
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_chunk import ssd_scan_plain
    before = ops.ssd_scan.launches
    got = ops.ssd_scan(*ins, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.ssd_scan.launches == before + 1
    want = ssd_scan_plain(*ins, chunk=chunk)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-3
    return got


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", SSD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_ssd_kernel_matches_plain(case, cuda_device):
    *shape, chunk = case
    _ssd_check(_ssd_inputs(*shape, cuda_device), chunk)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("chunk", SSD_CHUNKS)
def test_ssd_kernel_at_every_fitting_chunk(chunk, cuda_device):
    """Zamba2's head widths (P 224, N 64) over four heads at each chunk
    whose shared memory fits; the sequential oracle agrees too."""
    from repro_torch.kernels import ssd_chunk
    from repro_torch.kernels.ref import ssd_scan_ref
    ins = _ssd_inputs(1, 512, 4, 224, 64, cuda_device, seed=chunk)
    if ssd_chunk.launch_problem(chunk, 64):
        with pytest.raises(ValueError, match="shared memory"):
            ssd_chunk.ssd_scan(*ins, chunk=chunk)
        return
    got = _ssd_check(ins, chunk)
    want = ssd_scan_ref(*ins)[0]
    assert float((got - want).abs().max()) <= 1e-3


@pytest.mark.requires_cuda
@pytest.mark.parametrize("chunk", [128, 256])
def test_ssd_kernel_single_chunk(chunk, cuda_device):
    """chunk == S, and a chunk above S (clamped to S, as the reference
    does): one chunk, no carried state."""
    _ssd_check(_ssd_inputs(2, 128, 2, 40, 16, cuda_device), chunk)


@pytest.mark.requires_cuda
def test_ssd_kernel_no_nan_at_tiny_decay(cuda_device):
    """a down to 1e-30 at chunk 256 (N 16: chunk 256 fits): cum falls by ~28 a step, so an
    unmasked exp(cum_t - cum_s) above the diagonal overflows; the mask
    before exp keeps the output finite.  cum reaches about -2,300, where an
    fp32 ulp is 2.4e-4, so each decay of either chunked form carries ~1e-4
    relative error: held at 1e-3 of the output's largest magnitude."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_chunk import ssd_scan_plain
    x, B, C, a, dt = _ssd_inputs(1, 512, 2, 64, 16, cuda_device)
    a = a.clone()
    a[:, ::3] = 1e-30
    got = ops.ssd_scan(x, B, C, a, dt, chunk=256)
    torch.cuda.synchronize()
    want = ssd_scan_plain(x, B, C, a, dt, chunk=256)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


@pytest.mark.requires_cuda
def test_ssd_kernel_raises_when_chunk_does_not_divide(cuda_device):
    from repro_torch.kernels import ops
    ins = _ssd_inputs(1, 96, 2, 32, 16, cuda_device)
    before = ops.ssd_scan.launches
    with pytest.raises(ValueError, match="does not divide"):
        ops.ssd_scan(*ins, chunk=64)
    assert ops.ssd_scan.launches == before


@pytest.mark.requires_cuda
def test_new_kernels_raise_rather_than_fall_back(cuda_device):
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_chunk, swa_attention
    q, k, v = _swa_inputs(256, 64, torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="does not tile"):
        ops.swa_attention(q, k, v, 64, bq=96, bk=32)   # S % bq != 0
    with pytest.raises(ValueError, match="does not tile"):
        ops.swa_attention(q, k, v, 64, bq=64, bk=128)  # bk > bq
    with pytest.raises(TypeError):
        ops.swa_attention(q.half(), k.half(), v.half(), 64)
    meta = [torch.empty(1, 2, 64, 64, device="meta") for _ in range(3)]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.swa_attention(*meta, 16)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        swa_attention.swa_attention(*(t.cpu() for t in (q, k, v)),
                                    window=64)
    x = torch.zeros(1, 8, 2, 4, device=cuda_device)
    bc = torch.zeros(1, 8, 4, device=cuda_device)
    ad = torch.zeros(1, 8, 2, device=cuda_device)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.ssd_scan(*(t.to("meta") for t in (x, bc, bc, ad, ad)))
    with pytest.raises(TypeError, match="fp32"):
        ops.ssd_scan(x.double(), bc, bc, ad, ad)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_chunk.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3),
                           bc, bc, ad, ad)
    base = torch.zeros(1, 2, 256, 68, dtype=torch.bfloat16,
                       device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        ops.swa_attention(*(base[..., :64],) * 3, 64)  # 136-byte rows
    lib = swa_attention._lib()
    for bq, bk, d, db in ((128, 128, 256, 2), (32, 32, 64, 2),
                          (256, 64, 256, 4), (64, 32, 64, 4)):
        assert lib.swa_attention_smem_bytes(bq, bk, d, db) \
            == swa_attention.smem_bytes(bq, bk, d, db)
    ssd_lib = ssd_chunk._lib()
    for chunk, n in ((128, 64), (64, 64), (8, 4), (256, 13), (64, 128),
                     (256, 64)):
        assert ssd_lib.ssd_scan_smem_bytes(chunk, n) \
            == ssd_chunk.smem_bytes(chunk, n)
        assert ssd_lib.ssd_scan_workspace_floats(2, 4096, chunk) \
            == ssd_chunk.gram_floats(2, 4096, chunk)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("engine", ["overlap_cuda", "seq_swa_cuda",
                                    "seq_ssd_cuda"])
def test_cuda_engine_on_plain_spec_still_launches(engine, cuda_device):
    """A ``*_cuda`` plan carrying a plain-backend spec (as a reference plan
    on the lax backend loads) launches its kernel on CUDA tensors: the
    device decides, never the spec."""
    from repro_torch.exec import ExecutionPlan, KernelSpec, build_apply
    from repro_torch.kernels import ops
    from repro_torch.models.cnn.vgg import init_vgg16
    spec = KernelSpec(backend="plain")
    if engine == "overlap_cuda":
        shape = (32, 32, 3)
        mods, params = init_vgg16(torch.Generator().manual_seed(0), shape,
                                  0.25, 10, 3, device=cuda_device)
        plan = ExecutionPlan.explicit(engine, 2, in_shape=shape, kernel=spec)
        args = (params["trunk"], torch.randn((2,) + shape,
                                             device=cuda_device))
        counter, want = ops.conv2d, 7
    elif engine == "seq_swa_cuda":
        mods = None
        plan = ExecutionPlan.explicit(engine, kernel=spec, window=64)
        args = [t.transpose(1, 2) for t in
                _swa_inputs(256, 64, torch.bfloat16, cuda_device)]
        counter, want = ops.swa_attention, 1
    else:
        mods = None
        plan = ExecutionPlan.explicit(engine, kernel=spec)
        x = torch.randn(1, 64, 2, 8, device=cuda_device)
        bc = torch.randn(1, 64, 4, device=cuda_device)
        dt = torch.rand(1, 64, 2, device=cuda_device)
        args = (x, bc, bc, torch.exp(-dt), dt)
        counter, want = ops.ssd_scan, 1
    before = counter.launches
    out = build_apply(mods, plan)(*args)
    torch.cuda.synchronize()
    assert counter.launches == before + want
    assert bool(torch.isfinite(out.float()).all())


# ---------------------------------------------------------------------------
# The row-program executor's residencies on the card
# ---------------------------------------------------------------------------


def _twophase_run(device, policy, depth, engine="twophase", n=2):
    """Loss output, grads and the saved carries of a 2PS trunk (VGG-16 at
    width 0.25, 3 stages, 64², batch 4)."""
    from repro_torch.exec import ExecutionPlan, ResidencySpec, build_apply
    from repro_torch.models.cnn.vgg import init_vgg16
    from repro_torch.optim.adamw import tree_leaves
    shape = (64, 64, 3)
    mods, p = init_vgg16(torch.Generator().manual_seed(0), shape, 0.25,
                         n_stages=3, device=device)
    trunk = p["trunk"]
    leaves = tree_leaves(trunk)
    for t in leaves:
        t.requires_grad_()
    x = torch.randn((4,) + shape, generator=torch.Generator()
                    .manual_seed(1)).to(device).requires_grad_()
    plan = ExecutionPlan(engine=engine, n_rows=n, in_shape=shape,
                         residency=ResidencySpec(default=policy,
                                                 prefetch_depth=depth))
    y = build_apply(mods, plan)(trunk, x)
    saved = [t for row in getattr(y.grad_fn, "saved", ()) for t in row]
    y.square().sum().backward()
    torch.cuda.synchronize()
    return [y.detach(), x.grad] + [t.grad for t in leaves], saved


@pytest.fixture
def deterministic(cuda_device):
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield cuda_device
    torch.backends.cudnn.deterministic = before


@pytest.mark.requires_cuda
@pytest.mark.parametrize("depth", [0, 1, 2])
def test_host_residency_pins_and_equals_device(depth, deterministic):
    want, dev_saved = _twophase_run(deterministic, "device", 1)
    got, saved = _twophase_run(deterministic, "host", depth)
    assert saved and len(saved) == len(dev_saved)
    for t, d in zip(saved, dev_saved):
        # a zero-height head holds no memory to pin
        assert t.device.type == "cpu" and (t.is_pinned() or t.numel() == 0)
        assert torch.equal(t, d.cpu())
    assert any(t.numel() for t in saved)
    assert all(d.is_cuda for d in dev_saved)
    for a, b in zip(want, got):
        assert torch.equal(a, b)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("engine,n", [("twophase", 2), ("twophase_h", 4)])
def test_recompute_equals_device(engine, n, deterministic):
    want, _ = _twophase_run(deterministic, "device", 1, engine, n)
    got, _ = _twophase_run(deterministic, "recompute", 1, engine, n)
    for a, b in zip(want, got):
        assert torch.equal(a, b)


@pytest.mark.requires_cuda
def test_host_residency_peak_not_above_device(cuda_device):
    peaks = {}
    for policy in ("device", "host"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _twophase_run(cuda_device, policy, 1)
        peaks[policy] = torch.cuda.max_memory_allocated()
    assert peaks["host"] <= peaks["device"], peaks


@pytest.mark.requires_cuda
def test_measure_step_peak_covers_a_known_allocation(cuda_device):
    from repro_torch.obs.audit import measure_step
    nbytes = 64 * 2**20
    held = []

    def step():
        held.append(torch.empty(nbytes, dtype=torch.uint8,
                                device=cuda_device).fill_(1))

    before = torch.cuda.memory_allocated()
    m = measure_step(step)  # no tensor argument: the card is the default
    assert m["method"] == "cuda_max_allocated" and len(held) == 1
    assert m["peak_bytes"] >= before + nbytes
    x = torch.ones(1024, device=cuda_device)
    m = measure_step(lambda t: t * 2, x, time_iters=2)
    assert m["peak_bytes"] >= x.nbytes and m["wall_us"] > 0


@pytest.mark.requires_cuda
def test_calibrate_is_finite_and_positive(cuda_device):
    from repro_torch.exec.costmodel import CostTable, hardware_fingerprint
    t = CostTable.calibrate(matmul_dim=1024, copy_bytes=16 * 2**20,
                            iters=2)
    assert t.fingerprint == hardware_fingerprint()
    assert t.fingerprint.startswith("cuda:") and " " not in t.fingerprint
    for f in ("flops_per_s", "h2d_bytes_per_s", "d2h_bytes_per_s",
              "row_overhead_us"):
        v = getattr(t, f)
        assert np.isfinite(v) and v > 0, f
    assert torch.backends.cuda.matmul.allow_tf32 is False  # restored


def _time_us(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["conv", "swa", "ssd"])
def test_autotune_winner_launches_its_kernel(kind, cuda_device):
    """``autotune_kernel`` times the feasible tiles on the card (the
    default timer for the conv trunk, a caller's timer for the sequence
    kernels) and the winning tiles launch the kernel."""
    import dataclasses
    from repro_torch.exec import ExecutionPlan, Planner, build_apply
    from repro_torch.kernels import ops
    from repro_torch.models.cnn.layers import init_trunk
    from repro_torch.models.cnn.vgg import vgg16_modules
    mods = vgg16_modules(0.125, 3)
    planner = Planner(mods, (32, 32, 3), 2)
    if kind == "conv":
        tuned = planner.autotune_kernel(planner.plan("overlap", 2))
        assert tuned.engine == "overlap_cuda" and tuned.get("autotune_us")
        params, _ = init_trunk(mods, torch.Generator().manual_seed(0),
                               (32, 32, 3), device=cuda_device)
        before = ops.conv2d.launches
        build_apply(mods, tuned)(params, torch.ones(2, 32, 32, 3,
                                                    device=cuda_device))
        assert ops.conv2d.launches > before
        return
    if kind == "swa":
        q, k, v = _swa_inputs(256, 64, torch.bfloat16, cuda_device)
        plan = ExecutionPlan.explicit("seq_swa_overlap", 4, seq=256,
                                      head_dim=64, window=64)
        plan = dataclasses.replace(plan, dtype_bytes=2)
        run = lambda c: ops.swa_attention(  # noqa: E731
            q, k, v, 64, bq=c.kernel.bq, bk=c.kernel.bk)
        counter = ops.swa_attention
    else:
        g = torch.Generator().manual_seed(0)
        x = torch.randn((1, 256, 4, 16), generator=g).to(cuda_device)
        bc = torch.randn((1, 256, 8), generator=g).to(cuda_device)
        dt = torch.rand((1, 256, 4), generator=g).to(cuda_device)
        a = torch.exp(-dt)
        plan = ExecutionPlan.explicit("seq_ssd_cuda", seq=256, ssm_state=8)
        run = lambda c: ops.ssd_scan(  # noqa: E731
            x, bc, bc, a, dt, chunk=c.kernel.chunk)
        counter = ops.ssd_scan
    tuned = planner.autotune_kernel(
        plan, time_fn=lambda c: _time_us(lambda: run(c)))
    assert tuned.engine.endswith("_cuda") and tuned.get("autotune")
    before = counter.launches
    run(tuned)
    torch.cuda.synchronize()
    assert counter.launches == before + 1


def _recurrent_fwd_bwd(device, arch, policy):
    """Loss and every parameter gradient of one fwd+bwd of the reduced
    preset of ``arch`` at batch 1, seq 512 (two chunks, so the state is
    carried), under ``policy`` residency."""
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import TokenDataset, TokenDatasetConfig
    from repro_torch.exec import Planner, ResidencySpec
    from repro_torch.models.lm.model import init_lm
    from repro_torch.models.lm.rowexec import build_lm_apply
    from repro_torch.optim.adamw import tree_leaves
    cfg = get_reduced(arch)
    params = init_lm(torch.Generator(device=device).manual_seed(0), cfg)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    hb = TokenDataset(TokenDatasetConfig(vocab=cfg.vocab, seq_len=512,
                                         batch=1)).batch_at(0)
    batch = {k: torch.from_numpy(hb[k]).long().to(device)
             for k in ("tokens", "labels")}
    plan = Planner.for_model(cfg, 1, 512,
                             residency=ResidencySpec.parse(policy))
    loss, _ = build_lm_apply(cfg, plan)(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    return [loss.detach()] + list(grads)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["zamba2_7b", "xlstm_125m"])
def test_recurrent_lm_step_under_each_residency(arch, deterministic,
                                                tmp_path):
    """The reduced Zamba2 and xLSTM presets on the card under device, host
    and recompute residency (seq 512: two chunks, so the state is
    carried).  One fwd+bwd: the loss and every gradient under host
    residency (states fetched back from pinned memory) and recompute
    (states regenerated) against device residency, within 1e-5 of each
    tensor's largest magnitude (the parity tests' fp32 tolerance: the
    tied embedding's gradient gathers many tokens in no fixed order, and
    the device default, the checkpointed chunk loop, sums some chunk
    gradients in another order than the executor); a stale or misplaced
    state moves them by far more.  Two trainer steps: equal losses and
    step-0 gradient norms within 1e-6 relative, and the host run's carried
    states go to pinned memory and back (non-zero counters)."""
    import json
    from repro_torch.launch import train as T
    got = {p: _recurrent_fwd_bwd(deterministic, arch, p)
           for p in ("device", "host", "recompute")}
    for policy in ("host", "recompute"):
        for a, b in zip(got["device"], got[policy]):
            assert float((a - b).abs().max()) \
                <= 1e-5 * float(a.abs().max()), policy
    recs, counters = {}, {}
    for policy in ("device", "host", "recompute"):
        d = tmp_path / policy
        recs[policy] = T.main(
            ["--arch", arch, "--preset", "reduced", "--batch", "1", "--seq",
             "512", "--steps", "2", "--residency", policy, "--out", str(d),
             "--trace", str(d / "t.jsonl"), "--metrics-out",
             str(d / "m.json")])
        counters[policy] = json.load(open(d / "m.json"))["counters"]
    for policy in ("host", "recompute"):
        for r, want in zip(recs[policy], recs["device"]):
            assert np.isfinite(r["loss"])
            assert abs(r["loss"] - want["loss"]) \
                <= 1e-6 * abs(want["loss"]), recs
        g, want = recs[policy][0]["grad_norm"], recs["device"][0]["grad_norm"]
        assert abs(g - want) <= 1e-6 * abs(want), recs
    host = counters["host"]
    assert host["rowprog.offload_bytes"] > 0
    assert host["rowprog.prefetch_bytes"] == host["rowprog.offload_bytes"]
    assert host["rowprog.fp_rows"] == host["rowprog.bp_rows"] > 0
    assert "rowprog.offload_bytes" not in counters["device"]
    assert counters["recompute"]["rowprog.recompute_rows"] > 0


# ---------------------------------------------------------------------------
# sharded serving under nccl: one rank a card, as torchrun starts them
# ---------------------------------------------------------------------------

NCCL_RANK = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from repro_torch.configs import get_reduced
from repro_torch.exec import MeshSpec
from repro_torch.launch import serve as S
from repro_torch.launch import sharding as sh
from repro_torch.launch import steps
from repro_torch.launch.mesh import build_mesh, init_from_env
from repro_torch.models.lm.model import family_fns
from repro_torch.optim.adamw import tree_map
from repro_torch.serve import make_requests, serve

out, job = sys.argv[1], json.loads(sys.argv[2])
backend = init_from_env(torch.device("cuda"))
rank = dist.get_rank()
res = {"backend": backend, "device": torch.cuda.current_device()}
try:
    spec = MeshSpec.parse(job["serve_mesh"])
    build_mesh(spec)
    cfg = get_reduced("qwen1_5_4b")
    params = tree_map(lambda t: t.cuda(), family_fns(cfg).init(
        torch.Generator().manual_seed(0), cfg))
    reqs = make_requests(**job["reqs"], vocab=cfg.vocab)
    rep, plan = serve(params, cfg, reqs, mesh=spec, n_slots=job["n_slots"])
    res["tokens"] = {str(s.rid): list(map(int, s.generated))
                     for s in rep.states}
    res["summary"] = rep.summary()
    res["cli"] = bool(S.main(job["cli"]))
    mesh = build_mesh(MeshSpec.parse(job["step_mesh"]))
    for name, arch, seed, B, S_, L, n_dec in job["steps"]:
        cfg = get_reduced(arch)
        glob = tree_map(lambda t: t.cuda(), family_fns(cfg).init(
            torch.Generator().manual_seed(seed), cfg))
        rng = np.random.default_rng(seed)
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S_))).cuda()
        teacher = torch.from_numpy(
            rng.integers(0, cfg.vocab, (n_dec, B))).cuda()
        ctx = sh.bind_groups(steps.make_shape_ctx(
            mesh, cfg, steps.ShapeSpec("t", "decode", L, B)))
        places = steps.state_sharding(ctx, {"params": glob})["params"]
        local = sh.local_shards(glob, places, mesh)
        _, caches, lg = steps.make_prefill_step(cfg, L, ctx=ctx)(
            local, {"tokens": prompt})
        rows = [lg[:, -1]]
        step = steps.make_serve_step(cfg, ctx=ctx, cache_len=L)
        for i in range(n_dec):
            _, caches, lg = step(local, caches,
                                 {"tokens": teacher[i][:, None]})
            rows.append(lg[:, -1])
        np.save(f"{out}/{name}_rank{rank}.npy",
                torch.stack(rows).float().cpu().numpy())
finally:
    dist.destroy_process_group()
json.dump(res, open(f"{out}/rank{rank}.json", "w"))
'''

#: reduced configs' ctx steps under nccl: (name, arch, seed, batch, prompt,
#: cache length, decode steps).  On model=4 Gemma's 2 kv heads split the
#: cache's positions (the reference's ``_kv_fallback``); Zamba2's Mamba2
#: states split by heads
NCCL_STEPS = [("gemma", "gemma3_4b", 1, 2, 20, 32, 4),
              ("hybrid", "zamba2_7b", 2, 2, 12, 24, 3)]
NCCL_REQS = dict(n=6, seed=1, traffic="poisson", prompt_len=[8, 16],
                 max_new_tokens=[3, 4, 5, 6], mean_interarrival=1.5)


@pytest.mark.requires_cuda
def test_sharded_serving_under_nccl(tmp_path):
    """``serve(mesh=)``, ``launch.serve --mesh`` and the ``ctx=`` prefill
    and decode steps with one rank a card, each joining the group from
    torchrun's environment (so under nccl, which takes CUDA tensors only:
    the scheduler's host-built token ids and byte counts go through the
    card).  On four cards: serving on ``data=2,model=2`` (2 of 4 slots a
    rank), steps on ``data=1,model=4``, Gemma's cache split along its
    positions; on two: ``data=2`` and ``data=1,model=2``.  Every rank's
    greedy streams equal one process's at the rank's decode width (a
    width changes a product's rounding on the card); the step logits are
    within 1e-5 of one process's largest |logit| (fp32, TF32 off)."""
    import json
    import os
    import socket
    import subprocess
    import sys

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards (nccl takes one a rank)")
    world = 4 if n >= 4 else 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    serve_mesh = "data=2,model=2" if world == 4 else "data=2"
    job = {"serve_mesh": serve_mesh, "n_slots": 4, "reqs": NCCL_REQS,
           "step_mesh": f"data=1,model={world}", "steps": NCCL_STEPS,
           "cli": ["--arch", "qwen1_5_4b", "--preset", "reduced", "--mesh",
                   serve_mesh, "--device", "cuda", "--requests", "4",
                   "--prompt-len", "16", "--gen", "4", "--budget-gb",
                   "0.001"]}
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", NCCL_RANK, str(tmp_path), json.dumps(job)],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
                 RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                 LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                 MASTER_PORT=str(port)))
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {so[-2000:]} {se[-4000:]}"
    assert "serve OK" in outs[0][0]

    from repro_torch.configs import get_reduced
    from repro_torch.exec import MeshSpec
    from repro_torch.launch import steps
    from repro_torch.models.lm.model import family_fns
    from repro_torch.optim.adamw import tree_map
    from repro_torch.serve import make_requests, serve
    ranks = [json.load(open(tmp_path / f"rank{r}.json"))
             for r in range(world)]
    cfg = get_reduced("qwen1_5_4b")
    params = tree_map(lambda t: t.cuda(), family_fns(cfg).init(
        torch.Generator().manual_seed(0), cfg))
    width = 4 // MeshSpec.parse(serve_mesh).batch_extent
    rep, _ = serve(params, cfg, make_requests(**NCCL_REQS, vocab=cfg.vocab),
                   n_slots=width)
    want = {str(s.rid): list(map(int, s.generated)) for s in rep.states}
    for r, got in enumerate(ranks):
        assert got["backend"] == "nccl" and got["device"] == r
        assert got["tokens"] == want, r
        assert got["summary"] == ranks[0]["summary"], r
    for name, arch, seed, B, S_, L, n_dec in NCCL_STEPS:
        cfg = get_reduced(arch)
        params = tree_map(lambda t: t.cuda(), family_fns(cfg).init(
            torch.Generator().manual_seed(seed), cfg))
        rng = np.random.default_rng(seed)
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S_))).cuda()
        teacher = torch.from_numpy(
            rng.integers(0, cfg.vocab, (n_dec, B))).cuda()
        _, caches, lg = steps.make_prefill_step(cfg, L)(
            params, {"tokens": prompt})
        rows = [lg[:, -1]]
        step = steps.make_serve_step(cfg, cache_len=L)
        for i in range(n_dec):
            _, caches, lg = step(params, caches,
                                 {"tokens": teacher[i][:, None]})
            rows.append(lg[:, -1])
        one = torch.stack(rows).float().cpu().numpy()
        scale = float(np.abs(one).max())
        for r in range(world):
            got = np.load(tmp_path / f"{name}_rank{r}.npy")
            assert float(np.abs(got - one).max()) <= 1e-5 * scale, (name, r)
