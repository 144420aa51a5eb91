"""The port's CUDA kernel and kernel engine on the card.

Every test here needs a CUDA device (marker ``requires_cuda``) and skips
without one.  The file imports neither JAX nor the JAX package, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m requires_cuda \\
        tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports JAX.)  The kernel is held
against its plain version at 1e-4 of the output's largest magnitude (fp32
sums in another order); the kernel engine's loss and gradients against the
``base`` engine at 1e-5 relative.
"""

import numpy as np
import pytest
import torch

#: (H, W, Cin, Cout, k, s, p, block_h): the kernel tests' shared geometry
#: cases, then VGG-16/224 shapes (ragged H_out % 8 at 14, Cin = 3)
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
    assert lib.conv2d_rows_smem_bytes(3, 1, 8, cr.tile_w(8)) \
        == cr.smem_bytes(8, 1, 3)


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
