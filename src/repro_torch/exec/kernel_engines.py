"""Kernel-backed engines — counterpart of ``repro.exec.pallas_engines``.

``overlap_cuda`` runs every conv layer whose halo precondition holds
(:func:`~repro_torch.kernels.conv2d_rows.halo_ok`, the reference's
eligibility rule) through the hand-written ``conv2d_rows`` CUDA kernel,
and every other module through its plain ``apply``.  As in the reference,
the trunk runs column-centric: the row tiling is inside the kernel.

The kernel is forward-only.  Its backward pass is the gradient of the
plain convolution (``aten.convolution_backward`` on NCHW views), wrapped
in a ``torch.autograd.Function`` — the reference does the same with the
lax VJP — so loss and grads match the ``base`` engine.

The policy rides on the plan: :class:`~repro_torch.exec.plan.KernelSpec`
carries the backend and ``block_h``, and the planner
(:func:`repro_torch.exec.planner.kernelize_plan`) prices each CTA's shared
memory with :func:`conv_tiles` before it swaps the engine in.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import torch

from repro_torch.exec.plan import ExecutionPlan, KernelSpec
from repro_torch.exec.registry import register_engine
from repro_torch.kernels import ops
from repro_torch.kernels.conv2d_rows import halo_ok, smem_bytes
from repro_torch.models.cnn.layers import Conv


def plan_kernel(plan: ExecutionPlan) -> KernelSpec:
    """The plan's KernelSpec; a bare plan naming a ``*_cuda`` engine means
    the default tiles on the cuda backend."""
    return plan.kernel if plan.kernel is not None \
        else KernelSpec(backend="cuda")


def conv_tiles(modules: Sequence, in_shape: Tuple[int, int, int],
               spec: KernelSpec
               ) -> Iterator[Tuple[object, tuple, tuple, bool,
                                   Optional[int]]]:
    """Walk a trunk's shape chain and classify each module for the kernel
    path: yields ``(module, in_shape, out_shape, eligible, smem)`` where
    ``eligible`` is the halo precondition at the spec's clamped block and
    ``smem`` one CTA's shared-memory bytes at that block (``None`` for
    non-Conv modules).  Shared by the engine (which layers launch the
    kernel) and the planner (what they cost)."""
    shape = tuple(in_shape)
    for m in modules:
        out = m.out_shape(shape)
        if isinstance(m, Conv):
            h_out, w_out, _ = out
            eligible = h_out >= 1 and w_out >= 1 \
                and halo_ok(m.k, m.s, spec.block_h, h_out)
            bh = max(1, min(spec.block_h, h_out))
            smem = smem_bytes(bh, m.s, m.k)
        else:
            eligible, smem = False, None
        yield m, shape, out, eligible, smem
        shape = out


class _KernelConv(torch.autograd.Function):
    """Forward through ``ops.conv2d`` (the CUDA kernel on the card),
    backward through the plain convolution's gradient."""

    @staticmethod
    def forward(ctx, x, w, b, m: Conv, block_h: int):
        ctx.m = m
        ctx.save_for_backward(x, w)
        y = ops.conv2d(x.contiguous(), w.contiguous(), m.s, m.p, block_h)
        return y + b if b is not None else y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        m = ctx.m
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        gx, gw, gb = torch.ops.aten.convolution_backward(
            g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2),
            w.permute(3, 2, 0, 1), [w.shape[3]] if need_b else None,
            [m.s, m.s], [m.p, m.p], [1, 1], False, [0, 0], 1,
            [need_x, need_w, need_b])
        return (gx.permute(0, 2, 3, 1) if need_x else None,
                gw.permute(2, 3, 1, 0) if need_w else None,
                gb if need_b else None, None, None)


def _kernel_conv(m: Conv, block_h: int):
    def conv(params, x):
        return _KernelConv.apply(x, params["w"],
                                 params.get("b") if m.bias else None,
                                 m, block_h)
    return conv


@register_engine("overlap_cuda", kind="cnn",
                 doc="OverL rows inside the conv2d_rows CUDA kernel: one "
                     "CTA per (row block, column tile, Cout tile) with its "
                     "own halo; plain path for layers the halo "
                     "precondition rejects (plan.kernel carries block_h)")
def _build_overlap_cuda(modules, plan: ExecutionPlan):
    if plan.in_shape is None:
        raise ValueError("overlap_cuda plan needs an in_shape")
    spec = plan_kernel(plan)
    fns = []
    for m, _, out, eligible, _ in conv_tiles(modules, plan.in_shape, spec):
        if spec.backend == "cuda" and eligible:
            fns.append(_kernel_conv(m, max(1, min(spec.block_h, out[0]))))
        else:
            fns.append(m.apply)

    def apply(params, x):
        for fn, p in zip(fns, params):
            x = fn(p, x)
        return x

    return apply
