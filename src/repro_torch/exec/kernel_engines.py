"""Kernel-backed engines — counterpart of ``repro.exec.pallas_engines``.

CNN: ``overlap_cuda``.  Sequence: ``seq_swa_cuda`` (sliding-window
attention through the ``swa_attention`` kernel; the window IS the OverL
halo) and ``seq_ssd_cuda`` (the Mamba2 SSD recurrence through the
``ssd_scan`` kernel).  Both sequence engines have the reference's two
forms: given the LM form ``(params, cfg)`` they return the plan-driven
stack apply (the local attention layers pull ``seq_swa_cuda``'s op back
out through :func:`repro_torch.models.lm.rowexec.swa_kernel`), otherwise
the op-level apply.  The kernels are forward-only; each op is a
``torch.autograd.Function`` whose backward recomputes the dense oracle
(``kernels/ref.py``) under ``torch.enable_grad()`` and returns its
gradient, as the reference's ``custom_vjp`` returns the lax VJP of its
oracle.

Where the tensors lie decides kernel or plain version, whatever the spec's
backend: a ``*_cuda`` engine launches its kernel on CUDA tensors (or the
launch raises) and takes the plain version only for CPU tensors.  The
planner's kernel fallback leaves a plain engine in place rather than
swapping a ``*_cuda`` one in.

``overlap_cuda`` runs every dense conv layer whose halo precondition
holds (:func:`~repro_torch.kernels.conv2d_rows.halo_ok`, the reference's
eligibility rule) through the hand-written ``conv2d_rows`` CUDA kernel,
and every other module through its plain ``apply``.  As in the reference,
the trunk runs column-centric: the row tiling is inside the kernel.

The kernel is forward-only.  A kernel layer is the layer's own conv
(``Conv.apply`` with the row block), so it runs through the CNN path's
one conv op, :func:`repro_torch.models.cnn.layers.conv2d`: the kernel
forward, the plain convolution's gradient (``layers.conv_backward``)
backward — the reference does the same with the lax VJP — so loss and
grads match the ``base`` engine.  This module defines no conv Function.

The policy rides on the plan: :class:`~repro_torch.exec.plan.KernelSpec`
carries the backend and ``block_h``, and the planner
(:func:`repro_torch.exec.planner.kernelize_plan`) prices each CTA's shared
memory with :func:`conv_tiles` before it swaps the engine in.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import torch

from repro_torch.exec.collectives import ColumnParallel, unwrap
from repro_torch.exec.plan import ExecutionPlan, KernelSpec
from repro_torch.exec.registry import register_engine
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_scan_ref, swa_attention_ref
from repro_torch.kernels.conv2d_rows import halo_ok, smem_bytes
from repro_torch.models.cnn.layers import Conv, dense_conv


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
    modules other than a dense ``Conv``: the kernel has no groups, so a
    depthwise conv, and a block holding one, run their plain ``apply``).
    Shared by the engine (which layers launch the kernel) and the planner
    (what they cost)."""
    shape = tuple(in_shape)
    for m in modules:
        out = m.out_shape(shape)
        if dense_conv(m):
            h_out, w_out, _ = out
            eligible = h_out >= 1 and w_out >= 1 \
                and halo_ok(m.k, m.s, spec.block_h, h_out)
            bh = max(1, min(spec.block_h, h_out))
            smem = smem_bytes(bh, m.s, m.k, m.cout)
        else:
            eligible, smem = False, None
        yield m, shape, out, eligible, smem
        shape = out


def _kernel_conv(m: Conv, block_h: int):
    """``m`` through the ``conv2d_rows`` kernel at row block ``block_h``."""
    return lambda params, x: m.apply(params, x, block_h)


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
        if not eligible:
            fns.append(m.apply)
            continue
        fn = _kernel_conv(unwrap(m), max(1, min(spec.block_h, out[0])))
        # a column-parallel conv (model axis) runs the kernel on its slice
        fns.append(m.wrap(fn) if isinstance(m, ColumnParallel) else fn)

    def apply(params, x):
        for fn, p in zip(fns, params):
            x = fn(p, x)
        return x

    return apply


# ---------------------------------------------------------------------------
# Sequence-axis engines
# ---------------------------------------------------------------------------


def _oracle_grads(fn, saved, g):
    """The gradient of ``fn(*saved)`` against ``g``, recomputed."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in saved]
        return torch.autograd.grad(fn(*ins), ins, g)


def _swa_ref_bshd(window: int):
    def fn(q, k, v):
        out = swa_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), window)
        return out.transpose(1, 2)
    return fn


class _SwaOp(torch.autograd.Function):
    """(B, S, H, D) sliding-window attention: forward through
    ``ops.swa_attention`` (the CUDA kernel on the card) on ``(B, H, S,
    D)`` views, backward through the dense oracle's gradient."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, spec: KernelSpec):
        ctx.window = window
        ctx.save_for_backward(q, k, v)
        out = ops.swa_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), window, spec.bq, spec.bk)
        return out.transpose(1, 2)

    @staticmethod
    def backward(ctx, g):
        grads = _oracle_grads(_swa_ref_bshd(ctx.window), ctx.saved_tensors,
                              g)
        return (*grads, None, None)


def _ssd_ref_y(x, B, C, a, dt):
    return ssd_scan_ref(x, B, C, a, dt)[0]


class _SsdOp(torch.autograd.Function):
    """The SSD recurrence's ``y``: forward through ``ops.ssd_scan`` at the
    plan's chunk, backward through the sequential oracle's gradient."""

    @staticmethod
    def forward(ctx, x, B, C, a, dt, chunk):
        ctx.save_for_backward(x, B, C, a, dt)
        return ops.ssd_scan(*(t.contiguous() for t in (x, B, C, a, dt)),
                            chunk=chunk)

    @staticmethod
    def backward(ctx, g):
        return (*_oracle_grads(_ssd_ref_y, ctx.saved_tensors, g), None)


@register_engine("seq_swa_cuda", kind="seq",
                 doc="OverL along the sequence inside the swa_attention "
                     "CUDA kernel: the window IS the halo (plan.kernel "
                     "carries bq / bk; op layout (B, S, H, D) as for "
                     "seq_swa_overlap)")
def _build_seq_swa_cuda(modules, plan: ExecutionPlan):
    window = int(plan.get("window", 0))
    if window <= 0:
        raise ValueError("seq_swa_cuda plan needs a 'window' extra")
    from repro_torch.exec.engines import _seq_modules
    lm = _seq_modules(modules, plan)
    if lm is not None:
        return lm
    spec = plan_kernel(plan)

    def apply(q, k, v):
        return _SwaOp.apply(q, k, v, window, spec)

    return apply


@register_engine("seq_ssd_cuda", kind="seq",
                 doc="2PS along the sequence inside the ssd_scan CUDA "
                     "kernel: SSD chunks with the carried state kept on "
                     "chip (plan.kernel carries chunk)")
def _build_seq_ssd_cuda(modules, plan: ExecutionPlan):
    from repro_torch.exec.engines import _seq_modules
    lm = _seq_modules(modules, plan)
    if lm is not None:
        return lm
    chunk = plan_kernel(plan).chunk

    def apply(x, B, C, a, dt):
        return _SsdOp.apply(x, B, C, a, dt, chunk)

    return apply
