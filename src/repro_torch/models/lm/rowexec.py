"""Plan-aware execution seam for the LM layer stack (counterpart of
``repro.models.lm.rowexec``).

``build_apply((params, cfg), plan)`` resolves the plan's seq engine, whose
builder delegates back here (:func:`build_lm_apply`): the stack's row
structure lives inside the layers (the SSD and xLSTM chunk scans, the
sliding-window halo loop, the chunked MLP and classifier head), so the
layers consult the *active plan* while they run, through two hooks:

* :func:`scan_rows` — the carried chunk scans of ``ssm_train``,
  ``mlstm_train`` and ``slstm_train``.  With no active plan, or a
  device-resident one, it runs the checkpointed chunk loop; an offloading
  :class:`~repro_torch.exec.plan.ResidencySpec` builds the row-program
  executor instead, so the carried state — the 2PS boundary cache — goes
  to pinned host memory with prefetch, or is recomputed in BP, with
  ``fp_row``/``bp_row`` obs spans to show it ran.
* :func:`swa_kernel` — local attention swaps its halo loop for the
  ``seq_swa_cuda`` engine's op when the kernelized plan selected it.

The active plan is plain Python state, set by :func:`use_plan` around a
forward.  PyTorch recomputes checkpointed regions during backward, outside
that block, so a region whose body consults the plan must re-enter it
(``models/lm/blocks.py`` does for block-level recomputation).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

_ACTIVE_PLAN = None


@contextlib.contextmanager
def use_plan(plan):
    """Activate ``plan`` for the layer-stack hooks."""
    global _ACTIVE_PLAN
    prev = _ACTIVE_PLAN
    _ACTIVE_PLAN = plan
    try:
        yield
    finally:
        _ACTIVE_PLAN = prev


def current_plan():
    return _ACTIVE_PLAN


def lm_config(modules):
    """The ModelConfig when ``modules`` is the LM form ``(params, cfg)``
    that ``build_apply`` receives from the train path; None otherwise."""
    from repro_torch.models.lm.config import ModelConfig
    if isinstance(modules, tuple) and len(modules) == 2 \
            and isinstance(modules[1], ModelConfig):
        return modules[1]
    return None


def plan_cfg(cfg, plan):
    """cfg with the plan's chunk count as ``row_chunks`` under a rows-remat
    policy, so the planned step chunks the MLP / attention / classifier
    head axes as the reference's does."""
    remat = {"none": "rows", "block": "block_rows"}.get(cfg.remat, cfg.remat)
    return dataclasses.replace(cfg, row_chunks=max(1, plan.n_rows),
                               remat=remat)


def build_lm_apply(cfg, plan):
    """``apply(params, batch) -> (loss, aux)``: the family loss
    (``encdec_loss`` for the encoder-decoder family, ``lm_loss`` for the
    others) with the plan active for the layer-stack hooks.

    Mesh placement belongs to the caller (the sharded train step of
    :mod:`repro_torch.launch.steps` places the state and the batch, and
    its shard context drives the model's seams), not to the registry's
    seq shard wrapper, which would gather every positional argument's
    leading axis — wrong for a ``(params, batch)`` signature.  So the
    apply is marked ``handles_mesh`` and the registry leaves it
    unwrapped, as the reference's is."""
    from repro_torch.models.lm.model import family_fns
    loss_fn = family_fns(cfg).loss
    run_cfg = plan_cfg(cfg, plan)

    def apply(params, batch):
        with use_plan(plan):
            return loss_fn(params, batch, run_cfg)

    apply.handles_mesh = True
    return apply


def _residency():
    plan = _ACTIVE_PLAN
    return plan.residency if plan is not None else None


def scan_rows(body, carry0, xs, consts=None):
    """Carried chunk scan ``body(carry, chunk) -> (carry, out)`` over
    leading-axis-stacked ``xs`` (a tensor or a tuple of them), placed by the
    active plan; returns ``(carry, stacked outputs)``.

    Device-resident (or plan-less) execution is the checkpointed chunk loop
    (the reference's ``lax.scan(jax.checkpoint(body), carry0, xs)``).  An
    offloading residency builds the row-program executor: the carried state
    is the named boundary cache (``"state"``), offloaded and prefetched or
    recomputed by the spec.

    A body that uses differentiable values beyond the carry and the chunk
    (sLSTM's recurrent weights) must take them through ``consts``, with the
    signature ``body(consts, carry, chunk)``: the executor differentiates
    its args only, so a closure would detach the weights' gradients."""
    from repro_torch.core.seqrow import make_stacked_carry_scan_apply
    n_rows = next(iter(
        xs if isinstance(xs, (tuple, list)) else (xs,))).shape[0]
    if consts is not None:
        return make_stacked_carry_scan_apply(
            body, n_rows, _residency(), with_consts=True)(carry0, xs, consts)
    return make_stacked_carry_scan_apply(body, n_rows,
                                         _residency())(carry0, xs)


def swa_kernel(window: int) -> Optional[object]:
    """The plan's sliding-window attention op, or None.

    Returns the op-level ``apply(q, k, v)`` of the ``seq_swa_cuda`` engine
    — (B, S, H, D) layout, backward through the dense oracle's gradient —
    when the active plan kernelized to it and its window matches this
    layer's.  None (plain plans, kernel fallbacks, window mismatch) keeps
    the model's halo chunk loop, which IS the ``seq_swa_overlap`` row
    lowering."""
    plan = _ACTIVE_PLAN
    if plan is None or plan.engine != "seq_swa_cuda" or window <= 0:
        return None
    if int(plan.get("window", 0)) != int(window):
        return None
    from repro_torch.exec.registry import get_engine
    return get_engine("seq_swa_cuda").build(None, plan)
