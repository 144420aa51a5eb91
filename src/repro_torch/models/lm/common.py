"""Shared LM primitives: norms, rotary embeddings, init helpers
(counterpart of ``repro.models.lm.common``).

Initialisers draw from an explicit ``torch.Generator`` on the generator's
device; ``stack`` adds a leading layer axis, the shape the reference's
``vmap``-ed init gives stacked layers.  A ``meta`` stand-in for the
generator (:data:`META`) gives the shapes without memory.

The reference's ``lc`` constraints are the port's seams
(:func:`repro_torch.launch.sharding.seam`): on one device they are the
identity; in a sharded step a rank holding its slice of the vocabulary
embeds the tokens in its rows and the model group sums the rows
(:func:`embed_apply`), and computes its columns of the logits
(:func:`unembed_apply`).
"""

from __future__ import annotations

import math
import types
from typing import Optional

import torch

from repro_torch.launch.sharding import enter, seam, split_offset

#: a generator stand-in whose initialisers return ``meta`` tensors (shapes
#: and dtypes, no memory): what the reference's ``jax.eval_shape`` gives
META = types.SimpleNamespace(device=torch.device("meta"))


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def dense_init(gen: torch.Generator, shape, dtype,
               scale: Optional[float] = None, stack: int = 0):
    """Normal(0, scale) with the reference's default ``1/sqrt(fan_in)``,
    ``fan_in = shape[0]`` for 2-D and wider shapes; ``stack`` layers of it
    along a new leading axis."""
    shape = tuple(shape)
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    full = ((stack,) if stack else ()) + shape
    if gen.device.type == "meta":
        return torch.empty(full, dtype=torch_dtype(dtype), device="meta")
    # scaled in place: a stacked expert leaf is tens of GB at full width,
    # and a second temporary of its size would not fit beside the rest
    w = torch.randn(full, generator=gen, device=gen.device,
                    dtype=torch.float32).mul_(scale)
    return w.to(torch_dtype(dtype))


def init_rms(d: int, param_dtype, gen: torch.Generator, stack: int = 0):
    return torch.zeros(((stack,) if stack else ()) + (d,),
                       dtype=torch_dtype(param_dtype), device=gen.device)


def rms_norm(x, scale, eps: float = 1e-6):
    """RMS norm in fp32 with the ``(1 + scale)`` gain."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def rope(x, positions, theta: float = 10_000.0):
    """Rotary embedding in fp32.  x: (B, S, H, D); positions: (B, S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs          # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_init(gen, vocab, d, param_dtype):
    return {"table": dense_init(gen, (vocab, d), param_dtype, scale=0.02)}


def embed_apply(params, tokens, dtype, vocab: int = 0):
    """Rows of the table in ``dtype``.  The rows are taken before the cast
    (the reference casts the whole table first): the values are the same,
    and no ``(vocab, d)`` copy is made.  A table of fewer than ``vocab``
    rows is this rank's slice of it: tokens outside its rows embed as
    zeros and the model group sums the rows."""
    table = params["table"]
    lo = split_offset(table.shape[0], vocab or table.shape[0])
    if lo is None:
        return seam(table[tokens].to(dtype), "batch", None, None)
    local = tokens - lo
    inside = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)].to(dtype)
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return seam(rows, "batch", None, None, partial=True)


def unembed_init(gen, d, vocab, param_dtype):
    return {"w": dense_init(gen, (d, vocab), param_dtype)}


def unembed_apply(params, x, dtype, vocab: int = 0):
    """Logits; with fewer than ``vocab`` columns in ``w``, this rank's
    columns of them (column-parallel)."""
    w = params["w"]
    if split_offset(w.shape[-1], vocab or w.shape[-1]) is not None:
        x = enter(x)
    return seam(x.to(dtype) @ w.to(dtype), "batch", None, "tp")
