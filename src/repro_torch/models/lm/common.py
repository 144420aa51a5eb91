"""Shared LM primitives: norms, rotary embeddings, init helpers
(counterpart of ``repro.models.lm.common``).

Initialisers draw from an explicit ``torch.Generator`` on the generator's
device; ``stack`` adds a leading layer axis, the shape the reference's
``vmap``-ed init gives stacked layers.  The reference's ``lc`` sharding
constraints have no counterpart: the port runs on one device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


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


def embed_apply(params, tokens, dtype):
    """Rows of the table in ``dtype``.  The rows are taken before the cast
    (the reference casts the whole table first): the values are the same,
    and no ``(vocab, d)`` copy is made."""
    return params["table"][tokens].to(dtype)


def unembed_init(gen, d, vocab, param_dtype):
    return {"w": dense_init(gen, (d, vocab), param_dtype)}


def unembed_apply(params, x, dtype):
    return x.to(dtype) @ params["w"].to(dtype)
