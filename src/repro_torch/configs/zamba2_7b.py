"""Zamba2-7B [arXiv:2411.15242] (the reference's
``repro.configs.zamba2_7b``, same widths and presets).

81L, d_model=3584, Mamba2 backbone (ssm_state=64) with a SHARED
attention+MLP block interleaved every 6th layer (32 q heads, kv=32,
d_ff=14336) -- the shared block's params appear once and are reused at
every occurrence, the Zamba signature.  vocab=32000.
"""
from repro_torch.models.lm.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000,
    ssm_state=64, ssm_heads=32, ssm_expand=2, shared_attn_every=6,
    row_chunks=8, remat="rows",
)


def reduced():
    return ModelConfig(
        name="zamba2-reduced", family="hybrid",
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab=512, ssm_state=16, ssm_heads=4,
        shared_attn_every=2, dtype="float32", row_chunks=2)
