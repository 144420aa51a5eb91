"""Qwen1.5-110B [hf:Qwen/Qwen1.5-0.5B family, 110B scaling per assignment]
(the reference's ``repro.configs.qwen1_5_110b``, same widths, presets and
``OPTIMIZED`` variant).

80L, d_model=8192, 64 q heads (GQA kv=8), d_ff=49152, vocab=152064,
QKV bias (Qwen1.5 signature).
"""
import dataclasses

from repro_torch.models.lm.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=49152, vocab=152064, qkv_bias=True,
    row_chunks=8, remat="rows",
)


def reduced():
    return ModelConfig(
        name="qwen110b-reduced", family="dense",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab=512, qkv_bias=True, dtype="float32", row_chunks=2)


# the reference's fitting variant, carried as data: block remat and bf16
# parameters (its FSDP-2D and KV-cache sequence sharding are launcher
# flags, not config fields)
OPTIMIZED = dataclasses.replace(CONFIG, remat="block_rows",
                                param_dtype="bfloat16")
