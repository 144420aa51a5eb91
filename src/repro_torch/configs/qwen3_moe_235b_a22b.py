"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-30B-A3B scaled per assignment] (the
reference's ``repro.configs.qwen3_moe_235b_a22b``, same widths, presets
and ``OPTIMIZED`` variant).

94L, d_model=4096, 64 q heads (GQA kv=4), per-expert FFN 1536,
vocab 151936, 128 experts top-8.  head_dim=128 per the Qwen3 model card.
"""
import dataclasses

from repro_torch.models.lm.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936,
    n_experts=128, top_k=8, d_expert=1536, capacity_factor=1.25,
    moe_seq_groups=4,
    row_chunks=8, remat="rows",
)


def reduced():
    return ModelConfig(
        name="qwen3-moe-reduced", family="moe",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=128, vocab=512, n_experts=4, top_k=2, d_expert=128,
        moe_seq_groups=2, dtype="float32", row_chunks=2)


# the reference's fitting variant, carried as data: block remat, tight
# capacity, finer dispatch groups and bf16 parameters
OPTIMIZED = dataclasses.replace(CONFIG, remat="block_rows",
                                capacity_factor=1.0, moe_seq_groups=8,
                                param_dtype="bfloat16")
