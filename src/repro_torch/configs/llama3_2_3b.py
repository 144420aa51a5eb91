"""Llama-3.2-3B [hf:meta-llama/Llama-3.2-1B family] (the reference's
``repro.configs.llama3_2_3b``, same widths, presets and ``OPTIMIZED``
variant).

28L, d_model=3072, 24 q heads (GQA kv=8), d_ff=8192, vocab=128256,
tied embeddings (Llama-3.2 small models tie).
"""
import dataclasses

from repro_torch.models.lm.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=128256, tie_embeddings=True,
    rope_theta=500_000.0,
    row_chunks=8, remat="rows",
)


def reduced():
    return ModelConfig(
        name="llama32-reduced", family="dense",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab=512, tie_embeddings=True, dtype="float32",
        row_chunks=2)


# the reference's fitting variant, carried as data: block remat, the pure
# data-parallel layout (the batch over every mesh axis, the parameters 2-D
# sharded over data and model; ``make_shape_ctx`` reads ``parallel``) and
# bf16 parameters
OPTIMIZED = dataclasses.replace(CONFIG, remat="block_rows",
                                parallel="dp_only", param_dtype="bfloat16")
