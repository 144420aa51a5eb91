"""Qwen1.5-4B [hf:Qwen/Qwen1.5-0.5B family] (the reference's
``repro.configs.qwen1_5_4b``, same widths and presets).

40L, d_model=2560, 20 heads (MHA kv=20), d_ff=6912, vocab=151936,
QKV bias.
"""
from repro_torch.models.lm.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, head_dim=128,
    d_ff=6912, vocab=151936, qkv_bias=True,
    row_chunks=8, remat="rows",
)


def reduced():
    return ModelConfig(
        name="qwen4b-reduced", family="dense",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=512, vocab=512, qkv_bias=True, dtype="float32", row_chunks=2)
