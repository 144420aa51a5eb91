"""DeepSeek-MoE 16B [arXiv:2401.06066] (the reference's
``repro.configs.deepseek_moe_16b``, same widths and presets).

28L, d_model=2048, 16 heads (MHA: kv=16), fine-grained experts with
per-expert FFN width 1408; 64 routed experts top-6 + 2 shared experts.
vocab=102400.
"""
from repro_torch.models.lm.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=102400,
    n_experts=64, top_k=6, n_shared_experts=2, d_expert=1408,
    capacity_factor=1.25, moe_seq_groups=4,
    row_chunks=8, remat="rows",
)


def reduced():
    return ModelConfig(
        name="dsmoe-reduced", family="moe",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=128, vocab=512, n_experts=4, top_k=2, n_shared_experts=1,
        d_expert=128, moe_seq_groups=2, dtype="float32", row_chunks=2)
