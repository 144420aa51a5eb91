"""Gemma-3 4B [hf:google/gemma-3-1b-pt family] (the reference's
``repro.configs.gemma3_4b``, same widths and presets).

34L, d_model=2560, 8 q heads (GQA kv=4), head_dim=256, d_ff=10240,
vocab=262144; 5:1 local(sliding 1024):global attention pattern, 128k
context, tied embeddings.  The sliding-window local layers are the
strongest transformer fit for LR-CNN's weak-dependency row partitioning
(OverL halo = the 1024-token window).
"""
from repro_torch.models.lm.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=10240, vocab=262144, tie_embeddings=True,
    sliding_window=1024, local_ratio=5,
    rope_theta=1_000_000.0,
    row_chunks=8, remat="rows",
)


def reduced():
    return ModelConfig(
        name="gemma3-reduced", family="dense",
        n_layers=3, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=512, vocab=512, tie_embeddings=True, sliding_window=16,
        local_ratio=2, dtype="float32", row_chunks=2)
