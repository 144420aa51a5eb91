"""LLaVA-NeXT 34B [hf:llava-hf/llava-v1.6-mistral-7b-hf, 34B variant uses
the Nous-Hermes-Yi-34B backbone] (the reference's
``repro.configs.llava_next_34b``, same widths and presets).

60L, d_model=7168, 56 q heads (GQA kv=8), d_ff=20480, vocab=64000.
Vision tower (SigLIP/CLIP) is the sanctioned stub: anyres tiling yields
base + 4 tiles x 576 patches = 2880 precomputed patch embeddings.
"""
from repro_torch.models.lm.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab=64000,
    frontend="vision", n_frontend_tokens=2880,
    row_chunks=8, remat="rows",
)


def reduced():
    return ModelConfig(
        name="llava-reduced", family="vlm",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab=512, frontend="vision", n_frontend_tokens=16,
        dtype="float32", row_chunks=2)
