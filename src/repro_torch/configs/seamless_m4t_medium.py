"""SeamlessM4T-medium [arXiv:2308.11596] (the reference's
``repro.configs.seamless_m4t_medium``, same widths and presets).

Encoder-decoder transformer backbone: 12 encoder + 12 decoder layers,
d_model=1024, 16 heads (MHA kv=16), d_ff=4096, vocab=256206.  The speech
frontend (mel + conv) is the sanctioned stub: input_specs provides frame
embeddings.  Encoder has no decode step; decode shapes lower the text
decoder (noted in DESIGN.md).
"""
from repro_torch.models.lm.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    head_dim=64, d_ff=4096, vocab=256206,
    frontend="audio",
    row_chunks=8, remat="rows",
)


def reduced():
    return ModelConfig(
        name="seamless-reduced", family="encdec",
        n_layers=2, n_enc_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        head_dim=32, d_ff=256, vocab=512, frontend="audio",
        dtype="float32", row_chunks=2)
