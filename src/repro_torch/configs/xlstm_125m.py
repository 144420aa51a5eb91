"""xLSTM-125M [arXiv:2405.04517] (the reference's
``repro.configs.xlstm_125m``, same widths and presets).

12L, d_model=768, 4 heads, vocab=50304 (GPT-NeoX tokenizer rounding),
sLSTM + mLSTM blocks (1:1 interleave here; the paper's small models mix
both).  d_ff=0: xLSTM blocks carry their own up/down projections.
"""
from repro_torch.models.lm.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    ssm_expand=2, slstm_every=2,
    row_chunks=8, remat="rows",
)


def reduced():
    return ModelConfig(
        name="xlstm-reduced", family="ssm",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=0,
        vocab=512, ssm_expand=2, slstm_every=2, dtype="float32",
        row_chunks=2)
