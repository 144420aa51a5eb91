"""Unified model configuration covering all assigned architecture families
(a copy of ``repro.models.lm.config``, which is pure Python: the port keeps
its own so that it never imports the JAX package).

One frozen dataclass; family-specific fields are zero/empty when unused.
``layer_kinds()`` expands the per-layer pattern (dense attention, local/
global sliding window, mamba, mlstm/slstm, shared-attn) that the scan-over-
layers machinery in blocks.py consumes.  (The port's blocks.py loops over the
layers of each segment in Python; the segments stay as the reference's, so
parameter trees convert leaf for leaf.)
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_expert: int = 0           # per-expert FFN width (0 -> d_ff)
    capacity_factor: float = 1.25
    moe_seq_groups: int = 4     # dispatch group granularity (see moe.py)

    # --- sliding-window pattern (gemma3) ---
    sliding_window: int = 0     # window size for "local" layers
    local_ratio: int = 0        # N local layers per 1 global layer

    # --- SSM (mamba2 / xLSTM) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    conv_k: int = 4
    slstm_every: int = 0        # xlstm: every k-th layer is sLSTM

    # --- hybrid (zamba2) ---
    shared_attn_every: int = 0  # every k-th layer is the *shared* attn block

    # --- encoder-decoder (seamless) ---
    n_enc_layers: int = 0

    # --- modality frontend stub ---
    frontend: str = "none"      # none | vision | audio
    n_frontend_tokens: int = 576  # patch/frame embeddings per sample
    frontend_dim: int = 1152    # patch-embedding width (SigLIP-so400m)

    # --- numerics / policy ---
    dtype: str = "bfloat16"     # activation/compute dtype
    param_dtype: str = "float32"
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6

    # --- row-centric activation policy (the paper's technique) ---
    row_chunks: int = 1         # sequence chunks for row-centric remat
    row_mode: str = "overlap"   # overlap | twophase (seam strategy)
    remat: str = "rows"         # none | rows | block | block_rows

    # --- parallelism layout ---
    parallel: str = "tp"        # tp (TP over model axis) | dp_only
                                # (batch over BOTH axes, params FSDP-2D —
                                # right for small-d models where TP is
                                # collective-bound)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family == "moe" and self.d_expert == 0:
            object.__setattr__(self, "d_expert", self.d_ff)

    # ------------------------------------------------------------------
    @property
    def n_q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def layer_kinds(self) -> List[str]:
        """Per-layer kind tags, length n_layers (decoder side)."""
        L = self.n_layers
        if self.family == "moe":
            return ["moe"] * L
        if self.family == "ssm":
            if self.slstm_every:
                return ["slstm" if (i + 1) % self.slstm_every == 0 else "mlstm"
                        for i in range(L)]
            return ["mlstm"] * L
        if self.family == "hybrid":
            k = self.shared_attn_every or 6
            return ["shared_attn" if (i + 1) % k == 0 else "mamba"
                    for i in range(L)]
        if self.local_ratio:
            k = self.local_ratio + 1
            return ["global" if (i + 1) % k == 0 else "local"
                    for i in range(L)]
        return ["attn"] * L

    def scan_segments(self) -> List[Tuple[Tuple[str, ...], int]]:
        """Partition layer_kinds into (repeating pattern, count) segments so
        blocks.py can lax.scan over stacked group params."""
        kinds = self.layer_kinds()
        uniq = sorted(set(kinds))
        if len(uniq) == 1:
            return [((uniq[0],), len(kinds))]
        # find smallest repeating unit
        for plen in range(2, len(kinds) + 1):
            pat = tuple(kinds[:plen])
            reps = len(kinds) // plen
            if list(pat) * reps == kinds[:plen * reps] and len(set(pat)) == len(uniq):
                segs: List[Tuple[Tuple[str, ...], int]] = [(pat, reps)]
                rest = kinds[plen * reps:]
                if rest:
                    segs.append((tuple(rest), 1))
                return segs
        return [(tuple(kinds), 1)]

    def kv_cache_layers(self) -> List[Tuple[str, int]]:
        """(kind, effective cache length cap) per layer — 'local' layers use
        a ring buffer of sliding_window; ssm kinds carry state, no KV."""
        return [(k, self.sliding_window if k == "local" else 0)
                for k in self.layer_kinds()]

    def supports_long_context(self) -> bool:
        """True iff decode memory is sub-linear in context for at least the
        dominant share of layers (SSM/hybrid/sliding-window)."""
        kinds = self.layer_kinds()
        weak = sum(1 for k in kinds if k in ("mamba", "mlstm", "slstm", "local"))
        return weak >= len(kinds) // 2

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        hd, H, KV = self.head_dim, self.n_heads, self.n_kv_heads
        total = V * d * (1 if self.tie_embeddings else 2)
        for kind in (self.layer_kinds() if self.family != "encdec"
                     else ["attn"] * (self.n_layers + self.n_enc_layers)):
            attn = d * H * hd + 2 * d * KV * hd + H * hd * d
            mlp = 3 * d * ff
            if kind == "moe":
                mlp = self.n_experts * 3 * d * self.d_expert \
                    + self.n_shared_experts * 3 * d * self.d_expert \
                    + d * self.n_experts
            if kind in ("mamba", "mlstm", "slstm"):
                inner = self.ssm_expand * d
                attn = 0
                mlp = 2 * d * inner + inner * d + inner * (self.ssm_state or hd) * 2
            if kind == "shared_attn":
                pass  # shared params counted once below; rough: count 1/k here
            total += attn + mlp + 2 * d
        if self.family == "encdec":
            total += self.n_enc_layers * 0  # already included above
        return total

    def active_param_count(self) -> int:
        """Active (per-token) params for MoE rooflines: 6·N_active·D."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.n_layers * (
            self.n_experts * 3 * d * self.d_expert)
        return dense + self.n_layers * (
            (self.top_k) * 3 * d * self.d_expert)
