"""Analytic per-device FLOP / HBM-byte / collective-byte model
(counterpart of ``repro.analysis.costmodel``; the counts are the
reference's, formula for formula, and only the three times change: they
divide by the H100's constants in :mod:`repro_torch.launch.mesh`).

Why the reference has it: XLA's ``compiled.cost_analysis()`` counts a
loop body once, and its stacks are scans over layers.  The port's dry
run traces every op it executes (:func:`repro_torch.obs.audit.trace_step`),
so its traced counts have no such undercount; this model stays beside
them as the napkin math the roofline reasons in, and the ratio of the two
shows what the model leaves out (causal halves, heads that do not divide
the model axis and run whole on every rank, the optimizer's elementwise
work).

Conventions:
* matmul FLOPs = 2*m*n*k; training multiplies matmul work by 3 (fwd +
  2x bwd) or 4 with row-remat (the extra forward — exactly the paper's
  4τ in Sec. IV-B's time-complexity analysis).
* per-device = global / participating shards; batch shards over
  ("pod","data"), heads/ff/experts over "model".
* HBM bytes: weights touched per step (fwd+bwd+optimizer) + activation
  traffic + KV-cache traffic (decode).  Flash/chunked attention keeps
  score tiles on chip (not counted as HBM).
* collectives: ring all-reduce of M bytes over n ranks moves
  2*M*(n-1)/n per device; all-gather/reduce-scatter M*(n-1)/n;
  all-to-all M*(n-1)/n.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16
from repro_torch.models.lm.config import ModelConfig


@dataclasses.dataclass
class CostBreakdown:
    flops: float = 0.0          # per device
    hbm_bytes: float = 0.0      # per device
    coll_bytes: float = 0.0     # per device
    detail: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, key, flops=0.0, hbm=0.0, coll=0.0):
        self.flops += flops
        self.hbm_bytes += hbm
        self.coll_bytes += coll
        self.detail[key] = self.detail.get(key, 0.0) + flops

    @property
    def t_compute(self):
        return self.flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self):
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self):
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self):
        t = {"compute": self.t_compute, "memory": self.t_memory,
             "collective": self.t_collective}
        return max(t, key=t.get)

    def as_dict(self):
        return {"flops_per_chip": self.flops,
                "hbm_bytes_per_chip": self.hbm_bytes,
                "coll_bytes_per_chip": self.coll_bytes,
                "t_compute_s": self.t_compute,
                "t_memory_s": self.t_memory,
                "t_collective_s": self.t_collective,
                "bottleneck": self.bottleneck}


def _mesh_dims(mesh_shape: Dict[str, int]):
    dp = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    tp = mesh_shape.get("model", 1)
    return dp, tp


def _ar(m, n):  # ring all-reduce per-device traffic
    return 2.0 * m * (n - 1) / n if n > 1 else 0.0


def _ag(m, n):  # all-gather / reduce-scatter / all-to-all per-device
    return 1.0 * m * (n - 1) / n if n > 1 else 0.0


def _capacity(t, cfg: ModelConfig):
    c = int(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(4, -(-c // 4) * 4)


def layer_flops_fwd(cfg: ModelConfig, kind: str, tokens: float,
                    ctx_len: float, seq_group: float) -> Dict[str, float]:
    """Forward FLOPs of one layer of `kind` over `tokens` tokens with
    attention context `ctx_len` (= S for train/prefill, cache len for
    decode).  Returns {component: flops} (global, unsharded)."""
    d, ff = cfg.d_model, cfg.d_ff
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out: Dict[str, float] = {}
    if kind in ("attn", "local", "global", "shared_attn", "moe"):
        eff_ctx = min(ctx_len, cfg.sliding_window) if kind == "local" \
            else ctx_len
        causal_frac = 0.5 if tokens > 1 and kind != "local" else 1.0
        out["qkvo"] = 2 * tokens * d * (2 * H * hd + 2 * KV * hd)
        out["scores"] = 2 * 2 * tokens * eff_ctx * H * hd * causal_frac
        if kind == "moe":
            E, k, f = cfg.n_experts, cfg.top_k, cfg.d_expert
            t = seq_group
            C = _capacity(t, cfg)
            out["router"] = 2 * tokens * d * E
            # GShard dispatch/combine einsums: 2*T*E*C*d each
            out["dispatch"] = 4 * tokens * E * C * d
            # expert FFN on E*C slots per group = T*k*cf effective tokens
            out["experts"] = 6 * tokens * k * cfg.capacity_factor * d * f
            if cfg.n_shared_experts:
                out["shared"] = 6 * tokens * d * f * cfg.n_shared_experts
        else:
            out["mlp"] = 6 * tokens * d * ff
    elif kind == "mamba":
        inner = cfg.ssm_expand * d
        N = cfg.ssm_state or 64
        Hs = cfg.ssm_heads or H
        P = inner // Hs
        out["proj"] = 2 * tokens * d * (2 * inner + 2 * N + Hs) \
            + 2 * tokens * inner * d
        out["conv"] = 2 * tokens * (inner + 2 * N) * cfg.conv_k
        c = min(256.0, ctx_len)
        out["ssd"] = tokens * (2 * c * N + 2 * c * Hs + 2 * c * Hs * P) \
            + 4 * tokens * N * Hs * P
    elif kind in ("mlstm", "slstm"):
        inner = cfg.ssm_expand * d if kind == "mlstm" else d
        hd_x = inner // cfg.n_heads
        if kind == "mlstm":
            out["proj"] = 2 * tokens * d * 2 * inner + 3 * 2 * tokens * inner * inner \
                + 2 * tokens * inner * d
            out["recur"] = 6 * tokens * cfg.n_heads * hd_x * hd_x
        else:
            out["proj"] = 2 * tokens * d * 4 * d + 2 * tokens * d * d
            out["recur"] = 2 * tokens * cfg.n_heads * hd_x * 4 * hd_x
    return out


def layer_param_bytes(cfg: ModelConfig, kind: str, dtype_bytes: int = 4):
    d, ff = cfg.d_model, cfg.d_ff
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if kind in ("attn", "local", "global", "shared_attn"):
        return (d * (H + 2 * KV) * hd + H * hd * d + 3 * d * ff) * dtype_bytes
    if kind == "moe":
        E, f = cfg.n_experts, cfg.d_expert
        return (d * (H + 2 * KV) * hd + H * hd * d + d * E
                + 3 * E * d * f
                + 3 * cfg.n_shared_experts * d * f) * dtype_bytes
    if kind == "mamba":
        inner = cfg.ssm_expand * d
        N = cfg.ssm_state or 64
        return (d * (2 * inner + 2 * N + (cfg.ssm_heads or H))
                + inner * d) * dtype_bytes
    if kind == "mlstm":
        inner = cfg.ssm_expand * d
        return (2 * d * inner + 3 * inner * inner + inner * d) * dtype_bytes
    if kind == "slstm":
        return (4 * d * d + 4 * d * d // cfg.n_heads + d * d) * dtype_bytes
    raise ValueError(kind)


def analyze(cfg: ModelConfig, shape, mesh_shape: Dict[str, int],
            fsdp: bool = False, dtype_bytes: int = 2,
            param_dtype_bytes: int = 0) -> CostBreakdown:
    """Per-device cost model for (arch, shape, mesh)."""
    if param_dtype_bytes == 0:
        param_dtype_bytes = 2 if "bfloat16" in str(cfg.param_dtype) else 4
    dp, tp = _mesh_dims(mesh_shape)
    n_chips = dp * tp
    dp_only = getattr(cfg, "parallel", "tp") == "dp_only"
    if dp_only:
        dp, tp = n_chips, 1
        fsdp = True
    cb = CostBreakdown()

    kinds = cfg.layer_kinds()
    if cfg.family == "encdec":
        kinds = ["attn"] * (cfg.n_enc_layers + cfg.n_layers)  # + cross below

    train = shape.kind == "train"
    decode = shape.kind == "decode"
    if decode:
        tokens = float(shape.batch)
        ctx = float(shape.seq)
    else:
        tokens = float(shape.batch * shape.seq)
        ctx = float(shape.seq)
        if cfg.family in ("encdec", "vlm"):
            pass  # same order of magnitude; frontends stubbed

    # matmul work multiplier: fwd=1; +2 bwd; +1 remat re-forward
    mult = 1.0
    if train:
        mult = 4.0 if cfg.remat in ("rows", "block", "block_rows") else 3.0

    seq_group = ctx / max(1, cfg.moe_seq_groups) if not decode else 1.0

    # --- per-layer compute + params ------------------------------------
    total_param_bytes = 0.0
    seen_shared = False
    for kind in kinds:
        comp = layer_flops_fwd(cfg, kind, tokens, ctx, seq_group)
        for k, v in comp.items():
            cb.add(f"{kind}/{k}", flops=mult * v / n_chips)
        if kind == "shared_attn" and seen_shared:
            pass  # shared params counted once
        else:
            total_param_bytes += layer_param_bytes(cfg, kind,
                                                   param_dtype_bytes)
            seen_shared |= kind == "shared_attn"

    # head + embedding
    V, d = cfg.vocab, cfg.d_model
    head_tokens = tokens
    cb.add("head", flops=mult * 2 * head_tokens * d * V / n_chips)
    total_param_bytes += V * d * param_dtype_bytes * \
        (1 if cfg.tie_embeddings else 2)
    if cfg.family == "encdec":
        # cross-attention per decoder layer
        cross = 2 * tokens * d * (2 * cfg.n_kv_heads * cfg.head_dim) \
            + 2 * 2 * tokens * (ctx / 2) * cfg.n_heads * cfg.head_dim
        cb.add("cross", flops=mult * cross * cfg.n_layers / n_chips)

    p_local = total_param_bytes / n_chips  # params spread over all axes
    # --- HBM traffic ----------------------------------------------------
    data_only = mesh_shape.get("data", 1)
    batch_shards = dp if shape.batch % dp == 0 else \
        (data_only if shape.batch % data_only == 0 else 1)
    t_local = tokens / batch_shards
    if train:
        # fwd read + bwd read + grad write + adam (read mu,nu + write p,mu,nu)
        cb.add("hbm/weights", hbm=8.0 * p_local)
        # per layer: write out, read in bwd, remat re-read ~ 6 touches
        cb.add("hbm/acts",
               hbm=6.0 * t_local * d * dtype_bytes * len(kinds))
    else:
        cb.add("hbm/weights", hbm=1.0 * p_local)
        cb.add("hbm/acts", hbm=4.0 * t_local * d * dtype_bytes * len(kinds))
    if decode:
        # KV cache read per token + state reads
        kv_bytes = 0.0
        for kind in kinds:
            if kind in ("attn", "global", "shared_attn", "moe"):
                kv_bytes += 2 * ctx * cfg.n_kv_heads * cfg.head_dim \
                    * dtype_bytes
            elif kind == "local":
                kv_bytes += 2 * min(ctx, cfg.sliding_window) \
                    * cfg.n_kv_heads * cfg.head_dim * dtype_bytes
            elif kind == "mamba":
                inner = cfg.ssm_expand * d
                kv_bytes += inner * (cfg.ssm_state or 64) * 4
            elif kind == "mlstm":
                inner = cfg.ssm_expand * d
                kv_bytes += inner * (inner // cfg.n_heads) * 4
            elif kind == "slstm":
                kv_bytes += 4 * d * 4
        # cache shards: batch over (pod,data) & heads over model; for
        # batch=1 (long_500k) the cache *sequence* shards over data instead
        if shape.batch == 1:
            shard = data_only * tp
        else:
            shard = batch_shards * tp
        cb.add("hbm/kvcache", hbm=shape.batch * kv_bytes / shard)
    # --- collectives -----------------------------------------------------
    n_layers = len(kinds)
    act_local = t_local * d * dtype_bytes
    ar_per_layer = 2.0  # attn-out + mlp-out psum over tp
    fb = 2.0 if train else 1.0  # bwd repeats the psums
    cb.add("coll/tp", coll=_ar(act_local, tp) * ar_per_layer * n_layers * fb)
    if train:
        cb.add("coll/grads", coll=_ar(total_param_bytes / tp, dp))
        if fsdp:
            cb.add("coll/fsdp",
                   coll=2.0 * _ag(total_param_bytes / tp, dp))
    moe_layers = sum(1 for k in kinds if k == "moe")
    if moe_layers:
        disp = t_local * cfg.top_k * d * dtype_bytes * cfg.capacity_factor
        cb.add("coll/moe_a2a",
               coll=_ag(disp, tp) * 2 * moe_layers * (2 if train else 1))
    return cb
