"""Requests, lifecycle state, and deterministic simulated traffic
(counterpart of ``repro.serve.request``: a copy, numpy only, whose traffic
equals the reference's field for field).

A :class:`Request` is one user generation call: a token prompt (plus the
per-family feature stub — SigLIP patch embeddings for VLM, frame
embeddings for enc-dec), a token budget, sampling parameters, and a
*simulated* arrival time in scheduler ticks.  :class:`RequestState` tracks
it through the serving lifecycle::

    QUEUED -> PREFILL -> DECODE -> DONE

Everything is driven by seeds and the scheduler's tick clock — no
wall-clock enters the logic, so a (seed, traffic) pair replays the exact
same token stream on every run (the serving analogue of the repo's
exactness tests).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

VISION_DIM = 1152  # SigLIP-so400m patch width (the reference's VISION_DIM)


class Phase(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation call.  ``arrival`` is in scheduler ticks (simulated);
    ``seed`` drives this request's sampling generator, mixed with the step
    index, so its tokens are independent of slot placement and batching."""

    rid: int
    prompt: np.ndarray               # (P,) int32 token ids
    max_new_tokens: int
    arrival: float = 0.0             # simulated ticks
    temperature: float = 0.0         # 0 = greedy
    top_k: int = 0                   # 0 = full vocab
    seed: int = 0
    features: Optional[np.ndarray] = None  # VLM patch embeds / encdec frames
    priority: int = 0                # higher = more urgent (admission order)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


@dataclasses.dataclass
class RequestState:
    request: Request
    phase: Phase = Phase.QUEUED
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    admit_tick: float = -1.0
    first_token_tick: float = -1.0
    finish_tick: float = -1.0
    finish_wall: float = -1.0        # metrics only, never read by logic
    prefill_chunks: int = 1          # row chunks the prefill plan picked
    prefill_left: int = 0            # chunks still to run (preemptible mode)

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def done(self) -> bool:
        return self.phase is Phase.DONE

    @property
    def n_generated(self) -> int:
        return len(self.generated)

    def finished_decoding(self) -> bool:
        return self.n_generated >= self.request.max_new_tokens


def _span(rng, v: Union[int, Tuple[int, int], Sequence[int]]) -> int:
    """An int is fixed; a (lo, hi) TUPLE is sampled inclusive; a list (of
    any length, including 2) is a choice set — bucketed length lists keep
    chunk-friendly divisors."""
    if isinstance(v, int):
        return v
    if isinstance(v, tuple) and len(v) == 2:
        return int(rng.integers(v[0], v[1] + 1))
    return int(v[rng.integers(0, len(v))])


def make_requests(n: int, vocab: int, *, seed: int = 0,
                  traffic: str = "static",
                  prompt_len: Union[int, Tuple[int, int], Sequence[int]] = 64,
                  max_new_tokens: Union[int, Tuple[int, int]] = 32,
                  mean_interarrival: float = 0.0,
                  temperature: float = 0.0, top_k: int = 0,
                  frontend: str = "none", n_feature_tokens: int = 0,
                  feature_dim: int = VISION_DIM,
                  priority: Union[int, Tuple[int, int], Sequence[int]] = 0,
                  burst_size: int = 4) -> List[Request]:
    """Deterministic simulated traffic.

    ``traffic="static"`` — everything arrives at tick 0 (the old one-shot
    batch, expressed as requests).  ``traffic="poisson"`` — exponential
    inter-arrival times with the given mean (in ticks), the standard
    open-loop serving model.  ``traffic="bursty"`` — Poisson-sized clumps
    of ~``burst_size`` requests sharing one arrival tick, with exponential
    gaps between clumps (mean ``mean_interarrival * burst_size``, so the
    long-run rate matches the plain Poisson stream) — the SLO stress
    pattern: quiet, then a pile-up.  ``frontend`` != "none" attaches
    per-request feature stubs: ``vision`` -> (n_feature_tokens,
    feature_dim) patch embeddings, ``audio`` -> same-shaped frames.
    ``priority`` accepts the same int / (lo, hi) / choice-list forms as
    the length knobs (higher = more urgent).
    """
    if traffic not in ("static", "poisson", "bursty"):
        raise ValueError(f"unknown traffic model {traffic!r}")
    rng = np.random.default_rng(seed)
    t = 0.0
    burst_left = 0
    out: List[Request] = []
    for rid in range(n):
        if traffic == "poisson" and mean_interarrival > 0:
            t += float(rng.exponential(mean_interarrival))
        elif traffic == "bursty" and mean_interarrival > 0:
            if burst_left <= 0:
                t += float(rng.exponential(
                    mean_interarrival * max(1, burst_size)))
                burst_left = 1 + int(rng.poisson(max(0, burst_size - 1)))
            burst_left -= 1  # clump members share this arrival tick
        p = _span(rng, prompt_len)
        prompt = rng.integers(0, vocab, (p,)).astype(np.int32)
        features = None
        if frontend != "none":
            features = rng.normal(
                0, 1, (n_feature_tokens, feature_dim)).astype(np.float32)
        out.append(Request(
            rid=rid, prompt=prompt, max_new_tokens=_span(rng, max_new_tokens),
            arrival=t, temperature=temperature, top_k=top_k,
            seed=seed * 100_003 + rid, features=features,
            priority=_span(rng, priority)))
    return out
