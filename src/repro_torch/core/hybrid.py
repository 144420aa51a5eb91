"""Checkpointing and hybrid row-centric execution (LR-CNN Sec. IV: 2PS-H /
OverL-H; the Ckp baseline from Chen et al. [10]).  Counterpart of
``repro.core.hybrid``.

The trunk is cut into segments at checkpoint locations.  Segment inputs are
the only full feature maps whose liveness spans FP->BP (the checkpoints);
within a segment activations are managed by the chosen engine:

* ``column``  — ``torch.utils.checkpoint`` per segment == the paper's *Ckp*
  (the reference's ``jax.checkpoint``).
* ``overlap`` — OverL within the segment            == *OverL-H*.
* ``twophase``— 2PS within the segment              == *2PS-H*.

Both row engines already recompute their rows inside their custom backward
and save only (params, segment input), so composing per-segment applies
*is* checkpointing.  Truncating the per-segment depth L is what shrinks the
halo growth / boundary skew and admits a larger N — the paper's Table I
effect.

Each segment's forward runs inside a ``segment`` range
(:func:`repro_torch.obs.profile_range`) whose attributes are the
segment's index, strategy and row count.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Sequence, Tuple

from torch.utils.checkpoint import checkpoint

from repro_torch import obs
from repro_torch.core import overlap as _ov
from repro_torch.core import twophase as _tp
from repro_torch.models.cnn.layers import trunk_heights


@dataclasses.dataclass(frozen=True)
class SegmentSpec:
    start: int          # module index range [start, end)
    end: int
    n_rows: int = 1
    strategy: str = "column"  # column | overlap | twophase


def auto_segments(n_modules: int,
                  n_segments: int | None = None) -> List[Tuple[int, int]]:
    """Even segmentation; default count = round(sqrt(L)) (the paper's
    preferred checkpointing frequency)."""
    if n_segments is None:
        n_segments = max(1, round(math.sqrt(n_modules)))
    n_segments = min(n_segments, n_modules)
    base, rem = divmod(n_modules, n_segments)
    cuts, cur = [], 0
    for i in range(n_segments):
        size = base + (1 if i < rem else 0)
        cuts.append((cur, cur + size))
        cur += size
    return cuts


@functools.lru_cache(maxsize=1024)
def _max_valid_rows(modules: tuple, h0: int, limit: int) -> int:
    """:func:`twophase.max_valid_rows`, memoised: the planner asks it for
    the same segment at every N it scans."""
    return _tp.max_valid_rows(modules, h0, limit)


def max_rows_per_segment(modules: Sequence, h0: int,
                         segs: Sequence[Tuple[int, int]],
                         strategy: str, limit: int = 64) -> List[int]:
    """Largest valid N per segment — drives the Table I counters."""
    hs = trunk_heights(modules, h0)
    out = []
    for a, b in segs:
        if strategy == "twophase":
            out.append(_max_valid_rows(tuple(modules[a:b]), hs[a], limit))
        else:  # overlap: valid while the final activation has >= N rows
            out.append(max(1, min(limit, hs[b])))
    return out


def make_hybrid_apply(modules: Sequence, h0: int,
                      segments: Sequence[SegmentSpec], residency=None):
    """Compose per-segment engines into one trunk apply.  ``residency``
    places the boundary caches of the 2PS segments (row programs); column
    and overlap segments carry nothing and ignore it."""
    assert segments[0].start == 0 and segments[-1].end == len(modules)
    hs = trunk_heights(modules, h0)
    seg_fns = []
    for spec in segments:
        sub = list(modules[spec.start:spec.end])
        h_in = hs[spec.start]
        if spec.strategy == "column":
            fn = _ov.make_column_apply(sub)
            if len(segments) > 1 or spec.n_rows > 1:
                fn = functools.partial(checkpoint, fn, use_reentrant=False)
        elif spec.strategy == "overlap":
            fn = _ov.make_overlap_apply(sub, h_in, spec.n_rows)
        elif spec.strategy == "twophase":
            fn = _tp.make_twophase_apply(sub, h_in, spec.n_rows,
                                         residency=residency)
        else:
            raise ValueError(spec.strategy)
        seg_fns.append((spec, fn))

    def apply(params, x):
        for i, (spec, fn) in enumerate(seg_fns):
            with obs.profile_range("segment", index=i,
                                   strategy=spec.strategy,
                                   n_rows=spec.n_rows):
                x = fn(params[spec.start:spec.end], x)
        return x

    return apply
