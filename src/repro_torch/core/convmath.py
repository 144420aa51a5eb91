"""Interval algebra for row-centric CNN execution (LR-CNN, Sec. III-B/IV).

Everything here is *static* integer math over the height axis.  A "row" in
LR-CNN is a contiguous interval of activation rows; forward and backward
planning reduces to propagating half-open intervals ``[start, stop)``
through each layer's geometry ``(k, s, p)``.

The paper's recursions are special cases:

* Eq. (11)  ``H_1^l = (H_1^{l+1} - 1) s^l + k^l - p^l``  is
  :func:`in_interval` applied to row 1 (top boundary clipped at 0).
* Eq. (13)/(14) (middle/last-row heights under 2PS) follow from the
  boundary recursion in :func:`twophase_boundaries`.
* Eq. (15) (overlap volume ``o_r^l``) is :func:`overlap_rows`.

Semi-closed padding (Sec. III-B "Conclusion and Solution"): when a row slice
is convolved, zero padding is applied **only** on sides that coincide with
the true tensor boundary; artificial seams introduced by row partitioning
are never padded.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

Interval = Tuple[int, int]  # half-open [start, stop)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Height-axis geometry of a sliding-window layer (conv or pool)."""

    k: int  # kernel extent along H
    s: int  # stride along H
    p: int  # symmetric padding along H (column-centric semantics)

    def __post_init__(self):
        if self.k < 1 or self.s < 1 or self.p < 0:
            raise ValueError(f"bad geometry {self}")

    # -- full-tensor laws -------------------------------------------------
    def out_size(self, h_in: int) -> int:
        """Column-centric output height: floor((H + 2p - k)/s) + 1."""
        h = (h_in + 2 * self.p - self.k) // self.s + 1
        if h < 1:
            raise ValueError(f"geometry {self} collapses H={h_in} to {h}")
        return h

    # -- interval propagation --------------------------------------------
    def in_interval(self, out_iv: Interval, h_in: int) -> Interval:
        """Input rows needed (clipped to the real tensor; the clipped-away
        part is supplied by true-boundary padding)."""
        os_, oe = out_iv
        if os_ >= oe:
            return (0, 0)
        lo = os_ * self.s - self.p
        hi = (oe - 1) * self.s - self.p + self.k
        return (max(0, lo), min(h_in, hi))

    def out_interval(self, in_iv: Interval, h_in: int) -> Interval:
        """Largest output interval computable from input rows ``in_iv``
        under semi-closed padding."""
        a, b = in_iv
        h_out = self.out_size(h_in)
        if a == 0:
            o_start = 0
        else:  # no top padding at a seam: need o*s - p >= a
            o_start = ceil_div(a + self.p, self.s)
        if b == h_in:
            o_end = h_out
        else:  # no bottom padding at a seam: need o*s - p + k <= b
            o_end = (b + self.p - self.k) // self.s + 1
        o_start = max(0, min(o_start, h_out))
        o_end = max(o_start, min(o_end, h_out))
        return (o_start, o_end)

    def first_out_of_slice(self, a: int) -> int:
        """Global index of the first output row produced when the kernel is
        slid over a slice starting at global input row ``a`` (top-padded
        only if ``a == 0``)."""
        return 0 if a == 0 else ceil_div(a + self.p, self.s)

    def pad_for_slice(self, in_iv: Interval, h_in: int) -> Tuple[int, int]:
        """Semi-closed padding amounts (top, bottom) for a slice."""
        a, b = in_iv
        return (self.p if a == 0 else 0, self.p if b == h_in else 0)


IDENTITY = Geometry(k=1, s=1, p=0)


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def interval_union(a: Interval, b: Interval) -> Interval:
    if a[0] >= a[1]:
        return b
    if b[0] >= b[1]:
        return a
    return (min(a[0], b[0]), max(a[1], b[1]))


def interval_size(iv: Interval) -> int:
    return max(0, iv[1] - iv[0])


def split_even(h: int, n: int) -> List[Interval]:
    """Balanced partition of [0, h) into n contiguous intervals (sizes
    differing by at most one; empty intervals are rejected)."""
    if n < 1 or n > h:
        raise ValueError(f"cannot split H={h} into N={n} non-empty rows")
    base, rem = divmod(h, n)
    out, cur = [], 0
    for r in range(n):
        size = base + (1 if r < rem else 0)
        out.append((cur, cur + size))
        cur += size
    assert cur == h
    return out


# ---------------------------------------------------------------------------
# Whole-trunk planning over a sequence of geometries
# ---------------------------------------------------------------------------

def heights(geoms: Sequence[Geometry], h0: int) -> List[int]:
    """Per-activation heights [H^0, H^1, ..., H^L]."""
    hs = [h0]
    for g in geoms:
        hs.append(g.out_size(hs[-1]))
    return hs


def backward_intervals(
    geoms: Sequence[Geometry], h0: int, out_iv: Interval
) -> List[Interval]:
    """Needed interval at every activation (input-first list, length L+1)
    for a given final-layer output interval — the OverL receptive-field
    closure; generalises Eq. (11)."""
    hs = heights(geoms, h0)
    ivs = [out_iv]
    for l in range(len(geoms) - 1, -1, -1):
        ivs.append(geoms[l].in_interval(ivs[-1], hs[l]))
    ivs.reverse()
    return ivs


def overlap_rows(geoms: Sequence[Geometry], h0: int, boundary_l: int) -> List[int]:
    """Eq. (15): number of input-side halo rows at every activation level for
    a row whose final-layer interval starts at row ``boundary_l`` (> 0).

    Returns ``o[l]`` for l = 0..L-1: how many rows *above* the ownership
    boundary are needed at activation l (replicated under OverL, cached
    under 2PS)."""
    hs = heights(geoms, h0)
    # Ownership boundary at each level: derived by the 2PS in_end recursion,
    # see twophase_boundaries.  Overlap = owned_start - needed_start.
    need = boundary_l
    own = boundary_l
    out = []
    for l in range(len(geoms) - 1, -1, -1):
        g = geoms[l]
        need_lo = max(0, need * g.s - g.p)
        # the boundary maps down through in_end of the row *above*:
        own_lo = max(0, min(hs[l], (own - 1) * g.s - g.p + g.k)) if own > 0 else 0
        out.append(max(0, own_lo - need_lo))
        need, own = need_lo, own_lo
    out.reverse()
    return out


def twophase_boundaries(
    geoms: Sequence[Geometry], h0: int, n_rows: int
) -> List[List[int]]:
    """2PS ownership boundaries ``P[l][r]`` (length-(N+1) list per
    activation l = 0..L).

    ``P[L]`` is the balanced split of the final activation.  Going down,
    ``P[l-1][r] = clip(in_end(P[l][r]))`` so that the rows a row needs
    *below* its own territory never exist — every straddling receptive field
    is owned by the *lower* row, which consumes the cached boundary rows of
    the row above (the paper's Fig. 4 sharing direction).
    """
    hs = heights(geoms, h0)
    h_l = hs[-1]
    top = split_even(h_l, n_rows)
    bounds = [[iv[0] for iv in top] + [h_l]]
    for l in range(len(geoms) - 1, -1, -1):
        g = geoms[l]
        above = bounds[-1]
        cur = [0]
        for r in range(1, n_rows):
            b = above[r]
            # in_end of the row above: last input row (exclusive) needed by
            # outputs [.., b) of layer l+1
            e = (b - 1) * g.s - g.p + g.k
            e = max(0, min(hs[l], e))
            cur.append(e)
        cur.append(hs[l])
        # monotonicity repair (degenerate tiny-H cases)
        for r in range(1, n_rows + 1):
            cur[r] = max(cur[r], cur[r - 1])
        bounds.append(cur)
    bounds.reverse()
    return bounds


def twophase_cache_sizes(
    geoms: Sequence[Geometry], h0: int, n_rows: int
) -> List[List[int]]:
    """Per (row, activation-level) cache head sizes: rows of activation l
    that row r consumes from row r-1's cache.  cache[r][l] for r=1..N-1,
    l=0..L-1.  Equals ``in_start(P[l+1][r]) .. P[l][r]``."""
    bounds = twophase_boundaries(geoms, h0, n_rows)
    hs = heights(geoms, h0)
    caches = []
    for r in range(1, n_rows):
        per_level = []
        for l in range(len(geoms)):
            g = geoms[l]
            need_lo = max(0, bounds[l + 1][r] * g.s - g.p)
            per_level.append(max(0, bounds[l][r] - need_lo))
        caches.append(per_level)
    return caches


def validate_twophase(geoms: Sequence[Geometry], h0: int, n_rows: int) -> bool:
    """A 2PS plan is valid iff every cache head lies inside the producing
    row's territory (paper's granularity bound ``(N-1)(k-s) <= max H``)."""
    try:
        bounds = twophase_boundaries(geoms, h0, n_rows)
    except ValueError:
        return False
    for l in range(len(bounds)):
        col = bounds[l]
        for r in range(1, n_rows):
            if col[r] <= col[r - 1]:  # empty territory => cache unavailable
                return False
    # cache head must come from the immediately preceding row only
    for r in range(1, n_rows):
        for l in range(len(geoms)):
            g = geoms[l]
            need_lo = max(0, bounds[l + 1][r] * g.s - g.p)
            if need_lo < bounds[l][r - 1]:
                return False
    return True


def max_valid_rows(geoms: Sequence[Geometry], h0: int, limit: int = 64) -> int:
    """Largest N for which a 2PS plan is valid (paper: N <= H / o_r^0)."""
    best = 1
    for n in range(2, limit + 1):
        if validate_twophase(geoms, h0, n):
            best = n
        else:
            break
    return best
