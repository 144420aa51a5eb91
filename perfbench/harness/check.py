"""The comparison that decides ``correct``.

Both sides take the same three SGD steps from the same weights on the
same first three batches.  Four numbers are read, and each that has a
limit in ``perfbench/workloads/<cell>.json`` is compared with it (a cell
leaves ``loss_later`` out where the low-precision control reads too near
its sound runs for a limit with room on both sides):

* ``loss_step1``: the relative gap of the first step's loss;
* ``loss_later``: the largest relative gap of a later step's loss (these
  carry the first steps' rounding through ReLU and max-pool kinks, and
  swing from seed to seed by nature);
* ``grad``: the first gradient, by the worst leaf: the gap between the two
  sides' norms of a leaf, over the reference's norm of that leaf or of the
  median leaf, whichever is larger;
* ``update``: the same for each leaf's change after the three steps.  A
  leaf whose reference gradient is under a thousandth of the median
  leaf's moves by weight decay alone and is left out of it.

A number that is not finite fails."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Tuple

#: a leaf whose reference gradient is below this share of the median
#: leaf's is left out of ``update``
ROUNDING_LEAF = 1e-3


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], names):
    med = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in names}


def _worst(gaps: Dict[str, float]):
    bad = [n for n, g in gaps.items() if not math.isfinite(g)]
    if bad:
        return math.inf, bad[0]
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def _loss_gap(prog, ref, steps):
    worst, step = 0.0, steps[0]
    for i in steps:
        gap = abs(prog["loss"][i] - ref["loss"][i]) / abs(ref["loss"][i])
        if not math.isfinite(gap):
            return math.inf, i
        if gap > worst:
            worst, step = gap, i
    return worst, step


def gaps(prog: dict, ref: dict) -> Tuple[Dict[str, float], Dict[str, str]]:
    """``({number: value}, {number: the step or leaf that set it})``."""
    first, _ = _loss_gap(prog, ref, [0])
    later, step = _loss_gap(prog, ref, range(1, len(ref["loss"])))
    names = sorted(ref["grad"])
    grad, g_leaf = _worst(_leaf_gaps(prog["grad"], ref["grad"], names))
    med = statistics.median(ref["grad"][n] for n in names)
    moved = [n for n in names if ref["grad"][n] >= ROUNDING_LEAF * med]
    update, u_leaf = _worst(_leaf_gaps(prog["update"], ref["update"], moved))
    return ({"loss_step1": first, "loss_later": later, "grad": grad,
             "update": update},
            {"loss_step1": "step 1", "loss_later": f"step {step + 1}",
             "grad": g_leaf,
             "update": f"{u_leaf}; {len(names) - len(moved)} leaves left "
                       f"out"})


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(math.isfinite(values[k]) and values[k] <= limits[k]
               for k in limits)


def lines(values, limits, where) -> list:
    """The numbers beside their limits, one line each."""
    return [f"check {k} {values[k]!r} limit {limits[k]!r} ({where[k]})"
            for k in limits]
