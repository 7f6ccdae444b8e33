"""The numbers that decide ``correct``: each a gap between what the
program produced and what the plain reference works out from the same
inputs, held against a limit of its cell (``limits`` in the cell's file).

Three ticks run through the window's own call before the window.  A leaf's
gap is ‖ours − reference‖ over the larger of the reference's norm of that
leaf and of the median leaf's:

* ``grad``: the critic's first gradient as Adam took it (read from its
  state right after its first update), the median leaf's gap;
* ``g_grad``: the generator's first gradient as Adam took it, against the
  reference's taken through the same critic, the one that stood when the
  judged side's generator made its first update (read back by name): the
  widest leaf's gap;
* ``g_grad_outlier``: the same gaps, the widest over the median (a median
  under ``G_MEDIAN_FLOOR`` counts as that).  Every leaf of the generator
  takes its gradient through the critic's gradient at the fakes, which the
  program rounds in bf16 through the whole critic: that rounding moves
  every leaf's gap alike, and by ten times from seed to seed, so ``g_grad``
  needs a wide limit.  A kernel's backward feeds a few leaves (the
  up-blocks' weights), and its fault stands out of the rest;
* ``change``: the gap between the norms of each leaf's change over the
  three ticks, over the larger of the reference's and the median leaf's;
  the median over a network's leaves, the larger of the two networks'.

Why these (the readings are in ``PERF.md``): a gap of two norms is second
order in the error; the generator's gradient is taken after the critic's
first Adam steps, which move each weight by ±lr whatever its gradient's
size, so against the reference's own critic it would also read rounding
that flipped a step; through the same critic it reads the rounding of the
generator's update alone.  The critic's first gradient is taken before
any weight moved.  Leaves whose reference gradient is under a thousandth
of the median leaf's are left out: their gradient is nought to rounding
(the stage's unused toRGB / fromRGB), and Adam moves them by rounding
alone.
"""

from __future__ import annotations

import math
from statistics import median
from typing import Dict, List, Optional

import numpy as np

EXCLUDE_BELOW = 1e-3
# gaps under this are float32's agreement, not bf16 rounding
G_MEDIAN_FLOOR = 1e-3


def _gap(ours: float, ref: float, floor: float) -> float:
    if not (math.isfinite(ours) and math.isfinite(ref)):
        return math.inf
    return abs(ours - ref) / max(abs(ref), floor, 1e-30)


def kept_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= EXCLUDE_BELOW * med]


def leaf_gaps(ours: Dict[str, Dict[str, float]],
              ref: Dict[str, Dict[str, float]],
              ref_grad: Dict[str, Dict[str, float]]
              ) -> Dict[str, Dict[str, float]]:
    """Each kept leaf's gap of norms, by network."""
    out = {}
    for net, r in ref.items():
        keep = kept_leaves(ref_grad[net])
        floor = median(r[k] for k in keep)
        out[net] = {k: _gap(ours.get(net, {}).get(k, math.nan), r[k], floor)
                    for k in keep}
    return out


def leaf_gap(ours: Dict[str, Dict[str, float]],
             ref: Dict[str, Dict[str, float]],
             ref_grad: Dict[str, Dict[str, float]]) -> float:
    """The larger of the two networks' median leaf gaps."""
    return max(median(g.values())
               for g in leaf_gaps(ours, ref, ref_grad).values())


def grad_norms(grad: Dict[str, Dict[str, "torch.Tensor"]]
               ) -> Dict[str, Dict[str, float]]:
    """Each leaf's norm of a first gradient, by network."""
    return {net: {k: float(np.linalg.norm(np.asarray(v, np.float64)))
                  for k, v in g.items()} for net, g in grad.items()}


def diff_gaps(ours: Dict[str, "torch.Tensor"], ref: Dict[str, "torch.Tensor"]
              ) -> Dict[str, float]:
    """Each kept leaf's ‖ours − ref‖ over the larger of ‖ref‖ and the
    median leaf's, for one network's first gradient."""
    norms = {k: float(np.linalg.norm(np.asarray(v, np.float64)))
             for k, v in ref.items()}
    keep = kept_leaves(norms)
    floor = median(norms[k] for k in keep)
    out = {}
    for k in keep:
        r = np.asarray(ref[k], np.float64)
        o = np.asarray(ours[k], np.float64) if k in ours else None
        out[k] = (math.inf if o is None or o.shape != r.shape
                  or not np.all(np.isfinite(o))
                  else float(np.linalg.norm(o - r)) / max(norms[k], floor))
    return out


def outlier(gaps: Dict[str, float]) -> float:
    """The widest leaf's gap over the median leaf's (or the floor)."""
    worst = max(gaps.values())
    if not math.isfinite(worst):
        return math.inf
    return worst / max(median(gaps.values()), G_MEDIAN_FLOOR)


def train_numbers(ours: Dict, ref: Dict, ref_g: Optional[Dict]
                  ) -> Dict[str, float]:
    """The numbers of a training cell.  `ref_g` is the reference's first
    generator gradient through the critic that `ours` recorded (None where
    it recorded none: no first update came)."""
    g_gaps = (diff_gaps(ours["grad"].get("g", {}), ref_g)
              if ref_g is not None else {"": math.inf})
    return {"grad": median(diff_gaps(ours["grad"].get("d", {}),
                                     ref["grad"]["d"]).values()),
            "g_grad": max(g_gaps.values()),
            "g_grad_outlier": outlier(g_gaps),
            "change": leaf_gap(ours["change"], ref["change"],
                               grad_norms(ref["grad"]))}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number under its limit (a number without a limit fails)."""
    return all(name in limits and numbers[name] <= limits[name]
               for name in numbers)
