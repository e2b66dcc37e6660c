"""The comparison that decides ``correct`` for a training cell.

Both sides report, over the first three steps of one seed's batches:
each step's loss, the per-leaf norm of the first gradient as worked out
from the state after one step, and the per-leaf norm of the change after
three steps and its projection on a normal draw of the seed's
(``reference.common.projections``; leaves: ``w0``, then each field's
table). Four numbers are compared, each against a limit of the cell's own
(``benchmark/limits/<cell>.json``):

- ``loss_gap``: the largest ``|L_prog − L_ref| / |L_ref|`` over the steps;
- ``grad_gap``: over the leaves, the largest ``|‖g_prog‖ − ‖g_ref‖|``
  over the larger of the reference's norm of that leaf and its median
  leaf's norm;
- ``change_gap``: the same for the change after three steps, over the
  leaves whose true first gradient in the reference is at least a
  thousandth of the median leaf's (a leaf below that moves by round-off
  alone);
- ``change_proj_gap``: over the same leaves, the largest gap of the two
  sides' projections over the same denominator. A projection on a
  standard normal ``R`` of a leaf's change spreads as its norm, so the
  gap spreads as the norm of the sides' difference: it reads a change
  whose rows went to the wrong ids, which keeps each leaf's norm.
"""

from __future__ import annotations

import json
import math
import os
import statistics

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "change_proj_gap")
#: A leaf whose reference gradient is below this share of the median
#: leaf's is left out of the change.
STILL_LEAF = 1e-3
HERE = os.path.dirname(os.path.abspath(__file__))


def _worst(prog: list, ref: list, keep: list[int],
           scale: list | None = None) -> tuple[float, int]:
    """The largest ``|prog − ref|`` over the larger of the leaf's
    ``scale`` (by default ``ref``) and the median leaf's."""
    scale = ref if scale is None else scale
    med = statistics.median(scale[i] for i in keep)
    worst, at = 0.0, -1
    for i in keep:
        p = prog[i]
        gap = (abs(p - ref[i]) / max(scale[i], med)
               if math.isfinite(p) else math.inf)
        if not gap <= worst:
            worst, at = gap, i
    return worst, at


def gaps(prog: dict, ref: dict) -> dict:
    """``{number: (value, worst leaf or step)}`` for the four numbers."""
    loss = [(abs(p - r) / abs(r) if math.isfinite(p) else math.inf, t)
            for t, (p, r) in enumerate(zip(prog["loss"], ref["loss"]))]
    med = statistics.median(ref["true_grad"])
    moving = [i for i, g in enumerate(ref["true_grad"])
              if g >= STILL_LEAF * med]
    everyone = list(range(len(ref["grad"])))
    return {"loss_gap": max(loss),
            "grad_gap": _worst(prog["grad"], ref["grad"], everyone),
            "change_gap": _worst(prog["change"], ref["change"], moving),
            "change_proj_gap": _worst(prog["change_proj"], ref["change_proj"],
                                      moving, ref["change"])}


def limits_for(cell: str) -> dict:
    """The cell's limits, ``benchmark/limits/<cell>.json``."""
    with open(os.path.join(HERE, "limits", f"{cell}.json")) as fh:
        got = json.load(fh)
    return {k: float(got[k]) for k in NUMBERS}


def judge(found: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, checks)``: each number with its limit; correct when
    every number is finite and at or under its limit."""
    checks = {k: {"value": found[k][0], "limit": limits[k]}
              for k in NUMBERS}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
