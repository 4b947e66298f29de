"""The numbers that decide ``correct``, each against its limit.

Gaps of norms are taken leaf by leaf: the gap between the program's norm
and the reference's, over the reference's norm of that leaf or of the
median leaf, whichever is larger (some gradients are all but zero).  The
worst leaf is the number.  A leaf whose norm is not finite on either
side, or that the program lacks, reads infinity: no limit passes it.
"""
from __future__ import annotations

import math
import statistics


def leaf_gap(prog: float | None, ref: float, med: float) -> float:
    """One leaf's relative gap; infinity where the program lacks the
    leaf or either norm is not finite."""
    if prog is None or not (math.isfinite(prog) and math.isfinite(ref)):
        return math.inf
    return abs(prog - ref) / max(ref, med, 1e-30)


def widest(gaps: list[float]) -> float:
    """The largest of ``gaps``; infinity if any is not finite (``max``
    passes a NaN over unless it comes first)."""
    return max((g if math.isfinite(g) else math.inf for g in gaps),
               default=math.inf)


def worst_leaf_gap(prog: dict[str, float], ref: dict[str, float],
                   skip: frozenset = frozenset()) -> tuple[float, str]:
    """-> (the worst leaf's relative gap, its name)."""
    keys = [k for k in ref if k not in skip]
    med = statistics.median(ref[k] for k in keys)
    gaps = {k: leaf_gap(prog.get(k), ref[k], med) for k in keys}
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def median_leaf_gap(prog: dict[str, float], ref: dict[str, float],
                    skip: frozenset = frozenset()) -> float:
    """The median over the leaves of the same relative gap."""
    keys = [k for k in ref if k not in skip]
    med = statistics.median(ref[k] for k in keys)
    return statistics.median(leaf_gap(prog.get(k), ref[k], med)
                             for k in keys)


def still_leaves(raw_grad: dict[str, float]) -> frozenset:
    """Leaves whose reference gradient is nought to rounding: under a
    thousandth of the median leaf's.  Adam moves them by round-off
    alone, so their change is not compared."""
    med = statistics.median(raw_grad.values())
    return frozenset(k for k, n in raw_grad.items() if n < 1e-3 * med)


def judge(numbers: dict[str, float], limits: dict[str, dict]
          ) -> tuple[bool, dict[str, dict]]:
    """Each number against its limit (a number at or under it passes; a
    number that is not finite fails).  -> (all pass, {name: {"value",
    "limit"}}), in the limits' order."""
    out, ok = {}, True
    for name, spec in limits.items():
        value = numbers.get(name, float("nan"))
        limit = spec["limit"]
        ok = ok and math.isfinite(value) and value <= limit
        out[name] = {"value": value, "limit": limit}
    return ok, out
