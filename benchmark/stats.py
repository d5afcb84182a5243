"""Tails and spreads.

A tail is the nearest-rank percentile over every request that arrived
in the window: a request that failed, or never finished, counts as
missing every limit and is given the stand-in value ``missing`` (the
latest time it could still have been served), so that it sorts last.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence


def nearest_rank(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q`` quantile (0 < q <= 1) by nearest rank: the smallest
    value with at least a share ``q`` of the values at or below it."""
    if not values:
        return None
    xs = sorted(values)
    return xs[min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))]


def tail(values: Sequence[Optional[float]], q: float,
         missing: float) -> Optional[float]:
    """``q`` quantile of ``values`` with each None (a failed or unfinished
    request) counted as ``missing``."""
    return nearest_rank([missing if v is None else v for v in values], q)


def union_length(intervals: List[tuple], lo: float, hi: float) -> float:
    """Length of the union of ``(start, end)`` intervals clipped to
    [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total
