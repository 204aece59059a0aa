"""Monotone bisection used by SLO sizing.

Behavioral parity with the reference's BinarySearch
(upstream pkg/analyzer/utils.go:26-70): bounds are probed first,
an exact-enough boundary hit returns immediately, targets outside the
bounded region are reported with a -1/+1 indicator rather than an error,
and the interior search runs a fixed number of halvings against a
relative tolerance. Unlike the reference, the evaluator is passed in as a
closure — there is no module-global model state, so sizing is reentrant
and thread-safe (the reference's globals are called out as a wart in its
own survey).

Port copy of `inferno_tpu/analyzer/sizing.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

EPSILON = 1e-6
MAX_ITERATIONS = 100


def within_tolerance(x: float, value: float, tolerance: float = EPSILON) -> bool:
    if x == value:
        return True
    if value == 0 or tolerance < 0:
        return False
    return abs((x - value) / value) <= tolerance


@dataclasses.dataclass(frozen=True)
class BisectionResult:
    x: float
    # -1: target below bounded region; 0: found within; +1: above region
    indicator: int


def bisect_monotone(
    x_min: float,
    x_max: float,
    y_target: float,
    eval_fn: Callable[[float], float],
    tolerance: float = EPSILON,
    max_iterations: int = MAX_ITERATIONS,
) -> BisectionResult:
    """Find x in [x_min, x_max] with eval_fn(x) ~= y_target.

    eval_fn must be monotone (either direction) over the interval.
    """
    if x_min > x_max:
        raise ValueError(f"invalid range [{x_min}, {x_max}]")

    y_lo = eval_fn(x_min)
    if within_tolerance(y_lo, y_target, tolerance):
        return BisectionResult(x_min, 0)
    y_hi = eval_fn(x_max)
    if within_tolerance(y_hi, y_target, tolerance):
        return BisectionResult(x_max, 0)

    if y_lo == y_hi:
        # Flat curve with no crossing (e.g. degenerate single-token
        # workloads where ITL is rate-independent): report which side the
        # target lies on instead of misreading flat as decreasing — the
        # reference errs here and calls a met-everywhere target
        # "unachievable" (pkg/analyzer/utils.go:40-44).
        if y_target > y_lo:
            return BisectionResult(x_max, +1)
        return BisectionResult(x_min, -1)

    increasing = y_lo < y_hi
    if (increasing and y_target < y_lo) or (not increasing and y_target > y_lo):
        return BisectionResult(x_min, -1)
    if (increasing and y_target > y_hi) or (not increasing and y_target < y_hi):
        return BisectionResult(x_max, +1)

    x_star = 0.5 * (x_min + x_max)
    for _ in range(max_iterations):
        x_star = 0.5 * (x_min + x_max)
        y_star = eval_fn(x_star)
        if within_tolerance(y_star, y_target, tolerance):
            break
        if (increasing and y_target < y_star) or (not increasing and y_target > y_star):
            x_max = x_star
        else:
            x_min = x_star
    return BisectionResult(x_star, 0)
