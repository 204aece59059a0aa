"""The least time the card could take for a sizing cycle's work.

The work is what the cycle's changed inputs need, whatever implements
it: a lane whose token mix changed is sized anew (the two ends of its
rate range, each bisection's steps to its fixed point, the throughput at
the binding rate, the operating point), a lane whose arrival rate alone
changed gets its operating point, and an unchanged lane nothing. A
stationary solve of one chain reads each head state once (the lane's own
max batch, not a bucket's padded width) at OPS_PER_ELEMENT f32
operations; inputs are read once and outputs written once. The peaks are
one H100 SXM's (NVIDIA's data sheet, at its 700 W limit).
"""

from __future__ import annotations

import numpy as np

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
OPS_PER_ELEMENT = 11
BISECT_ITERS = 32  # the program's f32 bisection: halvings to a fixed point within 32
LANE_IN_BYTES = 12 * 4  # a lane's f32/i32 inputs (profile, tokens, batch, cap, SLOs, rate)
LANE_OUT_BYTES = 8 * 4  # its eight f32 results


def f32_steps(lam_min, lam_max, lam_star, fixed, iters: int = BISECT_ITERS):
    """Each lane's halvings of [lam_min, lam_max] in f32 before the first
    one that leaves the interval unchanged in every bit, walking towards
    `lam_star` (the reference's rate): the steps a bisection to the f32
    fixed point needs. 0 where the result needs no search (`fixed`)."""
    lo = np.asarray(lam_min, np.float32)
    hi = np.asarray(lam_max, np.float32)
    star = np.asarray(lam_star, np.float64)
    needed = np.where(fixed, 0, iters).astype(np.int64)
    done = np.asarray(fixed, bool).copy()
    half = np.float32(0.5)
    for it in range(iters):
        if done.all():
            break
        mid = half * (lo + hi)
        high = mid.astype(np.float64) > star
        new_lo, new_hi = np.where(high, lo, mid), np.where(high, mid, hi)
        same = (new_lo == lo) & (new_hi == hi)
        needed = np.where(~done & same, it, needed)
        done |= same
        lo, hi = new_lo, new_hi
    return needed


def cycle_bound_s(lanes: dict, sized: dict | None, full, refold) -> float:
    """Seconds of the least time for one cycle: `full` and `refold` are
    per-lane masks (token mix changed / arrival rate alone changed),
    `sized` the reference's sizing of the cycle (needed where `full`)."""
    loaded = ~lanes["zero"]
    full = np.asarray(full, bool) & loaded
    refold = np.asarray(refold, bool) & loaded & ~full
    chain = lanes["batch"]  # head states of one evaluation at a rate
    elements = float(np.sum(chain[refold]))
    if full.any():
        s_t = f32_steps(sized["lam_min"], sized["lam_max"], sized["lam_ttft"], sized["fixed_ttft"])
        s_i = f32_steps(sized["lam_min"], sized["lam_max"], sized["lam_itl"], sized["fixed_itl"])
        # the rate range's two ends, the throughput at the binding rate and
        # the operating point evaluate the chain once each, a bisection
        # once a step
        per = chain * (4 + s_t + s_i)
        elements += float(np.sum(per[full]))
    lanes_touched = int(np.sum(full | refold))
    t_ops = elements * OPS_PER_ELEMENT / PEAK_F32_OPS_PER_S
    t_bytes = lanes_touched * (LANE_IN_BYTES + LANE_OUT_BYTES) / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes)
