"""The plain reference of the capacity planner's rows: given each lane's
sizing (`sizing.size`, which does not depend on the arrival rate), every
row of a [steps, variants] rate matrix folds each lane's replicas, and
every variant picks the least (objective, cost, shape name) among its
feasible lanes; a variant at zero rate holds its zero-load lanes.

Dense over (row, variant, shape); imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.sizing import penalty


def dense(fleet: dict, lanes: dict, sized: dict) -> dict:
    """[variants, shapes] columns of the lanes: feasible, rate (req/s a
    replica), cost a replica, zero-load; absent lanes infeasible."""
    n, k = fleet["n"], len(fleet["shape_names"])
    out = {"feasible": np.zeros((n, k), bool), "rate": np.ones((n, k)),
           "cpr": np.zeros((n, k)), "zero": np.zeros((n, k), bool)}
    var, shp = lanes["var"], lanes["shape"]
    out["feasible"][var, shp] = sized["feasible"]
    out["rate"][var, shp] = np.where(sized["feasible"], sized["rate"], 1.0)
    out["cpr"][var, shp] = lanes["cost_per_replica"]
    out["zero"][var, shp] = lanes["zero"]
    return out


def _keys(fleet, state, d, reps):
    """(value, cost) of every lane at replicas `reps` [T, n, k]."""
    k = d["cpr"].shape[1]
    cost = reps * d["cpr"][None]
    shape = np.arange(k)[None, None, :]
    value = penalty(fleet["cur_rank"][None, :, None], state["cur_reps"][None, :, None],
                    state["cur_cost"][None, :, None], shape, reps, cost)
    return value, cost


def options(d: dict, rates: np.ndarray, tol: float):
    """The replicas each lane may hold at each row: (low, high) [T, n, k],
    equal unless the load over the rate lies within `tol` of a whole
    number (a ceil boundary, where either count is right)."""
    total = rates[:, :, None] / 60.0
    x = total / d["rate"][None]
    exact = np.maximum(np.ceil(x), 1.0)
    near = np.rint(x)
    boundary = np.abs(x - near) <= tol * x
    low = np.where(boundary, np.maximum(near, 1.0), exact)
    high = np.where(boundary, np.maximum(near + 1.0, 1.0), exact)
    zero = d["zero"][None] | (total <= 0)
    low = np.where(zero, 1.0, low)
    high = np.where(zero, 1.0, high)
    return low, high


def _lex_less(a, b):
    """(value, cost, rank) a < b, elementwise."""
    return (a[0] < b[0]) | ((a[0] == b[0]) & ((a[1] < b[1]) | ((a[1] == b[1]) & (a[2] < b[2]))))


def pick(fleet, state, d, reps):
    """Each row's pick per variant: (shape index, replicas), -1 where the
    variant has no feasible lane."""
    value, cost = _keys(fleet, state, d, reps)
    rank = np.argsort(np.argsort(fleet["shape_names"]))
    feasible = np.broadcast_to(d["feasible"][None], value.shape)
    value = np.where(feasible, value, np.inf)
    cost = np.where(feasible, cost, np.inf)
    k = value.shape[2]
    best = np.full(value.shape[:2], -1, np.int64)
    bv, bc, br = (np.full(value.shape[:2], np.inf) for _ in range(3))
    for s in range(k):
        cand = (value[:, :, s], cost[:, :, s], np.full(value.shape[:2], rank[s], float))
        better = feasible[:, :, s] & _lex_less(cand, (bv, bc, br))
        best = np.where(better, s, best)
        bv, bc, br = (np.where(better, c, b) for c, b in zip(cand, (bv, bc, br)))
    reps_b = np.take_along_axis(reps, np.maximum(best, 0)[:, :, None], axis=2)[:, :, 0]
    return best, np.where(best >= 0, reps_b, -1).astype(np.int64)


def row_costs(fleet, state, d, rates) -> np.ndarray:
    """Each row's summed cost of the picks (cents/hr), at exact ceil."""
    low, _ = options(d, rates, 0.0)
    best, reps = pick(fleet, state, d, low)
    cpr = np.take_along_axis(d["cpr"][None].repeat(len(rates), 0),
                             np.maximum(best, 0)[:, :, None], axis=2)[:, :, 0]
    return np.where(best >= 0, reps * cpr, 0.0).sum(axis=1)


def cells_off(fleet, state, d, rates, choice, replicas, tol, tie) -> int:
    """Cells (row, variant) whose pick (shape index `choice`, `replicas`)
    no reading of the boundary lanes makes the least: the picked lane is
    infeasible or holds replicas outside its options, or another lane
    beats it whichever of its options it holds.

    Two objectives within `tie` of the summed costs they are made of (the
    two lanes' and the current allocation's) are a tie: equal in exact
    arithmetic, and ordered only by the rounding of a float32 cost, so
    either lane is right. Lanes of equal cost have equal objectives at any
    precision, and the shape name still decides between them."""
    low, high = options(d, rates, tol)
    k = low.shape[2]
    rank = np.argsort(np.argsort(fleet["shape_names"]))
    v_lo, c_lo = _keys(fleet, state, d, low)
    v_hi, c_hi = _keys(fleet, state, d, high)
    # each lane's worst key over its options
    hi_worse = (v_hi > v_lo) | ((v_hi == v_lo) & (c_hi > c_lo))
    v_w, c_w = np.where(hi_worse, v_hi, v_lo), np.where(hi_worse, c_hi, c_lo)
    has_lane = d["feasible"].any(axis=1)[None, :]
    none = choice < 0
    off = none & has_lane
    off |= ~none & ~has_lane
    c = np.maximum(choice, 0)
    feas_c = d["feasible"][np.arange(d["feasible"].shape[0])[None, :], c]
    lo_c = np.take_along_axis(low, c[:, :, None], axis=2)[:, :, 0]
    hi_c = np.take_along_axis(high, c[:, :, None], axis=2)[:, :, 0]
    ok_reps = (replicas == lo_c) | (replicas == hi_c)
    off |= ~none & (~feas_c | ~ok_reps)
    r = replicas.astype(np.float64)[:, :, None]
    rep_c = np.zeros_like(low) + r  # the picked lane's replicas on every shape column
    v_p, c_p = _keys(fleet, state, d, rep_c)
    v_p = np.take_along_axis(v_p, c[:, :, None], axis=2)[:, :, 0]
    c_p = np.take_along_axis(c_p, c[:, :, None], axis=2)[:, :, 0]
    r_p = rank[c].astype(float)
    for s in range(k):
        other = d["feasible"][None, :, s] & (c != s) & ~none
        v_o, c_o = v_w[:, :, s], c_w[:, :, s]
        near = np.abs(v_o - v_p) <= tie * (c_o + c_p + state["cur_cost"][None, :])
        beats = (v_o < v_p) & ~near
        beats |= near & (c_o == c_p) & (rank[s] < r_p)
        off |= other & beats
    return int(off.sum())
