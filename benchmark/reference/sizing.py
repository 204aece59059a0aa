"""The plain reference of the sizing cycle: every (variant, shape) lane
sized against its SLOs by a birth-death queueing model, and every
variant's shape and replicas picked, in plain PyTorch at any precision.

It follows the model's definition (the upstream analyzer: a state-
dependent batch server, mu(n) = n / t(min(n, N)), occupancy capped at
K = N + 10 N, TTFT at the 95th percentile of an exponential wait), not
the program: every head state is summed explicitly, the queue tail by
its geometric series, and each bisection runs 64 halvings with no early
exit. It reads the fleet's arrays (`inputs/profile_fleet.py`) and a
cycle's state (`inputs/traffic.py`), and imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

RATE_EPSILON = 1e-3  # the stable rate range is (eps mu(1), (1 - eps) mu(N))
QUEUE_TO_BATCH = 10
SLO_MARGIN = -math.log(1.0 - 0.95)  # the TTFT wait at its 95th percentile
FEASIBLE_SLACK = 1e-6  # a target within this share of the metric at lam_min is met
PENALTY = 0.1  # share of both costs charged for a change of shape
BISECT_STEPS = 64
BLOCK_ELEMENTS = 1 << 22  # lanes x head states solved at once
INDEX_KEYS = ("var", "shape", "zero")  # lane columns that stay numpy


def lanes_of(fleet: dict, state: dict) -> dict:
    """Every lane the cycle sizes, as float64 numpy columns: one per
    (variant, shape its model has a profile for). Zero-load variants get
    closed-form lanes (`zero` True)."""
    var, shp = np.nonzero(fleet["offered"])
    out = state["out_tok"][var]
    mbs = fleet["max_batch"][var, shp].astype(np.float64)
    loaded = state["lam"][var] > 0
    # the decode batch scales with the output length the profile was taken at
    batch = np.where(loaded, np.maximum(np.floor(mbs * fleet["at_tokens"][var, shp] / out), 1.0),
                     mbs)
    return {
        "var": var, "shape": shp, "zero": ~loaded,
        "alpha": fleet["alpha"][var, shp], "beta": fleet["beta"][var, shp],
        "gamma": fleet["gamma"][var, shp], "delta": fleet["delta"][var, shp],
        "in_tok": state["in_tok"][var], "out_tok": out, "batch": batch,
        "slo_ttft": fleet["slo_ttft"][var], "slo_itl": fleet["slo_itl"][var],
        "total": state["lam"][var] / 60.0,  # req/s
        "cost_per_replica": fleet["cost_per_chip"][shp] * fleet["chips"][shp],
    }


class Stage:
    """One batch server: service time t(n) = base + slope n for n <= N,
    occupancy capped at `cap` >= N; the head states' log-weights are
    precomputed, since they do not depend on the arrival rate."""

    def __init__(self, base, slope, nmax, cap):
        self.n = nmax
        width = int(nmax.max().item())
        k = torch.arange(1, width + 1, dtype=base.dtype, device=base.device)[None, :]
        self.valid = k <= nmax[:, None]
        log_mu = torch.log(k) - torch.log(base[:, None] + slope[:, None] * k)
        self.cum = torch.cumsum(torch.where(self.valid, log_mu, 0.0), dim=1)
        self.k = k
        self.log_mu_full = torch.log(nmax) - torch.log(base + slope * nmax)
        self.tail = cap - nmax  # queue states past N, served at mu(N)

    def solve(self, lam):
        """(wait, serv, in_servers, throughput) at arrival rates `lam`
        (req/ms) from the stationary distribution."""
        log_lam = torch.log(lam)
        logp = torch.where(self.valid, self.k * log_lam[:, None] - self.cum, -math.inf)
        head_n = torch.where(self.k == self.n[:, None], logp, -math.inf).amax(dim=1)
        m = torch.clamp(logp.amax(dim=1), min=0.0)
        w = torch.exp(logp - m[:, None])
        w0 = torch.exp(-m)
        wn = torch.exp(head_n - m)
        q = torch.exp(log_lam - self.log_mu_full)
        big_l = self.tail
        q_l = torch.exp(big_l * torch.log(q))
        one_q = 1.0 - q
        s0 = q * (1.0 - q_l) / one_q  # sum_{j=1..L} q^j
        s1 = q * (1.0 - (big_l + 1.0) * q_l + big_l * q_l * q) / (one_q * one_q)  # sum j q^j
        z = w0 + w.sum(dim=1) + wn * s0
        in_servers = ((self.k * w).sum(dim=1) + self.n * wn * s0) / z
        queue = wn * s1 / z
        p_block = torch.where(big_l > 0, wn * q_l, wn) / z
        tput = lam * (1.0 - p_block)
        return queue / tput, in_servers / tput, in_servers, tput


def _concurrency(serv, base, slope, nmax):
    """The concurrency n at which t(n) = base + slope n equals `serv`."""
    n = torch.clamp((serv - base) / torch.where(slope > 0, slope, 1.0), min=0.0)
    n = torch.minimum(n, nmax)
    return torch.where(slope > 0, n, torch.where(serv > base, nmax, 0.0))


class _Agg:
    def __init__(self, c):
        self.c = c
        in_tok, out = c["in_tok"], c["out_tok"]
        self.nd = torch.where((in_tok == 0) & (out == 1), 1.0, out - 1.0)
        pre = in_tok > 0
        base = torch.where(pre, c["gamma"], 0.0) + self.nd * c["alpha"]
        slope = torch.where(pre, c["delta"] * in_tok, 0.0) + self.nd * c["beta"]
        self.stage = Stage(base, slope, c["batch"], c["batch"] * (1 + QUEUE_TO_BATCH))
        one = torch.ones_like(base)
        mu1 = one / (base + slope)
        mun = c["batch"] / (base + slope * c["batch"])
        self.lam_min, self.lam_max = mu1 * RATE_EPSILON, mun * (1.0 - RATE_EPSILON)

    def metrics(self, lam, margin):
        c = self.c
        wait, serv, _, tput = self.stage.solve(lam)
        tok = c["out_tok"] - 1.0
        conc = _concurrency(serv, c["gamma"] + c["alpha"] * tok,
                            c["delta"] * c["in_tok"] + c["beta"] * tok, c["batch"])
        prefill = torch.where(c["in_tok"] > 0, c["gamma"] + c["delta"] * c["in_tok"] * conc, 0.0)
        return margin * wait + prefill, c["alpha"] + c["beta"] * conc, tput


def _bisect(model, target, which, margin):
    """The largest rate in [lam_min, lam_max] at which metric `which`
    (0 TTFT, 1 ITL), increasing in the rate, stays at `target`:
    (rate, feasible, clamped)."""
    y_lo = model.metrics(model.lam_min, margin)[which]
    y_hi = model.metrics(model.lam_max, margin)[which]
    feasible = target >= y_lo * (1.0 - FEASIBLE_SLACK)
    clamped = target >= y_hi
    lo, hi = model.lam_min, model.lam_max
    for _ in range(BISECT_STEPS):
        mid = 0.5 * (lo + hi)
        high = model.metrics(mid, margin)[which] > target
        lo, hi = torch.where(high, lo, mid), torch.where(high, mid, hi)
    lam = torch.where(clamped, model.lam_max, 0.5 * (lo + hi))
    lam = torch.where(feasible, lam, model.lam_min)
    return lam, feasible, clamped


def _size_block(c):
    model = _Agg(c)
    lam_t, ok_t, clamp_t = _bisect(model, c["slo_ttft"], 0, SLO_MARGIN)
    lam_i, ok_i, clamp_i = _bisect(model, c["slo_itl"], 1, 1.0)
    lam = torch.minimum(lam_t, lam_i)
    rate = model.metrics(lam, 1.0)[2] * 1000.0  # req/s a replica
    return {
        "feasible": ok_t & ok_i, "rate": rate,
        "lam_ttft": lam_t, "lam_itl": lam_i, "lam_min": model.lam_min,
        "lam_max": model.lam_max, "fixed_ttft": ~ok_t | clamp_t, "fixed_itl": ~ok_i | clamp_i,
    }


def _zero_rate(lanes):
    """req/s a replica of a zero-load lane: the closed-form bound at the
    profile's own max batch (one token a stage)."""
    b = lanes["batch"]
    return b / (lanes["gamma"] + lanes["delta"] + lanes["alpha"] + lanes["beta"] * b) * 1000.0


def size(lanes: dict, dtype=torch.float64, device="cpu") -> dict:
    """Size every lane at precision `dtype` on `device`: numpy columns
    "feasible", "rate" (req/s a replica), "reps", "cost", and for loaded
    lanes the two bisections' rates ("lam_ttft", "lam_itl", req/ms), their
    ranges and whether each ends without a search ("fixed_*")."""
    n = len(lanes["var"])
    out = {
        "feasible": np.ones(n, bool), "rate": _zero_rate(lanes),
        "lam_ttft": np.zeros(n), "lam_itl": np.zeros(n), "lam_min": np.zeros(n),
        "lam_max": np.zeros(n), "fixed_ttft": np.ones(n, bool), "fixed_itl": np.ones(n, bool),
    }
    rows = np.flatnonzero(~lanes["zero"])
    rows = rows[np.argsort(lanes["batch"][rows], kind="stable")]
    start = 0
    while start < len(rows):
        stop = start + 1
        while stop < len(rows) and (stop - start + 1) * lanes["batch"][rows[stop]] <= BLOCK_ELEMENTS:
            stop += 1
        block = rows[start:stop]
        c = {k: torch.as_tensor(np.asarray(v[block], np.float64), device=device).to(dtype)
             for k, v in lanes.items() if k not in INDEX_KEYS}
        got = _size_block(c)
        for k, v in got.items():
            out[k][block] = v.double().cpu().numpy() if v.dtype != torch.bool else v.cpu().numpy()
        start = stop
    rate = out["rate"]
    loaded = ~lanes["zero"]
    with np.errstate(divide="ignore", invalid="ignore"):
        reps = np.where(loaded, np.ceil(lanes["total"] / rate), 1.0)
    reps = np.where(np.isfinite(reps), np.maximum(reps, 1.0), -1.0).astype(np.int64)
    out["reps"] = reps
    out["cost"] = reps * lanes["cost_per_replica"]
    return out


def penalty(cur_rank, cur_reps, cur_cost, rank, reps, cost):
    """The objective of moving from the current allocation to a lane:
    the cost change, plus a share of both costs when the shape changes."""
    same = rank == cur_rank
    return np.where(same & (reps == cur_reps), 0.0,
                    np.where(same, cost - cur_cost, PENALTY * (cur_cost + cost) + (cost - cur_cost)))


def decide(fleet: dict, state: dict, lanes: dict, feasible, reps, cost):
    """Each variant's pick among its feasible lanes: the least
    (objective, cost, shape name). Returns (shape index, replicas) per
    variant, -1 where no lane is feasible."""
    names = fleet["shape_names"]
    name_rank = np.argsort(np.argsort(names))  # shape index -> rank by name
    var, shp = lanes["var"], lanes["shape"]
    value = penalty(fleet["cur_rank"][var], state["cur_reps"][var], state["cur_cost"][var],
                    shp, reps, cost)
    fe = np.flatnonzero(feasible)
    order = np.lexsort((name_rank[shp[fe]], cost[fe], value[fe], var[fe]))
    rows = fe[order]
    first = np.r_[True, var[rows][1:] != var[rows][:-1]]
    pick_shape = np.full(fleet["n"], -1, np.int64)
    pick_reps = np.full(fleet["n"], -1, np.int64)
    pick_shape[var[rows[first]]] = shp[rows[first]]
    pick_reps[var[rows[first]]] = reps[rows[first]]
    return pick_shape, pick_reps
