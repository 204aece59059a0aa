"""The plain reference of the reconcile cycle's decisions: what the
controller's rules write for one cycle's Prometheus table, in plain numpy
and PyTorch at any precision.

The rules, as the upstream controller states them:

* each variant's lanes come from the rows it reported (its arrival rate
  and average input and output tokens);
* with KEEP_ACCELERATOR the pick is restricted to the current shape's
  lane, which `sizing.py` sizes against the variant's SLOs;
* replicas are the ceiling of the rate over the rate a replica can
  carry, and at least 1;
* an infeasible lane gives 1 replica with the OptimizationReady
  condition false;
* an idle variant (no arrivals) gets the closed-form zero lane.

It reads the fleet's arrays (`inputs/profile_fleet.py`) and the table the
cycle was served, and imports nothing of the program. Nothing here
multiplies matrices, so TF32 cannot enter, as in `sizing.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import sizing as ref


def pinned(fleet: dict) -> dict:
    """The fleet with each variant offered only its current shape, as
    KEEP_ACCELERATOR pins it."""
    offered = np.zeros_like(fleet["offered"])
    offered[np.arange(fleet["n"]), fleet["cur_rank"]] = True
    return {**fleet, "offered": offered}


def decide(fleet: dict, table: dict, dtype=torch.float64, device="cpu") -> dict:
    """The decisions the rules give for `table` (per variant: "rps"
    req/s, "in_tok", "out_tok"): per variant numpy arrays "shape" (the
    shape index written), "replicas", "ready" (the OptimizationReady
    condition), "rate" (req/s a replica of the lane) and "total" (req/s)."""
    state = {"lam": table["rps"] * 60.0, "in_tok": table["in_tok"], "out_tok": table["out_tok"]}
    with np.errstate(divide="ignore"):  # an idle variant reports no tokens
        lanes = ref.lanes_of(pinned(fleet), state)
    lanes["total"] = table["rps"][lanes["var"]]
    got = ref.size(lanes, dtype=dtype, device=device)
    n = fleet["n"]
    shape = np.full(n, -1, np.int64)
    replicas = np.ones(n, np.int64)
    ready = np.zeros(n, bool)
    rate = np.full(n, np.nan)
    var = lanes["var"]
    shape[var] = lanes["shape"]
    feasible = got["feasible"] & (got["reps"] >= 1)
    replicas[var] = np.where(feasible, got["reps"], 1)
    ready[var] = feasible
    rate[var] = got["rate"]
    return {"shape": shape, "replicas": replicas, "ready": ready, "rate": rate,
            "total": table["rps"].astype(np.float64), "zero": table["rps"] <= 0}


def compare(want: dict, got: dict, rate_limit: float) -> dict:
    """The numbers `correct` is decided by, the program's written cycle
    (`got`: per variant "written", "shape", "replicas", "ready", "rate"
    req/s a replica from its decision record, "gauge" replicas and
    "gauge_shape", -1 where none) against the reference's (`want`):

    * rate_gap: the worst relative gap of a rate a replica, over variants
      whose lane both sides find feasible;
    * decisions_off: variants whose written shape, replicas or condition
      differ; replicas either side of a ceil boundary (the reference's
      load over rate within `rate_limit` of a whole number) count as right;
    * gauges_off: variants whose desired-replicas gauge differs from their
      written status, in replicas or in shape;
    * unwritten: variants with no status written in the cycle."""
    both = want["ready"] & got["ready"]
    with np.errstate(divide="ignore", invalid="ignore"):
        gap = np.abs(got["rate"] - want["rate"]) / np.abs(want["rate"])
    finite = np.isfinite(gap)
    rate_gap = float(np.max(np.where(both & finite, gap, 0.0), initial=0.0))
    rate_gap = max(rate_gap, float(np.any(both & ~finite)))
    with np.errstate(divide="ignore", invalid="ignore"):
        x = want["total"] / want["rate"]
    near = np.rint(x)
    boundary = ~want["zero"] & np.isfinite(x) & (np.abs(x - near) <= rate_limit * x)
    reps_ok = (got["replicas"] == want["replicas"]) | (
        boundary & want["ready"] & ((got["replicas"] == np.maximum(near, 1))
                                    | (got["replicas"] == np.maximum(near + 1, 1))))
    # an infeasible lane writes no shape of its own: the one written before stands
    shape_ok = (got["shape"] == want["shape"]) | ~want["ready"]
    ok = shape_ok & reps_ok & (got["ready"] == want["ready"])
    decisions_off = int(np.sum(~ok))
    gauges_off = int(np.sum((got["gauge"] != got["replicas"])
                            | (got["gauge_shape"] != got["shape"])))
    unwritten = int(np.sum(~got["written"]))
    return {"rate_gap": rate_gap, "decisions_off": decisions_off,
            "gauges_off": gauges_off, "unwritten": unwritten}


def as_written(want: dict) -> dict:
    """The reference's decisions in the layout of a written cycle: every
    status written, each gauge equal to it (the control's program)."""
    return {"written": np.ones(len(want["shape"]), bool), "shape": want["shape"],
            "replicas": want["replicas"], "ready": want["ready"], "rate": want["rate"],
            "gauge": want["replicas"], "gauge_shape": want["shape"]}
