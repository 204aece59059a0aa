"""The one generator of cycle traffic: how a fleet's metrics move from
one reconcile cycle to the next, read from a mix's parameters.

A mix (`traffic/<mix>.json`, key "cycle") names two moves, each
optional:

* "rate": {"fraction": f, "scale": [lo, hi]}: a share f of the loaded
  variants get the arrival rate base x U(lo, hi);
* "tokens": {"fraction": f, "spread": s}: a share f of the loaded
  variants get average input and output tokens base x U(1 - s, 1 + s),
  rounded to whole tokens (at least 1).

Cycle c >= 1 draws its moves from `default_rng([seed, c])`, so the
inputs of a cycle depend on the seed and its index alone, whatever ran
before, and every seed makes the same amount of work.
"""

from __future__ import annotations

import numpy as np

STATE_KEYS = ("lam", "in_tok", "out_tok", "cur_reps", "cur_cost")


def initial(fleet: dict) -> dict:
    """The state of cycle 0: the fleet's own loads and allocations."""
    return {k: np.array(fleet[k], copy=True) for k in STATE_KEYS}


def step(fleet: dict, state: dict, mix: dict, seed: int, cycle: int) -> dict:
    """Apply cycle `cycle`'s moves to `state` in place. Returns the
    variants each move touched: {"rate", "tokens"} -> index
    arrays (sorted, possibly empty)."""
    rng = np.random.default_rng([int(seed), int(cycle)])
    loaded = np.flatnonzero(fleet["lam"] > 0)
    moved = {}

    def pick(pool, fraction):
        k = int(round(len(pool) * float(fraction)))
        if k >= len(pool):
            return pool.copy()
        return np.sort(rng.choice(pool, max(k, 1), replace=False))

    rate = mix.get("rate")
    if rate:
        who = pick(loaded, rate["fraction"])
        lo, hi = rate["scale"]
        state["lam"][who] = fleet["lam"][who] * rng.uniform(lo, hi, len(who))
        moved["rate"] = who
    tokens = mix.get("tokens")
    if tokens:
        who = pick(loaded, tokens["fraction"])
        s = float(tokens["spread"])
        for key in ("in_tok", "out_tok"):
            drawn = fleet[key][who] * rng.uniform(1.0 - s, 1.0 + s, len(who))
            state[key][who] = np.maximum(np.rint(drawn), 1.0)
        moved["tokens"] = who
    return moved


def state_at(fleet: dict, mix: dict, seed: int, cycle: int) -> dict:
    """The state after cycles 1..`cycle` (0: the fleet as generated)."""
    state = initial(fleet)
    for c in range(1, cycle + 1):
        step(fleet, state, mix, seed, c)
    return state
