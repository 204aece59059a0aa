"""A fleet of variants served with measured profiles, drawn from a seed.

A configuration names the pool's slice shapes (price a chip-hour, chips),
the models with their measured profiles on those shapes, one service
class, and the fleet's scale and load ranges. Variant i is a fine-tune of
model i mod len(models), served with that model's profiles, so every seed
has the same lanes; the seed draws the loads and current allocations.
Nothing here imports the program: the harness builds the program's inputs
from these arrays, and the reference reads the arrays themselves.
"""

from __future__ import annotations

import numpy as np

PROFILE_KEYS = ("maxBatchSize", "atTokens", "alpha", "beta", "gamma", "delta")


def make(config: dict, seed: int) -> dict:
    """The fleet of `config` (a configuration file's keys) for `seed`:
    a dict of numpy arrays over variants ([n]) and over variants by shape
    ([n, shapes]; `offered` marks the lanes a profile exists for), plus
    the catalog and the SLOs."""
    n = int(config["variants"])
    shapes = config["shapes"]
    names = [s[0] for s in shapes]
    models = config["models"]
    k = len(shapes)

    # [models, shapes] tables of the profiles, NaN where none is offered
    table = {key: np.full((len(models), k), np.nan) for key in PROFILE_KEYS}
    for m, model in enumerate(models):
        for acc, prof in model["profiles"].items():
            for key in PROFILE_KEYS:
                table[key][m, names.index(acc)] = float(prof[key])
    model_of = np.arange(n) % len(models)
    offered = ~np.isnan(table["alpha"][model_of])

    rng = np.random.default_rng(seed)
    idle = (np.arange(n) % config["idle_every"]) == config["idle_every"] - 1
    load = config["load"]
    lam = np.where(idle, 0.0, rng.uniform(*load["rate_per_min"], n))
    in_tok = rng.integers(*load["in_tokens"], n).astype(np.float64)
    out_tok = rng.integers(*load["out_tokens"], n).astype(np.float64)
    # the current shape: one the variant's model has a profile for
    u = rng.random(n)
    n_offered = offered.sum(axis=1)
    nth = np.minimum((u * n_offered).astype(np.int64), n_offered - 1)
    cur_rank = np.argmax(np.cumsum(offered, axis=1) > nth[:, None], axis=1)
    cur_reps = rng.integers(*config["current_replicas"], n)

    cost_per_chip = np.array([s[1] for s in shapes], np.float64)
    chips = np.array([s[2] for s in shapes], np.int64)
    sc = config["service_class"]
    return {
        "n": n,
        "shape_names": names,
        "cost_per_chip": cost_per_chip,
        "chips": chips,
        "service_class": (sc["name"], int(sc["priority"])),
        "model": [models[m]["name"] for m in model_of],
        "offered": offered,
        "slo_itl": np.full(n, float(sc["slo_tpot_ms"])),
        "slo_ttft": np.full(n, float(sc["slo_ttft_ms"])),
        "max_batch": np.nan_to_num(table["maxBatchSize"][model_of]).astype(np.int64),
        "at_tokens": np.nan_to_num(table["atTokens"][model_of]).astype(np.int64),
        "alpha": table["alpha"][model_of],
        "beta": table["beta"][model_of],
        "gamma": table["gamma"][model_of],
        "delta": table["delta"][model_of],
        "lam": lam,  # requests/min
        "in_tok": in_tok,
        "out_tok": out_tok,
        "cur_reps": cur_reps.astype(np.int64),
        "cur_cost": cur_reps * cost_per_chip[cur_rank] * chips[cur_rank],
        "cur_rank": cur_rank.astype(np.int64),
        "min_replicas": 1,
    }
