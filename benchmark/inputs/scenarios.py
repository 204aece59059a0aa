"""The capacity planner's traffic scenarios as plain data: a frozen copy
of the program's `planner.scenarios` flash-crowd generator and its
ensemble seed rule, so that the reference rebuilds every row the program
replays without reading anything the program made.

A member of an ensemble of one scenario draws the seed
`base + offset + k * stride`, where `offset` is the scenario's position
in the program's table of generators and `stride` the table's size.
"""

from __future__ import annotations

import numpy as np

# the program's table of scenario generators, in its order
TABLE = ("diurnal", "ramp", "flash_crowd", "launch", "regional_skew")


def member_seeds(name: str, base_seed: int, count: int) -> list[int]:
    offset = TABLE.index(name)
    return [base_seed + offset + k * len(TABLE) for k in range(count)]


def flash_crowd(base: np.ndarray, steps: int, seed: int, bursts: int = 3,
                magnitude=(3.0, 8.0), width_steps=(1, 3), fraction: float = 0.2) -> np.ndarray:
    """[steps, variants] arrival rates (req/min): the base rates, with
    `bursts` flash crowds each multiplying a random `fraction` of the
    variants by U(`magnitude`) for `width_steps` steps."""
    rng = np.random.default_rng(seed)
    mult = np.ones((steps, len(base)), np.float64)
    n_hit = max(1, int(round(fraction * len(base))))
    for _ in range(max(bursts, 0)):
        if steps == 0:
            break
        t0 = int(rng.integers(0, steps))
        width = int(rng.integers(width_steps[0], width_steps[1] + 1))
        mag = float(rng.uniform(*magnitude))
        hit = rng.choice(len(base), size=n_hit, replace=False)
        mult[t0:t0 + width, hit] *= mag
    return np.maximum(base[None, :] * mult, 0.0)


GENERATORS = {"flash_crowd": flash_crowd}
