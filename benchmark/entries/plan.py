"""The capacity planner's Monte Carlo ensembles, called back to back.

Each call is `replay_montecarlo(system, <scenario>, steps, step_seconds,
seeds, base_seed, backend)` on one `System` of the fleet, as a planner
asks what-if questions of the fleet as it stands: a prep (one full
sizing on the card) and every member's rows folded on the host. Between
calls the fleet's metrics move by the mix's "between_calls" moves (the
cycle traffic's generator), so each prep sizes a fleet it has not seen;
the base seed advances each call, so no two calls replay the same
members.

`correct` compares, for a call drawn from the seed and for the last call
of the window, the kept members' [steps, variants] picks (shape and
replicas) and the total cost of a sample of members drawn from the seed
(the kept ones among them) with the plain reference (`reference/rows.py`)
on the same rows.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import common
from benchmark.entries.cycle import apply, build_spec
from benchmark.inputs import scenarios, traffic
from benchmark.reference import rows as ref_rows
from benchmark.reference import sizing as ref

SPAN_CALL = "replay_montecarlo"


class Bench:
    """One cell of the plan entry: set up by `__init__` + `warm`, one
    timed call a `step`, then `check` against the reference."""

    def __init__(self, config, mix, seed, device, backend, spans):
        import torch

        from inferno_tpu_torch.core.system import System
        from inferno_tpu_torch.parallel import reset_fleet_state

        self.torch = torch
        self.plan = mix["plan"]
        self.between = mix["between_calls"]
        self.compare_members = int(mix["compare_members"])
        self.seed, self.device, self.backend, self.spans = seed, device, backend, spans
        self.warm_calls = int(mix["warm_calls"])
        self.fleet = common.load_generator(config["generator"]).make(config, seed)
        self.state = traffic.initial(self.fleet)
        reset_fleet_state()
        self.system = System(build_spec(self.fleet))
        self.call = 0
        self.window_first = self.warm_calls + 1
        self.sample_at = self.window_first + int(
            np.random.default_rng([int(seed), 2]).integers(0, int(mix["sample_within"])))
        self.captured = {}
        self.profiles = []

    def base_seed(self, call: int) -> int:
        """Call `call`'s base seed: strided past every member of the calls
        before it."""
        return int(self.seed) + call * int(self.plan["seeds"]) * len(scenarios.TABLE)

    def _replay(self):
        from inferno_tpu_torch.planner.montecarlo import replay_montecarlo

        p = self.plan
        keep = (0, int(p["seeds"]) - 1)
        with self.spans.span(SPAN_CALL):
            report = replay_montecarlo(
                self.system, p["scenario"], int(p["steps"]), float(p["step_seconds"]),
                seeds=int(p["seeds"]), base_seed=self.base_seed(self.call),
                backend=self.backend, device=self.device, per_seed=True, keep_seeds=keep,
            )
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()
        return report

    def _next(self):
        """The next call's fleet, outside the timed part."""
        self.call += 1
        moved = traffic.step(self.fleet, self.state, self.between, self.seed, self.call)
        apply(self.system, self.fleet, self.state, moved)

    def warm(self):
        """The cold call and the mix's warm calls: the prep's snapshot,
        plans, kernels and the host fold's buffers are built here."""
        self._replay()
        for _ in range(self.warm_calls):
            self._next()
            self._replay()

    def step(self) -> tuple[float, int]:
        """One timed call: (its host milliseconds, members replayed)."""
        self._next()
        t0 = time.perf_counter()
        report = self._replay()
        ms = (time.perf_counter() - t0) * 1000.0
        self.profiles.append(report["profile"])
        self.captured[self.call] = {
            "kept": report["_kept"], "cost": list(report["per_seed"]["cost_total_usd"]),
            "accelerators": sorted(self.system.accelerators),
        }
        for c in list(self.captured):
            if c not in (self.sample_at, self.call):
                del self.captured[c]
        return ms, int(self.plan["seeds"])

    def finish(self):
        from inferno_tpu_torch.parallel import reset_fleet_state

        self.system = None
        reset_fleet_state()

    def layer_context(self, traced: bool) -> dict:
        """The planner's own profile, ms a call over the window: its prep,
        and its rows (generate, fold, aggregate)."""
        if not self.profiles:
            return {}
        n = len(self.profiles)
        return {
            "plan_prepare_ms": sum(p["prepare_ms"] for p in self.profiles) / n,
            "plan_rows_ms": sum(p["generate_ms"] + p["solve_ms"] + p["aggregate_ms"]
                                for p in self.profiles) / n,
        }

    def check(self, limits, program=None):
        """Each compared number, the worst over the captured calls, beside
        its limit: [(name, value, limit)]. `program` (a torch dtype)
        replaces the program's answers by the reference's at that
        precision (the control)."""
        torch = self.torch
        p = self.plan
        names = self.fleet["shape_names"]
        worst = {"cells_off": 0, "cost_gap": 0.0}
        gen = scenarios.GENERATORS[p["scenario"]]
        steps, step_s, n_members = int(p["steps"]), float(p["step_seconds"]), int(p["seeds"])
        for call, got in sorted(self.captured.items()):
            state = traffic.state_at(self.fleet, self.between, self.seed, call)
            lanes = ref.lanes_of(self.fleet, state)
            d = ref_rows.dense(self.fleet, lanes, ref.size(lanes, torch.float64, self.device))
            d_prog = None
            if program is not None:
                d_prog = ref_rows.dense(self.fleet, lanes, ref.size(lanes, program, self.device))
            seeds = scenarios.member_seeds(p["scenario"], self.base_seed(call), n_members)
            drawn = np.random.default_rng([int(self.seed), 3, call]).choice(
                np.arange(1, n_members - 1), max(self.compare_members - 2, 0), replace=False)
            for m in sorted({0, n_members - 1, *drawn.tolist()}):
                member_seed = seeds[m]
                # the base rates of the call's fleet, as the program reads them
                rates = gen(state["lam"], steps, member_seed)
                want = ref_rows.row_costs(self.fleet, state, d, rates).sum() \
                    / 100.0 * step_s / 3600.0
                if d_prog is None:
                    cost = got["cost"][m]
                else:
                    cost = ref_rows.row_costs(self.fleet, state, d_prog, rates).sum() \
                        / 100.0 * step_s / 3600.0
                gap = abs(cost - want) / abs(want) if want else abs(cost)
                worst["cost_gap"] = max(worst["cost_gap"], gap if np.isfinite(gap) else np.inf)
                kept = got["kept"].get(m) if d_prog is None else None
                if d_prog is not None and m in (0, int(p["seeds"]) - 1):
                    low, _ = ref_rows.options(d_prog, rates, 0.0)
                    shape, reps = ref_rows.pick(self.fleet, state, d_prog, low)
                elif kept is not None:
                    # the program's choice is a rank among the sorted shape names
                    to_shape = np.array([names.index(a) for a in got["accelerators"]])
                    shape = np.where(kept["choice"] >= 0, to_shape[np.maximum(kept["choice"], 0)], -1)
                    reps = kept["replicas"].astype(np.int64)
                else:
                    continue
                off = ref_rows.cells_off(self.fleet, state, d, rates, shape, reps,
                                         limits["boundary"], limits["tie"])
                worst["cells_off"] = max(worst["cells_off"], off)
        return [(k, worst[k], limits[k]) for k in ("cells_off", "cost_gap")]
