"""The sizing cycle of the shipped incremental path, driven back to back.

One `System` is kept across cycles, as the controller keeps its state:
each cycle the traffic moves the fleet's metrics (outside the timed
part, as a scrape would), then `calculate_fleet` sizes what changed and
`Optimizer.optimize(calculate=False)` picks every variant's shape and
replicas. A cycle ends when its decisions are on the host.

`correct` compares, for a cycle drawn from the seed and for the last
cycle of the window, every lane's feasibility, rate a replica and
replicas, and every variant's shape and replicas, with the plain
reference (`reference/sizing.py`) on the same inputs.
"""

from __future__ import annotations

import copy
import time

import numpy as np

from benchmark import common, roofline
from benchmark.inputs import traffic
from benchmark.reference import sizing as ref

SPAN_SIZE = "calculate_fleet"
SPAN_OPTIMIZE = "optimize"
SPAN_PREPARE = "prepare"


def build_spec(fleet: dict):
    """The program's SystemSpec of the fleet's arrays: one model a
    variant, with a profile on each shape offered to it."""
    from inferno_tpu_torch.config import (
        AcceleratorSpec, AllocationData, CapacitySpec, DecodeParms, ModelPerfSpec,
        ModelTarget, OptimizerSpec, PrefillParms, ServerLoadSpec, ServerSpec,
        ServiceClassSpec, SystemSpec,
    )

    names = fleet["shape_names"]
    accelerators = [
        AcceleratorSpec(name=name, cost_per_chip_hr=float(fleet["cost_per_chip"][s]),
                        chips=int(fleet["chips"][s]))
        for s, name in enumerate(names)
    ]
    class_name, priority = fleet["service_class"]
    models, targets, servers = [], [], []
    for i in range(fleet["n"]):
        model = model_name(fleet, i)
        for s in np.flatnonzero(fleet["offered"][i]):
            models.append(ModelPerfSpec(
                name=model, acc=names[s], max_batch_size=int(fleet["max_batch"][i, s]),
                at_tokens=int(fleet["at_tokens"][i, s]),
                decode_parms=DecodeParms(alpha=float(fleet["alpha"][i, s]),
                                         beta=float(fleet["beta"][i, s])),
                prefill_parms=PrefillParms(gamma=float(fleet["gamma"][i, s]),
                                           delta=float(fleet["delta"][i, s])),
            ))
        targets.append(ModelTarget(model=model, slo_itl=float(fleet["slo_itl"][i]),
                                   slo_ttft=float(fleet["slo_ttft"][i])))
        cur = AllocationData(accelerator=names[fleet["cur_rank"][i]],
                             num_replicas=int(fleet["cur_reps"][i]),
                             cost=float(fleet["cur_cost"][i]))
        cur.load = ServerLoadSpec(arrival_rate=float(fleet["lam"][i]),
                                  avg_in_tokens=float(fleet["in_tok"][i]),
                                  avg_out_tokens=float(fleet["out_tok"][i]))
        servers.append(ServerSpec(
            name=server_name(i), class_name=class_name, model=model,
            min_num_replicas=int(fleet["min_replicas"]), current_alloc=cur,
        ))
    return SystemSpec(
        accelerators=accelerators, models=models,
        service_classes=[ServiceClassSpec(name=class_name, priority=priority,
                                          model_targets=targets)],
        servers=servers, optimizer=OptimizerSpec(unlimited=True),
        capacity=CapacitySpec(chips={}),
    )


def model_name(fleet: dict, i: int) -> str:
    """Variant i's model: a fine-tune of its base model, named apart."""
    return f"{fleet['model'][i]}-ft{i:05d}"


def server_name(i: int) -> str:
    return f"fleet/variant-{i:03d}"


def apply(system, fleet: dict, state: dict, moved: dict) -> None:
    """Hand the cycle's moves to the program as a controller would: a
    variant whose load changed is a fresh server object carrying a fresh
    load object."""
    from inferno_tpu_torch.config import ServerLoadSpec

    names = list(system.servers)
    load_moved = np.union1d(moved.get("rate", []), moved.get("tokens", [])).astype(np.int64)
    for i in load_moved:
        server = copy.copy(system.servers[names[i]])
        server.load = ServerLoadSpec(arrival_rate=float(state["lam"][i]),
                                     avg_in_tokens=float(state["in_tok"][i]),
                                     avg_out_tokens=float(state["out_tok"][i]))
        system.servers[names[i]] = server


def answers(system, fleet: dict) -> dict:
    """The program's answers on the host: per (variant, shape) whether a
    candidate exists, its rate a replica (req/s) and replicas; per variant
    the picked shape and replicas (-1: none)."""
    names = fleet["shape_names"]
    index = {name: s for s, name in enumerate(names)}
    n, k = fleet["n"], len(names)
    present = np.zeros((n, k), bool)
    rate = np.full((n, k), np.nan)
    reps = np.full((n, k), -1, np.int64)
    pick = np.full(n, -1, np.int64)
    pick_reps = np.full(n, -1, np.int64)
    for i, server in enumerate(system.servers.values()):
        for acc, alloc in server.all_allocations.items():
            s = index[acc]
            present[i, s] = True
            rate[i, s] = alloc.max_arrv_rate_per_replica * 1000.0
            reps[i, s] = alloc.num_replicas
        chosen = server.allocation
        if chosen is not None and chosen.accelerator:
            pick[i] = index[chosen.accelerator]
            pick_reps[i] = chosen.num_replicas
    return {"present": present, "rate": rate, "reps": reps, "pick": pick, "pick_reps": pick_reps}


def reference_answers(fleet, state, lanes, device, dtype) -> dict:
    """The reference's answers, at precision `dtype`, in the layout of
    `answers`."""
    got = ref.size(lanes, dtype=dtype, device=device)
    n, k = fleet["n"], len(fleet["shape_names"])
    present = np.zeros((n, k), bool)
    rate = np.full((n, k), np.nan)
    reps = np.full((n, k), -1, np.int64)
    var, shp = lanes["var"], lanes["shape"]
    present[var, shp] = got["feasible"]
    rate[var, shp] = got["rate"]
    reps[var, shp] = got["reps"]
    pick, pick_reps = ref.decide(fleet, state, lanes, got["feasible"], got["reps"], got["cost"])
    return {"present": present, "rate": rate, "reps": reps, "pick": pick,
            "pick_reps": pick_reps}


def compare(fleet, state, lanes, want, got, rate_limit) -> dict:
    """The numbers `correct` is decided by, program (`got`) against
    reference (`want`) on one cycle:

    * rate_gap: the largest relative gap of a rate a replica, over lanes
      both sides find feasible with a finite rate;
    * lanes_off: lanes found feasible on one side only, plus lanes whose
      rate is not finite or whose replicas differ other than at a ceil
      boundary (the reference's load / rate within `rate_limit` of a
      whole number);
    * picks_off: variants whose shape or replicas differ from the
      reference's pick made with the program's replicas at those
      boundary lanes."""
    var, shp = lanes["var"], lanes["shape"]
    p_w, p_g = want["present"][var, shp], got["present"][var, shp]
    both = p_w & p_g
    r_w, r_g = want["rate"][var, shp], got["rate"][var, shp]
    with np.errstate(divide="ignore", invalid="ignore"):
        gap = np.abs(r_g - r_w) / np.abs(r_w)
    finite = np.isfinite(gap)
    rate_gap = float(np.max(np.where(both & finite, gap, 0.0), initial=0.0))
    reps_w, reps_g = want["reps"][var, shp], got["reps"][var, shp]
    with np.errstate(divide="ignore", invalid="ignore"):
        x = lanes["total"] / r_w
    near = np.rint(x)
    boundary = ~lanes["zero"] & np.isfinite(x) & (np.abs(x - near) <= rate_limit * x)
    ok_boundary = boundary & ((reps_g == np.maximum(near, 1)) | (reps_g == np.maximum(near + 1, 1)))
    reps_ok = (reps_g == reps_w) | ok_boundary
    in_lanes = np.zeros_like(got["present"])
    in_lanes[var, shp] = True
    extra = int(np.sum(got["present"] & ~in_lanes))  # a candidate on a shape never offered
    lanes_off = int(np.sum(p_w != p_g) + np.sum(both & ~(reps_ok & finite))) + extra
    reps_adj = np.where(both & ok_boundary, reps_g, reps_w)
    cost_adj = reps_adj * lanes["cost_per_replica"]
    pick, pick_reps = ref.decide(fleet, state, lanes, p_w, reps_adj, cost_adj)
    picks_off = int(np.sum((pick != got["pick"]) | (pick_reps != got["pick_reps"])))
    return {"rate_gap": rate_gap, "lanes_off": lanes_off, "picks_off": picks_off}


class Bench:
    """One cell of the cycle entry: set up by `__init__` + `warm`, one
    timed cycle a `step`, then `check` against the reference."""

    def __init__(self, config, mix, seed, device, backend, spans):
        import torch

        from inferno_tpu_torch.core.system import System
        from inferno_tpu_torch.parallel import reset_fleet_state

        self.torch = torch
        self.mix, self.seed = mix["cycle"], seed
        self.warm_cycles = int(mix["warm_cycles"])
        self.device, self.backend = device, backend
        self.spans = spans
        self.fleet = common.load_generator(config["generator"]).make(config, seed)
        self.state = traffic.initial(self.fleet)
        self.spec = build_spec(self.fleet)
        reset_fleet_state()
        self.system = System(self.spec)
        self.cycle_index = 0
        self.sample_at = self.warm_cycles + 1 + int(
            np.random.default_rng([int(seed), 1]).integers(0, int(mix["sample_within"])))
        self.captured = {}
        self.window_first = self.warm_cycles + 1
        self.launches = []  # the kernels' launch counters as the window opens and closes

    def _run_cycle(self):
        from inferno_tpu_torch.parallel import calculate_fleet
        from inferno_tpu_torch.solver import Optimizer

        with self.spans.span(SPAN_SIZE):
            calculate_fleet(self.system, backend=self.backend, device=self.device)
        with self.spans.span(SPAN_OPTIMIZE):
            Optimizer(self.spec.optimizer).optimize(self.system, calculate=False)
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def warm(self):
        """The cold cycle on the fleet as generated, then the mix's warm
        cycles: every plan memo, snapshot table and kernel the window's
        cycles use is built here."""
        self._run_cycle()
        for _ in range(self.warm_cycles):
            self.prepare()
            self._run_cycle()
        self.launches.append(self._launch_counts())

    def _launch_counts(self):
        """(stats_kernel, bisect_kernel) launches so far in this process;
        None off the card, where the kernels never run."""
        if self.device.type != "cuda":
            return None
        from inferno_tpu_torch.ops import cuda_queueing

        return cuda_queueing.LAUNCHES, cuda_queueing.BISECT_LAUNCHES

    def prepare(self):
        """The next cycle's inputs, outside the timed part."""
        self.cycle_index += 1
        with self.spans.span(SPAN_PREPARE):
            moved = traffic.step(self.fleet, self.state, self.mix, self.seed, self.cycle_index)
            apply(self.system, self.fleet, self.state, moved)

    def step(self) -> tuple[float, int]:
        """One timed cycle: (its host milliseconds, 1 cycle done)."""
        self.prepare()
        t0 = time.perf_counter()
        self._run_cycle()
        ms = (time.perf_counter() - t0) * 1000.0
        if self.cycle_index == self.sample_at:
            self.captured[self.cycle_index] = answers(self.system, self.fleet)
        return ms, 1

    def finish(self):
        """Close the window: take the last cycle's answers and free the
        program's state."""
        from inferno_tpu_torch.parallel import reset_fleet_state

        self.captured[self.cycle_index] = answers(self.system, self.fleet)
        self.launches.append(self._launch_counts())
        self.system = None
        reset_fleet_state()

    def check(self, limits, program=None):
        """Each compared number, the worst over the captured cycles, beside
        its limit: [(name, value, limit)]. `program` (a torch dtype)
        replaces the program's answers by the reference's at that
        precision (the control)."""
        torch = self.torch
        worst = {}
        for cycle in sorted(self.captured):
            state = traffic.state_at(self.fleet, self.mix, self.seed, cycle)
            lanes = ref.lanes_of(self.fleet, state)
            want = reference_answers(self.fleet, state, lanes, self.device, torch.float64)
            got = self.captured[cycle] if program is None else reference_answers(
                self.fleet, state, lanes, self.device, program)
            numbers = compare(self.fleet, state, lanes, want, got, limits["rate_gap"])
            for k, v in numbers.items():
                worst[k] = max(worst.get(k, 0), v)
        return [(k, worst[k], limits[k]) for k in ("rate_gap", "lanes_off", "picks_off")]

    def layer_context(self, traced: bool) -> dict:
        """What the per-layer readers need of this entry: with a trace, the
        least device seconds of the window's cycles (`roofline`) and, on
        the card, each kernel's launches a cycle."""
        if not traced:
            return {}
        ctx = {"sizing_bound_s": self.bound_s(self.window_first, self.cycle_index)}
        cycles = self.cycle_index - self.warm_cycles
        opened, closed = self.launches
        if opened is not None and cycles > 0:
            ctx["stats_kernel_launches"] = (closed[0] - opened[0]) / cycles
            ctx["bisect_kernel_launches"] = (closed[1] - opened[1]) / cycles
        return ctx

    def bound_s(self, first: int, last: int) -> float:
        """The least device seconds for cycles first..last: each cycle's
        changed lanes, found by content against the cycle before."""
        prev = traffic.state_at(self.fleet, self.mix, self.seed, first - 1)
        total = 0.0
        for c in range(first, last + 1):
            state = {k: v.copy() for k, v in prev.items()}
            traffic.step(self.fleet, state, self.mix, self.seed, c)
            lanes = ref.lanes_of(self.fleet, state)
            var = lanes["var"]
            tokens = (state["in_tok"] != prev["in_tok"]) | (state["out_tok"] != prev["out_tok"])
            rate = state["lam"] != prev["lam"]
            sized = None
            if tokens[var].any():
                sized = ref.size(lanes, dtype=self.torch.float64, device=self.device)
            total += roofline.cycle_bound_s(lanes, sized, tokens[var], rate[var])
            prev = state
        return total
