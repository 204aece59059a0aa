"""Port of tests/test_solver_greedy_deep.py, on the port's imports.

Deep greedy/limited-mode solver tests.

Named equivalents of the behaviors covered by the reference's most
heavily tested file (the upstream Go project's pkg/solver/greedy_test.go, ~1.7k
LoC): brute-force cross-checks on small instances, re-insertion ordering
when pools exhaust, delayed vs per-priority best-effort, all four
saturation policies, the round-robin ticket loop, and scaled-allocation
proportionality.

Two styles:
* crafted fleets with hand-set candidate allocations driving
  `solve_greedy` directly — deterministic, exact expectations;
* randomized fleets checked against a brute-force enumerator for
  invariants that must hold on every instance.
"""

import itertools
import math

import numpy as np
import pytest

from inferno_tpu_torch.config.types import (
    AcceleratorSpec,
    AllocationData,
    CapacitySpec,
    DecodeParms,
    ModelPerfSpec,
    ModelTarget,
    OptimizerSpec,
    PrefillParms,
    ServerLoadSpec,
    ServerSpec,
    ServiceClassSpec,
    SystemSpec,
)
from inferno_tpu_torch.core import System
from inferno_tpu_torch.core.allocation import Allocation
from inferno_tpu_torch.solver.greedy import solve_greedy as port_solve_greedy

MODEL = "m/deep"

# shapes used by the crafted fleets: (name, chips, pool)
SHAPES = [("v5e-4", 4, "v5e"), ("v5e-8", 8, "v5e"), ("v5p-8", 8, "v5p")]


def _spec(servers, capacity, policy="None", delayed=False):
    return SystemSpec(
        accelerators=[AcceleratorSpec(name=n, cost_per_chip_hr=1.0) for n, _, _ in SHAPES],
        models=[
            ModelPerfSpec(
                name=MODEL, acc=n, max_batch_size=16, at_tokens=128,
                decode_parms=DecodeParms(10.0, 0.2),
                prefill_parms=PrefillParms(3.0, 0.01),
            )
            for n, _, _ in SHAPES
        ],
        service_classes=[
            ServiceClassSpec(name="Premium", priority=1,
                             model_targets=[ModelTarget(model=MODEL, slo_itl=60.0)]),
            ServiceClassSpec(name="Standard", priority=5,
                             model_targets=[ModelTarget(model=MODEL, slo_itl=120.0)]),
            ServiceClassSpec(name="Free", priority=10,
                             model_targets=[ModelTarget(model=MODEL, slo_itl=240.0)]),
        ],
        servers=servers,
        optimizer=OptimizerSpec(
            unlimited=False, saturation_policy=policy, delayed_best_effort=delayed
        ),
        capacity=CapacitySpec(chips=capacity),
    )


def _server(name, class_name="Premium"):
    return ServerSpec(
        name=name, class_name=class_name, model=MODEL, min_num_replicas=1,
        current_alloc=AllocationData(load=ServerLoadSpec(
            arrival_rate=600.0, avg_in_tokens=128, avg_out_tokens=64)),
    )


def _alloc(acc, replicas, value, cost=None):
    a = Allocation(
        accelerator=acc, num_replicas=replicas, batch_size=16,
        cost=value if cost is None else cost, max_arrv_rate_per_replica=0.01,
    )
    a.value = value
    return a


def _system(server_candidates, capacity, policy="None", delayed=False):
    """Build a System whose servers have exactly the given hand-set
    candidate lists: {server_spec: {acc: (replicas, value)}}."""
    spec = _spec([s for s, _ in server_candidates], capacity, policy, delayed)
    system = System(spec)
    for srv, cands in server_candidates:
        server = system.servers[srv.name]
        server.all_allocations = {
            acc: _alloc(acc, reps, val) for acc, (reps, val) in cands.items()
        }
    system.candidates_calculated = True
    _BUILT[id(system)] = (system, spec, server_candidates)
    return system, spec


# every System `_system` built, with its candidate lists, so that
# `solve_greedy` below can run the reference's greedy on the same input
_BUILT: dict = {}


def _reference_system(spec, server_candidates):
    """The reference's System with the same hand-set candidate lists."""
    from inferno_tpu.config.types import SystemSpec as RefSystemSpec
    from inferno_tpu.core import System as RefSystem
    from inferno_tpu.core.allocation import Allocation as RefAllocation

    ref = RefSystem(RefSystemSpec.from_dict(spec.to_dict()))
    for srv, cands in server_candidates:
        allocs = {}
        for acc, (reps, val) in cands.items():
            a = RefAllocation(accelerator=acc, num_replicas=reps, batch_size=16, cost=val,
                              max_arrv_rate_per_replica=0.01)
            a.value = val
            allocs[acc] = a
        ref.servers[srv.name].all_allocations = allocs
    ref.candidates_calculated = True
    return ref


def solve_greedy(system, optimizer_spec):
    """The port's greedy, then the reference's on the same candidates:
    every server's allocation equal, field for field."""
    from inferno_tpu.config.types import OptimizerSpec as RefOptimizerSpec
    from inferno_tpu.solver.greedy import solve_greedy as ref_solve_greedy

    out = port_solve_greedy(system, optimizer_spec)
    _, spec, server_candidates = _BUILT[id(system)]
    ref = _reference_system(spec, server_candidates)
    ref_solve_greedy(ref, RefOptimizerSpec.from_dict(optimizer_spec.to_dict()))
    assert {n: repr(s.allocation) for n, s in system.servers.items()} == {
        n: repr(s.allocation) for n, s in ref.servers.items()}
    return out


def _chips(acc):
    return dict((n, c) for n, c, _ in SHAPES)[acc]


def _pool(acc):
    return dict((n, p) for n, c, p in SHAPES)[acc]


def _used_chips(system):
    used = {}
    for server in system.servers.values():
        a = server.allocation
        if a is None or not a.accelerator:
            continue
        used[_pool(a.accelerator)] = (
            used.get(_pool(a.accelerator), 0) + a.num_replicas * _chips(a.accelerator)
        )
    return used


# -- re-insertion ordering (reference allocate: greedy.go:107-166) -----------


def test_reinsertion_falls_back_to_next_candidate():
    """First-choice pool exhausted: the server advances to its next-best
    candidate (other pool) and gets it, full-size."""
    srv = _server("s1")
    system, spec = _system(
        [(srv, {"v5e-4": (4, 10.0), "v5p-8": (2, 30.0)})],
        capacity={"v5e": 8, "v5p": 16},  # first choice needs 16 v5e chips
    )
    solve_greedy(system, spec.optimizer)
    a = system.servers["s1"].allocation
    assert a is not None and a.accelerator == "v5p-8"
    assert a.num_replicas == 2 and a.value == 30.0  # unscaled


def test_reinsertion_ordering_regret_first():
    """Same priority: the server with the larger regret (value gap to its
    next-best) allocates first, so when both want the same scarce pool the
    high-regret server wins it and the low-regret one takes its cheap
    fallback."""
    high_regret = _server("high", "Premium")
    low_regret = _server("low", "Premium")
    system, spec = _system(
        [
            # regret 90: fallback is painful
            (high_regret, {"v5e-4": (2, 10.0), "v5p-8": (1, 100.0)}),
            # regret 2: fallback is nearly as good
            (low_regret, {"v5e-4": (2, 10.0), "v5p-8": (1, 12.0)}),
        ],
        capacity={"v5e": 8, "v5p": 8},  # v5e fits only ONE server's 2x4 chips
    )
    solve_greedy(system, spec.optimizer)
    high = system.servers["high"].allocation
    low = system.servers["low"].allocation
    assert high is not None and high.accelerator == "v5e-4"
    assert low is not None and low.accelerator == "v5p-8"
    assert low.value == 12.0


def test_reinsertion_updates_delta_and_order():
    """A displaced server re-inserts by its NEW regret: after losing its
    first choice its remaining regret is tiny, so a third server with
    bigger regret allocates ahead of it and takes the contested pool."""
    a = _server("a", "Premium")
    b = _server("b", "Premium")
    system, spec = _system(
        [
            # a: candidates v5e(cheap), v5p(12), then nothing
            (a, {"v5e-4": (3, 10.0), "v5p-8": (1, 12.0)}),
            # b: only v5p, big value => delta inf, but processed after a's
            # displacement only if ordering is recomputed
            (b, {"v5p-8": (1, 50.0)}),
        ],
        capacity={"v5e": 4, "v5p": 8},  # a's v5e choice (12 chips) can't fit
    )
    solve_greedy(system, spec.optimizer)
    # b (delta=inf) must keep priority over displaced a (new delta=inf but
    # lower value ordering): v5p has 8 chips => only one of them fits
    b_alloc = system.servers["b"].allocation
    a_alloc = system.servers["a"].allocation
    assert (b_alloc is None) != (a_alloc is None), "exactly one fits v5p"
    assert _used_chips(system).get("v5p", 0) == 8


# -- delayed vs per-priority-group best-effort (greedy.go:62-104) ------------


def test_delayed_best_effort_lets_lower_priority_slo_pass_run_first():
    """delayed=False runs best-effort per priority group, so a saturated
    Premium server's scaled-down allocation consumes the chips a Free
    server's full SLO allocation needed. delayed=True defers ALL
    best-effort until every priority's SLO pass ran, so the Free server
    gets its full allocation and Premium scales into the remainder."""
    prem = _server("prem", "Premium")
    free = _server("free", "Free")
    candidates = [
        (prem, {"v5e-4": (10, 100.0)}),  # needs 40 chips; only 24 exist
        (free, {"v5e-4": (2, 20.0)}),  # needs 8 chips
    ]

    sys_eager, spec_eager = _system(
        candidates, {"v5e": 24}, policy="PriorityExhaustive", delayed=False
    )
    solve_greedy(sys_eager, spec_eager.optimizer)
    assert sys_eager.servers["prem"].allocation.num_replicas == 6  # 24 chips
    assert sys_eager.servers["free"].allocation is None  # starved

    sys_delay, spec_delay = _system(
        candidates, {"v5e": 24}, policy="PriorityExhaustive", delayed=True
    )
    solve_greedy(sys_delay, spec_delay.optimizer)
    assert sys_delay.servers["free"].allocation.num_replicas == 2  # full SLO
    assert sys_delay.servers["prem"].allocation.num_replicas == 4  # remainder


# -- saturation policies (greedy.go:169-316) ---------------------------------


def _scarce_three():
    p1 = _server("p1", "Premium")
    p2 = _server("p2", "Premium")
    f1 = _server("f1", "Free")
    return [
        (p1, {"v5e-4": (4, 40.0)}),
        (p2, {"v5e-4": (4, 44.0)}),
        (f1, {"v5e-4": (4, 4.0)}),
    ]


def test_policy_none_leaves_all_unallocated():
    system, spec = _system(_scarce_three(), {"v5e": 12}, policy="None")
    solve_greedy(system, spec.optimizer)
    assert all(s.allocation is None for s in system.servers.values())


def test_policy_priority_exhaustive_order_and_scaling():
    """Priority asc, then value DESC within a priority (the reference's
    orderFunc, greedy.go:76-85): p2 (value 44) is processed before p1 (40)
    and exhausts the pool (12 chips = 3 of its 4 replicas), scaled
    proportionally; the rest get nothing."""
    system, spec = _system(_scarce_three(), {"v5e": 12}, policy="PriorityExhaustive")
    solve_greedy(system, spec.optimizer)
    p2 = system.servers["p2"].allocation
    assert p2 is not None and p2.num_replicas == 3
    assert p2.cost == pytest.approx(44.0 * 3 / 4)
    assert p2.value == pytest.approx(44.0 * 3 / 4)
    assert system.servers["p1"].allocation is None
    assert system.servers["f1"].allocation is None


def test_policy_priority_round_robin_shares_within_group():
    """The Premium group shares 12 chips round-robin; the extra third
    replica goes to the first-ordered entry (p2: higher value). The Free
    group's best-effort sees an empty pool."""
    system, spec = _system(_scarce_three(), {"v5e": 12}, policy="PriorityRoundRobin")
    solve_greedy(system, spec.optimizer)
    p1 = system.servers["p1"].allocation
    p2 = system.servers["p2"].allocation
    assert p1 is not None and p2 is not None
    assert p2.num_replicas == 2 and p1.num_replicas == 1
    assert p2.cost == pytest.approx(44.0 * 2 / 4)
    assert system.servers["f1"].allocation is None


def test_policy_round_robin_shares_across_priorities_when_delayed():
    """Plain RoundRobin shares across priorities only in delayed mode
    (otherwise best-effort still runs per priority group, reference
    SolveGreedy:62-104): all three then get one replica each."""
    system, spec = _system(
        _scarce_three(), {"v5e": 12}, policy="RoundRobin", delayed=True
    )
    solve_greedy(system, spec.optimizer)
    for name in ("p1", "p2", "f1"):
        a = system.servers[name].allocation
        assert a is not None and a.num_replicas == 1, name


def test_policy_round_robin_undelayed_stays_within_group():
    """Without delayed mode, RoundRobin's sharing is confined to each
    priority group: Premium consumes everything, Free is starved."""
    system, spec = _system(_scarce_three(), {"v5e": 12}, policy="RoundRobin")
    solve_greedy(system, spec.optimizer)
    p1 = system.servers["p1"].allocation
    p2 = system.servers["p2"].allocation
    assert p2.num_replicas == 2 and p1.num_replicas == 1
    assert system.servers["f1"].allocation is None


# -- the ticket loop (allocateEqually, greedy.go:239-316) --------------------


def test_ticket_loop_uneven_demand():
    """Round-robin one replica at a time: a server stops claiming once its
    full demand is met; the rest flows to still-hungry servers."""
    small = _server("small", "Premium")
    big = _server("big", "Premium")
    system, spec = _system(
        [(small, {"v5e-4": (2, 10.0)}), (big, {"v5e-4": (10, 11.0)})],
        {"v5e": 24},  # 6 replicas total
        policy="RoundRobin",
    )
    solve_greedy(system, spec.optimizer)
    assert system.servers["small"].allocation.num_replicas == 2  # capped at demand
    assert system.servers["big"].allocation.num_replicas == 4  # the rest


def test_ticket_loop_pool_exhaustion_mid_round():
    """Odd capacity: the last replica goes to the first entry in order
    (value desc => b at 11.0 precedes a at 10.0), never overshooting."""
    a = _server("a", "Premium")
    b = _server("b", "Premium")
    system, spec = _system(
        [(a, {"v5e-4": (5, 10.0)}), (b, {"v5e-4": (5, 11.0)})],
        {"v5e": 12},  # 3 replicas for 2 hungry servers
        policy="RoundRobin",
    )
    solve_greedy(system, spec.optimizer)
    assert system.servers["b"].allocation.num_replicas == 2
    assert system.servers["a"].allocation.num_replicas == 1
    assert _used_chips(system)["v5e"] == 12


def test_ticket_loop_falls_back_to_feasible_candidate():
    """A ticket activates on the first candidate whose pool has room for
    at least one replica — not necessarily the min-value candidate."""
    srv = _server("s", "Premium")
    system, spec = _system(
        [(srv, {"v5e-4": (4, 10.0), "v5p-8": (2, 30.0)})],
        {"v5e": 0, "v5p": 8},
        policy="RoundRobin",
    )
    solve_greedy(system, spec.optimizer)
    a = system.servers["s"].allocation
    assert a is not None and a.accelerator == "v5p-8"
    assert a.num_replicas == 1  # one replica fits (8 chips)
    assert a.cost == pytest.approx(30.0 / 2)


# -- brute-force cross-checks on randomized small instances ------------------


def _random_instance(rng):
    """2-4 servers, hand-random candidate lists, small capacities."""
    classes = ["Premium", "Standard", "Free"]
    servers = []
    for i in range(int(rng.integers(2, 5))):
        srv = _server(f"s{i}", classes[int(rng.integers(0, 3))])
        cands = {}
        for acc, _, _ in SHAPES:
            if rng.random() < 0.7:
                cands[acc] = (int(rng.integers(1, 5)), float(rng.integers(1, 100)))
        if cands:
            servers.append((srv, cands))
    capacity = {
        "v5e": int(rng.integers(0, 40)),
        "v5p": int(rng.integers(0, 40)),
    }
    return servers, capacity


def _brute_force_feasible_sets(servers, capacity):
    """All feasible assignments: per server, one full candidate or None."""
    names = [s.name for s, _ in servers]
    options = []
    for _, cands in servers:
        opts = [None] + [
            (acc, reps, val) for acc, (reps, val) in sorted(cands.items())
        ]
        options.append(opts)
    for combo in itertools.product(*options):
        used = {}
        ok = True
        for choice in combo:
            if choice is None:
                continue
            acc, reps, _ = choice
            used[_pool(acc)] = used.get(_pool(acc), 0) + reps * _chips(acc)
        for pool, u in used.items():
            if u > capacity.get(pool, 0):
                ok = False
                break
        if ok:
            yield dict(zip(names, combo))


@pytest.mark.parametrize("seed", range(12))
def test_greedy_vs_brute_force_invariants(seed):
    """Invariants checked against full enumeration (policy None):
    1. greedy's assignment is one of the brute-force feasible ones;
    2. allocated servers get an unscaled candidate, verbatim;
    3. maximality: no unallocated server has ANY candidate that fits the
       remaining capacity (the SLO pass only drops a server after every
       candidate failed, and capacity never grows back);
    4. when the all-min-value assignment is feasible, greedy picks exactly
       each server's min-value candidate (= the unlimited solution)."""
    rng = np.random.default_rng(seed)
    servers, capacity = _random_instance(rng)
    system, spec = _system(servers, capacity, policy="None")
    solve_greedy(system, spec.optimizer)

    assignment = {}
    for srv, cands in servers:
        a = system.servers[srv.name].allocation
        if a is None:
            assignment[srv.name] = None
        else:
            assert a.accelerator in cands, "allocation not among candidates"
            reps, val = cands[a.accelerator]
            assert (a.num_replicas, a.value) == (reps, val), "scaled under policy None"
            assignment[srv.name] = (a.accelerator, a.num_replicas, a.value)

    feasible = list(_brute_force_feasible_sets(servers, capacity))
    assert assignment in feasible, "greedy produced an infeasible assignment"

    remaining = dict(capacity)
    for pool, used in _used_chips(system).items():
        remaining[pool] -= used
    for srv, cands in servers:
        if assignment[srv.name] is not None:
            continue
        for acc, (reps, _) in cands.items():
            assert reps * _chips(acc) > remaining.get(_pool(acc), 0), (
                f"{srv.name} left unallocated but its {acc} candidate fits"
            )

    all_min = {}
    for srv, cands in servers:
        acc, (reps, val) = min(cands.items(), key=lambda kv: kv[1][1])
        all_min[srv.name] = (acc, reps, val)
    if all_min in feasible:
        assert assignment == all_min, "ample capacity must reproduce unlimited"


@pytest.mark.parametrize("seed", range(6))
def test_greedy_priority_dominance_vs_brute_force(seed):
    """If brute force shows a feasible assignment serving every Premium
    server, greedy (policy None) must not leave any Premium server
    unallocated while any lower-priority server IS allocated with a
    candidate Premium could have used (chips in the same pool)."""
    rng = np.random.default_rng(1000 + seed)
    servers, capacity = _random_instance(rng)
    system, spec = _system(servers, capacity, policy="None")
    solve_greedy(system, spec.optimizer)

    prio = {s.name: {"Premium": 1, "Standard": 5, "Free": 10}[s.class_name]
            for s, _ in servers}
    starved_high = [
        (s, cands) for s, cands in servers
        if system.servers[s.name].allocation is None
    ]
    for s, cands in starved_high:
        for other, _ in servers:
            o_alloc = system.servers[other.name].allocation
            if o_alloc is None or prio[other.name] <= prio[s.name]:
                continue
            # the lower-priority allocation's pool had to be useless to s:
            # s's candidates in that pool exceed pool capacity even before
            # anyone consumed it? No — only the weaker invariant holds: s
            # was processed first and failed on the then-remaining
            # capacity, which the later allocation only shrank further. So
            # assert s's candidates in that pool don't fit the pool's
            # TOTAL capacity minus higher-priority usage.
            pool = _pool(o_alloc.accelerator)
            higher_used = sum(
                a.num_replicas * _chips(a.accelerator)
                for n2, a in (
                    (n, system.servers[n].allocation) for n in system.servers
                )
                if a is not None and prio[n2] <= prio[s.name]
                and _pool(a.accelerator) == pool
            )
            for acc, (reps, _) in cands.items():
                if _pool(acc) != pool:
                    continue
                assert reps * _chips(acc) > capacity.get(pool, 0) - higher_used, (
                    f"{s.name} (prio {prio[s.name]}) starved while "
                    f"{other.name} (prio {prio[other.name]}) took {pool}"
                )
