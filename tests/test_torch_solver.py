"""Port of tests/test_solver.py, on the port's imports.

Solver tests: unlimited mode, greedy with capacity, priorities, and
saturation policies.

Mirrors the strategy of the reference's most heavily tested file
(the upstream Go project's pkg/solver/greedy_test.go).
"""

import pytest

from inferno_tpu_torch.core import System
from inferno_tpu_torch.solver import Optimizer, optimize

from test_torch_core import assert_solves_as_reference, make_server, make_system_spec


def _sized_system(spec):
    system = System(spec)
    system.calculate_all()
    return system


def test_unlimited_picks_min_value():
    spec = make_system_spec()
    system = _sized_system(spec)
    result = optimize(system, spec.optimizer)
    name = spec.servers[0].name
    server = system.servers[name]
    assert server.allocation is not None
    vals = {a.value for a in server.all_allocations.values()}
    assert server.allocation.value == min(vals)
    assert name in result.solution
    assert result.solution[name].num_replicas == server.allocation.num_replicas
    assert result.solution_time_msec >= 0.0
    assert_solves_as_reference(spec, system)


def test_unlimited_multiple_servers_independent():
    servers = [
        make_server(name="ns/premium", class_name="Premium", arrival_rate=600.0),
        make_server(name="ns/freemium", class_name="Freemium", arrival_rate=600.0),
    ]
    spec = make_system_spec(servers)
    system = _sized_system(spec)
    result = optimize(system, spec.optimizer)
    assert set(result.solution) == {"ns/premium", "ns/freemium"}
    # Freemium's looser SLOs can never need more replicas than Premium
    assert (
        result.solution["ns/freemium"].num_replicas
        <= result.solution["ns/premium"].num_replicas
    )
    assert_solves_as_reference(spec, system)


def test_greedy_respects_capacity():
    # heavy load so v5e-4 needs many slices; v5e pool too small for first
    # choice forces fallback or best-effort
    servers = [make_server(arrival_rate=6000.0)]
    spec = make_system_spec(
        servers, unlimited=False, capacity={"v5e": 8, "v5p": 1024}
    )
    system = _sized_system(spec)
    optimize(system, spec.optimizer)
    server = system.servers[servers[0].name]
    assert server.allocation is not None
    # chips consumed must fit within capacity
    usage = system.allocate_by_pool()
    for pool, u in usage.items():
        assert u.chips <= spec.capacity.chips.get(pool, 0)
    assert_solves_as_reference(spec, system)


def test_greedy_priority_order_under_scarcity():
    # capacity only fits one server's allocation: Premium (prio 1) wins
    servers = [
        make_server(name="ns/freemium", class_name="Freemium", arrival_rate=1200.0),
        make_server(name="ns/premium", class_name="Premium", arrival_rate=1200.0),
    ]
    spec = make_system_spec(
        servers, unlimited=False, capacity={"v5e": 4, "v5p": 0}
    )
    system = _sized_system(spec)
    optimize(system, spec.optimizer)
    premium = system.servers["ns/premium"]
    freemium = system.servers["ns/freemium"]
    if premium.allocation is None:
        # even premium alone may not fit in 4 chips; at minimum freemium
        # must not have displaced it
        assert freemium.allocation is None
    else:
        assert premium.allocation.accelerator == "v5e-4"
    assert_solves_as_reference(spec, system)


def test_greedy_saturation_none_leaves_unallocated():
    servers = [make_server(arrival_rate=60000.0)]
    spec = make_system_spec(
        servers, unlimited=False, capacity={"v5e": 4, "v5p": 4}, saturation_policy="None"
    )
    system = _sized_system(spec)
    optimize(system, spec.optimizer)
    assert system.servers[servers[0].name].allocation is None
    assert_solves_as_reference(spec, system)


def test_greedy_saturation_priority_exhaustive_scales_down():
    servers = [make_server(arrival_rate=60000.0)]
    spec = make_system_spec(
        servers,
        unlimited=False,
        capacity={"v5e": 8, "v5p": 0},
        saturation_policy="PriorityExhaustive",
    )
    system = _sized_system(spec)
    optimize(system, spec.optimizer)
    server = system.servers[servers[0].name]
    assert server.allocation is not None
    full = server.all_allocations[server.allocation.accelerator]
    assert server.allocation.num_replicas < full.num_replicas
    assert server.allocation.num_replicas >= 1
    # cost scaled proportionally
    expected = full.cost * server.allocation.num_replicas / full.num_replicas
    assert server.allocation.cost == pytest.approx(expected, rel=1e-6)
    assert_solves_as_reference(spec, system)


def test_greedy_saturation_round_robin_shares():
    servers = [
        make_server(name="ns/a", class_name="Premium", arrival_rate=30000.0),
        make_server(name="ns/b", class_name="Premium", arrival_rate=30000.0),
    ]
    spec = make_system_spec(
        servers,
        unlimited=False,
        capacity={"v5e": 16, "v5p": 0},
        saturation_policy="RoundRobin",
    )
    system = _sized_system(spec)
    optimize(system, spec.optimizer)
    a = system.servers["ns/a"].allocation
    b = system.servers["ns/b"].allocation
    assert a is not None and b is not None
    # round-robin: replica counts differ by at most 1
    assert abs(a.num_replicas - b.num_replicas) <= 1
    usage = system.allocate_by_pool()
    assert usage["v5e"].chips <= 16
    assert_solves_as_reference(spec, system)


def test_diffs_reported():
    spec = make_system_spec()
    system = _sized_system(spec)
    opt = Optimizer(spec.optimizer)
    result = opt.optimize(system, calculate=False)
    name = spec.servers[0].name
    assert name in result.diffs
    d = result.diffs[name]
    assert d.old_accelerator == "none"
    assert d.new_num_replicas >= 1
    assert_solves_as_reference(spec, system)


def test_greedy_unknown_policy_behaves_as_none():
    servers = [make_server(arrival_rate=60000.0)]
    spec = make_system_spec(
        servers,
        unlimited=False,
        capacity={"v5e": 4, "v5p": 4},
        saturation_policy="priorityExhaustive",  # wrong case: not a valid enum
    )
    system = _sized_system(spec)
    optimize(system, spec.optimizer)  # must not raise
    assert system.servers[servers[0].name].allocation is None
    assert_solves_as_reference(spec, system)
