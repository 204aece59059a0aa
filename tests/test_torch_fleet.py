"""The port's fleet sizing pass (inferno_tpu_torch.parallel.calculate_fleet
+ solver.solve_unlimited) against the JAX reference.

The fleet is the reference's 200-variant edge fleet (tandem, zero-load,
pinned and infeasible variants). The reference is sized with
`calculate_fleet(System(spec), backend="jax")`, the port with
`calculate_fleet(System(port_spec), backend="torch", device="cpu")`, and
the decision surfaces are compared server by server under the port's
rule: accelerator and feasible candidate sets exactly, replicas exactly
except ±1 on a ceil boundary whose rate_star agrees within 1e-4, cost
and value within 1e-5.
"""

import numpy as np
import pytest
import torch

from inferno_tpu.core import System as RefSystem
from inferno_tpu.parallel import calculate_fleet as ref_calculate_fleet
from inferno_tpu.parallel import reset_fleet_state as ref_reset_fleet_state
from inferno_tpu.solver.solver import solve_unlimited as ref_solve_unlimited
from inferno_tpu.testing.fleet import fleet_system_spec as ref_fleet_system_spec
from inferno_tpu_torch.config.types import OptimizerSpec, SystemSpec
from inferno_tpu_torch.core.system import System
from inferno_tpu_torch.parallel import (
    LaneAllocations,
    build_fleet,
    build_tandem_fleet,
    calculate_fleet,
    reset_fleet_state,
)
from inferno_tpu_torch.parallel import fleet as port_fleet
from inferno_tpu_torch.solver import Solver, solve_unlimited
from inferno_tpu_torch.testing.fleet import (
    assert_same_decisions,
    fleet_system_spec,
    perturb_loads,
)

EDGE = dict(shapes_per_variant=3, tandem_every=5, zero_load_every=7,
            pinned_every=11, infeasible_every=13)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The fleets here are small, and the tests run beside other test
    workers: torch's intra-op threads would only contend with them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_fleet_state():
    reset_fleet_state()
    yield
    reset_fleet_state()


@pytest.fixture(scope="module")
def sized_pair():
    """(reference System, port System), both sized and solved once."""
    ref_spec = ref_fleet_system_spec(200, **EDGE)
    ref_reset_fleet_state()
    ref = RefSystem(ref_spec)
    ref_calculate_fleet(ref, backend="jax")
    ref_solve_unlimited(ref)
    ref_reset_fleet_state()
    reset_fleet_state()
    port = System(SystemSpec.from_dict(ref_spec.to_dict()))
    calculate_fleet(port, backend="torch", device="cpu")
    solve_unlimited(port)
    return ref, port


def test_port_fixture_builds_the_reference_fleet():
    assert (fleet_system_spec(200, **EDGE).to_dict()
            == ref_fleet_system_spec(200, **EDGE).to_dict())


def test_picked_accelerators_match(sized_pair):
    ref, port = sized_pair
    for name, server in ref.servers.items():
        a, b = server.allocation, port.servers[name].allocation
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.accelerator == b.accelerator, name


def test_feasible_candidate_sets_match(sized_pair):
    ref, port = sized_pair
    for name, server in ref.servers.items():
        assert set(server.all_allocations) == set(port.servers[name].all_allocations), name


def test_decision_surface_matches_under_the_boundary_rule(sized_pair):
    """Replicas (±1 on a ceil boundary), cost and value of every candidate,
    and the picks, via the port's one comparison helper."""
    ref, port = sized_pair
    boundary = assert_same_decisions(ref, port)
    assert boundary <= 2  # a ceil boundary is rare; more means drift


def test_edge_variants_are_covered(sized_pair):
    """The fleet exercises every edge lane, and each lands as the
    reference's does."""
    ref, port = sized_pair
    zero = [n for n, s in port.servers.items() if s.load.arrival_rate == 0]
    pinned = [n for n, s in port.servers.items() if s.keep_accelerator]
    infeasible = [n for n, s in port.servers.items()
                  if s.load.arrival_rate > 0 and not len(s.all_allocations)]
    assert zero and pinned and infeasible
    tandem = build_tandem_fleet(port)
    assert tandem is not None and tandem.num_lanes > 0
    for name in zero + pinned + infeasible:
        a, b = ref.servers[name].allocation, port.servers[name].allocation
        assert (a is None) == (b is None), name
        if a is not None:
            assert (a.accelerator, a.num_replicas, a.cost) == (
                b.accelerator, b.num_replicas, b.cost), name
    for name in pinned:
        cur = port.servers[name].cur_allocation.accelerator
        assert set(port.servers[name].all_allocations) <= {cur}, name
    tandem_servers = {s for s, _ in tandem.lanes}
    for name in tandem_servers:
        a, b = ref.servers[name].allocation, port.servers[name].allocation
        if a is not None:
            assert a.accelerator == b.accelerator, name


def test_vectorized_matches_port_scalar_oracle():
    """The port's own scalar f64 loop (System.calculate_all, the copied
    analyzer) against its vectorized path — the reference's
    tests/test_vectorized_sizing.py contract, inside the port."""
    spec = fleet_system_spec(40, **EDGE)
    scalar = System(SystemSpec.from_dict(spec.to_dict()))
    scalar.calculate_all()
    fleet = System(spec)
    calculate_fleet(fleet, backend="torch", device="cpu")
    for name, s_server in scalar.servers.items():
        f_allocs = fleet.servers[name].all_allocations
        assert set(f_allocs) == set(s_server.all_allocations), name
        for acc, s in s_server.all_allocations.items():
            f = f_allocs[acc]
            assert f.batch_size == s.batch_size, (name, acc)
            assert abs(f.num_replicas - s.num_replicas) <= 1, (name, acc)
            assert f.max_arrv_rate_per_replica == pytest.approx(
                s.max_arrv_rate_per_replica, rel=2e-2), (name, acc)
            assert f.cost == pytest.approx(s.cost, rel=2e-2), (name, acc)


def test_snapshot_off_matches_snapshot_on(monkeypatch):
    spec = fleet_system_spec(30, **EDGE)
    on = System(spec)
    calculate_fleet(on, backend="torch", device="cpu")
    solve_unlimited(on)
    reset_fleet_state()
    monkeypatch.setenv("FLEET_SNAPSHOT", "0")
    off = System(SystemSpec.from_dict(spec.to_dict()))
    calculate_fleet(off, backend="torch", device="cpu")
    solve_unlimited(off)
    assert assert_same_decisions(on, off) == 0


def test_unchanged_fleet_replays_and_perturbed_fleet_resolves(monkeypatch):
    # the plan and solve memos belong to the full path; the incremental
    # cycle (the default) replays clean servers on its own
    monkeypatch.setenv("INCREMENTAL_CYCLE", "0")
    system = System(fleet_system_spec(20, **EDGE))
    calculate_fleet(system, backend="torch", device="cpu")
    plan = build_fleet(system)
    results = port_fleet._solve_memo["last"]["results"]
    calculate_fleet(system, backend="torch", device="cpu")
    assert build_fleet(system) is plan
    assert port_fleet._solve_memo["last"]["results"] is results
    perturb_loads(system)
    calculate_fleet(system, backend="torch", device="cpu")
    assert build_fleet(system) is not plan
    assert port_fleet._solve_memo["last"]["results"] is not results


def test_lane_allocations_materialize_lazily():
    system = System(fleet_system_spec(20, **EDGE))
    calculate_fleet(system, backend="torch", device="cpu")
    views = [s.all_allocations for s in system.servers.values()
             if isinstance(s.all_allocations, LaneAllocations)]
    assert views
    src = views[0]._src
    solve_unlimited(system)
    assert src.materialized <= len(system.servers)  # one per server, not per lane


def test_only_subset_keeps_the_rest():
    spec = fleet_system_spec(20, **EDGE)
    full = System(spec)
    calculate_fleet(full, backend="torch", device="cpu")
    subset = {name for i, name in enumerate(full.servers) if i % 3 == 0}
    part = System(SystemSpec.from_dict(spec.to_dict()))
    marker = {"kept": None}
    for name, server in part.servers.items():
        if name not in subset:
            server.all_allocations = marker
    calculate_fleet(part, backend="torch", device="cpu", only=subset)
    for name, server in part.servers.items():
        if name in subset:
            assert set(server.all_allocations) == set(full.servers[name].all_allocations)
        else:
            assert server.all_allocations is marker


def test_bucket_launch_plan():
    """Buckets are 4x-geometric in K from 128 and padded like the
    reference; one launch sequence per bucket; within a bucket the lanes
    run in order of max batch."""
    system = System(fleet_system_spec(60, **EDGE))
    slots = port_fleet.bucket_slots(build_fleet(system), build_tandem_fleet(system))
    assert {kind for kind, *_ in slots} == {"agg", "tan"}
    for kind, k, sub, idx, width, cached in slots:
        assert cached is None  # the full path runs no refold bucket
        assert k in (128, 512, 2048, 8192)
        assert width == port_fleet._pad_lanes(len(idx)) >= len(idx)
        assert len(sub.alpha) == width
        batch = (sub.max_batch if kind == "agg"
                 else np.maximum(sub.prefill_batch, sub.decode_batch))[: len(idx)]
        assert np.all(np.diff(np.asarray(batch)) >= 0)
    for kind in ("agg", "tan"):
        idx = np.concatenate([s[3] for s in slots if s[0] == kind])
        assert np.array_equal(np.sort(idx), np.arange(len(idx)))
    assert [port_fleet._pad_lanes(n) for n in (1, 9, 2048, 2049, 5000)] == [
        8, 16, 2048, 2560, 5120]


def test_cuda_backend_on_cpu_device_raises():
    system = System(fleet_system_spec(5, **EDGE))
    with pytest.raises(ValueError, match="CUDA device"):
        calculate_fleet(system, backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        calculate_fleet(system, backend="jax", device="cpu")


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    system = System(fleet_system_spec(5, **EDGE))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calculate_fleet(system)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calculate_fleet(system, backend="torch")


def test_unlimited_solver_reports_diffs():
    system = System(fleet_system_spec(10, **EDGE))
    calculate_fleet(system, backend="torch", device="cpu")
    solver = Solver(OptimizerSpec(unlimited=True))
    solver.solve(system)
    assert solver.diff_allocation
    for name, diff in solver.diff_allocation.items():
        alloc = system.servers[name].allocation
        assert diff.new_accelerator == (alloc.accelerator if alloc and alloc.accelerator
                                        else "none")
    assert np.isfinite(sum(d.cost_diff for d in solver.diff_allocation.values()))
