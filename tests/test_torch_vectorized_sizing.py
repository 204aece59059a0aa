"""Port of tests/test_vectorized_sizing.py, on the port's imports: the
whole-fleet vectorized sizing on backend "torch" on the CPU.

The scalar per-variant loop (`System.calculate_all`) is the parity
oracle; the vectorized pipeline (columnar snapshot packing -> one solve
-> lazy `LaneAllocations` writeback -> per-server argmin) must agree with
it on every edge lane: zero-load shortcut, infeasible targets, pinned
shapes, tandem (disagg) lanes, and `only=`-restricted cache-replay
subsets. The reference's expectations stay as they are. Where the
reference computes the same case, the port's sized System is also held
to the reference's (`calculate_fleet(backend="jax")`) under
`testing.fleet.assert_same_decisions`: picks and feasible candidate sets
exactly, replicas exactly except ±1 on a ceil boundary whose rate_star
agrees within 1e-4, cost and value within 1e-5.
tests/test_torch_fleet.py carries the reference file's first case,
`test_vectorized_matches_scalar_over_edge_fleet`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from inferno_tpu.core import System as RefSystem
from inferno_tpu.parallel import calculate_fleet as ref_calculate_fleet
from inferno_tpu.parallel import reset_fleet_state as ref_reset_fleet_state
from inferno_tpu.solver.solver import solve_unlimited as ref_solve_unlimited
from inferno_tpu.config.types import SystemSpec as RefSystemSpec
from inferno_tpu_torch.config.types import SystemSpec
from inferno_tpu_torch.core.system import System
from inferno_tpu_torch.parallel import (
    LaneAllocations,
    build_fleet,
    build_tandem_fleet,
    calculate_fleet,
    reset_fleet_state,
)
from inferno_tpu_torch.solver.solver import solve_unlimited
from inferno_tpu_torch.testing.fleet import (
    assert_same_decisions,
    fleet_system_spec,
    perturb_loads,
)

CPU = dict(backend="torch", device="cpu")
NO_EDGES = dict(tandem_every=0, zero_load_every=0, pinned_every=0, infeasible_every=0)


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
    """The snapshot/plan/solve memos are module-level by design (they
    persist across production cycles); tests must not leak them."""
    reset_fleet_state()
    yield
    reset_fleet_state()


def _copy(spec: SystemSpec) -> SystemSpec:
    return SystemSpec.from_dict(spec.to_dict())


def _reference_solved(spec: SystemSpec):
    """The reference's System on the same spec, sized on backend jax and
    solved (its memos reset around it)."""
    ref_reset_fleet_state()
    ref = RefSystem(RefSystemSpec.from_dict(spec.to_dict()))
    ref_calculate_fleet(ref, backend="jax")
    ref_solve_unlimited(ref)
    ref_reset_fleet_state()
    return ref


def _assert_allocations_match(scalar: System, fleet: System) -> None:
    for name, s_server in scalar.servers.items():
        f_server = fleet.servers[name]
        assert set(f_server.all_allocations) == set(s_server.all_allocations), name
        for acc, s_alloc in s_server.all_allocations.items():
            f_alloc = f_server.all_allocations[acc]
            assert f_alloc.batch_size == s_alloc.batch_size, (name, acc)
            assert abs(f_alloc.num_replicas - s_alloc.num_replicas) <= 1, (name, acc)
            assert f_alloc.max_arrv_rate_per_replica == pytest.approx(
                s_alloc.max_arrv_rate_per_replica, rel=2e-2
            ), (name, acc)
            assert f_alloc.cost == pytest.approx(s_alloc.cost, rel=2e-2), (name, acc)


def test_solver_pick_matches_scalar():
    spec = fleet_system_spec(30, shapes_per_variant=3)
    scalar, fleet = System(_copy(spec)), System(_copy(spec))
    scalar.calculate_all()
    calculate_fleet(fleet, **CPU)
    solve_unlimited(scalar)
    solve_unlimited(fleet)
    for name in scalar.servers:
        s_alloc = scalar.servers[name].allocation
        f_alloc = fleet.servers[name].allocation
        assert (s_alloc is None) == (f_alloc is None), name
        if s_alloc is not None:
            assert f_alloc.accelerator == s_alloc.accelerator, name
            assert abs(f_alloc.num_replicas - s_alloc.num_replicas) <= 1, name
    assert_same_decisions(_reference_solved(spec), fleet)


def test_snapshot_off_matches_snapshot_on(monkeypatch):
    """FLEET_SNAPSHOT=0 (the legacy per-lane walk) and the columnar
    snapshot must pack bit-identical plans and produce equal candidate
    sets — the snapshot is a faster packer, never a different one."""
    spec = fleet_system_spec(25, shapes_per_variant=2)

    on = System(_copy(spec))
    plan_on = build_fleet(on)
    tan_on = build_tandem_fleet(on)
    calculate_fleet(on, **CPU)

    reset_fleet_state()
    monkeypatch.setenv("FLEET_SNAPSHOT", "0")
    off = System(_copy(spec))
    plan_off = build_fleet(off)
    tan_off = build_tandem_fleet(off)
    calculate_fleet(off, **CPU)

    assert plan_on.lanes == plan_off.lanes
    for a, b in zip(plan_on.params, plan_off.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tan_on.lanes == tan_off.lanes
    for a, b in zip(tan_on.params, tan_off.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for name in on.servers:
        a, b = on.servers[name].all_allocations, off.servers[name].all_allocations
        assert set(a) == set(b), name
        for acc in a:
            assert a[acc].num_replicas == b[acc].num_replicas, (name, acc)
            assert a[acc].value == b[acc].value, (name, acc)


def test_only_subset_replays_the_rest():
    """`only=` restricts sizing to a server subset (the sizing cache
    replays the rest): subset servers get fresh candidates, the others
    keep whatever they carried."""
    spec = fleet_system_spec(12, shapes_per_variant=2)
    system = System(spec)
    calculate_fleet(system, **CPU)
    full = {
        name: dict(server.all_allocations)
        for name, server in system.servers.items()
    }
    subset = set(list(system.servers)[:4])
    sentinel = object()
    for name, server in system.servers.items():
        if name not in subset:
            server.all_allocations = {"sentinel": sentinel}
    calculate_fleet(system, only=subset, **CPU)
    for name, server in system.servers.items():
        if name in subset:
            assert set(server.all_allocations) == set(full[name]), name
            for acc in full[name]:
                assert (
                    server.all_allocations[acc].num_replicas
                    == full[name][acc].num_replicas
                ), (name, acc)
        else:
            assert server.all_allocations.get("sentinel") is sentinel, name


def test_unchanged_fleet_replays_the_same_plan_object():
    """The snapshot memo key is a version counter: an unchanged fleet is
    an O(1) check that replays the previous cycle's plan OBJECT (which
    the downstream solve memo's identity check relies on)."""
    spec = fleet_system_spec(10)
    system = System(spec)
    p1 = build_fleet(system)
    p2 = build_fleet(system)
    assert p1 is p2
    # a content-identical NEW System replays too (same signatures)
    other = System(spec)
    assert build_fleet(other) is p1


def test_one_lane_load_mutation_invalidates():
    spec = fleet_system_spec(10)
    system = System(spec)
    p1 = build_fleet(system)
    name = p1.lanes[0][0]
    system.servers[name].load.arrival_rate *= 1.5
    p2 = build_fleet(system)
    assert p2 is not p1
    lane_rows = [i for i, (s, _) in enumerate(p2.lanes) if s == name]
    old_rate = np.asarray(p1.params.total_rate)[lane_rows[0]]
    new_rate = np.asarray(p2.params.total_rate)[lane_rows[0]]
    assert new_rate == pytest.approx(old_rate * 1.5, rel=1e-6)
    # unrelated lanes kept their columns bit-for-bit
    other_rows = [i for i, (s, _) in enumerate(p2.lanes) if s != name]
    np.testing.assert_array_equal(
        np.asarray(p1.params.total_rate)[other_rows],
        np.asarray(p2.params.total_rate)[other_rows],
    )


def test_one_server_structure_mutation_invalidates():
    """A structural change (one model's SLO target, arriving on the next
    cycle's freshly built System — the reconciler rebuilds the System
    from spec every cycle) must invalidate the plan memo and flow into
    that server's columns."""
    spec = fleet_system_spec(10)
    system = System(spec)
    p1 = build_fleet(system)
    name = p1.lanes[0][0]
    model = system.servers[name].model_name
    spec2 = fleet_system_spec(10)
    sc = spec2.service_classes[0]
    sc.model_targets = [
        dataclasses.replace(t, slo_itl=t.slo_itl * 2.0) if t.model == model else t
        for t in sc.model_targets
    ]
    p2 = build_fleet(System(spec2))
    assert p2 is not p1
    row = [i for i, (s, _) in enumerate(p2.lanes) if s == name][0]
    assert np.asarray(p2.params.target_itl)[row] == pytest.approx(
        np.asarray(p1.params.target_itl)[row] * 2.0
    )


def test_structure_swap_with_equal_mask_regression():
    """Regression (caught by fuzz parity): two fleets whose eligibility
    masks are bit-identical but whose lane->accelerator mapping differs
    (same catalog, reversed candidate order) must not replay the previous
    fleet's lane list — sizing fleet A then fleet B must match B's scalar
    oracle exactly, accelerator names included."""
    from test_torch_core import make_system_spec

    spec_a = make_system_spec()
    spec_b = dataclasses.replace(
        spec_a, accelerators=list(reversed(spec_a.accelerators))
    )
    a = System(_copy(spec_a))
    calculate_fleet(a, **CPU)
    b = System(_copy(spec_b))
    calculate_fleet(b, **CPU)
    oracle = System(_copy(spec_b))
    oracle.calculate_all()
    _assert_allocations_match(oracle, b)


def test_tie_break_is_deterministic_both_orders():
    """Equal-value candidates must resolve by (value, cost, accelerator
    name) — NOT dict insertion order — in both the scalar fallback loop
    and the vectorized argmin."""
    from inferno_tpu_torch.core.allocation import Allocation

    a = Allocation(accelerator="v5e-4", num_replicas=2, batch_size=8,
                   cost=40.0, value=44.0)
    b = Allocation(accelerator="v5e-16", num_replicas=1, batch_size=16,
                   cost=40.0, value=44.0)
    spec = fleet_system_spec(1, shapes_per_variant=1, **NO_EDGES)
    for order in ((a, b), (b, a)):
        system = System(spec)
        server = next(iter(system.servers.values()))
        server.all_allocations = {x.accelerator: x for x in order}
        solve_unlimited(system)
        assert server.allocation is b, order  # "v5e-16" < "v5e-4"


def test_vectorized_argmin_breaks_ties_like_scalar():
    """Two identically-priced identically-profiled shapes produce
    equal-value candidates; the vectorized pick must equal the scalar
    path's deterministic pick on every server."""
    spec = fleet_system_spec(10, shapes_per_variant=3, **NO_EDGES)
    # clone v5e-8's economics onto v5e-16 (both differ from the current
    # "v5e-4" shape, so both candidates carry the same accel-change
    # penalty): equal slice cost + identical parms => equal-value pair
    donor_acc, clone_acc = "v5e-8", "v5e-16"
    by_name = {a.name: a for a in spec.accelerators}
    by_name[clone_acc].cost_per_chip_hr = (
        by_name[donor_acc].cost_per_chip_hr * by_name[donor_acc].chips
    ) / by_name[clone_acc].chips
    donors = {m.name: m for m in spec.models if m.acc == donor_acc}
    for m in spec.models:
        if m.acc == clone_acc:
            d = donors[m.name]
            m.max_batch_size = d.max_batch_size
            m.at_tokens = d.at_tokens
            m.decode_parms = d.decode_parms
            m.prefill_parms = d.prefill_parms
    scalar, fleet = System(_copy(spec)), System(_copy(spec))
    scalar.calculate_all()
    calculate_fleet(fleet, **CPU)
    solve_unlimited(scalar)
    solve_unlimited(fleet)
    ties = 0
    for name, s in scalar.servers.items():
        pair = [s.all_allocations.get(donor_acc), s.all_allocations.get(clone_acc)]
        if all(pair) and pair[0].value == pair[1].value:
            ties += 1
        f_alloc = fleet.servers[name].allocation
        assert f_alloc is not None and s.allocation is not None, name
        assert f_alloc.accelerator == s.allocation.accelerator, name
    assert ties > 0  # the fixture really manufactured equal-value pairs
    ref = _reference_solved(spec)
    for name, server in ref.servers.items():
        assert server.allocation.accelerator == fleet.servers[name].allocation.accelerator


def test_lane_allocations_materialize_lazily():
    """The solver path materializes exactly one Allocation per laned
    server; a full-dict access materializes the rest transparently."""
    spec = fleet_system_spec(10, shapes_per_variant=3, **NO_EDGES)
    system = System(spec)
    calculate_fleet(system, **CPU)
    solve_unlimited(system)
    server = next(iter(system.servers.values()))
    allocs = server.all_allocations
    assert isinstance(allocs, LaneAllocations)
    # raw dict storage: only the solver's winner has been materialized
    assert dict.__len__(allocs) == 1
    assert server.allocation is allocs.best()
    # ... and ordinary access inflates the full candidate set
    assert len(allocs) == 3
    assert set(allocs) == {m.acc for m in spec.models}
    # best() after materialization still agrees with the argmin
    best = allocs.best()
    assert best is min(
        allocs.values(), key=lambda x: (x.value, x.cost, x.accelerator)
    )


def test_sizing_cache_store_keeps_lane_allocations_lazy():
    """SizingCache.store() must be O(1): caching a laned server keeps the
    lazy view un-materialized (no per-lane clone loop at store time), and
    a later hit still replays the full candidate set with recomputed
    transition penalties."""
    from inferno_tpu_torch.controller.sizing_cache import SizingCache
    from inferno_tpu_torch.core.allocation import transition_penalty

    spec = fleet_system_spec(6, shapes_per_variant=3, **NO_EDGES)
    system = System(spec)
    calculate_fleet(system, **CPU)
    solve_unlimited(system)
    name, server = next(iter(system.servers.items()))
    allocs = server.all_allocations
    assert isinstance(allocs, LaneAllocations)
    materialized_before = dict.__len__(allocs)

    cache = SizingCache(rel_tolerance=0.05)
    lam = server.load.arrival_rate
    cache.store(name, ("sig",), lam, allocs)
    # store touched nothing: same lazy source, no new lanes materialized
    assert allocs._src is not None
    assert dict.__len__(allocs) == materialized_before

    replay = cache.lookup(name, ("sig",), lam, server.cur_allocation)
    assert replay is not None
    assert set(replay) == set(allocs)  # full candidate set survives
    for acc, alloc in replay.items():
        original = allocs[acc]
        assert alloc is not original  # replays are clones
        assert alloc.value == transition_penalty(server.cur_allocation, alloc)
        assert (alloc.accelerator, alloc.num_replicas, alloc.cost) == (
            original.accelerator, original.num_replicas, original.cost
        )


def test_sizing_latency_budget_500_variants():
    """Fast budget guard (mirrors the reference's query-budget guard): a
    500-variant sizing pass — snapshot update, solve, vectorized
    writeback, solver argmin — must fit a generous CPU budget after a
    warm-up pass. Catches an accidental return to per-lane Python work,
    not box-speed noise (hence min-of-3 and a wide ceiling)."""
    import time

    BUDGET_MS = 3000.0
    spec = fleet_system_spec(500, shapes_per_variant=1)
    system = System(spec)
    calculate_fleet(system, **CPU)  # warm-up, uncounted
    solve_unlimited(system)
    times = []
    for _ in range(3):
        perturb_loads(system)
        t0 = time.perf_counter()
        calculate_fleet(system, **CPU)
        solve_unlimited(system)
        times.append((time.perf_counter() - t0) * 1000.0)
    assert min(times) <= BUDGET_MS, (
        f"500-variant sizing pass took {min(times):.0f}ms "
        f"(budget {BUDGET_MS:.0f}ms); the vectorized path regressed"
    )


def test_backend_torch_accepted_scalar_is_oracle():
    """The port's counterpart of the reference's 'jax' case: 'torch' and
    'cuda' are its first-class compute backends; 'scalar' stays accepted
    as the explicit parity oracle; junk is rejected, and so is 'jax',
    which only the reference runs."""
    from inferno_tpu_torch.controller.reconciler import ReconcilerConfig

    assert ReconcilerConfig(compute_backend="torch").compute_backend == "torch"
    assert ReconcilerConfig(compute_backend="cuda").compute_backend == "cuda"
    assert ReconcilerConfig(compute_backend="scalar").compute_backend == "scalar"
    with pytest.raises(ValueError):
        ReconcilerConfig(compute_backend="vectorized")
    with pytest.raises(ValueError):
        ReconcilerConfig(compute_backend="jax")


def test_vectorized_sizing_suite_stays_in_fast_tier():
    """No test in this module may carry the `slow` marker — the parity
    and budget assertions above must stay inside tier-1's
    `-m 'not slow'` run."""
    import pathlib

    marker = "mark." + "slow"  # split so this line doesn't self-match
    text = (pathlib.Path(__file__).parent / "test_torch_vectorized_sizing.py").read_text()
    assert marker not in text
