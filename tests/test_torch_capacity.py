"""The port's capacity-limited solve (inferno_tpu_torch.solver.greedy /
greedy_vec / optimizer) on the CPU.

* Inside the port: the vectorized `solve_greedy_fleet` equals the scalar
  `solve_greedy` BIT FOR BIT — allocations and `system.degradations` —
  across loose and binding capacity, quotas and regions, every
  saturation policy in both best-effort modes, and the crafted
  degradation ladder (the counterparts of tests/test_capacity_solver.py).
* Against the JAX reference, in two ways: (a) the solver alone, on the
  reference's own sized candidates carried into the port's Allocations,
  which isolates it from ±1 ceil-boundary lanes of the sizing; (b) end
  to end, each package sizing its own System, on fleets where the sizing
  shows no boundary lane.
"""

import dataclasses

import numpy as np
import pytest
import torch

from inferno_tpu_torch.config.defaults import SaturationPolicy
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
from inferno_tpu_torch.parallel import LaneAllocations, calculate_fleet, reset_fleet_state
from inferno_tpu_torch.parallel.fleet import FleetCandidates, _LaneSource
from inferno_tpu_torch.solver import Optimizer, Solver, optimize
from inferno_tpu_torch.solver.greedy import (
    DEGRADE_INT8,
    DEGRADE_REPLICAS,
    DEGRADE_SHAPE,
    DEGRADE_ZEROED,
    solve_greedy,
)
from inferno_tpu_torch.solver.greedy_vec import solve_greedy_fleet
from inferno_tpu_torch.testing.fleet import fleet_capacity, fleet_system_spec

CPU = dict(backend="torch", device="cpu")


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


def _edge_spec(**kw):
    """The edge fleet: tandem, zero-load, pinned and infeasible variants."""
    kw.setdefault("shapes_per_variant", 3)
    kw.setdefault("priority_classes", 3)
    return fleet_system_spec(40, **kw)


def _limited(spec, fraction, **opt):
    cap = fleet_capacity(spec, fraction, device="cpu")
    reset_fleet_state()
    spec.capacity = CapacitySpec(chips=cap)
    spec.optimizer = OptimizerSpec(unlimited=False, **opt)
    return spec


def _solve_both(spec):
    """Size two identical Systems with the batched path, each from a fresh
    fleet state (so they share no candidate objects); solve one with the
    scalar greedy and one vectorized, on its candidate table."""
    a = System(spec)
    calculate_fleet(a, **CPU)
    reset_fleet_state()
    b = System(spec)
    calculate_fleet(b, **CPU)
    solve_greedy(a, spec.optimizer)
    solve_greedy_fleet(b, spec.optimizer)
    if b.fleet_candidates is not None:  # not under GREEDY_VECTORIZED=0
        assert b.fleet_candidates.num_rows > 0
    return a, b


def _surface(system) -> dict:
    out = {}
    for name, server in system.servers.items():
        a = server.allocation
        out[name] = None if a is None else (
            a.accelerator, a.num_replicas, a.batch_size, a.cost, a.value,
            a.spot_replicas, a.spot_discount,
        )
    return out


def _events(system) -> dict:
    return {k: dataclasses.asdict(v) for k, v in system.degradations.items()}


def _assert_bit_parity(scalar: System, fleet: System) -> None:
    assert _surface(scalar) == _surface(fleet)
    assert scalar.degradations == fleet.degradations


@pytest.mark.parametrize("fraction", [1.2, 1.0, 0.5])
def test_vectorized_matches_scalar_tight_and_loose(fraction):
    spec = _limited(_edge_spec(), fraction)
    scalar, fleet = _solve_both(spec)
    _assert_bit_parity(scalar, fleet)
    assert bool(fleet.degradations) == (fraction < 1.0)


def test_vectorized_matches_scalar_with_quotas_and_regions():
    """Split pools + a per-region quota + a pool-wide quota: the quota
    buckets bind before the pool budgets and both solvers walk the same
    ladder."""
    spec = _edge_spec(split_pools=True)
    cap = fleet_capacity(spec, 1.0, device="cpu")
    reset_fleet_state()
    quotas = {f"{pool}/r0": max(chips // 3, 4) for pool, chips in cap.items() if pool == "gen0"}
    quotas["gen1"] = max(cap.get("gen1", 8) // 2, 4)
    spec.capacity = CapacitySpec(chips=cap, quotas=quotas)
    spec.optimizer = OptimizerSpec(unlimited=False)
    scalar, fleet = _solve_both(spec)
    _assert_bit_parity(scalar, fleet)
    assert any(e.pool in quotas for e in fleet.degradations.values()), fleet.degradations


@pytest.mark.parametrize("policy", [p.value for p in (
    SaturationPolicy.NONE, SaturationPolicy.PRIORITY_EXHAUSTIVE,
    SaturationPolicy.PRIORITY_ROUND_ROBIN, SaturationPolicy.ROUND_ROBIN,
)])
@pytest.mark.parametrize("delayed", [False, True])
def test_saturation_policy_parity(policy, delayed):
    spec = _limited(_edge_spec(), 0.5, saturation_policy=policy, delayed_best_effort=delayed)
    scalar, fleet = _solve_both(spec)
    _assert_bit_parity(scalar, fleet)


def test_no_dict_inflation_on_vectorized_path():
    """The vectorized constrained solve never inflates candidate dicts:
    the lazy table is built on demand, and the materialization counter
    stays at O(allocated servers), below the lane count."""
    spec = _limited(_edge_spec(), 0.6)
    system = System(spec)
    calculate_fleet(system, **CPU)
    assert system.fleet_candidates is None  # lazy: unlimited never pays
    solve_greedy_fleet(system, spec.optimizer)
    assert system.fleet_candidates is not None
    allocated = sum(1 for s in system.servers.values() if s.allocation is not None)
    materialized = system.fleet_candidates.src.materialized
    assert materialized <= allocated
    assert materialized < system.fleet_candidates.num_rows
    assert any(
        isinstance(s.all_allocations, LaneAllocations) and s.all_allocations._src is not None
        for s in system.servers.values()
    ), "every lazy view was inflated"


def test_vectorized_env_kill_switch(monkeypatch):
    """GREEDY_VECTORIZED=0 routes solve_greedy_fleet to the scalar solver."""
    spec = _limited(_edge_spec(shapes_per_variant=2), 0.7)
    scalar, fleet = _solve_both(spec)
    _assert_bit_parity(scalar, fleet)
    reset_fleet_state()
    monkeypatch.setenv("GREEDY_VECTORIZED", "0")
    off = System(spec)
    calculate_fleet(off, **CPU)
    solve_greedy_fleet(off, spec.optimizer)
    assert off.fleet_candidates is None  # the table was never built
    _assert_bit_parity(scalar, off)


def test_mixed_lanes_and_cache_replayed_dicts_parity():
    """Plain candidate dicts (sizing-cache replays) beside lazy lane views
    in one limited solve still match the scalar oracle bit for bit."""
    spec = _limited(_edge_spec(shapes_per_variant=2), 0.6)
    a = System(spec)
    calculate_fleet(a, **CPU)
    reset_fleet_state()
    b = System(spec)
    calculate_fleet(b, **CPU)
    for i, server in enumerate(b.servers.values()):
        if i % 2 == 0 and server.all_allocations:
            server.all_allocations = {
                acc: alloc.clone() for acc, alloc in server.all_allocations.items()
            }
    solve_greedy(a, spec.optimizer)
    solve_greedy_fleet(b, spec.optimizer)
    _assert_bit_parity(a, b)


def test_solver_and_optimizer_run_limited_mode():
    """Solver.solve and Optimizer.optimize take limited mode, report the
    orchestration diffs and carry the degradation events."""
    spec = _limited(_edge_spec(shapes_per_variant=2), 0.5)
    system = System(spec)
    calculate_fleet(system, **CPU)
    result = Optimizer(spec.optimizer).optimize(system, calculate=False)
    assert result.degradations and result.degradations == system.degradations
    assert result.diffs
    assert sum(u.chips for u in result.pool_usage.values()) <= sum(spec.capacity.chips.values())
    reset_fleet_state()
    again = System(spec)
    calculate_fleet(again, **CPU)
    solver = Solver(spec.optimizer)
    solver.solve(again)
    assert _surface(again) == _surface(system)
    reset_fleet_state()
    third = System(spec)
    calculate_fleet(third, **CPU)
    assert optimize(third, spec.optimizer).degradations == result.degradations


# -- the degradation ladder (crafted, exact) ---------------------------------

SHAPES = [
    AcceleratorSpec(name="v5e-4", cost_per_chip_hr=1.0),
    AcceleratorSpec(name="v5e-4-int8", pool="v5e", chips=4, cost_per_chip_hr=0.5),
    AcceleratorSpec(name="v5p-8", cost_per_chip_hr=2.0),
]


def _alloc(acc, replicas, value):
    a = Allocation(accelerator=acc, num_replicas=replicas, batch_size=16,
                   cost=value, max_arrv_rate_per_replica=0.01)
    a.value = value
    return a


def _crafted_system(candidates, capacity, policy="None", quotas=None):
    spec = SystemSpec(
        accelerators=list(SHAPES),
        models=[
            ModelPerfSpec(
                name="m", acc=a.name, max_batch_size=16, at_tokens=128,
                decode_parms=DecodeParms(10.0, 0.2), prefill_parms=PrefillParms(3.0, 0.01),
            )
            for a in SHAPES
        ],
        service_classes=[ServiceClassSpec(
            name="Premium", priority=1, model_targets=[ModelTarget(model="m", slo_itl=60.0)],
        )],
        servers=[
            ServerSpec(
                name=name, class_name="Premium", model="m", min_num_replicas=1,
                current_alloc=AllocationData(load=ServerLoadSpec(600.0, 128, 64)),
            )
            for name in candidates
        ],
        optimizer=OptimizerSpec(unlimited=False, saturation_policy=policy),
        capacity=CapacitySpec(chips=capacity, quotas=quotas or {}),
    )
    system = System(spec)
    for name, cands in candidates.items():
        system.servers[name].all_allocations = {
            acc: _alloc(acc, reps, val) for acc, (reps, val) in cands.items()
        }
    system.candidates_calculated = True
    return system, spec


def _empty_table() -> FleetCandidates:
    """A candidate table with no lane rows: solve_greedy_fleet then runs
    its vectorized machinery on every server's plain dict (extension
    rows), not the scalar fallback."""
    z = np.zeros(0, np.int64)
    return FleetCandidates(
        src=_LaneSource(), server=z, kind=z, lane=z, value=np.zeros(0), cost=np.zeros(0),
        reps=z, chips=z, rank=z, spot_reps=z, bounds=np.zeros(1, np.int64), seg_server=z,
    )


def _both_solvers(candidates, capacity, policy="None", quotas=None):
    """The scalar solve and the vectorized one (extension rows) of one
    crafted system; they must agree, and the scalar one is returned."""
    scalar, spec = _crafted_system(candidates, capacity, policy, quotas)
    solve_greedy(scalar, spec.optimizer)
    vec, _ = _crafted_system(candidates, capacity, policy, quotas)
    vec.fleet_candidates = _empty_table()
    solve_greedy_fleet(vec, spec.optimizer)
    _assert_bit_parity(scalar, vec)
    return scalar


def test_ladder_shape_step_down():
    system = _both_solvers(
        {"s": {"v5e-4": (4, 10.0), "v5p-8": (2, 30.0)}}, capacity={"v5e": 8, "v5p": 16},
    )
    e = system.degradations["s"]
    assert e.step == DEGRADE_SHAPE
    assert (e.from_accelerator, e.to_accelerator) == ("v5e-4", "v5p-8")
    assert e.pool == "v5e" and e.shortfall_chips == 8
    assert (e.from_replicas, e.to_replicas) == (4, 2)


def test_ladder_int8_step_down():
    system = _both_solvers(
        {"s": {"v5e-4": (10, 100.0), "v5e-4-int8": (5, 120.0)}}, capacity={"v5e": 24},
    )
    e = system.degradations["s"]
    assert e.step == DEGRADE_INT8 and e.to_accelerator == "v5e-4-int8"
    assert e.shortfall_chips == 16


def test_ladder_replica_scale_down_and_zeroed():
    cands = {"s": {"v5e-4": (10, 100.0)}}
    scaled = _both_solvers(cands, capacity={"v5e": 24}, policy="PriorityExhaustive")
    e = scaled.degradations["s"]
    assert e.step == DEGRADE_REPLICAS and (e.from_replicas, e.to_replicas) == (10, 6)
    assert scaled.servers["s"].allocation.num_replicas == 6
    zeroed = _both_solvers(cands, capacity={"v5e": 2}, policy="None")
    e = zeroed.degradations["s"]
    assert e.step == DEGRADE_ZEROED and e.to_accelerator == "" and e.shortfall_chips == 38
    assert zeroed.servers["s"].allocation is None


def test_greedy_tie_break_deterministic_both_orders():
    """Equal-value equal-cost candidates resolve by accelerator name, not
    dict insertion order."""
    a = _alloc("v5p-8", 1, 10.0)
    b = _alloc("v5e-4", 2, 10.0)
    for order in ((a, b), (b, a)):
        system, spec = _crafted_system({"s": {}}, capacity={"v5e": 64, "v5p": 64})
        system.servers["s"].all_allocations = {x.accelerator: x for x in order}
        solve_greedy(system, spec.optimizer)
        assert system.servers["s"].allocation.accelerator == "v5e-4", order


def test_quota_binds_before_pool():
    region = [AcceleratorSpec(name="v5e-4", cost_per_chip_hr=1.0, region="us-east1")]

    def system_with(quota):
        spec = SystemSpec(
            accelerators=region,
            models=[ModelPerfSpec(
                name="m", acc="v5e-4", max_batch_size=16, at_tokens=128,
                decode_parms=DecodeParms(10.0, 0.2), prefill_parms=PrefillParms(3.0, 0.01),
            )],
            service_classes=[ServiceClassSpec(
                name="Premium", priority=1, model_targets=[ModelTarget(model="m", slo_itl=60.0)],
            )],
            servers=[ServerSpec(
                name="s", class_name="Premium", model="m", min_num_replicas=1,
                current_alloc=AllocationData(load=ServerLoadSpec(600.0, 128, 64)),
            )],
            optimizer=OptimizerSpec(unlimited=False),
            capacity=CapacitySpec(chips={"v5e": 64}, quotas={"v5e/us-east1": quota}),
        )
        system = System(spec)
        system.servers["s"].all_allocations = {"v5e-4": _alloc("v5e-4", 4, 10.0)}
        system.candidates_calculated = True
        solve_greedy(system, spec.optimizer)
        return system

    tight = system_with(8)
    assert tight.servers["s"].allocation is None  # 16 chips > 8 quota
    e = tight.degradations["s"]
    assert e.pool == "v5e/us-east1" and e.shortfall_chips == 8
    loose = system_with(16)
    assert loose.servers["s"].allocation is not None and not loose.degradations


# -- the port against the JAX reference ---------------------------------------


def _ref_limited(fraction, size=True):
    """A reference System of the capacity bench's fleet at `fraction`,
    sized by the reference (backend "jax") when `size`, and its spec."""
    from inferno_tpu.config.types import CapacitySpec as RefCapacitySpec
    from inferno_tpu.config.types import OptimizerSpec as RefOptimizerSpec
    from inferno_tpu.core import System as RefSystem
    from inferno_tpu.parallel import calculate_fleet as ref_calculate_fleet
    from inferno_tpu.parallel import reset_fleet_state as ref_reset
    from inferno_tpu.testing.fleet import fleet_capacity as ref_fleet_capacity
    from inferno_tpu.testing.fleet import fleet_system_spec as ref_fleet_system_spec

    ref_reset()
    spec = ref_fleet_system_spec(40, shapes_per_variant=2, priority_classes=3, split_pools=True)
    cap = ref_fleet_capacity(spec, fraction, backend="jax")
    ref_reset()
    spec.capacity = RefCapacitySpec(chips=cap)
    spec.optimizer = RefOptimizerSpec(unlimited=False)
    system = RefSystem(spec)
    if size:
        ref_calculate_fleet(system, backend="jax")
    return system, spec


def _carry(ref_system, port_system) -> None:
    """The reference's sized candidates, as the port's own Allocations."""
    fields = ("accelerator", "num_replicas", "batch_size", "cost", "itl", "ttft", "rho",
              "max_arrv_rate_per_replica", "value", "spot_replicas", "spot_discount",
              "spot_premium", "spot_trimmed")
    for name, server in ref_system.servers.items():
        carried = {}
        for acc, a in server.all_allocations.items():
            b = Allocation(accelerator=acc, num_replicas=0, batch_size=0, cost=0.0)
            for f in fields:
                setattr(b, f, getattr(a, f))
            carried[acc] = b
        port_system.servers[name].all_allocations = carried
    port_system.candidates_calculated = True


@pytest.mark.parametrize("fraction", [1.0, 0.8, 0.5])
def test_solver_alone_matches_reference(fraction):
    """(a) The reference's sized candidates carried into the port: the
    port's vectorized solve (extension rows) and its scalar solve both
    equal the reference's vectorized solve — allocations and events."""
    from inferno_tpu.parallel import reset_fleet_state as ref_reset
    from inferno_tpu.solver.greedy_vec import solve_greedy_fleet as ref_solve_greedy_fleet

    ref, ref_spec = _ref_limited(fraction)
    try:
        port_spec = SystemSpec.from_dict(ref_spec.to_dict())
        vec, scalar = System(port_spec), System(port_spec)
        _carry(ref, vec)
        _carry(ref, scalar)
        ref_solve_greedy_fleet(ref, ref_spec.optimizer)
        vec.fleet_candidates = _empty_table()
        solve_greedy_fleet(vec, port_spec.optimizer)
        solve_greedy(scalar, port_spec.optimizer)
    finally:
        ref_reset()
    assert _surface(vec) == _surface(ref) == _surface(scalar)
    assert _events(vec) == _events(ref) == _events(scalar)
    assert bool(ref.degradations) == (fraction < 1.0)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_limited_mode_end_to_end_matches_reference(fraction):
    """(b) Each package sizes its own System and runs its own vectorized
    limited solve; with no ceil-boundary lane in the sizing, decisions
    and degradation events are identical."""
    from inferno_tpu.parallel import reset_fleet_state as ref_reset
    from inferno_tpu.solver.greedy_vec import solve_greedy_fleet as ref_solve_greedy_fleet
    from inferno_tpu.solver.solver import solve_unlimited as ref_solve_unlimited
    from inferno_tpu_torch.solver import solve_unlimited
    from inferno_tpu_torch.testing.fleet import assert_same_decisions

    from inferno_tpu.parallel import calculate_fleet as ref_calculate_fleet

    ref_u, ref_spec = _ref_limited(fraction, size=False)
    try:
        port_spec = SystemSpec.from_dict(ref_spec.to_dict())
        # the sizing alone, under the round's rule: no boundary lane
        ref_calculate_fleet(ref_u, backend="jax")
        ref_solve_unlimited(ref_u)
        port_u = System(port_spec)
        calculate_fleet(port_u, **CPU)
        solve_unlimited(port_u)
        assert assert_same_decisions(ref_u, port_u) == 0
        ref_reset()
        reset_fleet_state()
        ref = type(ref_u)(ref_spec)
        ref_calculate_fleet(ref, backend="jax")
        ref_solve_greedy_fleet(ref, ref_spec.optimizer)
        port = System(port_spec)
        calculate_fleet(port, **CPU)
        solve_greedy_fleet(port, port_spec.optimizer)
    finally:
        ref_reset()
    assert _surface(port) == _surface(ref)
    assert _events(port) == _events(ref)
