"""Port of tests/test_core.py, on the port's imports.

Core domain tests: system construction, allocation sizing, penalties.

Mirrors the strategy of the reference's core tests
(the upstream Go project's pkg/core/{allocation,system,server}_test.go): hand-built
SystemSpec fixtures, no Kubernetes.

Every System these tests build carries the reference's System on the same
spec (`System` below), and every sizing, penalty, diff, power and pool call
runs on both and must agree exactly (the core is the same f64 code in both
packages); the copied expectations stay as well.
"""

import math

import pytest

import inferno_tpu.core as ref_core
import inferno_tpu_torch.core as port_core
from inferno_tpu_torch.config import AcceleratorSpec, AllocationData, PowerSpec, ServerLoadSpec
from inferno_tpu_torch.core.allocation import Allocation

import fixtures as ref_fixtures
from fixtures import LLAMA8B
from inferno_tpu.config.types import AllocationData as RefAllocationData
from test_torch_analyzer import Held, assert_same, hold, to_reference
from inferno_tpu_torch.config.types import (
    ModelPerfSpec,
    ServerSpec,
    ServiceClassSpec,
    SystemSpec,
)

# tests/fixtures.py's builders, carried over into the port's types through
# the wire format (the port's tests import them from here)


def make_accelerators() -> list[AcceleratorSpec]:
    return [AcceleratorSpec.from_dict(a.to_dict()) for a in ref_fixtures.make_accelerators()]


def make_perf(model: str = LLAMA8B) -> list[ModelPerfSpec]:
    return [ModelPerfSpec.from_dict(m.to_dict()) for m in ref_fixtures.make_perf(model)]


def make_service_classes(model: str = LLAMA8B) -> list[ServiceClassSpec]:
    return [ServiceClassSpec.from_dict(c.to_dict())
            for c in ref_fixtures.make_service_classes(model)]


def make_server(*args, current: AllocationData | None = None, **kwargs) -> ServerSpec:
    """The fixture's server; like the reference's, it fills the load of the
    `current` allocation the caller passes in."""
    ref_current = None if current is None else RefAllocationData.from_dict(current.to_dict())
    srv = ServerSpec.from_dict(
        ref_fixtures.make_server(*args, current=ref_current, **kwargs).to_dict())
    if current is not None:
        current.load = srv.current_alloc.load
        srv.current_alloc = current
    return srv


def reference_system(spec: SystemSpec):
    """The reference's System on the same spec (through the wire format)."""
    from inferno_tpu.config.types import SystemSpec as RefSystemSpec
    from inferno_tpu.core import System as RefSystem

    return RefSystem(RefSystemSpec.from_dict(spec.to_dict()))


# -- the reference beside the port ----------------------------------------------


def System(spec: SystemSpec | None = None) -> port_core.System:
    """The port's System on `spec`, with the reference's System on the same
    spec beside it as `.reference` (for `create_allocation` and `on_both`)."""
    system = port_core.System(spec)
    system.reference = ref_core.System() if spec is None else reference_system(spec)
    return system


def create_allocation(system, server_name: str, acc_name: str):
    """The port's create_allocation, and the reference's on the reference
    System beside `system`: both agree exactly."""
    got = port_core.create_allocation(system, server_name, acc_name)
    assert_same(got, ref_core.create_allocation(system.reference, server_name, acc_name))
    return got


def on_both(system, op, *args):
    """`op(system, *args)` and `op(system.reference, *args)` with `args`
    carried into the reference's types: both results agree exactly, and
    the port's is returned. `op` may change state (calculate,
    set_allocation, ...): both systems then change alike."""
    got = op(system, *args)
    assert_same(got, op(system.reference, *to_reference(args)))
    return got


def held(obj):
    """A port value (an Allocation) beside the reference's copy of it:
    attributes and method calls are checked on both (`Held`)."""
    return Held(obj, to_reference(obj))


transition_penalty = hold(port_core.transition_penalty, ref_core.transition_penalty)
allocation_diff = hold(port_core.allocation_diff, ref_core.allocation_diff)
Accelerator = hold(port_core.Accelerator, ref_core.Accelerator, held=True)


def decisions(system) -> dict[str, str]:
    """Each server's chosen allocation, every field (repr)."""
    return {name: repr(s.allocation) for name, s in system.servers.items()}


def assert_solves_as_reference(spec: SystemSpec, system) -> None:
    """The reference's scalar sizing and solve of `spec` pick what the
    port's `system` picked, field for field (the scalar paths are the same
    f64 code in both packages)."""
    from inferno_tpu.config.types import OptimizerSpec as RefOptimizerSpec
    from inferno_tpu.solver import optimize as ref_optimize

    ref = reference_system(spec)
    ref.calculate_all()
    ref_optimize(ref, RefOptimizerSpec.from_dict(spec.optimizer.to_dict()))
    assert decisions(system) == decisions(ref)


def make_system_spec(servers: list[ServerSpec] | None = None, *args, **kwargs) -> SystemSpec:
    """The fixture's SystemSpec; `servers` are the port's ServerSpecs."""
    spec = SystemSpec.from_dict(ref_fixtures.make_system_spec(None, *args, **kwargs).to_dict())
    if servers is not None:
        spec.servers = servers
    return spec


def test_system_from_spec():
    system = System(make_system_spec())
    assert set(system.accelerators) == {"v5e-4", "v5p-8", "v5e-16"}
    assert LLAMA8B in system.models
    assert set(system.service_classes) == {"Premium", "Freemium"}
    assert len(system.servers) == 1
    # slice economics: v5e-4 = 4 chips at 10 c/chip-hr
    assert system.accelerators["v5e-4"].cost == pytest.approx(40.0)
    assert system.accelerators["v5e-4"].pool == "v5e"
    assert system.accelerators["v5p-8"].chips == 8
    assert on_both(system, lambda s: {
        n: (a.name, a.pool, a.chips, a.cost) for n, a in s.accelerators.items()}) \
        == {n: (n, a.pool, a.chips, a.cost) for n, a in system.accelerators.items()}
    assert on_both(system, lambda s: (sorted(s.models), sorted(s.service_classes),
                                      sorted(s.servers)))


def test_spec_round_trip():
    spec = make_system_spec()
    from inferno_tpu_torch.config import SystemSpec

    spec2 = SystemSpec.from_dict(spec.to_dict())
    assert spec2.to_dict() == spec.to_dict()


def test_create_allocation_sizes_replicas():
    spec = make_system_spec()
    system = System(spec)
    name = spec.servers[0].name
    alloc = create_allocation(system, name, "v5e-4")
    assert alloc is not None
    assert alloc.accelerator == "v5e-4"
    assert alloc.num_replicas >= 1
    # cost = replicas * slices * chips * chip-cost
    assert alloc.cost == pytest.approx(alloc.num_replicas * 1 * 4 * 10.0)
    assert alloc.itl <= 24.0 * 1.01
    assert alloc.ttft <= 500.0 * 1.01
    assert 0.0 <= alloc.rho <= 1.0
    assert alloc.max_rpm > 0
    # replicas = ceil(total_rate / rate_star)
    total_rate = 120.0 / 60.0
    rate_star = alloc.max_arrv_rate_per_replica * 1000.0
    assert alloc.num_replicas == math.ceil(total_rate / rate_star)


def test_create_allocation_scales_with_load():
    low = make_system_spec([make_server(arrival_rate=60.0)])
    high = make_system_spec([make_server(arrival_rate=6000.0)])
    a_low = create_allocation(System(low), low.servers[0].name, "v5e-4")
    a_high = create_allocation(System(high), high.servers[0].name, "v5e-4")
    assert a_high.num_replicas > a_low.num_replicas


def test_create_allocation_zero_load_holds_min_replicas():
    spec = make_system_spec([make_server(arrival_rate=0.0, min_replicas=2)])
    system = System(spec)
    alloc = create_allocation(system, spec.servers[0].name, "v5e-4")
    assert alloc.num_replicas == 2
    assert alloc.cost == pytest.approx(2 * 4 * 10.0)
    assert alloc.rho == 0.0


def test_create_allocation_scale_to_zero():
    spec = make_system_spec([make_server(arrival_rate=0.0, min_replicas=0)])
    system = System(spec)
    alloc = create_allocation(system, spec.servers[0].name, "v5e-4")
    assert alloc.accelerator == ""
    assert alloc.num_replicas == 0
    assert alloc.cost == 0.0


def test_create_allocation_unknown_entities():
    spec = make_system_spec()
    system = System(spec)
    assert create_allocation(system, "nope", "v5e-4") is None
    assert create_allocation(system, spec.servers[0].name, "h100") is None


def test_create_allocation_missing_target():
    spec = make_system_spec([make_server(class_name="Premium", model="unknown-model")])
    system = System(spec)
    assert create_allocation(system, spec.servers[0].name, "v5e-4") is None


def test_transition_penalty_semantics():
    a = Allocation(accelerator="v5e-4", num_replicas=2, batch_size=8, cost=80.0)
    same = Allocation(accelerator="v5e-4", num_replicas=2, batch_size=8, cost=80.0)
    scaled = Allocation(accelerator="v5e-4", num_replicas=3, batch_size=8, cost=120.0)
    moved = Allocation(accelerator="v5p-8", num_replicas=1, batch_size=8, cost=130.0)
    assert transition_penalty(a, same) == 0.0
    assert transition_penalty(a, scaled) == pytest.approx(40.0)
    # slice-shape change: 0.1*(80+130) + (130-80)
    assert transition_penalty(a, moved) == pytest.approx(21.0 + 50.0)


def test_server_calculate_values_are_penalties():
    # fresh server (empty current alloc): value = 1.1 * cost for every shape
    spec = make_system_spec()
    system = System(spec)
    server = system.servers[spec.servers[0].name]
    on_both(system, lambda s: s.servers[server.name].calculate(s))
    on_both(system, lambda s: s.servers[server.name].all_allocations)
    assert len(server.all_allocations) == 3
    for alloc in server.all_allocations.values():
        assert alloc.value == pytest.approx(1.1 * alloc.cost, rel=1e-6)


def test_server_keep_accelerator_pins_candidates():
    current = AllocationData(accelerator="v5p-8", num_replicas=1, cost=130.0)
    srv = make_server(current=current)
    srv.keep_accelerator = True
    spec = make_system_spec([srv])
    system = System(spec)
    server = system.servers[srv.name]
    on_both(system, lambda s: s.servers[srv.name].calculate(s))
    on_both(system, lambda s: s.servers[srv.name].all_allocations)
    assert set(server.all_allocations) == {"v5p-8"}


def test_allocation_diff():
    a = Allocation(accelerator="v5e-4", num_replicas=2, batch_size=8, cost=80.0)
    b = Allocation(accelerator="v5e-16", num_replicas=1, batch_size=8, cost=160.0)
    d = allocation_diff(a, b)
    assert d.cost_diff == pytest.approx(80.0)
    assert allocation_diff(None, None) is None
    d2 = allocation_diff(None, b)
    assert d2.old_accelerator == "none"


def test_saturated():
    a = Allocation(
        accelerator="v5e-4",
        num_replicas=2,
        batch_size=8,
        cost=80.0,
        max_arrv_rate_per_replica=0.001,  # req/msec -> 60 req/min per replica
    )
    a = held(a)
    assert a.max_rpm == pytest.approx(60.0)
    assert not a.saturated(100.0)
    assert a.saturated(121.0)


def test_pool_usage_accounting():
    spec = make_system_spec()
    system = System(spec)
    server = system.servers[spec.servers[0].name]
    on_both(system, lambda s: s.servers[server.name].calculate(s))
    on_both(system, lambda s: s.servers[server.name].set_allocation(
        s.servers[server.name].all_allocations["v5e-16"]))
    usage = on_both(system, lambda s: s.allocate_by_pool())
    assert usage["v5e"].chips == server.allocation.num_replicas * 16
    assert usage["v5e"].cost == pytest.approx(server.allocation.cost)


def test_power_model_piecewise_linear():
    # Per-chip piecewise profile through (0, idle), (mid_util, mid), (1, full),
    # scaled to the slice's chip count (reference pkg/core/accelerator.go:29-41).
    acc = Accelerator(
        AcceleratorSpec(
            name="v5e-4",
            cost_per_chip_hr=1.2,
            power=PowerSpec(idle=60.0, full=200.0, mid_power=150.0, mid_util=0.5),
        )
    )
    assert acc.power(0.0) == pytest.approx(4 * 60.0)
    assert acc.power(0.5) == pytest.approx(4 * 150.0)
    assert acc.power(1.0) == pytest.approx(4 * 200.0)
    # low segment slope (150-60)/0.5 = 180 W per unit util per chip
    assert acc.power(0.25) == pytest.approx(4 * (60.0 + 180.0 * 0.25))
    # high segment slope (200-150)/0.5 = 100
    assert acc.power(0.75) == pytest.approx(4 * (150.0 + 100.0 * 0.25))
    # out-of-range utilizations clamp
    assert acc.power(-1.0) == acc.power(0.0)
    assert acc.power(2.0) == acc.power(1.0)


def test_power_model_degenerate_mid_util_falls_back_linear():
    acc = Accelerator(
        AcceleratorSpec(
            name="v5e-1",
            power=PowerSpec(idle=50.0, full=150.0, mid_power=0.0, mid_util=0.0),
        )
    )
    assert acc.power(0.5) == pytest.approx(100.0)


def test_power_spec_round_trip_and_defaults():
    p = PowerSpec(idle=60.0, full=200.0, mid_power=150.0, mid_util=0.4)
    assert PowerSpec.from_dict(p.to_dict()) == p
    # missing midPower defaults to the idle/full midpoint
    q = PowerSpec.from_dict({"idle": 100.0, "full": 300.0})
    assert q.mid_power == pytest.approx(200.0)
    assert q.mid_util == pytest.approx(0.5)


def test_pool_usage_includes_power():
    spec = make_system_spec()
    for a in spec.accelerators:
        a.power = PowerSpec(idle=60.0, full=200.0, mid_power=150.0, mid_util=0.5)
    system = System(spec)
    server = system.servers[spec.servers[0].name]
    on_both(system, lambda s: s.servers[server.name].calculate(s))
    alloc = server.all_allocations["v5e-16"]
    on_both(system, lambda s, a: s.servers[server.name].set_allocation(a), alloc)
    usage = on_both(system, lambda s: s.allocate_by_pool())
    assert on_both(system, lambda s: s.accelerators["v5e-16"].power(alloc.rho)) > 0
    acc = system.accelerators["v5e-16"]
    assert usage["v5e"].watts == pytest.approx(alloc.num_replicas * acc.power(alloc.rho))
    assert usage["v5e"].watts > 0


def test_power_spec_explicit_zeros_preserved():
    # midUtil: 0 selects the linear fallback and must survive round-trip
    p = PowerSpec(idle=50.0, full=150.0, mid_power=0.0, mid_util=0.0)
    assert PowerSpec.from_dict(p.to_dict()) == p
