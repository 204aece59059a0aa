"""Port of tests/test_solver_properties.py, on the port's imports.

Property-style solver invariants over randomized fleets.

The reference's greedy solver is its most heavily tested component
(greedy_test.go, ~1.7k LoC of cases). These tests cover the same ground
generatively: random fleets, checked against invariants that must hold
for every instance.
"""

import numpy as np
import pytest

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
from inferno_tpu_torch.solver import optimize

from test_torch_core import assert_solves_as_reference

SHAPES = [("v5e-4", 4), ("v5e-8", 8), ("v5e-16", 16), ("v5p-8", 8)]


def random_spec(rng, n_servers, unlimited, capacity_chips, policy="None"):
    model = "m/rand"
    accs = [AcceleratorSpec(name=n, cost_per_chip_hr=float(rng.uniform(1, 6)))
            for n, _ in SHAPES]
    perfs = [
        ModelPerfSpec(
            name=model, acc=n,
            max_batch_size=int(rng.integers(8, 64)), at_tokens=128,
            decode_parms=DecodeParms(float(rng.uniform(8, 30)), float(rng.uniform(0.1, 0.5))),
            prefill_parms=PrefillParms(float(rng.uniform(2, 8)), float(rng.uniform(0.002, 0.01))),
        )
        for n, _ in SHAPES
    ]
    classes = [
        ServiceClassSpec(name="Premium", priority=1,
                         model_targets=[ModelTarget(model=model, slo_itl=60.0, slo_ttft=2000.0)]),
        ServiceClassSpec(name="Free", priority=10,
                         model_targets=[ModelTarget(model=model, slo_itl=200.0, slo_ttft=5000.0)]),
    ]
    servers = [
        ServerSpec(
            name=f"s{i}",
            class_name="Premium" if rng.random() < 0.5 else "Free",
            model=model,
            min_num_replicas=1,
            current_alloc=AllocationData(load=ServerLoadSpec(
                arrival_rate=float(rng.integers(60, 3000)),
                avg_in_tokens=int(rng.integers(64, 1024)),
                avg_out_tokens=int(rng.integers(32, 256)),
            )),
        )
        for i in range(n_servers)
    ]
    return SystemSpec(
        accelerators=accs, models=perfs, service_classes=classes, servers=servers,
        optimizer=OptimizerSpec(unlimited=unlimited, saturation_policy=policy),
        capacity=CapacitySpec(chips={"v5e": capacity_chips, "v5p": capacity_chips}),
    )


def chips_used(system):
    used = {}
    for server in system.servers.values():
        alloc = server.allocation
        if alloc is None or not alloc.accelerator:
            continue
        acc = system.accelerators[alloc.accelerator]
        model = system.models[server.model_name]
        per = model.perf_data[alloc.accelerator].slices_per_replica
        used[acc.pool] = used.get(acc.pool, 0) + alloc.num_replicas * per * acc.chips
    return used


@pytest.mark.parametrize("seed", range(8))
def test_greedy_never_exceeds_capacity(seed):
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(16, 160))
    spec = random_spec(rng, n_servers=int(rng.integers(2, 10)), unlimited=False,
                       capacity_chips=cap, policy="PriorityExhaustive")
    system = System(spec)
    system.calculate_all()
    optimize(system, spec.optimizer)
    for pool, used in chips_used(system).items():
        assert used <= cap, (seed, pool, used, cap)
    assert_solves_as_reference(spec, system)


@pytest.mark.parametrize("seed", range(8))
def test_greedy_with_ample_capacity_matches_unlimited(seed):
    rng = np.random.default_rng(100 + seed)
    spec_l = random_spec(rng, n_servers=5, unlimited=False, capacity_chips=10**6)
    spec_u = SystemSpec(**{**spec_l.__dict__, "optimizer": OptimizerSpec(unlimited=True)})

    sys_l = System(spec_l); sys_l.calculate_all(); optimize(sys_l, spec_l.optimizer)
    sys_u = System(spec_u); sys_u.calculate_all(); optimize(sys_u, spec_u.optimizer)

    for name in sys_u.servers:
        au = sys_u.servers[name].allocation
        al = sys_l.servers[name].allocation
        assert au is not None and al is not None, name
        assert (au.accelerator, au.num_replicas) == (al.accelerator, al.num_replicas), name
    assert_solves_as_reference(spec_l, sys_l)
    assert_solves_as_reference(spec_u, sys_u)


@pytest.mark.parametrize("policy", [p.value for p in SaturationPolicy])
def test_policies_respect_capacity_under_scarcity(policy):
    rng = np.random.default_rng(7)
    cap = 24  # scarce: a few 4-chip replicas total
    spec = random_spec(rng, n_servers=6, unlimited=False,
                       capacity_chips=cap, policy=policy)
    system = System(spec)
    system.calculate_all()
    optimize(system, spec.optimizer)
    for pool, used in chips_used(system).items():
        assert used <= cap, (policy, pool, used, cap)
    assert_solves_as_reference(spec, system)


def test_higher_priority_served_first_under_scarcity():
    """With capacity for exactly one server's needs, the Premium server
    must get its allocation before the Free one."""
    rng = np.random.default_rng(3)
    spec = random_spec(rng, n_servers=1, unlimited=False, capacity_chips=10**6)
    # two identical servers except priority
    base = spec.servers[0]
    prem = ServerSpec(name="prem", class_name="Premium", model=base.model,
                      min_num_replicas=1, current_alloc=base.current_alloc)
    free = ServerSpec(name="free", class_name="Free", model=base.model,
                      min_num_replicas=1, current_alloc=base.current_alloc)
    spec.servers = [free, prem]  # order must not matter

    # find what prem alone needs, then cap capacity to exactly that
    probe = SystemSpec(**{**spec.__dict__, "servers": [prem]})
    sys_p = System(probe); sys_p.calculate_all(); optimize(sys_p, probe.optimizer)
    alloc = sys_p.servers["prem"].allocation
    acc = sys_p.accelerators[alloc.accelerator]
    need = alloc.num_replicas * acc.chips
    spec.capacity = CapacitySpec(chips={acc.pool: need})
    spec.optimizer = OptimizerSpec(unlimited=False, saturation_policy="None")

    system = System(spec)
    system.calculate_all()
    optimize(system, spec.optimizer)
    prem_alloc = system.servers["prem"].allocation
    assert prem_alloc is not None and prem_alloc.accelerator, "premium starved"
    assert_solves_as_reference(spec, system)


@pytest.mark.slow
def test_large_fleet_limited_mode_invariants():
    """200 variants x 4 shapes under a tight chip budget: capacity holds,
    higher priorities are never starved in favor of lower ones, and the
    whole solve (scalar sizing + greedy) stays well under a reconcile
    interval."""
    import time as _time

    rng = np.random.default_rng(42)
    spec = random_spec(rng, n_servers=200, unlimited=False,
                       capacity_chips=2000, policy="PriorityExhaustive")
    system = System(spec)
    t0 = _time.perf_counter()
    optimize(system, spec.optimizer)
    wall = _time.perf_counter() - t0
    assert wall < 30.0, f"solve took {wall:.1f}s"

    used = chips_used(system)
    for pool, n in used.items():
        assert n <= 2000, (pool, n)

    # no priority inversion in SATURATION: if any Premium server ended up
    # unallocated, no Free server may hold chips it could have used
    # (PriorityExhaustive semantics: higher priorities drained first)
    premium_unmet = [
        s for s in system.servers.values()
        if s.service_class_name == "Premium" and s.allocation is None
    ]
    if premium_unmet:
        free_allocated = [
            s for s in system.servers.values()
            if s.service_class_name == "Free" and s.allocation is not None
            and s.allocation.accelerator
        ]
        assert not free_allocated, (
            f"{len(premium_unmet)} Premium unallocated while "
            f"{len(free_allocated)} Free hold capacity"
        )
    # every allocated server meets its floor
    for s in system.servers.values():
        if s.allocation is not None and s.allocation.accelerator:
            assert s.allocation.num_replicas >= 1
    assert_solves_as_reference(spec, system)
