"""The port's spot columns of the batched solve and its storm replays
(inferno_tpu_torch.spot.scenarios) on the CPU.

Inside the port (the counterparts of the batch and storm cases of
tests/test_spot.py): T=1 with a spot tier ≡ the live `calculate_fleet` +
`solve_unlimited`, spot replicas included; storm schedules seeded and
independent of which storms ride along; pre-positioning strictly cuts
violation-seconds at a cost overhead of at most 10%; the storm ensemble's
member 0 equals the single replay.

Against the JAX reference: storm schedules bit-identical for the same
seeds, and the storm reports (single and ensemble) equal as documents on
fleets whose batch surfaces show no ceil-boundary cell. The closed-loop
storm comparison on the emulator waits for the port's emulator.
"""

import dataclasses

import numpy as np
import pytest
import torch

from inferno_tpu.config.types import CapacitySpec as RefCapacitySpec
from inferno_tpu.config.types import SpotPoolSpec as RefSpotPoolSpec
from inferno_tpu.core import System as RefSystem
from inferno_tpu.parallel import reset_fleet_state as ref_reset_fleet_state
from inferno_tpu.testing.fleet import fleet_system_spec as ref_fleet_system_spec
from inferno_tpu_torch.config.types import CapacitySpec, SpotPoolSpec
from inferno_tpu_torch.core import System
from inferno_tpu_torch.parallel import (
    calculate_fleet,
    calculate_fleet_batch,
    reset_fleet_state,
)
from inferno_tpu_torch.planner.scenarios import base_rates_from_system, diurnal
from inferno_tpu_torch.solver.solver import solve_unlimited
from inferno_tpu_torch.spot import (
    STORM_GENERATORS,
    build_storms,
    replay_spot_storm,
    replay_spot_storm_ensemble,
    storm_ensemble_seeds,
)
from inferno_tpu_torch.testing.fleet import fleet_system_spec
from test_torch_planner import CPU, REF, both_batches, port_spec

CHEAP_HAZARD = SpotPoolSpec(discount=0.5, hazard_per_hr=0.001, blast_radius=0.5,
                            recovery_s=180.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_fleet_state():
    reset_fleet_state()
    ref_reset_fleet_state()
    yield
    reset_fleet_state()
    ref_reset_fleet_state()


def bench_tier(cls=SpotPoolSpec):
    """The canonical tier of the reference's storm bench: premium 0.005 x
    0.06 x 0.5 h x 1000 = 0.15 < the 0.3 discount, so the whole fleet
    rides spot and the pre-positioned run differs by the held headroom."""
    return cls(discount=0.3, hazard_per_hr=0.005, blast_radius=0.06,
               recovery_s=1800.0)


def _ref_storm_spec(n, shapes=2):
    spec = ref_fleet_system_spec(n, shapes_per_variant=shapes)
    spec.capacity = RefCapacitySpec(chips={}, spot={"v5e": bench_tier(RefSpotPoolSpec)})
    return spec


def _canonical_storm(storm_mod, steps, step_seconds, blast=0.06):
    """The reference bench's storm: seed 7's spot_reclaim with every
    realized reclaim pinned inside the blast radius."""
    storm = storm_mod.build_storms(["spot_reclaim"], ["v5e"], steps, step_seconds,
                                   seed=7)[0]
    return dataclasses.replace(storm, events=tuple(
        dataclasses.replace(e, fraction=min(e.fraction, blast))
        for e in storm.events))


def test_batch_t1_spot_parity_with_live_solve():
    spec = fleet_system_spec(30, shapes_per_variant=3, priority_classes=3)
    spec.capacity = CapacitySpec(chips={}, spot={"v5e": CHEAP_HAZARD})
    system = System(spec)
    result = calculate_fleet_batch(system, base_rates_from_system(system)[None, :], **CPU)
    assert result.spot_replicas is not None and result.required is not None
    live = System(spec)
    calculate_fleet(live, **CPU)
    solve_unlimited(live)
    for j, (name, server) in enumerate(live.servers.items()):
        a = server.allocation
        got = ((-1, 0, 0) if a is None or not a.accelerator
               else (result.accelerators.index(a.accelerator), a.num_replicas,
                     a.spot_replicas))
        want = (int(result.choice[0, j]), int(result.replicas[0, j]),
                int(result.spot_replicas[0, j]))
        assert got == want, name


def test_batch_without_spot_carries_no_spot_columns():
    system = System(fleet_system_spec(10, shapes_per_variant=1))
    result = calculate_fleet_batch(system, base_rates_from_system(system)[None, :], **CPU)
    assert result.spot_replicas is None and result.required is None


def test_storm_schedules_are_seed_deterministic_regardless_of_selection():
    alone = build_storms(["zone_outage"], ["v5e"], 48, 600.0, seed=3)
    together = build_storms([], ["v5e"], 48, 600.0, seed=3)
    assert alone[0].events == together[list(STORM_GENERATORS).index("zone_outage")].events
    rev = build_storms(["zone_outage", "spot_reclaim"], ["v5e"], 48, 600.0, seed=3)
    fwd = build_storms(["spot_reclaim", "zone_outage"], ["v5e"], 48, 600.0, seed=3)
    assert rev[0].events == fwd[1].events and rev[1].events == fwd[0].events
    with pytest.raises(ValueError, match="unknown storm"):
        build_storms(["quake"], ["v5e"], 48, 600.0)


def test_storm_schedule_reproducible_and_seed_sensitive():
    a = build_storms(["spot_reclaim"], ["v5e"], 96, 600.0, seed=11)[0]
    b = build_storms(["spot_reclaim"], ["v5e"], 96, 600.0, seed=11)[0]
    c = build_storms(["spot_reclaim"], ["v5e"], 96, 600.0, seed=12)[0]
    assert a.events == b.events and a.events != c.events


@pytest.mark.parametrize("pools", [["v5e"], ["v5e", "v6e"]])
def test_storm_schedules_bit_identical_to_reference(pools):
    from inferno_tpu.spot import scenarios as ref_scenarios

    for seed in (0, 7, 11):
        port = build_storms([], pools, 48, 600.0, seed=seed)
        ref = ref_scenarios.build_storms([], pools, 48, 600.0, seed=seed)
        assert [(s.name, s.seed) for s in port] == [(s.name, s.seed) for s in ref]
        for a, b in zip(port, ref):
            assert [dataclasses.astuple(e) for e in a.events] == [
                dataclasses.astuple(e) for e in b.events]
    for name in STORM_GENERATORS:
        assert storm_ensemble_seeds(name, 7, 5) == ref_scenarios.storm_ensemble_seeds(
            name, 7, 5)


def test_replay_spot_storm_prepositioning_cuts_violations():
    spec = fleet_system_spec(60, shapes_per_variant=2)
    spec.capacity = CapacitySpec(chips={}, spot={"v5e": bench_tier()})
    system = System(spec)
    trace = diurnal(base_rates_from_system(system), 24, 600.0, seed=0)
    from inferno_tpu_torch.spot import scenarios

    schedule = _canonical_storm(scenarios, 24, 600.0)
    report = replay_spot_storm(spec, trace, schedule, **CPU)
    reactive, prepos = report["reactive"], report["prepositioned"]
    assert reactive["violation_seconds"] > 0
    assert prepos["violation_seconds"] < reactive["violation_seconds"]
    assert prepos["restored_replica_steps"] > 0
    assert 0 < report["cost_delta_pct"] <= 10.0
    assert reactive["evicted_replica_steps"] >= prepos["evicted_replica_steps"]
    reset_fleet_state()
    assert replay_spot_storm(spec, trace, schedule, **CPU) == report


def test_replay_spot_storm_matches_reference():
    """The reference bench's configuration cut to 48 variants: the whole
    storm report equals the reference's."""
    from inferno_tpu.spot import scenarios as ref_scenarios
    from inferno_tpu_torch.spot import scenarios

    ref_spec = _ref_storm_spec(48)
    spec = port_spec(ref_spec)
    trace = diurnal(base_rates_from_system(System(spec)), 48, 600.0, seed=0)
    _, ref_res, _, port_res = both_batches(ref_spec, trace.rates)
    assert (port_res.replicas == ref_res.replicas).all(), "boundary cell"
    port = replay_spot_storm(spec, trace, _canonical_storm(scenarios, 48, 600.0), **CPU)
    ref = ref_scenarios.replay_spot_storm(
        ref_spec, trace, _canonical_storm(ref_scenarios, 48, 600.0), **REF)
    assert port["violation_s_saved"] > 0
    assert port == ref


def test_spot_storm_ensemble_envelopes_and_reference():
    """Storm seeds as an ensemble axis: placements solved once, member 0
    identical to the single-schedule replay, envelopes ordered, and the
    document equal to the reference's."""
    from inferno_tpu.spot import scenarios as ref_scenarios

    ref_spec = ref_fleet_system_spec(30, shapes_per_variant=2)
    ref_spec.capacity = RefCapacitySpec(chips={}, spot={"v5e": bench_tier(RefSpotPoolSpec)})
    spec = port_spec(ref_spec)
    trace = diurnal(base_rates_from_system(System(spec)), 16, 600.0, seed=0)
    rep = replay_spot_storm_ensemble(spec, trace, "spot_reclaim", seeds=4, base_seed=7,
                                     **CPU)
    assert rep["seeds"] == 4 and len(rep["per_seed"]["storm_seed"]) == 4
    for block in (rep["reactive"], rep["prepositioned"]):
        env = block["violation_seconds"]
        assert env["p50"] <= env["p95"] <= env["p99"] <= env["max"]
    reset_fleet_state()
    schedule = build_storms(["spot_reclaim"], ["v5e"], 16, 600.0, seed=7)[0]
    assert schedule.seed == storm_ensemble_seeds("spot_reclaim", 7, 1)[0]
    single = replay_spot_storm(spec, trace, schedule, **CPU)
    assert (rep["per_seed"]["reactive_violation_s"][0]
            == single["reactive"]["violation_seconds"])
    assert rep["per_seed"]["violation_s_saved"][0] == single["violation_s_saved"]
    reset_fleet_state()
    assert replay_spot_storm_ensemble(spec, trace, "spot_reclaim", seeds=4,
                                      base_seed=7, **CPU) == rep
    with pytest.raises(ValueError, match="unknown storm"):
        replay_spot_storm_ensemble(spec, trace, "nope", seeds=2, **CPU)

    _, ref_res, _, port_res = both_batches(ref_spec, trace.rates)
    assert (port_res.replicas == ref_res.replicas).all(), "boundary cell"
    ref = ref_scenarios.replay_spot_storm_ensemble(
        ref_spec, trace, "spot_reclaim", seeds=4, base_seed=7, **REF)
    assert rep == ref


def test_storm_replay_needs_a_spot_tier():
    spec = fleet_system_spec(6, shapes_per_variant=1)
    trace = diurnal(base_rates_from_system(System(spec)), 4, 600.0, seed=0)
    schedule = build_storms(["spot_reclaim"], ["v5e"], 4, 600.0, seed=0)[0]
    with pytest.raises(ValueError, match="spot tier"):
        replay_spot_storm(spec, trace, schedule, **CPU)


def test_evaluate_storms_matches_reference_on_shared_placements():
    """evaluate_storms alone, on each package's own placement of the same
    trace, with a zone outage as well as a reclaim."""
    from inferno_tpu.parallel import calculate_fleet_batch as ref_cfb
    from inferno_tpu.spot import scenarios as ref_scenarios
    from inferno_tpu_torch.spot.scenarios import evaluate_storms

    ref_spec = _ref_storm_spec(24)
    spec = port_spec(ref_spec)
    port_sys, ref_sys = System(spec), RefSystem(ref_spec)
    trace = diurnal(base_rates_from_system(port_sys), 24, 600.0, seed=3)
    port_res = calculate_fleet_batch(port_sys, trace.rates, **CPU)
    ref_res = ref_cfb(ref_sys, trace.rates, **REF)
    np.testing.assert_array_equal(port_res.replicas, ref_res.replicas)
    for storm in build_storms([], ["v5e"], 24, 600.0, seed=5):
        ref_storm = [s for s in ref_scenarios.build_storms([], ["v5e"], 24, 600.0, seed=5)
                     if s.name == storm.name][0]
        for pre in (False, True):
            assert evaluate_storms(port_sys, port_res, storm, pre) == (
                ref_scenarios.evaluate_storms(ref_sys, ref_res, ref_storm, pre))
