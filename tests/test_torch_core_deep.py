"""Port of tests/test_core_deep.py, on the port's imports.

Deep table-driven tests of the allocation economics and System registry.

The weight-class analogue of the reference's largest unit suite
(the upstream Go project's pkg/core/system_test.go, 1675 LoC): the sizing formula
piece by piece — batch scaling by output length, the chip-cost formula,
replica arithmetic, TPS-target sizing, SLO feasibility at the chosen
operating point, saturation, transition penalties from every starting
state, pool accounting, and the desired/current allocation lifecycle.

The held System, create_allocation, transition_penalty and allocation_diff
of test_torch_core run every call on the reference too (same spec, same
arguments) and require exact agreement; `on_both` does the same for the
server and pool calls, and `held` for an Allocation's own methods.
"""

import math

import pytest

from test_torch_core import (
    LLAMA8B,
    System,
    allocation_diff,
    create_allocation,
    held,
    make_accelerators,
    make_perf,
    make_server,
    make_service_classes,
    make_system_spec,
    on_both,
    transition_penalty,
)
from inferno_tpu_torch.config.defaults import (
    ACCEL_PENALTY_FACTOR,
    DEFAULT_SERVICE_CLASS_NAME,
    DEFAULT_SERVICE_CLASS_PRIORITY,
)
from inferno_tpu_torch.config.types import (
    AllocationData,
    DecodeParms,
    DisaggSpec,
    ModelPerfSpec,
    ModelTarget,
    PowerSpec,
    PrefillParms,
    ServiceClassSpec,
    SystemSpec,
)
from inferno_tpu_torch.core.allocation import Allocation

SRV = "default/llama-premium"


def sized(system, acc="v5e-4", server=SRV) -> Allocation:
    alloc = create_allocation(system, server, acc)
    assert alloc is not None, f"expected feasible allocation on {acc}"
    return alloc


# -- batch-size selection (reference allocation.go:78-87) --------------------


def test_batch_scales_inversely_with_output_length():
    """batch = maxBatchSize * atTokens / K: the profile's max batch was
    measured at `at_tokens`-sized requests; longer completions hold slots
    longer, shrinking the effective concurrency."""
    sys_short = System(make_system_spec([make_server(out_tokens=64)]))
    sys_ref = System(make_system_spec([make_server(out_tokens=128)]))
    sys_long = System(make_system_spec([make_server(out_tokens=256)]))
    # v5e-4 profile: max_batch 64 at 128 tokens
    assert sized(sys_short).batch_size == 128
    assert sized(sys_ref).batch_size == 64
    assert sized(sys_long).batch_size == 32


def test_server_max_batch_override_wins():
    spec = make_system_spec([make_server(out_tokens=256)])
    spec.servers[0].max_batch_size = 48
    assert sized(System(spec)).batch_size == 48


def test_batch_floors_at_one_while_feasible():
    # 64 * 128 // 8192 == 1: the floor holds as long as the SLO is servable
    sys = System(make_system_spec([make_server(out_tokens=8192)]))
    assert sized(sys).batch_size == 1
    # absurd lengths make even batch 1 unservable: infeasible, not batch 0
    sys = System(make_system_spec([make_server(out_tokens=100_000)]))
    assert create_allocation(sys, SRV, "v5e-4") is None


# -- replica arithmetic & cost (reference allocation.go:133-145) -------------


def test_replica_count_is_ceil_of_rate_over_lambda_star():
    sys = System(make_system_spec([make_server(arrival_rate=600.0)]))
    alloc = sized(sys)
    lam_star = alloc.max_arrv_rate_per_replica * 1000.0  # req/sec
    assert alloc.num_replicas == math.ceil((600.0 / 60.0) / lam_star)


def test_replicas_monotone_in_load():
    replicas = [
        sized(System(make_system_spec([make_server(arrival_rate=r)]))).num_replicas
        for r in (60.0, 600.0, 3000.0, 12000.0)
    ]
    assert replicas == sorted(replicas)
    assert replicas[-1] > replicas[0]


def test_cost_formula_chips_times_chip_rate():
    """cost = replicas x slices/replica x chips x cents/chip-hr
    (reference allocation.go:143-145 with chips replacing multiplicity)."""
    sys = System(make_system_spec([make_server(arrival_rate=3000.0)]))
    a4 = sized(sys, "v5e-4")
    assert a4.cost == pytest.approx(a4.num_replicas * 1 * 4 * 10.0)
    a8 = sized(sys, "v5p-8")
    assert a8.cost == pytest.approx(a8.num_replicas * 1 * 8 * 16.25)


def test_multi_slice_replica_multiplies_cost():
    spec = make_system_spec()
    for perf in spec.models:
        perf.slices_per_replica = 2
    sys2 = System(spec)
    sys1 = System(make_system_spec())
    a1, a2 = sized(sys1), sized(sys2)
    assert a1.num_replicas == a2.num_replicas  # sizing unchanged
    assert a2.cost == pytest.approx(2 * a1.cost)


def test_min_replicas_floor_applies():
    spec = make_system_spec([make_server(arrival_rate=1.0, min_replicas=5)])
    assert sized(System(spec)).num_replicas == 5


def test_tps_target_sizes_by_token_throughput():
    """With an slo-tps target the driving rate is tokens/sec / K, not the
    observed arrival rate (reference allocation.go:133-141)."""
    spec = make_system_spec([make_server(arrival_rate=1.0, out_tokens=128)])
    spec.service_classes = [
        ServiceClassSpec(
            name="Premium",
            priority=1,
            model_targets=[
                ModelTarget(model=LLAMA8B, slo_itl=24.0, slo_ttft=500.0,
                            slo_tps=2560.0)
            ],
        )
    ]
    alloc = sized(System(spec))
    lam_star = alloc.max_arrv_rate_per_replica * 1000.0
    # total rate = 2560 tok/s / 128 tok/req = 20 req/s, regardless of the
    # 1-req/min observed arrivals
    assert alloc.num_replicas == math.ceil(20.0 / lam_star)
    assert alloc.num_replicas > 1


# -- SLOs hold at the chosen operating point ---------------------------------


@pytest.mark.parametrize("acc", ["v5e-4", "v5p-8", "v5e-16"])
def test_operating_point_meets_slo(acc):
    sys = System(make_system_spec([make_server(arrival_rate=1200.0)]))
    alloc = sized(sys, acc)
    assert 0.0 < alloc.itl <= 24.0 + 1e-9
    # TTFT targets bind at the SLO percentile, so the *mean* sits below
    assert 0.0 < alloc.ttft < 500.0
    assert 0.0 < alloc.rho <= 1.0


def test_infeasible_itl_slo_returns_none():
    """alpha alone exceeding the ITL target can never be served."""
    spec = make_system_spec()
    spec.service_classes = [
        ServiceClassSpec(
            name="Premium", priority=1,
            model_targets=[ModelTarget(model=LLAMA8B, slo_itl=5.0, slo_ttft=500.0)],
        )
    ]
    # v5e-4 alpha=18 > 5ms: infeasible; v5p-8 alpha=10 > 5: infeasible too
    assert create_allocation(System(spec), SRV, "v5e-4") is None
    assert create_allocation(System(spec), SRV, "v5p-8") is None


def test_negative_load_fields_return_none():
    spec = make_system_spec()
    spec.servers[0].current_alloc.load.arrival_rate = -1.0
    assert create_allocation(System(spec), SRV, "v5e-4") is None


# -- saturation (reference allocation.go:233-256, server.go:144-146) ---------


def test_max_rpm_unit_conversion():
    alloc = held(Allocation(accelerator="v5e-4", num_replicas=2, batch_size=8,
                            cost=80.0, max_arrv_rate_per_replica=0.005))
    assert alloc.max_rpm == pytest.approx(0.005 * 1000.0 * 60.0)


def test_saturated_boundary():
    alloc = held(Allocation(accelerator="v5e-4", num_replicas=2, batch_size=8,
                            cost=80.0, max_arrv_rate_per_replica=0.005))
    cap_rpm = 2 * alloc.max_rpm
    assert not alloc.saturated(cap_rpm)  # at capacity: not saturated
    assert alloc.saturated(cap_rpm + 1e-6)


def test_sized_allocation_not_saturated_by_its_own_load():
    sys = System(make_system_spec([make_server(arrival_rate=2400.0)]))
    alloc = sized(sys)
    on_both(sys, lambda s, a: s.servers[SRV].set_allocation(a), alloc)
    assert not on_both(sys, lambda s: s.servers[SRV].saturated())


# -- zero load (reference allocation.go:259-288) -----------------------------


def test_zero_load_holds_min_replicas_with_batch1_latencies():
    spec = make_system_spec([make_server(arrival_rate=0.0, min_replicas=2)])
    alloc = sized(System(spec))
    assert alloc.num_replicas == 2
    assert alloc.cost == pytest.approx(2 * 4 * 10.0)
    assert alloc.itl == pytest.approx(18.0 + 0.3)  # alpha + beta at batch 1
    assert alloc.ttft == pytest.approx(5.0 + 0.02)  # gamma + delta
    assert alloc.rho == 0.0
    assert alloc.max_arrv_rate_per_replica > 0  # idle capacity is nonzero


def test_zero_output_tokens_treated_as_zero_load():
    spec = make_system_spec([make_server(arrival_rate=120.0, out_tokens=0)])
    alloc = sized(System(spec))
    assert alloc.num_replicas == spec.servers[0].min_num_replicas


def test_scale_to_zero_yields_empty_allocation():
    spec = make_system_spec([make_server(arrival_rate=0.0, min_replicas=0)])
    alloc = sized(System(spec))
    assert alloc.accelerator == "" and alloc.num_replicas == 0
    assert alloc.cost == 0.0


# -- disaggregated units -----------------------------------------------------


def disagg_spec() -> SystemSpec:
    spec = make_system_spec([make_server(arrival_rate=600.0)])
    spec.models = [
        ModelPerfSpec(
            name=LLAMA8B, acc="v5e-4", slices_per_replica=1,
            max_batch_size=64, at_tokens=128,
            decode_parms=DecodeParms(alpha=18.0, beta=0.3),
            prefill_parms=PrefillParms(gamma=5.0, delta=0.02),
            disagg=DisaggSpec(prefill_slices=1, decode_slices=3),
        )
    ]
    return spec


def test_disagg_unit_footprint_multiplies_cost():
    """A disaggregated replica is an atomic prefill+decode unit: 4 slices
    of v5e-4 -> 16 chips per replica in the cost and pool arithmetic."""
    sys = System(disagg_spec())
    assert on_both(sys, lambda s: s.models[LLAMA8B].slices_per_replica("v5e-4")) == 4
    alloc = sized(sys)
    assert alloc.cost == pytest.approx(alloc.num_replicas * 4 * 4 * 10.0)


def test_disagg_zero_load_rate_binds_on_slowest_stage():
    spec = disagg_spec()
    spec.servers = [make_server(arrival_rate=0.0, min_replicas=1)]
    alloc = sized(System(spec))
    batch = 64
    decode_full = 18.0 + 0.3 * batch
    prefill_full = 5.0 + 0.02 * batch
    expect = min(1 * batch / prefill_full, 3 * batch / decode_full)
    assert alloc.max_arrv_rate_per_replica == pytest.approx(expect)


# -- transition penalties (reference allocation.go:291-300) ------------------


def test_penalty_same_shape_same_count_is_free():
    a = Allocation(accelerator="v5e-4", num_replicas=3, batch_size=8, cost=120.0)
    assert transition_penalty(a, a.clone()) == 0.0


def test_penalty_same_shape_scaling_is_cost_delta():
    a = Allocation(accelerator="v5e-4", num_replicas=3, batch_size=8, cost=120.0)
    b = Allocation(accelerator="v5e-4", num_replicas=5, batch_size=8, cost=200.0)
    assert transition_penalty(a, b) == pytest.approx(80.0)
    assert transition_penalty(b, a) == pytest.approx(-80.0)  # scale-in credit


def test_penalty_shape_change_taxes_both_costs():
    a = Allocation(accelerator="v5e-4", num_replicas=3, batch_size=8, cost=120.0)
    b = Allocation(accelerator="v5p-8", num_replicas=1, batch_size=8, cost=130.0)
    assert transition_penalty(a, b) == pytest.approx(
        ACCEL_PENALTY_FACTOR * (120.0 + 130.0) + 10.0
    )


def test_penalty_from_fresh_server_taxes_like_shape_change():
    """A fresh server (empty current accelerator) pays the provisioning
    tax on the way in — spinning up a pod-slice is not free."""
    fresh = Allocation(accelerator="", num_replicas=0, batch_size=0, cost=0.0)
    b = Allocation(accelerator="v5e-4", num_replicas=2, batch_size=8, cost=80.0)
    assert transition_penalty(fresh, b) == pytest.approx(
        ACCEL_PENALTY_FACTOR * 80.0 + 80.0
    )


# -- server candidate generation ---------------------------------------------


def test_keep_accelerator_with_vanished_shape_falls_back_to_all():
    spec = make_system_spec()
    spec.servers[0].keep_accelerator = True
    spec.servers[0].current_alloc = AllocationData(
        accelerator="v4-8", num_replicas=1,
        load=spec.servers[0].current_alloc.load,
    )
    sys = System(spec)
    # pinned shape is not in the catalog for this system: all candidates
    assert on_both(sys, lambda s: set(s.servers[SRV].candidate_accelerators(s))) == {
        "v5e-4", "v5p-8", "v5e-16"
    }


def test_unknown_service_class_uses_default_priority():
    spec = make_system_spec()
    spec.servers[0].class_name = "NoSuchClass"
    sys = System(spec)
    assert on_both(sys, lambda s: s.servers[SRV].priority(s)) == DEFAULT_SERVICE_CLASS_PRIORITY


def test_empty_class_name_falls_back_to_default_class():
    spec = make_system_spec()
    spec.servers[0].class_name = ""
    sys = System(spec)
    assert on_both(sys, lambda s: s.servers[SRV].service_class_name) \
        == DEFAULT_SERVICE_CLASS_NAME


def test_calculate_all_sets_flag_and_fills_candidates():
    sys = System(make_system_spec())
    assert not on_both(sys, lambda s: s.candidates_calculated)
    on_both(sys, lambda s: s.calculate_all())
    assert on_both(sys, lambda s: s.candidates_calculated)
    on_both(sys, lambda s: s.servers[SRV].all_allocations)
    assert set(sys.servers[SRV].all_allocations) == {"v5e-4", "v5p-8", "v5e-16"}
    for alloc in sys.servers[SRV].all_allocations.values():
        # values are transition penalties from the (empty) current alloc
        assert alloc.value == pytest.approx(
            ACCEL_PENALTY_FACTOR * alloc.cost + alloc.cost
        )


# -- allocation lifecycle (reference server.go:148-161) ----------------------


def test_desired_alloc_lifecycle_and_promotion():
    sys = System(make_system_spec())
    server = sys.servers[SRV]
    alloc = sized(sys)
    on_both(sys, lambda s, a: s.servers[SRV].set_allocation(a), alloc)
    on_both(sys, lambda s: s.servers[SRV].spec.desired_alloc)
    assert server.spec.desired_alloc.accelerator == "v5e-4"
    assert server.spec.desired_alloc.load.arrival_rate == 120.0  # load rides along

    on_both(sys, lambda s: s.servers[SRV].apply_desired_alloc())
    on_both(sys, lambda s: s.servers[SRV].cur_allocation)
    assert server.cur_allocation.accelerator == "v5e-4"
    assert server.cur_allocation.num_replicas == alloc.num_replicas

    on_both(sys, lambda s: s.servers[SRV].remove_allocation())
    on_both(sys, lambda s: s.servers[SRV].spec.desired_alloc)
    assert server.spec.desired_alloc.accelerator == ""
    assert server.spec.desired_alloc.num_replicas == 0


def test_generate_solution_only_solved_servers():
    spec = make_system_spec([
        make_server(name="a"), make_server(name="b"),
    ])
    sys = System(spec)
    on_both(sys, lambda s, a: s.servers["a"].set_allocation(a), sized(sys, server="a"))
    solution = on_both(sys, lambda s: s.generate_solution())
    assert set(solution) == {"a"}
    assert solution["a"].load.arrival_rate == 120.0


# -- pool accounting (reference system.go:271-300) ---------------------------


def test_allocate_by_pool_multi_pool_chips_cost_watts():
    spec = make_system_spec([
        make_server(name="a"), make_server(name="b"), make_server(name="c"),
    ])
    for acc in spec.accelerators:  # fixtures default to an all-zero PowerSpec
        acc.power = PowerSpec(idle=60.0, full=200.0, mid_power=150.0, mid_util=0.6)
    sys = System(spec)
    alloc_a = sized(sys, "v5e-4", "a")
    alloc_b = sized(sys, "v5p-8", "b")
    on_both(sys, lambda s, a: s.servers["a"].set_allocation(a), alloc_a)
    on_both(sys, lambda s, a: s.servers["b"].set_allocation(a), alloc_b)
    # c: scale-to-zero style empty allocation must not contribute
    on_both(sys, lambda s, a: s.servers["c"].set_allocation(a),
            Allocation(accelerator="", num_replicas=0, batch_size=0, cost=0.0))
    usage = on_both(sys, lambda s: s.allocate_by_pool())
    assert set(usage) == {"v5e", "v5p"}
    assert usage["v5e"].chips == alloc_a.num_replicas * 4
    assert usage["v5p"].chips == alloc_b.num_replicas * 8
    assert usage["v5e"].cost == pytest.approx(alloc_a.cost)
    assert usage["v5p"].cost == pytest.approx(alloc_b.cost)
    assert usage["v5e"].watts > 0 and usage["v5p"].watts > 0
    assert sys.pool_usage is usage


def test_allocate_by_pool_same_pool_accumulates():
    spec = make_system_spec([make_server(name="a"), make_server(name="b")])
    sys = System(spec)
    a = sized(sys, "v5e-4", "a")
    b = sized(sys, "v5e-16", "b")
    on_both(sys, lambda s, x: s.servers["a"].set_allocation(x), a)
    on_both(sys, lambda s, x: s.servers["b"].set_allocation(x), b)
    usage = on_both(sys, lambda s: s.allocate_by_pool())
    assert set(usage) == {"v5e"}  # both shapes draw from the v5e pool
    assert usage["v5e"].chips == a.num_replicas * 4 + b.num_replicas * 16


# -- diffs -------------------------------------------------------------------


def test_allocation_diff_none_cases():
    assert allocation_diff(None, None) is None
    b = Allocation(accelerator="v5e-4", num_replicas=2, batch_size=8, cost=80.0)
    d = allocation_diff(None, b)
    assert d.old_accelerator == "none" and d.new_accelerator == "v5e-4"
    assert d.cost_diff == pytest.approx(80.0)
    empty = Allocation(accelerator="", num_replicas=0, batch_size=0, cost=0.0)
    d2 = allocation_diff(empty, b)
    assert d2.old_accelerator == "none"


# -- spec validation gates ---------------------------------------------------


def test_validation_gates_reject_bad_specs():
    """The validate() gates the analyzers call before touching math: bad
    wire data fails with a named error, not NaNs downstream."""
    import inferno_tpu.analyzer as ref_analyzer
    from inferno_tpu_torch.analyzer import AnalyzerError, build_analyzer, build_disagg_analyzer
    from inferno_tpu_torch.analyzer.queue import RequestSize, TargetPerf
    from test_torch_analyzer import hold

    # each raises on the reference too, with an error of the same type
    build_analyzer = hold(build_analyzer, ref_analyzer.build_analyzer)
    build_disagg_analyzer = hold(build_disagg_analyzer, ref_analyzer.build_disagg_analyzer)

    dec, pre = DecodeParms(alpha=5.0, beta=0.1), PrefillParms(gamma=1.0, delta=0.01)

    with pytest.raises(ValueError):
        DisaggSpec(prefill_slices=0).validate()
    with pytest.raises(ValueError):
        DisaggSpec(prefill_max_batch=-1).validate()
    DisaggSpec().validate()  # defaults are valid

    with pytest.raises(AnalyzerError):
        build_analyzer(max_batch=8, max_queue=80, decode=dec, prefill=pre,
                       request=RequestSize(avg_in_tokens=-1, avg_out_tokens=8))
    with pytest.raises(AnalyzerError):
        build_analyzer(max_batch=8, max_queue=80, decode=dec, prefill=pre,
                       request=RequestSize(avg_in_tokens=8, avg_out_tokens=0))
    with pytest.raises(AnalyzerError):
        build_disagg_analyzer(max_batch=8, max_queue=80, decode=dec, prefill=pre,
                              request=RequestSize(avg_in_tokens=8, avg_out_tokens=8),
                              spec=DisaggSpec(decode_slices=0))
    with pytest.raises(AnalyzerError):
        TargetPerf(target_ttft=-1.0).validate()
