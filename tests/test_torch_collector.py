"""Collector behavioral matrix against canned Prometheus results.

The dedicated analogue of the reference's collector suite
(upstream internal/collector/collector_test.go, 584 LoC): every
availability/staleness/fallback branch, the five-query wire shapes, unit
conversions, NaN hygiene, the max-batch preference chain, and both engine
vocabularies — driven through exact query strings so the PromQL the
controller emits is pinned, not approximated.

Port of tests/test_collector.py on the port's modules, the expectations unchanged.
"""

import math
import time

import pytest

from inferno_tpu_torch.config.types import DecodeParms, PrefillParms
from inferno_tpu_torch.controller.collector import (
    DEFAULT_MAX_BATCH,
    STALENESS_LIMIT_SECONDS,
    collect_current_alloc,
    fix_value,
    validate_metrics_availability,
)
from inferno_tpu_torch.controller.crd import (
    ACCELERATOR_LABEL,
    REASON_METRICS_FOUND,
    REASON_METRICS_MISSING,
    REASON_METRICS_STALE,
    REASON_PROMETHEUS_ERROR,
    AcceleratorProfile,
    ConfigMapKeyRef,
    VariantAutoscaling,
    VariantAutoscalingSpec,
)
from inferno_tpu_torch.controller.engines import JETSTREAM, VLLM_TPU
from inferno_tpu_torch.controller.promclient import FakeProm, PromError, Sample
from inferno_tpu_torch.controller.workload import from_deployment, from_leader_worker_set

MODEL = "meta-llama/Llama-3.1-8B"
NS = "workloads"

# Exact wire shapes (pinning these IS the point of this suite).
SEL = f'{{model_name="{MODEL}",namespace="{NS}"}}'
SEL_NONS = f'{{model_name="{MODEL}"}}'
Q_RUNNING = f"vllm:num_requests_running{SEL}"
Q_RUNNING_NONS = f"vllm:num_requests_running{SEL_NONS}"
Q_ARRIVAL = f"sum(rate(vllm:request_success_total{SEL}[1m]))"
Q_IN = (
    f"sum(rate(vllm:request_prompt_tokens_sum{SEL}[1m]))"
    f"/sum(rate(vllm:request_prompt_tokens_count{SEL}[1m]))"
)
Q_OUT = (
    f"sum(rate(vllm:request_generation_tokens_sum{SEL}[1m]))"
    f"/sum(rate(vllm:request_generation_tokens_count{SEL}[1m]))"
)
Q_TTFT = (
    f"sum(rate(vllm:time_to_first_token_seconds_sum{SEL}[1m]))"
    f"/sum(rate(vllm:time_to_first_token_seconds_count{SEL}[1m]))"
)
Q_ITL = (
    f"sum(rate(vllm:time_per_output_token_seconds_sum{SEL}[1m]))"
    f"/sum(rate(vllm:time_per_output_token_seconds_count{SEL}[1m]))"
)
Q_MAXBATCH = f"max(vllm:num_requests_max{SEL})"
Q_MAXBATCH_NONS = f"max(vllm:num_requests_max{SEL_NONS})"


def make_va(max_batch_size=48, acc="v5e-4"):
    return VariantAutoscaling(
        name="llama-premium",
        namespace=NS,
        labels={ACCELERATOR_LABEL: acc},
        spec=VariantAutoscalingSpec(
            model_id=MODEL,
            slo_class_ref=ConfigMapKeyRef(name="service-classes-config", key="Premium"),
            accelerators=[
                AcceleratorProfile(
                    acc=acc, acc_count=1, max_batch_size=max_batch_size, at_tokens=128,
                    decode_parms=DecodeParms(alpha=18.0, beta=0.3),
                    prefill_parms=PrefillParms(gamma=5.0, delta=0.02),
                ),
            ],
        ),
    )


def make_workload(replicas=3):
    return from_deployment({
        "metadata": {"name": "llama-premium", "namespace": NS, "uid": "u1"},
        "spec": {"replicas": replicas},
    })


def seed_five_queries(prom, arrival_rps=5.0, in_tok=128.0, out_tok=96.0,
                      ttft_s=0.05, itl_s=0.02):
    prom.set_result(Q_ARRIVAL, arrival_rps)
    prom.set_result(Q_IN, in_tok)
    prom.set_result(Q_OUT, out_tok)
    prom.set_result(Q_TTFT, ttft_s)
    prom.set_result(Q_ITL, itl_s)


# -- fix_value ---------------------------------------------------------------


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), float("-inf")])
def test_fix_value_sanitizes(bad):
    assert fix_value(bad) == 0.0


def test_fix_value_passthrough():
    assert fix_value(3.25) == 3.25
    assert fix_value(-1.0) == -1.0


# -- validate_metrics_availability ------------------------------------------


def test_available_fresh_namespaced():
    prom = FakeProm()
    prom.set_result(Q_RUNNING, 4.0)
    v = validate_metrics_availability(prom, VLLM_TPU, MODEL, NS)
    assert v.available and v.reason == REASON_METRICS_FOUND
    assert v.running == 4.0
    assert prom.queries == [Q_RUNNING]  # no fallback issued


def test_running_sums_across_pods_with_nan_fixed():
    prom = FakeProm()
    now = time.time()
    prom.results[Q_RUNNING] = [
        Sample(labels={"pod": "a"}, value=2.0, timestamp=now),
        Sample(labels={"pod": "b"}, value=float("nan"), timestamp=now),
        Sample(labels={"pod": "c"}, value=3.5, timestamp=now),
    ]
    v = validate_metrics_availability(prom, VLLM_TPU, MODEL, NS)
    assert v.available and v.running == 5.5


def test_fallback_without_namespace_label():
    """Emulator scrapes carry no namespace label; the namespace-less
    fallback must answer (reference collector.go:113-137)."""
    prom = FakeProm()
    prom.set_result(Q_RUNNING_NONS, 1.0)
    v = validate_metrics_availability(prom, VLLM_TPU, MODEL, NS)
    assert v.available
    assert prom.queries == [Q_RUNNING, Q_RUNNING_NONS]


def test_missing_metrics_reason_and_message():
    v = validate_metrics_availability(FakeProm(), VLLM_TPU, MODEL, NS)
    assert not v.available and v.reason == REASON_METRICS_MISSING
    # the message must be actionable: name the model, namespace, and probe
    assert MODEL in v.message and NS in v.message
    assert "ServiceMonitor" in v.message


def test_prometheus_error_on_primary_query():
    prom = FakeProm()
    prom.set_error(Q_RUNNING, PromError("boom"))
    v = validate_metrics_availability(prom, VLLM_TPU, MODEL, NS)
    assert not v.available and v.reason == REASON_PROMETHEUS_ERROR


def test_prometheus_error_on_fallback_query():
    prom = FakeProm()
    prom.set_error(Q_RUNNING_NONS, PromError("boom"))
    v = validate_metrics_availability(prom, VLLM_TPU, MODEL, NS)
    assert not v.available and v.reason == REASON_PROMETHEUS_ERROR


def test_staleness_boundary():
    fresh = FakeProm()
    fresh.set_result(Q_RUNNING, 1.0, age_seconds=STALENESS_LIMIT_SECONDS - 5)
    assert validate_metrics_availability(fresh, VLLM_TPU, MODEL, NS).available

    stale = FakeProm()
    stale.set_result(Q_RUNNING, 1.0, age_seconds=STALENESS_LIMIT_SECONDS + 5)
    v = validate_metrics_availability(stale, VLLM_TPU, MODEL, NS)
    assert not v.available and v.reason == REASON_METRICS_STALE
    assert "stale" in v.message


def test_one_stale_pod_among_fresh_trips_staleness():
    """Any stale series marks the variant stale — a half-dead scrape
    target must not silently undercount load (collector.go:139-149)."""
    prom = FakeProm()
    now = time.time()
    prom.results[Q_RUNNING] = [
        Sample(labels={"pod": "a"}, value=1.0, timestamp=now),
        Sample(labels={"pod": "b"}, value=1.0,
               timestamp=now - STALENESS_LIMIT_SECONDS - 60),
    ]
    v = validate_metrics_availability(prom, VLLM_TPU, MODEL, NS)
    assert not v.available and v.reason == REASON_METRICS_STALE


# -- collect_current_alloc ---------------------------------------------------


def test_happy_path_units_and_fields():
    prom = FakeProm()
    seed_five_queries(prom, arrival_rps=5.0, in_tok=128.0, out_tok=96.0,
                      ttft_s=0.05, itl_s=0.02)
    prom.set_result(Q_MAXBATCH, 64.0)
    alloc = collect_current_alloc(prom, VLLM_TPU, make_va(), make_workload(3), 10.0)

    assert alloc.accelerator == "v5e-4"
    assert alloc.num_replicas == 3
    assert alloc.variant_cost == pytest.approx(30.0)  # replicas x unit cost
    assert alloc.load.arrival_rate == pytest.approx(300.0)  # 5 rps -> req/min
    assert alloc.load.avg_input_tokens == pytest.approx(128.0)
    assert alloc.load.avg_output_tokens == pytest.approx(96.0)
    assert alloc.ttft_average == pytest.approx(50.0)  # s -> ms
    assert alloc.itl_average == pytest.approx(20.0)
    assert alloc.max_batch == 64  # engine-reported wins


def test_query_shapes_are_exact():
    """The five collection queries (plus max-batch) hit Prometheus with
    exactly the documented shapes: sum(rate(..[1m])) and ratio-of-rates
    (reference collector.go:170-209)."""
    prom = FakeProm()
    seed_five_queries(prom)
    prom.set_result(Q_MAXBATCH, 64.0)
    collect_current_alloc(prom, VLLM_TPU, make_va(), make_workload(), 10.0)
    assert prom.queries == [Q_ARRIVAL, Q_IN, Q_OUT, Q_TTFT, Q_ITL, Q_MAXBATCH]


def test_max_batch_preference_chain():
    # 1) engine-reported present -> wins over profile
    prom = FakeProm()
    seed_five_queries(prom)
    prom.set_result(Q_MAXBATCH, 96.0)
    assert collect_current_alloc(
        prom, VLLM_TPU, make_va(max_batch_size=48), make_workload(), 10.0
    ).max_batch == 96

    # 2) engine series absent -> CR profile for the current accelerator
    prom = FakeProm()
    seed_five_queries(prom)
    assert collect_current_alloc(
        prom, VLLM_TPU, make_va(max_batch_size=48), make_workload(), 10.0
    ).max_batch == 48

    # 3) profile zero -> last-resort constant (the reference's TODO value)
    prom = FakeProm()
    seed_five_queries(prom)
    assert collect_current_alloc(
        prom, VLLM_TPU, make_va(max_batch_size=0), make_workload(), 10.0
    ).max_batch == DEFAULT_MAX_BATCH


def test_max_batch_namespaceless_fallback():
    prom = FakeProm()
    seed_five_queries(prom)
    prom.set_result(Q_MAXBATCH_NONS, 72.0)
    alloc = collect_current_alloc(prom, VLLM_TPU, make_va(), make_workload(), 10.0)
    assert alloc.max_batch == 72
    assert Q_MAXBATCH in prom.queries and Q_MAXBATCH_NONS in prom.queries


def test_max_batch_query_error_is_advisory():
    """A failing max-batch query must not fail the collection — batch is
    advisory; the chain falls through to the CR profile."""
    prom = FakeProm()
    seed_five_queries(prom)
    prom.set_error(Q_MAXBATCH, PromError("boom"))
    prom.set_error(Q_MAXBATCH_NONS, PromError("boom"))
    alloc = collect_current_alloc(
        prom, VLLM_TPU, make_va(max_batch_size=48), make_workload(), 10.0
    )
    assert alloc.max_batch == 48


@pytest.mark.parametrize("failing", [Q_ARRIVAL, Q_IN, Q_OUT, Q_TTFT, Q_ITL])
def test_any_core_query_failure_propagates(failing):
    """Unlike max-batch, the five core queries are load-bearing: a failure
    raises so the caller skips the variant this cycle (collector.go:158+)."""
    prom = FakeProm()
    seed_five_queries(prom)
    prom.set_error(failing, PromError("down"))
    with pytest.raises(PromError):
        collect_current_alloc(prom, VLLM_TPU, make_va(), make_workload(), 10.0)


def test_nan_rates_collapse_to_zero():
    """0/0 rate ratios (idle engine) arrive as NaN and must read as 0,
    not poison the sizing (reference FixValue, collector.go:281-285)."""
    prom = FakeProm()
    seed_five_queries(prom, arrival_rps=0.0)
    for q in (Q_IN, Q_OUT, Q_TTFT, Q_ITL):
        prom.set_result(q, float("nan"))
    alloc = collect_current_alloc(prom, VLLM_TPU, make_va(), make_workload(), 10.0)
    assert alloc.load.arrival_rate == 0.0
    assert alloc.load.avg_input_tokens == 0.0
    assert alloc.load.avg_output_tokens == 0.0
    assert alloc.ttft_average == 0.0 and alloc.itl_average == 0.0


def test_zero_replica_workload_costs_nothing():
    prom = FakeProm()
    seed_five_queries(prom)
    alloc = collect_current_alloc(prom, VLLM_TPU, make_va(), make_workload(0), 10.0)
    assert alloc.num_replicas == 0 and alloc.variant_cost == 0.0


def test_lws_replicas_count_groups_not_pods():
    """A v5e-16 LeaderWorkerSet spans 4 hosts; spec.replicas counts GROUPS
    and that is what CurrentAlloc must report (replaces the reference's
    1-replica=1-pod assumption, collector.go:243-244)."""
    prom = FakeProm()
    seed_five_queries(prom)
    lws = from_leader_worker_set({
        "metadata": {"name": "llama-premium", "namespace": NS, "uid": "u2"},
        "spec": {"replicas": 2, "leaderWorkerTemplate": {"size": 4}},
    })
    assert lws.group_size == 4
    alloc = collect_current_alloc(prom, VLLM_TPU, make_va(acc="v5e-16"),
                                  lws, 40.0)
    assert alloc.num_replicas == 2  # groups, never 8 pods
    assert alloc.variant_cost == pytest.approx(80.0)


def test_jetstream_vocabulary():
    """The same collection against the JetStream metric family: series
    names and the `id` model label all switch (engines.py JETSTREAM);
    nothing vLLM-flavored may appear on the wire."""
    sel = f'{{id="{MODEL}",namespace="{NS}"}}'
    q_arrival = f"sum(rate(jetstream_request_success_count{sel}[1m]))"
    q_in = (
        f"sum(rate(jetstream_request_input_length_sum{sel}[1m]))"
        f"/sum(rate(jetstream_request_input_length_count{sel}[1m]))"
    )
    q_out = (
        f"sum(rate(jetstream_request_output_length_sum{sel}[1m]))"
        f"/sum(rate(jetstream_request_output_length_count{sel}[1m]))"
    )
    q_ttft = (
        f"sum(rate(jetstream_time_to_first_token_sum{sel}[1m]))"
        f"/sum(rate(jetstream_time_to_first_token_count{sel}[1m]))"
    )
    q_itl = (
        f"sum(rate(jetstream_time_per_output_token_sum{sel}[1m]))"
        f"/sum(rate(jetstream_time_per_output_token_count{sel}[1m]))"
    )
    q_slots = f"max(jetstream_total_slots{sel})"
    prom = FakeProm()
    prom.set_result(q_arrival, 2.0)
    prom.set_result(q_in, 256.0)
    prom.set_result(q_out, 64.0)
    prom.set_result(q_ttft, 0.1)
    prom.set_result(q_itl, 0.03)
    prom.set_result(q_slots, 128.0)
    alloc = collect_current_alloc(prom, JETSTREAM, make_va(), make_workload(1), 10.0)
    assert alloc.load.arrival_rate == pytest.approx(120.0)
    assert alloc.max_batch == 128
    assert all("vllm" not in q for q in prom.queries)


def test_validation_jetstream_vocabulary():
    prom = FakeProm()
    prom.set_result(f'jetstream_slots_used_percentage{{id="{MODEL}",namespace="{NS}"}}', 0.4)
    v = validate_metrics_availability(prom, JETSTREAM, MODEL, NS)
    assert v.available and v.running == pytest.approx(0.4)
