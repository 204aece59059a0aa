"""Sockets-level e2e for DISAGGREGATED serving: a prefill/decode-separated
emulated engine (JetStream vocabulary) behind HTTP -> MiniProm scrape ->
collector -> reconciler sizing the variant with the TANDEM model (and the
batched tandem sizing) -> atomic LeaderWorkerSet group actuation.

The tandem components (analyzer, batched sizing, native backend,
simulation validation) have unit tests of their own; this file runs a
disagg variant through the full loop. It is the disagg counterpart of
test_torch_e2e_http.py's aggregated scenario (itself mirroring the
reference's Kind e2e, upstream test/e2e/e2e_test.go:341-563).

Port of tests/test_e2e_disagg.py on the port's controller and emulator:
the reference's backend "tpu" is "torch" on the CPU here (the plain
versions of the kernels that chip_smoke.py's phase 19 runs on the card),
every Reconciler gets `compute_device="cpu"`, and MiniProm is scraped by
hand; idle is its clock stepped past the rate window.
"""

import json
import threading
import time
import urllib.request

import pytest

from inferno_tpu_torch.config.types import DecodeParms, DisaggSpec, PrefillParms
from inferno_tpu_torch.controller import InMemoryCluster, Reconciler, ReconcilerConfig, VariantAutoscaling
from inferno_tpu_torch.controller.crd import (
    ACCELERATOR_LABEL,
    AcceleratorProfile,
    ConfigMapKeyRef,
    VariantAutoscalingSpec,
)
from inferno_tpu_torch.controller.promclient import HttpPromClient, PromConfig
from inferno_tpu_torch.emulator.disagg import DisaggEngine, DisaggProfile
from inferno_tpu_torch.emulator.server import EmulatorServer

from test_torch_apiserver import (  # noqa: F401 (prom_clock: a fixture)
    E2E_TIME_SCALE as TIME_SCALE,
    go_idle,
    hand_prom,
    prom_clock,
)

MODEL = "meta-llama/Llama-3.1-8B"
NS = "workloads"
CFG_NS = "inferno-system"
VA_NAME = "llama-disagg"

# one replica unit: 1 prefill engine + 2 decode engines (3 pod-slices,
# actuated as one LWS group)
SPEC = DisaggSpec(prefill_slices=1, decode_slices=2, prefill_max_batch=8)
PROFILE = DisaggProfile(
    alpha=18.0, beta=0.3, gamma=5.0, delta=0.02,
    prefill_max_batch=8, decode_max_batch=64,
    prefill_engines=SPEC.prefill_slices, decode_engines=SPEC.decode_slices,
    kv_transfer_ms=2.0,
)


def make_disagg_cluster() -> InMemoryCluster:
    cluster = InMemoryCluster()
    cluster.set_configmap(CFG_NS, "accelerator-unit-costs", {
        "v5e-4": json.dumps({"cost": 10.0}),
    })
    cluster.set_configmap(CFG_NS, "service-classes-config", {
        "premium.yaml": (
            "name: Premium\npriority: 1\ndata:\n"
            f"  - model: {MODEL}\n    slo-ttft: 500\n    slo-tpot: 24\n"
        ),
    })
    cluster.set_configmap(CFG_NS, "inferno-autoscaler-config", {
        "GLOBAL_OPT_INTERVAL": "30s",
    })
    va = VariantAutoscaling(
        name=VA_NAME,
        namespace=NS,
        labels={ACCELERATOR_LABEL: "v5e-4"},
        spec=VariantAutoscalingSpec(
            model_id=MODEL,
            slo_class_ref=ConfigMapKeyRef(name="service-classes-config", key="Premium"),
            accelerators=[
                AcceleratorProfile(
                    acc="v5e-4", acc_count=1, max_batch_size=64, at_tokens=128,
                    decode_parms=DecodeParms(alpha=PROFILE.alpha, beta=PROFILE.beta),
                    prefill_parms=PrefillParms(gamma=PROFILE.gamma, delta=PROFILE.delta),
                    disagg=SPEC,
                ),
            ],
        ),
    )
    cluster.add_variant_autoscaling(va)
    # the variant is backed by a LeaderWorkerSet whose group size is the
    # unit footprint (prefill + decode engines) — NO Deployment exists, so
    # workload resolution must fall through to the LWS
    cluster.add_leader_worker_set(
        NS, VA_NAME, replicas=1, size=SPEC.slices_per_unit
    )
    return cluster


@pytest.fixture()
def disagg_stack():
    srv = EmulatorServer(
        model_id=MODEL,
        engine_name="jetstream",
        engine=DisaggEngine(PROFILE, time_scale=TIME_SCALE),
    )
    srv.start()
    prom = hand_prom([(f"http://127.0.0.1:{srv.port}/metrics", {"namespace": NS})])
    cluster = make_disagg_cluster()
    rec = Reconciler(
        kube=cluster,
        prom=HttpPromClient(PromConfig(base_url=prom.url, allow_http=True)),
        config=ReconcilerConfig(
            compute_device="cpu",
            config_namespace=CFG_NS,
            compute_backend="torch",  # the batched tandem kernel sizes it
            direct_scale=True,
            engine="jetstream",
            # static profiles: the tandem-sizing equality assertion below
            # must compare against the CR parms, not corrected ones
            profile_correction=False,
        ),
    )
    yield srv, prom, cluster, rec
    prom.stop()
    srv.stop()


def _post_load(port: int, duration_s: float, concurrency: int = 6):
    stop_at = time.time() + duration_s
    url = f"http://127.0.0.1:{port}/v1/chat/completions"
    body = json.dumps({
        "model": MODEL,
        "messages": [{"role": "user", "content": "x " * 64}],
        "max_tokens": 32,
    }).encode()

    def worker():
        while time.time() < stop_at:
            req = urllib.request.Request(
                url, data=body, headers={"Content-Type": "application/json"}
            )
            try:
                urllib.request.urlopen(req, timeout=30).read()
            except OSError:
                return

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def test_disagg_scale_out_atomic_groups_and_back_in(disagg_stack, prom_clock):
    srv, prom, cluster, rec = disagg_stack

    # -- load -> tandem-sized scale-out actuated in whole LWS groups --------
    _post_load(srv.port, duration_s=2.0)
    prom.scrape_once()
    report = rec.run_cycle()
    assert report.errors == [], report.errors

    va = cluster.get_variant_autoscaling(NS, VA_NAME)
    cond = va.status.condition("MetricsAvailable")
    assert cond is not None and cond.status == "True", cond
    cond = va.status.condition("OptimizationReady")
    assert cond is not None and cond.status == "True", cond

    desired_units = va.status.desired_optimized_alloc.num_replicas
    assert desired_units > 1, (desired_units, report)
    # replica units actuate ATOMICALLY: the LWS scales in whole groups of
    # slices_per_unit pods; the group size is never touched
    lws = cluster.get_leader_worker_set(NS, VA_NAME)
    assert lws["spec"]["replicas"] == desired_units
    assert lws["spec"]["leaderWorkerTemplate"]["size"] == SPEC.slices_per_unit
    assert cluster.pod_count(NS, VA_NAME) == desired_units * SPEC.slices_per_unit
    # current replicas were read in GROUP units
    assert va.status.current_alloc.num_replicas == 1
    # owner reference names the LWS kind (GC path, reference :276-293)
    assert va.owner_references and va.owner_references[0]["kind"] == "LeaderWorkerSet"

    # the collector really observed the disagg engine's jetstream series
    assert va.status.current_alloc.load.arrival_rate > 0
    assert va.status.current_alloc.load.avg_output_tokens == pytest.approx(32, rel=0.2)

    # -- the sizing came from the TANDEM model, not the aggregated one ------
    # an aggregated sizing of the same parms serves the same rate with
    # FEWER, cheaper replicas (no prefill-stage bottleneck, no unit
    # footprint): if the tandem path were silently bypassed, desired_units
    # would match the aggregated answer — verify it does not
    from inferno_tpu_torch.analyzer import RequestSize, TargetPerf, build_disagg_analyzer

    load = va.status.current_alloc.load
    req = RequestSize(
        avg_in_tokens=int(load.avg_input_tokens) or 64,
        avg_out_tokens=int(load.avg_output_tokens) or 32,
    )
    targets = TargetPerf(target_ttft=500.0, target_itl=24.0)
    rate = load.arrival_rate / 60.0  # spec arrival is req/min
    tandem = build_disagg_analyzer(
        max_batch=64, max_queue=640,
        decode=DecodeParms(alpha=PROFILE.alpha, beta=PROFILE.beta),
        prefill=PrefillParms(gamma=PROFILE.gamma, delta=PROFILE.delta),
        request=req, spec=SPEC,
    )
    rates, _, _ = tandem.size(targets)
    lam = min(rates.rate_target_ttft, rates.rate_target_itl, rates.rate_target_tps)
    import math

    assert desired_units == max(1, math.ceil(rate / lam)), (
        "reconciler's unit count must equal the tandem model's sizing"
    )

    # -- idle past the window -> scale back to one unit ---------------------
    go_idle(prom, prom_clock)
    rec.run_cycle()
    va = cluster.get_variant_autoscaling(NS, VA_NAME)
    assert va.status.desired_optimized_alloc.num_replicas == 1
    lws = cluster.get_leader_worker_set(NS, VA_NAME)
    assert lws["spec"]["replicas"] == 1


def test_disagg_unit_cost_counts_all_engine_slices(disagg_stack):
    """The optimizer's cost for one disagg unit is slices_per_unit x the
    slice price — visible in the CR's desired alloc cost after a cycle."""
    srv, prom, cluster, rec = disagg_stack
    _post_load(srv.port, duration_s=1.0)
    prom.scrape_once()
    report = rec.run_cycle()
    assert report.errors == []
    va = cluster.get_variant_autoscaling(NS, VA_NAME)
    # the observed CURRENT alloc prices the whole unit: v5e-4 at
    # 10/chip-hr x 4 chips = 40 per slice, x 3 slices per disagg unit,
    # x 1 running LWS group (desired-side costs use the same formula in
    # core/allocation.py; reference: collector.go:255)
    assert va.status.current_alloc.variant_cost == pytest.approx(
        1 * SPEC.slices_per_unit * 40.0)
