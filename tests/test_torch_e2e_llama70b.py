"""BASELINE config #5 end to end: Llama-3.1-70B on multi-host v5e-16
slices, sized from the COMMITTED 70B profile and actuated as whole
LeaderWorkerSet groups through the real-HTTP MiniApiServer.

Differs from test_torch_apiserver.test_run_cycle_scales_lws_groups_over_http
(which pins toy parms to exercise the transport): here the VA carries the
actual `profiles/llama-3.1-70b_v5e-16-int8.json` performance parameters
over the CRD wire format (stringly floats, reference
variantautoscaling_types.go:41-50), so the decision under test is the one
the bench's `llama_70b` table advertises. Reference scenario:
BASELINE.json configs[4]; profile dimensions per
upstream docs/design/modeling-optimization.md:64-65.

Port of tests/test_e2e_llama70b.py on the port's controller and
MiniApiServer; every Reconciler gets `compute_device="cpu"`.
"""

import json
import math
import urllib.request

import pytest

from inferno_tpu_torch.analyzer import RequestSize, TargetPerf, build_analyzer
from inferno_tpu_torch.config.defaults import slo_margin_for
from inferno_tpu_torch.controller.kube import RestKubeClient
from inferno_tpu_torch.controller.reconciler import Reconciler, ReconcilerConfig
from inferno_tpu_torch.models.profiles import load_named_profile_doc
from inferno_tpu_torch.testing.apiserver import MiniApiServer

from test_torch_apiserver import make_prom

NS = "workloads"
CFG_NS = "inferno-system"
MODEL_ID = "meta-llama/Llama-3.1-70B"
ACC = "v5e-16"
GROUP_SIZE = 4  # 4 hosts x 4 chips per 16-chip slice
V5E_CHIP_COST = 1.2


@pytest.fixture(scope="module")
def profile():
    spec, doc = load_named_profile_doc("llama-3.1-70b", "v5e-16-int8")
    # the multi-host story rests on a derivation until a real 70B raw
    # lands; the profile must say so (provenance contract)
    assert doc["derived"] and "cross_model" in doc["assumptions"]
    return spec


def post(srv, path, body):
    req = urllib.request.Request(
        srv.url + path, method="POST", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    return json.loads(urllib.request.urlopen(req).read())


def seed(srv, profile):
    """Config CMs + the 70B VA (committed-profile parms over the CRD wire
    format) + its 4-pod-per-group LeaderWorkerSet at 1 group."""
    for name, data in [
        ("accelerator-unit-costs",
         {ACC: json.dumps({"cost": 16 * V5E_CHIP_COST})}),
        ("service-classes-config",
         {"premium.yaml": ("name: Premium\npriority: 1\ndata:\n"
                           f"  - model: {MODEL_ID}\n"
                           "    slo-ttft: 500\n    slo-tpot: 24\n")}),
        ("inferno-autoscaler-config", {"GLOBAL_OPT_INTERVAL": "30s"}),
    ]:
        post(srv, f"/api/v1/namespaces/{CFG_NS}/configmaps",
             {"metadata": {"name": name, "namespace": CFG_NS}, "data": data})

    d, p = profile.decode_parms, profile.prefill_parms
    post(srv, f"/apis/llmd.ai/v1alpha1/namespaces/{NS}/variantautoscalings", {
        "apiVersion": "llmd.ai/v1alpha1",
        "kind": "VariantAutoscaling",
        "metadata": {
            "name": "llama-70b", "namespace": NS,
            "labels": {"inference.optimization/acceleratorName": ACC},
        },
        "spec": {
            "modelID": MODEL_ID,
            "sloClassRef": {"name": "service-classes-config", "key": "Premium"},
            "modelProfile": {"accelerators": [{
                # accCount counts SLICE units per replica (normally 1 —
                # the v5e-16 shape itself encodes the 16-chip footprint;
                # docs/crd-reference.md)
                "acc": ACC, "accCount": 1,
                "maxBatchSize": profile.max_batch_size,
                "atTokens": profile.at_tokens,
                "perfParms": {
                    "decodeParms": {"alpha": str(d.alpha), "beta": str(d.beta)},
                    "prefillParms": {"gamma": str(p.gamma), "delta": str(p.delta)},
                },
            }]},
        },
    })
    post(srv, f"/apis/leaderworkerset.x-k8s.io/v1/namespaces/{NS}/leaderworkersets", {
        "metadata": {"name": "llama-70b", "namespace": NS},
        "spec": {"replicas": 1, "leaderWorkerTemplate": {"size": GROUP_SIZE}},
        "status": {"replicas": 1, "readyReplicas": 1},
    })


def expected_groups(profile, arrival_rps: float) -> int:
    """What the sizing machinery itself says this rate needs at the
    Premium p99 SLO — the bench table's replica arithmetic
    (replicas = ceil(rate / lambda*), reference allocation.go:133-141)."""
    analyzer = build_analyzer(
        max_batch=profile.max_batch_size,
        max_queue=10 * profile.max_batch_size,
        decode=profile.decode_parms,
        prefill=profile.prefill_parms,
        request=RequestSize(avg_in_tokens=128, avg_out_tokens=128),
    )
    rates, _, _ = analyzer.size(
        TargetPerf(target_ttft=500.0, target_itl=24.0),
        ttft_tail_margin=slo_margin_for(0.99),
    )
    lam = min(rates.rate_target_ttft, rates.rate_target_itl)
    return max(1, math.ceil(arrival_rps / lam))


def test_70b_va_scales_lws_groups_from_committed_profile(profile):
    srv = MiniApiServer().start()
    try:
        seed(srv, profile)
        client = RestKubeClient(base_url=srv.url, token="", namespace=CFG_NS)
        rec = Reconciler(
            kube=client, prom=make_prom(arrival_rps=40.0),
            config=ReconcilerConfig(compute_device="cpu", config_namespace=CFG_NS,
                                    compute_backend="scalar",
                                    direct_scale=True),
        )
        report = rec.run_cycle()
        assert report.errors == [], report.errors

        va = client.get_variant_autoscaling(NS, "llama-70b")
        desired = va.status.desired_optimized_alloc.num_replicas
        # 40 req/s of 128/128 traffic needs multiple 16-chip groups on
        # this profile — and exactly as many as the sizing math says
        assert desired > 1
        assert desired == expected_groups(profile, 40.0)
        # collected in GROUP units: 1 group, never 4 pods
        assert va.status.current_alloc.num_replicas == 1
        assert va.status.desired_optimized_alloc.accelerator == ACC

        lws = client.get_leader_worker_set(NS, "llama-70b")
        assert lws["spec"]["replicas"] == desired  # whole groups
        assert lws["spec"]["leaderWorkerTemplate"]["size"] == GROUP_SIZE
        assert va.owner_references[0]["kind"] == "LeaderWorkerSet"

        # idle traffic: the next cycle squeezes back to the floor, still
        # in group units (16 chips come and go atomically)
        rec2 = Reconciler(
            kube=client, prom=make_prom(arrival_rps=0.05),
            config=ReconcilerConfig(compute_device="cpu", config_namespace=CFG_NS,
                                    compute_backend="scalar",
                                    direct_scale=True),
        )
        assert rec2.run_cycle().errors == []
        lws = client.get_leader_worker_set(NS, "llama-70b")
        assert lws["spec"]["replicas"] == 1
    finally:
        srv.stop()
