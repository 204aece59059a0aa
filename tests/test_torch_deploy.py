"""Deployment artifacts of the port: the reference's shipped manifests
driven through the port's controller, the port's configuration table, and
the H100 overlay (deploy/overlays/h100/) that runs the port's image.

Port of the port-relevant cases of tests/test_deploy.py:
`test_reconcile_cycle_from_shipped_manifests` runs on the port's
`Reconciler` (backend "torch" on the CPU, asked for explicitly, the cycle
held to the reference's decisions on the same inputs), and
`test_env_knobs_documented_in_user_guide` reads the port's controller
package against docs/user-guide/configuration-torch.md. The overlay's
cases follow tests/test_deploy.py's kustomization and probe checks, on
the manager Deployment as the overlay's patch leaves it (a strategic
merge: containers and env entries merge by name).
"""

import copy
import glob
import os
import re

import pytest
import yaml

from inferno_tpu_torch.controller.reconciler import BACKENDS, ReconcilerConfig

from test_torch_held_cycle import PORT_CPU, held_reconciler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERLAY = os.path.join(REPO, "deploy", "overlays", "h100")
PORT_ENTRY = ["python", "-m", "inferno_tpu_torch.controller.main"]
# quantity suffixes of the memory values (Kubernetes resource quantities)
_BINARY = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30}


def load_all(path):
    with open(path) as f:
        return [d for d in yaml.safe_load_all(f) if d is not None]


def test_reconcile_cycle_from_shipped_manifests():
    """Boot the port's controller against the exact ConfigMaps and sample
    VAs this repo ships: the manifest keys must be the ones the port's
    reconciler reads."""
    import time as _time

    from inferno_tpu_torch.controller import InMemoryCluster
    from inferno_tpu_torch.controller.crd import VariantAutoscaling
    from inferno_tpu_torch.controller.promclient import FakeProm, Sample

    cluster = InMemoryCluster()
    cm_docs = load_all(os.path.join(REPO, "deploy/manifests/configmaps.yaml"))
    for doc in cm_docs:
        cluster.set_configmap("inferno-system", doc["metadata"]["name"], doc["data"])
    va_docs = load_all(os.path.join(REPO, "deploy/samples/variantautoscaling-v5e.yaml"))
    for doc in va_docs:
        va = VariantAutoscaling.from_dict(doc)
        cluster.add_variant_autoscaling(va)
        cluster.add_deployment(va.namespace, va.name, replicas=1)

    prom = FakeProm()

    def handler(q):
        def s(v):
            return [Sample(labels={}, value=v, timestamp=_time.time())]

        if "num_requests_running" in q or "slots_used" in q:
            return s(4.0)
        if "success" in q:
            return s(10.0)  # req/s
        if "prompt_tokens" in q or "input_length" in q:
            return s(128.0)
        if "generation_tokens" in q or "output_length" in q:
            return s(128.0)
        if "first_token" in q:
            return s(0.05)
        if "per_output_token" in q:
            return s(0.02)
        return []

    prom.add_handler(lambda q: True, handler)
    rec = held_reconciler(cluster, prom, ReconcilerConfig(
        config_namespace="inferno-system", **PORT_CPU))
    report = rec.run_cycle()
    assert report.optimization_ok, report.errors
    assert report.variants_prepared == len(va_docs)
    assert rec.held_cycles == 1
    for va in cluster.list_variant_autoscalings():
        alloc = va.status.desired_optimized_alloc
        assert alloc.num_replicas >= 1, va.name
        assert alloc.accelerator, va.name
    rec.close()


def _port_knobs() -> set[str]:
    """Every env knob the port's controller package reads (from source,
    through the typed config/defaults.py accessors)."""
    import inferno_tpu_torch.controller as C

    pkg_dir = os.path.dirname(C.__file__)
    pattern = (r'(?:env_bool|env_flag|env_str|env_int|env_float|os\.environ\.get)'
               r'\(\s*\n?\s*"([A-Z][A-Z0-9_]+)"')
    knobs = set()
    for path in glob.glob(os.path.join(pkg_dir, "*.py")):
        with open(path) as f:
            knobs |= set(re.findall(pattern, f.read()))
    return knobs


def test_env_knobs_documented_in_user_guide():
    """Every env knob the port's controller package reads must appear in
    the port's configuration table."""
    # platform-injected, not operator configuration
    knobs = _port_knobs() - {"KUBERNETES_SERVICE_HOST", "KUBERNETES_SERVICE_PORT"}
    assert len(knobs) >= 15, f"source parse produced too little: {sorted(knobs)}"
    assert "COMPUTE_DEVICE" in knobs
    guide = open(os.path.join(REPO, "docs/user-guide/configuration-torch.md")).read()
    for knob in sorted(knobs):
        assert knob in guide, f"{knob} missing from configuration-torch.md"


# -- the H100 overlay ----------------------------------------------------------


def _merge_by_name(base: list, patch: list) -> list:
    out = [copy.deepcopy(x) for x in base]
    for item in patch:
        for i, cur in enumerate(out):
            if cur["name"] == item["name"]:
                out[i] = _merge(cur, item)
                break
        else:
            out.append(copy.deepcopy(item))
    return out


def _merge(base, patch):
    """A strategic merge of the fields the overlay patches: maps merge,
    `containers` and `env` merge by name, other lists replace."""
    if isinstance(base, dict) and isinstance(patch, dict):
        out = copy.deepcopy(base)
        for key, value in patch.items():
            if key in ("containers", "env") and key in out:
                out[key] = _merge_by_name(out[key], value)
            elif key in out:
                out[key] = _merge(out[key], value)
            else:
                out[key] = copy.deepcopy(value)
        return out
    return copy.deepcopy(patch)


def _overlay_patch() -> dict:
    (doc,) = load_all(os.path.join(OVERLAY, "manager-patch.yaml"))
    return doc


def _patched_manager() -> tuple[dict, dict]:
    """(the pod spec, the manager container) as the overlay leaves them."""
    (base,) = load_all(os.path.join(REPO, "deploy/manifests/manager.yaml"))
    deployment = _merge(base, _overlay_patch())
    pod = deployment["spec"]["template"]["spec"]
    (manager,) = [c for c in pod["containers"] if c["name"] == "manager"]
    return pod, manager


def _bytes(quantity: str) -> int:
    number, suffix = re.fullmatch(r"(\d+)([KMG]i)", quantity).groups()
    return int(number) * _BINARY[suffix]


def test_overlay_resources_exist_and_patch_the_manager():
    kust = load_all(os.path.join(OVERLAY, "kustomization.yaml"))[0]
    for res in kust["resources"]:
        assert os.path.exists(os.path.join(OVERLAY, res)), res
    for patch in kust["patches"]:
        assert os.path.exists(os.path.join(OVERLAY, patch["path"])), patch
        assert patch["target"] == {"kind": "Deployment", "name": "inferno-tpu-controller"}
    (base,) = load_all(os.path.join(REPO, "deploy/manifests/manager.yaml"))
    patch = _overlay_patch()
    assert (patch["kind"], patch["metadata"]["name"], patch["metadata"]["namespace"]) == (
        base["kind"], base["metadata"]["name"], base["metadata"]["namespace"])


def test_overlay_runs_the_ports_entry_on_cuda():
    _, manager = _patched_manager()
    assert manager["command"] == PORT_ENTRY
    env = {e["name"]: e.get("value") for e in manager["env"]}
    assert env["COMPUTE_BACKEND"] == "cuda"
    assert env["COMPUTE_BACKEND"] in BACKENDS
    ReconcilerConfig(compute_backend=env["COMPUTE_BACKEND"])  # accepted by the port
    # the base's entries survive the merge
    assert env["PROMETHEUS_BASE_URL"].startswith("http")
    assert "POD_NAMESPACE" in env


def test_overlay_env_names_are_knobs_the_port_reads():
    _, manager = _patched_manager()
    knobs = _port_knobs()
    for entry in manager["env"]:
        assert entry["name"] in knobs, entry["name"]


def test_overlay_probe_and_metrics_ports_match_the_ports_defaults():
    """The probes target the `health` port, which is HealthServer's
    default in the port's controller/main.py; `metrics` is METRICS_PORT's."""
    src = open(os.path.join(REPO, "inferno_tpu_torch/controller/main.py")).read()
    defaults = dict(re.findall(r'env_int\("(\w+_PORT)", (\d+)\)', src))
    _, manager = _patched_manager()
    ports = {p["name"]: p["containerPort"] for p in manager["ports"]}
    assert ports["health"] == int(defaults["HEALTH_PORT"]) == 8081
    assert ports["metrics"] == int(defaults["METRICS_PORT"]) == 8443
    assert manager["livenessProbe"]["httpGet"] == {"path": "/healthz", "port": "health"}
    assert manager["readinessProbe"]["httpGet"] == {"path": "/readyz", "port": "health"}


def test_overlay_requests_one_gpu_on_h100_nodes():
    pod, manager = _patched_manager()
    limits = manager["resources"]["limits"]
    assert limits["nvidia.com/gpu"] == 1
    assert "H100" in pod["nodeSelector"]["nvidia.com/gpu.product"]
    assert _bytes(manager["resources"]["requests"]["memory"]) <= _bytes(limits["memory"])
    # the base's CPU request and limit are kept
    assert manager["resources"]["requests"]["cpu"] and limits["cpu"]


def test_overlay_keeps_the_bases_security_context():
    pod, manager = _patched_manager()
    assert pod["securityContext"]["runAsNonRoot"] is True
    assert pod["serviceAccountName"] == "inferno-tpu-controller"
    assert manager["securityContext"]["allowPrivilegeEscalation"] is False
    assert "runAsNonRoot" not in _overlay_patch()["spec"]["template"]["spec"].get(
        "securityContext", {})


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(OVERLAY, "*.yaml"))),
                         ids=os.path.basename)
def test_overlay_yaml_parses(path):
    assert load_all(path)
