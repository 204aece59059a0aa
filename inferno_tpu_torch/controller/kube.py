"""Kubernetes access.

`KubeClient` is the narrow interface the reconciler needs (list/get VAs,
update status, get Deployments/ConfigMaps, patch owner references) —
the reconciler never sees HTTP. Two implementations:

* `InMemoryCluster` — a faithful in-process fake (namespaced stores,
  deep-copy on read/write, status subresource semantics) used by tests
  and the emulated e2e stack; the analogue of envtest in the reference's
  strategy (upstream internal/controller/suite_test.go:66-84).
* `RestKubeClient` — stdlib-only client for in-cluster use: service
  account token + CA from the pod filesystem, JSON over HTTPS against
  the API server, exponential-backoff retries mirroring the reference's
  wrappers (upstream internal/utils/utils.go:31-104).

Port copy of `inferno_tpu/controller/kube.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import copy
import json
import os
import ssl
import time
import urllib.error
import urllib.request
from typing import Any, Protocol

from inferno_tpu_torch.controller.crd import GROUP, PLURAL, VERSION, VariantAutoscaling


class KubeError(RuntimeError):
    pass


class NotFound(KubeError):
    pass


class Conflict(KubeError):
    pass


class KubeClient(Protocol):
    def list_variant_autoscalings(self) -> list[VariantAutoscaling]: ...

    def get_variant_autoscaling(self, namespace: str, name: str) -> VariantAutoscaling: ...

    def update_variant_autoscaling_status(self, va: VariantAutoscaling) -> None: ...

    def patch_variant_autoscaling_meta(self, va: VariantAutoscaling) -> None: ...

    def get_deployment(self, namespace: str, name: str) -> dict: ...

    def scale_deployment(self, namespace: str, name: str, replicas: int) -> None: ...

    def get_configmap(self, namespace: str, name: str) -> dict[str, str]: ...

    def list_nodes(self) -> list[dict]: ...

    # coordination.k8s.io leases (leader election)
    def get_lease(self, namespace: str, name: str) -> dict: ...

    def create_lease(self, namespace: str, name: str, lease: dict) -> dict: ...

    def update_lease(self, namespace: str, name: str, lease: dict) -> dict: ...


# -- in-memory fake ----------------------------------------------------------


class InMemoryCluster:
    """Deep-copy-on-access fake cluster for tests and emulation."""

    def __init__(self, namespace: str = "default"):
        self.default_namespace = namespace
        self._vas: dict[tuple[str, str], dict] = {}
        self._deployments: dict[tuple[str, str], dict] = {}
        self._lws: dict[tuple[str, str], dict] = {}
        self._configmaps: dict[tuple[str, str], dict[str, str]] = {}
        self._nodes: dict[str, dict] = {}
        self._leases: dict[tuple[str, str], dict] = {}
        # (kind, event_type, namespace, name) subscribers (watch analogue)
        self._subscribers: list = []

    def subscribe(self, callback) -> None:
        """Register `callback(kind, event_type, namespace, name)` for
        resource events — the in-process analogue of API-server watches."""
        self._subscribers.append(callback)

    def _notify(self, kind: str, event_type: str, namespace: str, name: str) -> None:
        for cb in self._subscribers:
            cb(kind, event_type, namespace, name)

    # seeding helpers -------------------------------------------------------

    def add_variant_autoscaling(self, va: VariantAutoscaling) -> None:
        key = (va.namespace, va.name)
        event = "MODIFIED" if key in self._vas else "ADDED"
        self._vas[key] = va.to_dict()
        self._notify("VariantAutoscaling", event, va.namespace, va.name)

    def add_deployment(
        self, namespace: str, name: str, replicas: int = 1, labels: dict | None = None
    ) -> None:
        self._deployments[(namespace, name)] = {
            "metadata": {"name": name, "namespace": namespace, "labels": labels or {}},
            "spec": {"replicas": replicas},
            "status": {"readyReplicas": replicas, "replicas": replicas},
        }

    def add_leader_worker_set(
        self,
        namespace: str,
        name: str,
        replicas: int = 1,
        size: int = 4,
        labels: dict | None = None,
    ) -> None:
        """A LeaderWorkerSet: `replicas` pod GROUPS of `size` pods each
        (one pod per host of a multi-host slice). Pods are accounted
        atomically: a group exists completely or not at all."""
        self._lws[(namespace, name)] = {
            "apiVersion": "leaderworkerset.x-k8s.io/v1",
            "kind": "LeaderWorkerSet",
            "metadata": {"name": name, "namespace": namespace, "labels": labels or {}},
            "spec": {"replicas": replicas, "leaderWorkerTemplate": {"size": size}},
            "status": {"readyReplicas": replicas, "replicas": replicas},
        }

    def get_leader_worker_set(self, namespace: str, name: str) -> dict:
        d = self._lws.get((namespace, name))
        if d is None:
            raise NotFound(f"leaderworkerset {namespace}/{name}")
        return copy.deepcopy(d)

    def scale_leader_worker_set(self, namespace: str, name: str, replicas: int) -> None:
        d = self._lws.get((namespace, name))
        if d is None:
            raise NotFound(f"leaderworkerset {namespace}/{name}")
        d["spec"]["replicas"] = replicas
        d["status"]["replicas"] = replicas
        d["status"]["readyReplicas"] = replicas
        self._notify("LeaderWorkerSet", "MODIFIED", namespace, name)

    def pod_count(self, namespace: str, name: str) -> int:
        """Observable pod count of a workload — for a LeaderWorkerSet
        always groups x size (whole groups only)."""
        lws = self._lws.get((namespace, name))
        if lws is not None:
            return int(lws["spec"]["replicas"]) * int(
                lws["spec"]["leaderWorkerTemplate"]["size"]
            )
        dep = self._deployments.get((namespace, name))
        if dep is not None:
            return int(dep["spec"]["replicas"])
        raise NotFound(f"workload {namespace}/{name}")

    def set_configmap(self, namespace: str, name: str, data: dict[str, str]) -> None:
        event = "MODIFIED" if (namespace, name) in self._configmaps else "ADDED"
        self._configmaps[(namespace, name)] = dict(data)
        self._notify("ConfigMap", event, namespace, name)

    def delete_variant_autoscaling(self, namespace: str, name: str) -> None:
        self._vas.pop((namespace, name), None)

    # KubeClient ------------------------------------------------------------

    def list_variant_autoscalings(self) -> list[VariantAutoscaling]:
        return [
            VariantAutoscaling.from_dict(copy.deepcopy(d))
            for d in self._vas.values()
        ]

    def get_variant_autoscaling(self, namespace: str, name: str) -> VariantAutoscaling:
        d = self._vas.get((namespace, name))
        if d is None:
            raise NotFound(f"variantautoscaling {namespace}/{name}")
        return VariantAutoscaling.from_dict(copy.deepcopy(d))

    def update_variant_autoscaling_status(self, va: VariantAutoscaling) -> None:
        key = (va.namespace, va.name)
        if key not in self._vas:
            raise NotFound(f"variantautoscaling {va.namespace}/{va.name}")
        self._vas[key]["status"] = copy.deepcopy(va.to_dict()["status"])

    def patch_variant_autoscaling_meta(self, va: VariantAutoscaling) -> None:
        key = (va.namespace, va.name)
        if key not in self._vas:
            raise NotFound(f"variantautoscaling {va.namespace}/{va.name}")
        meta = copy.deepcopy(va.to_dict()["metadata"])
        self._vas[key]["metadata"] = meta

    def get_deployment(self, namespace: str, name: str) -> dict:
        d = self._deployments.get((namespace, name))
        if d is None:
            raise NotFound(f"deployment {namespace}/{name}")
        return copy.deepcopy(d)

    def scale_deployment(self, namespace: str, name: str, replicas: int) -> None:
        d = self._deployments.get((namespace, name))
        if d is None:
            raise NotFound(f"deployment {namespace}/{name}")
        d["spec"]["replicas"] = replicas
        d["status"]["replicas"] = replicas
        d["status"]["readyReplicas"] = replicas

    def get_configmap(self, namespace: str, name: str) -> dict[str, str]:
        d = self._configmaps.get((namespace, name))
        if d is None:
            raise NotFound(f"configmap {namespace}/{name}")
        return dict(d)

    def add_node(
        self,
        name: str,
        tpu_chips: int = 0,
        accelerator: str = "",
        unschedulable: bool = False,
        labels: dict | None = None,
    ) -> None:
        labels = dict(labels or {})
        if accelerator:
            labels["cloud.google.com/gke-tpu-accelerator"] = accelerator
        node = {
            "metadata": {"name": name, "labels": labels},
            "spec": {"unschedulable": unschedulable},
            "status": {
                "allocatable": {"google.com/tpu": str(tpu_chips)} if tpu_chips else {}
            },
        }
        self._nodes[name] = node

    def list_nodes(self) -> list[dict]:
        return [copy.deepcopy(n) for n in self._nodes.values()]

    # leases with optimistic concurrency (resourceVersion), so election
    # races behave as they would against a real API server
    def get_lease(self, namespace: str, name: str) -> dict:
        d = self._leases.get((namespace, name))
        if d is None:
            raise NotFound(f"lease {namespace}/{name}")
        return copy.deepcopy(d)

    def create_lease(self, namespace: str, name: str, lease: dict) -> dict:
        if (namespace, name) in self._leases:
            raise Conflict(f"lease {namespace}/{name} exists")
        stored = copy.deepcopy(lease)
        stored.setdefault("metadata", {}).update(
            {"name": name, "namespace": namespace, "resourceVersion": "1"}
        )
        self._leases[(namespace, name)] = stored
        return copy.deepcopy(stored)

    def update_lease(self, namespace: str, name: str, lease: dict) -> dict:
        cur = self._leases.get((namespace, name))
        if cur is None:
            raise NotFound(f"lease {namespace}/{name}")
        sent_rv = (lease.get("metadata", {}) or {}).get("resourceVersion")
        cur_rv = cur["metadata"]["resourceVersion"]
        if sent_rv is not None and sent_rv != cur_rv:
            raise Conflict(f"lease {namespace}/{name}: resourceVersion mismatch")
        stored = copy.deepcopy(lease)
        stored.setdefault("metadata", {}).update(
            {
                "name": name,
                "namespace": namespace,
                "resourceVersion": str(int(cur_rv) + 1),
            }
        )
        self._leases[(namespace, name)] = stored
        return copy.deepcopy(stored)


# -- REST client -------------------------------------------------------------

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

# Standard backoff: 100ms doubling, 5 steps
# (reference: internal/utils/utils.go:31-38)
BACKOFF_INITIAL = 0.1
BACKOFF_STEPS = 5
BACKOFF_FACTOR = 2.0


def with_backoff(fn, retriable=(Conflict, urllib.error.URLError)):
    """(reference GetVariantAutoscalingWithBackoff et al.:
    internal/utils/utils.go:58-104)"""
    delay = BACKOFF_INITIAL
    last: Exception | None = None
    for _ in range(BACKOFF_STEPS):
        try:
            return fn()
        except retriable as e:  # type: ignore[misc]
            last = e
            time.sleep(delay)
            delay *= BACKOFF_FACTOR
    raise last  # type: ignore[misc]


class RestKubeClient:
    """Minimal API-server client (in-cluster or kubeconfig-less)."""

    def __init__(
        self,
        base_url: str | None = None,
        token: str | None = None,
        ca_file: str | None = None,
        namespace: str | None = None,
        insecure: bool = False,
    ):
        from inferno_tpu_torch.config.defaults import env_str

        host = env_str("KUBERNETES_SERVICE_HOST")
        port = env_str("KUBERNETES_SERVICE_PORT", "443")
        self.base_url = base_url or (f"https://{host}:{port}" if host else "")
        if not self.base_url:
            raise KubeError("no API server address (KUBERNETES_SERVICE_HOST unset)")
        token_file = os.path.join(SA_DIR, "token")
        if token is None and os.path.exists(token_file):
            with open(token_file) as f:
                token = f.read().strip()
        self.token = token or ""
        ca = ca_file or os.path.join(SA_DIR, "ca.crt")
        if insecure:
            self.ctx = ssl._create_unverified_context()  # noqa: S323 — explicit opt-in
        else:
            self.ctx = ssl.create_default_context(
                cafile=ca if os.path.exists(ca) else None
            )
        ns_file = os.path.join(SA_DIR, "namespace")
        self.namespace = namespace or (
            open(ns_file).read().strip() if os.path.exists(ns_file) else "default"
        )

    def _request(
        self, method: str, path: str, body: Any = None,
        content_type: str = "application/json",
    ) -> Any:
        req = urllib.request.Request(
            self.base_url + path, method=method,
            data=json.dumps(body).encode() if body is not None else None,
        )
        req.add_header("Accept", "application/json")
        if body is not None:
            req.add_header("Content-Type", content_type)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            with urllib.request.urlopen(req, context=self.ctx, timeout=30) as resp:
                data = resp.read()
                return json.loads(data) if data else None
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise NotFound(path) from e
            if e.code == 409:
                raise Conflict(path) from e
            raise KubeError(f"{method} {path}: HTTP {e.code}: {e.read()[:300]}") from e

    # KubeClient ------------------------------------------------------------

    def _va_path(self, namespace: str, name: str = "", subresource: str = "") -> str:
        p = f"/apis/{GROUP}/{VERSION}/namespaces/{namespace}/{PLURAL}"
        if name:
            p += f"/{name}"
        if subresource:
            p += f"/{subresource}"
        return p

    def list_variant_autoscalings(self) -> list[VariantAutoscaling]:
        out = self._request("GET", f"/apis/{GROUP}/{VERSION}/{PLURAL}")
        return [VariantAutoscaling.from_dict(i) for i in out.get("items", [])]

    def get_variant_autoscaling(self, namespace: str, name: str) -> VariantAutoscaling:
        return VariantAutoscaling.from_dict(
            with_backoff(lambda: self._request("GET", self._va_path(namespace, name)))
        )

    def update_variant_autoscaling_status(self, va: VariantAutoscaling) -> None:
        body = {
            "apiVersion": f"{GROUP}/{VERSION}",
            "kind": "VariantAutoscaling",
            "metadata": {"name": va.name, "namespace": va.namespace},
            "status": va.to_dict()["status"],
        }
        with_backoff(
            lambda: self._request(
                "PATCH",
                self._va_path(va.namespace, va.name, "status"),
                body,
                content_type="application/merge-patch+json",
            )
        )

    def patch_variant_autoscaling_meta(self, va: VariantAutoscaling) -> None:
        meta = va.to_dict()["metadata"]
        body = {"metadata": {k: meta[k] for k in ("labels", "ownerReferences") if k in meta}}
        with_backoff(
            lambda: self._request(
                "PATCH",
                self._va_path(va.namespace, va.name),
                body,
                content_type="application/merge-patch+json",
            )
        )

    def get_deployment(self, namespace: str, name: str) -> dict:
        return with_backoff(
            lambda: self._request(
                "GET", f"/apis/apps/v1/namespaces/{namespace}/deployments/{name}"
            )
        )

    def scale_deployment(self, namespace: str, name: str, replicas: int) -> None:
        with_backoff(
            lambda: self._request(
                "PATCH",
                f"/apis/apps/v1/namespaces/{namespace}/deployments/{name}/scale",
                {"spec": {"replicas": replicas}},
                content_type="application/merge-patch+json",
            )
        )

    def get_leader_worker_set(self, namespace: str, name: str) -> dict:
        return with_backoff(
            lambda: self._request(
                "GET",
                f"/apis/leaderworkerset.x-k8s.io/v1/namespaces/{namespace}"
                f"/leaderworkersets/{name}",
            )
        )

    def scale_leader_worker_set(self, namespace: str, name: str, replicas: int) -> None:
        # LWS serves the scale subresource; spec.replicas counts GROUPS
        with_backoff(
            lambda: self._request(
                "PATCH",
                f"/apis/leaderworkerset.x-k8s.io/v1/namespaces/{namespace}"
                f"/leaderworkersets/{name}/scale",
                {"spec": {"replicas": replicas}},
                content_type="application/merge-patch+json",
            )
        )

    def get_configmap(self, namespace: str, name: str) -> dict[str, str]:
        out = with_backoff(
            lambda: self._request(
                "GET", f"/api/v1/namespaces/{namespace}/configmaps/{name}"
            )
        )
        return dict(out.get("data", {}) or {})

    def list_nodes(self) -> list[dict]:
        out = with_backoff(lambda: self._request("GET", "/api/v1/nodes"))
        return list(out.get("items", []) or [])

    def watch_request(self, path: str) -> urllib.request.Request:
        """An authenticated streaming request for `?watch=true` paths
        (consumed line-by-line by controller.watch.Watcher)."""
        req = urllib.request.Request(self.base_url + path)
        req.add_header("Accept", "application/json")
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        return req

    def _lease_path(self, namespace: str, name: str = "") -> str:
        p = f"/apis/coordination.k8s.io/v1/namespaces/{namespace}/leases"
        return f"{p}/{name}" if name else p

    # no backoff on lease ops: election rounds are themselves the retry
    # loop, and a stale retry after a conflict must not clobber the winner
    def get_lease(self, namespace: str, name: str) -> dict:
        return self._request("GET", self._lease_path(namespace, name))

    def create_lease(self, namespace: str, name: str, lease: dict) -> dict:
        body = {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {"name": name, "namespace": namespace},
            **{k: v for k, v in lease.items() if k != "metadata"},
        }
        return self._request("POST", self._lease_path(namespace), body)

    def update_lease(self, namespace: str, name: str, lease: dict) -> dict:
        return self._request("PUT", self._lease_path(namespace, name), lease)
