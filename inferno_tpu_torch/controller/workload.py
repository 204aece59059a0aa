"""Scalable workload abstraction: Deployment or LeaderWorkerSet.

The reference assumes 1 replica = 1 pod of a Deployment with the VA's
name (upstream internal/collector/collector.go:243-244,
internal/actuator/actuator.go:29-48). On TPU that breaks down: one
replica of a multi-host slice shape (e.g. v5e-16 = 4 hosts x 4 chips) is
a *pod group* that must be scheduled and scaled atomically —
LeaderWorkerSet semantics, where `spec.replicas` counts GROUPS and
`spec.leaderWorkerTemplate.size` pods per group.

This module makes the controller group-aware end to end: the collector
reads current replicas in group units, the actuator emits gauges and
(optionally) scales in group units, and a replica can never exist in a
fractional-host state because only whole groups are requested.

Port copy of `inferno_tpu/controller/workload.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import dataclasses

from inferno_tpu_torch.controller.kube import NotFound

LWS_GROUP = "leaderworkerset.x-k8s.io"
LWS_VERSION = "v1"
LWS_PLURAL = "leaderworkersets"
LWS_API_VERSION = f"{LWS_GROUP}/{LWS_VERSION}"


@dataclasses.dataclass(frozen=True)
class Workload:
    """The scalable unit owning a variant's pods.

    `replicas` is always in REPLICA units — pods for a Deployment, whole
    pod groups for a LeaderWorkerSet — matching the optimizer's replica
    semantics (1 replica = 1 pod-slice)."""

    kind: str  # "Deployment" | "LeaderWorkerSet"
    api_version: str
    raw: dict

    @property
    def name(self) -> str:
        return self.raw.get("metadata", {}).get("name", "")

    @property
    def namespace(self) -> str:
        return self.raw.get("metadata", {}).get("namespace", "")

    @property
    def uid(self) -> str:
        return self.raw.get("metadata", {}).get("uid", "")

    @property
    def replicas(self) -> int:
        return int(self.raw.get("spec", {}).get("replicas", 0) or 0)

    @property
    def ready_replicas(self) -> int | None:
        status = self.raw.get("status", {}) or {}
        if "readyReplicas" in status:
            return int(status.get("readyReplicas") or 0)
        return None

    @property
    def group_size(self) -> int:
        """Pods per replica: 1 for a Deployment, the leader/worker group
        size for a LeaderWorkerSet."""
        if self.kind != "LeaderWorkerSet":
            return 1
        template = self.raw.get("spec", {}).get("leaderWorkerTemplate", {}) or {}
        return int(template.get("size", 1) or 1)


def from_deployment(obj: dict) -> Workload:
    return Workload(kind="Deployment", api_version="apps/v1", raw=obj)


def from_leader_worker_set(obj: dict) -> Workload:
    return Workload(kind="LeaderWorkerSet", api_version=LWS_API_VERSION, raw=obj)


def get_workload(kube, namespace: str, name: str) -> Workload:
    """The workload owning the variant's pods, by the VA's name/namespace
    (the reference's name-coupling, extended): a Deployment if one
    exists, else a LeaderWorkerSet when the client supports them."""
    get_lws = getattr(kube, "get_leader_worker_set", None)
    try:
        return from_deployment(kube.get_deployment(namespace, name))
    except NotFound:
        if get_lws is None:
            raise
        return from_leader_worker_set(get_lws(namespace, name))


def scale_workload(kube, workload: Workload, replicas: int) -> None:
    """Scale in replica units: pods for a Deployment, whole groups for a
    LeaderWorkerSet — the group either exists completely or not at all."""
    if workload.kind == "LeaderWorkerSet":
        kube.scale_leader_worker_set(workload.namespace, workload.name, replicas)
    else:
        kube.scale_deployment(workload.namespace, workload.name, replicas)
