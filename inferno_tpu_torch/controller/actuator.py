"""Actuator: publish scaling decisions for HPA/KEDA to enact.

Like the reference (internal/actuator/actuator.go:50-84), the controller
does NOT scale Deployments directly: it emits the inferno_* gauges that
prometheus-adapter/KEDA feed into HPA. Optionally (flagged), it can
scale the Deployment itself for environments without an external
actuator — useful with the in-memory cluster and the emulator e2e.

Port copy of `inferno_tpu/controller/actuator.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import dataclasses

from inferno_tpu_torch.controller.crd import VariantAutoscaling
from inferno_tpu_torch.controller.kube import KubeClient, KubeError
from inferno_tpu_torch.controller.metrics import MetricsEmitter
from inferno_tpu_torch.controller.workload import get_workload, scale_workload


@dataclasses.dataclass
class Actuator:
    kube: KubeClient
    emitter: MetricsEmitter
    direct_scale: bool = False  # scale workloads directly (no HPA present)

    def current_replicas(self, va: VariantAutoscaling) -> int:
        """Observed replicas from the owning workload (same name/ns),
        counted in replica units — pods for a Deployment, whole pod
        groups for a multi-host LeaderWorkerSet
        (reference getCurrentDeploymentReplicas: actuator.go:29-48, minus
        its 1-replica=1-pod assumption)."""
        return self._observed(get_workload(self.kube, va.namespace, va.name))

    @staticmethod
    def _observed(wl) -> int:
        ready = wl.ready_replicas
        return ready if ready is not None else wl.replicas

    def emit_metrics(self, va: VariantAutoscaling) -> None:
        """(reference EmitMetrics: actuator.go:50-84); failures must not
        fail the reconcile cycle (actuator.go:69-74) — callers catch."""
        wl = get_workload(self.kube, va.namespace, va.name)
        current = self._observed(wl)
        desired = va.status.desired_optimized_alloc.num_replicas
        accelerator = va.status.desired_optimized_alloc.accelerator
        self.emitter.emit_replica_metrics(
            namespace=va.namespace,
            variant=va.name,
            accelerator=accelerator,
            current=current,
            desired=desired,
        )
        if self.direct_scale and desired != current:
            try:
                scale_workload(self.kube, wl, desired)
            except KubeError:
                pass  # next cycle retries; metrics already emitted
