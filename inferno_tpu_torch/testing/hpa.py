"""prometheus-adapter + HorizontalPodAutoscaler emulation for closing the
production actuation loop in tests.

The controller's ACTUAL production contract is indirect: it emits
`inferno_desired_replicas` gauges and an external actuator enacts them
(reference actuator.go:50-84; its primary e2e asserts scaling through
Prometheus -> prometheus-adapter -> HPA,
the upstream project's test/e2e/e2e_test.go:341-517). Every earlier closed loop
here used `direct_scale=true`, leaving the advertised path untested.
This module emulates the two external
pieces with their real semantics so a sockets e2e can run the whole
chain with `direct_scale=false`:

* `ExternalMetricsAdapter` — prometheus-adapter's external-metrics rule
  for the actuation gauges (deploy/samples/prometheus-adapter-values.yaml):
  executes `max(<series>{<matchers>}) by (variant_name, namespace)`
  against a real Prometheus API (MiniProm scraping the controller's real
  /metrics exposition) and returns the external.metrics.k8s.io value
  list for a selector, exactly what the HPA controller would fetch.
* `HpaEmulator` — the HPA v2 replica arithmetic for one External metric
  with an AverageValue target (the shape of
  deploy/samples/hpa-integration.yaml): desired = ceil(metric /
  averageValue), clamped to [minReplicas, maxReplicas], with the
  scale-down stabilization window (the recommendation applied is the MAX
  over the window, so transient dips never shrink the workload —
  HPA's actual behavior.scaleDown.stabilizationWindowSeconds semantics)
  — then enacted through the kube /scale subresource like the real HPA
  controller (scale_workload, group units for a LeaderWorkerSet).

A missing metric (no series yet, or the variant's gauges pruned) yields
no scaling action, matching HPA's conservative handling of external
metric errors.

Port copy of `inferno_tpu/testing/hpa.py`, verbatim apart from this
paragraph, its imports and two source references in the paragraph above: the actuators read and scale workloads
through the port's `controller.workload`.
"""

from __future__ import annotations

import dataclasses
import math
import time

from inferno_tpu_torch.controller.workload import get_workload, scale_workload


@dataclasses.dataclass
class ExternalMetricsAdapter:
    """One external-metrics rule over a Prometheus client (the
    PromClient protocol: .query(promql) -> [Sample])."""

    prom: object
    series: str = "inferno_desired_replicas"

    def get_metric(self, match_labels: dict[str, str]) -> float | None:
        """external.metrics.k8s.io GET for `series` with a label
        selector; None when no series matches (adapter returns an empty
        item list and HPA records a FailedGetExternalMetric)."""
        matchers = ",".join(f'{k}="{v}"' for k, v in sorted(match_labels.items()))
        q = (f"max({self.series}{{{matchers}}}) "
             f"by (variant_name, namespace)")
        samples = self.prom.query(q)
        if not samples:
            return None
        return max(s.value for s in samples)


@dataclasses.dataclass
class KedaScaledObject:
    """KEDA's prometheus-scaler + ScaledObject semantics for one variant
    (the reference's sample config/samples/keda-scaled-object-vllme.yaml,
    docs/integrations/keda-integration.md:30-49; ours is
    deploy/samples/keda-scaledobject.yaml): a direct PromQL instant query
    of `inferno_desired_replicas{variant_name,namespace}`, AverageValue
    threshold arithmetic, an ACTIVATION edge (metric > activationThreshold
    wakes the workload from 0; below it, after cooldownPeriod of
    inactivity, KEDA scales to minReplicaCount — natively 0), and the
    fallback (consecutive query FAILURES -> fallback replicas,
    currentReplicasIfHigher). An empty query result counts as value 0,
    KEDA's prometheus-scaler default (ignoreNullValues: true) — which is
    exactly why the controller must keep EMITTING a fresh 0 gauge for a
    sleeping variant rather than letting the series vanish."""

    kube: object
    prom: object  # PromClient: .query(promql) -> [Sample]
    namespace: str
    name: str  # scaleTargetRef and the variant_name selector
    series: str = "inferno_desired_replicas"
    threshold: float = 1.0
    activation_threshold: float = 0.0
    min_replica_count: int = 0
    max_replica_count: int = 32
    cooldown_period_s: float = 30.0
    fallback_failure_threshold: int = 3
    fallback_replicas: int = 2
    now: callable = time.time

    def __post_init__(self) -> None:
        self._last_active: float | None = None
        self._failures = 0
        self.last_metric: float | None = None

    def _query(self) -> float:
        q = (f'{self.series}{{variant_name="{self.name}",'
             f'namespace="{self.namespace}"}}')
        samples = self.prom.query(q)
        return max((s.value for s in samples), default=0.0)

    def step(self) -> int:
        """One polling interval. Returns the replica count enacted."""
        wl = get_workload(self.kube, self.namespace, self.name)
        try:
            metric = self._query()
            self._failures = 0
        except Exception:
            self._failures += 1
            if self._failures >= self.fallback_failure_threshold:
                # fallback behavior currentReplicasIfHigher
                desired = max(self.fallback_replicas, wl.replicas)
                if desired != wl.replicas:
                    scale_workload(self.kube, wl, desired)
                return desired
            return wl.replicas  # below the failure threshold: no action
        self.last_metric = metric

        t = self.now()
        active = metric > self.activation_threshold
        if active:
            self._last_active = t
            # real KEDA writes minReplicaCount into the generated HPA's
            # minReplicas, so the active-path floor is max(1, min_count)
            desired = max(1, self.min_replica_count,
                          math.ceil(metric / self.threshold))
            desired = min(self.max_replica_count, desired)
        else:
            # deactivation: scale to minReplicaCount only after the
            # cooldown period with no activity
            if wl.replicas <= self.min_replica_count:
                return wl.replicas
            if self._last_active is None:
                self._last_active = t
                return wl.replicas
            if t - self._last_active < self.cooldown_period_s:
                return wl.replicas
            desired = self.min_replica_count
        if desired != wl.replicas:
            scale_workload(self.kube, wl, desired)
        return desired


@dataclasses.dataclass
class HpaEmulator:
    """HPA v2: one External metric, AverageValue target, /scale actuation."""

    kube: object
    adapter: ExternalMetricsAdapter
    namespace: str
    name: str  # scaleTargetRef and the variant_name selector
    min_replicas: int = 1
    max_replicas: int = 32
    average_value: float = 1.0
    scale_down_stabilization_s: float = 0.0
    # injectable clock so tests can step the stabilization window without
    # real sleeps
    now: callable = time.time

    def __post_init__(self) -> None:
        self._recommendations: list[tuple[float, int]] = []
        self.last_metric: float | None = None

    def _recommend(self, raw: int) -> int:
        """Apply the scale-down stabilization window: act on the MAX
        recommendation seen within the window (upscales pass through
        immediately — scaleUp stabilization is 0 in the sample policy)."""
        t = self.now()
        self._recommendations.append((t, raw))
        cutoff = t - self.scale_down_stabilization_s
        self._recommendations = [(ts, r) for ts, r in self._recommendations
                                 if ts >= cutoff]
        return max(r for _, r in self._recommendations)

    def step(self) -> int | None:
        """One HPA sync: fetch the external metric, compute the replica
        recommendation, and enact it via /scale when it differs from the
        current spec. Returns the applied desired count, or None when the
        metric is unavailable (no action, like the real controller)."""
        metric = self.adapter.get_metric({
            "variant_name": self.name, "namespace": self.namespace,
        })
        self.last_metric = metric
        if metric is None:
            return None
        raw = max(1, math.ceil(metric / self.average_value))
        desired = min(self.max_replicas, max(self.min_replicas,
                                             self._recommend(raw)))
        wl = get_workload(self.kube, self.namespace, self.name)
        if desired != wl.replicas:
            scale_workload(self.kube, wl, desired)
        return desired
