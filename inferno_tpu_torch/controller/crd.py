"""The VariantAutoscaling custom resource.

Capability parity with the reference CRD
(upstream api/v1alpha1/variantautoscaling_types.go:8-222), TPU-
flavored: `modelProfile.accelerators[].acc` names a TPU slice shape
(v5e-4, v5p-8, ...), and `accCount` counts slice units per replica.

Deliberate departure: numeric status fields are numbers, not the
reference's pattern-validated strings (its own survey calls the stringly
floats a wart). The wire format is plain JSON-able dicts — no Kubernetes
client types leak into the domain.

Conditions follow metav1.Condition semantics
(upstream api/v1alpha1/conditions.go:9-34): unique per type,
lastTransitionTime updates only when status flips.

Port copy of `inferno_tpu/controller/crd.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Mapping

from inferno_tpu_torch.config.types import (
    ContextBucketSpec,
    DecodeParms,
    DisaggSpec,
    ModelPerfSpec,
    PrefillParms,
    select_bucket,
)

GROUP = "llmd.ai"
VERSION = "v1alpha1"
KIND = "VariantAutoscaling"
PLURAL = "variantautoscalings"

# label used to pin the slice shape a variant currently runs on
# (reference: internal/controller/variantautoscaling_controller.go:250-260)
ACCELERATOR_LABEL = "inference.optimization/acceleratorName"

# condition types and reasons
# (reference: api/v1alpha1/variantautoscaling_types.go:194-222)
TYPE_METRICS_AVAILABLE = "MetricsAvailable"
TYPE_OPTIMIZATION_READY = "OptimizationReady"
REASON_METRICS_FOUND = "MetricsFound"
REASON_METRICS_MISSING = "MetricsMissing"
REASON_METRICS_STALE = "MetricsStale"
REASON_PROMETHEUS_ERROR = "PrometheusError"
REASON_OPTIMIZATION_SUCCEEDED = "OptimizationSucceeded"
REASON_OPTIMIZATION_FAILED = "OptimizationFailed"
REASON_METRICS_UNAVAILABLE = "MetricsUnavailable"


def _utcnow() -> str:
    return (
        datetime.datetime.now(datetime.timezone.utc)
        .replace(microsecond=0)
        .isoformat()
        .replace("+00:00", "Z")
    )


@dataclasses.dataclass
class ConfigMapKeyRef:
    """(reference: variantautoscaling_types.go:24-32)"""

    name: str
    key: str

    def to_dict(self) -> dict[str, Any]:
        return {"name": self.name, "key": self.key}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ConfigMapKeyRef":
        return cls(name=d.get("name", ""), key=d.get("key", ""))


def _perf_parms_to_dict(decode: DecodeParms, prefill: PrefillParms) -> dict[str, Any]:
    """Wire shape shared by profiles and context buckets: string-valued
    maps, like the reference (variantautoscaling_types.go:41-50)."""
    return {
        "decodeParms": {"alpha": str(decode.alpha), "beta": str(decode.beta)},
        "prefillParms": {"gamma": str(prefill.gamma), "delta": str(prefill.delta)},
    }


def _perf_parms_from_dict(d: Mapping[str, Any]) -> tuple[DecodeParms, PrefillParms]:
    perf = d.get("perfParms", {}) or {}
    dp = perf.get("decodeParms", {}) or {}
    pp = perf.get("prefillParms", {}) or {}
    return (
        DecodeParms(alpha=float(dp.get("alpha", 0) or 0), beta=float(dp.get("beta", 0) or 0)),
        PrefillParms(gamma=float(pp.get("gamma", 0) or 0), delta=float(pp.get("delta", 0) or 0)),
    )


@dataclasses.dataclass
class ContextBucket:
    """Latency profile measured at a context-length bucket.

    Long-context serving shifts α/β/γ/δ (longer KV reads per decode step,
    larger prefill): profiles are fitted per context bucket and the
    controller selects the bucket matching the variant's observed average
    input length (SURVEY §5.7 — long context as profile dimensions; the
    optimizer machinery is unchanged)."""

    max_in_tokens: int  # bucket upper bound, e.g. 4096 / 16384 / 65536
    decode_parms: DecodeParms = dataclasses.field(default_factory=DecodeParms)
    prefill_parms: PrefillParms = dataclasses.field(default_factory=PrefillParms)
    max_batch_size: int = 0  # 0 = inherit the profile's base batch
    # token count max_batch_size was sized at (KV budget per admitted
    # request); 0 = fall back to max_in_tokens
    at_tokens: int = 0

    def to_dict(self) -> dict[str, Any]:
        return {
            "maxInTokens": self.max_in_tokens,
            "maxBatchSize": self.max_batch_size,
            "atTokens": self.at_tokens,
            "perfParms": _perf_parms_to_dict(self.decode_parms, self.prefill_parms),
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ContextBucket":
        decode, prefill = _perf_parms_from_dict(d)
        return cls(
            max_in_tokens=int(d.get("maxInTokens", 0) or 0),
            max_batch_size=int(d.get("maxBatchSize", 0) or 0),
            at_tokens=int(d.get("atTokens", 0) or 0),
            decode_parms=decode,
            prefill_parms=prefill,
        )


@dataclasses.dataclass
class AcceleratorProfile:
    """Per-slice-shape performance profile carried on the CR
    (reference: variantautoscaling_types.go:54-69)."""

    acc: str  # slice shape name
    acc_count: int = 1  # slice units per replica (per engine when disagg)
    max_batch_size: int = 1
    at_tokens: int = 0  # tokens/request the max batch was profiled at
    decode_parms: DecodeParms = dataclasses.field(default_factory=DecodeParms)
    prefill_parms: PrefillParms = dataclasses.field(default_factory=PrefillParms)
    # JetStream-style disaggregated serving: one replica is then an atomic
    # unit of prefill+decode engines (inferno_tpu.analyzer.disagg)
    disagg: DisaggSpec | None = None
    # optional context-length-bucketed profiles, sorted ascending by
    # maxInTokens; base parms serve loads beyond the largest bucket
    context_buckets: list[ContextBucket] = dataclasses.field(default_factory=list)

    def bucket_for(self, avg_in_tokens: float) -> ContextBucket | None:
        """Smallest bucket covering the observed average input length
        (the shared rule: config.types.select_bucket)."""
        return select_bucket(self.context_buckets, avg_in_tokens)

    def to_perf_spec(self, model_id: str, avg_in_tokens: float = 0.0) -> ModelPerfSpec:
        """Resolve to the optimizer-side perf spec; bucket resolution
        (including the at_tokens rebase the K-rescale depends on) is
        delegated to `ModelPerfSpec.at_context` — ONE implementation."""
        base = ModelPerfSpec(
            name=model_id,
            acc=self.acc,
            slices_per_replica=self.acc_count,
            max_batch_size=self.max_batch_size,
            at_tokens=self.at_tokens or self.max_batch_size,
            decode_parms=self.decode_parms,
            prefill_parms=self.prefill_parms,
            disagg=self.disagg,
            context_buckets=[
                ContextBucketSpec(
                    max_in_tokens=b.max_in_tokens,
                    max_batch_size=b.max_batch_size,
                    at_tokens=b.at_tokens,
                    decode_parms=b.decode_parms,
                    prefill_parms=b.prefill_parms,
                )
                for b in self.context_buckets
            ],
        )
        return base.at_context(avg_in_tokens)

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "acc": self.acc,
            "accCount": self.acc_count,
            "maxBatchSize": self.max_batch_size,
            "atTokens": self.at_tokens,
            "perfParms": _perf_parms_to_dict(self.decode_parms, self.prefill_parms),
        }
        if self.disagg is not None:
            out["disagg"] = self.disagg.to_dict()
        if self.context_buckets:
            out["contextBuckets"] = [b.to_dict() for b in self.context_buckets]
        return out

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "AcceleratorProfile":
        decode, prefill = _perf_parms_from_dict(d)
        dg = d.get("disagg")
        return cls(
            acc=d.get("acc", ""),
            acc_count=int(d.get("accCount", 1) or 1),
            max_batch_size=int(d.get("maxBatchSize", 1) or 1),
            at_tokens=int(d.get("atTokens", 0) or 0),
            decode_parms=decode,
            prefill_parms=prefill,
            disagg=DisaggSpec.from_dict(dg) if dg is not None else None,
            context_buckets=sorted(
                (ContextBucket.from_dict(b) for b in d.get("contextBuckets", []) or []),
                key=lambda b: b.max_in_tokens,
            ),
        )


@dataclasses.dataclass
class VariantAutoscalingSpec:
    """(reference: variantautoscaling_types.go:8-21)"""

    model_id: str
    slo_class_ref: ConfigMapKeyRef = dataclasses.field(
        default_factory=lambda: ConfigMapKeyRef("", "")
    )
    accelerators: list[AcceleratorProfile] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        return {
            "modelID": self.model_id,
            "sloClassRef": self.slo_class_ref.to_dict(),
            "modelProfile": {"accelerators": [a.to_dict() for a in self.accelerators]},
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "VariantAutoscalingSpec":
        profile = d.get("modelProfile", {}) or {}
        return cls(
            model_id=d.get("modelID", ""),
            slo_class_ref=ConfigMapKeyRef.from_dict(d.get("sloClassRef", {}) or {}),
            accelerators=[
                AcceleratorProfile.from_dict(a)
                for a in profile.get("accelerators", []) or []
            ],
        )


@dataclasses.dataclass
class LoadProfile:
    """(reference: variantautoscaling_types.go:126-135)"""

    arrival_rate: float = 0.0  # req/min
    avg_input_tokens: float = 0.0
    avg_output_tokens: float = 0.0

    def to_dict(self) -> dict[str, Any]:
        return {
            "arrivalRate": self.arrival_rate,
            "avgInputTokens": self.avg_input_tokens,
            "avgOutputTokens": self.avg_output_tokens,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "LoadProfile":
        return cls(
            arrival_rate=float(d.get("arrivalRate", 0) or 0),
            avg_input_tokens=float(d.get("avgInputTokens", 0) or 0),
            avg_output_tokens=float(d.get("avgOutputTokens", 0) or 0),
        )


@dataclasses.dataclass
class CurrentAlloc:
    """(reference Allocation: variantautoscaling_types.go:93-120)"""

    accelerator: str = ""
    num_replicas: int = 0
    max_batch: int = 0
    variant_cost: float = 0.0
    itl_average: float = 0.0
    ttft_average: float = 0.0
    load: LoadProfile = dataclasses.field(default_factory=LoadProfile)

    def to_dict(self) -> dict[str, Any]:
        return {
            "accelerator": self.accelerator,
            "numReplicas": self.num_replicas,
            "maxBatch": self.max_batch,
            "variantCost": self.variant_cost,
            "itlAverage": self.itl_average,
            "ttftAverage": self.ttft_average,
            "load": self.load.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "CurrentAlloc":
        return cls(
            accelerator=d.get("accelerator", "") or "",
            num_replicas=int(d.get("numReplicas", 0) or 0),
            max_batch=int(d.get("maxBatch", 0) or 0),
            variant_cost=float(d.get("variantCost", 0) or 0),
            itl_average=float(d.get("itlAverage", 0) or 0),
            ttft_average=float(d.get("ttftAverage", 0) or 0),
            load=LoadProfile.from_dict(d.get("load", {}) or {}),
        )


@dataclasses.dataclass
class OptimizedAlloc:
    """(reference: variantautoscaling_types.go:138-149)"""

    accelerator: str = ""
    num_replicas: int = 0
    last_run_time: str = ""

    def to_dict(self) -> dict[str, Any]:
        return {
            "accelerator": self.accelerator,
            "numReplicas": self.num_replicas,
            "lastRunTime": self.last_run_time,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "OptimizedAlloc":
        return cls(
            accelerator=d.get("accelerator", "") or "",
            num_replicas=int(d.get("numReplicas", 0) or 0),
            last_run_time=d.get("lastRunTime", "") or "",
        )


@dataclasses.dataclass
class Condition:
    """metav1.Condition shape."""

    type: str
    status: str  # "True" | "False" | "Unknown"
    reason: str = ""
    message: str = ""
    last_transition_time: str = ""

    def to_dict(self) -> dict[str, Any]:
        return {
            "type": self.type,
            "status": self.status,
            "reason": self.reason,
            "message": self.message,
            "lastTransitionTime": self.last_transition_time,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Condition":
        return cls(
            type=d.get("type", ""),
            status=d.get("status", "Unknown"),
            reason=d.get("reason", ""),
            message=d.get("message", ""),
            last_transition_time=d.get("lastTransitionTime", ""),
        )


@dataclasses.dataclass
class VariantAutoscalingStatus:
    """(reference: variantautoscaling_types.go:73-90)"""

    current_alloc: CurrentAlloc = dataclasses.field(default_factory=CurrentAlloc)
    desired_optimized_alloc: OptimizedAlloc = dataclasses.field(
        default_factory=OptimizedAlloc
    )
    actuation_applied: bool = False
    conditions: list[Condition] = dataclasses.field(default_factory=list)

    def set_condition(
        self, ctype: str, status: str, reason: str, message: str
    ) -> None:
        """Upsert keeping lastTransitionTime stable unless status flips
        (reference: api/v1alpha1/conditions.go:9-19)."""
        for c in self.conditions:
            if c.type == ctype:
                if c.status != status:
                    c.last_transition_time = _utcnow()
                c.status, c.reason, c.message = status, reason, message
                return
        self.conditions.append(
            Condition(
                type=ctype,
                status=status,
                reason=reason,
                message=message,
                last_transition_time=_utcnow(),
            )
        )

    def condition(self, ctype: str) -> Condition | None:
        for c in self.conditions:
            if c.type == ctype:
                return c
        return None

    def to_dict(self) -> dict[str, Any]:
        return {
            "currentAlloc": self.current_alloc.to_dict(),
            "desiredOptimizedAlloc": self.desired_optimized_alloc.to_dict(),
            "actuation": {"applied": self.actuation_applied},
            "conditions": [c.to_dict() for c in self.conditions],
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "VariantAutoscalingStatus":
        return cls(
            current_alloc=CurrentAlloc.from_dict(d.get("currentAlloc", {}) or {}),
            desired_optimized_alloc=OptimizedAlloc.from_dict(
                d.get("desiredOptimizedAlloc", {}) or {}
            ),
            actuation_applied=bool((d.get("actuation", {}) or {}).get("applied", False)),
            conditions=[Condition.from_dict(c) for c in d.get("conditions", []) or []],
        )


@dataclasses.dataclass
class VariantAutoscaling:
    """The full custom resource (metadata + spec + status)."""

    name: str
    namespace: str = "default"
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    owner_references: list[dict] = dataclasses.field(default_factory=list)
    deletion_timestamp: str = ""
    generation: int = 1
    spec: VariantAutoscalingSpec = dataclasses.field(
        default_factory=lambda: VariantAutoscalingSpec(model_id="")
    )
    status: VariantAutoscalingStatus = dataclasses.field(
        default_factory=VariantAutoscalingStatus
    )

    @property
    def full_name(self) -> str:
        """System server key (reference FullName: internal/utils/utils.go:334-336)."""
        return f"{self.name}:{self.namespace}"

    @property
    def active(self) -> bool:
        """Not being deleted (reference filterActiveVAs:
        internal/controller/variantautoscaling_controller.go:204-215)."""
        return not self.deletion_timestamp

    def to_dict(self) -> dict[str, Any]:
        meta: dict[str, Any] = {
            "name": self.name,
            "namespace": self.namespace,
            "labels": dict(self.labels),
            "generation": self.generation,
        }
        if self.owner_references:
            meta["ownerReferences"] = list(self.owner_references)
        if self.deletion_timestamp:
            meta["deletionTimestamp"] = self.deletion_timestamp
        return {
            "apiVersion": f"{GROUP}/{VERSION}",
            "kind": KIND,
            "metadata": meta,
            "spec": self.spec.to_dict(),
            "status": self.status.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "VariantAutoscaling":
        meta = d.get("metadata", {}) or {}
        return cls(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
            labels=dict(meta.get("labels", {}) or {}),
            owner_references=list(meta.get("ownerReferences", []) or []),
            deletion_timestamp=meta.get("deletionTimestamp", "") or "",
            generation=int(meta.get("generation", 1) or 1),
            spec=VariantAutoscalingSpec.from_dict(d.get("spec", {}) or {}),
            status=VariantAutoscalingStatus.from_dict(d.get("status", {}) or {}),
        )
