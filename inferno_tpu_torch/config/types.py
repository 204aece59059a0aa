"""Serializable system specification.

Capability parity with the reference's spec structs
(upstream pkg/config/types.go:11-155), re-expressed for TPU:

* an "accelerator" is a TPU *slice shape* (v5e-4, v5p-8, ...) whose cost is
  chips × per-chip $/hr, instead of a GPU card bundle with a multiplicity;
* capacity is counted in *chips per generation pool* with whole-host
  granularity, instead of cards per GPU type;
* everything is a plain dataclass with `to_dict`/`from_dict` for round-trip
  through ConfigMaps/JSON — no Kubernetes types leak in here.

This module is pure data: no I/O, no JAX, importable anywhere.

Port copy of `inferno_tpu/config/types.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from inferno_tpu_torch.config.defaults import (
    SPOT_RECOVERY_SECONDS,
    SPOT_RISK_PENALTY_FACTOR,
    SaturationPolicy,
)
from inferno_tpu_torch.config.tpu_catalog import SliceShape, slice_shape


def _get(d: Mapping[str, Any], *names: str, default: Any = None) -> Any:
    for n in names:
        if n in d:
            return d[n]
    return default


@dataclasses.dataclass(frozen=True)
class PowerSpec:
    """Piecewise-linear per-chip power profile: watts at idle, at an
    inflection utilization `mid_util`, and at full utilization
    (reference PowerSpec: pkg/config/types.go:40-45)."""

    idle: float = 0.0  # watts per chip at 0 utilization
    full: float = 0.0  # watts per chip at 100% utilization
    mid_power: float = 0.0  # watts per chip at the inflection point
    mid_util: float = 0.5  # utilization of the inflection point, (0,1)

    def to_dict(self) -> dict[str, Any]:
        return {
            "idle": self.idle,
            "full": self.full,
            "midPower": self.mid_power,
            "midUtil": self.mid_util,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "PowerSpec":
        idle = float(d.get("idle", 0.0) or 0.0)
        full = float(d.get("full", 0.0) or 0.0)
        # Explicit zeros are meaningful (midUtil 0 selects the linear
        # fallback), so only a *missing* key gets a default.
        mid_power = d.get("midPower")
        mid_util = d.get("midUtil")
        return cls(
            idle=idle,
            full=full,
            mid_power=(idle + full) / 2 if mid_power is None else float(mid_power),
            mid_util=0.5 if mid_util is None else float(mid_util),
        )


@dataclasses.dataclass
class AcceleratorSpec:
    """One allocatable TPU slice shape.

    TPU analogue of the reference's AcceleratorSpec
    (pkg/config/types.go:29-37): `name` is the slice shape, `pool` is the
    capacity pool (generation), `chips` replaces multiplicity, and `cost`
    is derived from per-chip pricing.
    """

    name: str  # slice shape name, e.g. "v5e-16"
    pool: str = ""  # capacity pool / generation; default from name
    chips: int = 0  # chips per slice; default from catalog
    # placement region/zone ("" = unregioned): allocations on this shape
    # additionally draw from any matching "pool/region" quota bucket
    # (CapacitySpec.quotas) when one is configured
    region: str = ""
    # whether this shape is offered on its pool's spot tier
    # (CapacitySpec.spot): False keeps every replica of this shape on
    # reserved capacity even when the pool has a spot market — the lever
    # for shapes the provider never sells preemptible (e.g. large
    # multi-host reservations)
    spot_eligible: bool = True
    mem_per_chip_gb: float = 16.0  # HBM per chip
    mem_bw_gbs: float = 820.0  # HBM bandwidth per chip
    cost_per_chip_hr: float = 0.0  # cents per chip-hour
    power: PowerSpec = dataclasses.field(default_factory=PowerSpec)

    def __post_init__(self) -> None:
        shape = slice_shape(self.name)
        if not self.pool:
            self.pool = shape.generation
        if not self.chips:
            self.chips = shape.chips

    @property
    def shape(self) -> SliceShape:
        return slice_shape(self.name)

    @property
    def cost(self) -> float:
        """Cost of one slice of this shape, cents/hr."""
        return self.cost_per_chip_hr * self.chips

    @property
    def mem_gb(self) -> float:
        return self.mem_per_chip_gb * self.chips

    def to_dict(self) -> dict[str, Any]:
        out = {
            "name": self.name,
            "pool": self.pool,
            "chips": self.chips,
            "region": self.region,
            "memPerChipGB": self.mem_per_chip_gb,
            "memBWGBs": self.mem_bw_gbs,
            "costPerChipHr": self.cost_per_chip_hr,
            "power": self.power.to_dict(),
        }
        # emitted only when non-default so pre-spot documents (and their
        # recorder fingerprints) round-trip byte-identically
        if not self.spot_eligible:
            out["spotEligible"] = False
        return out

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "AcceleratorSpec":
        return cls(
            name=d["name"],
            pool=_get(d, "pool", "type", default=""),
            chips=int(_get(d, "chips", "multiplicity", default=0) or 0),
            region=str(d.get("region", "") or ""),
            spot_eligible=bool(d.get("spotEligible", True)),
            mem_per_chip_gb=float(_get(d, "memPerChipGB", "memSize", default=16.0)),
            mem_bw_gbs=float(_get(d, "memBWGBs", "memBW", default=820.0)),
            cost_per_chip_hr=float(_get(d, "costPerChipHr", "cost", default=0.0)),
            power=PowerSpec.from_dict(d.get("power", {}) or {}),
        )


@dataclasses.dataclass(frozen=True)
class DecodeParms:
    """decode time(batch) = alpha + beta * batch (msec)
    (reference: pkg/config/types.go:74-78)."""

    alpha: float = 0.0
    beta: float = 0.0


@dataclasses.dataclass(frozen=True)
class PrefillParms:
    """prefill time(batch) = gamma + delta * inputTokens * batch (msec)
    (reference: pkg/config/types.go:80-84)."""

    gamma: float = 0.0
    delta: float = 0.0


@dataclasses.dataclass(frozen=True)
class DisaggSpec:
    """Shape of one disaggregated (JetStream-style) replica unit: separate
    prefill and decode engines scheduled as an atomic group.

    `prefill_slices` / `decode_slices`: engines of each role per unit. Each
    engine occupies `ModelPerfSpec.slices_per_replica` pod-slices, so the
    unit's total slice footprint is
    slices_per_replica * (prefill_slices + decode_slices).
    `prefill_max_batch`: concurrent prompts per prefill engine (JetStream
    typically runs few, large prefill batches; 0 = same as decode batch).
    """

    prefill_slices: int = 1
    decode_slices: int = 1
    prefill_max_batch: int = 0

    def validate(self) -> None:
        if self.prefill_slices < 1 or self.decode_slices < 1:
            raise ValueError(f"invalid disagg spec {self}")
        if self.prefill_max_batch < 0:
            raise ValueError(f"invalid disagg spec {self}")

    @property
    def slices_per_unit(self) -> int:
        return self.prefill_slices + self.decode_slices

    def to_dict(self) -> dict[str, Any]:
        return {
            "prefillSlices": self.prefill_slices,
            "decodeSlices": self.decode_slices,
            "prefillMaxBatch": self.prefill_max_batch,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "DisaggSpec":
        def _int(key: str, default: int) -> int:
            v = d.get(key)
            # missing/null -> default; an explicit invalid value (e.g. 0
            # engines) is preserved so validate() rejects it downstream
            return default if v is None else int(v)

        return cls(
            prefill_slices=_int("prefillSlices", 1),
            decode_slices=_int("decodeSlices", 1),
            prefill_max_batch=_int("prefillMaxBatch", 0),
        )


def select_bucket(buckets, avg_in_tokens: float):
    """THE context-bucket resolution rule, shared by the config-side
    `ModelPerfSpec.at_context` and the CRD-side
    `AcceleratorProfile.bucket_for` (controller/crd.py): the smallest
    bucket covering the observed average input length, or None when none
    applies. Works on any objects with a `max_in_tokens` attribute."""
    if avg_in_tokens <= 0:
        return None
    eligible = [b for b in buckets if b.max_in_tokens >= avg_in_tokens]
    if not eligible:
        return None
    return min(eligible, key=lambda b: b.max_in_tokens)


@dataclasses.dataclass(frozen=True)
class ContextBucketSpec:
    """Latency parms refit at a context-length bucket. Wire shape matches
    the CRD's `contextBuckets` entries (controller/crd.py ContextBucket):
    the sizing-relevant fields round-trip; fit provenance stays in the
    JSON document (SURVEY §5.7: long context as profile dimensions)."""

    max_in_tokens: int  # bucket upper bound, e.g. 4096 / 16384 / 65536
    max_batch_size: int = 0  # 0 = inherit the profile's base batch
    # token count max_batch_size was sized at (KV budget per admitted
    # request); 0 = fall back to max_in_tokens
    at_tokens: int = 0
    decode_parms: DecodeParms = dataclasses.field(default_factory=DecodeParms)
    prefill_parms: PrefillParms = dataclasses.field(default_factory=PrefillParms)

    def to_dict(self) -> dict[str, Any]:
        return {
            "maxInTokens": self.max_in_tokens,
            "maxBatchSize": self.max_batch_size,
            "atTokens": self.at_tokens,
            "perfParms": {
                "decodeParms": {"alpha": self.decode_parms.alpha, "beta": self.decode_parms.beta},
                "prefillParms": {"gamma": self.prefill_parms.gamma, "delta": self.prefill_parms.delta},
            },
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ContextBucketSpec":
        pp = d.get("perfParms", {}) or {}
        dp = pp.get("decodeParms", {}) or {}
        fp = pp.get("prefillParms", {}) or {}
        return cls(
            max_in_tokens=int(d.get("maxInTokens", 0) or 0),
            max_batch_size=int(d.get("maxBatchSize", 0) or 0),
            at_tokens=int(d.get("atTokens", 0) or 0),
            decode_parms=DecodeParms(float(dp.get("alpha", 0.0) or 0.0),
                                     float(dp.get("beta", 0.0) or 0.0)),
            prefill_parms=PrefillParms(float(fp.get("gamma", 0.0) or 0.0),
                                       float(fp.get("delta", 0.0) or 0.0)),
        )


@dataclasses.dataclass
class ModelPerfSpec:
    """Performance profile of one model on one slice shape
    (reference: pkg/config/types.go:63-72).

    `slices_per_replica` is the TPU analogue of accCount: the number of
    slice units one replica of the model occupies (normally 1 — the slice
    shape itself encodes the parallelism footprint).
    """

    name: str  # model id
    acc: str  # slice shape name
    slices_per_replica: int = 1
    max_batch_size: int = 0
    at_tokens: int = 0  # avg tokens/request assumed for max_batch_size
    decode_parms: DecodeParms = dataclasses.field(default_factory=DecodeParms)
    prefill_parms: PrefillParms = dataclasses.field(default_factory=PrefillParms)
    # Set for disaggregated (JetStream-style) serving: one replica is then a
    # unit of prefill_slices + decode_slices pod-slices of this shape, sized
    # by the tandem model in inferno_tpu_torch.analyzer.disagg.
    disagg: DisaggSpec | None = None
    # measured long-context buckets, sorted ascending by max_in_tokens;
    # base parms serve loads beyond the largest bucket
    context_buckets: list[ContextBucketSpec] = dataclasses.field(default_factory=list)

    def at_context(self, avg_in_tokens: float) -> "ModelPerfSpec":
        """Resolve to the smallest bucket covering the observed average
        input length; self unchanged when no bucket applies.

        `at_tokens` must track the bucket's own sizing token count: the
        downstream K-rescale (batch = max_batch_size * at_tokens / K)
        assumes at_tokens is the context the cap was computed at — keeping
        the base value would inflate a long-context cap ~at_tokens-fold."""
        b = select_bucket(self.context_buckets, avg_in_tokens)
        if b is None:
            return self
        if b.max_batch_size <= 0:
            return dataclasses.replace(
                self, decode_parms=b.decode_parms, prefill_parms=b.prefill_parms
            )
        return dataclasses.replace(
            self,
            decode_parms=b.decode_parms,
            prefill_parms=b.prefill_parms,
            max_batch_size=b.max_batch_size,
            at_tokens=b.at_tokens or b.max_in_tokens,
        )

    def to_dict(self) -> dict[str, Any]:
        out = {
            "name": self.name,
            "acc": self.acc,
            "slicesPerReplica": self.slices_per_replica,
            "maxBatchSize": self.max_batch_size,
            "atTokens": self.at_tokens,
            "decodeParms": {"alpha": self.decode_parms.alpha, "beta": self.decode_parms.beta},
            "prefillParms": {"gamma": self.prefill_parms.gamma, "delta": self.prefill_parms.delta},
        }
        if self.disagg is not None:
            out["disagg"] = self.disagg.to_dict()
        if self.context_buckets:
            out["contextBuckets"] = [b.to_dict() for b in self.context_buckets]
        return out

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ModelPerfSpec":
        dp = _get(d, "decodeParms", default={}) or {}
        pp = _get(d, "prefillParms", default={}) or {}
        dg = _get(d, "disagg", default=None)
        return cls(
            name=d["name"],
            acc=d["acc"],
            slices_per_replica=int(_get(d, "slicesPerReplica", "accCount", default=1) or 1),
            max_batch_size=int(_get(d, "maxBatchSize", default=0) or 0),
            at_tokens=int(_get(d, "atTokens", default=0) or 0),
            decode_parms=DecodeParms(float(dp.get("alpha", 0.0)), float(dp.get("beta", 0.0))),
            prefill_parms=PrefillParms(float(pp.get("gamma", 0.0)), float(pp.get("delta", 0.0))),
            # `{}` is a valid spec (all defaults); only absent/null disables
            disagg=DisaggSpec.from_dict(dg) if dg is not None else None,
            context_buckets=sorted(
                (ContextBucketSpec.from_dict(b) for b in d.get("contextBuckets", []) or []),
                key=lambda b: b.max_in_tokens,
            ),
        )


@dataclasses.dataclass(frozen=True)
class ModelTarget:
    """SLO targets for one model within a service class
    (reference: pkg/config/types.go:99-104)."""

    model: str
    slo_itl: float = 0.0  # inter-token latency, msec (0 = no target)
    slo_ttft: float = 0.0  # time to first token incl. queueing, msec
    slo_tps: float = 0.0  # token throughput, tokens/sec

    def to_dict(self) -> dict[str, Any]:
        return {
            "model": self.model,
            "slo-itl": self.slo_itl,
            "slo-ttft": self.slo_ttft,
            "slo-tps": self.slo_tps,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ModelTarget":
        return cls(
            model=d["model"],
            slo_itl=float(_get(d, "slo-itl", "slo-tpot", "sloItl", default=0.0) or 0.0),
            slo_ttft=float(_get(d, "slo-ttft", "sloTtft", default=0.0) or 0.0),
            slo_tps=float(_get(d, "slo-tps", "sloTps", default=0.0) or 0.0),
        )


@dataclasses.dataclass
class ServiceClassSpec:
    """A service class: priority plus per-model SLO targets
    (reference: pkg/config/types.go:92-96)."""

    name: str
    priority: int  # [1,100], lower value = higher priority
    model_targets: list[ModelTarget] = dataclasses.field(default_factory=list)

    def target_for(self, model: str) -> ModelTarget | None:
        for t in self.model_targets:
            if t.model == model:
                return t
        return None

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "priority": self.priority,
            "modelTargets": [t.to_dict() for t in self.model_targets],
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ServiceClassSpec":
        return cls(
            name=d["name"],
            priority=int(d.get("priority", 100)),
            model_targets=[ModelTarget.from_dict(t) for t in _get(d, "modelTargets", "data", default=[]) or []],
        )


@dataclasses.dataclass
class ServerLoadSpec:
    """Observed load statistics for a server
    (reference: pkg/config/types.go:135-139)."""

    arrival_rate: float = 0.0  # requests/min
    avg_in_tokens: int = 0
    avg_out_tokens: int = 0

    def to_dict(self) -> dict[str, Any]:
        return {
            "arrivalRate": self.arrival_rate,
            "avgInTokens": self.avg_in_tokens,
            "avgOutTokens": self.avg_out_tokens,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ServerLoadSpec":
        return cls(
            arrival_rate=float(d.get("arrivalRate", 0.0) or 0.0),
            avg_in_tokens=int(d.get("avgInTokens", 0) or 0),
            avg_out_tokens=int(d.get("avgOutTokens", 0) or 0),
        )


@dataclasses.dataclass
class AllocationData:
    """A (possibly current, possibly desired) allocation of a slice shape to
    a server (reference: pkg/config/types.go:124-132)."""

    accelerator: str = ""  # slice shape name; "" = none
    num_replicas: int = 0  # pod-slices
    max_batch: int = 0
    cost: float = 0.0  # cents/hr
    itl_average: float = 0.0  # msec
    ttft_average: float = 0.0  # msec
    # replicas of this allocation placed on the pool's spot tier
    # (0 <= spot_replicas <= num_replicas; always 0 without a tier)
    spot_replicas: int = 0
    load: ServerLoadSpec = dataclasses.field(default_factory=ServerLoadSpec)

    def to_dict(self) -> dict[str, Any]:
        out = {
            "accelerator": self.accelerator,
            "numReplicas": self.num_replicas,
            "maxBatch": self.max_batch,
            "cost": self.cost,
            "itlAverage": self.itl_average,
            "ttftAverage": self.ttft_average,
            "load": self.load.to_dict(),
        }
        # emitted only when spot placed, so pre-spot documents (and the
        # flight recorder's canonicalized snapshot fingerprints) are
        # byte-identical with the tier disabled
        if self.spot_replicas:
            out["spotReplicas"] = self.spot_replicas
        return out

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "AllocationData":
        return cls(
            accelerator=d.get("accelerator", "") or "",
            num_replicas=int(d.get("numReplicas", 0) or 0),
            max_batch=int(d.get("maxBatch", 0) or 0),
            cost=float(d.get("cost", 0.0) or 0.0),
            itl_average=float(d.get("itlAverage", 0.0) or 0.0),
            ttft_average=float(d.get("ttftAverage", 0.0) or 0.0),
            spot_replicas=int(d.get("spotReplicas", 0) or 0),
            load=ServerLoadSpec.from_dict(d.get("load", {}) or {}),
        )


@dataclasses.dataclass
class ServerSpec:
    """One managed inference server variant
    (reference: pkg/config/types.go:112-121)."""

    name: str
    class_name: str = ""
    model: str = ""
    keep_accelerator: bool = False
    min_num_replicas: int = 0
    max_batch_size: int = 0  # overrides profile-derived batch if > 0
    current_alloc: AllocationData = dataclasses.field(default_factory=AllocationData)
    desired_alloc: AllocationData = dataclasses.field(default_factory=AllocationData)

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "class": self.class_name,
            "model": self.model,
            "keepAccelerator": self.keep_accelerator,
            "minNumReplicas": self.min_num_replicas,
            "maxBatchSize": self.max_batch_size,
            "currentAlloc": self.current_alloc.to_dict(),
            "desiredAlloc": self.desired_alloc.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ServerSpec":
        return cls(
            name=d["name"],
            class_name=_get(d, "class", "className", default="") or "",
            model=d.get("model", "") or "",
            keep_accelerator=bool(d.get("keepAccelerator", False)),
            min_num_replicas=int(d.get("minNumReplicas", 0) or 0),
            max_batch_size=int(d.get("maxBatchSize", 0) or 0),
            current_alloc=AllocationData.from_dict(d.get("currentAlloc", {}) or {}),
            desired_alloc=AllocationData.from_dict(d.get("desiredAlloc", {}) or {}),
        )


@dataclasses.dataclass
class OptimizerSpec:
    """Optimizer behavior switches (reference: pkg/config/types.go:151-155)."""

    unlimited: bool = True  # unlimited chip capacity (cloud / planning mode)
    delayed_best_effort: bool = False
    saturation_policy: str = SaturationPolicy.NONE.value

    def to_dict(self) -> dict[str, Any]:
        return {
            "unlimited": self.unlimited,
            "delayedBestEffort": self.delayed_best_effort,
            "saturationPolicy": self.saturation_policy,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "OptimizerSpec":
        return cls(
            unlimited=bool(d.get("unlimited", True)),
            delayed_best_effort=bool(d.get("delayedBestEffort", False)),
            saturation_policy=str(d.get("saturationPolicy", SaturationPolicy.NONE.value)),
        )


@dataclasses.dataclass(frozen=True)
class SpotPoolSpec:
    """One pool's preemptible (spot) tier: cheaper chips that can vanish
    in correlated eviction storms (ConfigMap/env key `TPU_SPOT_POOLS`,
    parsed with actionable validation by `spot.market.parse_spot_pools`).

    The risk model (`inferno_tpu/spot/market.py`) prices the tier:
    replicas placed on spot cost `(1 - discount)` of the reserved price;
    a storm arrives at `hazard_per_hr` and reclaims `blast_radius` of
    the pool's spot replicas at once, each taking `recovery_s` to
    re-provision. Spot replicas whose eviction would breach the SLO
    carry a risk premium in the solver objective, and the limited-mode
    solve pre-positions `ceil(blast_radius x spot chips)` of reserved
    headroom to absorb the implied blast radius.
    """

    discount: float  # fraction off the reserved price, (0, 1)
    hazard_per_hr: float = 0.0  # correlated eviction storms per hour
    blast_radius: float = 0.5  # fraction of spot replicas per storm, (0, 1]
    recovery_s: float = SPOT_RECOVERY_SECONDS  # eviction -> serving again
    chips: int = 0  # spot-tier chip budget; 0 = elastic (unbounded)
    penalty_factor: float = SPOT_RISK_PENALTY_FACTOR  # SLO-violation pricing

    def validate(self) -> None:
        if not 0.0 < self.discount < 1.0:
            raise ValueError(f"discount must be in (0, 1), got {self.discount}")
        if self.hazard_per_hr < 0.0:
            raise ValueError(
                f"hazardPerHr must be >= 0, got {self.hazard_per_hr}"
            )
        if not 0.0 < self.blast_radius <= 1.0:
            raise ValueError(
                f"blastRadius must be in (0, 1], got {self.blast_radius}"
            )
        if self.recovery_s <= 0.0:
            raise ValueError(
                f"recoverySeconds must be > 0, got {self.recovery_s}"
            )
        if self.chips < 0:
            raise ValueError(f"chips must be >= 0, got {self.chips}")
        if self.penalty_factor < 0.0:
            raise ValueError(
                f"penaltyFactor must be >= 0, got {self.penalty_factor}"
            )

    def to_dict(self) -> dict[str, Any]:
        return {
            "discount": self.discount,
            "hazardPerHr": self.hazard_per_hr,
            "blastRadius": self.blast_radius,
            "recoverySeconds": self.recovery_s,
            "chips": self.chips,
            "penaltyFactor": self.penalty_factor,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SpotPoolSpec":
        # explicit zeros are preserved (so validate() can reject them
        # with the field's own message); only a MISSING key defaults
        def _get(key: str, default: float) -> float:
            v = d.get(key)
            return default if v is None else float(v)

        return cls(
            discount=float(d["discount"]),
            hazard_per_hr=_get("hazardPerHr", 0.0),
            blast_radius=_get("blastRadius", 0.5),
            recovery_s=_get("recoverySeconds", SPOT_RECOVERY_SECONDS),
            chips=int(d.get("chips", 0) or 0),
            penalty_factor=_get("penaltyFactor", SPOT_RISK_PENALTY_FACTOR),
        )


@dataclasses.dataclass
class CapacitySpec:
    """Available chips per pool (generation), e.g. {"v5e": 64, "v5p": 32}.

    TPU analogue of the reference's per-type card counts
    (pkg/config/types.go:48-56): the unit here is a *chip*, and allocations
    consume chips in whole-slice (hence whole-host) quanta.

    `quotas` layers sub-budgets on top of the pool totals: a key is either
    a bare pool name (a pool-wide cap tighter than discovered inventory)
    or "pool/region" (a per-region carve-out matched against
    `AcceleratorSpec.region`). An allocation must fit its pool budget AND
    every matching quota bucket; a pool or quota absent from `chips` /
    `quotas` respectively means zero capacity / no extra constraint.

    `spot` attaches a preemptible tier per pool (`SpotPoolSpec`): spot
    replicas draw the tier's own chip budget instead of the pool budget
    (quotas constrain reserved commitments only), at a discounted,
    eviction-risk-adjusted price.
    """

    chips: dict[str, int] = dataclasses.field(default_factory=dict)
    quotas: dict[str, int] = dataclasses.field(default_factory=dict)
    spot: dict[str, SpotPoolSpec] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {"chips": dict(self.chips)}
        if self.quotas:
            out["quotas"] = dict(self.quotas)
        if self.spot:
            out["spot"] = {k: v.to_dict() for k, v in self.spot.items()}
        return out

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "CapacitySpec":
        quotas = {k: int(v) for k, v in (d.get("quotas", {}) or {}).items()}
        spot = {
            k: SpotPoolSpec.from_dict(v)
            for k, v in (d.get("spot", {}) or {}).items()
        }
        if "chips" in d:
            return cls(
                chips={k: int(v) for k, v in d["chips"].items()},
                quotas=quotas, spot=spot,
            )
        # reference shape: {"count": [{"type": ..., "count": ...}]}
        counts = d.get("count", []) or []
        return cls(
            chips={c["type"]: int(c["count"]) for c in counts},
            quotas=quotas, spot=spot,
        )


@dataclasses.dataclass
class SystemSpec:
    """Everything the optimizer needs for one cycle
    (reference: pkg/config/types.go:11-21)."""

    accelerators: list[AcceleratorSpec] = dataclasses.field(default_factory=list)
    models: list[ModelPerfSpec] = dataclasses.field(default_factory=list)
    service_classes: list[ServiceClassSpec] = dataclasses.field(default_factory=list)
    servers: list[ServerSpec] = dataclasses.field(default_factory=list)
    optimizer: OptimizerSpec = dataclasses.field(default_factory=OptimizerSpec)
    capacity: CapacitySpec = dataclasses.field(default_factory=CapacitySpec)

    def to_dict(self) -> dict[str, Any]:
        return {
            "acceleratorData": {"accelerators": [a.to_dict() for a in self.accelerators]},
            "modelData": {"models": [m.to_dict() for m in self.models]},
            "serviceClassData": {"serviceClasses": [s.to_dict() for s in self.service_classes]},
            "serverData": {"servers": [s.to_dict() for s in self.servers]},
            "optimizerData": {"optimizer": self.optimizer.to_dict()},
            "capacityData": self.capacity.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SystemSpec":
        if "system" in d:
            d = d["system"]
        return cls(
            accelerators=[
                AcceleratorSpec.from_dict(a)
                for a in (d.get("acceleratorData", {}) or {}).get("accelerators", []) or []
            ],
            models=[
                ModelPerfSpec.from_dict(m)
                for m in (d.get("modelData", {}) or {}).get("models", []) or []
            ],
            service_classes=[
                ServiceClassSpec.from_dict(s)
                for s in (d.get("serviceClassData", {}) or {}).get("serviceClasses", []) or []
            ],
            servers=[
                ServerSpec.from_dict(s)
                for s in (d.get("serverData", {}) or {}).get("servers", []) or []
            ],
            optimizer=OptimizerSpec.from_dict(
                (d.get("optimizerData", {}) or {}).get("optimizer", {}) or {}
            ),
            capacity=CapacitySpec.from_dict(d.get("capacityData", {}) or {}),
        )
