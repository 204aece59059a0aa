"""Allocation sizing: how many pod-slice replicas of which slice shape.

Capability parity with the reference's sizing routine
(upstream pkg/core/allocation.go:27-300), with TPU economics:

* a replica is a *pod-slice* (possibly multi-host, scheduled atomically);
* cost = replicas × slices_per_replica × slice.chips × $/chip-hr;
* transitions between slice shapes carry a penalty (slice re-provisioning
  tears down a whole multi-host pod group).

Unlike the reference there is no global singleton system: sizing takes the
`System` explicitly, so concurrent optimization cycles are safe.

Port copy of `inferno_tpu/core/allocation.py`, verbatim apart from its
imports.
"""

from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING

from inferno_tpu_torch.analyzer import (
    AnalyzerError,
    RequestSize,
    TargetPerf,
    build_analyzer,
    build_disagg_analyzer,
)
from inferno_tpu_torch.config.defaults import ACCEL_PENALTY_FACTOR, MAX_QUEUE_TO_BATCH_RATIO
from inferno_tpu_torch.config.types import AllocationData

if TYPE_CHECKING:  # avoid a cycle at import time
    from inferno_tpu_torch.core.system import System


@dataclasses.dataclass
class Allocation:
    """An allocation of a slice shape to a server
    (reference: pkg/core/allocation.go:13-24)."""

    accelerator: str  # slice shape name; "" = no allocation
    num_replicas: int  # pod-slices
    batch_size: int
    cost: float  # cents/hr (spot discount already applied)
    value: float = 0.0  # solver objective (cost or transition penalty)
    itl: float = 0.0  # expected avg token decode time, msec
    ttft: float = 0.0  # expected avg queueing + prefill time, msec
    rho: float = 0.0  # expected utilization
    max_arrv_rate_per_replica: float = 0.0  # req/msec
    # -- spot tier (inferno_tpu/spot/market.py; all zero when the pool
    # has no spot tier, keeping pre-spot behavior bit-identical) --------
    spot_replicas: int = 0  # replicas placed on the preemptible tier
    spot_discount: float = 0.0  # cents/hr taken off the reserved price
    # risk premium (cents/hr) the solver objective carries for risky
    # spot replicas — added to `value` on top of the transition penalty,
    # never to the reported cost
    spot_premium: float = 0.0
    # risk (not price) capped spot below the full replica count: the
    # `spot_risk_bound` decision-reason signal
    spot_trimmed: bool = False

    @property
    def max_rpm(self) -> float:
        """Max sustainable request rate per replica, req/min
        (reference: pkg/core/allocation.go:233-235)."""
        return self.max_arrv_rate_per_replica * 1000.0 * 60.0

    def saturated(self, total_rate_rpm: float) -> bool:
        """(reference: pkg/core/allocation.go:254-256)"""
        return total_rate_rpm > self.num_replicas * self.max_rpm

    def clone(self) -> "Allocation":
        return dataclasses.replace(self)

    def to_data(self) -> AllocationData:
        """(reference: pkg/core/allocation.go:317-326)"""
        return AllocationData(
            accelerator=self.accelerator,
            num_replicas=self.num_replicas,
            max_batch=self.batch_size,
            cost=self.cost,
            itl_average=self.itl,
            ttft_average=self.ttft,
            spot_replicas=self.spot_replicas,
        )


def allocation_from_data(data: AllocationData) -> Allocation:
    """(reference: pkg/core/allocation.go:328-337)"""
    return Allocation(
        accelerator=data.accelerator,
        num_replicas=data.num_replicas,
        batch_size=data.max_batch,
        cost=data.cost,
        itl=data.itl_average,
        ttft=data.ttft_average,
        spot_replicas=data.spot_replicas,
    )


def create_allocation(system: "System", server_name: str, acc_name: str) -> Allocation | None:
    """Size the cheapest feasible allocation of slice shape `acc_name` to
    server `server_name`; None if infeasible or data is missing
    (reference: pkg/core/allocation.go:27-163)."""
    acc = system.accelerators.get(acc_name)
    server = system.servers.get(server_name)
    if acc is None or server is None:
        return None
    load = server.load
    if load is None or load.arrival_rate < 0 or load.avg_in_tokens < 0 or load.avg_out_tokens < 0:
        return None
    model = system.models.get(server.model_name)
    if model is None:
        return None
    perf = model.perf_data.get(acc_name)
    if perf is None:
        return None
    svc = system.service_classes.get(server.service_class_name)
    if svc is None:
        return None
    target = svc.target_for(server.model_name)
    if target is None:
        return None

    if load.arrival_rate == 0 or load.avg_out_tokens == 0:
        alloc = _zero_load_allocation(server, model, acc, perf)
        # zero-load spot: no load-required replicas, so every held
        # replica is storm-safe slack — full discount, no premium
        _apply_spot(
            system, alloc, acc.cost * model.slices_per_replica(acc_name), 0
        )
        return alloc

    # max batch size scaled by the average output length K relative to the
    # token count the profile's max batch was measured at
    # (reference: pkg/core/allocation.go:78-87)
    k_out = load.avg_out_tokens
    if server.max_batch_size > 0:
        batch = server.max_batch_size
    else:
        batch = max(perf.max_batch_size * perf.at_tokens // k_out, 1)
    max_queue = batch * MAX_QUEUE_TO_BATCH_RATIO

    request = RequestSize(avg_in_tokens=load.avg_in_tokens, avg_out_tokens=k_out)
    try:
        if perf.disagg is not None:
            # JetStream-style disaggregated serving: one replica is an atomic
            # prefill+decode unit, sized by the tandem model.
            qa = build_disagg_analyzer(
                max_batch=batch,
                max_queue=max_queue,
                decode=perf.decode_parms,
                prefill=perf.prefill_parms,
                request=request,
                spec=perf.disagg,
            )
        else:
            qa = build_analyzer(
                max_batch=batch,
                max_queue=max_queue,
                decode=perf.decode_parms,
                prefill=perf.prefill_parms,
                request=request,
            )
        _, metrics, _ = qa.size(
            TargetPerf(
                target_ttft=target.slo_ttft,
                target_itl=target.slo_itl,
                target_tps=target.slo_tps,
            )
        )
    except AnalyzerError:
        return None
    rate_star = metrics.throughput  # req/sec at the binding rate

    # replicas to carry the total load (reference: pkg/core/allocation.go:133-141)
    if target.slo_tps == 0:
        total_rate = load.arrival_rate / 60.0  # req/min -> req/sec
    else:
        total_rate = target.slo_tps / float(k_out)
    num_replicas = max(math.ceil(total_rate / rate_star), server.min_num_replicas)

    # TPU cost: slices × chips/slice × $/chip-hr
    # (reference formula: pkg/core/allocation.go:143-145)
    slices = model.slices_per_replica(acc_name) * num_replicas
    cost = acc.cost * slices

    # expected per-replica operating point (reference: allocation.go:147-157)
    try:
        per_replica = qa.analyze(total_rate / num_replicas)
    except AnalyzerError:
        return None

    alloc = Allocation(
        accelerator=acc_name,
        num_replicas=num_replicas,
        batch_size=batch,
        cost=cost,
        itl=per_replica.avg_token_time,
        ttft=per_replica.avg_wait_time + per_replica.avg_prefill_time,
        rho=per_replica.rho,
        max_arrv_rate_per_replica=rate_star / 1000.0,
    )
    alloc.value = alloc.cost
    # spot tier (inferno_tpu/spot/market.py): replicas above the
    # load-required count are storm-safe slack; the rest ride spot only
    # when the risk premium beats the discount. No-op without a tier.
    _apply_spot(
        system, alloc,
        acc.cost * model.slices_per_replica(acc_name),
        math.ceil(total_rate / rate_star),
    )
    return alloc


def _apply_spot(system, alloc, cost_per_replica, required) -> None:
    """Local-import shim for spot.market.apply_spot (the spot package
    imports config only; this keeps core <-> spot acyclic)."""
    if not getattr(system, "spot", None):
        return
    from inferno_tpu_torch.spot.market import apply_spot

    apply_spot(system, alloc, cost_per_replica, required)


def _zero_load_allocation(server, model, acc, perf) -> Allocation:
    """Allocation under zero traffic: hold min replicas (possibly zero)
    (reference: pkg/core/allocation.go:259-288)."""
    num_replicas = server.min_num_replicas
    if num_replicas == 0:
        return Allocation(accelerator="", num_replicas=0, batch_size=0, cost=0.0)

    batch = server.max_batch_size if server.max_batch_size > 0 else perf.max_batch_size
    slices = model.slices_per_replica(acc.name) * num_replicas
    cost = acc.cost * slices

    decode_1 = perf.decode_parms.alpha + perf.decode_parms.beta
    decode_full = perf.decode_parms.alpha + perf.decode_parms.beta * batch
    prefill_1 = perf.prefill_parms.gamma + perf.prefill_parms.delta
    if perf.disagg is not None:
        # disaggregated unit: the binding stage caps the unit's rate (same
        # one-token-per-stage convention as the aggregated bound below)
        dg = perf.disagg
        p_batch = dg.prefill_max_batch or batch
        prefill_full = perf.prefill_parms.gamma + perf.prefill_parms.delta * p_batch
        max_rate = min(
            dg.prefill_slices * p_batch / prefill_full,
            dg.decode_slices * batch / decode_full,
        )
    else:
        max_rate = batch / (prefill_1 + decode_full)
    alloc = Allocation(
        accelerator=acc.name,
        num_replicas=num_replicas,
        batch_size=batch,
        cost=cost,
        itl=decode_1,
        ttft=prefill_1,
        rho=0.0,
        max_arrv_rate_per_replica=max_rate,
    )
    alloc.value = alloc.cost
    return alloc


def transition_penalty(current: Allocation, proposed: Allocation) -> float:
    """Objective value of moving from `current` to `proposed`.

    Same-shape scaling costs the cost delta; changing slice shape (a
    multi-host pod-slice re-provision) adds a tax proportional to both
    costs (reference: pkg/core/allocation.go:291-300).
    """
    if current.accelerator == proposed.accelerator:
        if current.num_replicas == proposed.num_replicas:
            return 0.0
        return proposed.cost - current.cost
    return ACCEL_PENALTY_FACTOR * (current.cost + proposed.cost) + (
        proposed.cost - current.cost
    )


@dataclasses.dataclass(frozen=True)
class AllocationDiff:
    """Orchestration delta between two allocations
    (reference: pkg/core/allocation.go:345-380)."""

    old_accelerator: str
    new_accelerator: str
    old_num_replicas: int
    new_num_replicas: int
    cost_diff: float


def allocation_diff(a: Allocation | None, b: Allocation | None) -> AllocationDiff | None:
    if a is None and b is None:
        return None
    # An Allocation with an empty accelerator (fresh server, scale-to-zero)
    # is the same state as no allocation: report both as "none".
    return AllocationDiff(
        old_accelerator=(a.accelerator if a and a.accelerator else "none"),
        new_accelerator=(b.accelerator if b and b.accelerator else "none"),
        old_num_replicas=a.num_replicas if a else 0,
        new_num_replicas=b.num_replicas if b else 0,
        cost_diff=(b.cost if b else 0.0) - (a.cost if a else 0.0),
    )
