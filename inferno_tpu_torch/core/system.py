"""Domain registry: accelerators, models, service classes, servers.

Capability parity with the reference's core registry
(upstream pkg/core/{system.go,accelerator.go,model.go,
serviceclass.go,server.go}), minus its deliberate warts: there is **no
package-level singleton** (the reference's `TheSystem`,
pkg/core/system.go:10-45, makes the library thread-unsafe); a `System` is
an ordinary value constructed from a `SystemSpec`, and every operation
takes it explicitly.

Port copy of `inferno_tpu/core/system.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import dataclasses

from inferno_tpu_torch.config.defaults import (
    DEFAULT_SERVICE_CLASS_NAME,
    DEFAULT_SERVICE_CLASS_PRIORITY,
)
from inferno_tpu_torch.config.types import (
    AcceleratorSpec,
    AllocationData,
    ModelPerfSpec,
    ModelTarget,
    ServerLoadSpec,
    ServerSpec,
    ServiceClassSpec,
    SystemSpec,
)
from inferno_tpu_torch.core.allocation import (
    Allocation,
    allocation_from_data,
    create_allocation,
    transition_penalty,
)


class Accelerator:
    """A TPU slice shape available to the optimizer
    (reference: pkg/core/accelerator.go:11-71)."""

    def __init__(self, spec: AcceleratorSpec):
        self.spec = spec

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def pool(self) -> str:
        """Capacity pool (generation) this shape draws chips from — the
        TPU analogue of the reference's accelerator *type*."""
        return self.spec.pool

    @property
    def region(self) -> str:
        """Placement region ("" = unregioned); selects the "pool/region"
        quota bucket this shape additionally draws from, when one is
        configured on System.quotas."""
        return self.spec.region

    @property
    def chips(self) -> int:
        return self.spec.chips

    @property
    def cost(self) -> float:
        """Cents/hr for one slice."""
        return self.spec.cost

    def power(self, util: float) -> float:
        """Watts drawn by one slice at the given utilization in [0,1]:
        piecewise-linear through (0, idle), (mid_util, mid_power),
        (1, full), scaled to the slice's chip count (reference
        Accelerator.{Calculate,Power}: pkg/core/accelerator.go:29-41)."""
        p = self.spec.power
        util = min(max(util, 0.0), 1.0)
        if p.mid_util <= 0.0 or p.mid_util >= 1.0:
            per_chip = p.idle + (p.full - p.idle) * util
        elif util <= p.mid_util:
            per_chip = p.idle + (p.mid_power - p.idle) / p.mid_util * util
        else:
            per_chip = p.mid_power + (p.full - p.mid_power) / (1.0 - p.mid_util) * (
                util - p.mid_util
            )
        return per_chip * self.chips


class Model:
    """A model with per-slice-shape performance profiles
    (reference: pkg/core/model.go)."""

    def __init__(self, name: str):
        self.name = name
        self.perf_data: dict[str, ModelPerfSpec] = {}

    def add_perf(self, perf: ModelPerfSpec) -> None:
        self.perf_data[perf.acc] = perf

    def slices_per_replica(self, acc_name: str) -> int:
        """Slice units one replica occupies (reference numInstances,
        pkg/core/model.go:45-54). For disaggregated serving a replica is
        the atomic prefill+decode unit, so its slice footprint multiplies
        by the unit size."""
        perf = self.perf_data.get(acc_name)
        if perf is None:
            return 1
        units = perf.disagg.slices_per_unit if perf.disagg else 1
        return perf.slices_per_replica * units


class ServiceClass:
    """(reference: pkg/core/serviceclass.go:10-21)"""

    def __init__(self, spec: ServiceClassSpec):
        self.spec = spec
        # model -> target index: the spec's list scan is O(targets) and
        # target_for runs per server per cycle — at fleet scale (10k
        # variants sharing one class) the scan alone is O(variants^2)
        # and dominates the sizing pass. setdefault keeps the FIRST
        # occurrence per model, matching the spec scan's first-match.
        self._targets: dict[str, ModelTarget] = {}
        for t in spec.model_targets:
            self._targets.setdefault(t.model, t)

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def priority(self) -> int:
        return self.spec.priority

    def target_for(self, model: str) -> ModelTarget | None:
        return self._targets.get(model)


class Server:
    """One managed inference-server variant
    (reference: pkg/core/server.go:10-166)."""

    def __init__(self, spec: ServerSpec):
        self.spec = spec
        self.name = spec.name
        self.service_class_name = spec.class_name or DEFAULT_SERVICE_CLASS_NAME
        self.model_name = spec.model
        self.keep_accelerator = spec.keep_accelerator
        self.min_num_replicas = spec.min_num_replicas
        self.max_batch_size = spec.max_batch_size
        self.load: ServerLoadSpec = spec.current_alloc.load
        self.all_allocations: dict[str, Allocation] = {}
        self.allocation: Allocation | None = None
        self.cur_allocation: Allocation = allocation_from_data(spec.current_alloc)

    def priority(self, system: "System") -> int:
        svc = system.service_classes.get(self.service_class_name)
        return svc.priority if svc else DEFAULT_SERVICE_CLASS_PRIORITY

    def candidate_accelerators(self, system: "System") -> dict[str, Accelerator]:
        """Honor keep_accelerator pinning
        (reference: pkg/core/server.go:70-82)."""
        if self.keep_accelerator and self.cur_allocation.accelerator:
            cur = system.accelerators.get(self.cur_allocation.accelerator)
            if cur is not None:
                return {cur.name: cur}
        return system.accelerators

    def calculate(self, system: "System") -> None:
        """Build candidate allocations on every feasible slice shape; the
        solver objective ("value") is the transition penalty from the
        current allocation (reference: pkg/core/server.go:55-67), plus
        the spot-tier risk premium when the candidate places risky
        replicas on preemptible capacity (spot/market.py; zero without a
        tier, keeping the pre-spot objective bit-identical)."""
        self.all_allocations = {}
        for g in self.candidate_accelerators(system).values():
            alloc = create_allocation(system, self.name, g.name)
            if alloc is not None:
                alloc.value = (
                    transition_penalty(self.cur_allocation, alloc)
                    + alloc.spot_premium
                )
                self.all_allocations[g.name] = alloc

    def set_allocation(self, alloc: Allocation | None) -> None:
        self.allocation = alloc
        self.update_desired_alloc()

    def remove_allocation(self) -> None:
        self.allocation = None
        self.update_desired_alloc()

    def saturated(self) -> bool:
        """(reference: pkg/core/server.go:144-146)"""
        return self.allocation is not None and self.allocation.saturated(
            self.load.arrival_rate
        )

    def update_desired_alloc(self) -> None:
        """(reference: pkg/core/server.go:148-155)"""
        if self.allocation is not None:
            data = self.allocation.to_data()
            data.load = self.load
            self.spec.desired_alloc = data
        else:
            self.spec.desired_alloc = AllocationData()

    def apply_desired_alloc(self) -> None:
        """Promote desired to current (reference: pkg/core/server.go:157-161)."""
        self.spec.current_alloc = self.spec.desired_alloc
        self.cur_allocation = allocation_from_data(self.spec.current_alloc)
        self.load = self.spec.current_alloc.load


@dataclasses.dataclass
class PoolUsage:
    """Chips, cost, and power allocated per pool after a solve
    (reference AllocateByType: pkg/core/system.go:271-300; the reference
    computes per-accelerator power but never aggregates it — we surface
    expected fleet watts per pool from each allocation's utilization)."""

    chips: int = 0
    cost: float = 0.0
    watts: float = 0.0
    # chips of the total placed on the pool's preemptible (spot) tier,
    # and the replicas they carry — the reconciler's spot gauges and the
    # reserved-headroom arithmetic read these per cycle
    spot_chips: int = 0
    spot_replicas: int = 0


class System:
    """The full optimization domain for one cycle
    (reference: pkg/core/system.go:48-89)."""

    def __init__(self, spec: SystemSpec | None = None):
        self.accelerators: dict[str, Accelerator] = {}
        self.models: dict[str, Model] = {}
        self.service_classes: dict[str, ServiceClass] = {}
        self.servers: dict[str, Server] = {}
        self.capacity: dict[str, int] = {}  # available chips per pool
        # sub-budgets layered on the pool totals: "pool" (pool-wide cap)
        # or "pool/region" (per-region carve-out) -> chips. An allocation
        # must fit its pool budget AND every matching quota bucket.
        self.quotas: dict[str, int] = {}
        # preemptible tier per pool (config.types.SpotPoolSpec, ConfigMap/
        # env TPU_SPOT_POOLS): spot replicas draw the tier's own budget
        # at a discounted, eviction-risk-adjusted price (spot/market.py).
        # Empty = no spot anywhere, and every spot branch is skipped.
        self.spot: dict = {}
        self.pool_usage: dict[str, PoolUsage] = {}
        # set by calculate_all / parallel.calculate_fleet; lets the
        # optimizer's auto mode distinguish "never sized" from "sized and
        # found infeasible" (empty all_allocations in both cases)
        self.candidates_calculated = False
        # columnar candidate table attached by parallel.calculate_fleet
        # (parallel/fleet.FleetCandidates) — the capacity-constrained
        # solver's vectorized input; None when sizing ran scalar
        self.fleet_candidates = None
        # per-server capacity degradation emitted by the limited-mode
        # solve: server name -> solver.greedy.DegradationEvent
        self.degradations: dict = {}
        if spec is not None:
            self.set_from_spec(spec)

    def set_from_spec(self, spec: SystemSpec) -> None:
        """(reference: pkg/core/system.go:82-89)"""
        for acc_spec in spec.accelerators:
            self.accelerators[acc_spec.name] = Accelerator(acc_spec)
        for perf in spec.models:
            model = self.models.setdefault(perf.name, Model(perf.name))
            model.add_perf(perf)
        for svc_spec in spec.service_classes:
            self.service_classes[svc_spec.name] = ServiceClass(svc_spec)
        for server_spec in spec.servers:
            self.servers[server_spec.name] = Server(server_spec)
        self.capacity.update(spec.capacity.chips)
        self.quotas.update(spec.capacity.quotas)
        self.spot.update(spec.capacity.spot)

    # -- solve support ------------------------------------------------------

    def calculate_all(self, only: set[str] | None = None) -> None:
        """Candidate allocations for every server (the analyzer hot loop).

        `only` restricts sizing to a server subset — the reconciler's
        input-signature cache replays the rest from the previous cycle
        (controller/sizing_cache.py); servers outside the subset keep
        whatever all_allocations they already carry."""
        for name, server in self.servers.items():
            if only is not None and name not in only:
                continue
            server.calculate(self)
        self.candidates_calculated = True

    def allocate_by_pool(self) -> dict[str, PoolUsage]:
        """Accumulate chips and cost consumed per pool by the solved
        allocations (reference AllocateByType: pkg/core/system.go:271-300,
        with chips replacing units × multiplicity)."""
        usage: dict[str, PoolUsage] = {}
        for server in self.servers.values():
            alloc = server.allocation
            if alloc is None or not alloc.accelerator:
                continue
            acc = self.accelerators.get(alloc.accelerator)
            model = self.models.get(server.model_name)
            if acc is None or model is None:
                continue
            u = usage.setdefault(acc.pool, PoolUsage())
            slices = alloc.num_replicas * model.slices_per_replica(acc.name)
            u.chips += slices * acc.chips
            u.cost += alloc.cost
            u.watts += slices * acc.power(alloc.rho)
            if alloc.spot_replicas:
                u.spot_chips += (
                    alloc.spot_replicas * model.slices_per_replica(acc.name)
                    * acc.chips
                )
                u.spot_replicas += alloc.spot_replicas
        self.pool_usage = usage
        return usage

    def generate_solution(self) -> dict[str, AllocationData]:
        """Map of server name -> solved allocation data
        (reference GenerateSolution: pkg/core/system.go:303-319)."""
        solution: dict[str, AllocationData] = {}
        for name, server in self.servers.items():
            if server.allocation is not None:
                data = server.allocation.to_data()
                data.load = server.load
                solution[name] = data
        return solution
