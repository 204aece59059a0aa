"""Greedy allocation under limited chip capacity (the scalar oracle).

Capability parity with upstream pkg/solver/greedy.go:35-341, with
TPU capacity arithmetic: availability is counted in **chips per pool**
(generation), and one replica consumes
`slices_per_replica × slice.chips` chips — whole-host quanta by
construction of the slice catalog. On top of the reference's per-pool
budget, a `CapacityLedger` layers optional quota buckets (pool-wide
caps and per-region carve-outs, `System.quotas`): an allocation must
fit its pool budget AND every matching quota bucket.

Algorithm (unchanged from the reference, which is sound and well-tested
there): each server sorts its candidate allocations by value; servers are
processed in (priority, regret-to-next-best desc, value desc) order; when
a server's current candidate doesn't fit the remaining chips it advances
to its next candidate and is re-inserted by binary search; servers left
without any feasible candidate get best-effort treatment per the
saturation policy. Candidate ties break by (value, cost, accelerator
name) — the same deterministic key as `solve_unlimited` and the
vectorized argmin — never by dict insertion order.

Every capacity concession is recorded as a `DegradationEvent` on
`system.degradations` (the graceful-degradation ladder: step down shape,
step onto a quantized `-int8` shape, scale replicas below the
SLO-satisfying count, zero out), which the reconciler surfaces as
`capacity_limited` DecisionRecords with the chip shortfall.

This module is the SCALAR implementation — the parity oracle. Fleet-scale
solves route through `solver.greedy_vec.solve_greedy_fleet`, which
consumes the columnar candidate table from `parallel/fleet.py` and must
agree with this solver bit-for-bit.

Port copy of `inferno_tpu/solver/greedy.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import TYPE_CHECKING

from inferno_tpu_torch.config.defaults import SaturationPolicy
from inferno_tpu_torch.config.types import OptimizerSpec
from inferno_tpu_torch.core.allocation import Allocation

if TYPE_CHECKING:
    from inferno_tpu_torch.core.system import System


# -- the degradation ladder ---------------------------------------------------

DEGRADE_SHAPE = "shape"  # allocated a value-worse (non-preferred) shape
DEGRADE_INT8 = "int8"  # the worse shape is a quantized -int8 catalog entry
DEGRADE_REPLICAS = "replicas"  # best-effort scaled replicas below the SLO count
DEGRADE_ZEROED = "zeroed"  # nothing fit; variant got no allocation
# spot placement demoted to all-reserved: the spot tier (or the reserved
# headroom the pre-positioner must hold for its blast radius) could not
# be taken, so the variant keeps its shape and replica count at the
# undiscounted reserved price (spot/market.demote_spot)
DEGRADE_SPOT_HEADROOM = "spot_headroom"


@dataclasses.dataclass(frozen=True)
class DegradationEvent:
    """One capacity concession made by the limited-mode solve: which rung
    of the ladder the server landed on, the bucket that bound, and the
    chip shortfall at the moment its preferred candidate failed."""

    server: str
    step: str  # DEGRADE_SHAPE | DEGRADE_INT8 | DEGRADE_REPLICAS | DEGRADE_ZEROED
    pool: str  # binding bucket key ("pool" or "pool/region")
    shortfall_chips: int  # preferred-candidate chips missing in that bucket
    from_accelerator: str = ""  # the preferred (min-value) candidate's shape
    to_accelerator: str = ""  # what was actually allocated ("" = nothing)
    from_replicas: int = 0
    to_replicas: int = 0


def parse_policy(policy: str) -> SaturationPolicy:
    """Saturation-policy parsing shared by the scalar and vectorized
    solvers: unknown strings behave as NONE (the reference's switch
    falls through silently)."""
    try:
        return SaturationPolicy(policy) if policy else SaturationPolicy.NONE
    except ValueError:
        return SaturationPolicy.NONE


def _classify_step(from_acc: str, to_acc: str) -> str:
    """Shape step-down vs int8 step-down: stepping onto a quantized
    `-int8` catalog entry from a non-int8 preference is the ladder's
    second rung (cheaper chips at degraded numerics), any other shape
    change is the first."""
    if to_acc.endswith("-int8") and not from_acc.endswith("-int8"):
        return DEGRADE_INT8
    return DEGRADE_SHAPE


class CapacityLedger:
    """Chip bookkeeping for one greedy solve: the per-pool budgets plus
    the quota buckets each accelerator draws from, in deterministic
    order (pool budget, then "pool/region" quota, then pool-wide
    quota). Shared by the scalar solver and — in array form — the
    vectorized one; both must fit-check and decrement identically."""

    def __init__(self, system: "System"):
        self._system = system
        self.available: dict[str, int] = dict(system.capacity)
        self.quota_available: dict[str, int] = dict(
            getattr(system, "quotas", {}) or {}
        )
        self._acc_buckets: dict[str, tuple[str, ...]] = {}
        # spot tier (spot/market.py): per-pool preemptible budgets (a
        # tier with chips == 0 is elastic and absent here), the blast
        # radius driving the reserved-headroom charge, and the headroom
        # chips currently HELD free per pool (the pre-positioner state,
        # surfaced as inferno_reserved_headroom_chips)
        self.spot_specs: dict = dict(getattr(system, "spot", {}) or {})
        self.spot_available: dict[str, int] = {
            pool: spec.chips
            for pool, spec in self.spot_specs.items()
            if spec.chips > 0
        }
        self.headroom_held: dict[str, int] = {}

    def buckets_for(self, acc_name: str) -> tuple[str, ...]:
        """Quota bucket keys (beyond the pool budget) this shape draws
        from; cached per accelerator."""
        cached = self._acc_buckets.get(acc_name)
        if cached is None:
            acc = self._system.accelerators.get(acc_name)
            keys: list[str] = []
            if acc is not None:
                if acc.region and f"{acc.pool}/{acc.region}" in self.quota_available:
                    keys.append(f"{acc.pool}/{acc.region}")
                if acc.pool in self.quota_available:
                    keys.append(acc.pool)
            cached = tuple(keys)
            self._acc_buckets[acc_name] = cached
        return cached

    def _pool(self, acc_name: str) -> str:
        acc = self._system.accelerators.get(acc_name)
        return acc.pool if acc is not None else ""

    def fits(self, acc_name: str, need: int) -> bool:
        if self.available.get(self._pool(acc_name), 0) < need:
            return False
        return all(
            self.quota_available.get(k, 0) >= need
            for k in self.buckets_for(acc_name)
        )

    def take(self, acc_name: str, need: int) -> None:
        pool = self._pool(acc_name)
        self.available[pool] = self.available.get(pool, 0) - need
        for k in self.buckets_for(acc_name):
            self.quota_available[k] -= need

    def headroom(self, acc_name: str) -> int:
        """Chips available to this shape right now (min over buckets)."""
        room = self.available.get(self._pool(acc_name), 0)
        for k in self.buckets_for(acc_name):
            room = min(room, self.quota_available.get(k, 0))
        return room

    def shortfall(self, acc_name: str, need: int) -> tuple[str, int]:
        """(binding bucket key, chip deficit) for a candidate that does
        not fit — the first bucket in deterministic order whose
        remainder is below `need`."""
        pool = self._pool(acc_name)
        if self.available.get(pool, 0) < need:
            return pool, need - self.available.get(pool, 0)
        for k in self.buckets_for(acc_name):
            if self.quota_available.get(k, 0) < need:
                return k, need - self.quota_available.get(k, 0)
        return pool, 0

    # -- spot-split accounting (spot/market.py) -----------------------------
    # A candidate with spot replicas draws THREE charges: its reserved
    # chips plus the blast-radius headroom from every reserved bucket
    # (pool budget + quotas — held slack, not allocated), and its spot
    # chips from the pool's spot budget. A candidate without spot
    # replicas reduces exactly to the plain fits/take/shortfall above.

    def _spot_needs(self, acc_name: str, alloc, per_replica: int):
        """(pool, reserved+headroom chips, spot chips) of one candidate;
        None when it carries no spot placement."""
        if not alloc.spot_replicas:
            return None
        pool = self._pool(acc_name)
        spec = self.spot_specs.get(pool)
        if spec is None:  # stale candidate from a tier-less solve
            return None
        from inferno_tpu_torch.spot.market import split_needs

        reserved, spot, headroom = split_needs(alloc, per_replica, spec.blast_radius)
        return pool, reserved + headroom, spot

    def fits_alloc(self, acc_name: str, alloc, per_replica: int) -> bool:
        needs = self._spot_needs(acc_name, alloc, per_replica)
        if needs is None:
            return self.fits(acc_name, alloc.num_replicas * per_replica)
        pool, reserved_need, spot_need = needs
        if not self.fits(acc_name, reserved_need):
            return False
        avail = self.spot_available.get(pool)
        return avail is None or avail >= spot_need

    def take_alloc(self, acc_name: str, alloc, per_replica: int) -> None:
        needs = self._spot_needs(acc_name, alloc, per_replica)
        if needs is None:
            self.take(acc_name, alloc.num_replicas * per_replica)
            return
        pool, reserved_need, spot_need = needs
        self.take(acc_name, reserved_need)
        if pool in self.spot_available:
            self.spot_available[pool] -= spot_need
        held = reserved_need - (alloc.num_replicas - alloc.spot_replicas) * per_replica
        self.headroom_held[pool] = self.headroom_held.get(pool, 0) + held

    def shortfall_alloc(self, acc_name: str, alloc, per_replica: int) -> tuple[str, int]:
        needs = self._spot_needs(acc_name, alloc, per_replica)
        if needs is None:
            return self.shortfall(acc_name, alloc.num_replicas * per_replica)
        pool, reserved_need, spot_need = needs
        if not self.fits(acc_name, reserved_need):
            return self.shortfall(acc_name, reserved_need)
        avail = self.spot_available.get(pool)
        if avail is not None and avail < spot_need:
            return f"{pool}:spot", spot_need - avail
        return pool, 0


@dataclasses.dataclass
class _ServerEntry:
    """(reference serverEntry: pkg/solver/greedy.go:16-22)"""

    server_name: str
    priority: int
    cur_index: int
    allocations: list[Allocation]
    delta: float  # regret: value gap to the next-best allocation
    # (binding bucket, deficit) recorded the first time the PREFERRED
    # candidate failed to fit — the shortfall every later degradation
    # event of this server reports
    pending_shortfall: tuple[str, int] | None = None

    def sort_key(self) -> tuple:
        # priority asc, then delta desc, then current value desc
        # (reference orderFunc: pkg/solver/greedy.go:76-85)
        return (self.priority, -self.delta, -self.allocations[self.cur_index].value)


def candidate_sort_key(alloc: Allocation) -> tuple:
    """THE candidate ordering of every solver path: (value, cost,
    accelerator name) — matches `solve_unlimited` and the vectorized
    per-server argmin, so equal-value ties never resolve by dict
    insertion order."""
    return (alloc.value, alloc.cost, alloc.accelerator)


def _chips_per_replica(system: "System", server_name: str, alloc: Allocation) -> tuple[str, int] | None:
    """Accelerator name and chips consumed per replica of this allocation
    (reference unitsPerReplica: pkg/solver/greedy.go:139-140)."""
    server = system.servers.get(server_name)
    if server is None:
        return None
    model = system.models.get(server.model_name)
    acc = system.accelerators.get(alloc.accelerator)
    if model is None or acc is None:
        return None
    return acc.name, model.slices_per_replica(acc.name) * acc.chips


def record_degradation(
    system: "System",
    entry: _ServerEntry,
    step: str,
    to_alloc: Allocation | None,
    to_replicas: int = 0,
) -> None:
    """Emit one DegradationEvent for `entry` onto system.degradations,
    anchored at the shortfall of its preferred candidate."""
    preferred = entry.allocations[0]
    pool, deficit = entry.pending_shortfall or ("", 0)
    system.degradations[entry.server_name] = DegradationEvent(
        server=entry.server_name,
        step=step,
        pool=pool,
        shortfall_chips=deficit,
        from_accelerator=preferred.accelerator,
        to_accelerator=to_alloc.accelerator if to_alloc is not None else "",
        from_replicas=preferred.num_replicas,
        to_replicas=to_replicas,
    )


def solve_greedy(system: "System", optimizer_spec: OptimizerSpec) -> None:
    """(reference SolveGreedy: pkg/solver/greedy.go:35-104)"""
    system.degradations = {}
    ledger = CapacityLedger(system)

    entries: list[_ServerEntry] = []
    for server_name, server in system.servers.items():
        server.remove_allocation()
        if not server.all_allocations:
            continue
        allocs = sorted(server.all_allocations.values(), key=candidate_sort_key)
        delta = allocs[1].value - allocs[0].value if len(allocs) > 1 else math.inf
        entries.append(
            _ServerEntry(
                server_name=server_name,
                priority=server.priority(system),
                cur_index=0,
                allocations=allocs,
                delta=delta,
            )
        )
    entries.sort(key=_ServerEntry.sort_key)

    if optimizer_spec.delayed_best_effort:
        unallocated = _allocate(system, entries, ledger)
        _best_effort(system, unallocated, ledger, optimizer_spec.saturation_policy)
    else:
        for group in _make_priority_groups(entries):
            unallocated = _allocate(system, group, ledger)
            _best_effort(system, unallocated, ledger, optimizer_spec.saturation_policy)


def _allocate(
    system: "System", entries: list[_ServerEntry], ledger: CapacityLedger
) -> list[_ServerEntry]:
    """Greedy SLO-satisfying pass; returns entries that got nothing
    (reference allocate: pkg/solver/greedy.go:107-166)."""
    entries = list(entries)
    keys = [e.sort_key() for e in entries]
    unallocated: list[_ServerEntry] = []

    while entries:
        top = entries.pop(0)
        keys.pop(0)
        if not top.allocations:
            continue
        server = system.servers.get(top.server_name)
        if server is None:
            continue
        alloc = top.allocations[top.cur_index]
        pool_chips = _chips_per_replica(system, top.server_name, alloc)
        if pool_chips is None:
            continue
        acc_name, per_replica = pool_chips
        need = alloc.num_replicas * per_replica

        if ledger.fits_alloc(acc_name, alloc, per_replica):
            ledger.take_alloc(acc_name, alloc, per_replica)
            server.set_allocation(alloc)
            if top.cur_index > 0:
                record_degradation(
                    system, top,
                    _classify_step(top.allocations[0].accelerator, alloc.accelerator),
                    alloc, alloc.num_replicas,
                )
        elif alloc.spot_replicas and ledger.fits(acc_name, need):
            # pre-positioner fallback: the spot tier (or the reserved
            # headroom its blast radius demands) can't be taken, but the
            # whole placement fits reserved — keep the shape and replica
            # count at the undiscounted price, and surface the lost
            # discount as a spot_headroom DegradationEvent anchored at
            # the split attempt's binding bucket (read BEFORE the
            # reserved take below mutates the books)
            from inferno_tpu_torch.spot.market import demote_spot

            if top.cur_index == 0:
                top.pending_shortfall = ledger.shortfall_alloc(
                    acc_name, alloc, per_replica
                )
            ledger.take(acc_name, need)
            demoted = demote_spot(alloc)
            server.set_allocation(demoted)
            if top.cur_index == 0:
                record_degradation(
                    system, top, DEGRADE_SPOT_HEADROOM, demoted,
                    demoted.num_replicas,
                )
            else:
                record_degradation(
                    system, top,
                    _classify_step(top.allocations[0].accelerator,
                                   demoted.accelerator),
                    demoted, demoted.num_replicas,
                )
        else:
            if top.cur_index == 0:
                top.pending_shortfall = ledger.shortfall_alloc(
                    acc_name, alloc, per_replica
                )
            top.cur_index += 1
            if top.cur_index + 1 < len(top.allocations):
                top.delta = (
                    top.allocations[top.cur_index + 1].value
                    - top.allocations[top.cur_index].value
                )
            elif top.cur_index == len(top.allocations):
                unallocated.append(top)
                continue
            else:
                top.delta = math.inf
            key = top.sort_key()
            i = bisect.bisect_left(keys, key)
            entries.insert(i, top)
            keys.insert(i, key)
    return unallocated


def _best_effort(
    system: "System",
    unallocated: list[_ServerEntry],
    ledger: CapacityLedger,
    policy: str,
) -> None:
    """(reference bestEffort: pkg/solver/greedy.go:169-190)

    Unknown policy strings behave as NONE (the reference's switch falls
    through silently); a typo in a ConfigMap must not abort the cycle.
    """
    pol = parse_policy(policy)
    if pol is SaturationPolicy.PRIORITY_EXHAUSTIVE:
        _allocate_maximally(system, unallocated, ledger)
    elif pol is SaturationPolicy.PRIORITY_ROUND_ROBIN:
        for group in _make_priority_groups(unallocated):
            _allocate_equally(system, group, ledger)
    elif pol is SaturationPolicy.ROUND_ROBIN:
        _allocate_equally(system, unallocated, ledger)
    else:
        # SaturationPolicy.NONE: leave unallocated — the ladder's last rung
        for entry in unallocated:
            if entry.server_name in system.servers:
                record_degradation(system, entry, DEGRADE_ZEROED, None)


def _scaled(alloc: Allocation, num_replicas: int) -> Allocation:
    """Clone with replica count reduced to what fits, cost/value scaled
    proportionally (reference: pkg/solver/greedy.go:206-211, 305-310).

    Best-effort candidates are always DEMOTED off the spot tier first
    (`_reserved_only`), so the proportional cost scaling here operates
    on the undiscounted reserved price."""
    factor = num_replicas / alloc.num_replicas
    out = alloc.clone()
    out.cost *= factor
    out.value *= factor
    out.num_replicas = num_replicas
    return out


def _reserved_only(alloc: Allocation) -> Allocation:
    """Best-effort placements never gamble on the spot tier: a variant
    already conceding replicas (or its whole SLO count) to capacity
    pressure must not also carry eviction risk, and the round-robin /
    maximal fill arithmetic stays whole-chip-exact on one bucket. A
    candidate with spot replicas is demoted to all-reserved pricing."""
    if not alloc.spot_replicas:
        return alloc
    from inferno_tpu_torch.spot.market import demote_spot

    return demote_spot(alloc)


def _record_best_effort(
    system: "System", entry: _ServerEntry, alloc: Allocation, num_replicas: int
) -> None:
    """Classify a best-effort outcome on the degradation ladder."""
    if num_replicas < alloc.num_replicas:
        record_degradation(system, entry, DEGRADE_REPLICAS, alloc, num_replicas)
    else:
        record_degradation(
            system, entry,
            _classify_step(entry.allocations[0].accelerator, alloc.accelerator),
            alloc, num_replicas,
        )


def _allocate_maximally(
    system: "System", entries: list[_ServerEntry], ledger: CapacityLedger
) -> None:
    """Exhaustive best-effort in priority order
    (reference allocateMaximally: pkg/solver/greedy.go:194-223)."""
    for entry in entries:
        server = system.servers.get(entry.server_name)
        if server is None:
            continue
        placed = False
        for alloc in entry.allocations:
            alloc = _reserved_only(alloc)
            pool_chips = _chips_per_replica(system, entry.server_name, alloc)
            if pool_chips is None:
                continue
            acc_name, per_replica = pool_chips
            if per_replica <= 0:
                continue
            max_replicas = min(
                ledger.headroom(acc_name) // per_replica, alloc.num_replicas
            )
            if max_replicas > 0:
                server.set_allocation(_scaled(alloc, max_replicas))
                ledger.take(acc_name, max_replicas * per_replica)
                _record_best_effort(system, entry, alloc, max_replicas)
                placed = True
                break
        if not placed:
            record_degradation(system, entry, DEGRADE_ZEROED, None)


@dataclasses.dataclass
class _Ticket:
    """(reference serverAllocationTicket: pkg/solver/greedy.go:225-235)"""

    entry: _ServerEntry
    active: bool = False
    acc_name: str = ""
    per_replica: int = 0
    num_replicas: int = 0
    final_alloc: Allocation | None = None


def _allocate_equally(
    system: "System", entries: list[_ServerEntry], ledger: CapacityLedger
) -> None:
    """Round-robin one replica at a time within the group
    (reference allocateEqually: pkg/solver/greedy.go:239-316)."""
    tickets: dict[str, _Ticket] = {}
    for entry in entries:
        if entry.server_name in system.servers:
            tickets[entry.server_name] = _Ticket(entry=entry)

    allocated: dict[str, _Ticket] = {}
    while tickets:
        for entry in entries:
            name = entry.server_name
            ticket = tickets.get(name)
            if ticket is None:
                continue
            if not ticket.active:
                for alloc in entry.allocations:
                    alloc = _reserved_only(alloc)
                    pool_chips = _chips_per_replica(system, name, alloc)
                    if pool_chips is None:
                        continue
                    acc_name, per_replica = pool_chips
                    if per_replica > 0 and ledger.headroom(acc_name) >= per_replica:
                        ticket.active = True
                        ticket.acc_name = acc_name
                        ticket.per_replica = per_replica
                        ticket.final_alloc = alloc
                        break
                if not ticket.active:
                    record_degradation(system, entry, DEGRADE_ZEROED, None)
                    del tickets[name]
                    continue
            assert ticket.final_alloc is not None
            replicas_available = ledger.headroom(ticket.acc_name) // ticket.per_replica
            if min(replicas_available, ticket.final_alloc.num_replicas) > 0 and (
                ticket.num_replicas < ticket.final_alloc.num_replicas
            ):
                ticket.num_replicas += 1
                ledger.take(ticket.acc_name, ticket.per_replica)
                allocated[name] = ticket
            else:
                del tickets[name]

    for name, ticket in allocated.items():
        assert ticket.final_alloc is not None
        server = system.servers[name]
        server.set_allocation(_scaled(ticket.final_alloc, ticket.num_replicas))
        _record_best_effort(
            system, ticket.entry, ticket.final_alloc, ticket.num_replicas
        )


def _make_priority_groups(entries: list[_ServerEntry]) -> list[list[_ServerEntry]]:
    """Partition (already sorted) entries into equal-priority groups
    (reference makePriorityGroups: pkg/solver/greedy.go:321-341)."""
    groups: list[list[_ServerEntry]] = []
    for entry in entries:
        if groups and groups[-1][0].priority == entry.priority:
            groups[-1].append(entry)
        else:
            groups.append([entry])
    return groups
