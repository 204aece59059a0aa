"""Vectorized capacity-constrained greedy solve over shared chip pools.

`solve_greedy_fleet` is the fleet-scale implementation of the limited
mode: it consumes the columnar candidate table attached to the System by
`parallel.fleet.calculate_fleet` (`FleetCandidates` — every feasible
lane, pre-sorted per server by the deterministic (value, cost,
accelerator-rank) key) and solves priority groups as vectorized buckets:

* the common case — the whole priority group's preferred-candidate chip
  demand fits the remaining pools and quotas — is ONE numpy bincount
  check followed by a bulk allocation, no per-server Python beyond
  materializing each winner;
* only when a pool binds does the group fall into the exact sequential
  loop, driven by a heap over (priority, -regret, -value) keys with
  tie-sequencing replicating the scalar solver's bisect_left reinsertion
  semantics. Each step is O(log n) array indexing — no Allocation
  objects, no candidate dicts.

The lazy `LaneAllocations.best()`/`lane_alloc()` path stays lazy end to
end: an allocated server materializes exactly ONE Allocation (its
winner); full candidate sets inflate only for the (rare) servers that
reach a non-NONE best-effort saturation policy. Bit-parity with the
scalar `solve_greedy` — allocations AND DegradationEvents — is asserted
over the edge-fleet fixtures in tests/test_capacity_solver.py.

Servers whose candidates are plain dicts (zero-load shortcut, sizing-
cache replays, scalar-sized systems) ride the same machinery as
extension rows, so mixed fleets solve in one pass. `GREEDY_VECTORIZED=0`
forces the scalar path for A/B debugging.

Port copy of `inferno_tpu/solver/greedy_vec.py`, verbatim apart from its
imports.
"""

from __future__ import annotations

import heapq
import math

import numpy as np

from inferno_tpu_torch.config.defaults import (
    DEFAULT_SERVICE_CLASS_PRIORITY,
    SaturationPolicy,
)
from inferno_tpu_torch.config.types import OptimizerSpec
from inferno_tpu_torch.core.system import System

# cycle-profiler hooks (obs/profiler.py): thread-local no-ops
# unless a profiler is active; observation only
from inferno_tpu_torch.obs import profiler as _prof
from inferno_tpu_torch.solver.greedy import (
    DEGRADE_SPOT_HEADROOM,
    DEGRADE_ZEROED,
    DegradationEvent,
    _best_effort,
    _chips_per_replica,
    _classify_step,
    _ServerEntry,
    candidate_sort_key,
    parse_policy,
    solve_greedy,
)


def _vec_enabled() -> bool:
    from inferno_tpu_torch.config.defaults import env_flag

    return env_flag("GREEDY_VECTORIZED", True)


class _ArrayLedger:
    """Array form of `greedy.CapacityLedger`: remaining chips per bucket
    (pool budgets + quota carve-outs) with accelerator-RANK addressing
    for the vectorized loop and accelerator-NAME addressing for the
    scalar best-effort helpers. Bucket order per accelerator matches the
    scalar ledger exactly: pool budget, then "pool/region" quota, then
    pool-wide quota — fits, takes, and shortfall reports are
    bit-identical."""

    def __init__(self, system: System):
        accs = sorted(system.accelerators)
        self.acc_order = {a: i for i, a in enumerate(accs)}
        quotas = dict(getattr(system, "quotas", {}) or {})
        pools: list[str] = []
        pool_id: dict[str, int] = {}
        quota_keys: list[str] = []
        quota_id: dict[str, int] = {}
        rank_pid, rank_q1, rank_q2 = [], [], []
        for name in accs:
            acc = system.accelerators[name]
            pid = pool_id.setdefault(acc.pool, len(pools))
            if pid == len(pools):
                pools.append(acc.pool)
            rank_pid.append(pid)
            region_key = f"{acc.pool}/{acc.region}" if acc.region else None
            if region_key is not None and region_key in quotas:
                qid = quota_id.setdefault(region_key, len(quota_keys))
                if qid == len(quota_keys):
                    quota_keys.append(region_key)
                rank_q1.append(qid)
            else:
                rank_q1.append(-1)
            if acc.pool in quotas:
                qid = quota_id.setdefault(acc.pool, len(quota_keys))
                if qid == len(quota_keys):
                    quota_keys.append(acc.pool)
                rank_q2.append(qid)
            else:
                rank_q2.append(-1)
        self.pools = pools
        self.quota_keys = quota_keys
        self.pool_remaining = np.asarray(
            [system.capacity.get(p, 0) for p in pools], np.int64
        )
        self.quota_remaining = np.asarray(
            [quotas[k] for k in quota_keys], np.int64
        )
        self.rank_pid = np.asarray(rank_pid, np.int64)
        self.rank_q1 = np.asarray(rank_q1, np.int64)
        self.rank_q2 = np.asarray(rank_q2, np.int64)
        # spot tier (spot/market.py): per-rank blast radius (0 = the
        # rank's pool has no tier) and the bounded spot budgets; a tier
        # with chips == 0 is elastic and gets no bucket (rank_spot -1).
        # Bucket semantics mirror greedy.CapacityLedger exactly: a spot
        # candidate charges reserved chips + blast-radius headroom to
        # every reserved bucket and its spot chips to the spot budget.
        self.spot_specs = dict(getattr(system, "spot", {}) or {})
        spot_pools: list[str] = []
        spot_id: dict[str, int] = {}
        rank_spot, rank_blast = [], []
        for name in accs:
            acc = system.accelerators[name]
            spec = self.spot_specs.get(acc.pool)
            if spec is None:
                rank_spot.append(-1)
                rank_blast.append(0.0)
                continue
            rank_blast.append(spec.blast_radius)
            if spec.chips > 0:
                sid = spot_id.setdefault(acc.pool, len(spot_pools))
                if sid == len(spot_pools):
                    spot_pools.append(acc.pool)
                rank_spot.append(sid)
            else:
                rank_spot.append(-1)
        self.spot_pools = spot_pools
        self.spot_remaining = np.asarray(
            [self.spot_specs[p].chips for p in spot_pools], np.int64
        )
        self.rank_spot = np.asarray(rank_spot, np.int64)
        self.rank_blast = np.asarray(rank_blast, np.float64)
        self.headroom_held: dict[str, int] = {}

    # -- rank-addressed (the vectorized loop) -------------------------------

    def fits_rank(self, rank: int, need: int) -> bool:
        if self.pool_remaining[self.rank_pid[rank]] < need:
            return False
        q1, q2 = self.rank_q1[rank], self.rank_q2[rank]
        if q1 >= 0 and self.quota_remaining[q1] < need:
            return False
        return not (q2 >= 0 and self.quota_remaining[q2] < need)

    def take_rank(self, rank: int, need: int) -> None:
        self.pool_remaining[self.rank_pid[rank]] -= need
        q1, q2 = self.rank_q1[rank], self.rank_q2[rank]
        if q1 >= 0:
            self.quota_remaining[q1] -= need
        if q2 >= 0:
            self.quota_remaining[q2] -= need

    def headroom_rank(self, rank: int) -> int:
        room = self.pool_remaining[self.rank_pid[rank]]
        q1, q2 = self.rank_q1[rank], self.rank_q2[rank]
        if q1 >= 0:
            room = min(room, self.quota_remaining[q1])
        if q2 >= 0:
            room = min(room, self.quota_remaining[q2])
        return int(room)

    def shortfall_rank(self, rank: int, need: int) -> tuple[str, int]:
        pid = self.rank_pid[rank]
        if self.pool_remaining[pid] < need:
            return self.pools[pid], int(need - self.pool_remaining[pid])
        for q in (self.rank_q1[rank], self.rank_q2[rank]):
            if q >= 0 and self.quota_remaining[q] < need:
                return self.quota_keys[q], int(need - self.quota_remaining[q])
        return self.pools[pid], 0

    # -- spot-split accounting (mirrors CapacityLedger.*_alloc) -------------

    def needs_rank(self, rank: int, reps: int, spot_k: int, chips: int):
        """(reserved+headroom chips, spot chips) of one candidate row."""
        spot = spot_k * chips
        reserved = (reps - spot_k) * chips
        if spot:
            from inferno_tpu_torch.spot.market import headroom_chips

            reserved += headroom_chips(float(self.rank_blast[rank]), spot)
        return reserved, spot

    def fits_rank_split(self, rank: int, reserved_need: int, spot_need: int) -> bool:
        if not self.fits_rank(rank, reserved_need):
            return False
        if spot_need:
            sid = self.rank_spot[rank]
            if sid >= 0 and self.spot_remaining[sid] < spot_need:
                return False
        return True

    def take_rank_split(self, rank: int, reserved_need: int, spot_need: int,
                        reserved_chips: int) -> None:
        self.take_rank(rank, reserved_need)
        sid = self.rank_spot[rank]
        if spot_need and sid >= 0:
            self.spot_remaining[sid] -= spot_need
        held = reserved_need - reserved_chips
        if held:
            pool = self.pools[self.rank_pid[rank]]
            self.headroom_held[pool] = self.headroom_held.get(pool, 0) + held

    def shortfall_rank_split(self, rank: int, reserved_need: int,
                             spot_need: int) -> tuple[str, int]:
        if not self.fits_rank(rank, reserved_need):
            return self.shortfall_rank(rank, reserved_need)
        sid = self.rank_spot[rank]
        if spot_need and sid >= 0 and self.spot_remaining[sid] < spot_need:
            pool = self.pools[self.rank_pid[rank]]
            return f"{pool}:spot", int(spot_need - self.spot_remaining[sid])
        return self.pools[self.rank_pid[rank]], 0

    # -- bulk (the fast bucket path) ----------------------------------------

    def bulk_fits(self, ranks: np.ndarray, needs: np.ndarray) -> bool:
        pool_demand = np.bincount(
            self.rank_pid[ranks], weights=needs,
            minlength=len(self.pool_remaining),
        )
        if np.any(pool_demand > self.pool_remaining):
            return False
        for qids in (self.rank_q1[ranks], self.rank_q2[ranks]):
            m = qids >= 0
            if m.any():
                demand = np.bincount(
                    qids[m], weights=needs[m],
                    minlength=len(self.quota_remaining),
                )
                if np.any(demand > self.quota_remaining):
                    return False
        return True

    def bulk_take(self, ranks: np.ndarray, needs: np.ndarray) -> None:
        self.pool_remaining -= np.bincount(
            self.rank_pid[ranks], weights=needs,
            minlength=len(self.pool_remaining),
        ).astype(np.int64)
        for qids in (self.rank_q1[ranks], self.rank_q2[ranks]):
            m = qids >= 0
            if m.any():
                self.quota_remaining -= np.bincount(
                    qids[m], weights=needs[m],
                    minlength=len(self.quota_remaining),
                ).astype(np.int64)

    def bulk_fits_split(
        self, ranks: np.ndarray, reserved_needs: np.ndarray,
        spot_needs: np.ndarray,
    ) -> bool:
        if not self.bulk_fits(ranks, reserved_needs):
            return False
        sids = self.rank_spot[ranks]
        m = (sids >= 0) & (spot_needs > 0)
        if m.any():
            demand = np.bincount(
                sids[m], weights=spot_needs[m],
                minlength=len(self.spot_remaining),
            )
            if np.any(demand > self.spot_remaining):
                return False
        return True

    def bulk_take_split(
        self, ranks: np.ndarray, reserved_needs: np.ndarray,
        spot_needs: np.ndarray, headroom: np.ndarray,
    ) -> None:
        self.bulk_take(ranks, reserved_needs)
        sids = self.rank_spot[ranks]
        m = (sids >= 0) & (spot_needs > 0)
        if m.any():
            self.spot_remaining -= np.bincount(
                sids[m], weights=spot_needs[m],
                minlength=len(self.spot_remaining),
            ).astype(np.int64)
        hm = headroom > 0
        if hm.any():
            per_pool = np.bincount(
                self.rank_pid[ranks[hm]], weights=headroom[hm],
                minlength=len(self.pools),
            )
            for pid in np.flatnonzero(per_pool):
                pool = self.pools[pid]
                self.headroom_held[pool] = (
                    self.headroom_held.get(pool, 0) + int(per_pool[pid])
                )

    # -- name-addressed (the scalar best-effort helpers) --------------------

    def _rank(self, acc_name: str) -> int | None:
        return self.acc_order.get(acc_name)

    def fits(self, acc_name: str, need: int) -> bool:
        rank = self._rank(acc_name)
        return need <= 0 if rank is None else self.fits_rank(rank, need)

    def take(self, acc_name: str, need: int) -> None:
        rank = self._rank(acc_name)
        if rank is not None:
            self.take_rank(rank, need)

    def headroom(self, acc_name: str) -> int:
        rank = self._rank(acc_name)
        return 0 if rank is None else self.headroom_rank(rank)

    def shortfall(self, acc_name: str, need: int) -> tuple[str, int]:
        rank = self._rank(acc_name)
        return ("", need) if rank is None else self.shortfall_rank(rank, need)


def capacity_buckets(system: System) -> _ArrayLedger:
    """A fresh `_ArrayLedger` for `system` — the pool budgets and quota
    carve-outs in exactly the bucket order the capacity-constrained
    greedy enforces. The reference's offline planner (`planner/replay.py`)
    feeds each timestep's aggregate chip demand through these buckets to
    report when a pool/region first binds, using the same rank ->
    (pool, region-quota, pool-quota) addressing as the live solve."""
    return _ArrayLedger(system)


def solve_greedy_fleet(system: System, optimizer_spec: OptimizerSpec) -> None:
    """Capacity-constrained solve routed through the columnar candidate
    table when one is attached (batched sizing ran this cycle); falls
    back to the scalar `solve_greedy` otherwise — results are
    bit-identical either way."""
    cands = getattr(system, "fleet_candidates", None)
    builder = getattr(system, "fleet_candidates_builder", None)
    if cands is None and builder is not None and _vec_enabled():
        # incremental cycle (parallel/incremental.py): when last cycle's
        # solve was all-bulk, re-charge the ledger from the persistent
        # preferred-candidate columns (only dirty servers re-derived)
        # and skip building the candidate table entirely; any binding
        # falls through to the exact pass below
        from inferno_tpu_torch.parallel.incremental import try_greedy_bulk

        if try_greedy_bulk(system, optimizer_spec):
            return
        cands = builder()
        system.fleet_candidates = cands
    if cands is None or not _vec_enabled():
        solve_greedy(system, optimizer_spec)
        return
    # local import: parallel.fleet imports torch; solver modules stay
    # importable without it through the scalar path above
    from inferno_tpu_torch.parallel.fleet import LaneAllocations

    system.degradations = {}
    ledger = _ArrayLedger(system)
    names = list(system.servers)
    servers_list = list(system.servers.values())
    acc_names = sorted(system.accelerators)

    # table segment per server position
    seg_of = {int(p): i for i, p in enumerate(cands.seg_server)}

    # -- assemble the global candidate arrays: table rows + ext rows for
    # plain-dict servers (zero-load shortcut, cache replays) ----------------
    n_table = cands.num_rows
    ext_val: list[float] = []
    ext_cost: list[float] = []
    ext_reps: list[int] = []
    ext_chips: list[int] = []
    ext_rank: list[int] = []
    ext_spot: list[int] = []
    direct: dict[int, object] = {}  # global row -> Allocation (ext rows)

    e_pos: list[int] = []  # entry -> server position
    e_start: list[int] = []
    e_end: list[int] = []

    for pos, server in enumerate(servers_list):
        server.remove_allocation()
        allocs = server.all_allocations
        if (
            isinstance(allocs, LaneAllocations)
            and getattr(allocs, "_src", None) is cands.src
            and pos in seg_of
        ):
            i = seg_of[pos]
            e_pos.append(pos)
            e_start.append(int(cands.bounds[i]))
            e_end.append(int(cands.bounds[i + 1]))
            continue
        if not allocs:
            continue
        ordered = sorted(allocs.values(), key=candidate_sort_key)
        start = n_table + len(ext_val)
        for alloc in ordered:
            pc = _chips_per_replica(system, names[pos], alloc)
            ext_val.append(float(alloc.value))
            ext_cost.append(float(alloc.cost))
            ext_reps.append(int(alloc.num_replicas))
            ext_spot.append(int(alloc.spot_replicas))
            if pc is None:
                # the scalar loop drops the whole entry when it pops an
                # unresolvable candidate; the sentinel replays that
                ext_chips.append(-1)
                ext_rank.append(-1)
            else:
                ext_chips.append(pc[1])
                ext_rank.append(ledger.acc_order[pc[0]])
            direct[n_table + len(ext_val) - 1] = alloc
        e_pos.append(pos)
        e_start.append(start)
        e_end.append(n_table + len(ext_val))

    if not e_pos:
        return

    if ext_val:
        g_value = np.concatenate([cands.value, np.asarray(ext_val, np.float64)])
        g_cost = np.concatenate([cands.cost, np.asarray(ext_cost, np.float64)])
        g_reps = np.concatenate([cands.reps, np.asarray(ext_reps, np.int64)])
        g_chips = np.concatenate([cands.chips, np.asarray(ext_chips, np.int64)])
        g_rank = np.concatenate([cands.rank, np.asarray(ext_rank, np.int64)])
        g_spot = np.concatenate([cands.spot_reps, np.asarray(ext_spot, np.int64)])
    else:
        g_value, g_cost = cands.value, cands.cost
        g_reps, g_chips, g_rank = cands.reps, cands.chips, cands.rank
        g_spot = cands.spot_reps
    g_kind, g_lane = cands.kind, cands.lane

    e_pos_a = np.asarray(e_pos, np.int64)
    e_start_a = np.asarray(e_start, np.int64)
    e_end_a = np.asarray(e_end, np.int64)
    class_prio = {
        name: svc.priority for name, svc in system.service_classes.items()
    }
    e_prio = np.asarray(
        [
            class_prio.get(
                servers_list[p].service_class_name, DEFAULT_SERVICE_CLASS_PRIORITY
            )
            for p in e_pos
        ],
        np.int64,
    )
    value0 = g_value[e_start_a]
    delta0 = np.where(
        e_end_a - e_start_a > 1,
        g_value[np.minimum(e_start_a + 1, len(g_value) - 1)] - g_value[e_start_a],
        np.inf,
    )
    # the scalar entry order: stable sort by (priority, -delta, -value)
    order = np.lexsort((-value0, -delta0, e_prio))

    cur = np.zeros(len(e_pos), np.int64)
    pending: list[tuple[str, int] | None] = [None] * len(e_pos)
    # all-bulk tracking: next cycle's incremental ledger re-charge is
    # only sound when every group took the bulk path (no heap walk —
    # binding releases can unblock lower priorities)
    used_heap = [False]

    def materialize(row: int, pos: int):
        if row < n_table:
            return servers_list[pos].all_allocations.lane_alloc(
                int(g_kind[row]), int(g_lane[row])
            )
        return direct[row]

    def preferred_shape(e: int) -> tuple[str, int]:
        """(accelerator, replicas) of the entry's preferred candidate,
        read from the arrays — no materialization."""
        row = int(e_start_a[e])
        rank = int(g_rank[row])
        acc = acc_names[rank] if 0 <= rank < len(acc_names) else ""
        return acc, int(g_reps[row])

    def emit(e: int, step: str, to_acc: str, to_reps: int) -> None:
        from_acc, from_reps = preferred_shape(e)
        pool, deficit = pending[e] or ("", 0)
        name = names[e_pos[e]]
        system.degradations[name] = DegradationEvent(
            server=name, step=step, pool=pool, shortfall_chips=deficit,
            from_accelerator=from_acc, to_accelerator=to_acc,
            from_replicas=from_reps, to_replicas=to_reps,
        )

    def allocate_group(group: np.ndarray) -> list[int]:
        """The SLO-satisfying pass over one priority bucket (or, in
        delayed mode, the whole fleet). Returns unallocated entry ids in
        the exact pop order the scalar loop would produce."""
        # fast bucket path: the whole group's preferred demand fits —
        # reserved chips + blast-radius headroom against the reserved
        # buckets, spot chips against the spot budgets (identical to
        # the plain needs when no row carries spot replicas)
        firsts = e_start_a[group]
        if np.all(g_chips[firsts] >= 0):
            spot_chips = g_spot[firsts] * g_chips[firsts]
            ranks = g_rank[firsts]
            headroom = np.ceil(
                ledger.rank_blast[ranks] * spot_chips
            ).astype(np.int64)
            res_needs = (g_reps[firsts] - g_spot[firsts]) * g_chips[firsts] + headroom
            if ledger.bulk_fits_split(ranks, res_needs, spot_chips):
                ledger.bulk_take_split(ranks, res_needs, spot_chips, headroom)
                for e in group:
                    pos = int(e_pos_a[e])
                    servers_list[pos].set_allocation(
                        materialize(int(e_start_a[e]), pos)
                    )
                _prof.count("ledger_bulk_groups")
                return []

        # exact sequential loop: heap keys replicate the scalar solver's
        # sorted list + bisect_left reinsertion (a reinserted entry pops
        # before every queued equal-key entry; newest reinsertion first)
        used_heap[0] = True
        heap = [
            (int(e_prio[e]), -float(delta0[e]), -float(value0[e]), k, int(e))
            for k, e in enumerate(group)
        ]
        _prof.count("ledger_heap_groups")
        heap_pops = 0
        reinsert_seq = -1
        unallocated: list[int] = []
        while heap:
            heap_pops += 1
            _, _, _, _, e = heapq.heappop(heap)
            pos = int(e_pos_a[e])
            row = int(e_start_a[e] + cur[e])
            chips = int(g_chips[row])
            if chips < 0:
                continue  # unresolvable candidate: scalar drops the entry
            need = int(g_reps[row]) * chips
            rank = int(g_rank[row])
            spot_k = int(g_spot[row])
            res_need, spot_need = ledger.needs_rank(
                rank, int(g_reps[row]), spot_k, chips
            )
            if ledger.fits_rank_split(rank, res_need, spot_need):
                ledger.take_rank_split(rank, res_need, spot_need,
                                       need - spot_need)
                alloc = materialize(row, pos)
                servers_list[pos].set_allocation(alloc)
                if cur[e] > 0:
                    emit(
                        e,
                        _classify_step(preferred_shape(e)[0], alloc.accelerator),
                        alloc.accelerator, int(g_reps[row]),
                    )
            elif spot_k and ledger.fits_rank(rank, need):
                # pre-positioner fallback (scalar: the demote branch of
                # greedy._allocate): spot tier or headroom unavailable,
                # all-reserved placement at the undiscounted price; the
                # shortfall is read BEFORE the take mutates the books
                from inferno_tpu_torch.spot.market import demote_spot

                if cur[e] == 0:
                    pending[e] = ledger.shortfall_rank_split(
                        rank, res_need, spot_need
                    )
                ledger.take_rank(rank, need)
                alloc = demote_spot(materialize(row, pos))
                servers_list[pos].set_allocation(alloc)
                if cur[e] == 0:
                    emit(e, DEGRADE_SPOT_HEADROOM, alloc.accelerator,
                         int(g_reps[row]))
                else:
                    emit(
                        e,
                        _classify_step(preferred_shape(e)[0], alloc.accelerator),
                        alloc.accelerator, int(g_reps[row]),
                    )
            else:
                if cur[e] == 0:
                    pending[e] = ledger.shortfall_rank_split(
                        rank, res_need, spot_need
                    )
                cur[e] += 1
                nxt = int(e_start_a[e] + cur[e])
                if nxt + 1 < int(e_end_a[e]):
                    delta = float(g_value[nxt + 1] - g_value[nxt])
                elif nxt == int(e_end_a[e]):
                    unallocated.append(e)
                    continue
                else:
                    delta = math.inf
                heapq.heappush(
                    heap,
                    (int(e_prio[e]), -delta, -float(g_value[nxt]),
                     reinsert_seq, e),
                )
                reinsert_seq -= 1
        # one batched count, not one hook call per pop: the heap walk is
        # the solver's hot path when a pool binds
        _prof.count("ledger_heap_pops", heap_pops)
        return unallocated

    def settle(unallocated: list[int]) -> None:
        """Best-effort treatment of the group's leftovers per the
        saturation policy. NONE stays fully lazy (events only); real
        policies inflate just these servers' candidates and reuse the
        scalar helpers on the shared ledger."""
        if not unallocated:
            return
        pol = parse_policy(optimizer_spec.saturation_policy)
        if pol is SaturationPolicy.NONE:
            for e in unallocated:
                emit(e, DEGRADE_ZEROED, "", 0)
            return
        entries = []
        for e in unallocated:
            pos = int(e_pos_a[e])
            rows = range(int(e_start_a[e]), int(e_end_a[e]))
            entries.append(
                _ServerEntry(
                    server_name=names[pos],
                    priority=int(e_prio[e]),
                    cur_index=0,
                    allocations=[materialize(r, pos) for r in rows],
                    delta=math.inf,
                    pending_shortfall=pending[e],
                )
            )
        _best_effort(
            system, entries, ledger, optimizer_spec.saturation_policy
        )

    prio_sorted = e_prio[order]
    if optimizer_spec.delayed_best_effort:
        settle(allocate_group(order))
    else:
        starts = np.flatnonzero(
            np.r_[True, prio_sorted[1:] != prio_sorted[:-1]]
        )
        bounds = np.append(starts, len(order))
        for a, b in zip(bounds[:-1], bounds[1:]):
            settle(allocate_group(order[a:b]))
    if getattr(system, "fleet_dirty", None) is not None:
        from inferno_tpu_torch.parallel.incremental import record_greedy

        record_greedy(system, bulk_only=not used_heap[0])
