"""Incremental dirty-set reconcile.

The full fleet path (`parallel.fleet.calculate_fleet`) re-derives every
lane's sizing, transition penalty, and per-server argmin each cycle even
when the snapshot proves almost nothing changed. This module pushes the
snapshot's change detection from *cache-hit* into *skip-entirely*:

* `FleetSnapshot.scan_update` classifies every server into CLEAN /
  VALUE / RATE / FULL tiers (parallel/snapshot.py);
* persistent **static-row-aligned result tables** hold the last solved
  FleetResult columns, transition-penalty values, spot splits, and the
  per-server [servers] preferred-candidate columns the capacity solve's
  bulk replay charges;
* dirty lanes run as a **gathered** pass — FULL lanes through the full
  sizing kernel, RATE lanes through the cheap refold kernel
  (`ops.queueing.fleet_refold` / `tandem_refold`: the bisection is
  rate-independent, so a λ-only change re-derives replicas/cost and the
  operating point in ONE stationary solve instead of ~66) — and scatter
  back into the tables;
* clean servers replay their prior `LaneAllocations` OBJECT untouched;
  the capacity-candidate table becomes a lazy builder (limited mode
  only pays for it), and the unlimited/greedy solvers re-apply only
  dirty servers' allocations on a persistent System.

Correctness contract (tests/test_torch_incremental.py): with
INCREMENTAL_CYCLE=0 (or FLEET_SNAPSHOT=0, or an `only=` subset) cycles
take the full path; with it on, an N-dirty cycle's choices, replica
counts, costs, solver values, spot splits and degradation events are
bit-identical to the full solve of the same inputs, and the operating
point (itl/ttft/rho) of λ-only lanes agrees within 1e-4 relative. This
rests on each lane's result being independent of the lanes beside it in
a bucket and of the bucket's padded width, which the kernels and their
plain versions are designed for.

Port of `inferno_tpu/parallel/incremental.py`, numpy apart from the
gathered solve: the dirty lanes go through `parallel.fleet.solve_slots`,
the same dispatch and bucketing rule as the full path, on backend "cuda"
(every stationary solve on `stats_kernel`, every bisection on
`bisect_kernel`) or "torch" (their plain versions). The reference never
runs its Pallas kernel here; the port runs its kernels on this path as
on the full one. The cycle profiler's counters keep the reference's
names; the spans `snapshot_update`, `incremental_scatter` and
`incremental_writeback` time this cycle's layers, and `dispatch` its
gathered solve (`fleet.solve_slots`, see `parallel/fleet.py`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# cycle-profiler hooks (obs/profiler.py): thread-local no-ops unless a
# profiler is active; observation only
from inferno_tpu_torch.obs import profiler as _prof
from inferno_tpu_torch.ops.queueing import (
    DEFAULT_BISECT_ITERS,
    FleetParams,
    FleetResult,
    TandemParams,
    offered_load,
)
from inferno_tpu_torch.parallel.snapshot import (
    SCAN_CLEAN,
    SCAN_FULL,
    SCAN_RATE,
    SCAN_VALUE,
)

_RESULT_FIELDS = (
    "feasible", "lambda_star", "rate_star", "num_replicas",
    "cost", "itl", "ttft", "rho",
)

_KIND_NAMES = ("agg", "tan")


class _PlanView:
    """Duck-typed stand-in for a FleetPlan inside the persistent
    `_LaneSource`: materialization only reads `.lanes[row]`, and the
    incremental tables address lanes by STATIC row id."""

    __slots__ = ("lanes",)

    def __init__(self, lanes):
        self.lanes = lanes


class _KindTable:
    """Persistent solved-state of one lane kind, aligned to the
    snapshot's static row space (masked-out rows simply stay invalid)."""

    __slots__ = ("res", "valid", "value", "cost64", "spot", "rows_per_server")

    def __init__(self, m: int, rows_per_server: np.ndarray):
        self.res = FleetResult(
            feasible=np.zeros(m, bool),
            lambda_star=np.zeros(m, np.float32),
            rate_star=np.zeros(m, np.float32),
            num_replicas=np.zeros(m, np.int32),
            cost=np.zeros(m, np.float32),
            itl=np.zeros(m, np.float32),
            ttft=np.zeros(m, np.float32),
            rho=np.zeros(m, np.float32),
        )
        self.valid = np.zeros(m, bool)
        self.value = np.zeros(m, np.float64)
        self.cost64 = np.zeros(m, np.float64)
        # (cost_adj f64, spot_k i64, discount f64, premium f64, trimmed
        # bool) when the System carries a spot tier, else None
        self.spot: tuple | None = None
        self.rows_per_server = rows_per_server.copy()

    def ensure_spot(self, m: int) -> tuple:
        if self.spot is None:
            self.spot = (
                np.zeros(m, np.float64), np.zeros(m, np.int64),
                np.zeros(m, np.float64), np.zeros(m, np.float64),
                np.zeros(m, bool),
            )
        return self.spot


class _State:
    """The cross-cycle incremental state (module singleton)."""

    __slots__ = (
        "names", "structure_version", "backend", "device", "mesh", "kinds", "source",
        "la", "pref_rank", "pref_reps", "pref_spot", "pref_chips",
        "applied_system", "solve_system", "greedy", "force_full",
        "cands", "cands_system", "la_complete",
    )


@dataclasses.dataclass
class FleetDirty:
    """Attached to the System by `incremental_cycle`: what this cycle
    re-derived (consumed by the solvers' replay fast paths and by the
    reconciler's dirty metrics)."""

    codes: np.ndarray  # int8[S]: SCAN_* verdict per server position
    dirty_pos: np.ndarray  # positions with codes != CLEAN
    state: _State
    dirty_lanes: int  # lanes solved through a kernel this cycle
    refold_lanes: int  # of those, lanes that took the cheap refold
    skipped_servers: int  # servers that replayed everything
    # servers whose content the scan actually read (poll: the fleet;
    # event-authoritative: the dirty set) — the event bench's work axis
    scanned_servers: int = 0


_state: _State | None = None


def reset_state() -> None:
    """Void the persistent incremental state (reset_fleet_state, or any
    pass through the non-incremental path — its tables no longer
    describe what is on the servers)."""
    global _state
    _state = None


def reset_state_for(system) -> None:
    """Void the persistent state iff a non-incremental pass is about to
    rewrite THIS System's candidates/allocations (the state's replay
    claims about it would go stale). A full pass over a DIFFERENT System
    leaves the state alone: its tables are content-addressed through the
    snapshot, and the next incremental scan re-verifies them — this is
    what lets a parity harness interleave reference full solves with an
    incremental fleet without resetting it (tests/test_incremental.py)."""
    st = _state
    if st is not None and (
        st.applied_system is system or st.solve_system is system
    ):
        reset_state()


def reset_results() -> None:
    """Void only the SOLVED results (bench cold-path helper): the next
    incremental cycle re-runs the full kernel on every lane — first-sight
    cost with a warm scan, warm jit, and a warm static table."""
    if _state is not None:
        _state.force_full = True
        for t in _state.kinds.values():
            t.valid[:] = False
        _state.greedy = {"ok": False}


def _cumsum0(a: np.ndarray) -> np.ndarray:
    out = np.zeros(len(a) + 1, np.int64)
    np.cumsum(a, out=out[1:])
    return out


def _new_state(snap, names, backend, device, mesh) -> _State:
    from inferno_tpu_torch.parallel import fleet as F

    st = _State()
    st.names = names
    st.structure_version = snap.structure_version
    st.backend = backend
    st.device = device
    st.mesh = mesh
    n = len(names)
    st.la = [None] * n
    st.pref_rank = np.full(n, -1, np.int64)
    st.pref_reps = np.zeros(n, np.int64)
    st.pref_spot = np.zeros(n, np.int64)
    st.pref_chips = np.zeros(n, np.int64)
    st.kinds = {}
    st.source = F._LaneSource()
    for kind_name in _KIND_NAMES:
        kt = snap.kind_table(kind_name)
        st.kinds[kind_name] = _KindTable(len(kt.lanes), kt.rows_per_server)
    st.applied_system = None
    st.solve_system = None
    st.greedy = {"ok": False}
    st.force_full = False
    st.cands = None
    st.cands_system = None
    st.la_complete = False
    return st


def _bind_source(st: _State, snap) -> None:
    """Re-point the persistent lane source at the snapshot's CURRENT
    lanes/dyn arrays (they are replaced on repack / load apply)."""
    for kind_name in _KIND_NAMES:
        kt = snap.kind_table(kind_name)
        t = st.kinds[kind_name]
        st.source.plans[kind_name] = _PlanView(kt.lanes)
        st.source.results[kind_name] = t.res
        st.source.values[kind_name] = t.value
        batch_key = "agg_batch" if kind_name == "agg" else "tan_batch"
        st.source.batches[kind_name] = kt.dyn.get(
            batch_key, np.zeros(len(kt.lanes))
        )
        st.source.spot[kind_name] = t.spot


def _remap(st: _State, snap, codes: np.ndarray) -> None:
    """Carry the persistent tables across a static-table repack: servers
    whose fragments (and lane counts) are unchanged keep their solved
    rows at the new row numbers; everything else re-solves. All
    surviving servers are escalated to at least VALUE so their
    LaneAllocations are rebuilt over the new row ids (a pure re-index:
    the copied values are bit-identical)."""
    for kind_name in _KIND_NAMES:
        kt = snap.kind_table(kind_name)
        t = st.kinds[kind_name]
        old_rps = t.rows_per_server
        new_rps = kt.rows_per_server
        m_new = len(kt.lanes)
        new = _KindTable(m_new, new_rps)
        if t.spot is not None:
            new.ensure_spot(m_new)
        if len(old_rps) == len(new_rps):
            keep = (old_rps == new_rps) & (codes != SCAN_FULL)
            sel_new = np.flatnonzero(keep[kt.lane_server]) if m_new else (
                np.zeros(0, np.int64)
            )
            if len(sel_new):
                offs = (_cumsum0(old_rps)[:-1] - _cumsum0(new_rps)[:-1])[
                    kt.lane_server[sel_new]
                ]
                sel_old = sel_new + offs
                for field in _RESULT_FIELDS:
                    getattr(new.res, field)[sel_new] = getattr(t.res, field)[sel_old]
                new.valid[sel_new] = t.valid[sel_old]
                new.value[sel_new] = t.value[sel_old]
                new.cost64[sel_new] = t.cost64[sel_old]
                if t.spot is not None:
                    for dst, src in zip(new.spot, t.spot):
                        dst[sel_new] = src[sel_old]
        st.kinds[kind_name] = new
    # surviving servers re-index their LaneAllocations (VALUE tier);
    # anything already FULL re-solves outright
    codes[codes == SCAN_CLEAN] = SCAN_VALUE
    codes[codes == SCAN_RATE] = SCAN_FULL
    st.structure_version = snap.structure_version
    st.greedy = {"ok": False}


def incremental_cycle(
    system,
    device,
    backend: str,
    lam_tolerance: float = 0.0,
    max_age_cycles: int = 0,
    event_dirty=None,
    mesh=None,
) -> int:
    """One incremental fleet cycle — the INCREMENTAL_CYCLE=1 body of
    `calculate_fleet` (which owns the routing/eligibility decision).

    With `event_dirty` (an iterable of server names) the scan runs
    event-authoritative: only the named servers are re-read and the
    O(fleet) content diff is skipped (`FleetSnapshot.scan_event_update`,
    which falls back to the full poll scan on any doubt). `None` — the
    default, and the anti-entropy cadence — is the full poll scan.

    `mesh` (a `parallel.mesh.FleetMesh`, resolved by `calculate_fleet`)
    splits the dirty buckets, padded to a multiple of its size, over its
    devices; a different mesh object rebuilds the state, as a different
    backend or device does."""
    global _state
    from inferno_tpu_torch.parallel import fleet as F

    snap = F._get_snapshot()
    with _prof.span("snapshot_update"):
        if event_dirty is None:
            snap.scan_update(system, lam_tolerance, max_age_cycles)
        else:
            snap.scan_event_update(system, event_dirty, lam_tolerance)

    names = snap._names
    servers_list = list(system.servers.values())
    n_srv = len(names)

    st = _state
    if (
        st is None
        or snap.scan_all_dirty
        or st.backend != backend
        or st.device != device
        or st.mesh is not mesh
        or st.names != names
    ):
        st = _state = _new_state(snap, names, backend, device, mesh)
        codes = np.full(n_srv, SCAN_FULL, np.int8)
    else:
        codes = snap.scan_codes.copy()
        if st.structure_version != snap.structure_version:
            _remap(st, snap, codes)
        if st.force_full:
            codes[:] = SCAN_FULL
            st.force_full = False
    _bind_source(st, snap)
    st.cands = None
    st.cands_system = None

    # escalation: a non-FULL server whose eligible rows lack valid solved
    # results cannot replay (first sight, voided results, mask growth)
    for kind_name in _KIND_NAMES:
        kt = snap.kind_table(kind_name)
        t = st.kinds[kind_name]
        if kt.mask is not None and len(kt.mask):
            bad = kt.mask & ~t.valid
            if bad.any():
                bad_srv = np.unique(kt.lane_server[bad])
                codes[bad_srv] = SCAN_FULL
    # a server never writeback'd on this state cannot replay either.
    # NOTE: guarded by an explicit flag, never `None in st.la` — `in`
    # falls back to == per element, and LaneAllocations.__eq__ would
    # lazily materialize every clean server's candidate dict
    if not st.la_complete:
        never = np.asarray([la is None for la in st.la], bool)
        codes[never & (codes != SCAN_FULL)] = SCAN_FULL
        st.la_complete = not never.any()

    full_pos = np.flatnonzero(codes == SCAN_FULL)
    rate_pos = np.flatnonzero(codes == SCAN_RATE)
    wb_pos = np.flatnonzero(codes != SCAN_CLEAN)
    _prof.count("skipped_servers", int(n_srv - len(wb_pos)))

    acc_names = sorted(system.accelerators)
    acc_order = {a: i for i, a in enumerate(acc_names)}

    # zero-load / no-load shortcut for EVERY dirty server (not just FULL:
    # a VALUE-dirty zero-load server's transition penalties were computed
    # against the old current allocation and must re-derive — replaying
    # the stale dict broke decision parity, caught in review)
    for pos in wb_pos.tolist():
        server = servers_list[pos]
        load = server.load
        if load is None or load.arrival_rate < 0:
            st.la[pos] = {}
        elif load.arrival_rate == 0 or load.avg_out_tokens == 0:
            st.la[pos] = F._zero_load_dict(system, server) or {}
        else:
            st.la[pos] = {}  # replaced below when feasible lanes exist

    # -- gathered solve: FULL lanes -> full kernel, RATE lanes -> refold ----
    slots: list = []
    chunk = F._mesh_chunk(mesh)
    n_lanes_total = 0
    refold_lanes = 0

    def add_bucketed(kind_name: str, rows: np.ndarray, refold: bool) -> None:
        nonlocal refold_lanes
        t = st.kinds[kind_name]
        cols = snap.columns(kind_name, rows)
        pcls = FleetParams if kind_name == "agg" else TandemParams
        params = pcls(**cols)
        if kind_name == "agg":
            batches = cols["max_batch"]
        else:
            batches = np.maximum(cols["prefill_batch"], cols["decode_batch"])
        cached = None
        if refold:
            cached = (
                t.res.lambda_star[rows], t.res.rate_star[rows], t.res.feasible[rows],
            )
            refold_lanes += len(rows)
        F.add_bucketed(slots, kind_name, params, batches, rows, cached, chunk=chunk)

    for kind_name in _KIND_NAMES:
        kt = snap.kind_table(kind_name)
        t = st.kinds[kind_name]
        if len(full_pos):
            # a FULL server's previously-valid rows are void whatever the
            # new mask says (its eligible set may have shrunk)
            m = np.zeros(n_srv, bool)
            m[full_pos] = True
            if len(kt.lane_server):
                t.valid[m[kt.lane_server]] = False
            rows = snap.rows_for_positions(kind_name, full_pos)
            if len(rows):
                add_bucketed(kind_name, rows, refold=False)
        if len(rate_pos):
            rows = snap.rows_for_positions(kind_name, rate_pos)
            if len(rows):
                add_bucketed(kind_name, rows, refold=True)

    if slots:
        packed_all = F.solve_slots(
            slots, device, DEFAULT_BISECT_ITERS, backend == "cuda", mesh
        )
        with _prof.span("incremental_scatter"):
            for slot, res in F.iter_slot_results(slots, packed_all):
                t = st.kinds[slot.kind]
                for field in _RESULT_FIELDS:
                    getattr(t.res, field)[slot.idx] = getattr(res, field)
                t.valid[slot.idx] = True
                n_lanes_total += len(slot.idx)
    _prof.count("dirty_lanes", n_lanes_total)
    _prof.count("refold_lanes", refold_lanes)

    # -- writeback for dirty servers: penalties, spot, per-server argmin ----
    with _prof.span("incremental_writeback"):
        spot_cols = None
        if getattr(system, "spot", None):
            from inferno_tpu_torch.spot.market import rank_columns

            spot_cols = rank_columns(system, acc_names)

        if len(wb_pos):
            scan = snap._scan
            inv = np.full(n_srv, -1, np.int64)
            inv[wb_pos] = np.arange(len(wb_pos))
            cw_rank = np.empty(len(wb_pos), np.int64)
            cw_cost = np.empty(len(wb_pos), np.float64)
            cw_reps = np.empty(len(wb_pos), np.int64)
            for j, pos in enumerate(wb_pos.tolist()):
                acc, cost, reps = scan.cur_vals[pos]
                cw_rank[j] = acc_order.get(acc, -1) if acc else -1
                cw_cost[j] = cost
                cw_reps[j] = reps

            cat: list[tuple] = []  # feasible rows per kind, as F._CandidateTable takes
            for kind_id, kind_name in enumerate(_KIND_NAMES):
                kt = snap.kind_table(kind_name)
                t = st.kinds[kind_name]
                rows = snap.rows_for_positions(kind_name, wb_pos)
                if not len(rows):
                    continue
                reps64 = t.res.num_replicas[rows].astype(np.int64)
                cost64 = t.res.cost[rows].astype(np.float64)
                rank_rows = kt.cols["acc_rank"][rows].astype(np.int64)
                spot = None
                if spot_cols is not None:
                    cols = snap.columns(kind_name, rows)
                    total = offered_load(
                        cols["total_rate"], cols["target_tps"], cols["out_tokens"], np
                    )
                    spot, _ = F._spot_terms(
                        reps64, total, t.res.rate_star[rows], cost64,
                        cols["cost_per_replica"].astype(np.float64),
                        tuple(col[rank_rows] for col in spot_cols),
                    )
                    cost64 = spot[0]
                    for dst, src in zip(t.ensure_spot(len(t.valid)), spot):
                        dst[rows] = src
                    st.source.spot[kind_name] = t.spot
                li = inv[kt.lane_server[rows]]
                value = F._transition_value(
                    rank_rows == cw_rank[li], reps64, cw_reps[li], cost64, cw_cost[li],
                    None if spot is None else spot[3],
                )
                t.value[rows] = value
                t.cost64[rows] = cost64
                fe = t.res.feasible[rows]
                if fe.any():
                    rf = rows[fe]
                    cat.append((
                        kind_id, rf, kt.lane_server[rf], rank_rows[fe], value[fe],
                        cost64[fe], t.res.num_replicas[rf].astype(np.int64),
                        kt.cols["chips_per_replica"][rf].astype(np.int64),
                        None if spot is None else spot[1][fe],
                    ))

            covered = np.zeros(n_srv, bool)
            if cat:
                table = F._CandidateTable(st.source, cat)
                firsts, seg_pos = table.firsts, table.seg_server
                covered[seg_pos] = True
                st.pref_rank[seg_pos] = table.rank[firsts]
                st.pref_reps[seg_pos] = table.reps[firsts]
                st.pref_spot[seg_pos] = table.spot_reps[firsts]
                st.pref_chips[seg_pos] = table.chips[firsts]
                for pos, allocs in table.allocations():
                    st.la[pos] = allocs
            # dirty servers without a feasible lane: zero-load dict (built
            # above) or genuinely empty — per-server columns from its pick
            from inferno_tpu_torch.solver.greedy import _chips_per_replica, candidate_sort_key

            for pos in wb_pos[~covered[wb_pos]].tolist():
                d = st.la[pos]
                best = min(d.values(), key=candidate_sort_key) if d else None
                if best is None or not best.accelerator:
                    st.pref_rank[pos] = -1
                    st.pref_reps[pos] = 0
                    st.pref_spot[pos] = 0
                    st.pref_chips[pos] = 0
                    continue
                st.pref_rank[pos] = acc_order.get(best.accelerator, -1)
                st.pref_reps[pos] = best.num_replicas
                st.pref_spot[pos] = best.spot_replicas
                pc = _chips_per_replica(system, names[pos], best)
                st.pref_chips[pos] = pc[1] if pc is not None else -1

    # -- hand the cycle's results to the System -----------------------------
    if st.applied_system is system:
        assign = wb_pos.tolist()
    else:
        assign = range(n_srv)
        st.applied_system = system
        st.solve_system = None  # fresh servers carry no allocations yet
    for pos in assign:
        servers_list[pos].all_allocations = st.la[pos]
    # every never-writeback server was escalated to FULL above, so the
    # state now covers the whole fleet
    st.la_complete = True

    system.candidates_calculated = True
    system.fleet_candidates = None
    system.fleet_candidates_builder = lambda: _build_candidates(system)
    system.fleet_dirty = FleetDirty(
        codes=codes,
        dirty_pos=wb_pos,
        state=st,
        dirty_lanes=n_lanes_total,
        refold_lanes=refold_lanes,
        skipped_servers=int(n_srv - len(wb_pos)),
        scanned_servers=int(getattr(snap, "scan_scanned", n_srv)),
    )
    n = 0
    for kind_name in _KIND_NAMES:
        kt = snap.kind_table(kind_name)
        if kt.mask is not None and len(kt.mask):
            n += int(kt.mask.sum())
    return n


def _build_candidates(system):
    """Lazy `FleetCandidates` over the persistent tables — built only
    when the capacity-constrained solver actually asks (unlimited-mode
    cycles never pay the global candidate sort)."""
    from inferno_tpu_torch.parallel import fleet as F

    fd = getattr(system, "fleet_dirty", None)
    if fd is None:
        return None
    st = fd.state
    if st.cands is not None and st.cands_system is system:
        return st.cands
    snap = F._get_snapshot()
    cat: list[tuple] = []
    for kind_id, kind_name in enumerate(_KIND_NAMES):
        kt = snap.kind_table(kind_name)
        t = st.kinds[kind_name]
        if kt.mask is None or not len(kt.mask):
            continue
        rows = np.flatnonzero(kt.mask & t.valid & t.res.feasible)
        if not len(rows):
            continue
        cat.append((
            kind_id, rows, kt.lane_server[rows],
            kt.cols["acc_rank"][rows].astype(np.int64), t.value[rows],
            t.cost64[rows], t.res.num_replicas[rows].astype(np.int64),
            kt.cols["chips_per_replica"][rows].astype(np.int64),
            None if t.spot is None else t.spot[1][rows],
        ))
    if not cat:
        return None
    cands = F._CandidateTable(st.source, cat, materialization=False).candidates()
    st.cands = cands
    st.cands_system = system
    return cands


# -- solver replay fast paths -------------------------------------------------


def try_unlimited_replay(system) -> bool:
    """Re-apply only dirty servers' unlimited picks on a persistent
    System whose clean allocations are still standing from the previous
    solve. Bit-identical to the full loop: a clean server's best() is
    the same object it already holds."""
    fd = getattr(system, "fleet_dirty", None)
    if fd is None:
        return False
    st = fd.state
    if st.solve_system is not system:
        return False
    from inferno_tpu_torch.solver.greedy import candidate_sort_key

    servers_list = list(system.servers.values())
    for pos in fd.dirty_pos.tolist():
        server = servers_list[pos]
        server.remove_allocation()
        allocs = server.all_allocations
        picker = getattr(allocs, "best", None)
        if picker is not None:
            best = picker()
        else:
            best = min(allocs.values(), key=candidate_sort_key) if allocs else None
        if best is not None:
            server.set_allocation(best)
    _prof.count("solve_replayed_servers", int(fd.skipped_servers))
    return True


def record_unlimited(system) -> None:
    """Mark this System's allocations as the standing unlimited solve
    (called after a full solve_unlimited pass when dirty info exists)."""
    fd = getattr(system, "fleet_dirty", None)
    if fd is not None:
        fd.state.solve_system = system


def try_greedy_bulk(system, optimizer_spec) -> bool:
    """Capacity-solve fast path: when the previous cycle's solve was
    all-bulk (every priority group's preferred demand fit — no heap, no
    degradations, no best-effort), re-charge the ledger from the
    persistent preferred-candidate columns with only dirty servers'
    charges re-derived, and re-apply only dirty allocations. Falls back
    to the full solve whenever the whole fleet's preferred demand no
    longer fits (a binding bucket can unblock lower priorities on
    release, so anything short of everyone-gets-preferred needs the
    exact pass)."""
    fd = getattr(system, "fleet_dirty", None)
    if fd is None:
        return False
    st = fd.state
    g = st.greedy
    if not g.get("ok"):
        return False
    from inferno_tpu_torch.solver.greedy_vec import _ArrayLedger

    has = st.pref_rank >= 0
    if not has.any():
        return False
    if (st.pref_chips[has] < 0).any():
        return False  # unresolvable candidate: exact path decides
    ledger = _ArrayLedger(system)
    ranks = st.pref_rank[has]
    reps = st.pref_reps[has]
    spotk = st.pref_spot[has]
    chips = st.pref_chips[has]
    spot_chips = spotk * chips
    headroom = np.ceil(ledger.rank_blast[ranks] * spot_chips).astype(np.int64)
    res_needs = (reps - spotk) * chips + headroom
    if not ledger.bulk_fits_split(ranks, res_needs, spot_chips):
        g["ok"] = False  # binding: exact pass, and stay exact until bulk again
        return False
    ledger.bulk_take_split(ranks, res_needs, spot_chips, headroom)
    system.degradations = {}
    from inferno_tpu_torch.solver.greedy import candidate_sort_key

    servers_list = list(system.servers.values())
    if g.get("system") is system and g.get("applied"):
        positions = fd.dirty_pos.tolist()
    else:
        positions = range(len(servers_list))
    for pos in positions:
        server = servers_list[pos]
        server.remove_allocation()
        if st.pref_rank[pos] < 0:
            continue
        allocs = server.all_allocations
        picker = getattr(allocs, "best", None)
        if picker is not None:
            best = picker()
        else:
            best = min(allocs.values(), key=candidate_sort_key) if allocs else None
        if best is not None:
            server.set_allocation(best)
    g["system"] = system
    g["applied"] = True
    _prof.count("ledger_incremental_bulk")
    return True


def record_greedy(system, bulk_only: bool) -> None:
    """Record whether the full capacity solve was all-bulk (the
    precondition of next cycle's `try_greedy_bulk`)."""
    fd = getattr(system, "fleet_dirty", None)
    if fd is None:
        return
    fd.state.greedy = {
        "ok": bool(bulk_only), "system": system, "applied": True,
    }
