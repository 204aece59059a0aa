"""Incremental columnar fleet snapshot (struct-of-arrays lane table).

The legacy packing path (`parallel.fleet._eligible_lanes` +
`build_fleet`/`build_tandem_fleet`) walks every (server, slice-shape)
pair as Python objects each cycle, appends ~14 scalar columns per lane,
and keys its plan memo on a tuple-of-tuples of the full column content —
O(lanes x fields) Python per cycle even when nothing changed. At 10k
variants that walk, not the jitted solve, dominates the sizing pass.

`FleetSnapshot` replaces it with a persistent lane table updated by
per-variant deltas:

* **structure** (which lanes exist and their rate-independent columns:
  profile parms, SLO targets, cost, batch-cap statics) is keyed by a
  cheap per-server signature — model profile content, service-class
  target, pinning, replica bounds. Only servers whose signature changed
  re-derive their lane rows; unchanged servers keep their fragments.
* **load** (arrival rate, token mix) is applied to the whole table
  VECTORIZED each cycle: the batch rescale, eligibility mask (zero /
  negative load, non-positive service time), and the load-dependent
  FleetParams/TandemParams columns are numpy expressions over the packed
  arrays, never a per-lane Python loop.
* the plan memo key is a **version counter** bumped on any structural or
  load change — the memo check itself is O(1) per cycle, and an
  unchanged fleet replays the previous cycle's plan OBJECT (so the
  downstream solve memo's identity check keeps holding).

Eligibility and column semantics MUST stay bit-identical to the legacy
walk — tests/test_vectorized_sizing.py pins snapshot-on vs snapshot-off
plans and scalar<->vectorized allocations across the edge lanes
(zero-load, infeasible, pinned, tandem, `only=` subsets).

Port copy of `inferno_tpu/parallel/snapshot.py`, numpy only, verbatim
apart from its imports and one fix: the columnar table, and the
incremental dirty scan (`scan_update`, `scan_event_update`) with its
state. The fix is in `scan_update`'s identity-witness path (fleets above
SCAN_FULL_SIG_LIMIT), which edited the token anchors in place; after any
earlier scan those are the arrays of the applied load, so a token-mix
change on a replaced server was classified FULL but solved on the old
token columns.
"""

from __future__ import annotations

import itertools
from operator import attrgetter

import numpy as np

from inferno_tpu_torch.config.defaults import (
    MAX_QUEUE_TO_BATCH_RATIO,
    env_int,
    rate_within_tolerance,
)

# -- incremental dirty-scan codes ----------------------------------
# Per-server verdicts of `FleetSnapshot.scan_update`, ordered by how much
# of the cycle the server must re-run:
#   CLEAN — replay everything (results, writeback, allocation);
#   VALUE — only the current allocation changed: transition penalties and
#           the per-server argmin re-run, sizing results replay;
#   RATE  — only the arrival rate changed (beyond tolerance): the cached
#           rate-independent bisection replays and the cheap refold kernel
#           re-derives replicas/cost/operating point;
#   FULL  — structure changed (profiles, SLOs via sig, token mix,
#           eligibility flips): the full sizing kernel re-runs these lanes.
SCAN_CLEAN, SCAN_VALUE, SCAN_RATE, SCAN_FULL = 0, 1, 2, 3

# Above this many servers the per-cycle scan switches from full
# value-signature fidelity to identity witnesses + a rotating deep
# verification (see scan_update's docstring for the exact contract).
SCAN_FULL_SIG_LIMIT = env_int("INCREMENTAL_FULL_SIG_LIMIT", 4096)
# Rotating-verification window: at identity-witness scale every server's
# value signature is re-verified once per this many cycles.
SCAN_VERIFY_CYCLES = max(env_int("INCREMENTAL_VERIFY_CYCLES", 64), 1)

_GET_LOAD = attrgetter("load")
_GET_ARRIVAL = attrgetter("arrival_rate")
_GET_IN = attrgetter("avg_in_tokens")
_GET_OUT = attrgetter("avg_out_tokens")
_GET_CUR = attrgetter("cur_allocation")


class _ScanState:
    """Cross-cycle state of the incremental dirty scan: anchors (the
    inputs each server's lanes were last SOLVED with), identity
    witnesses, and the rotating-verification cursor."""

    __slots__ = (
        "cap_fp", "class_wit", "class_fp",
        "arrival", "in_tok", "out_tok", "normal",
        "cur_vals", "cur_objs", "server_objs", "model_objs", "model_names",
        "streak", "cursor",
    )

# structural static columns shared by both lane kinds ("acc_rank" is the
# lane accelerator's position in the sorted catalog — the deterministic
# tie-break axis of the vectorized candidate argmin, not a solver input;
# "chips_per_replica" feeds the capacity-constrained solver's per-pool
# chip demand, slices_per_replica x slice.chips)
_SHARED_STATIC = (
    "alpha", "beta", "gamma", "delta",
    "target_ttft", "target_itl", "target_tps",
    "min_replicas", "cost_per_replica",
    "perf_max_batch", "at_tokens", "server_max_batch", "acc_rank",
    "chips_per_replica",
)
# tandem-only statics (disagg unit shape; validity of the spec itself)
_TAN_STATIC = ("dg_prefill_max_batch", "prefill_slices", "decode_slices")


class _Kind:
    """Packed static columns for one lane kind ("agg" or "tan")."""

    def __init__(self, fields: tuple[str, ...]):
        self.fields = fields
        self.frags: dict[str, dict[str, list]] = {}  # server -> field -> list
        self.lane_frags: dict[str, list[tuple[str, str]]] = {}
        self.cols: dict[str, np.ndarray] = {}
        self.lanes: list[tuple[str, str]] = []  # all static lanes, unmasked
        self.rows_per_server: np.ndarray = np.zeros(0, np.int64)
        self.lane_server: np.ndarray = np.zeros(0, np.int64)  # row -> server idx
        self.row_starts: np.ndarray = np.zeros(1, np.int64)
        # load-dependent state of the last update; mask=None marks the
        # masked-lane cache void (fresh table or just-repacked structure)
        self.dyn: dict[str, np.ndarray] = {}
        self.mask: np.ndarray | None = None
        self.masked_lanes: list[tuple[str, str]] = []
        self.row_index: np.ndarray = np.zeros(0, np.int64)  # masked row ids

    def repack(self, names: list[str]) -> None:
        empty: dict[str, list] = {f: [] for f in self.fields}
        self.cols = {
            f: np.asarray(
                list(itertools.chain.from_iterable(
                    self.frags.get(n, empty)[f] for n in names
                )),
                np.float64,
            )
            for f in self.fields
        }
        self.lanes = list(itertools.chain.from_iterable(
            self.lane_frags.get(n, ()) for n in names
        ))
        self.rows_per_server = np.asarray(
            [len(self.lane_frags.get(n, ())) for n in names], np.int64
        )
        self.lane_server = np.repeat(
            np.arange(len(names), dtype=np.int64), self.rows_per_server
        )
        # per-server row extents (server i owns rows
        # [row_starts[i], row_starts[i+1])) — the event-dirty sparse
        # update indexes lane rows by position through this
        self.row_starts = np.concatenate(
            ([0], np.cumsum(self.rows_per_server))
        )
        # the lane list just changed; an equal-CONTENT mask from the
        # previous structure must not keep its masked_lanes (two fleets
        # with different acc orders can share a mask bit-for-bit)
        self.mask = None

    def expand(self, per_server: np.ndarray) -> np.ndarray:
        """Broadcast a per-server value to this kind's lane rows."""
        return np.repeat(per_server, self.rows_per_server)

    def set_mask(self, mask: np.ndarray) -> None:
        if (
            self.mask is None
            or self.mask.shape != mask.shape
            or not np.array_equal(self.mask, mask)
        ):
            self.mask = mask
            self.row_index = np.flatnonzero(mask)
            self.masked_lanes = (
                list(itertools.compress(self.lanes, mask)) if len(mask) else []
            )


def _model_fp(model) -> tuple | None:
    """Content fingerprint of the profile fields the lane walk consumes.
    DecodeParms/PrefillParms are frozen dataclasses (cheap value
    equality); DisaggSpec compares by field equality."""
    if model is None:
        return None
    return tuple(
        (acc, p.slices_per_replica, p.max_batch_size, p.at_tokens,
         p.decode_parms, p.prefill_parms, p.disagg)
        for acc, p in model.perf_data.items()
    )


def _structure_sig(system, server) -> tuple:
    """Everything a server's static lane rows depend on, EXCEPT load
    (load is applied vectorized). A changed signature re-derives only
    this server's fragments."""
    model = system.models.get(server.model_name)
    svc = system.service_classes.get(server.service_class_name)
    target = svc.target_for(server.model_name) if svc else None
    pin = (
        server.cur_allocation.accelerator
        if server.keep_accelerator and server.cur_allocation.accelerator
        else ""
    )
    return (
        server.model_name,
        server.service_class_name,
        server.min_num_replicas,
        server.max_batch_size,
        pin,
        _model_fp(model),
        None if target is None else (target.slo_ttft, target.slo_itl, target.slo_tps),
    )


class FleetSnapshot:
    """The incremental lane table; one module-level instance serves every
    cycle (parallel.fleet owns it and routes build_fleet through it)."""

    def __init__(self):
        self._global_fp: tuple | None = None
        self._names: list[str] = []
        self._sigs: dict[str, tuple] = {}
        self._agg = _Kind(_SHARED_STATIC)
        self._tan = _Kind(_SHARED_STATIC + _TAN_STATIC)
        self._load: dict[str, np.ndarray] = {}
        self.version = 0  # bumps on ANY content change: the O(1) memo key
        # bumps only when the STATIC table is repacked (lane rows added,
        # removed, or renumbered) — the incremental fleet state
        # (parallel/incremental.py) keys its static-row-aligned result
        # tables on this and remaps them across repacks
        self.structure_version = 0
        # incremental dirty-scan state + last verdicts (scan_update)
        self._scan: _ScanState | None = None
        self.scan_codes: np.ndarray | None = None
        self.scan_all_dirty = True
        # servers whose content the last scan actually READ (poll scan:
        # the whole fleet; event scan: just the dirty set) — the
        # event-reconcile bench's scanned-work axis
        self.scan_scanned = 0
        # name -> position map, rebuilt lazily when _names is replaced
        # (identity-checked: scan-scale fleets reuse the same list)
        self._pos_map: dict[str, int] = {}
        self._pos_names: list[str] | None = None

    # -- structural layer ---------------------------------------------------

    def _derive_server(self, system, name: str, server, acc_rank: dict) -> None:
        """Re-derive one server's static lane fragments. Mirrors the
        eligibility rules of parallel.fleet._eligible_lanes and the two
        builders' static halves — keep them in lockstep (the parity
        suite compares the resulting plans lane by lane)."""
        for kind in (self._agg, self._tan):
            kind.frags[name] = {f: [] for f in kind.fields}
            kind.lane_frags[name] = []
        model = system.models.get(server.model_name)
        svc = system.service_classes.get(server.service_class_name)
        if model is None or svc is None:
            return
        target = svc.target_for(server.model_name)
        if target is None:
            return
        min_replicas = max(server.min_num_replicas, 0)
        for acc in server.candidate_accelerators(system).values():
            perf = model.perf_data.get(acc.name)
            if perf is None:
                continue
            if perf.disagg is not None:
                kind = self._tan
                try:
                    perf.disagg.validate()
                except ValueError:
                    continue
            else:
                kind = self._agg
            frag = kind.frags[name]
            frag["alpha"].append(perf.decode_parms.alpha)
            frag["beta"].append(perf.decode_parms.beta)
            frag["gamma"].append(perf.prefill_parms.gamma)
            frag["delta"].append(perf.prefill_parms.delta)
            frag["target_ttft"].append(target.slo_ttft)
            frag["target_itl"].append(target.slo_itl)
            frag["target_tps"].append(target.slo_tps)
            frag["min_replicas"].append(min_replicas)
            frag["cost_per_replica"].append(
                acc.cost * model.slices_per_replica(acc.name)
            )
            frag["perf_max_batch"].append(perf.max_batch_size)
            frag["at_tokens"].append(perf.at_tokens)
            frag["server_max_batch"].append(server.max_batch_size)
            frag["acc_rank"].append(acc_rank[acc.name])
            frag["chips_per_replica"].append(
                model.slices_per_replica(acc.name) * acc.chips
            )
            if kind is self._tan:
                dg = perf.disagg
                frag["dg_prefill_max_batch"].append(dg.prefill_max_batch)
                frag["prefill_slices"].append(float(dg.prefill_slices))
                frag["decode_slices"].append(float(dg.decode_slices))
            kind.lane_frags[name].append((name, acc.name))

    def _global_fingerprint(self, system) -> tuple:
        # catalog membership/order/cost and class targets are consumed by
        # every server's walk; model profiles are fingerprinted
        # per-server (so a corrected model re-derives only its servers).
        # pool/chips/region ride along because the chips_per_replica
        # column (the capacity solver's demand axis) depends on them
        return (
            tuple(
                (a.name, a.cost, a.pool, a.chips, a.region)
                for a in system.accelerators.values()
            ),
            tuple(
                (s.name, tuple(
                    (t.model, t.slo_ttft, t.slo_itl, t.slo_tps)
                    for t in s.spec.model_targets
                ))
                for s in system.service_classes.values()
            ),
        )

    # -- load layer ---------------------------------------------------------

    def _gather_load(self, servers: list) -> dict[str, np.ndarray]:
        n = len(servers)
        arrival = np.full(n, np.nan, np.float64)
        in_tok = np.zeros(n, np.float64)
        out_tok = np.zeros(n, np.float64)
        for i, server in enumerate(servers):
            load = server.load
            if load is None:
                continue  # NaN arrival marks "no load" (excluded)
            arrival[i] = load.arrival_rate
            in_tok[i] = load.avg_in_tokens
            out_tok[i] = load.avg_out_tokens
        # the walk sizes a lane only for positive load with sane token
        # stats; zero load (closed-form shortcut) and negative/missing
        # stats never enter the table
        normal = (
            ~np.isnan(arrival) & (arrival > 0)
            & (in_tok >= 0) & (out_tok > 0)
        )
        return {
            "arrival": arrival, "in": in_tok, "out": out_tok, "normal": normal,
        }

    def _apply_load(self, load: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        """Vectorized equivalents of the load-dependent halves of
        build_fleet/build_tandem_fleet; returns the dynamic columns and
        eligibility masks for both kinds."""
        out: dict[str, np.ndarray] = {}
        with np.errstate(divide="ignore", invalid="ignore"):
            for prefix, kind in (("agg", self._agg), ("tan", self._tan)):
                arr = kind.expand(load["arrival"])
                itk = kind.expand(load["in"])
                otk = kind.expand(load["out"])
                normal = kind.expand(load["normal"])
                c = kind.cols
                # batch rescale (core/allocation.py:117-121): floor
                # division of the profile cap by the output length
                batch = np.where(
                    c["server_max_batch"] > 0,
                    c["server_max_batch"],
                    np.maximum(
                        np.floor(c["perf_max_batch"] * c["at_tokens"] / otk), 1.0
                    ),
                )
                batch = np.where(normal, batch, 1.0)  # keep masked rows finite
                out[f"{prefix}_in"] = np.where(normal, itk, 0.0)
                out[f"{prefix}_out"] = np.where(normal, otk, 1.0)
                out[f"{prefix}_rate"] = np.where(normal, arr, 0.0) / 60.0
                out[f"{prefix}_batch"] = batch
                if kind is self._agg:
                    # non-positive service time => the scalar analyzer
                    # raises and the pair is rejected (build_fleet)
                    nd = out[f"{prefix}_out"] - 1.0
                    nd = np.where(
                        (out[f"{prefix}_in"] == 0) & (out[f"{prefix}_out"] == 1.0),
                        1.0, nd,
                    )
                    t1 = nd * (c["alpha"] + c["beta"])
                    t1 = t1 + np.where(
                        out[f"{prefix}_in"] > 0,
                        c["gamma"] + c["delta"] * out[f"{prefix}_in"],
                        0.0,
                    )
                    out["agg_mask"] = normal & (t1 > 0)
                    out["agg_cap"] = batch * (1 + MAX_QUEUE_TO_BATCH_RATIO)
                else:
                    # tandem rejects lanes the scalar disagg analyzer
                    # rejects: no prefill stage or non-positive stage time
                    p_batch = np.where(
                        c["dg_prefill_max_batch"] > 0,
                        c["dg_prefill_max_batch"], batch,
                    )
                    max_queue = batch * MAX_QUEUE_TO_BATCH_RATIO
                    nd = np.maximum(out[f"{prefix}_out"] - 1.0, 1.0)
                    p_lo = c["gamma"] + c["delta"] * out[f"{prefix}_in"]
                    p_hi = c["gamma"] + c["delta"] * out[f"{prefix}_in"] * p_batch
                    d_lo = c["alpha"] + c["beta"]
                    d_hi = c["alpha"] + c["beta"] * batch
                    out["tan_mask"] = (
                        normal
                        & (out[f"{prefix}_in"] > 0)
                        & (np.minimum(p_lo, p_hi) > 0)
                        & (nd * np.minimum(d_lo, d_hi) > 0)
                    )
                    out["tan_p_batch"] = p_batch
                    out["tan_p_cap"] = p_batch + max_queue
                    out["tan_d_cap"] = batch + max_queue
        return out

    # -- the per-cycle entry point ------------------------------------------

    def update(self, system) -> int:
        """Reconcile the table with `system`; returns the content version
        (unchanged fleet => unchanged version => plan replay)."""
        names = list(system.servers.keys())
        servers = list(system.servers.values())
        global_fp = self._global_fingerprint(system)
        if global_fp != self._global_fp:
            # catalog/class change: every cached signature is void
            self._sigs.clear()
        # a changed name list (variant added/removed/reordered) only
        # forces a repack — unchanged servers keep their fragments
        structural = global_fp != self._global_fp or names != self._names
        changed = []
        sigs = self._sigs
        for name, server in zip(names, servers):
            sig = _structure_sig(system, server)
            if sigs.get(name) != sig:
                sigs[name] = sig
                changed.append((name, server))
        if changed or structural:
            acc_rank = {n: i for i, n in enumerate(sorted(system.accelerators))}
            for name, server in changed:
                self._derive_server(system, name, server, acc_rank)
            for stale in sorted(set(self._agg.frags) - set(names)):
                for kind in (self._agg, self._tan):
                    kind.frags.pop(stale, None)
                    kind.lane_frags.pop(stale, None)
                sigs.pop(stale, None)
            self._agg.repack(names)
            self._tan.repack(names)
            self._global_fp = global_fp
            self._names = names
            self._load = {}  # force the dynamic layer to re-apply
            self.version += 1
            self.structure_version += 1

        load = self._gather_load(servers)
        same_load = bool(self._load) and all(
            np.array_equal(load[k], self._load[k], equal_nan=True)
            for k in ("arrival", "in", "out")
        )
        if not same_load:
            dyn = self._apply_load(load)
            for kind, prefix in ((self._agg, "agg"), (self._tan, "tan")):
                kind.set_mask(dyn[f"{prefix}_mask"])
                kind.dyn = dyn
            self._load = load
            self.version += 1
        return self.version

    # -- plan assembly (consumed by parallel.fleet) -------------------------

    def rows(self, kind_name: str, only: set[str] | None):
        """(row_index, lanes) of the eligible lanes, optionally restricted
        to the `only` server subset (in table order, like the walk)."""
        kind = self._agg if kind_name == "agg" else self._tan
        if only is None:
            return kind.row_index, kind.masked_lanes
        starts = np.zeros(len(self._names) + 1, np.int64)
        np.cumsum(kind.rows_per_server, out=starts[1:])
        picks = [
            np.arange(starts[i], starts[i + 1])
            for i, n in enumerate(self._names)
            if n in only
        ]
        rows = (
            np.concatenate(picks) if picks else np.zeros(0, np.int64)
        )
        rows = rows[kind.mask[rows]] if len(rows) else rows
        return rows, [kind.lanes[i] for i in rows]

    def meta(
        self, kind_name: str, rows: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(server_idx, acc_rank, chips_per_replica) for the selected
        rows: server_idx maps each lane to its position in the system's
        server order, acc_rank is the lane accelerator's sorted-catalog
        rank, chips_per_replica its whole-slice chip demand — the inputs
        of the vectorized per-server candidate argmin and the
        capacity-constrained solver in parallel.fleet."""
        kind = self._agg if kind_name == "agg" else self._tan
        return (
            kind.lane_server[rows],
            kind.cols["acc_rank"][rows].astype(np.int64),
            kind.cols["chips_per_replica"][rows].astype(np.int64),
        )

    def columns(self, kind_name: str, rows: np.ndarray) -> dict[str, np.ndarray]:
        """FleetParams/TandemParams column dict for the selected rows,
        cast to the packed dtypes (f32 floats, i32 ints) exactly like
        parallel.fleet._pack does from Python lists."""
        kind = self._agg if kind_name == "agg" else self._tan
        c, d = kind.cols, kind.dyn
        p = kind_name

        def f32(a):
            return a[rows].astype(np.float32)

        def i32(a):
            return a[rows].astype(np.int32)

        cols = {
            "alpha": f32(c["alpha"]), "beta": f32(c["beta"]),
            "gamma": f32(c["gamma"]), "delta": f32(c["delta"]),
            "in_tokens": f32(d[f"{p}_in"]), "out_tokens": f32(d[f"{p}_out"]),
            "target_ttft": f32(c["target_ttft"]),
            "target_itl": f32(c["target_itl"]),
            "target_tps": f32(c["target_tps"]),
            "total_rate": f32(d[f"{p}_rate"]),
            "min_replicas": i32(c["min_replicas"]),
            "cost_per_replica": f32(c["cost_per_replica"]),
        }
        if kind_name == "agg":
            cols["max_batch"] = i32(d["agg_batch"])
            cols["occupancy_cap"] = i32(d["agg_cap"])
        else:
            cols["prefill_batch"] = i32(d["tan_p_batch"])
            cols["decode_batch"] = i32(d["tan_batch"])
            cols["prefill_cap"] = i32(d["tan_p_cap"])
            cols["decode_cap"] = i32(d["tan_d_cap"])
            cols["prefill_slices"] = f32(c["prefill_slices"])
            cols["decode_slices"] = f32(c["decode_slices"])
        return cols

    def rows_for_positions(self, kind_name: str, pos: np.ndarray) -> np.ndarray:
        """Row ids of the eligible (masked) lanes belonging to the server
        POSITIONS in `pos` — the vectorized equivalent of
        `rows(kind, only=names)` keyed by position instead of name (the
        incremental path works in positions and static rows throughout)."""
        kind = self._agg if kind_name == "agg" else self._tan
        if not len(kind.lane_server):
            return np.zeros(0, np.int64)
        m = np.zeros(len(self._names), bool)
        m[pos] = True
        rowmask = m[kind.lane_server]
        if kind.mask is not None:
            rowmask &= kind.mask
        return np.flatnonzero(rowmask)

    def kind_table(self, kind_name: str) -> _Kind:
        """The packed static table of one lane kind — the incremental
        fleet state reads its layout (rows_per_server, lane_server,
        lanes) and static columns directly."""
        return self._agg if kind_name == "agg" else self._tan

    # -- incremental dirty scan ----------------------------------

    def _cap_fp(self, system) -> tuple:
        """Cheap every-cycle global fingerprint of the incremental path:
        the catalog (incl. spot eligibility) plus capacity/quota/spot
        state. Any change ⇒ all-dirty — capacity and quota do not feed
        the sizing table, but they ARE the capacity solver's context,
        and the spot tier changes candidate costs outright."""
        return (
            tuple(
                (a.name, a.cost, a.pool, a.chips, a.region,
                 a.spec.spot_eligible)
                for a in system.accelerators.values()
            ),
            tuple(sorted(system.capacity.items())),
            tuple(sorted(getattr(system, "quotas", {}).items())),
            tuple(sorted(getattr(system, "spot", {}).items())),
        )

    def _class_fp(self, system) -> tuple:
        return tuple(
            (s.name, tuple(
                (t.model, t.slo_ttft, t.slo_itl, t.slo_tps)
                for t in s.spec.model_targets
            ))
            for s in system.service_classes.values()
        )

    def _gather_scan_arrays(self, servers: list, tokens: bool = True):
        """(arrival, in_tok, out_tok, normal, have_tokens) as f64/bool
        arrays; NaN arrival marks a load-less server. With
        `tokens=False` (the identity-witness fast path) the token
        columns come back None and the caller keeps its anchors — token
        edits are then caught by the rotating sweep, like every other
        in-place scalar change at that scale."""
        n = len(servers)
        loads = list(map(_GET_LOAD, servers))
        try:
            # C-speed gather; raises AttributeError iff some server has
            # no load at all — probing for None up front would cost a
            # full dataclass-__eq__ sweep per cycle
            arrival = np.fromiter(map(_GET_ARRIVAL, loads), np.float64, count=n)
            if not tokens:
                return arrival, None, None, None, False
            in_tok = np.fromiter(map(_GET_IN, loads), np.float64, count=n)
            out_tok = np.fromiter(map(_GET_OUT, loads), np.float64, count=n)
        except AttributeError:
            arrival = np.asarray(
                [np.nan if l is None else l.arrival_rate for l in loads],
                np.float64,
            )
            in_tok = np.asarray(
                [0.0 if l is None else l.avg_in_tokens for l in loads], np.float64
            )
            out_tok = np.asarray(
                [0.0 if l is None else l.avg_out_tokens for l in loads], np.float64
            )
        normal = (
            ~np.isnan(arrival) & (arrival > 0) & (in_tok >= 0) & (out_tok > 0)
        )
        return arrival, in_tok, out_tok, normal, True

    def _fresh_scan_state(self, system, names, servers, cap_fp, class_fp) -> None:
        st = _ScanState()
        st.cap_fp = cap_fp
        st.class_wit = tuple(system.service_classes.values())
        st.class_fp = class_fp if class_fp is not None else self._class_fp(system)
        st.arrival, st.in_tok, st.out_tok, st.normal, _ = (
            self._gather_scan_arrays(servers)
        )
        st.server_objs = servers
        st.model_names = [s.model_name for s in servers]
        st.model_objs = list(map(system.models.get, st.model_names))
        st.cur_objs = list(map(_GET_CUR, servers))
        st.cur_vals = [
            (c.accelerator, c.cost, c.num_replicas) for c in st.cur_objs
        ]
        st.streak = np.zeros(len(names), np.int64)
        st.cursor = 0
        self._scan = st

    def scan_update(
        self,
        system,
        lam_tolerance: float = 0.0,
        max_age_cycles: int = 0,
    ) -> int:
        """Reconcile the table with `system` AND classify every server
        into a dirty tier (`self.scan_codes`, values `SCAN_*`): the
        incremental cycle's detection pass (parallel/incremental.py).

        Semantics vs `update()`:

        * detection verdicts come from the same content comparisons —
          a changed structure signature, token mix, or eligibility flip
          is FULL; an arrival-rate move beyond `lam_tolerance` (relative,
          the shared `config.defaults.rate_within_tolerance` predicate)
          is RATE; a changed current allocation is VALUE.
        * λ within tolerance stays ANCHORED: the table keeps the rate the
          lanes were last solved with (exactly the sizing cache's hit
          semantics), so sub-tolerance scrape jitter re-solves nothing.
          Tolerance 0 (the default) anchors nothing — merged loads equal
          observed loads and verdicts are exact.
        * with `max_age_cycles` > 0 a server that drifts inside the
          tolerance for that many consecutive cycles is re-anchored via
          one RATE re-solve (mirrors SizingCache.max_age_cycles; an
          identical λ never expires — re-solving identical inputs cannot
          change a decision, so decisions never drift between the two
          layers, pinned in tests).

        Fidelity contract: up to INCREMENTAL_FULL_SIG_LIMIT servers
        (default 4096 — every test fleet, and any reconciler-scale
        fleet), structure signatures and current allocations are
        re-verified by VALUE every cycle, exactly like `update()`.
        Above it, the per-cycle check is identity witnesses (server,
        model, and current-allocation OBJECTS — every supported mutation
        path replaces objects: fresh Systems, dataclasses.replace'd
        parms, allocation_from_data) plus a rotating deep verification
        that re-checks every server's value signature once per
        INCREMENTAL_VERIFY_CYCLES cycles, bounding the staleness of an
        in-place scalar edit that never replaced an object. On any
        doubt — unseen fleet, renamed servers, catalog/class/capacity/
        quota/spot fingerprint change — the verdict is all-dirty.
        """
        names = list(system.servers.keys())
        servers = list(system.servers.values())
        n = len(names)
        st = self._scan

        cap_fp = self._cap_fp(system)
        class_fp = None
        global_changed = st is None or names != self._names or cap_fp != st.cap_fp
        if not global_changed and tuple(system.service_classes.values()) != st.class_wit:
            class_fp = self._class_fp(system)
            global_changed = class_fp != st.class_fp
        if global_changed:
            version = self.update(system)
            self._fresh_scan_state(system, names, servers, cap_fp, class_fp)
            self.scan_codes = np.full(n, SCAN_FULL, np.int8)
            self.scan_all_dirty = True
            self.scan_scanned = n
            return version
        st.cap_fp = cap_fp
        if class_fp is not None:  # rebuilt-but-equal classes: refresh witness
            st.class_wit = tuple(system.service_classes.values())
            st.class_fp = class_fp

        codes = np.zeros(n, np.int8)
        large = n > SCAN_FULL_SIG_LIMIT

        # -- load tier: λ value-compared every cycle, vectorized; token
        # mix every cycle up to the fidelity limit, rotating above it ----
        arrival, in_tok, out_tok, normal, have_tokens = (
            self._gather_scan_arrays(servers, tokens=not large)
        )
        if not have_tokens:
            # copies: the verification below edits them in place, and the
            # anchors are the very arrays of the last applied load — an
            # in-place edit would make the load compare equal to itself
            # and leave the lane columns on the old token mix
            in_tok, out_tok = st.in_tok.copy(), st.out_tok.copy()
            normal = (
                ~np.isnan(arrival) & (arrival > 0)
                & (in_tok >= 0) & (out_tok > 0)
            )
            tok_changed = np.zeros(n, bool)
        else:
            tok_changed = ~(
                ((in_tok == st.in_tok) | (np.isnan(in_tok) & np.isnan(st.in_tok)))
                & ((out_tok == st.out_tok)
                   | (np.isnan(out_tok) & np.isnan(st.out_tok)))
            )
        elig_flip = normal != st.normal
        both = ~np.isnan(arrival) & ~np.isnan(st.arrival)
        nan_flip = np.isnan(arrival) != np.isnan(st.arrival)
        if lam_tolerance > 0.0:
            # the SHARED tolerance predicate, vectorized
            # (config.defaults.rate_within_tolerance)
            rate_moved = both & (
                np.abs(arrival - st.arrival)
                > lam_tolerance * np.maximum(st.arrival, 0.0)
            )
        else:
            rate_moved = both & (arrival != st.arrival)
        codes[rate_moved & normal & st.normal] = SCAN_RATE
        # zero/zero-load/no-load transitions change the eligible lane set
        # (or route through the closed-form shortcut): full tier
        full_load = tok_changed | elig_flip | nan_flip | (
            rate_moved & ~(normal & st.normal)
        )
        codes[full_load] = SCAN_FULL
        if lam_tolerance > 0.0 and max_age_cycles > 0:
            drifting = both & ~rate_moved & (arrival != st.arrival)
            st.streak[drifting] += 1
            st.streak[~drifting] = 0
            expired = drifting & (st.streak >= max_age_cycles) & normal & st.normal
            codes[expired & (codes == SCAN_CLEAN)] = SCAN_RATE
            st.streak[expired] = 0

        # -- structure + current-allocation tier ----------------------------
        sigs = self._sigs
        changed: list[tuple[str, object]] = []
        if not large:
            # full value fidelity: the exact per-server comparisons
            # update() makes, plus the cur-allocation value triple
            for i, (name, server) in enumerate(zip(names, servers)):
                sig = _structure_sig(system, server)
                if sigs.get(name) != sig:
                    sigs[name] = sig
                    changed.append((name, server))
                    codes[i] = SCAN_FULL
                cur = server.cur_allocation
                cv = (cur.accelerator, cur.cost, cur.num_replicas)
                if cv != st.cur_vals[i]:
                    st.cur_vals[i] = cv
                    if codes[i] == SCAN_CLEAN:
                        codes[i] = SCAN_VALUE
            st.cur_objs = list(map(_GET_CUR, servers))
            st.server_objs = servers
            st.model_names = [s.model_name for s in servers]
            st.model_objs = list(map(system.models.get, st.model_names))
        else:
            # identity witnesses + rotating deep verification. The model
            # lookup uses the CACHED name list (a C-level map): an
            # in-place rename of server.model_name on the same server
            # object is caught by the rotating sweep like any other
            # in-place scalar edit; a server REPLACEMENT refreshes its
            # name below.
            suspects = set()
            if servers != st.server_objs:
                st.model_names = [s.model_name for s in servers]
                suspects.update(
                    i for i, (a, b) in enumerate(zip(servers, st.server_objs))
                    if a is not b
                )
            model_objs = list(map(system.models.get, st.model_names))
            cur_objs = list(map(_GET_CUR, servers))
            if model_objs != st.model_objs:
                suspects.update(
                    i for i, (a, b) in enumerate(zip(model_objs, st.model_objs))
                    if a is not b
                )
            cur_suspects = set()
            if cur_objs != st.cur_objs:
                cur_suspects.update(
                    i for i, (a, b) in enumerate(zip(cur_objs, st.cur_objs))
                    if a is not b
                )
            # rotating slice: full value re-verification of 1/window of
            # the fleet per cycle. The slice WRAPS — truncating at n while
            # advancing the cursor mod n would skip the wrapped remainder
            # and let low-index servers starve for thousands of cycles
            # (caught in review); with the wrap covered, every server is
            # re-verified within SCAN_VERIFY_CYCLES cycles.
            step = -(-n // SCAN_VERIFY_CYCLES)
            lo = st.cursor % n
            hi = lo + step
            if hi <= n:
                rot = range(lo, hi)
            else:
                rot = itertools.chain(range(lo, n), range(0, hi - n))
            st.cursor = hi % n
            rot = list(rot)
            for i in itertools.chain(suspects, rot):
                name, server = names[i], servers[i]
                sig = _structure_sig(system, server)
                if sigs.get(name) != sig:
                    sigs[name] = sig
                    changed.append((name, server))
                    codes[i] = SCAN_FULL
                load = server.load
                if load is not None and (
                    load.avg_in_tokens != in_tok[i]
                    or load.avg_out_tokens != out_tok[i]
                ):
                    # token mix edited in place since last verification:
                    # full tier (batch rescale + grids depend on it)
                    in_tok[i] = load.avg_in_tokens
                    out_tok[i] = load.avg_out_tokens
                    normal[i] = (
                        not np.isnan(arrival[i]) and arrival[i] > 0
                        and in_tok[i] >= 0 and out_tok[i] > 0
                    )
                    codes[i] = SCAN_FULL
            for i in itertools.chain(cur_suspects, rot):
                cur = servers[i].cur_allocation
                cv = (cur.accelerator, cur.cost, cur.num_replicas)
                if cv != st.cur_vals[i]:
                    st.cur_vals[i] = cv
                    if codes[i] == SCAN_CLEAN:
                        codes[i] = SCAN_VALUE
            st.server_objs = servers
            st.model_objs = model_objs
            st.cur_objs = cur_objs

        if changed:
            acc_rank = {nm: i for i, nm in enumerate(sorted(system.accelerators))}
            for name, server in changed:
                self._derive_server(system, name, server, acc_rank)
            self._agg.repack(names)
            self._tan.repack(names)
            self._load = {}
            self.version += 1
            self.structure_version += 1

        # -- merged (anchored) load apply -----------------------------------
        dirty_rate = codes >= SCAN_RATE
        merged = np.where(dirty_rate, arrival, st.arrival)
        st.arrival = merged
        st.in_tok, st.out_tok = in_tok, out_tok
        st.normal = np.where(dirty_rate, normal, st.normal)
        load = {
            "arrival": merged, "in": in_tok, "out": out_tok,
            "normal": (
                ~np.isnan(merged) & (merged > 0) & (in_tok >= 0) & (out_tok > 0)
            ),
        }
        same_load = bool(self._load) and all(
            np.array_equal(load[k], self._load[k], equal_nan=True)
            for k in ("arrival", "in", "out")
        )
        if not same_load:
            dyn = self._apply_load(load)
            for kind, prefix in ((self._agg, "agg"), (self._tan, "tan")):
                kind.set_mask(dyn[f"{prefix}_mask"])
                kind.dyn = dyn
            self._load = load
            self.version += 1

        self.scan_codes = codes
        self.scan_all_dirty = False
        self.scan_scanned = n
        return self.version

    def _position_index(self) -> dict[str, int]:
        if self._pos_names is not self._names:
            self._pos_map = {n: i for i, n in enumerate(self._names)}
            self._pos_names = self._names
        return self._pos_map

    def scan_event_update(
        self,
        system,
        dirty_names,
        lam_tolerance: float = 0.0,
    ) -> int:
        """Event-authoritative variant of `scan_update`: the
        caller asserts — on the authority of its event source (watch
        streams + grouped-collector λ deltas) — that ONLY the servers in
        `dirty_names` changed since the previous scan. The O(fleet)
        content diff is skipped: only the named servers are re-read, and
        the table's sole arrival-dependent dynamic column (the per-lane
        rate) is rewritten sparsely, O(dirty lanes).

        Decision-surface parity with the poll scan is exact by
        construction: the same per-server comparisons run (structure
        signature, token mix, eligibility, the shared λ-tolerance
        predicate, the current-allocation value triple), and the sparse
        rate write computes the identical f64 expression `arrival / 60`
        the vectorized `_apply_load` would. Anything this path cannot
        prove it can update sparsely FALLS BACK to a full `scan_update`
        (poll-equivalent, hence parity-safe):

        * no prior scan state / fleet size changed / unknown dirty name
          (membership changed under us),
        * catalog / capacity / quota / spot / service-class fingerprint
          moved (global context),
        * a dirty server's structure signature changed (lane set may
          repack),
        * token mix, eligibility, or load-presence changed (masks and
          batch rescale depend on them),
        * a λ move on a non-eligible server (the poll path classifies it
          FULL).

        The event source is trusted only for *which* servers changed —
        every claim about *what* changed is re-verified against the
        anchors, so a mislabeled event degrades to extra work, never to
        a wrong verdict. Drift from missed events (the one thing this
        path cannot see) is bounded by the caller's periodic anti-entropy
        full scan (EVENT_ANTI_ENTROPY_CYCLES).

        λ anchoring within `lam_tolerance` matches the poll scan; the
        `max_age_cycles` streak re-anchor is intentionally NOT advanced
        here (an event cycle re-reads only the dirty servers, so
        fleet-wide drift streaks would undercount) — age-based expiry
        happens on the anti-entropy pass.
        """
        st = self._scan
        n = len(self._names)
        if (
            st is None
            or not self._load
            or n == 0
            or len(system.servers) != n
        ):
            return self.scan_update(system, lam_tolerance)
        cap_fp = self._cap_fp(system)
        class_fp = None
        doubt = cap_fp != st.cap_fp
        if not doubt and tuple(system.service_classes.values()) != st.class_wit:
            class_fp = self._class_fp(system)
            doubt = class_fp != st.class_fp
        if doubt:
            return self.scan_update(system, lam_tolerance)
        st.cap_fp = cap_fp
        if class_fp is not None:
            st.class_wit = tuple(system.service_classes.values())
            st.class_fp = class_fp

        pos_map = self._position_index()
        servers_map = system.servers
        sigs = self._sigs
        # pass 1 — VALIDATE every dirty claim without mutating anchors:
        # a mid-loop fallback after partial anchor updates would make the
        # full scan classify already-anchored movers CLEAN while the lane
        # table still holds their old rate
        rate_upd: dict[int, float] = {}
        cur_upd: dict[int, tuple] = {}
        seen: dict[int, object] = {}
        for name in dirty_names:
            pos = pos_map.get(name)
            server = servers_map.get(name)
            if pos is None or server is None:
                return self.scan_update(system, lam_tolerance)
            if sigs.get(name) != _structure_sig(system, server):
                return self.scan_update(system, lam_tolerance)
            load = server.load
            if load is None:
                arrival_i, in_i, out_i = np.nan, 0.0, 0.0
            else:
                arrival_i = load.arrival_rate
                in_i = load.avg_in_tokens
                out_i = load.avg_out_tokens
            normal_i = (
                not np.isnan(arrival_i) and arrival_i > 0
                and in_i >= 0 and out_i > 0
            )
            tok_same = (
                (in_i == st.in_tok[pos]
                 or (np.isnan(in_i) and np.isnan(st.in_tok[pos])))
                and (out_i == st.out_tok[pos]
                     or (np.isnan(out_i) and np.isnan(st.out_tok[pos])))
            )
            if (
                not tok_same
                or normal_i != bool(st.normal[pos])
                or np.isnan(arrival_i) != np.isnan(st.arrival[pos])
            ):
                return self.scan_update(system, lam_tolerance)
            if not np.isnan(arrival_i):
                anchor = float(st.arrival[pos])
                if not rate_within_tolerance(anchor, arrival_i, lam_tolerance):
                    if not normal_i:
                        # poll classifies a non-eligible λ move FULL
                        return self.scan_update(system, lam_tolerance)
                    rate_upd[pos] = arrival_i
            cur = server.cur_allocation
            cv = (cur.accelerator, cur.cost, cur.num_replicas)
            if cv != st.cur_vals[pos]:
                cur_upd[pos] = cv
            seen[pos] = server

        # pass 2 — APPLY: anchors, witnesses, verdicts, sparse table write
        codes = np.zeros(n, np.int8)
        for pos, server in seen.items():
            st.server_objs[pos] = server
            st.model_names[pos] = server.model_name
            st.model_objs[pos] = system.models.get(server.model_name)
            st.cur_objs[pos] = server.cur_allocation
        for pos, cv in cur_upd.items():
            st.cur_vals[pos] = cv
            codes[pos] = SCAN_VALUE
        if rate_upd:
            pos_arr = np.asarray(sorted(rate_upd), np.int64)
            vals = np.asarray([rate_upd[p] for p in sorted(rate_upd)], np.float64)
            codes[pos_arr] = SCAN_RATE
            st.arrival[pos_arr] = vals
            arr_load = self._load["arrival"]
            if arr_load is not st.arrival:  # distinct since the last update()
                arr_load[pos_arr] = vals
            # the ONLY arrival-dependent dynamic column is the per-lane
            # rate (_apply_load: batch / tokens / masks depend on token
            # mix + eligibility, both proven unchanged above) — rewrite
            # just the dirty servers' rows. All selected servers are
            # eligible (normal), so every row gets arr/60 exactly as the
            # vectorized `np.where(normal, arr, 0) / 60` would.
            for kind, prefix in ((self._agg, "agg"), (self._tan, "tan")):
                if not len(kind.lane_server):
                    continue
                counts = kind.rows_per_server[pos_arr]
                total = int(counts.sum())
                if not total:
                    continue
                base = np.repeat(kind.row_starts[pos_arr], counts)
                offs = np.arange(total, dtype=np.int64) - np.repeat(
                    np.cumsum(counts) - counts, counts
                )
                kind.dyn[f"{prefix}_rate"][base + offs] = (
                    np.repeat(vals, counts) / 60.0
                )
            self.version += 1

        self.scan_codes = codes
        self.scan_all_dirty = False
        self.scan_scanned = len(seen)
        return self.version

    def reset(self) -> None:
        self.__init__()
