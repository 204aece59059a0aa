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

Port copy of `inferno_tpu/parallel/snapshot.py`, numpy only: `update`,
`rows`, `meta` and `columns` verbatim apart from the imports. The
incremental dirty scan (`scan_update`, `scan_event_update` and their
state) belongs to the incremental-cycle slice of the port and is left
out until then.
"""

from __future__ import annotations

import itertools

import numpy as np

from inferno_tpu_torch.config.defaults import MAX_QUEUE_TO_BATCH_RATIO

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

    # -- structural layer ---------------------------------------------------

    def _derive_server(self, system, name: str, server, acc_rank: dict) -> None:
        """Re-derive one server's static lane fragments. Mirrors the
        eligibility rules of parallel.fleet._eligible_lanes and the static
        halves of build_fleet/build_tandem_fleet — keep them in lockstep
        (the parity suite compares the resulting plans lane by lane)."""
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

    def reset(self) -> None:
        self.__init__()
