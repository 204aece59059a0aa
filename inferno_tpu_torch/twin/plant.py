"""Vectorized fleet twin: thousands of emulated engines in ONE event loop.

`TwinPlant` columnarizes emulated-engine state the way
`parallel/snapshot.py` columnarized the fleet: per-engine queues
(ring-buffer struct-of-arrays), in-flight batch slots, decode/prefill
phase timers, and KV occupancy all live in ``[engines]``- and
``[engines, max_batch]``-shaped numpy arrays, advanced by one vectorized
round loop on a shared virtual clock. Each round performs, for every
runnable engine simultaneously, exactly one `EmulatedEngine` decode
iteration: admission (reservation-based, head-of-line on KV), the step
cost ``alpha + beta·B + beta2·B² (+ delta·Σin_new, + gamma when the whole
batch is new)``, first-token stamps, and finish-step completions.

Parity contract: the arithmetic is ordered identically to the scalar
engine's (`EmulatedEngine._step_cost` / `_apply_step`), so a seeded
1-engine twin run is BIT-identical to the sync-stepped scalar oracle
(twin/oracle.py) — tests/test_twin.py pins this, and the scalar emulator
stays the semantic oracle.

Knobs (docs/user-guide/configuration.md): TWIN_CHUNK_EVENTS bounds how
many rounds run between active-set recompactions (results are invariant
to it — only the gather/scatter cadence changes), TWIN_BACKEND selects
where the step cost runs: `torch` (the default) on `device`, None being
the CUDA card, or `numpy` on the host.

Port of `inferno_tpu/twin/plant.py`, verbatim apart from its imports and
the step cost's backends. The reference's optional `jax` step cost
becomes the default `torch` one: the five profile columns go to the
device once, at construction; each round uploads only its engine index,
`bf`, `new_count`, `new_in_sum` and `batch`, evaluates the step cost in
float64 with one torch op per term in the numpy path's order (no fused
multiply-add can regroup the sum, so the result is bit-equal to numpy's),
and brings `step_ms` back. The rest of the plant (ring buffers,
admission, completions, the scatters) stays host numpy.
"""

from __future__ import annotations

import time
from collections.abc import Callable

import numpy as np
import torch

from inferno_tpu_torch.config.defaults import env_int, env_str
from inferno_tpu_torch.emulator.engine import EngineProfile
from inferno_tpu_torch.obs import profiler
from inferno_tpu_torch.parallel.mesh import fleet_device

# request lifecycle states in the columnar request table
QUEUED, RUNNING, DONE, REJECTED = 0, 1, 2, 3

BACKENDS = ("torch", "numpy")
# step-cost evaluations by backend (one per round); a caller zeroes them
# before a run and reads them after
STEP_COST_EVALS = {"torch": 0, "numpy": 0}


def resolve_backend(backend: str | None = None) -> str:
    """The step cost's backend: `backend`, else TWIN_BACKEND, else torch."""
    backend = backend or env_str("TWIN_BACKEND", "torch")
    if backend not in BACKENDS:
        raise ValueError(f"TWIN_BACKEND must be numpy|torch, got {backend!r}")
    return backend


def twin_device(device: str | torch.device | None = None) -> torch.device:
    """Where the torch step cost runs (`parallel.mesh.fleet_device`).
    `None` means the CUDA card and raises without one: the twin runs on
    the card unless the caller asks for the host (backend numpy) or the
    CPU (device 'cpu')."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device for the twin's step cost: pass backend='numpy' "
            "(--backend numpy) or device='cpu' (--device cpu)"
        )
    return fleet_device(device)


def _grow(arr: np.ndarray, n: int) -> np.ndarray:
    """Double-and-copy growth along axis 0 to at least n rows."""
    cap = max(len(arr) * 2, n, 16)
    out = np.zeros((cap,) + arr.shape[1:], dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


class TwinPlant:
    """E emulated engines advanced by one vectorized event loop.

    Arrivals are injected (in nondecreasing per-engine arrival order)
    with `inject` / `inject_bulk`, time advances with `advance_to`, and
    spot preemptions land through `preempt` (the spot injector
    contract: victims fail permanently, later traffic to a dead engine
    is refused). Results accumulate in the struct-of-arrays request
    table (`r_*`); `report` summarizes them.
    """

    def __init__(
        self,
        profile: EngineProfile | list[EngineProfile],
        engines: int | None = None,
        chunk_events: int | None = None,
        backend: str | None = None,
        device: str | torch.device | None = None,
        wall_clock: Callable[[], float] = time.perf_counter,
    ):
        profiles = (
            [profile] * int(engines)
            if isinstance(profile, EngineProfile)
            else list(profile)
        )
        if engines is not None and len(profiles) != engines:
            raise ValueError(
                f"got {len(profiles)} profiles for engines={engines}"
            )
        E = len(profiles)
        if E == 0:
            raise ValueError("TwinPlant needs at least one engine")
        self.engines = E
        self.chunk_events = (
            chunk_events
            if chunk_events is not None
            else env_int("TWIN_CHUNK_EVENTS", 256)
        )
        if self.chunk_events < 1:
            raise ValueError("TWIN_CHUNK_EVENTS must be >= 1")
        self.backend = resolve_backend(backend)
        self.device = (
            twin_device(device) if self.backend == "torch" else None
        )
        self._wall = wall_clock

        # -- per-engine profile columns ---------------------------------
        self.alpha = np.array([p.alpha for p in profiles], dtype=np.float64)
        self.beta = np.array([p.beta for p in profiles], dtype=np.float64)
        self.beta2 = np.array([p.beta2 for p in profiles], dtype=np.float64)
        self.gamma = np.array([p.gamma for p in profiles], dtype=np.float64)
        self.delta = np.array([p.delta for p in profiles], dtype=np.float64)
        self.max_batch = np.array(
            [p.max_batch for p in profiles], dtype=np.int64
        )
        self.kv_cap = np.array(
            [p.kv_tokens_capacity for p in profiles], dtype=np.int64
        )
        B = int(self.max_batch.max())
        if self.device is not None:
            # [5, E] on the device, rows in the order of _step_cost_vec's
            # unbind; gathered by engine index each round
            self._cols = torch.from_numpy(np.stack(
                [self.alpha, self.beta, self.beta2, self.gamma, self.delta]
            )).to(self.device)

        # -- per-engine dynamic state -----------------------------------
        self.clock = np.zeros(E, dtype=np.float64)  # emulated msec
        self.step_idx = np.zeros(E, dtype=np.int64)
        self.batch = np.zeros(E, dtype=np.int64)
        self.kv_res = np.zeros(E, dtype=np.int64)
        self.preempted = np.zeros(E, dtype=bool)
        self.preempted_requests = 0

        # -- in-flight batch slots [E, B] -------------------------------
        self.slot_used = np.zeros((E, B), dtype=bool)
        self.slot_req = np.full((E, B), -1, dtype=np.int64)
        self.slot_in = np.zeros((E, B), dtype=np.int64)
        self.slot_out = np.zeros((E, B), dtype=np.int64)
        self.slot_admit = np.zeros((E, B), dtype=np.int64)
        self.slot_finish = np.zeros((E, B), dtype=np.int64)
        # min slot_finish among used slots (sentinel: never reached);
        # keeps the per-round completion scan off engines with nothing
        # finishing this step
        self.next_fin = np.full(E, np.iinfo(np.int64).max, dtype=np.int64)

        # -- per-engine arrival queues: ring buffers [E, Q] -------------
        Q = 64
        self.q_arr = np.zeros((E, Q), dtype=np.float64)
        self.q_in = np.zeros((E, Q), dtype=np.int64)
        self.q_out = np.zeros((E, Q), dtype=np.int64)
        self.q_req = np.full((E, Q), -1, dtype=np.int64)
        self.q_head = np.zeros(E, dtype=np.int64)
        self.q_len = np.zeros(E, dtype=np.int64)
        self._last_arr = np.full(E, -np.inf)  # per-engine FIFO-order guard

        # -- global request table (struct-of-arrays, doubling growth) ---
        self.n_requests = 0
        cap = 1024
        self.r_engine = np.zeros(cap, dtype=np.int64)
        self.r_in = np.zeros(cap, dtype=np.int64)
        self.r_out = np.zeros(cap, dtype=np.int64)
        self.r_arr = np.zeros(cap, dtype=np.float64)  # injected arrival
        self.r_eff = np.full(cap, np.nan)  # arrived_emu after idle clamp
        self.r_first = np.full(cap, np.nan)  # first-token instant
        self.r_finish = np.full(cap, np.nan)  # completion instant
        self.r_state = np.zeros(cap, dtype=np.int8)

        self._completed: list[np.ndarray] = []  # per-round finished rids
        self.events_total = 0  # admissions + steps + completions
        self.now_ms = 0.0  # high-water advance_to barrier (virtual clock)

    # -- injection ----------------------------------------------------------

    def inject(self, engine: int, arr_ms: float, in_tokens: int, out_tokens: int) -> int:
        return int(
            self.inject_bulk(
                np.array([engine]), np.array([arr_ms], dtype=np.float64),
                np.array([in_tokens]), np.array([out_tokens]),
            )[0]
        )

    def inject_bulk(
        self,
        engine: np.ndarray,
        arr_ms: np.ndarray,
        in_tokens: np.ndarray,
        out_tokens: np.ndarray,
    ) -> np.ndarray:
        """Queue arrivals (same submit-time semantics as the scalar
        engine: over-length and dead-engine submissions are REJECTED,
        `out_tokens` is clamped to >= 1). Arrivals must be in
        nondecreasing arrival order per engine — the FIFO the scalar
        waiting deque realizes by construction. Returns request ids."""
        engine = np.asarray(engine, dtype=np.int64)
        arr_ms = np.asarray(arr_ms, dtype=np.float64)
        in_tokens = np.asarray(in_tokens, dtype=np.int64)
        out_tokens = np.maximum(np.asarray(out_tokens, dtype=np.int64), 1)
        n = len(engine)
        if self.n_requests + n > len(self.r_in):
            need = self.n_requests + n
            for name in ("r_engine", "r_in", "r_out", "r_arr", "r_eff",
                         "r_first", "r_finish", "r_state"):
                setattr(self, name, _grow(getattr(self, name), need))
        rids = np.arange(self.n_requests, self.n_requests + n, dtype=np.int64)
        self.n_requests += n
        self.r_engine[rids] = engine
        self.r_in[rids] = in_tokens
        self.r_out[rids] = out_tokens
        self.r_arr[rids] = arr_ms
        self.r_eff[rids] = arr_ms

        reject = (
            (in_tokens + out_tokens > self.kv_cap[engine])
            | self.preempted[engine]
        )
        self.r_state[rids[reject]] = REJECTED
        keep = ~reject
        if not keep.any():
            return rids
        # vectorized ring append: group by engine (stable sort keeps the
        # call's arrival order within each engine), verify per-engine
        # FIFO order, grow rings to fit, scatter in one pass
        order = np.argsort(engine[keep], kind="stable")
        ge = engine[keep][order]
        ga = arr_ms[keep][order]
        gi = in_tokens[keep][order]
        go = out_tokens[keep][order]
        gr = rids[keep][order]
        same = np.empty(len(ge), dtype=bool)
        same[0] = False
        same[1:] = ge[1:] == ge[:-1]
        bad = same & np.concatenate(([False], ga[1:] < ga[:-1]))
        firsts = np.flatnonzero(~same)
        head_bad = ga[firsts] < self._last_arr[ge[firsts]]
        if bad.any() or head_bad.any():
            k = int(np.flatnonzero(bad)[0]) if bad.any() else int(
                firsts[np.flatnonzero(head_bad)[0]]
            )
            prev = float(ga[k - 1]) if (bad.any() and same[k]) else float(
                self._last_arr[ge[k]]
            )
            raise ValueError(
                "per-engine arrivals must be nondecreasing "
                f"(engine {int(ge[k])}: {float(ga[k])} after {prev})"
            )
        counts = np.bincount(ge, minlength=self.engines)
        while int((self.q_len + counts).max()) > self.q_arr.shape[1]:
            self._grow_queues()
        Q = self.q_arr.shape[1]
        # rank of each arrival within its engine group
        group_start = np.repeat(firsts, np.diff(np.append(firsts, len(ge))))
        ranks = np.arange(len(ge), dtype=np.int64) - group_start
        pos = (self.q_head[ge] + self.q_len[ge] + ranks) % Q
        self.q_arr[ge, pos] = ga
        self.q_in[ge, pos] = gi
        self.q_out[ge, pos] = go
        self.q_req[ge, pos] = gr
        self.q_len += counts
        lasts = np.append(firsts[1:], len(ge)) - 1
        self._last_arr[ge[lasts]] = ga[lasts]
        return rids

    def _grow_queues(self) -> None:
        E, Q = self.q_arr.shape
        gather = (self.q_head[:, None] + np.arange(Q)[None, :]) % Q
        for name in ("q_arr", "q_in", "q_out", "q_req"):
            old = getattr(self, name)
            new = np.zeros((E, Q * 2), dtype=old.dtype)
            new[:, :Q] = np.take_along_axis(old, gather, axis=1)
            setattr(self, name, new)
        self.q_head[:] = 0

    # -- preemption (spot injector contract) --------------------------------

    def preempt(self, engines: np.ndarray | list[int]) -> int:
        """Spot-kill engines: every queued or running request fails
        permanently (REJECTED — the `(None, True)` contract) and later
        injections are refused. Abrupt BY DESIGN, like
        `EmulatedEngine.preempt`: no drain, no completion stamps.
        Returns the number of requests killed."""
        engines = np.asarray(engines, dtype=np.int64)
        victims = 0
        Q = self.q_arr.shape[1]
        for e in engines:
            if self.preempted[e]:
                continue
            self.preempted[e] = True
            if self.q_len[e]:
                pos = (self.q_head[e] + np.arange(self.q_len[e])) % Q
                self.r_state[self.q_req[e, pos]] = REJECTED
                victims += int(self.q_len[e])
            used = self.slot_used[e]
            if used.any():
                self.r_state[self.slot_req[e, used]] = REJECTED
                victims += int(used.sum())
            self.q_len[e] = 0
            self.batch[e] = 0
            self.kv_res[e] = 0
            self.slot_used[e] = False
            self.next_fin[e] = np.iinfo(np.int64).max
        self.preempted_requests += victims
        return victims

    # -- the vectorized event loop -------------------------------------------

    def _head_arr(self, idx: np.ndarray) -> np.ndarray:
        Q = self.q_arr.shape[1]
        return self.q_arr[idx, self.q_head[idx] % Q]

    def _runnable(self, idx: np.ndarray, t_ms: float) -> np.ndarray:
        """Mask over idx: which engines still have an event before the
        barrier. Busy engines step while their clock is behind t; idle
        engines run when their queue head has arrived by max(clock, t)
        (an arrival the scalar engine would already be serving)."""
        busy = self.batch[idx] > 0
        has_q = self.q_len[idx] > 0
        head = self._head_arr(idx)
        idle_run = (
            ~busy & has_q & (head <= np.maximum(self.clock[idx], t_ms))
        )
        return ~self.preempted[idx] & (
            (busy & (self.clock[idx] < t_ms)) | idle_run
        )

    def _step_cost_vec(
        self,
        idx: np.ndarray,
        bf: np.ndarray,
        new_count: np.ndarray,
        new_in_sum: np.ndarray,
        batch: np.ndarray,
    ) -> np.ndarray:
        """The scalar `_step_cost` arithmetic for the engines in idx,
        vectorized with IDENTICAL operation order (term by term, left to
        right) so float64 results are bit-equal to the oracle's. On the
        torch backend every term is its own op: one rounding each, as
        numpy does."""
        STEP_COST_EVALS[self.backend] += 1
        if self.backend == "torch":
            dev = self.device
            cols = self._cols.index_select(1, torch.from_numpy(idx).to(dev))
            alpha, beta, beta2, gamma, delta = cols.unbind(0)
            ints = torch.from_numpy(np.stack([new_count, batch])).to(dev)
            floats = torch.from_numpy(np.stack([bf, new_in_sum])).to(dev)
            count_t, batch_t = ints.unbind(0)
            bf_t, in_sum_t = floats.unbind(0)
            s = alpha + beta * bf_t + beta2 * bf_t * bf_t
            has_new = count_t > 0
            s = torch.where(has_new, s + delta * in_sum_t, s)
            s = torch.where(has_new & (count_t == batch_t), s + gamma, s)
            return s.cpu().numpy()
        alpha, beta, beta2 = self.alpha[idx], self.beta[idx], self.beta2[idx]
        gamma, delta = self.gamma[idx], self.delta[idx]
        s = alpha + beta * bf + beta2 * bf * bf
        has_new = new_count > 0
        s = np.where(has_new, s + delta * new_in_sum, s)
        s = np.where(has_new & (new_count == batch), s + gamma, s)
        return s

    def advance_to(self, t_ms: float) -> int:
        """Advance every engine past the barrier: each runnable engine
        takes whole decode iterations until its clock reaches t_ms (the
        last step may overshoot — engines take whole steps, exactly like
        the scalar loop). Returns rounds executed."""
        t0 = self._wall()
        rounds = 0
        events0 = self.events_total
        while True:
            c0 = self._wall()
            act = np.flatnonzero(self._runnable(np.arange(self.engines), t_ms))
            if len(act) == 0:
                break
            for _ in range(self.chunk_events):
                sub = act[self._runnable(act, t_ms)]
                if len(sub) == 0:
                    break
                self._round(sub)
                rounds += 1
            profiler.add_ms("twin_chunk_ms", (self._wall() - c0) * 1000.0)
        dt_ms = (self._wall() - t0) * 1000.0
        profiler.add_ms("twin_advance_ms", dt_ms)
        profiler.count("twin_events_total", self.events_total - events0)
        self.now_ms = max(self.now_ms, float(t_ms))
        return rounds

    def _round(self, idx: np.ndarray) -> None:
        """One decode iteration for every engine in idx (all runnable)."""
        Q = self.q_arr.shape[1]
        clock = self.clock  # local aliases for the hot path
        was_idle = self.batch[idx] == 0

        # idle-jump: discrete-event semantics — an idle engine begins
        # service AT the arrival instant (same clamp as the scalar
        # `_admit`'s was_idle branch; per-request max below keeps the
        # exact per-pop order)
        if was_idle.any():
            ji = idx[was_idle]
            np.maximum.at(clock, ji, self._head_arr(ji))

        # vectorized admission rounds: pop each eligible engine's queue
        # head until FIFO order, batch, or the KV reservation blocks it
        new_count = np.zeros(len(idx), dtype=np.int64)
        new_in_sum = np.zeros(len(idx), dtype=np.int64)
        admitted_rids: list[np.ndarray] = []
        admitted_eng: list[np.ndarray] = []
        while True:
            has_q = self.q_len[idx] > 0
            head_pos = self.q_head[idx] % Q
            head_arr = self.q_arr[idx, head_pos]
            head_foot = self.q_in[idx, head_pos] + self.q_out[idx, head_pos]
            elig = (
                has_q
                & (head_arr <= clock[idx])
                & (self.batch[idx] < self.max_batch[idx])
                & (self.kv_res[idx] + head_foot <= self.kv_cap[idx])
            )
            if not elig.any():
                break
            sel = np.flatnonzero(elig)
            e = idx[sel]
            pos = head_pos[sel]
            rid = self.q_req[e, pos]
            arr = head_arr[sel]
            i_t = self.q_in[e, pos]
            o_t = self.q_out[e, pos]
            self.q_head[e] = (self.q_head[e] + 1) % Q
            self.q_len[e] -= 1
            # was_idle engines: restart the virtual wait-clock at the
            # (possibly clamped) arrival and jump the engine clock
            wi = was_idle[sel]
            eff = arr.copy()
            if wi.any():
                eff[wi] = np.maximum(arr[wi], clock[e[wi]])
                np.maximum.at(clock, e[wi], arr[wi])
            self.r_eff[rid] = eff
            self.r_state[rid] = RUNNING
            slot = np.argmin(self.slot_used[e], axis=1)  # first free slot
            self.slot_used[e, slot] = True
            self.slot_req[e, slot] = rid
            self.slot_in[e, slot] = i_t
            self.slot_out[e, slot] = o_t
            self.slot_admit[e, slot] = self.step_idx[e]
            fin = self.step_idx[e] + o_t
            self.slot_finish[e, slot] = fin
            np.minimum.at(self.next_fin, e, fin)
            self.kv_res[e] += i_t + o_t
            self.batch[e] += 1
            new_count[sel] += 1
            new_in_sum[sel] += i_t
            admitted_rids.append(rid)
            admitted_eng.append(e)

        # the decode step (every runnable engine has batch >= 1 now)
        bf = self.batch[idx].astype(np.float64)
        step_ms = self._step_cost_vec(
            idx, bf, new_count, new_in_sum.astype(np.float64),
            self.batch[idx],
        )
        clock[idx] += step_ms
        self.step_idx[idx] += 1

        # first-token stamps for this round's admissions (post-step)
        for rid, e in zip(admitted_rids, admitted_eng):
            self.r_first[rid] = np.maximum(clock[e], self.r_eff[rid])

        # completions: engines whose earliest finish-step is this step
        fin_e = idx[self.next_fin[idx] == self.step_idx[idx]]
        n_fin = 0
        if len(fin_e):
            hit = self.slot_used[fin_e] & (
                self.slot_finish[fin_e] == self.step_idx[fin_e, None]
            )
            rows, cols = np.nonzero(hit)
            e = fin_e[rows]
            rid = self.slot_req[e, cols]
            self.r_finish[rid] = np.maximum(clock[e], self.r_first[rid])
            self.r_state[rid] = DONE
            self.slot_used[e, cols] = False
            # buffered fancy -= would drop all but one decrement when an
            # engine finishes several requests in one step
            np.subtract.at(
                self.kv_res, e, self.slot_in[e, cols] + self.slot_out[e, cols]
            )
            np.subtract.at(self.batch, e, 1)
            masked = np.where(
                self.slot_used[fin_e], self.slot_finish[fin_e],
                np.iinfo(np.int64).max,
            )
            self.next_fin[fin_e] = masked.min(axis=1)
            self._completed.append(rid)
            n_fin = len(rid)
        self.events_total += int(new_count.sum()) + len(idx) + n_fin

    # -- observation ---------------------------------------------------------

    def drain_completions(self) -> np.ndarray:
        """Request ids completed since the previous drain (the window
        collector's feed)."""
        if not self._completed:
            return np.empty(0, dtype=np.int64)
        out = np.concatenate(self._completed)
        self._completed = []
        return out

    def kv_used_fraction(self) -> np.ndarray:
        """Per-engine actual KV use (in + generated-so-far over
        capacity) — the scalar telemetry gauge, vectorized."""
        prog = np.minimum(
            np.maximum(self.step_idx[:, None] - self.slot_admit, 0),
            self.slot_out,
        )
        used = ((self.slot_in + prog) * self.slot_used).sum(axis=1)
        return np.minimum(used / self.kv_cap, 1.0)

    def waiting_total(self) -> int:
        """Arrived-but-unadmitted requests across the fleet (future
        injections still queued do not count)."""
        Q = self.q_arr.shape[1]
        total = 0
        for e in np.flatnonzero(self.q_len):
            pos = (self.q_head[e] + np.arange(self.q_len[e])) % Q
            total += int((self.q_arr[e, pos] <= self.clock[e]).sum())
        return total

    def results(self, rids: np.ndarray | None = None) -> dict[str, np.ndarray]:
        """Columnar per-request outcomes (emulated msec, the scalar
        RequestResult vocabulary): ttft/latency only valid where
        state == DONE."""
        sl = slice(0, self.n_requests) if rids is None else rids
        eff = self.r_eff[sl]
        return {
            "engine": self.r_engine[sl],
            "state": self.r_state[sl],
            "in_tokens": self.r_in[sl],
            "out_tokens": self.r_out[sl],
            "arrived_ms": self.r_arr[sl],
            "ttft_emu_ms": self.r_first[sl] - eff,
            "latency_emu_ms": self.r_finish[sl] - eff,
        }

    def report(self) -> dict:
        """Fleet-level run summary (deterministic: same seed, same
        injections => bit-identical dict)."""
        st = self.r_state[: self.n_requests]
        done = st == DONE
        res = self.results()
        ttft = res["ttft_emu_ms"][done]
        lat = res["latency_emu_ms"][done]
        out = res["out_tokens"][done]
        multi = out > 1
        itl = (lat[multi] - ttft[multi]) / (out[multi] - 1)

        def _pct(a: np.ndarray, q: float) -> float:
            return float(np.percentile(a, q)) if len(a) else 0.0

        return {
            "engines": self.engines,
            "requests": int(self.n_requests),
            "completed": int(done.sum()),
            "rejected": int((st == REJECTED).sum()),
            "in_flight": int(((st == QUEUED) | (st == RUNNING)).sum()),
            "preempted_requests": int(self.preempted_requests),
            "events_total": int(self.events_total),
            "ttft_emu_ms": {"mean": float(ttft.mean()) if len(ttft) else 0.0,
                            "p50": _pct(ttft, 50), "p95": _pct(ttft, 95),
                            "p99": _pct(ttft, 99)},
            "latency_emu_ms": {"mean": float(lat.mean()) if len(lat) else 0.0,
                               "p50": _pct(lat, 50), "p95": _pct(lat, 95),
                               "p99": _pct(lat, 99)},
            "itl_emu_ms": {"mean": float(itl.mean()) if len(itl) else 0.0,
                           "p50": _pct(itl, 50), "p95": _pct(itl, 95)},
        }
