"""Discrete-event emulation of a TPU continuous-batching inference engine.

The analogue of the reference's vLLM emulator core
(the upstream project's tools/vllm-emulator/vllm_model.py:46-467), modeling a
JetStream/vLLM-TPU replica: a decode loop that admits waiting requests up
to `max_batch` slots (KV memory permitting), where each iteration costs
the linear latency profile

    prefill(batch) = gamma + delta * in_tokens * batch      (msec)
    decode(batch)  = alpha + beta * batch                   (msec)

— the same curves the autoscaler's queueing model assumes, so closed-loop
tests can check the whole stack against analytic expectations. A
`time_scale` compresses emulated milliseconds to run e2e tests fast.

Port copy of `inferno_tpu/emulator/engine.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from collections import deque
from collections.abc import Callable


@dataclasses.dataclass(frozen=True)
class EngineProfile:
    alpha: float = 20.0  # msec
    beta: float = 0.4
    gamma: float = 5.0
    delta: float = 0.02
    max_batch: int = 64
    kv_tokens_capacity: int = 1_000_000  # KV cache budget in tokens
    # quadratic decode term: real engines bend super-linearly as the KV
    # working set spills cache tiers; lets tests emulate a true profile
    # that the CR's linear alpha/beta does NOT capture (the profile-
    # corrector's closed-loop scenario)
    beta2: float = 0.0


@dataclasses.dataclass
class RequestResult:
    ttft_ms: float  # wall-clock
    latency_ms: float  # wall-clock
    in_tokens: int
    out_tokens: int
    # Virtual-clock timings in profile (emulated) msec, free of host
    # scheduling overhead — the unit the latency profile and analytic
    # model speak (reference uses a tick Clock, vllm_model.py:46-64).
    ttft_emu_ms: float = 0.0
    latency_emu_ms: float = 0.0


@dataclasses.dataclass(eq=False)  # identity semantics: requests are
# unique in-flight objects; field-wise __eq__ would make every
# list-removal a deep comparison scan (and Events don't compare anyway)
class _Request:
    in_tokens: int
    out_tokens: int
    arrived: float
    arrived_emu: float = 0.0
    done_event: threading.Event = dataclasses.field(default_factory=threading.Event)
    first_token_at: float | None = None
    finished_at: float | None = None
    first_token_emu: float = 0.0
    finished_emu: float = 0.0
    tokens_done: int = 0
    prefilled: bool = False
    # iteration count at admission (aggregated engine only): progress is
    # derived as step_index - admit_step instead of per-step increments,
    # so one decode iteration costs O(1) bookkeeping, not O(batch)
    admit_step: int = 0
    # a request whose KV footprint can NEVER fit the engine (in + out >
    # capacity even on an empty engine) is rejected at submit instead of
    # head-of-line-blocking the admission queue forever (real engines
    # return 400/413 for over-length requests)
    rejected: bool = False


def wait_for_result(
    req: _Request, timeout: float
) -> tuple[RequestResult | None, bool]:
    """THE (result, rejected) contract, shared by the aggregated and
    disaggregated engines so their rejection/timeout/result semantics
    cannot drift: (None, True) = permanently unservable (rejected at
    submit), (None, False) = timeout/overload, else the completed
    RequestResult."""
    if req.rejected:
        return None, True
    if not req.done_event.wait(timeout):
        return None, False
    assert req.first_token_at is not None and req.finished_at is not None
    return RequestResult(
        ttft_ms=(req.first_token_at - req.arrived) * 1000.0,
        latency_ms=(req.finished_at - req.arrived) * 1000.0,
        in_tokens=req.in_tokens,
        out_tokens=req.out_tokens,
        ttft_emu_ms=req.first_token_emu - req.arrived_emu,
        latency_emu_ms=req.finished_emu - req.arrived_emu,
    ), False


class EmulatedEngine:
    """One emulated replica, running its decode loop on a thread."""

    def __init__(
        self,
        profile: EngineProfile,
        time_scale: float = 1.0,
        clock: Callable[[], float] = time.time,
    ):
        """time_scale < 1 runs faster than real time (0.01 => 100x).

        `clock` is the wall-clock source (INF005 seam): the default-arg
        REFERENCE keeps the engine honest under the invariant analyzer
        (no wall-clock Call sites), and tests/the fleet twin inject a
        virtual clock so runs are deterministic.
        """
        self.profile = profile
        self.time_scale = time_scale
        self._clock = clock
        self.waiting: deque[_Request] = deque()
        # keyed by id(request): completion removal must be O(1), not a
        # list scan — at SLO-sized batches roughly one request completes
        # per iteration, so a scan would re-tax every step by O(batch)
        self.running: dict[int, _Request] = {}
        self.lock = threading.Lock()
        self.stop_flag = False
        # event-driven completion tracking: per iteration the loop does
        # O(1) work plus O(1) amortized per request (admission + the one
        # heap pop at completion) — per-step scans over the whole batch
        # made large operating points (B ~ 200+) physically unemulable,
        # the loop overhead outweighing the modeled step time
        self._step_index = 0
        self._new: list[_Request] = []  # admitted, awaiting their prefill step
        self._finish_heap: list[tuple[int, int, _Request]] = []
        self._heap_seq = 0
        self._kv_reserved = 0  # in+out reservations of running requests
        # telemetry event windows (timestamp, payload) for the fake scrape
        self.arrivals: deque[float] = deque(maxlen=100_000)
        self.completions: deque[tuple[float, RequestResult]] = deque(maxlen=100_000)
        self.emu_ms = 0.0  # virtual clock: emulated msec since start
        self._last_tick_wall = self._clock()  # wall time of the last clock advance
        self.started_at = self._clock()
        # spot-eviction state (spot/injection.py): a preempted replica is
        # gone — loop stopped, in-flight work failed, submissions refused
        self.preempted = False
        self.preempted_requests = 0
        self.thread = threading.Thread(target=self._loop, daemon=True)

    # -- public API ---------------------------------------------------------

    def start(self) -> None:
        self.started_at = self._clock()
        self.thread.start()

    def stop(self) -> None:
        self.stop_flag = True
        self.thread.join(timeout=5)

    def preempt(self) -> int:
        """Kill this replica mid-run, as a spot eviction does: the decode
        loop stops, every waiting or running request fails permanently
        (their `wait_for_result` returns ``(None, True)`` — the caller
        must resubmit on a surviving replica), and later submissions are
        refused. Returns the number of in-flight requests killed.

        Unlike `stop()` this is abrupt BY DESIGN: no drain, no
        completion stamps — a reclaimed TPU slice does not say goodbye.
        """
        self.stop_flag = True
        with self.lock:
            self.preempted = True
            victims = list(self.waiting) + list(self.running.values())
            self.waiting.clear()
            self.running.clear()
            self._new.clear()
            self._finish_heap.clear()
            self._kv_reserved = 0
            self.preempted_requests += len(victims)
        for r in victims:
            r.rejected = True
            r.done_event.set()
        return len(victims)

    def submit(self, in_tokens: int, out_tokens: int) -> _Request:
        req = _Request(in_tokens=in_tokens, out_tokens=max(out_tokens, 1), arrived=self._clock())
        if req.in_tokens + req.out_tokens > self.profile.kv_tokens_capacity:
            # can never be admitted: reject instead of queueing forever
            req.rejected = True
            req.done_event.set()
            return req
        with self.lock:
            if self.preempted:
                # a dead replica serves nothing: the caller (load
                # balancer) must route elsewhere — same (None, True)
                # contract as an over-length rejection. Checked UNDER
                # the lock preempt() holds while clearing the queues: a
                # check-then-append race would strand the request with
                # the decode loop already gone.
                req.rejected = True
                req.done_event.set()
                return req
            elapsed = self._clock() - self._last_tick_wall
            req.arrived_emu = self.emu_ms + elapsed * 1000.0 / max(self.time_scale, 1e-9)
            self.waiting.append(req)
            self.arrivals.append(req.arrived)
        return req

    def submit_at(self, in_tokens: int, out_tokens: int, at_emu_ms: float) -> _Request:
        """Deterministic submission at an exact virtual instant — the
        sync-stepped oracle mode the fleet twin's parity contract drives
        (twin/oracle.py). Unlike `submit` there is no wall-clock
        extrapolation: `arrived_emu` IS the given instant and the
        wall-side stamp is derived from it, so identical seeds give
        bit-identical results however loaded the host is."""
        req = _Request(
            in_tokens=in_tokens,
            out_tokens=max(out_tokens, 1),
            arrived=self.started_at + at_emu_ms * self.time_scale / 1000.0,
        )
        req.arrived_emu = at_emu_ms
        if req.in_tokens + req.out_tokens > self.profile.kv_tokens_capacity:
            req.rejected = True
            req.done_event.set()
            return req
        with self.lock:
            if self.preempted:
                req.rejected = True
                req.done_event.set()
                return req
            self.waiting.append(req)
            self.arrivals.append(req.arrived)
        return req

    def advance_idle_to(self, emu_ms: float) -> None:
        """Jump the virtual clock forward across an idle gap (sync
        stepping only; the threaded loop tracks wall time instead).
        A no-op when the target is in the past."""
        with self.lock:
            if emu_ms > self.emu_ms:
                self.emu_ms = emu_ms

    def generate(self, in_tokens: int, out_tokens: int, timeout: float = 60.0) -> RequestResult | None:
        """Submit and block until completion (the /v1/chat path)."""
        result, _ = self.generate_or_reject(in_tokens, out_tokens, timeout)
        return result

    def generate_or_reject(
        self, in_tokens: int, out_tokens: int, timeout: float = 60.0
    ) -> tuple[RequestResult | None, bool]:
        """(result, rejected): rejected=True means the request can NEVER
        be served (over-length — HTTP 400/413 territory), while
        (None, False) is a timeout/overload (503, retryable). The HTTP
        front must not conflate them: a retry-on-503 client would retry
        an unservable request forever."""
        return wait_for_result(self.submit(in_tokens, out_tokens), timeout)

    @property
    def num_running(self) -> int:
        return len(self.running)

    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    def kv_used_fraction(self) -> float:
        """Fraction of KV capacity in ACTUAL use (in + generated-so-far)
        — a telemetry gauge, deliberately not the reservation sum that
        `_admit` gates on; with reservation-based admission it can never
        exceed 1.0. Progress derives from the iteration counter (one
        token per iteration since admission) — O(batch), but only when
        the gauge is read, never per decode step."""
        with self.lock:
            used = sum(
                r.in_tokens + min(max(self._step_index - r.admit_step, 0),
                                  r.out_tokens)
                for r in self.running.values()
            )
        return min(used / self.profile.kv_tokens_capacity, 1.0)

    # -- decode loop --------------------------------------------------------

    def _admit(self) -> None:
        with self.lock:
            if not self.waiting:
                return
            # An idle engine serves an arrival immediately in the modeled
            # (discrete-event) world; any gap between arrival and this
            # admission poll is host artifact, so restart its virtual
            # wait-clock here. Admissions into a busy batch keep their
            # stamps — waiting out the in-flight step is real queueing.
            was_idle = not self.running
            # Reservation-based admission: every running
            # request reserves its FULL in+out footprint — held as the
            # incremental self._kv_reserved, never recomputed per step —
            # matching the candidate's accounting; otherwise aggregate KV
            # can exceed capacity later as admitted requests generate
            # tokens (this emulator has no preemption to recover with).
            while self.waiting and len(self.running) < self.profile.max_batch:
                nxt = self.waiting[0]
                footprint = nxt.in_tokens + nxt.out_tokens
                if self._kv_reserved + footprint > self.profile.kv_tokens_capacity:
                    break  # KV admission control (vllm_model.py:254-467)
                self.waiting.popleft()
                if was_idle:
                    nxt.arrived_emu = max(nxt.arrived_emu, self.emu_ms)
                    # The arrival stamp may sit AHEAD of the lazily-ticked
                    # idle clock: submit() extrapolates from the last tick,
                    # and a descheduled idle loop leaves emu_ms behind wall
                    # time by whole scheduling quanta. Discrete-event
                    # semantics: an idle engine begins service AT the
                    # arrival instant — jump the clock forward so the
                    # first-token/finish stamps accumulate real step time
                    # instead of collapsing into their max() clamps (the
                    # intermittent "decode phase reads 0 emulated ms"
                    # flake on loaded hosts).
                    if nxt.arrived_emu > self.emu_ms:
                        self.emu_ms = nxt.arrived_emu
                        self._last_tick_wall = self._clock()
                nxt.admit_step = self._step_index
                self.running[id(nxt)] = nxt
                self._new.append(nxt)
                self._kv_reserved += footprint
                # one token per iteration starting with the next one:
                # finished after out_tokens iterations
                self._heap_seq += 1
                heapq.heappush(
                    self._finish_heap,
                    (self._step_index + nxt.out_tokens, self._heap_seq, nxt),
                )

    def _step_cost(self, batch: int, new: list[_Request]) -> float:
        """Emulated msec of one iteration: a decode step, plus the newly
        admitted requests' prefill chunks riding it. The chunk SHARES the
        iteration's weight pass (the architecture the on-chip mixed
        kernel measures — llama_block.make_mixed_fn: projections
        computed once for decode rows + chunk), so its marginal
        cost is the per-token slope delta times the chunk tokens.
        gamma (the fixed prefill cost, dominated by the weight
        read) is charged only when there is NO decode iteration to
        share with (engine idle -> pure prefill iteration). The
        previous surcharge gamma + delta*in*batch misread the
        TTFT-vs-B SIZING form as a physical per-chunk cost and
        triple-counted prefill interference at high occupancy,
        making SLO-sized operating points (B ~ 200+) falsely
        unstable under emulation."""
        p = self.profile
        step_ms = p.alpha + p.beta * batch + p.beta2 * batch * batch
        if new:
            step_ms += p.delta * sum(r.in_tokens for r in new)
            if len(new) == batch:  # no in-flight decode to share
                step_ms += p.gamma
        return step_ms

    def _apply_step(self, new: list[_Request], step_ms: float, now: float) -> list[_Request]:
        """Advance the virtual clock one iteration and settle its stamps
        and completions — shared verbatim by the threaded loop and the
        sync-stepped oracle mode so their semantics cannot drift.
        Returns the finished requests; the CALLER sets their done events
        (outside the lock)."""
        finished: list[_Request] = []
        with self.lock:
            self.emu_ms += step_ms
            self._last_tick_wall = now
            self._step_index += 1
            emu_now = self.emu_ms
            for r in new:
                r.prefilled = True
                r.first_token_at = now
                r.first_token_emu = max(emu_now, r.arrived_emu)
            heap = self._finish_heap
            while heap and heap[0][0] <= self._step_index:
                _, _, r = heapq.heappop(heap)
                r.tokens_done = r.out_tokens
                r.finished_at = now
                r.finished_emu = max(emu_now, r.first_token_emu)
                finished.append(r)
                del self.running[id(r)]
                self._kv_reserved -= r.in_tokens + r.out_tokens
                self.completions.append(
                    (
                        now,
                        RequestResult(
                            ttft_ms=(r.first_token_at - r.arrived) * 1000.0,
                            latency_ms=(now - r.arrived) * 1000.0,
                            in_tokens=r.in_tokens,
                            out_tokens=r.out_tokens,
                            ttft_emu_ms=r.first_token_emu - r.arrived_emu,
                            latency_emu_ms=emu_now - r.arrived_emu,
                        ),
                    )
                )
        return finished

    def step_sync(self) -> float:
        """Advance ONE decode iteration synchronously on the virtual
        clock — no thread, no sleeps, no wall reads that matter. Admits
        whatever is admissible, charges the same `_step_cost`, settles
        via the same `_apply_step` as the threaded loop. Returns the
        emulated msec consumed; 0.0 means idle (nothing waiting that can
        be admitted and nothing running) and the caller should jump the
        clock to the next arrival with `advance_idle_to`."""
        self._admit()
        with self.lock:
            batch = len(self.running)
            new = self._new
            self._new = []
        if batch == 0:
            return 0.0
        step_ms = self._step_cost(batch, new)
        # derive the wall stamp FROM the virtual clock so wall-side
        # results are an exact rescale of the emulated ones
        now = self.started_at + (self.emu_ms + step_ms) * self.time_scale / 1000.0
        finished = self._apply_step(new, step_ms, now)
        for r in finished:
            r.done_event.set()
        return step_ms

    def _loop(self) -> None:
        while not self.stop_flag:
            self._admit()
            with self.lock:
                batch = len(self.running)
                new = self._new
                self._new = []
            if batch == 0:
                # idle: keep the virtual clock tracking wall time so
                # arrival timestamps stay meaningful across quiet gaps
                t0 = self._clock()
                time.sleep(0.0005)
                with self.lock:
                    self.emu_ms += (self._clock() - t0) * 1000.0 / max(self.time_scale, 1e-9)
                    self._last_tick_wall = self._clock()
                continue
            step_ms = self._step_cost(batch, new)
            time.sleep(step_ms / 1000.0 * self.time_scale)
            finished = self._apply_step(new, step_ms, self._clock())
            for r in finished:
                r.done_event.set()
