"""Disaggregated (JetStream-style) serving emulation: separate prefill
and decode engine pools coupled by a KV-cache transfer delay.

The aggregated `EmulatedEngine` models one continuous-batching replica;
JetStream instead runs prompt processing on dedicated prefill engines
and hands the KV cache to decode engines that do generation-only
continuous batching (the gap the reference's single-mu(n) analyzer names
explicitly — SURVEY §7 "hard parts"; our tandem model in
inferno_tpu_torch.analyzer.disagg sizes it). This module is the serving-side
counterpart so the tandem path gets the same closed e2e loop the
aggregated path has:

* prefill pool — `prefill_engines` threads batching waiting prompts up
  to `prefill_max_batch`; an iteration costs gamma + delta·in_tokens·B
  (the analyzer's mu_p(n) curve) and produces the FIRST token (TTFT is
  stamped at prefill completion, as JetStream reports it — BEFORE the
  KV transfer below);
* KV transfer — a fixed `kv_transfer_ms` between prefill completion and
  decode admission. The tandem analyzer folds this into its prefill
  gamma, so ITS predicted TTFT includes the handoff while the emulator's
  measured TTFT does not: model-vs-emulator TTFT comparisons must
  subtract kv_transfer_ms from the prediction
  (emulator/experiment.py `_model_prediction` does);
* decode pool — `decode_engines` threads running generation-only steps
  alpha + beta·B for the remaining out_tokens-1 tokens (mu_d(n)).

One DisaggEngine == one tandem REPLICA UNIT: scaling replicas means
whole (prefill_engines + decode_engines) groups — exactly what a
LeaderWorkerSet group actuates atomically.

Public surface matches `EmulatedEngine` (start/stop/submit/generate,
num_running/num_waiting, arrivals/completions, kv_used_fraction) so
`EmulatorServer` and `render_engine_metrics` wrap either engine
unchanged. Virtual timings are derived from scaled wall time (every
sleep in both pools is `time_scale`-scaled, so emulated msec ==
wall msec / time_scale uniformly across the tandem).

Port copy of `inferno_tpu/emulator/disagg.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import bisect
import dataclasses
import threading
import time
from collections import deque

from inferno_tpu_torch.emulator.engine import RequestResult, _Request, wait_for_result


@dataclasses.dataclass(frozen=True)
class DisaggProfile:
    """Latency profile of one disaggregated replica unit."""

    alpha: float = 20.0  # decode step, msec
    beta: float = 0.4
    gamma: float = 5.0  # prefill, msec
    delta: float = 0.02
    prefill_max_batch: int = 8  # concurrent prompts per prefill engine
    decode_max_batch: int = 64  # generation slots per decode engine
    prefill_engines: int = 1  # engines per replica unit
    decode_engines: int = 1
    kv_transfer_ms: float = 2.0  # prefill->decode KV handoff
    kv_tokens_capacity: int = 1_000_000  # per decode engine


class DisaggEngine:
    """One emulated disaggregated replica unit (prefill pool + decode
    pool), every engine on its own thread."""

    def __init__(self, profile: DisaggProfile, time_scale: float = 1.0):
        self.profile = profile
        self.time_scale = time_scale
        self.lock = threading.Lock()
        self.stop_flag = False
        # shared queues: prompts awaiting a prefill engine; prefilled
        # requests awaiting a decode slot, gated by the KV-transfer time.
        # decode_waiting is kept SORTED by ready_wall: with
        # multiple prefill engines, completion times interleave out of
        # append order, and the FIFO admission loop below must not block
        # an already-transferred request behind a not-yet-ready head.
        # (Blocking on the *KV check* is intentional FIFO admission —
        # large requests are not starved by smaller later arrivals.)
        self.prefill_waiting: deque[_Request] = deque()
        self.decode_waiting: list[tuple[float, _Request]] = []
        # per-engine running sets (index 0..prefill_engines-1, etc.)
        self._prefill_running: list[list[_Request]] = [
            [] for _ in range(profile.prefill_engines)
        ]
        self._decode_running: list[list[_Request]] = [
            [] for _ in range(profile.decode_engines)
        ]
        self.arrivals: deque[float] = deque(maxlen=100_000)
        self.completions: deque[tuple[float, RequestResult]] = deque(maxlen=100_000)
        self.started_at = time.time()
        self.threads = [
            threading.Thread(target=self._prefill_loop, args=(i,), daemon=True)
            for i in range(profile.prefill_engines)
        ] + [
            threading.Thread(target=self._decode_loop, args=(i,), daemon=True)
            for i in range(profile.decode_engines)
        ]

    # -- public surface (mirrors EmulatedEngine) ----------------------------

    def start(self) -> None:
        self.started_at = time.time()
        for t in self.threads:
            t.start()

    def stop(self) -> None:
        self.stop_flag = True
        for t in self.threads:
            t.join(timeout=5)

    @property
    def emu_ms(self) -> float:
        """Virtual clock: all sleeps are time_scale-scaled wall sleeps, so
        emulated time is wall time divided by the scale."""
        return (time.time() - self.started_at) * 1000.0 / max(self.time_scale, 1e-9)

    def _emu(self, wall: float) -> float:
        return (wall - self.started_at) * 1000.0 / max(self.time_scale, 1e-9)

    def submit(self, in_tokens: int, out_tokens: int) -> _Request:
        req = _Request(
            in_tokens=in_tokens, out_tokens=max(out_tokens, 1), arrived=time.time()
        )
        if req.in_tokens + req.out_tokens > self.profile.kv_tokens_capacity:
            # can never fit a decode engine even empty: reject instead of
            # head-of-line-blocking the FIFO admission queue forever (real
            # engines return 400/413 for over-length requests)
            req.rejected = True
            req.done_event.set()
            return req
        req.arrived_emu = self._emu(req.arrived)
        with self.lock:
            self.prefill_waiting.append(req)
            self.arrivals.append(req.arrived)
        return req

    def generate(
        self, in_tokens: int, out_tokens: int, timeout: float = 60.0
    ) -> RequestResult | None:
        result, _ = self.generate_or_reject(in_tokens, out_tokens, timeout)
        return result

    def generate_or_reject(
        self, in_tokens: int, out_tokens: int, timeout: float = 60.0
    ) -> tuple[RequestResult | None, bool]:
        """(result, rejected) — the shared contract in
        engine.wait_for_result: rejection (over-length, HTTP 400/413)
        must not be conflated with timeout/overload (503)."""
        return wait_for_result(self.submit(in_tokens, out_tokens), timeout)

    @property
    def num_running(self) -> int:
        with self.lock:
            return sum(len(r) for r in self._prefill_running) + sum(
                len(r) for r in self._decode_running
            )

    @property
    def num_waiting(self) -> int:
        with self.lock:
            return len(self.prefill_waiting) + len(self.decode_waiting)

    def kv_used_fraction(self) -> float:
        """Actual KV in use (in + generated-so-far); the admission gate
        reserves in+out instead, so this gauge can't exceed 1.0."""
        cap = self.profile.kv_tokens_capacity * self.profile.decode_engines
        with self.lock:
            used = sum(
                r.in_tokens + r.tokens_done
                for eng in self._decode_running
                for r in eng
            )
        return min(used / cap, 1.0)

    # -- pools --------------------------------------------------------------

    def _sleep(self, emu_ms: float) -> None:
        time.sleep(emu_ms / 1000.0 * self.time_scale)

    def _prefill_loop(self, idx: int) -> None:
        p = self.profile
        running = self._prefill_running[idx]
        while not self.stop_flag:
            with self.lock:
                while self.prefill_waiting and len(running) < p.prefill_max_batch:
                    running.append(self.prefill_waiting.popleft())
                batch = len(running)
                max_in = max((r.in_tokens for r in running), default=0)
            if batch == 0:
                time.sleep(0.0005)
                continue
            # one prefill iteration over the admitted prompt batch; it
            # emits each request's first token (JetStream TTFT semantics)
            self._sleep(p.gamma + p.delta * max_in * batch)
            now = time.time()
            ready_wall = now + p.kv_transfer_ms / 1000.0 * self.time_scale
            finished: list[_Request] = []
            with self.lock:
                for r in running:
                    r.prefilled = True
                    r.tokens_done = 1
                    r.first_token_at = now
                    r.first_token_emu = self._emu(now)
                    if r.tokens_done >= r.out_tokens:
                        self._finish(r, now)
                        finished.append(r)
                    else:
                        bisect.insort(self.decode_waiting, (ready_wall, r),
                                      key=lambda t: t[0])
                running.clear()
            for r in finished:
                r.done_event.set()

    def _decode_loop(self, idx: int) -> None:
        p = self.profile
        running = self._decode_running[idx]
        while not self.stop_flag:
            now = time.time()
            with self.lock:
                # reservation-based KV admission, matching engine._admit
                #: running requests reserve in+out so the
                # aggregate can't outgrow capacity as they decode
                kv_used = sum(r.in_tokens + r.out_tokens for r in running)
                # admit transferred requests whose KV has arrived, in
                # ready_wall order (the list is sorted at insertion)
                while self.decode_waiting and len(running) < p.decode_max_batch:
                    ready_wall, nxt = self.decode_waiting[0]
                    if ready_wall > now:
                        break
                    if kv_used + nxt.in_tokens + nxt.out_tokens > p.kv_tokens_capacity:
                        break  # KV admission control (FIFO, anti-starvation)
                    self.decode_waiting.pop(0)
                    running.append(nxt)
                    kv_used += nxt.in_tokens + nxt.out_tokens
                batch = len(running)
            if batch == 0:
                time.sleep(0.0005)
                continue
            self._sleep(p.alpha + p.beta * batch)
            now = time.time()
            finished: list[_Request] = []
            with self.lock:
                for r in running:
                    r.tokens_done += 1
                    if r.tokens_done >= r.out_tokens:
                        finished.append(r)
                for r in finished:
                    running.remove(r)
                    self._finish(r, now)
            for r in finished:
                r.done_event.set()

    def _finish(self, r: _Request, now: float) -> None:
        """Record completion (caller holds self.lock)."""
        r.finished_at = now
        r.finished_emu = max(self._emu(now), r.first_token_emu)
        self.completions.append(
            (
                now,
                RequestResult(
                    ttft_ms=(r.first_token_at - r.arrived) * 1000.0,
                    latency_ms=(now - r.arrived) * 1000.0,
                    in_tokens=r.in_tokens,
                    out_tokens=r.out_tokens,
                    ttft_emu_ms=r.first_token_emu - r.arrived_emu,
                    latency_emu_ms=r.finished_emu - r.arrived_emu,
                ),
            )
        )
