"""Port of tests/test_disagg_simulation.py, on the port's imports.

Discrete-event validation of the tandem (disaggregated) queueing model.

The DisaggAnalyzer's prefill->decode tandem is cross-checked across the
scalar/XLA/pallas/C++ backends, but those all share the same analytic
assumptions. This test validates the MODEL itself against an independent
discrete-event simulation: two chained EmulatedEngines (a prefill stage
producing the first token, a decode stage producing the rest) under
Poisson load, comparing measured steady-state TTFT/ITL/throughput with
DisaggAnalyzer.analyze's predictions — the same role the reference's
emulator plays for its aggregated model (SURVEY §7 hard part: 'the
single mu(n) curve must become two coupled stages or a validated
approximation').
"""

import threading
import time

import numpy as np
import pytest

from inferno_tpu_torch.analyzer import RequestSize, build_disagg_analyzer
from inferno_tpu_torch.config.types import DecodeParms, DisaggSpec, PrefillParms
from inferno_tpu_torch.emulator.engine import EmulatedEngine, EngineProfile

# one prefill engine + one decode engine per unit; modest batches so the
# simulation reaches steady state quickly
DECODE = DecodeParms(alpha=8.0, beta=0.4)
PREFILL = PrefillParms(gamma=6.0, delta=0.04)
REQ = RequestSize(avg_in_tokens=128, avg_out_tokens=24)
PB = 4   # prefill batch
DB = 8   # decode batch
SCALE = 0.02


class TandemSim:
    """Prefill stage: an engine whose per-iteration cost is the prefill
    curve (out_tokens=1 -> a single 'decode' step priced as prefill).
    Decode stage: an engine running pure decode for out-1 tokens."""

    def __init__(self):
        # prefill engine: alpha/beta set to 0 so its single output step
        # costs gamma + delta*in*batch (the prefill curve); max_batch=PB
        self.prefill = EmulatedEngine(
            EngineProfile(alpha=0.0, beta=0.0, gamma=PREFILL.gamma,
                          delta=PREFILL.delta, max_batch=PB,
                          kv_tokens_capacity=10**9),
            time_scale=SCALE,
        )
        # decode engine: no prefill term (gamma=delta=0 via in_tokens=0
        # submissions), decode curve alpha/beta; max_batch=DB
        self.decode = EmulatedEngine(
            EngineProfile(alpha=DECODE.alpha, beta=DECODE.beta, gamma=0.0,
                          delta=0.0, max_batch=DB, kv_tokens_capacity=10**9),
            time_scale=SCALE,
        )
        self.results: list[tuple[float, float]] = []  # (ttft_emu, itl_emu)
        self._lock = threading.Lock()

    def start(self):
        self.prefill.start()
        self.decode.start()

    def stop(self):
        self.prefill.stop()
        self.decode.stop()

    def submit(self):
        def run():
            # stage 1: prefill (first token) — emulated engine pays
            # gamma + delta*in_tokens*batch for the single step. TTFT is
            # read from the VIRTUAL clock (queue wait + service in
            # emulated ms): wall-clock deltas would multiply every bit of
            # host scheduling noise by 1/SCALE = 50x
            r1 = self.prefill.generate(REQ.avg_in_tokens, 1, timeout=60)
            if r1 is None:
                return
            ttft_ms = r1.latency_emu_ms
            # stage 2: remaining tokens on the decode engine
            r2 = self.decode.generate(0, REQ.avg_out_tokens - 1, timeout=60)
            if r2 is None:
                return
            itl_ms = r2.latency_emu_ms / (REQ.avg_out_tokens - 1)
            with self._lock:
                self.results.append((ttft_ms, itl_ms))

        threading.Thread(target=run, daemon=True).start()


@pytest.mark.slow
def test_tandem_model_matches_discrete_event_sim():
    an = build_disagg_analyzer(
        max_batch=DB, max_queue=10 * DB, decode=DECODE, prefill=PREFILL,
        request=REQ, spec=DisaggSpec(prefill_slices=1, decode_slices=1,
                                     prefill_max_batch=PB),
    )
    # drive at 60% of the unit's max stable rate: busy enough for real
    # queueing, far enough from saturation for a short sim to converge
    lam_rps = 0.6 * an.max_rate

    sim = TandemSim()
    sim.start()
    rng = np.random.default_rng(5)
    try:
        n = 400
        emu_start = sim.prefill.emu_ms
        # emulated-seconds between arrivals -> wall seconds via SCALE
        for _ in range(n):
            time.sleep(float(rng.exponential(1.0 / lam_rps)) * SCALE)
            sim.submit()
        emu_window_s = (sim.prefill.emu_ms - emu_start) / 1000.0
        deadline = time.time() + 30
        while len(sim.results) < int(n * 0.95) and time.time() < deadline:
            time.sleep(0.1)
        results = list(sim.results)
    finally:
        sim.stop()

    # Analyze at the REALIZED emulated rate, not the intended one: the
    # arrival gaps are wall sleeps, so a loaded host stretches them and
    # the sim runs at a lower rho than intended — comparing against the
    # intended-rate prediction then fails from below exactly when the
    # box is busy (the round-4 emu-vs-wall flake class). Same convention
    # as experiment.run_scenario's measured_emu_rps_per_replica.
    realized_lam = n / emu_window_s if emu_window_s > 0 else lam_rps
    predicted = an.analyze(realized_lam)

    assert len(results) >= n * 0.9, f"only {len(results)}/{n} completed"
    # drop warmup
    results = results[len(results) // 5:]
    ttft = float(np.mean([r[0] for r in results]))
    itl = float(np.mean([r[1] for r in results]))

    # The analytic tandem makes a finite-buffer independence approximation
    # and the sim adds host-scheduling noise through a 50x time compression:
    # agreement within 30% on TTFT and 15% on ITL validates the model's
    # operating-point predictions (the reference tolerates similar error
    # for its aggregated emulator checks).
    assert itl == pytest.approx(predicted.avg_token_time, rel=0.15), (
        itl, predicted.avg_token_time
    )
    assert ttft == pytest.approx(predicted.ttft, rel=0.30, abs=3.0), (
        ttft, predicted.ttft
    )
