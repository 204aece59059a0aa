"""tests/test_emulator_engine.py's cases on the port's emulated engine
(KV admission control, batching bounds, the virtual clock, the quadratic
profile knob), and the synchronously stepped engine of both packages on
the same seeded requests: equal `RequestResult`s.
"""

import dataclasses
import time

import numpy as np
import pytest

from inferno_tpu.emulator import engine as ref_engine
from inferno_tpu_torch.emulator import engine as port_engine
from inferno_tpu_torch.emulator.engine import EmulatedEngine, EngineProfile

FAST = EngineProfile(alpha=1.0, beta=0.05, gamma=0.5, delta=0.001, max_batch=4)
SCALE = 0.002


def drain(engine, reqs, timeout=30.0):
    for r in reqs:
        assert r.done_event.wait(timeout), "request did not complete"


def test_kv_admission_blocks_oversized_working_set():
    """Requests whose KV footprint exceeds capacity must wait even when
    batch slots are free."""
    # slow steps (~0.4ms wall each) so the admission state is observable
    # long before the ~80ms first completions
    prof = EngineProfile(alpha=20.0, beta=0.5, gamma=1.0, delta=0.001,
                         max_batch=8, kv_tokens_capacity=1000)
    eng = EmulatedEngine(prof, time_scale=0.02)
    eng.start()
    try:
        # each request needs 400 in + 200 out = 600 KV tokens: only 1 fits
        # fully, a second fits while outputs are short -> never more than 2
        reqs = [eng.submit(400, 200) for _ in range(4)]
        time.sleep(0.03)
        assert eng.num_running <= 2
        assert eng.num_waiting >= 2
        assert eng.kv_used_fraction() <= 1.0
        drain(eng, reqs)  # waiters admitted as completions free KV
    finally:
        eng.stop()


def test_kv_admission_is_fifo_head_blocking():
    """A head-of-line request that does not fit blocks the queue (matching
    the reference's in-order admission) rather than being skipped."""
    prof = EngineProfile(alpha=20.0, beta=0.5, gamma=1.0, delta=0.001,
                         max_batch=8, kv_tokens_capacity=1000)
    eng = EmulatedEngine(prof, time_scale=0.02)
    eng.start()
    try:
        big = eng.submit(900, 50)     # takes nearly all KV for ~20ms wall
        time.sleep(0.005)
        huge = eng.submit(800, 100)   # fits alone, can never co-run with `big`
        small = eng.submit(10, 10)    # would fit, but queued behind `huge`
        time.sleep(0.01)
        assert eng.num_running == 1   # only `big`
        assert eng.num_waiting == 2
        drain(eng, [big, huge, small])
    finally:
        eng.stop()


def test_batch_never_exceeds_max_batch():
    eng = EmulatedEngine(FAST, time_scale=SCALE)
    eng.start()
    try:
        reqs = [eng.submit(8, 64) for _ in range(16)]
        peak = 0
        deadline = time.time() + 10.0
        while any(not r.done_event.is_set() for r in reqs) and time.time() < deadline:
            peak = max(peak, eng.num_running)
            time.sleep(0.005)
        drain(eng, reqs)
        assert peak <= FAST.max_batch
        assert peak >= 2  # concurrency actually happened
    finally:
        eng.stop()


def test_virtual_clock_advances_with_steps_and_idle():
    eng = EmulatedEngine(FAST, time_scale=SCALE)
    eng.start()
    try:
        time.sleep(0.05)
        idle_ms = eng.emu_ms
        assert idle_ms > 0  # idle ticks keep the clock moving
        r = eng.submit(16, 32)
        assert r.done_event.wait(10)
        # 32 decode steps at >= alpha ms each, plus prefill
        assert eng.emu_ms >= idle_ms + 32 * FAST.alpha
    finally:
        eng.stop()


def test_latencies_scale_with_emulated_profile():
    """Emulated TTFT/latency reflect the profile's terms, not wall-clock
    noise: doubled output length ~doubles decode time."""
    eng = EmulatedEngine(FAST, time_scale=SCALE)
    eng.start()
    try:
        a = eng.generate(16, 16, timeout=10)
        b = eng.generate(16, 64, timeout=10)
        assert a is not None and b is not None
        # assert on the VIRTUAL clock: wall latency_ms flakes whenever
        # anything else loads the box (sleep overshoot), emu timings don't
        decode_a = a.latency_emu_ms - a.ttft_emu_ms
        decode_b = b.latency_emu_ms - b.ttft_emu_ms
        assert decode_b == pytest.approx(decode_a * (63 / 15), rel=0.25)
    finally:
        eng.stop()


def test_quadratic_beta2_bends_itl_superlinearly():
    """The beta2 knob exists so closed-loop tests can emulate true
    profiles the CR's linear alpha/beta cannot capture (the corrector
    scenario). Full-batch ITL must exceed the linear prediction."""
    linear = EngineProfile(alpha=2.0, beta=0.1, gamma=0.5, delta=0.001,
                           max_batch=8)
    bent = EngineProfile(alpha=2.0, beta=0.1, gamma=0.5, delta=0.001,
                         max_batch=8, beta2=0.2)

    def full_batch_itl(prof):
        eng = EmulatedEngine(prof, time_scale=SCALE)
        eng.start()
        try:
            reqs = [eng.submit(8, 32) for _ in range(8)]
            drain(eng, reqs)
            comps = [r for _, r in eng.completions]
            return sum(
                (c.latency_emu_ms - c.ttft_emu_ms) / max(c.out_tokens - 1, 1)
                for c in comps
            ) / len(comps)
        finally:
            eng.stop()

    itl_linear = full_batch_itl(linear)
    itl_bent = full_batch_itl(bent)
    # beta2 * batch^2 = 0.2 * 64 = 12.8ms extra per step at batch 8
    assert itl_bent > itl_linear + 5.0


def test_completion_telemetry_windows_bounded():
    eng = EmulatedEngine(FAST, time_scale=SCALE)
    assert eng.completions.maxlen == 100_000
    assert eng.arrivals.maxlen == 100_000


# -- the synchronously stepped engine, both packages ------------------------


def _sync_run(mod, profile, arrivals, kill_at_ms=None):
    """Step one engine of `mod` through seeded arrivals on the virtual
    clock (submit_at / step_sync / advance_idle_to, a frozen wall clock),
    optionally preempting it at `kill_at_ms`; every request's
    (result, rejected) pair, as `wait_for_result` reports it."""
    eng = mod.EmulatedEngine(mod.EngineProfile(**profile), time_scale=1.0,
                             clock=lambda: 0.0)
    reqs, k = [], 0
    while k < len(arrivals) or eng.num_running or eng.num_waiting:
        while k < len(arrivals) and arrivals[k][0] <= eng.emu_ms:
            reqs.append(eng.submit_at(arrivals[k][1], arrivals[k][2],
                                      arrivals[k][0]))
            k += 1
        if kill_at_ms is not None and eng.emu_ms >= kill_at_ms:
            eng.preempt()
            kill_at_ms = None
        if eng.step_sync() == 0.0:
            if k == len(arrivals):
                break
            eng.advance_idle_to(arrivals[k][0])
    reqs += [eng.submit_at(i, o, a) for a, i, o in arrivals[k:]]
    out = []
    for r in reqs:
        res, rejected = mod.wait_for_result(r, 0.0)
        out.append((None if res is None else dataclasses.asdict(res), rejected))
    return out


@pytest.mark.parametrize("kill_at_ms", [None, 1500.0])
@pytest.mark.parametrize("profile", [
    dict(alpha=20.0, beta=0.5, beta2=0.001, gamma=8.0, delta=0.02,
         max_batch=4, kv_tokens_capacity=4_000),
    dict(alpha=5.0, beta=0.1, gamma=2.0, delta=0.01, max_batch=8),
])
def test_sync_stepped_results_equal_reference(profile, kill_at_ms):
    """Seeded Poisson arrivals with lognormal token counts (some over the
    KV capacity, so rejected at submit) through both packages' engines
    in sync-stepping mode: the same RequestResults, bit for bit."""
    rng = np.random.default_rng(5)
    n = 120
    arr = np.cumsum(rng.exponential(25.0, n))
    ins = np.minimum(rng.lognormal(5.0, 0.8, n).astype(int) + 1, 5000)
    outs = rng.integers(1, 80, n)
    arrivals = [(float(a), int(i), int(o)) for a, i, o in zip(arr, ins, outs)]
    ref = _sync_run(ref_engine, profile, arrivals, kill_at_ms)
    port = _sync_run(port_engine, profile, arrivals, kill_at_ms)
    assert port == ref
    assert sum(r is not None for r, _ in port) >= 3  # real work completed
    if kill_at_ms is not None:
        assert sum(rejected for _, rejected in port) > 20  # the kill landed
