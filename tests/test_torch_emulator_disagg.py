"""tests/test_emulator_disagg.py's cases on the port's disaggregated
(prefill/decode-separated) emulator. Its two wall-paced cases sit in the
slow tier there; the deterministic counterpart of its closed loop is
tests/test_torch_twin.py::test_closed_loop_matches_tandem_analyzer_twin.
Both packages' discrete-event tandem unit (`twin/tandem.py`) on the same
seeded traces: equal results, bit for bit.
"""

import random
import threading
import time

import numpy as np
import pytest

from inferno_tpu_torch.analyzer import RequestSize, build_disagg_analyzer
from inferno_tpu_torch.config.types import DecodeParms, DisaggSpec, PrefillParms
from inferno_tpu_torch.emulator.disagg import DisaggEngine, DisaggProfile

# large enough that admission-poll overhead (0.5 ms wall) is small in
# emulated units: 0.5 ms wall / 0.1 = 5 emu ms against 50+ ms step times
SCALE = 0.1


def run_engine(profile, fn, time_scale=SCALE):
    eng = DisaggEngine(profile, time_scale=time_scale)
    eng.start()
    try:
        return fn(eng)
    finally:
        eng.stop()


def test_prefill_not_blocked_by_decode():
    """The whole point of disaggregation: a long-running decode batch must
    not delay a newly arrived prompt's first token. (The aggregated
    emulator CANNOT pass this: its single loop interleaves prefill into
    the shared iteration.)"""
    p = DisaggProfile(alpha=60.0, beta=0.5, gamma=40.0, delta=0.01,
                      kv_transfer_ms=0.0, decode_max_batch=32)

    def body(eng):
        # occupy decode with long generations
        bg = [threading.Thread(target=eng.generate, args=(64, 64), kwargs={"timeout": 120})
              for _ in range(8)]
        for t in bg:
            t.start()
        time.sleep(0.5 * SCALE / 0.1)  # let them reach the decode pool
        r = eng.generate(64, 1, timeout=60)  # single-token: pure prefill
        for t in bg:
            t.join()
        assert r is not None
        # prefill engine is idle, so TTFT stays ~ gamma + delta*64, far
        # below one decode generation (64 tokens * 60+ ms)
        assert r.ttft_emu_ms < 200.0, r.ttft_emu_ms
        return r

    run_engine(p, body)


def test_kv_admission_respects_capacity():
    """Decode admission stops at the KV budget; requests queue instead of
    overflowing (aggregated analogue: engine.py _admit)."""
    p = DisaggProfile(alpha=30.0, beta=0.5, gamma=10.0, delta=0.001,
                      kv_transfer_ms=0.0, decode_max_batch=64,
                      kv_tokens_capacity=3_000)

    def body(eng):
        results = []
        ts = [threading.Thread(
            target=lambda: results.append(eng.generate(900, 24, timeout=120)))
            for _ in range(6)]
        for t in ts:
            t.start()
        time.sleep(2.0)
        # 900 in + 24 out ~ 924+ tokens per request: only 3 fit 3000
        assert max(len(r) for r in eng._decode_running) <= 3
        for t in ts:
            t.join()
        assert all(r is not None for r in results)
        return results

    run_engine(p, body)


def test_pool_scaling_two_decode_engines():
    """Two decode engines split the generation load: sustained throughput
    roughly doubles vs one engine at the same per-engine batch cap."""
    def throughput(decode_engines):
        p = DisaggProfile(alpha=40.0, beta=1.0, gamma=5.0, delta=0.001,
                          kv_transfer_ms=0.0, decode_max_batch=4,
                          decode_engines=decode_engines)

        def body(eng):
            results = []

            def worker():
                while time.time() < stop_at:
                    r = eng.generate(32, 16, timeout=60)
                    if r is not None:
                        results.append(r)

            stop_at = time.time() + 3.0
            ts = [threading.Thread(target=worker) for _ in range(12)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            return len(results)

        return run_engine(p, body, time_scale=0.02)

    one, two = throughput(1), throughput(2)
    assert two >= 1.5 * one, (one, two)


def test_oversized_request_rejected_not_deadlocking():
    """A request whose KV footprint can never fit (in+out > capacity) is
    rejected at submit; traffic queued behind it still completes instead
    of starving behind the FIFO head (review r4)."""
    p = DisaggProfile(alpha=20.0, beta=0.4, gamma=5.0, delta=0.001,
                      kv_transfer_ms=0.0, kv_tokens_capacity=1_000)

    def body(eng):
        assert eng.generate(900, 200, timeout=5) is None  # rejected fast
        ok = eng.generate(100, 8, timeout=30)  # unaffected by the reject
        assert ok is not None
        return ok

    run_engine(p, body, time_scale=0.02)


def test_oversized_request_rejected_aggregated_engine():
    from inferno_tpu_torch.emulator.engine import EmulatedEngine, EngineProfile

    eng = EmulatedEngine(EngineProfile(alpha=20.0, beta=0.4, gamma=5.0,
                                       delta=0.001, kv_tokens_capacity=1_000),
                         time_scale=0.02)
    eng.start()
    try:
        assert eng.generate(900, 200, timeout=5) is None
        assert eng.generate(100, 8, timeout=30) is not None
    finally:
        eng.stop()


def test_http_rejects_overlength_with_400_not_503():
    """An unservable (over-length) request is a permanent 400, never the
    retryable 503 a timeout maps to (review r4: a retry-on-503 client
    would retry it forever)."""
    import json
    import urllib.error
    import urllib.request

    from inferno_tpu_torch.emulator.server import EmulatorServer

    srv = EmulatorServer(
        model_id="m",
        engine=DisaggEngine(
            DisaggProfile(alpha=10.0, beta=0.2, gamma=5.0, delta=0.001,
                          kv_tokens_capacity=500),
            time_scale=0.02,
        ),
    )
    srv.start()
    try:
        body = json.dumps({"model": "m",
                           "messages": [{"role": "user", "content": "x " * 400}],
                           "max_tokens": 400}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/chat/completions", data=body,
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=30)
            raise AssertionError("expected HTTP 400")
        except urllib.error.HTTPError as e:
            assert e.code == 400
        # a servable request on the same engine still succeeds
        ok = json.dumps({"model": "m",
                         "messages": [{"role": "user", "content": "hi"}],
                         "max_tokens": 8}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/chat/completions", data=ok,
            headers={"Content-Type": "application/json"})
        assert urllib.request.urlopen(req, timeout=60).status == 200
    finally:
        srv.stop()


def _same_columns(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k], equal_nan=True), k


@pytest.mark.parametrize("kv_transfer_ms", [0.0, 12.5])
def test_tandem_poisson_equals_reference(kv_transfer_ms):
    """`run_tandem_poisson` of both packages on one seed and profile."""
    from inferno_tpu.emulator.disagg import DisaggProfile as RefProfile
    from inferno_tpu.twin.tandem import run_tandem_poisson as ref_run
    from inferno_tpu_torch.twin.tandem import run_tandem_poisson

    kw = dict(alpha=40.0, beta=1.0, gamma=30.0, delta=0.02,
              prefill_max_batch=8, decode_max_batch=16, prefill_engines=1,
              decode_engines=2, kv_transfer_ms=kv_transfer_ms)
    ref = ref_run(RefProfile(**kw), 9.0, 120.0, 128, 12, seed=3)
    port = run_tandem_poisson(DisaggProfile(**kw), 9.0, 120.0, 128, 12, seed=3)
    _same_columns(port, ref)
    assert (port["state"] == 2).sum() > 100


def test_tandem_trace_equals_reference():
    """`run_tandem` over a seeded heavy-tailed trace whose tokens overflow
    the KV capacity now and then (rejections on both sides)."""
    from inferno_tpu.emulator.disagg import DisaggProfile as RefProfile
    from inferno_tpu.twin.tandem import run_tandem as ref_run
    from inferno_tpu_torch.twin.tandem import run_tandem

    rng = np.random.default_rng(11)
    n = 400
    arr = np.cumsum(rng.exponential(40.0, n))
    ins = rng.lognormal(5.0, 0.9, n).astype(np.int64) + 1
    outs = rng.integers(1, 60, n)
    kw = dict(alpha=30.0, beta=0.8, gamma=20.0, delta=0.03,
              prefill_max_batch=4, decode_max_batch=8, prefill_engines=2,
              decode_engines=2, kv_transfer_ms=5.0, kv_tokens_capacity=2_000)
    _same_columns(run_tandem(DisaggProfile(**kw), arr, ins, outs),
                  ref_run(RefProfile(**kw), arr, ins, outs))
