"""Threaded-stress companion to the INF004 lock-discipline rule
(docs/analysis.md).

The static checker proves shared writes are guarded and the lock-order
graph is acyclic; this suite is the dynamic half — it hammers the same
entry points the graph models (registry emission from pool workers,
flight-recorder enqueue against its writer thread, per-thread profiler
counters) from N threads with a seeded schedule and pins
no-lost-counts / no-torn-reads. Fast by construction: pure-Python
contention, no sockets, no sleeps on the hot path.

Port of tests/test_thread_stress.py on the port's modules, the expectations unchanged.
"""

from __future__ import annotations

import random
import threading

from inferno_tpu_torch.controller.metrics import Registry
from inferno_tpu_torch.obs import profiler
from inferno_tpu_torch.obs.recorder import FlightRecorder, RecorderConfig, read_artifact

THREADS = 8
OPS = 250
SEED = 0x15F0


class StubSpec:
    def __init__(self, doc):
        self.doc = doc

    def to_dict(self):
        return self.doc


def _start_all(threads):
    barrier = threading.Barrier(len(threads) + 1)
    wrapped = []
    for t in threads:
        orig = t._target

        def run(orig=orig, args=t._args):
            barrier.wait()
            orig(*args)

        wrapped.append(threading.Thread(target=run))
    for t in wrapped:
        t.start()
    barrier.wait()  # release every worker at once for maximum overlap
    return wrapped


def test_registry_counts_survive_contention():
    """N threads inc() one shared counter, set() per-thread gauges, and
    observe() one histogram while a reader renders concurrently: the
    final counts are exact (no lost read-modify-write) and every
    rendered snapshot is internally consistent (no torn cumulative
    buckets: a finite bucket may never exceed the +Inf count)."""
    registry = Registry()
    counter = registry.counter("inferno_stress_total", "contended event count")
    gauge = registry.gauge("inferno_stress_ratio", "per-worker progress")
    hist = registry.histogram(
        "inferno_stress_seconds", "contended latencies", buckets=(0.001, 0.01, 0.1)
    )
    stop = threading.Event()
    torn: list[str] = []

    def reader():
        while not stop.is_set():
            text = registry.render()
            counts = {}
            for line in text.splitlines():
                if line.startswith("inferno_stress_seconds_bucket"):
                    le = line.split('le="', 1)[1].split('"', 1)[0]
                    counts[le] = int(line.rsplit(" ", 1)[1])
            if counts:
                inf = counts.get("+Inf", 0)
                if any(v > inf for v in counts.values()):
                    torn.append(text)
                    return

    def worker(i: int) -> None:
        rng = random.Random(SEED + i)
        for n in range(OPS):
            counter.inc({"worker": str(i)})
            counter.inc({}, 2.0)
            gauge.set({"worker": str(i)}, n / OPS)
            hist.observe({}, rng.choice((0.0005, 0.005, 0.05, 0.5)))

    reader_t = threading.Thread(target=reader)
    reader_t.start()
    workers = [
        threading.Thread(target=worker, args=(i,)) for i in range(THREADS)
    ]
    done = _start_all(workers)
    for t in done:
        t.join(timeout=30)
    stop.set()
    reader_t.join(timeout=30)

    assert torn == [], "torn histogram render observed"
    assert counter.get({}) == THREADS * OPS * 2.0
    for i in range(THREADS):
        assert counter.get({"worker": str(i)}) == OPS
        assert gauge.get({"worker": str(i)}) == (OPS - 1) / OPS
    # histogram: exact total observation count, cumulative render sane
    (_name, sets) = next(
        (n, s) for n, s in registry.labelsets() if n == "inferno_stress_seconds"
    )
    assert sets == [{}]
    rendered = registry.render()
    count_line = next(
        line for line in rendered.splitlines()
        if line.startswith("inferno_stress_seconds_count")
    )
    assert int(count_line.rsplit(" ", 1)[1]) == THREADS * OPS


def test_recorder_enqueue_under_contention(tmp_path):
    """N threads enqueue cycles against the live writer thread — the
    exact producer/consumer pair the lock-order graph models. Every
    accepted cycle must be durably written exactly once (no lost or
    duplicated cycles), and accepted + dropped must equal offered."""
    rec = FlightRecorder(RecorderConfig(
        dir=str(tmp_path / "rec"), max_mb=64.0, queue_max=THREADS * OPS + 8,
    ))
    accepted = [0] * THREADS

    def worker(i: int) -> None:
        for n in range(OPS):
            ok = rec.record_cycle(
                StubSpec({"worker": i, "n": n}), [], {"seq": i * OPS + n}
            )
            if ok:
                accepted[i] += 1

    done = _start_all(
        [threading.Thread(target=worker, args=(i,)) for i in range(THREADS)]
    )
    for t in done:
        t.join(timeout=30)
    rec.flush()
    rec.close()

    offered = THREADS * OPS
    assert sum(accepted) + rec.dropped == offered
    # the queue was sized to never drop: every cycle is on disk once
    assert rec.dropped == 0 and rec.write_errors == 0
    assert rec.recorded == offered
    trace = read_artifact(str(tmp_path / "rec"))
    seqs = [c.seq for c in trace.cycles]
    assert len(seqs) == offered
    assert sorted(seqs) == list(range(offered))


def test_profiler_counters_stay_thread_local():
    """Each thread activates its OWN CycleProfiler; concurrent count()
    and add_ms() bumps must land on the activating thread's profiler
    only — no bleed, no lost increments (the TLS design the INF004
    graph models as lock-free-by-confinement)."""
    profs: dict[int, profiler.CycleProfiler] = {}

    def worker(i: int) -> None:
        p = profiler.CycleProfiler()
        p.activate()
        profs[i] = p  # dict insert under the GIL; keys are disjoint
        for _ in range(OPS):
            profiler.count("stress_events", by=1)
            profiler.add_ms("stress_ms", 0.5)
        assert profiler.current() is p
        p.deactivate()

    done = _start_all(
        [threading.Thread(target=worker, args=(i,)) for i in range(THREADS)]
    )
    for t in done:
        t.join(timeout=30)

    assert profiler.current() is None
    assert len(profs) == THREADS
    for p in profs.values():
        assert p.counters["stress_events"] == OPS
        assert p.counters["stress_ms"] == OPS * 0.5
