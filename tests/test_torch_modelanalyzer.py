"""tests/test_modelanalyzer.py's cases on the port: the ModelAnalyzer
facade and the thread-safety of the analysis stack (the same sizing
hammered from many threads must give bit-identical results), plus the
facade of both packages on the same SystemSpec: equal responses.
"""

import threading

import pytest

from inferno_tpu_torch.analyzer import TargetPerf, build_analyzer
from inferno_tpu_torch.analyzer.queue import RequestSize
from inferno_tpu_torch.config.types import DecodeParms, PrefillParms
from inferno_tpu_torch.controller.modelanalyzer import (
    REASON_MARKOVIAN,
    analyze_model,
)
from inferno_tpu_torch.config.types import SystemSpec
from inferno_tpu_torch.core import System

from fixtures import make_server
from fixtures import make_system_spec as ref_system_spec


def make_system_spec(*args, **kwargs) -> SystemSpec:
    """The shared fixture's SystemSpec, carried over into the port's types."""
    return SystemSpec.from_dict(ref_system_spec(*args, **kwargs).to_dict())


def test_analyze_model_returns_sorted_candidates():
    system = System(make_system_spec(servers=[make_server(arrival_rate=1200.0)]))
    name = next(iter(system.servers))
    resp = analyze_model(system, name)
    assert resp.reason == REASON_MARKOVIAN
    assert resp.allocations, "loaded server must have candidates"
    values = [a.value for a in resp.allocations]
    assert values == sorted(values)
    assert resp.required_prefill_qps > 0
    assert resp.required_decode_qps == resp.required_prefill_qps


def test_analyze_model_unknown_server():
    system = System(make_system_spec())
    with pytest.raises(KeyError):
        analyze_model(system, "nope:nowhere")


def test_concurrent_sizing_is_deterministic():
    """64 threads size the same configuration; every result must be
    identical to the single-threaded one (no shared mutable state)."""
    qa = build_analyzer(
        max_batch=32,
        max_queue=320,
        decode=DecodeParms(18.0, 0.3),
        prefill=PrefillParms(5.0, 0.02),
        request=RequestSize(128, 128),
    )
    targets = TargetPerf(target_ttft=500.0, target_itl=24.0)
    expected = qa.size(targets)

    results = [None] * 64
    errors = []
    barrier = threading.Barrier(16)

    def worker(i):
        try:
            if i < 16:
                barrier.wait()  # maximize overlap for the first wave
            results[i] = qa.size(targets)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(64)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    for r in results:
        assert r == expected


def test_concurrent_system_cycles_are_independent():
    """Whole sizing cycles on distinct System objects in parallel: results
    must match serial runs (the reference's TheSystem singleton made this
    impossible)."""
    def run_cycle():
        system = System(make_system_spec(servers=[make_server(arrival_rate=2400.0)]))
        system.calculate_all()
        name = next(iter(system.servers))
        best = min(system.servers[name].all_allocations.values(), key=lambda a: a.value)
        return (best.accelerator, best.num_replicas, round(best.cost, 6))

    expected = run_cycle()
    results = [None] * 16
    def worker(i):
        results[i] = run_cycle()
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(r == expected for r in results)


def test_concurrent_full_optimizations_are_independent():
    """Whole optimization cycles (sizing + solve + pool accounting) on
    DISTINCT System objects from many threads must match the serial
    results exactly — the no-package-globals guarantee at the widest
    scope (the reference's TheSystem singleton forbids this,
    pkg/core/system.go:10-45, pkg/manager/manager.go:14)."""
    from inferno_tpu_torch.solver import optimize

    specs = [
        make_system_spec([
            make_server(name=f"t{i}-a", arrival_rate=300.0 + 137.0 * i),
            make_server(name=f"t{i}-b", class_name="Freemium",
                        arrival_rate=2000.0 + 61.0 * i, out_tokens=64),
        ])
        for i in range(8)
    ]
    serial = [
        {k: v.num_replicas for k, v in optimize(System(s)).solution.items()}
        for s in specs
    ]

    results = [None] * len(specs)
    errors = []

    def run(i):
        try:
            sol = optimize(System(specs[i])).solution
            results[i] = {k: v.num_replicas for k, v in sol.items()}
        except Exception as e:  # noqa: BLE001
            errors.append((i, e))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(specs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads), "optimize hung under concurrency"
    assert errors == []
    assert results == serial


@pytest.mark.parametrize("arrival_rate", [0.0, 300.0, 2400.0])
def test_analyze_model_equals_reference(arrival_rate):
    """The same server through both packages' facades: the same reason,
    required rates and candidate allocations, bit for bit."""
    from inferno_tpu.controller.modelanalyzer import analyze_model as ref_analyze
    from inferno_tpu.core import System as RefSystem

    ref_spec = ref_system_spec(servers=[make_server(arrival_rate=arrival_rate)])
    ref_sys, port_sys = RefSystem(ref_spec), System(make_system_spec(
        servers=[make_server(arrival_rate=arrival_rate)]))
    name = next(iter(ref_sys.servers))
    ref, port = ref_analyze(ref_sys, name), analyze_model(port_sys, name)

    def fields(resp):
        return (resp.reason, resp.required_prefill_qps, resp.required_decode_qps,
                [(a.accelerator, a.num_replicas, a.batch_size, a.cost, a.value,
                  a.max_arrv_rate_per_replica) for a in resp.allocations])

    assert fields(port) == fields(ref)
