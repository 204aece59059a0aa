"""The port's cycle profiler against the reference's, on the CPU.

The profile document (schema `inferno.profile/v1`) of a port cycle must
carry the reference's keys, phases and counter names; the deterministic
counters (memo hits and misses, dispatches, dirty and skipped work, ledger
paths, Prometheus queries) must be equal; and the hooks only observe:
decisions are bit-identical with the profiler on and off. Millisecond
counters are wall time, and whether a dispatch counts as a compile
(`jit_compiles`, `jit_compile_ms`) or as warm (`jit_execute_ms`) depends on
what each process dispatched before, so neither their values nor their
presence is compared across packages: each side must account for its
dispatches with one of them.
"""

from __future__ import annotations

import pytest

from inferno_tpu.obs import PROFILE_SCHEMA as R_SCHEMA
from inferno_tpu_torch.obs import PROFILE_SCHEMA, CycleProfiler
from inferno_tpu_torch.obs import profiler as prof_mod
from inferno_tpu_torch.parallel import fleet as p_fleet

from test_torch_controller import (
    PKGS,
    SCENARIOS,
    make_reconciler,
    p_fix,
    scenario,
    snapshot,
)

PROCESS_DEPENDENT = ("jit_compiles", "jit_compile_ms", "jit_execute_ms")


def _profiles(pkg: str, scn: dict, backend: str, cycles: int, **cfg):
    rec, cluster = make_reconciler(pkg, scn, backend, **cfg)
    fix = PKGS[pkg][3]
    docs, snaps = [], []
    for c in range(cycles):
        rec.prom = fix.fleet_fake_prom(scn["rows"](c), grouped=scn["grouped"])
        report = rec.run_cycle()
        docs.append(report.profile)
        snaps.append(snapshot(pkg, rec, cluster, report, scn))
    rec.close()
    return docs, snaps


def _deterministic(counters: dict) -> dict:
    return {
        k: v for k, v in counters.items()
        if not k.endswith(("_ms", "_kb")) and k not in PROCESS_DEPENDENT
    }


@pytest.mark.parametrize(
    "name,env",
    [
        ("unlimited", {}),
        ("limited_degraded", {}),
        ("sizing_cache", {}),
        ("unlimited", {"INCREMENTAL_CYCLE": "0"}),
    ],
    ids=["incremental", "limited", "sizing_cache", "full_path"],
)
def test_profile_documents_match_reference(name, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    scn = SCENARIOS[name]()
    ref_docs, _ = _profiles("ref", scn, "jax", cycles=4)
    port_docs, _ = _profiles("port", scn, "torch", cycles=4)
    assert PROFILE_SCHEMA == R_SCHEMA
    for c, (a, b) in enumerate(zip(ref_docs, port_docs)):
        assert b["schema"] == PROFILE_SCHEMA
        assert set(a) == set(b), c
        assert set(a["phases"]) == set(b["phases"]), c
        assert set(a["cycle"]) == set(b["cycle"]), c
        for phase in a["phases"]:
            assert set(a["phases"][phase]) == set(b["phases"][phase])
        keys_a = set(a["counters"]) - set(PROCESS_DEPENDENT)
        keys_b = set(b["counters"]) - set(PROCESS_DEPENDENT)
        assert keys_a == keys_b, (c, sorted(keys_a ^ keys_b))
        for doc in (a, b):
            if doc["counters"].get("jit_dispatches"):
                assert {"jit_compile_ms", "jit_execute_ms"} & set(doc["counters"]), c
        assert _deterministic(a["counters"]) == _deterministic(b["counters"]), c


@pytest.mark.parametrize("name", ["unlimited", "limited_degraded", "spot_tier"])
def test_profiler_off_decisions_bit_identical(name):
    scn = SCENARIOS[name]()
    on_docs, on = _profiles("port", scn, "torch", cycles=4, cycle_profiler=True)
    off_docs, off = _profiles("port", scn, "torch", cycles=4, cycle_profiler=False)
    assert all(d is not None for d in on_docs)
    assert all(d is None for d in off_docs)
    assert on == off


def test_first_dispatch_of_a_signature_counts_as_compile(monkeypatch):
    """`jit_compiles` counts the first dispatch of a launch signature in
    the process; the same signature later is a warm dispatch."""
    monkeypatch.setenv("INCREMENTAL_CYCLE", "0")
    monkeypatch.setattr(p_fleet, "_compiled_sigs", set())
    scn = scenario(n=6)
    rec, _ = make_reconciler("port", scn, "torch")
    first = rec.run_cycle().profile["counters"]
    assert first["jit_dispatches"] == 1 and first["jit_compiles"] == 1
    assert first["jit_compile_ms"] > 0.0 and "jit_execute_ms" not in first
    # same lanes, new loads: the same signature dispatches warm
    rec.prom = p_fix.fleet_fake_prom(
        {k: dict(v, arrival_rps=v["arrival_rps"] * 1.01) for k, v in scn["rows"](0).items()}
    )
    second = rec.run_cycle().profile["counters"]
    assert second["jit_dispatches"] == 1
    assert "jit_compiles" not in second and second["jit_execute_ms"] > 0.0


def test_module_hooks_are_noops_without_active_profiler():
    assert prof_mod.current() is None
    prof_mod.count("anything")
    prof_mod.add_ms("anything_ms", 1.0)
    assert prof_mod.current() is None
    with CycleProfiler() as p:
        prof_mod.count("jit_dispatches", 2)
        prof_mod.add_ms("solve_ms", 1.5)
    assert p.counters == {"jit_dispatches": 2, "solve_ms": 1.5}


def test_profile_phases_and_prom_queries():
    scn = scenario(n=4)
    rec, _ = make_reconciler("port", scn, "torch")
    report = rec.run_cycle()
    doc = report.profile
    assert {"collect", "analyze", "solve", "actuate"} <= set(doc["phases"])
    assert doc["counters"]["prom_queries"] == report.prom_queries
    body = rec.emitter.registry.render()
    assert 'inferno_profile_phase_seconds_bucket{le="+Inf",phase="solve"}' in body
