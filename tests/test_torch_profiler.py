"""The port's cycle profiler against the reference's, on the CPU.

The profile document (schema `inferno.profile/v1`) of a port cycle must
carry the reference's keys, phases and counter names, apart from two
named tables: the counters the port renames (`RENAMED`) and the port's
own (`PORT_ONLY`: its spans, the kernel library's loads, the kernels'
launches). The deterministic counters (memo hits and misses, dispatches,
dirty and skipped work, ledger paths, Prometheus queries) must be equal;
and the hooks only observe: decisions are bit-identical with the profiler
on and off. Millisecond counters are wall time, and whether a reference
dispatch counts as a compile (`jit_compiles`, `jit_compile_ms`) or as
warm (`jit_execute_ms`) depends on what its process dispatched before, so
neither their values nor their presence is compared: the reference must
account for its dispatches with one of them, the port with `dispatch_ms`.

The span hook (`obs.profiler.span`) is held here too: its counters, its
no-op, nested profilers, its ranges in a CPU `torch.profiler` trace, and
the layers it times inside `calculate_fleet`.
"""

from __future__ import annotations

import pytest
import torch

from inferno_tpu.obs import PROFILE_SCHEMA as R_SCHEMA
from inferno_tpu_torch.core.system import System
from inferno_tpu_torch.obs import PROFILE_SCHEMA, CycleProfiler
from inferno_tpu_torch.obs import profiler as prof_mod
from inferno_tpu_torch.ops import cuda_queueing as cq
from inferno_tpu_torch.parallel import calculate_fleet, reset_fleet_state
from inferno_tpu_torch.solver import Optimizer
from inferno_tpu_torch.testing.fleet import fleet_system_spec, perturb_loads

from test_torch_controller import (
    PKGS,
    SCENARIOS,
    make_reconciler,
    p_fix,
    scenario,
    snapshot,
)

PROCESS_DEPENDENT = ("jit_compiles", "jit_compile_ms", "jit_execute_ms")
# the reference's counter -> the port's name for it
RENAMED = {"jit_dispatches": "dispatches"}
# the port's own counters: its spans' milliseconds, the planner's rows by
# path, the kernel library's loads and the kernels' launches (the last two
# on backend "cuda" only)
PORT_ONLY = frozenset({
    "calculate_fleet_ms", "calculate_fleet_self_ms", "dispatch_ms", "kernel_library_load_ms",
    "solver_assign_ms", "solver_diff_ms", "solver_pools_ms", "solver_solution_ms",
    "plan_fold_ms", "plan_feed_ms", "plan_card_rows", "plan_host_rows",
    "kernel_library_loads", "stats_kernel_launches", "bisect_kernel_launches",
    "plan_rows_kernel_launches",
})


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
        and k not in PORT_ONLY
    }


def _as_port(counters: dict) -> dict:
    """The reference's counters under the port's names."""
    return {RENAMED.get(k, k): v for k, v in counters.items()}


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
        keys_a = set(_as_port(a["counters"])) - set(PROCESS_DEPENDENT)
        keys_b = set(b["counters"]) - PORT_ONLY
        assert keys_a == keys_b, (c, sorted(keys_a ^ keys_b))
        assert not [k for k in b["counters"] if k.startswith("jit_")], c
        if a["counters"].get("jit_dispatches"):
            assert {"jit_compile_ms", "jit_execute_ms"} & set(a["counters"]), c
        if b["counters"].get("dispatches"):
            assert b["counters"]["dispatch_ms"] > 0.0, c
        assert _deterministic(_as_port(a["counters"])) == _deterministic(b["counters"]), c


@pytest.mark.parametrize("name", ["unlimited", "limited_degraded", "spot_tier"])
def test_profiler_off_decisions_bit_identical(name):
    scn = SCENARIOS[name]()
    on_docs, on = _profiles("port", scn, "torch", cycles=4, cycle_profiler=True)
    off_docs, off = _profiles("port", scn, "torch", cycles=4, cycle_profiler=False)
    assert all(d is not None for d in on_docs)
    assert all(d is None for d in off_docs)
    assert on == off


def test_every_dispatch_is_charged_to_dispatch_ms(monkeypatch):
    """The first dispatch of the lanes and a warm one alike count in
    `dispatches` and are timed in `dispatch_ms`; no `jit_*` key is left."""
    monkeypatch.setenv("INCREMENTAL_CYCLE", "0")
    scn = scenario(n=6)
    rec, _ = make_reconciler("port", scn, "torch")
    first = rec.run_cycle().profile["counters"]
    # same lanes, new loads: the same buckets dispatch again
    rec.prom = p_fix.fleet_fake_prom(
        {k: dict(v, arrival_rps=v["arrival_rps"] * 1.01) for k, v in scn["rows"](0).items()}
    )
    second = rec.run_cycle().profile["counters"]
    for counters in (first, second):
        assert counters["dispatches"] == 1 and counters["dispatch_ms"] > 0.0
        assert not [k for k in counters if k.startswith("jit_")]


def test_module_hooks_are_noops_without_active_profiler():
    assert prof_mod.current() is None
    prof_mod.count("anything")
    prof_mod.add_ms("anything_ms", 1.0)
    assert prof_mod.current() is None
    with CycleProfiler() as p:
        prof_mod.count("dispatches", 2)
        prof_mod.add_ms("solve_ms", 1.5)
    assert p.counters == {"dispatches": 2, "solve_ms": 1.5}


def test_span_is_a_shared_noop_with_no_profiler_active():
    """With no profiler on the thread and torch's profiler not recording,
    every span is the same no-op context and leaves no counter behind."""
    assert prof_mod.current() is None
    assert prof_mod.span("dispatch") is prof_mod.span("calculate_fleet")
    with prof_mod.span("dispatch"):
        pass
    p = CycleProfiler()
    with prof_mod.span("dispatch"):
        pass
    assert p.counters == {} and prof_mod.current() is None


def test_span_adds_its_milliseconds_on_the_profilers_clock():
    ticks = iter([1.0, 1.25, 2.0, 2.5])
    with CycleProfiler(clock=lambda: next(ticks)) as p:
        with prof_mod.span("dispatch"):
            pass
        with prof_mod.span("dispatch"):
            pass
    assert p.counters == {"dispatch_ms": 750.0}


def test_nested_profiler_restores_the_outer_one():
    """A profiler activated inside another's window (a reconcile cycle
    inside a profiled benchmark window) puts the outer one back when it
    deactivates, and each charges only its own spans."""
    outer = CycleProfiler().activate()
    try:
        with prof_mod.span("calculate_fleet"):
            inner = CycleProfiler().activate()
            with prof_mod.span("dispatch"):
                pass
            inner.deactivate()
            assert prof_mod.current() is outer
            with prof_mod.span("solver_assign"):
                pass
    finally:
        outer.deactivate()
    assert prof_mod.current() is None
    assert set(inner.counters) == {"dispatch_ms"}
    assert set(outer.counters) == {"calculate_fleet_ms", "solver_assign_ms"}


@pytest.mark.parametrize("first", ["outer", "inner"])
def test_nested_profilers_deactivate_in_any_order(first):
    """A profiler deactivated while a later one is still active leaves that
    one on the thread, and is not put back when the later one goes: the
    thread then has the profiler it had before either."""
    base = CycleProfiler().activate()
    try:
        outer = CycleProfiler().activate()
        inner = CycleProfiler().activate()
        (outer if first == "outer" else inner).deactivate()
        assert prof_mod.current() is (inner if first == "outer" else outer)
        (inner if first == "outer" else outer).deactivate()
        assert prof_mod.current() is base
        with prof_mod.span("dispatch"):
            pass
    finally:
        base.deactivate()
    assert prof_mod.current() is None
    assert set(base.counters) == {"dispatch_ms"}
    assert outer.counters == {} and inner.counters == {}


def test_own_span_charges_its_time_less_its_direct_children():
    """`span(name, own=True)` adds to ``<name>_self_ms`` its time less that
    of the spans that closed directly inside it; a grandchild is charged
    to its own parent, not twice."""
    ticks = iter([0.0, 0.1, 0.3, 0.35, 0.4, 0.5, 0.6, 1.0])
    with CycleProfiler(clock=lambda: next(ticks)) as p:
        with prof_mod.span("calculate_fleet", own=True):      # 0.0 .. 1.0
            with prof_mod.span("dispatch"):                   # 0.1 .. 0.4
                with prof_mod.span("kernel_library_load"):    # 0.3 .. 0.35
                    pass
            with prof_mod.span("incremental_writeback"):      # 0.5 .. 0.6
                pass
    c = p.counters
    assert c["calculate_fleet_ms"] == pytest.approx(1000.0)
    assert c["calculate_fleet_self_ms"] == pytest.approx(1000.0 - 300.0 - 100.0)
    assert c["dispatch_ms"] == pytest.approx(300.0)
    assert "dispatch_self_ms" not in c


def test_kernel_library_load_is_counted_once_a_process(monkeypatch):
    """The first load of the kernel library is the span
    `kernel_library_load` and one `kernel_library_loads`; a later launch
    finds it loaded and counts nothing."""

    class _Entry:
        pass

    class _Library:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, name):
            entry = _Entry()
            setattr(self, name, entry)
            return entry

    monkeypatch.setattr(cq, "_lib", None)
    monkeypatch.setattr(cq, "build", lambda: "libinferno_kernels-test.so")
    monkeypatch.setattr(cq.ctypes, "CDLL", _Library)
    with CycleProfiler() as first:
        lib = cq._load()
        assert cq._load() is lib and lib.path == "libinferno_kernels-test.so"
    with CycleProfiler() as later:
        assert cq._load() is lib
    assert first.counters["kernel_library_loads"] == 1
    assert first.counters["kernel_library_load_ms"] >= 0.0
    assert later.counters == {}


def _fleet(n: int = 24) -> tuple[System, object]:
    reset_fleet_state()
    spec = fleet_system_spec(n, shapes_per_variant=2, seed=3)
    return System(spec), spec


@pytest.mark.parametrize("incremental", ["1", "0"], ids=["incremental", "full_path"])
def test_calculate_fleet_children_fit_inside_it(incremental, monkeypatch):
    """On a CPU fleet (backend torch) the direct child spans of
    `calculate_fleet` sum to no more than `calculate_fleet_ms`, on both
    paths, cold and warm: its own time is not negative, and leaves the
    snapshot and the dispatch, two of its children, outside it."""
    monkeypatch.setenv("INCREMENTAL_CYCLE", incremental)
    system, _ = _fleet()
    try:
        for cycle in range(2):
            perturb_loads(system)  # every loaded lane moves: one dispatch a cycle
            with CycleProfiler() as p:
                calculate_fleet(system, backend="torch", device="cpu")
            c = p.counters
            children_ms = c["calculate_fleet_ms"] - c["calculate_fleet_self_ms"]
            assert c["calculate_fleet_self_ms"] >= 0.0, (cycle, c)
            # (total - self) rounds the children's sum by an ulp or two
            two = c["dispatch_ms"] + c["snapshot_update_ms"]
            assert children_ms >= two - 1e-9 * c["calculate_fleet_ms"], (cycle, c)
    finally:
        reset_fleet_state()


def _ranges(prof) -> dict:
    """inferno.* range name -> the inferno.* ranges around it, innermost
    first, in a CPU profiler's event list."""
    out = {}
    for e in prof.events():
        if not e.name.startswith("inferno."):
            continue
        parents, up = [], e.cpu_parent
        while up is not None:
            if up.name.startswith("inferno."):
                parents.append(up.name)
            up = up.cpu_parent
        out.setdefault(e.name, parents)
    return out


def test_spans_are_ranges_of_a_cpu_torch_profiler_trace():
    """One `calculate_fleet` + `Optimizer.optimize` under a CPU
    `torch.profiler` (no cycle profiler active) holds the inferno.* ranges,
    nested as they run."""
    from torch.profiler import ProfilerActivity, profile

    system, spec = _fleet()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            calculate_fleet(system, backend="torch", device="cpu")
            Optimizer(spec.optimizer).optimize(system, calculate=False)
    finally:
        reset_fleet_state()
    ranges = _ranges(prof)
    assert ranges["inferno.calculate_fleet"] == []
    for child in ("inferno.snapshot_update", "inferno.dispatch",
                  "inferno.incremental_scatter", "inferno.incremental_writeback"):
        assert ranges[child] == ["inferno.calculate_fleet"], (child, ranges)
    for name in ("inferno.solver_assign", "inferno.solver_diff", "inferno.solver_pools",
                 "inferno.solver_solution"):
        assert ranges[name] == [], (name, ranges)
    # the ranges are the program's record functions, not device work
    assert all(e.device_type == torch.autograd.DeviceType.CPU
               for e in prof.events() if e.name.startswith("inferno."))


def test_profile_phases_and_prom_queries():
    scn = scenario(n=4)
    rec, _ = make_reconciler("port", scn, "torch")
    report = rec.run_cycle()
    doc = report.profile
    assert {"collect", "analyze", "solve", "actuate"} <= set(doc["phases"])
    assert doc["counters"]["prom_queries"] == report.prom_queries
    body = rec.emitter.registry.render()
    assert 'inferno_profile_phase_seconds_bucket{le="+Inf",phase="solve"}' in body
