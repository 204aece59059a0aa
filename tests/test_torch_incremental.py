"""The port's incremental dirty-set cycle and event scan
(inferno_tpu_torch.parallel.incremental, the snapshot's scan_update /
scan_event_update), on the CPU with backend "torch".

Two contracts:

* inside the port, an incremental cycle's DECISION SURFACE — accelerator,
  replicas, cost, solver value, spot replicas, degradation events — is
  bit-identical to the port's full path (INCREMENTAL_CYCLE=0,
  FLEET_SNAPSHOT=0) on a fresh System with the same inputs; the
  operating point (itl/ttft/rho) agrees within 1e-4 relative. These are
  the counterparts of tests/test_incremental.py;
* against the JAX reference, both packages run their incremental paths
  over the same mutations of carried-across specs, and the decisions
  agree under the round's rule (`testing.fleet.assert_same_decisions`).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from inferno_tpu_torch.config.types import CapacitySpec, OptimizerSpec, SystemSpec
from inferno_tpu_torch.core import System
from inferno_tpu_torch.ops import queueing as Q
from inferno_tpu_torch.parallel import calculate_fleet, reset_fleet_state
from inferno_tpu_torch.parallel import fleet as port_fleet
from inferno_tpu_torch.parallel import incremental as fleet_incremental
from inferno_tpu_torch.parallel import snapshot as snap_mod
from inferno_tpu_torch.parallel.snapshot import SCAN_FULL, SCAN_RATE, SCAN_VALUE
from inferno_tpu_torch.solver.greedy_vec import solve_greedy_fleet
from inferno_tpu_torch.solver.solver import solve_unlimited
from inferno_tpu_torch.testing.fleet import (
    assert_same_decisions,
    fleet_capacity,
    fleet_system_spec,
)

CPU = dict(backend="torch", device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The fleets here are small, and the tests run beside other test
    workers: torch's intra-op threads would only contend with them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_fleet_state():
    reset_fleet_state()
    yield
    reset_fleet_state()


def _calc(system, **kw):
    return calculate_fleet(system, **CPU, **kw)


def _decisions(system: System) -> dict:
    out = {}
    for name, server in system.servers.items():
        a = server.allocation
        out[name] = None if a is None else (
            a.accelerator, a.num_replicas, a.cost, a.value,
            a.itl, a.ttft, a.rho, a.spot_replicas,
        )
    return out


def _assert_parity(got: dict, want: dict, got_degr=None, want_degr=None):
    """Decision surface bit-equal; operating point within 1e-4."""
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert (g is None) == (w is None), name
        if w is None:
            continue
        assert g[:4] == w[:4], (name, g[:4], w[:4])  # acc/reps/cost/value
        assert g[7] == w[7], name  # spot replicas
        for gv, wv in zip(g[4:7], w[4:7]):
            assert gv == pytest.approx(wv, rel=1e-4, abs=1e-6), name
    if want_degr is not None:
        assert got_degr == want_degr


def _full(system_src: System, spec, limited=False):
    """The port's full path (INCREMENTAL_CYCLE=0, legacy FLEET_SNAPSHOT=0
    walk) on a FRESH System of the same inputs: loads, profiles and SLO
    targets are shared with the spec by reference, current allocations
    and capacity are copied. Leaves the incremental state alone (the
    full path voids only state describing its own System)."""
    prior = {k: os.environ.get(k) for k in ("INCREMENTAL_CYCLE", "FLEET_SNAPSHOT")}
    os.environ["INCREMENTAL_CYCLE"] = "0"
    os.environ["FLEET_SNAPSHOT"] = "0"
    try:
        ref = System(spec)
        for ref_s, src_s in zip(ref.servers.values(), system_src.servers.values()):
            cur = src_s.cur_allocation
            ref_s.cur_allocation.accelerator = cur.accelerator
            ref_s.cur_allocation.num_replicas = cur.num_replicas
            ref_s.cur_allocation.cost = cur.cost
        ref.quotas = dict(system_src.quotas)
        ref.capacity = dict(system_src.capacity)
        ref.spot = dict(system_src.spot)
        _calc(ref)
        if limited:
            solve_greedy_fleet(ref, spec.optimizer)
        else:
            solve_unlimited(ref)
        return ref
    finally:
        for key, val in prior.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val


def _perturb(system: System, rng, fraction: float) -> None:
    servers = list(system.servers.values())
    for i in rng.choice(len(servers), max(int(len(servers) * fraction), 1), replace=False):
        load = servers[i].load
        if load is not None and load.arrival_rate > 0:
            load.arrival_rate *= float(rng.uniform(0.6, 1.7))


def _mutate(system: System, rng) -> None:
    """One fuzz step: λ / profile parms / SLO target / current allocation /
    token mix on a random handful of servers (the reference's fuzz)."""
    names = list(system.servers)
    kind = rng.integers(0, 5)
    picks = rng.choice(len(names), int(rng.integers(1, 5)), replace=False)
    if kind == 0:  # λ
        for i in picks:
            load = system.servers[names[i]].load
            if load is not None:
                load.arrival_rate = float(
                    max(load.arrival_rate * rng.uniform(0.3, 2.0),
                        0.0 if rng.uniform() < 0.05 else 1.0)
                )
    elif kind == 1:  # profile parms (replacement, shared with spec)
        for i in picks:
            model = system.models.get(system.servers[names[i]].model_name)
            if model is None:
                continue
            for perf in model.perf_data.values():
                perf.decode_parms = dataclasses.replace(
                    perf.decode_parms,
                    beta=perf.decode_parms.beta * float(rng.uniform(0.9, 1.1)),
                )
    elif kind == 2:  # SLO target (per-model entry in the class)
        for i in picks:
            server = system.servers[names[i]]
            svc = system.service_classes.get(server.service_class_name)
            t = svc.target_for(server.model_name)
            if t is None:
                continue
            new = dataclasses.replace(
                t, slo_itl=max(t.slo_itl * float(rng.uniform(0.8, 1.2)), 1.0)
            )
            svc._targets[server.model_name] = new
            svc.spec.model_targets[:] = [
                new if x.model == server.model_name else x
                for x in svc.spec.model_targets
            ]
    elif kind == 3:  # current allocation
        for i in picks:
            server = system.servers[names[i]]
            server.cur_allocation.num_replicas = int(rng.integers(0, 6))
            server.cur_allocation.cost = float(rng.uniform(0, 200))
            server.spec.current_alloc.num_replicas = server.cur_allocation.num_replicas
            server.spec.current_alloc.cost = server.cur_allocation.cost
    else:  # token mix
        for i in picks:
            load = system.servers[names[i]].load
            if load is not None:
                load.avg_in_tokens = float(rng.integers(16, 600))
                load.avg_out_tokens = float(rng.integers(8, 400))


FUZZ_SPEC = dict(shapes_per_variant=2, tandem_every=5, zero_load_every=9,
                 pinned_every=7, infeasible_every=11)


def test_kill_switch_routes_to_full_path(monkeypatch):
    """INCREMENTAL_CYCLE=0 runs the full pipeline: no dirty info, the
    candidate table built eagerly, decisions equal either way."""
    spec = fleet_system_spec(40, shapes_per_variant=2)
    inc = System(spec)
    _calc(inc)
    solve_unlimited(inc)
    assert inc.fleet_dirty is not None
    assert inc.fleet_candidates is None  # lazy on the incremental path
    assert inc.fleet_candidates_builder is not None

    monkeypatch.setenv("INCREMENTAL_CYCLE", "0")
    reset_fleet_state()
    off = System(spec)
    _calc(off)
    solve_unlimited(off)
    assert off.fleet_dirty is None
    assert off.fleet_candidates is not None  # eager
    _assert_parity(_decisions(inc), _decisions(off))


def test_only_subset_takes_the_full_path():
    system = System(fleet_system_spec(12, shapes_per_variant=2))
    _calc(system, only=set(list(system.servers)[:4]))
    assert system.fleet_dirty is None


def test_clean_cycle_replays_everything():
    """An unchanged fleet re-solves nothing: zero dirty servers, the clean
    servers' allocation OBJECTS stand."""
    system = System(fleet_system_spec(60, shapes_per_variant=2))
    _calc(system)
    solve_unlimited(system)
    allocs0 = {n: s.allocation for n, s in system.servers.items()}
    n = _calc(system)
    solve_unlimited(system)
    fd = system.fleet_dirty
    assert n > 0
    assert len(fd.dirty_pos) == 0
    assert fd.skipped_servers == len(system.servers)
    assert fd.dirty_lanes == 0 and fd.refold_lanes == 0
    assert fd.scanned_servers == len(system.servers)
    for name, server in system.servers.items():
        assert server.allocation is allocs0[name], name


def test_rate_dirty_refolds_only_those_lanes(monkeypatch):
    spec = fleet_system_spec(80, shapes_per_variant=2)
    system = System(spec)
    _calc(system)
    solve_unlimited(system)
    _perturb(system, np.random.default_rng(5), 0.1)
    calls = []
    real = port_fleet._solve_slot
    monkeypatch.setattr(
        port_fleet, "_solve_slot",
        lambda slot, *a: calls.append(slot) or real(slot, *a),
    )
    _calc(system)
    solve_unlimited(system)
    fd = system.fleet_dirty
    assert 0 < len(fd.dirty_pos) < len(system.servers)
    assert fd.dirty_lanes == fd.refold_lanes > 0  # λ-only: no full kernel
    assert set(fd.codes[fd.dirty_pos].tolist()) == {SCAN_RATE}
    # every dispatched bucket is a refold bucket, bucketed by the full
    # path's rule
    assert calls and all(slot.cached is not None for slot in calls)
    assert sum(len(slot.idx) for slot in calls) == fd.refold_lanes
    for slot in calls:
        assert slot.width == port_fleet._pad_lanes(len(slot.idx))
        assert slot.cached[2].dtype == bool
    _assert_parity(_decisions(system), _decisions(_full(system, spec)))


def test_structure_dirty_runs_full_kernel_for_subset():
    """A profile-parms replacement re-solves ONLY that variant's lanes
    through the full sizing program, bit-equal to the full path."""
    spec = fleet_system_spec(50, shapes_per_variant=2, tandem_every=0, infeasible_every=0)
    system = System(spec)
    _calc(system)
    solve_unlimited(system)
    victim = next(
        s for s in system.servers.values()
        if s.load is not None and s.load.arrival_rate > 0
    )
    for perf in system.models[victim.model_name].perf_data.values():
        perf.decode_parms = dataclasses.replace(
            perf.decode_parms, alpha=perf.decode_parms.alpha * 1.07
        )
    _calc(system)
    solve_unlimited(system)
    fd = system.fleet_dirty
    dirty_names = {list(system.servers)[p] for p in fd.dirty_pos.tolist()}
    assert victim.name in dirty_names
    assert fd.refold_lanes == 0
    assert 1 <= fd.dirty_lanes < 10
    _assert_parity(_decisions(system), _decisions(_full(system, spec)))


@pytest.mark.parametrize("zero_load", [False, True], ids=["loaded", "zero_load"])
def test_cur_allocation_change_is_value_dirty(zero_load):
    """A changed current allocation re-derives transition penalties and the
    argmin without any kernel; a zero-load server re-derives its
    closed-form dict (replaying it would keep penalties computed against
    the OLD allocation)."""
    spec = fleet_system_spec(
        12 if zero_load else 40, shapes_per_variant=2, tandem_every=0,
        zero_load_every=3 if zero_load else 0, pinned_every=0, infeasible_every=0,
    )
    system = System(spec)
    _calc(system)
    solve_unlimited(system)
    victim = next(
        s for i, s in enumerate(system.servers.values())
        if (s.load.arrival_rate == 0) == zero_load and i >= 1
    )
    victim.cur_allocation.num_replicas += 3
    victim.cur_allocation.cost = victim.cur_allocation.cost * 1.5 + 123.0
    victim.spec.current_alloc.num_replicas = victim.cur_allocation.num_replicas
    victim.spec.current_alloc.cost = victim.cur_allocation.cost
    _calc(system)
    solve_unlimited(system)
    fd = system.fleet_dirty
    assert fd.codes[list(system.servers).index(victim.name)] == SCAN_VALUE
    assert fd.dirty_lanes == 0  # no kernel at all
    _assert_parity(_decisions(system), _decisions(_full(system, spec)))


def _spot_capacity(cap: dict) -> CapacitySpec:
    import json

    from inferno_tpu_torch.spot.market import parse_spot_pools

    spot_cap = CapacitySpec(chips=cap)
    spot_cap.spot = parse_spot_pools(json.dumps({
        pool: {"discount": 0.6, "hazardPerHr": 0.05, "blastRadius": 0.25, "chips": 64}
        for pool in cap
    }))
    return spot_cap


@pytest.fixture(scope="module")
def edge_base():
    reset_fleet_state()
    base = fleet_system_spec(60, shapes_per_variant=2, priority_classes=3, split_pools=True)
    cap = fleet_capacity(base, 0.9, device="cpu")
    reset_fleet_state()
    return base, cap


@pytest.mark.parametrize("regime", ["unlimited", "limited+quotas", "limited+spot"])
def test_incremental_matches_full_over_edge_regimes(edge_base, regime):
    """Edge fleets (multi-priority, split pools) x capacity / quota / spot
    regimes: perturbed cycles on a persistent System end bit-equal to the
    full path, degradation events included."""
    base, cap = edge_base
    pool = next(iter(cap))
    overrides, limited = {
        "unlimited": ({}, False),
        "limited+quotas": ({
            "capacity": CapacitySpec(chips=cap, quotas={pool: max(cap[pool] - 8, 4)}),
            "optimizer": OptimizerSpec(unlimited=False),
        }, True),
        "limited+spot": ({
            "capacity": _spot_capacity(cap),
            "optimizer": OptimizerSpec(unlimited=False),
        }, True),
    }[regime]
    spec = dataclasses.replace(base, **overrides)
    system = System(spec)
    rng = np.random.default_rng(11)
    for _ in range(4):
        _calc(system)
        solve_greedy_fleet(system, spec.optimizer) if limited else solve_unlimited(system)
        _perturb(system, rng, 0.15)
    _calc(system)
    solve_greedy_fleet(system, spec.optimizer) if limited else solve_unlimited(system)
    ref = _full(system, spec, limited=limited)
    _assert_parity(_decisions(system), _decisions(ref), system.degradations, ref.degradations)
    if regime == "limited+spot":
        assert any(a and a[7] for a in _decisions(system).values())


def test_fuzz_random_flips_bit_parity_50_cycles():
    """Every cycle flips a random subset of λ / profiles / SLO targets /
    current allocations / token mixes on a persistent fleet; the
    incremental cycle must equal the port's full path on every one of 50
    cycles."""
    spec = fleet_system_spec(36, **FUZZ_SPEC)
    system = System(spec)
    rng = np.random.default_rng(42)
    tiers = set()
    for _ in range(50):
        _mutate(system, rng)
        _calc(system)
        solve_unlimited(system)
        tiers.update(system.fleet_dirty.codes.tolist())
        _assert_parity(_decisions(system), _decisions(_full(system, spec)))
    assert {SCAN_VALUE, SCAN_RATE, SCAN_FULL} <= tiers


def test_reset_and_reversed_catalog_void_persistent_columns():
    """reset_fleet_state voids the persistent result columns and the dirty
    bookkeeping: sizing fleet A, then a reversed-catalog fleet B with
    bit-equal masks, must match B's own full path, accelerator names
    included."""
    from fixtures import make_system_spec

    spec_a = SystemSpec.from_dict(make_system_spec().to_dict())
    spec_b = dataclasses.replace(spec_a, accelerators=list(reversed(spec_a.accelerators)))
    a = System(spec_a)
    _calc(a)
    solve_unlimited(a)
    reset_fleet_state()
    assert fleet_incremental._state is None
    b = System(spec_b)
    _calc(b)
    solve_unlimited(b)
    _assert_parity(_decisions(b), _decisions(_full(b, spec_b)))


def test_full_pass_voids_state_only_for_its_own_system():
    """A full pass over a DIFFERENT System leaves the incremental state
    alone (what lets the parity harness interleave full solves); a full
    pass over the state's own System voids it."""
    spec = fleet_system_spec(20, shapes_per_variant=2)
    system = System(spec)
    _calc(system)
    solve_unlimited(system)
    st = fleet_incremental._state
    _full(system, spec)
    assert fleet_incremental._state is st
    os.environ["INCREMENTAL_CYCLE"] = "0"
    try:
        _calc(system)
    finally:
        os.environ.pop("INCREMENTAL_CYCLE")
    assert fleet_incremental._state is None


def test_lambda_tolerance_anchors_and_tolerance_zero_resolves():
    """A sub-tolerance λ wiggle on every server is clean (the shared
    `rate_within_tolerance` predicate), decisions replay as objects; the
    same wiggle with tolerance 0 re-solves every server."""
    from inferno_tpu_torch.config.defaults import rate_within_tolerance

    assert rate_within_tolerance(100.0, 104.9, 0.05)
    assert not rate_within_tolerance(100.0, 105.1, 0.05)
    spec = fleet_system_spec(30, shapes_per_variant=1, tandem_every=0, zero_load_every=0,
                             pinned_every=0, infeasible_every=0)
    system = System(spec)
    _calc(system, lam_tolerance=0.05)
    solve_unlimited(system)
    before = _decisions(system)
    alloc_objs = {n: s.allocation for n, s in system.servers.items()}
    for server in system.servers.values():
        server.load.arrival_rate *= 1.02
    _calc(system, lam_tolerance=0.05)
    solve_unlimited(system)
    assert len(system.fleet_dirty.dirty_pos) == 0
    assert _decisions(system) == before
    for n, s in system.servers.items():
        assert s.allocation is alloc_objs[n]
    for server in system.servers.values():
        server.load.arrival_rate *= 1.02
    _calc(system, lam_tolerance=0.0)
    solve_unlimited(system)
    assert len(system.fleet_dirty.dirty_pos) == len(system.servers)


def test_lambda_tolerance_max_age_reanchors():
    """Persistent sub-tolerance drift re-anchors after max_age_cycles; an
    identical λ never expires."""
    spec = fleet_system_spec(10, shapes_per_variant=1, tandem_every=0, zero_load_every=0,
                             pinned_every=0, infeasible_every=0)
    system = System(spec)
    kw = dict(lam_tolerance=0.10, max_age_cycles=3)
    _calc(system, **kw)
    solve_unlimited(system)
    for cycle in range(3):
        for server in system.servers.values():
            server.load.arrival_rate *= 1.01
        _calc(system, **kw)
        fd = system.fleet_dirty
        if cycle < 2:
            assert len(fd.dirty_pos) == 0, cycle
        else:
            assert set(fd.codes[fd.dirty_pos].tolist()) == {SCAN_RATE}
    for _ in range(5):
        _calc(system, **kw)
        assert len(system.fleet_dirty.dirty_pos) == 0


def test_greedy_incremental_bulk_recharge_and_binding_fallback(monkeypatch):
    """Limited mode: after an all-bulk cycle a dirty cycle re-charges the
    ledger from the persistent preferred columns (no candidate table
    built) with exact parity; a binding cycle falls back to the exact
    pass and emits the full path's degradations."""
    base = fleet_system_spec(40, shapes_per_variant=2, priority_classes=2, split_pools=True)
    cap = fleet_capacity(base, 4.0, device="cpu")  # loose: everyone fits
    reset_fleet_state()
    spec = dataclasses.replace(
        base, capacity=CapacitySpec(chips=cap), optimizer=OptimizerSpec(unlimited=False),
    )
    bulk = []
    real = fleet_incremental.try_greedy_bulk
    monkeypatch.setattr(
        fleet_incremental, "try_greedy_bulk",
        lambda *a: bulk.append(real(*a)) or bulk[-1],
    )
    system = System(spec)
    _calc(system)
    solve_greedy_fleet(system, spec.optimizer)  # full pass, records all-bulk
    assert bulk == [False] and not system.degradations
    _perturb(system, np.random.default_rng(3), 0.2)
    _calc(system)
    solve_greedy_fleet(system, spec.optimizer)
    assert bulk[-1] is True
    assert fleet_incremental._state.cands is None  # no candidate table built
    ref = _full(system, spec, limited=True)
    _assert_parity(_decisions(system), _decisions(ref), system.degradations, ref.degradations)
    tight = {pool: max(chips // 4, 1) for pool, chips in cap.items()}
    system.capacity = dict(tight)
    spec.capacity.chips = dict(tight)
    _calc(system)  # capacity change => all-dirty
    solve_greedy_fleet(system, spec.optimizer)
    assert bulk[-1] is False  # the exact pass ran
    assert system.degradations
    ref = _full(system, spec, limited=True)
    _assert_parity(_decisions(system), _decisions(ref), system.degradations, ref.degradations)


def test_unlimited_replay_materializes_only_dirty_servers():
    """On a persistent System a dirty cycle's unlimited solve re-applies
    only dirty servers' picks: the lazy views stay lazy (O(dirty servers)
    materializations, never O(lanes)), and clean allocations stand."""
    system = System(fleet_system_spec(60, shapes_per_variant=3))
    _calc(system)
    solve_unlimited(system)
    src = fleet_incremental._state.source
    before = src.materialized
    assert before <= len(system.servers)
    allocs0 = {n: s.allocation for n, s in system.servers.items()}
    _perturb(system, np.random.default_rng(8), 0.1)
    _calc(system)
    solve_unlimited(system)
    fd = system.fleet_dirty
    assert 0 < src.materialized - before <= len(fd.dirty_pos)
    dirty = {list(system.servers)[p] for p in fd.dirty_pos.tolist()}
    for name, server in system.servers.items():
        if name not in dirty:
            assert server.allocation is allocs0[name], name
    views = [s.all_allocations for s in system.servers.values()
             if isinstance(s.all_allocations, port_fleet.LaneAllocations)]
    assert views and all(v._src is not None for v in views)


def test_rotating_verification_covers_every_server(monkeypatch):
    """Above SCAN_FULL_SIG_LIMIT the scan runs on identity witnesses plus a
    rotating deep verification that WRAPS: any SCAN_VERIFY_CYCLES-long
    span re-verifies every server, and an in-place scalar edit is caught
    within it (the full-signature path is what every other test here
    runs)."""
    monkeypatch.setattr(snap_mod, "SCAN_FULL_SIG_LIMIT", 4)
    monkeypatch.setattr(snap_mod, "SCAN_VERIFY_CYCLES", 3)
    spec = fleet_system_spec(10, shapes_per_variant=1, tandem_every=0, zero_load_every=0,
                             pinned_every=0, infeasible_every=0)
    system = System(spec)
    _calc(system)
    per_cycle: list[set] = []
    real = snap_mod._structure_sig

    def spy(sys_, server):
        per_cycle[-1].add(server.name)
        return real(sys_, server)

    monkeypatch.setattr(snap_mod, "_structure_sig", spy)
    for _ in range(9):
        per_cycle.append(set())
        _calc(system)
    everyone = set(system.servers)
    for i in range(len(per_cycle) - 2):
        span = per_cycle[i] | per_cycle[i + 1] | per_cycle[i + 2]
        assert span == everyone, (i, everyone - span)
    victim = list(system.servers.values())[0]
    perf = next(iter(system.models[victim.model_name].perf_data.values()))
    perf.max_batch_size = max(perf.max_batch_size // 2, 8)
    caught = False
    for _ in range(3):
        per_cycle.append(set())
        _calc(system)
        if len(system.fleet_dirty.dirty_pos):
            caught = True
            break
    assert caught, "in-place edit never re-verified within the window"
    solve_unlimited(system)
    _assert_parity(_decisions(system), _decisions(_full(system, spec)))


def test_witness_path_token_change_on_replaced_servers(monkeypatch):
    """Above SCAN_FULL_SIG_LIMIT a replaced server object is re-verified,
    and a token-mix change found there re-solves its lanes on the NEW
    token columns — also after an earlier scan, when the token anchors
    are the arrays of the applied load (the reference edits them in place
    and solves such lanes on the old mix; the port copies them)."""
    import copy

    monkeypatch.setattr(snap_mod, "SCAN_FULL_SIG_LIMIT", 8)
    spec = fleet_system_spec(40, **FUZZ_SPEC)
    system = System(spec)
    _calc(system)
    solve_unlimited(system)
    rng = np.random.default_rng(8)
    _perturb(system, rng, 0.05)  # one scan on the witness path first
    _calc(system)
    solve_unlimited(system)
    loaded = [n for n, s in system.servers.items() if s.load.arrival_rate > 0]
    moved = [loaded[i] for i in rng.choice(len(loaded), 5, replace=False)]
    for name in moved:
        load = system.servers[name].load
        load.avg_in_tokens = float(rng.integers(16, 600))
        load.avg_out_tokens = float(rng.integers(8, 400))
        system.servers[name] = copy.copy(system.servers[name])
    _calc(system)
    solve_unlimited(system)
    fd = system.fleet_dirty
    assert {list(system.servers)[p] for p in fd.dirty_pos.tolist()} == set(moved)
    assert set(fd.codes[fd.dirty_pos].tolist()) == {SCAN_FULL}
    _assert_parity(_decisions(system), _decisions(_full(system, spec)))


def _refold_params(n: int, seed: int = 0) -> Q.FleetParams:
    rng = np.random.default_rng(seed)
    out = rng.integers(16, 384, n).astype(np.float32)
    mb = np.maximum((rng.integers(8, 61, n) * 128 // out).astype(np.int32), 1)
    return Q.FleetParams(
        alpha=rng.uniform(4, 20, n).astype(np.float32),
        beta=rng.uniform(0.1, 0.6, n).astype(np.float32),
        gamma=rng.uniform(1, 8, n).astype(np.float32),
        delta=rng.uniform(0.005, 0.04, n).astype(np.float32),
        in_tokens=rng.integers(32, 512, n).astype(np.float32),
        out_tokens=out,
        max_batch=mb,
        occupancy_cap=(mb * 5).astype(np.int32),
        target_ttft=np.full(n, 1500.0, np.float32),
        target_itl=np.full(n, 60.0, np.float32),
        target_tps=np.zeros(n, np.float32),
        total_rate=rng.uniform(0.5, 15, n).astype(np.float32),
        min_replicas=np.ones(n, np.int32),
        cost_per_replica=rng.uniform(20, 60, n).astype(np.float32),
    )


def _np(res):
    return Q.FleetResult(*(f.numpy() for f in res))


def test_refold_bit_parity_and_batch_invariance():
    """The refold reproduces the full program's fold outputs (replicas,
    cost) bit for bit, and both programs are batch-invariant: a lane's
    result does not depend on which lanes share its bucket or how wide
    the bucket is padded."""
    cpu = torch.device("cpu")
    n = 192
    params = _refold_params(n)
    full = _np(Q.fleet_size(Q.fleet_params_from_numpy(params, cpu), 512))
    p2 = params._replace(total_rate=(params.total_rate * 1.31).astype(np.float32))
    full2 = _np(Q.fleet_size(Q.fleet_params_from_numpy(p2, cpu), 512))
    refold = _np(Q.fleet_refold(
        Q.fleet_params_from_numpy(p2, cpu), 512, torch.from_numpy(full.lambda_star),
        torch.from_numpy(full.rate_star), torch.from_numpy(full.feasible),
    ))
    np.testing.assert_array_equal(refold.num_replicas, full2.num_replicas)
    np.testing.assert_array_equal(refold.cost, full2.cost)
    np.testing.assert_array_equal(refold.lambda_star, full.lambda_star)
    idx = np.arange(0, n, 7)
    psub = type(p2)(*(a[idx] for a in p2))
    sub = _np(Q.fleet_refold(
        Q.fleet_params_from_numpy(psub, cpu), 512, torch.from_numpy(full.lambda_star[idx]),
        torch.from_numpy(full.rate_star[idx]), torch.from_numpy(full.feasible[idx]),
    ))
    sub_full = _np(Q.fleet_size(Q.fleet_params_from_numpy(psub, cpu), 512))
    for field in sub._fields:
        np.testing.assert_array_equal(getattr(sub, field), getattr(refold, field)[idx],
                                      err_msg=field)
        np.testing.assert_array_equal(getattr(sub_full, field), getattr(full2, field)[idx],
                                      err_msg=field)


@pytest.fixture
def cuda_device():
    """The card, for `cuda`-marked tests; decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [128, 512, 2048])
def test_lane_results_independent_of_bucket_width_on_card(k, cuda_device):
    """On the card, through both kernels: a lane sized in a wide bucket and
    in a narrow one (other neighbours, other padded width) gets the same
    bits — the property an incremental cycle's bit parity rests on."""
    n = 4096
    params = _refold_params(n, seed=k)
    params = params._replace(max_batch=np.minimum(params.max_batch * (k // 128), k)
                             .astype(np.int32))
    params = params._replace(occupancy_cap=(params.max_batch * 5).astype(np.int32))
    idx = np.arange(3, n, 97)
    sub = port_fleet.pad_params_rows(type(params)(*(a[idx] for a in params)), 64)
    wide = Q.fleet_size(Q.fleet_params_from_numpy(params, cuda_device), k, use_kernel=True)
    narrow = Q.fleet_size(Q.fleet_params_from_numpy(sub, cuda_device), k, use_kernel=True)
    torch.cuda.synchronize()
    for field in ("feasible", "lambda_star", "rate_star", "num_replicas", "cost"):
        a = getattr(wide, field).cpu().numpy()[idx]
        b = getattr(narrow, field).cpu().numpy()[: len(idx)]
        np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("kind", ["agg", "tan"])
def test_solve_slots_mixes_full_and_refold_buckets(kind):
    """One dispatch over full and refold buckets: each bucket's lanes equal
    a direct call of its program on the same lanes, and padding (row 0
    repeated) never leaks into the real lanes."""
    cpu = torch.device("cpu")
    system = System(fleet_system_spec(40, shapes_per_variant=2))
    plan = (port_fleet.build_fleet(system) if kind == "agg"
            else port_fleet.build_tandem_fleet(system))
    p = plan.params
    batches = (p.max_batch if kind == "agg" else np.maximum(p.prefill_batch, p.decode_batch))
    plans = (plan, None) if kind == "agg" else (None, plan)
    full = port_fleet._solve_all(*plans, cpu, Q.DEFAULT_BISECT_ITERS, False)[kind == "tan"]
    half = np.arange(0, plan.num_lanes, 2)
    rest = np.arange(1, plan.num_lanes, 2)
    slots: list = []
    sub = lambda rows: type(p)(*(np.asarray(a)[rows] for a in p))  # noqa: E731
    port_fleet.add_bucketed(slots, kind, sub(half), batches[half], half)
    port_fleet.add_bucketed(
        slots, kind, sub(rest), batches[rest], rest,
        (full.lambda_star[rest], full.rate_star[rest], full.feasible[rest]),
    )
    packed = port_fleet.solve_slots(slots, cpu, Q.DEFAULT_BISECT_ITERS, False)
    seen = np.zeros(plan.num_lanes, bool)
    for slot, res in port_fleet.iter_slot_results(slots, packed):
        seen[slot.idx] = True
        for field in ("feasible", "lambda_star", "rate_star", "num_replicas", "cost"):
            np.testing.assert_array_equal(
                getattr(res, field), getattr(full, field)[slot.idx], err_msg=field)
    assert seen.all()


# -- event-authoritative scan -----------------------------------------------


def _warm(n=60, shapes=2):
    spec = fleet_system_spec(n, shapes_per_variant=shapes)
    system = System(spec)
    _calc(system)
    solve_unlimited(system)
    return spec, system, list(system.servers)


def test_event_scan_reads_only_named_servers():
    rng = np.random.default_rng(20)
    spec, system, names = _warm()
    moved = []
    for name in (names[3], names[17], names[41]):
        load = system.servers[name].load
        if load is not None and load.arrival_rate > 0:
            load.arrival_rate *= float(rng.uniform(1.2, 1.6))
            moved.append(name)
    assert moved
    _calc(system, event_dirty=moved)
    solve_unlimited(system)
    fd = system.fleet_dirty
    assert fd.scanned_servers == len(moved)  # NOT the fleet
    assert fd.skipped_servers == len(names) - len(fd.dirty_pos)
    assert {names[p] for p in fd.dirty_pos.tolist()} == set(moved)
    _assert_parity(_decisions(system), _decisions(_full(system, spec)))


def test_event_scan_empty_set_replays_everything():
    _, system, _ = _warm()
    allocs0 = {n: s.allocation for n, s in system.servers.items()}
    _calc(system, event_dirty=[])
    solve_unlimited(system)
    fd = system.fleet_dirty
    assert fd.scanned_servers == 0 and len(fd.dirty_pos) == 0
    for name, server in system.servers.items():
        assert server.allocation is allocs0[name], name


@pytest.mark.parametrize("fault", ["unknown_name", "token_mix"])
def test_event_scan_unprovable_claim_falls_back_to_full_scan(fault):
    """A name the table never saw (membership changed under the event
    source) or a token-mix change on a named server routes the cycle
    through the poll scan: extra work, never a wrong verdict."""
    spec, system, names = _warm()
    load = system.servers[names[7]].load
    load.arrival_rate *= 1.4
    dirty = [names[7]]
    if fault == "unknown_name":
        dirty.append("ghost:nowhere")
    else:
        load.avg_out_tokens += 32.0
    _calc(system, event_dirty=dirty)
    solve_unlimited(system)
    assert system.fleet_dirty.scanned_servers == len(names)
    _assert_parity(_decisions(system), _decisions(_full(system, spec)))


def test_event_scan_lambda_tolerance_anchors():
    _, system, names = _warm()
    target = next(n for n in names if system.servers[n].load.arrival_rate > 0)
    alloc0 = system.servers[target].allocation
    load = system.servers[target].load
    anchor = load.arrival_rate
    load.arrival_rate = anchor * 1.01  # inside a 5% tolerance
    _calc(system, event_dirty=[target], lam_tolerance=0.05)
    solve_unlimited(system)
    fd = system.fleet_dirty
    assert len(fd.dirty_pos) == 0 and fd.scanned_servers == 1
    assert system.servers[target].allocation is alloc0
    load.arrival_rate = anchor * 1.2  # past the tolerance: RATE
    _calc(system, event_dirty=[target], lam_tolerance=0.05)
    solve_unlimited(system)
    assert {names[p] for p in system.fleet_dirty.dirty_pos.tolist()} == {target}


def test_event_scan_missed_event_caught_by_next_full_scan():
    spec, system, names = _warm()
    silent = next(n for n in names if system.servers[n].load.arrival_rate > 0)
    system.servers[silent].load.arrival_rate *= 1.5
    _calc(system, event_dirty=[])
    solve_unlimited(system)
    assert len(system.fleet_dirty.dirty_pos) == 0  # drift, by design
    _calc(system)
    solve_unlimited(system)
    assert {names[p] for p in system.fleet_dirty.dirty_pos.tolist()} == {silent}
    _assert_parity(_decisions(system), _decisions(_full(system, spec)))


def test_event_cycle_equals_poll_cycle():
    """The same λ moves, once reported as events and once found by the
    poll scan (each run from a fresh state on its own copy of the fleet):
    identical decisions, cycle after cycle, with the event runs reading
    only the named servers."""
    spec = fleet_system_spec(48, **FUZZ_SPEC)

    def run(events: bool) -> list:
        reset_fleet_state()
        system = System(SystemSpec.from_dict(spec.to_dict()))
        names = list(system.servers)
        rng = np.random.default_rng(9)
        out = []
        for cycle in range(6):
            moved = []
            if cycle:
                for i in rng.choice(len(names), 4, replace=False):
                    load = system.servers[names[i]].load
                    if load.arrival_rate > 0:
                        load.arrival_rate *= float(rng.uniform(0.5, 1.8))
                        moved.append(names[i])
            _calc(system, event_dirty=moved if events and cycle else None)
            solve_unlimited(system)
            if events and cycle:
                assert system.fleet_dirty.scanned_servers == len(moved)
            out.append(_decisions(system))
        return out

    assert run(events=True) == run(events=False)


# -- the port against the JAX reference --------------------------------------


def test_incremental_cycles_match_reference():
    """Both packages run their incremental paths over the same mutations
    of carried-across specs; after every cycle the decisions agree under
    the round's rule (feasibility and picks exact, replicas ±1 only on a
    ceil boundary, cost/value within 1e-5)."""
    from inferno_tpu.core import System as RefSystem
    from inferno_tpu.parallel import calculate_fleet as ref_calculate_fleet
    from inferno_tpu.parallel import reset_fleet_state as ref_reset_fleet_state
    from inferno_tpu.solver.solver import solve_unlimited as ref_solve_unlimited
    from inferno_tpu.testing.fleet import fleet_system_spec as ref_fleet_system_spec

    ref_spec = ref_fleet_system_spec(36, **FUZZ_SPEC)
    ref_reset_fleet_state()
    try:
        ref = RefSystem(ref_spec)
        port = System(SystemSpec.from_dict(ref_spec.to_dict()))
        rng_ref, rng_port = np.random.default_rng(7), np.random.default_rng(7)
        boundary = 0
        for cycle in range(8):
            if cycle:
                _mutate(ref, rng_ref)
                _mutate(port, rng_port)
            ref_calculate_fleet(ref, backend="jax")
            ref_solve_unlimited(ref)
            _calc(port)
            solve_unlimited(port)
            assert port.fleet_dirty is not None and ref.fleet_dirty is not None
            np.testing.assert_array_equal(port.fleet_dirty.codes, ref.fleet_dirty.codes)
            boundary += assert_same_decisions(ref, port)
        assert boundary <= 3
    finally:
        ref_reset_fleet_state()


# -- the lane mesh on the incremental path ------------------------------------


def _sharded_cycles(spec, mesh) -> list:
    """Cold, 1% λ, a token-mix change on three servers, then λ again:
    each cycle's decision surface and dirty counts."""
    reset_fleet_state()
    system = System(SystemSpec.from_dict(spec.to_dict()))
    rng = np.random.default_rng(11)
    names = list(system.servers)
    out = []
    for step in ("cold", "rate", "structure", "rate"):
        if step == "rate":
            _perturb(system, rng, 0.01)
        elif step == "structure":
            for i in rng.choice(len(names), 3, replace=False):
                load = system.servers[names[i]].load
                if load is not None:
                    load.avg_in_tokens = float(rng.integers(16, 600))
        _calc(system, mesh=mesh)
        solve_unlimited(system)
        d = system.fleet_dirty
        out.append((_decisions(system), d.dirty_lanes, d.refold_lanes, d.codes.tolist()))
    return out


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_sharded_incremental_cycles_bit_identical(m):
    """shards ≡ single on the incremental path (aggregated and tandem
    lanes): every cycle's decision surface, operating point included, is
    the same bits over `m` CPU shards as unsharded, with the same dirty
    lanes (the counterpart of tests/test_incremental.py:530-560)."""
    from inferno_tpu_torch.parallel import fleet_mesh

    spec = fleet_system_spec(200, **FUZZ_SPEC)
    want = _sharded_cycles(spec, None)
    assert want[1][2] > 0 and want[2][1] > 0  # a refold cycle, a full-program cycle
    assert _sharded_cycles(spec, fleet_mesh(devices=["cpu"] * m)) == want


def test_new_mesh_rebuilds_the_state():
    """A different mesh object rebuilds the incremental state (every lane
    dirty), as a different backend or device does; the same mesh replays."""
    from inferno_tpu_torch.parallel import fleet_mesh

    system = System(fleet_system_spec(30, **FUZZ_SPEC))
    two, four = fleet_mesh(devices=["cpu"] * 2), fleet_mesh(devices=["cpu"] * 4)
    _calc(system, mesh=two)
    lanes = system.fleet_dirty.dirty_lanes
    assert lanes > 0
    _calc(system, mesh=two)
    assert system.fleet_dirty.dirty_lanes == 0
    _calc(system, mesh=four)
    assert fleet_incremental._state.mesh is four
    assert system.fleet_dirty.dirty_lanes == lanes
