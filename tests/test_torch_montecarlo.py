"""The port's Monte Carlo seed-axis solve and envelope planner
(inferno_tpu_torch.planner.montecarlo) on the CPU.

Inside the port, bit for bit (the counterparts of tests/test_montecarlo.py):
[seeds, T, S] in one call ≡ S per-seed calls ≡ the serial loop, chunking
invariant across seed boundaries, consume ≡ materialized, the zero-load
table pinned to the transition basis of prepare time, and every envelope
input equal to `aggregate_replay` of the same seed's trace.

Against the JAX reference, with the rates of one numpy seed: the seed
axis under the port's rule (`testing.fleet.assert_same_batch`: choices
exactly, replicas ±1 only on a ceil boundary whose rate_star agrees
within 1e-4, every other column exactly), and the Monte Carlo report
documents equal where the two surfaces show no boundary cell.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from inferno_tpu.core import System as RefSystem
from inferno_tpu.parallel import reset_fleet_state as ref_reset_fleet_state
from inferno_tpu.testing.fleet import fleet_system_spec as ref_fleet_system_spec
from inferno_tpu_torch.config.types import CapacitySpec
from inferno_tpu_torch.core import System
from inferno_tpu_torch.parallel import (
    calculate_fleet,
    calculate_fleet_batch,
    prepare_fleet_batch,
    reset_fleet_state,
)
from inferno_tpu_torch.solver.solver import solve_unlimited
from inferno_tpu_torch.testing.fleet import (
    assert_same_batch,
    fleet_capacity,
    fleet_system_spec,
)
from test_torch_planner import (
    BATCH_FIELDS,
    CPU,
    REF,
    base_rates,
    both_batches,
    port_spec,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_fleet_state():
    reset_fleet_state()
    ref_reset_fleet_state()
    yield
    reset_fleet_state()
    ref_reset_fleet_state()


def _seeded_ensemble_rates(system, seeds, steps, zero_rows=True):
    rng = np.random.default_rng(11)
    base = base_rates(system)
    rates = base[None, None, :] * rng.uniform(0.0, 2.5, size=(seeds, steps, len(base)))
    if zero_rows:
        rates[rates < 20.0] = 0.0
    return rates


def test_seed_axis_bit_identical_to_per_seed_and_serial():
    spec = fleet_system_spec(25, shapes_per_variant=2)
    system = System(spec)
    rates = _seeded_ensemble_rates(system, 3, 4)
    ensemble = calculate_fleet_batch(system, rates, **CPU)
    assert ensemble.choice.shape == rates.shape
    for k in range(3):
        per_seed = calculate_fleet_batch(system, rates[k], **CPU)
        for field in BATCH_FIELDS:
            np.testing.assert_array_equal(
                getattr(ensemble, field)[k], getattr(per_seed, field),
                err_msg=f"seed {k} field {field}")

    acc_idx = {a: i for i, a in enumerate(sorted(system.accelerators))}
    reset_fleet_state()
    oracle = System(spec)
    for k in range(3):
        for t in range(4):
            for j, server in enumerate(oracle.servers.values()):
                if server.load is not None:
                    server.load.arrival_rate = float(rates[k, t, j])
            calculate_fleet(oracle, **CPU)
            solve_unlimited(oracle)
            for j, server in enumerate(oracle.servers.values()):
                a = server.allocation
                got = ((-1, 0) if a is None or not a.accelerator
                       else (acc_idx[a.accelerator], a.num_replicas))
                want = (int(ensemble.choice[k, t, j]), int(ensemble.replicas[k, t, j]))
                assert got == want, f"seed {k} step {t} server {j}"


@pytest.mark.parametrize("chunk", [1, 3, 5, 7])
def test_chunking_invariance_across_seed_boundaries(chunk):
    system = System(fleet_system_spec(16, shapes_per_variant=2))
    rates = _seeded_ensemble_rates(system, 4, 5)
    full = calculate_fleet_batch(system, rates, chunk_steps=4 * 5, **CPU)
    other = calculate_fleet_batch(system, rates, chunk_steps=chunk, **CPU)
    for field in BATCH_FIELDS:
        np.testing.assert_array_equal(
            getattr(full, field), getattr(other, field),
            err_msg=f"chunk {chunk} field {field}")


def test_zero_load_seed_shortcut():
    system = System(fleet_system_spec(14, shapes_per_variant=2))
    rates = _seeded_ensemble_rates(system, 3, 4, zero_rows=False)
    rates[1] = 0.0
    ensemble = calculate_fleet_batch(system, rates, **CPU)
    standalone = calculate_fleet_batch(system, np.zeros_like(rates[1]), **CPU)
    for field in BATCH_FIELDS:
        np.testing.assert_array_equal(
            getattr(ensemble, field)[1], getattr(standalone, field), err_msg=field)
    assert (ensemble.choice[1] >= 0).any()


@pytest.mark.parametrize("shapes", [1, 2])
def test_consume_mode_matches_materialized(shapes):
    system = System(fleet_system_spec(15, shapes_per_variant=shapes))
    rates = _seeded_ensemble_rates(system, 2, 6)
    flat = rates.reshape(-1, len(system.servers))
    prep = prepare_fleet_batch(system, **CPU)
    assert prep.all_seg1 == (shapes == 1)
    materialized = prep.solve(rates)
    got = {f: np.zeros_like(getattr(materialized, f).reshape(flat.shape[0], -1))
           for f in BATCH_FIELDS}

    def consume(slab):
        for f in BATCH_FIELDS:
            got[f][slab.row0 : slab.row0 + slab.rows] = getattr(slab, f)
        assert slab.lane_reps is not None
        assert slab.rates.shape == (slab.rows, len(system.servers))

    assert prep.solve(rates, consume=consume, chunk_steps=5) is None
    for f in BATCH_FIELDS:
        np.testing.assert_array_equal(
            got[f].reshape(getattr(materialized, f).shape),
            getattr(materialized, f), err_msg=f)

    seen = {}

    def consume_subset(slab):
        assert slab.value is None and slab.choice is None
        seen.setdefault("cost", []).append(slab.cost.copy())
        seen.setdefault("chips", []).append(slab.chips.copy())

    prep.solve(rates, consume=consume_subset, needs=("cost", "chips"), chunk_steps=7)
    np.testing.assert_array_equal(
        np.concatenate(seen["cost"]).reshape(materialized.cost.shape),
        materialized.cost)
    np.testing.assert_array_equal(
        np.concatenate(seen["chips"]).reshape(materialized.chips.shape),
        materialized.chips)
    with pytest.raises(ValueError, match="unknown batch outputs"):
        prep.solve(rates, consume=consume_subset, needs=("nope",))
    with pytest.raises(ValueError, match="requires"):
        prep.solve(rates, needs=("cost",))


def test_binding_flush_boundary_is_invisible(monkeypatch):
    from inferno_tpu_torch.planner import montecarlo
    from inferno_tpu_torch.planner.montecarlo import replay_montecarlo

    spec = fleet_system_spec(15, shapes_per_variant=1, priority_classes=2,
                             split_pools=True)
    usage = fleet_capacity(spec, 1.0, **CPU)
    reset_fleet_state()
    spec.capacity = CapacitySpec(
        chips={p: max(int(c * 0.5), 1) for p, c in usage.items()})
    system = System(spec)
    baseline = replay_montecarlo(system, "diurnal", 8, 3600.0, seeds=3,
                                 per_seed=True, **CPU)
    assert baseline["binding_rows"] > 4
    monkeypatch.setattr(montecarlo, "BINDING_FLUSH_ROWS", 4)
    reset_fleet_state()
    flushed = replay_montecarlo(system, "diurnal", 8, 3600.0, seeds=3,
                                per_seed=True, **CPU)
    baseline.pop("profile"), flushed.pop("profile")
    assert flushed == baseline


def test_prep_zero_table_pins_init_transition_basis():
    """The lazily built zero-load table uses the current allocations
    captured at prepare time, even when a reconcile replaced them before
    the first zero-rate cell forced the build."""
    spec = fleet_system_spec(10, shapes_per_variant=1)
    reference_sys = System(spec)
    zeros = np.zeros((2, len(reference_sys.servers)))
    reference = calculate_fleet_batch(reference_sys, zeros, **CPU)

    reset_fleet_state()
    system = System(spec)
    prep = prepare_fleet_batch(system, **CPU)
    for server in system.servers.values():
        server.cur_allocation = dataclasses.replace(
            server.cur_allocation, cost=server.cur_allocation.cost + 500.0)
    got = prep.solve(zeros)
    for field in BATCH_FIELDS:
        np.testing.assert_array_equal(
            getattr(got, field), getattr(reference, field), err_msg=field)


def test_batch_still_rejects_bad_rates_with_seed_axis():
    system = System(fleet_system_spec(5, shapes_per_variant=1))
    n = len(system.servers)
    with pytest.raises(ValueError, match="server order"):
        calculate_fleet_batch(system, np.ones((2, 2, 3)), **CPU)
    with pytest.raises(ValueError, match="server order"):
        calculate_fleet_batch(system, np.ones((2, 2, 2, n)), **CPU)
    with pytest.raises(ValueError, match="finite"):
        calculate_fleet_batch(system, -np.ones((1, 2, n)), **CPU)


@pytest.mark.parametrize("shapes,capacity", [(1, None), (2, 0.6), (1, 0.6)])
def test_envelopes_exactly_match_per_seed_aggregation(shapes, capacity):
    from inferno_tpu_torch.planner.montecarlo import replay_montecarlo
    from inferno_tpu_torch.planner.replay import replay_scenario
    from inferno_tpu_torch.planner.scenarios import (
        GENERATORS,
        base_rates_from_system,
        ensemble_seeds,
    )

    spec = fleet_system_spec(18, shapes_per_variant=shapes, priority_classes=3,
                             split_pools=True)
    if capacity is not None:
        usage = fleet_capacity(spec, 1.0, **CPU)
        reset_fleet_state()
        spec.capacity = CapacitySpec(
            chips={p: max(int(c * capacity), 1) for p, c in usage.items()},
            quotas={"gen0/r0": max(int(usage["gen0"] * 0.3), 1)})
    system = System(spec)
    seeds = 4
    mc = replay_montecarlo(system, "diurnal", 10, 3600.0, seeds=seeds, base_seed=3,
                           per_seed=True, keep_seeds=(0, 2), **CPU)
    base = base_rates_from_system(system)
    any_bound = 0
    for k, seed in enumerate(ensemble_seeds("diurnal", 3, seeds)):
        trace = GENERATORS["diurnal"](base, 10, 3600.0, seed=seed)
        serial = replay_scenario(system, trace, **CPU)["reactive"]
        for pool, stats in serial["pools"].items():
            kept = mc["pools"][pool]["per_seed"]
            assert kept["peak"][k] == stats["peak"], (pool, k)
            assert kept["p95"][k] == stats["p95"], (pool, k)
            assert kept["mean"][k] == stats["mean"], (pool, k)
            if "first_bind_step" in stats:
                assert kept["first_bind_step"][k] == stats["first_bind_step"]
        for key, stats in serial["quotas"].items():
            kept = mc["quotas"][key]["per_seed"]
            assert kept["peak"][k] == stats["peak"], (key, k)
            assert kept["first_bind_step"][k] == stats["first_bind_step"]
        assert mc["per_seed"]["violation_seconds"][k] == serial["violation_seconds"]
        assert mc["per_seed"]["cost_total_usd"][k] == serial["cost"]["total_usd"]
        if serial["binding_steps"] > 0:
            any_bound += 1
        if k in (0, 2):
            res = calculate_fleet_batch(system, trace.rates, **CPU)
            np.testing.assert_array_equal(mc["_kept"][k]["choice"], res.choice)
            np.testing.assert_array_equal(mc["_kept"][k]["replicas"], res.replicas)
    assert mc["tail_risk"]["first_bind_probability"] == any_bound / seeds
    if capacity is not None:
        assert mc["violation_seconds"]["max"] > 0 and mc["binding_rows"] > 0
    else:
        assert mc["violation_seconds"]["max"] == 0.0 and mc["binding_rows"] == 0


def test_envelope_shape_and_ordering():
    from inferno_tpu_torch.planner.montecarlo import (
        percentile_envelope,
        replay_montecarlo,
    )

    env = percentile_envelope([3.0, 1.0, 2.0, 10.0])
    assert env["p50"] <= env["p95"] <= env["p99"] <= env["max"] == 10.0
    assert percentile_envelope([]) == {"p50": 0.0, "p95": 0.0, "p99": 0.0, "max": 0.0}
    system = System(fleet_system_spec(10, shapes_per_variant=1))
    mc = replay_montecarlo(system, "flash_crowd", 6, 3600.0, seeds=3,
                           include_series=True, **CPU)
    for block in mc["pools"].values():
        series = block["envelope_series"]
        assert set(series) == {"p50", "p95", "p99", "max"}
        assert all(len(v) == 6 for v in series.values())
        for t in range(6):
            assert series["p50"][t] <= series["p95"][t] <= series["max"][t]
    env = mc["cost"]["total_usd"]
    assert env["p50"] <= env["p95"] <= env["p99"] <= env["max"]


def test_percentile_envelope_matches_reference():
    from inferno_tpu.planner.montecarlo import percentile_envelope as ref_env
    from inferno_tpu_torch.planner.montecarlo import percentile_envelope

    values = list(np.random.default_rng(4).exponential(3.0, size=37))
    assert percentile_envelope(values) == ref_env(values)


def test_ensemble_seed_derivation_matches_reference():
    from inferno_tpu.planner.scenarios import ensemble_seeds as ref_ensemble_seeds
    from inferno_tpu_torch.planner.scenarios import (
        GENERATORS,
        build_scenarios,
        ensemble_seeds,
    )

    base = np.asarray([60.0, 120.0, 240.0])
    for name in GENERATORS:
        members = ensemble_seeds(name, 7, 3)
        assert members == ref_ensemble_seeds(name, 7, 3)
        single = build_scenarios([name], base, 4, 3600.0, seed=7)[0]
        member0 = GENERATORS[name](base, 4, 3600.0, seed=members[0])
        np.testing.assert_array_equal(single.rates, member0.rates)
    all_seeds = [s for name in GENERATORS for s in ensemble_seeds(name, 7, 5)]
    assert len(all_seeds) == len(set(all_seeds))
    with pytest.raises(ValueError, match="unknown scenario"):
        ensemble_seeds("nope", 0, 2)


def test_seed_axis_matches_reference():
    """An 8-seed ensemble of the edge fleet, one numpy seed for both
    packages, under the port's rule."""
    ref_spec = ref_fleet_system_spec(
        100, shapes_per_variant=3, tandem_every=5, zero_load_every=7,
        pinned_every=11, infeasible_every=13)
    rates = _seeded_ensemble_rates(RefSystem(ref_spec), 8, 6)
    ref_prep, ref_res, port_prep, port_res = both_batches(ref_spec, rates, chunk_steps=7)
    assert port_res.choice.shape == rates.shape
    boundary = assert_same_batch(ref_prep, ref_res, port_prep, port_res)
    assert boundary <= rates.size // 100


MC_CASES = [("flash_crowd", None), ("diurnal", 0.6)]


def _mc_ref_spec(capacity):
    """The 40-variant, two-shape fleet whose Monte Carlo surfaces agree
    cell for cell between the packages, optionally with pool budgets at
    `capacity` of its unlimited use and one quota."""
    from inferno_tpu.config.types import CapacitySpec as RefCapacitySpec
    from inferno_tpu.testing.fleet import fleet_capacity as ref_fleet_capacity

    ref_spec = ref_fleet_system_spec(40, shapes_per_variant=2, priority_classes=3,
                                     split_pools=True)
    if capacity is not None:
        usage = ref_fleet_capacity(ref_spec, 1.0, backend="jax")
        ref_reset_fleet_state()
        ref_spec.capacity = RefCapacitySpec(
            chips={p: max(int(c * capacity), 1) for p, c in usage.items()},
            quotas={"gen1/r1": max(int(usage["gen1"] * 0.3), 1)})
    return ref_spec


def _mc_doc(system, scenario, replay, **kw):
    """One Monte Carlo document of the test fleet, without its profile."""
    doc = replay(system, scenario, 24, 3600.0, seeds=6, base_seed=2, per_seed=True,
                 include_series=True, **kw)
    doc.pop("profile")
    return doc


@pytest.mark.parametrize("scenario,capacity", MC_CASES)
def test_montecarlo_report_matches_reference(scenario, capacity):
    """The whole Monte Carlo document (envelopes, tail risk, per-seed
    scalars) equals the reference's, on a fleet whose surfaces agree
    cell for cell."""
    from inferno_tpu.planner.montecarlo import replay_montecarlo as ref_replay_mc
    from inferno_tpu_torch.planner.montecarlo import replay_montecarlo

    ref_spec = _mc_ref_spec(capacity)
    port = _mc_doc(System(port_spec(ref_spec)), scenario, replay_montecarlo, **CPU)
    ref = _mc_doc(RefSystem(ref_spec), scenario, ref_replay_mc, **REF)
    assert port.pop("backend") == "torch" and ref.pop("backend") == "jax"
    assert port == ref


@pytest.mark.parametrize("scenario,capacity", MC_CASES)
def test_montecarlo_mesh_equals_unsharded(scenario, capacity):
    """`replay_montecarlo(mesh=)` splits the prep's grid solve over four
    devices; the report is the unsharded one, bit for bit, and the prep
    holds the mesh (SIZING_SHARDS does not apply to the prep)."""
    from inferno_tpu_torch.parallel import fleet, fleet_mesh
    from inferno_tpu_torch.planner.montecarlo import replay_montecarlo

    spec = port_spec(_mc_ref_spec(capacity))
    mesh = fleet_mesh(devices=["cpu"] * 4)
    preps = []
    real_init = fleet.FleetBatchPrep.__init__

    def init(prep, *args, **kwargs):
        real_init(prep, *args, **kwargs)
        preps.append(prep)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fleet.FleetBatchPrep, "__init__", init)
        single = _mc_doc(System(spec), scenario, replay_montecarlo, **CPU)
        reset_fleet_state()
        sharded = _mc_doc(System(spec), scenario, replay_montecarlo, mesh=mesh, **CPU)
    assert [p.mesh for p in preps] == [None, mesh]
    assert sharded == single


@pytest.mark.parametrize("scenario,capacity", MC_CASES)
def test_montecarlo_sharded_report_matches_reference(scenario, capacity):
    """The port's report over four devices equals the reference's over
    four of its (host) devices: the whole document, as unsharded."""
    from inferno_tpu.parallel.mesh import fleet_mesh as ref_fleet_mesh
    from inferno_tpu.planner.montecarlo import replay_montecarlo as ref_replay_mc
    from inferno_tpu_torch.parallel import fleet_mesh
    from inferno_tpu_torch.planner.montecarlo import replay_montecarlo

    ref_spec = _mc_ref_spec(capacity)
    port = _mc_doc(System(port_spec(ref_spec)), scenario, replay_montecarlo,
                   mesh=fleet_mesh(devices=["cpu"] * 4), **CPU)
    ref = _mc_doc(RefSystem(ref_spec), scenario, ref_replay_mc, mesh=ref_fleet_mesh(4), **REF)
    assert port.pop("backend") == "torch" and ref.pop("backend") == "jax"
    assert port == ref


def test_planner_cli_montecarlo_and_survival_gate(tmp_path):
    from inferno_tpu_torch.planner.__main__ import main

    out = tmp_path / "mc.json"
    rc = main(["--variants", "12", "--steps", "6", "--shapes", "1",
               "--scenarios", "flash_crowd", "--backend", "torch", "--device", "cpu",
               "--seeds", "4", "--capacity-fraction", "0.5",
               "--survival-percentile", "99", "--out", str(out)])
    assert rc == 3
    report = json.loads(out.read_text())
    assert report["seeds"] == 4
    gate = report["survival_gate"]
    assert gate["pass"] is False and gate["failures"]
    failure = gate["failures"][0]
    assert failure["survival_fraction"] < 0.99
    assert failure["p99_peak_chips"] > failure["budget_chips"]
    block = report["scenarios"][0]
    assert block["scenario"] == "flash_crowd"
    assert set(block["violation_seconds"]) >= {"p50", "p95", "p99", "max"}

    reset_fleet_state()
    out2 = tmp_path / "mc-ok.json"
    rc = main(["--variants", "12", "--steps", "6", "--shapes", "1",
               "--scenarios", "diurnal", "--backend", "torch", "--device", "cpu",
               "--seeds", "3", "--capacity-fraction", "50.0",
               "--survival-percentile", "99", "--out", str(out2)])
    assert rc == 0
    assert json.loads(out2.read_text())["survival_gate"]["pass"] is True


def test_planner_cli_montecarlo_flag_validation(monkeypatch):
    from inferno_tpu_torch.planner.__main__ import main

    with pytest.raises(SystemExit, match="survival-percentile needs"):
        main(["--variants", "4", "--survival-percentile", "99"])
    with pytest.raises(SystemExit, match="no seed axis"):
        main(["--trace", "/nonexistent", "--seeds", "4"])
    with pytest.raises(SystemExit, match="not supported with --seeds"):
        main(["--variants", "4", "--seeds", "4", "--forecast"])
    with pytest.raises(SystemExit, match="must be in"):
        main(["--variants", "4", "--seeds", "4", "--survival-percentile", "0"])
    with pytest.raises(SystemExit, match="must be >= 0"):
        main(["--variants", "4", "--seeds", "-2"])
    monkeypatch.setenv("PLANNER_SEEDS", "-1")
    with pytest.raises(SystemExit, match="must be >= 0"):
        main(["--variants", "4"])
    monkeypatch.setenv("PLANNER_SEEDS", "x")
    with pytest.raises(SystemExit, match="not an integer"):
        main(["--variants", "4"])


def test_perfdiff_names_montecarlo_phase():
    from inferno_tpu_torch.obs.perfdiff import compare, metrics_from_bench_full

    base = metrics_from_bench_full({"montecarlo": {
        "mc_week_ms": 4000.0, "mc_week_ms_spread": 50.0, "mc_cold_ms": 5500.0}})
    assert base["mc_week_ms"]["value"] == 4000.0
    assert base["mc_week_ms"]["spread"] == 50.0
    assert "mc_cold_ms" not in base
    cand = metrics_from_bench_full({"montecarlo": {
        "mc_week_ms": 9000.0, "mc_cold_ms": 15000.0}})
    assert compare(base, cand)["regressions"] == ["mc_week_ms"]


def test_perfdiff_reads_the_ports_cycle_profiles(tmp_path):
    """perfdiff sniffs the port's own profile documents (the reference's
    schema) and flags a doubled phase."""
    from inferno_tpu_torch.obs import perfdiff
    from inferno_tpu_torch.obs.profiler import PROFILE_SCHEMA

    def doc(solve_ms):
        return {"cycles": [{"schema": PROFILE_SCHEMA, "cycle_ms": solve_ms + 10.0,
                            "phases": {"solve": {"wall_ms": solve_ms}},
                            "counters": {}} for _ in range(3)]}

    (tmp_path / "a.json").write_text(json.dumps(doc(100.0)))
    (tmp_path / "b.json").write_text(json.dumps(doc(300.0)))
    assert perfdiff.main([str(tmp_path / "a.json"), str(tmp_path / "a.json")]) == 0
    assert perfdiff.main([str(tmp_path / "a.json"), str(tmp_path / "b.json")]) == 2
