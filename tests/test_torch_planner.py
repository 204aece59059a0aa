"""The port's batched time-axis solve and planner (inferno_tpu_torch.parallel.
calculate_fleet_batch, inferno_tpu_torch.planner) on the CPU.

Inside the port, the reference's own bit-exact contracts hold bit for bit
(the counterparts of tests/test_planner.py): T=1 ≡ `calculate_fleet` +
`solve_unlimited`, multi-T ≡ the serial loop, chunk placement never
changes a result, and a prep over the live System between two incremental
cycles leaves the next cycle ≡ a full pass.

Against the JAX reference (`backend="jax"`), the same rates from one
numpy seed go through both packages and are held to `testing.fleet.
assert_same_batch`: choices and feasibility exactly; replicas exactly,
except ±1 where the chosen lane's rate_star agrees within 1e-4 relative
(a ceil boundary); chips, cost (f32), value (f64) and the spot columns
exactly off those boundary cells, since both sides compute them with
the same host arithmetic from equal replica counts. Scenario
generators' rates are bit-identical, and planner reports are equal on
fleets whose batch surfaces show no boundary cell.
"""

import json

import numpy as np
import pytest
import torch

from inferno_tpu.core import System as RefSystem
from inferno_tpu.parallel import prepare_fleet_batch as ref_prepare_fleet_batch
from inferno_tpu.parallel import reset_fleet_state as ref_reset_fleet_state
from inferno_tpu.testing.fleet import fleet_system_spec as ref_fleet_system_spec
from inferno_tpu_torch.config.types import SystemSpec
from inferno_tpu_torch.core import System
from inferno_tpu_torch.parallel import (
    calculate_fleet,
    calculate_fleet_batch,
    prepare_fleet_batch,
    reset_fleet_state,
)
from inferno_tpu_torch.parallel import snapshot as port_snapshot
from inferno_tpu_torch.solver.solver import solve_unlimited
from inferno_tpu_torch.testing.fleet import assert_same_batch, fleet_system_spec

CPU = dict(backend="torch", device="cpu")
REF = dict(backend="jax")
BATCH_FIELDS = ("choice", "replicas", "chips", "cost", "value")
EDGE = dict(shapes_per_variant=3, tandem_every=5, zero_load_every=7,
            pinned_every=11, infeasible_every=13)


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
    ref_reset_fleet_state()
    yield
    reset_fleet_state()
    ref_reset_fleet_state()


def base_rates(system):
    return np.asarray(
        [s.load.arrival_rate if s.load is not None else 0.0
         for s in system.servers.values()],
        np.float64,
    )


def serial_rows(system):
    """(choice, replicas, chips) per server of a solved System, in the
    batch result's encoding."""
    acc_idx = {a: i for i, a in enumerate(sorted(system.accelerators))}
    rows = []
    for server in system.servers.values():
        a = server.allocation
        if a is None or not a.accelerator:
            rows.append((-1, 0, 0))
            continue
        model = system.models[server.model_name]
        chips = (a.num_replicas * model.slices_per_replica(a.accelerator)
                 * system.accelerators[a.accelerator].chips)
        rows.append((acc_idx[a.accelerator], a.num_replicas, chips))
    return rows


def batch_rows(batch, index):
    return [
        (int(batch.choice[index][j]), int(batch.replicas[index][j]),
         int(batch.chips[index][j]))
        for j in range(len(batch.servers))
    ]


def port_spec(ref_spec):
    """The port's SystemSpec of a reference spec (same document)."""
    return SystemSpec.from_dict(ref_spec.to_dict())


def both_batches(ref_spec, rates, chunk_steps=None):
    """(ref_prep, ref_res, port_prep, port_res) of one rate tensor."""
    ref_reset_fleet_state()
    ref_prep = ref_prepare_fleet_batch(RefSystem(ref_spec), **REF)
    ref_res = ref_prep.solve(rates, chunk_steps=chunk_steps)
    reset_fleet_state()
    port_prep = prepare_fleet_batch(System(port_spec(ref_spec)), **CPU)
    port_res = port_prep.solve(rates, chunk_steps=chunk_steps)
    return ref_prep, ref_res, port_prep, port_res


# -- inside the port: the reference's bit-exact contracts ---------------------


def test_batch_t1_bit_identical_over_edge_fleet():
    """T=1 at the fleet's own loads (zero-load, infeasible, pinned,
    tandem lanes) equals the per-cycle calculate_fleet + solve_unlimited,
    and the replay leaves the System's loads untouched."""
    spec = fleet_system_spec(40, **EDGE)
    system = System(spec)
    rates = base_rates(system)[None, :]
    saved = rates.copy()
    batch = calculate_fleet_batch(system, rates, **CPU)
    np.testing.assert_array_equal(base_rates(system)[None, :], saved)

    reset_fleet_state()
    oracle = System(spec)
    calculate_fleet(oracle, **CPU)
    solve_unlimited(oracle)
    assert batch_rows(batch, 0) == serial_rows(oracle)


def test_batch_matches_serial_loop_across_timesteps():
    """Multi-T parity, zero-rate timesteps included."""
    spec = fleet_system_spec(25, shapes_per_variant=2)
    system = System(spec)
    rng = np.random.default_rng(7)
    base = base_rates(system)
    rates = base[None, :] * rng.uniform(0.0, 2.5, size=(6, len(base)))
    rates[rates < 20.0] = 0.0
    batch = calculate_fleet_batch(system, rates, **CPU)

    reset_fleet_state()
    oracle = System(spec)
    for t in range(len(rates)):
        for j, server in enumerate(oracle.servers.values()):
            if server.load is not None:
                server.load.arrival_rate = float(rates[t, j])
        calculate_fleet(oracle, **CPU)
        solve_unlimited(oracle)
        assert batch_rows(batch, t) == serial_rows(oracle), f"timestep {t}"


@pytest.mark.parametrize("chunk", [1, 3, 5])
def test_chunk_boundary_placement_never_changes_results(chunk):
    spec = fleet_system_spec(20, shapes_per_variant=2)
    system = System(spec)
    rng = np.random.default_rng(3)
    rates = base_rates(system)[None, :] * rng.uniform(
        0.2, 2.0, size=(7, len(system.servers)))
    full = calculate_fleet_batch(system, rates, chunk_steps=7, **CPU)
    other = calculate_fleet_batch(system, rates, chunk_steps=chunk, **CPU)
    for field in BATCH_FIELDS:
        np.testing.assert_array_equal(
            getattr(full, field), getattr(other, field), err_msg=field)


def test_chunk_env_knob(monkeypatch):
    system = System(fleet_system_spec(8, shapes_per_variant=1))
    rates = base_rates(system)[None, :] * np.ones((4, 1))
    baseline = calculate_fleet_batch(system, rates, **CPU)
    monkeypatch.setenv("PLANNER_CHUNK_STEPS", "2")
    enved = calculate_fleet_batch(system, rates, **CPU)
    for field in BATCH_FIELDS:
        np.testing.assert_array_equal(
            getattr(baseline, field), getattr(enved, field), err_msg=field)


def test_batch_rejects_bad_rates():
    system = System(fleet_system_spec(5, shapes_per_variant=1))
    with pytest.raises(ValueError, match="server order"):
        calculate_fleet_batch(system, np.ones((2, 3)), **CPU)
    with pytest.raises(ValueError, match="finite"):
        calculate_fleet_batch(system, -np.ones((1, len(system.servers))), **CPU)


def test_batch_runs_on_the_card_unless_asked():
    """device=None is the CUDA card; without one the batched solve
    raises instead of falling back to the CPU, and backend 'cuda' on the
    CPU is refused."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    system = System(fleet_system_spec(4, shapes_per_variant=1))
    rates = base_rates(system)[None, :]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calculate_fleet_batch(system, rates)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_fleet_batch(system, backend="torch")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        calculate_fleet_batch(system, rates, backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        calculate_fleet_batch(system, rates, backend="jax", device="cpu")


def _surface(system):
    out = {}
    for name, s in system.servers.items():
        a = s.allocation
        out[name] = None if a is None else (
            a.accelerator, a.num_replicas, a.cost, a.value)
        out[name + "#candidates"] = sorted(
            (k, v.num_replicas, v.cost, v.value)
            for k, v in s.all_allocations.items())
    return out


def _full_pass(spec, cur, monkeypatch):
    """A fresh System of `spec` under the full path, on the given
    current allocations."""
    with monkeypatch.context() as m:
        m.setenv("INCREMENTAL_CYCLE", "0")
        m.setenv("FLEET_SNAPSHOT", "0")
        fresh = System(spec)
        for name, server in fresh.servers.items():
            server.cur_allocation = cur[name]
        calculate_fleet(fresh, **CPU)
        solve_unlimited(fresh)
    return fresh


@pytest.mark.parametrize("witness", [False, True])
def test_prep_between_incremental_cycles_keeps_them_exact(witness, monkeypatch):
    """A prep shares the process-wide snapshot and sizes it at a
    placeholder rate. Run between incremental cycles over the SAME
    System — on the full-signature scan and on the identity-witness scan
    (limit monkeypatched small) — every following cycle stays ≡ a full
    pass of its loads: unchanged, λ-moved, and prep-then-λ-moved."""
    if witness:
        monkeypatch.setattr(port_snapshot, "SCAN_FULL_SIG_LIMIT", 8)
    spec = fleet_system_spec(60, **EDGE)
    system = System(spec)
    calculate_fleet(system, **CPU)
    solve_unlimited(system)
    rates = base_rates(system)[None, :] * 1.7
    calculate_fleet_batch(system, rates, **CPU)
    for step in ("unchanged", "lam", "unchanged", "prep-then-lam"):
        if step == "prep-then-lam":
            calculate_fleet_batch(system, rates * 0.5, **CPU)
        if step.endswith("lam"):
            for i, s in enumerate(system.servers.values()):
                if s.load is not None and i % 3 == 0 and s.load.arrival_rate > 0:
                    s.load.arrival_rate *= 1.3
        cur = {n: s.cur_allocation for n, s in system.servers.items()}
        calculate_fleet(system, **CPU)
        solve_unlimited(system)
        assert system.fleet_dirty is not None
        assert (system.fleet_dirty.dirty_lanes > 0) == step.endswith("lam"), step
        assert _surface(system) == _surface(_full_pass(spec, cur, monkeypatch)), step


# -- against the reference ----------------------------------------------------


def test_port_batch_matches_reference_over_edge_fleet():
    """Multi-T over the edge fleet, zero-rate rows included, one numpy
    seed for both packages."""
    ref_spec = ref_fleet_system_spec(120, **EDGE)
    n = len(ref_spec.servers)
    rng = np.random.default_rng(21)
    base = base_rates(RefSystem(ref_spec))
    rates = base[None, :] * rng.uniform(0.0, 2.5, size=(12, n))
    rates[rates < 15.0] = 0.0
    ref_prep, ref_res, port_prep, port_res = both_batches(ref_spec, rates)
    assert port_prep.n_lanes == ref_prep.n_lanes
    np.testing.assert_array_equal(port_prep.lane_server, ref_prep.lane_server)
    np.testing.assert_array_equal(port_prep.lane_rank, ref_prep.lane_rank)
    boundary = assert_same_batch(ref_prep, ref_res, port_prep, port_res)
    assert boundary <= rates.size // 100, boundary


def test_port_batch_matches_reference_with_spot_tier():
    """A spot tier adds the spot split and the required-replica fold to
    every row: the spot columns follow the choice rule."""
    from inferno_tpu.config.types import CapacitySpec as RefCapacitySpec
    from inferno_tpu.config.types import SpotPoolSpec as RefSpotPoolSpec

    ref_spec = ref_fleet_system_spec(60, shapes_per_variant=2)
    ref_spec.capacity = RefCapacitySpec(chips={}, spot={"v5e": RefSpotPoolSpec(
        discount=0.3, hazard_per_hr=0.005, blast_radius=0.06)})
    rng = np.random.default_rng(5)
    base = base_rates(RefSystem(ref_spec))
    rates = base[None, :] * rng.uniform(0.2, 2.0, size=(8, len(base)))
    ref_prep, ref_res, port_prep, port_res = both_batches(ref_spec, rates)
    assert port_prep.spot_on and ref_prep.spot_on
    assert port_res.spot_replicas is not None and port_res.required is not None
    boundary = assert_same_batch(ref_prep, ref_res, port_prep, port_res)
    assert boundary <= rates.size // 100


def test_rate_trace_matches_reference():
    from inferno_tpu.emulator.experiment import rate_trace as ref_rate_trace
    from inferno_tpu.emulator.loadgen import RateSpec as RefRateSpec
    from inferno_tpu_torch.emulator import RateSpec, rate_trace

    spec = RateSpec.ramp(0.0, 10.0, duration=100.0, steps=10)
    ref = RefRateSpec.ramp(0.0, 10.0, duration=100.0, steps=10)
    assert spec.phases == ref.phases
    trace = rate_trace(spec, 10, 10.0)
    assert trace == pytest.approx(np.arange(0.5, 10.0), abs=1e-9)
    for steps, repeat in ((10, False), (12, False), (12, True), (37, True)):
        np.testing.assert_array_equal(
            rate_trace(spec, steps, 10.0, repeat=repeat),
            ref_rate_trace(ref, steps, 10.0, repeat=repeat))
    with pytest.raises(ValueError):
        rate_trace(spec, 5, 0.0)


@pytest.mark.parametrize("name", ["diurnal", "ramp", "flash_crowd", "launch",
                                  "regional_skew"])
def test_scenario_generators_bit_identical_to_reference(name):
    from inferno_tpu.planner.scenarios import GENERATORS as REF_GENERATORS
    from inferno_tpu_torch.planner.scenarios import GENERATORS, ensemble_seeds

    assert list(GENERATORS) == list(REF_GENERATORS)
    base = np.random.default_rng(2).uniform(0.0, 300.0, size=40)
    base[::7] = 0.0
    for seed in ensemble_seeds(name, 5, 3):
        t = GENERATORS[name](base, 48, 3600.0, seed=seed)
        r = REF_GENERATORS[name](base, 48, 3600.0, seed=seed)
        np.testing.assert_array_equal(t.rates, r.rates)
        assert (t.name, t.seed, t.step_seconds, t.description) == (
            r.name, r.seed, r.step_seconds, r.description)


def test_scenario_generators_are_seeded_and_shaped():
    from inferno_tpu_torch.planner.scenarios import GENERATORS, build_scenarios

    base = np.asarray([60.0, 120.0, 0.0, 240.0])
    for name, gen in GENERATORS.items():
        t1 = gen(base, 24, 3600.0, seed=5)
        t2 = gen(base, 24, 3600.0, seed=5)
        np.testing.assert_array_equal(t1.rates, t2.rates)
        assert t1.rates.shape == (24, 4) and (t1.rates >= 0).all(), name
        if name != "launch":
            assert (t1.rates[:, 2] == 0).all(), name
    traces = build_scenarios([], base, 6, 3600.0, seed=1)
    assert [t.name for t in traces] == list(GENERATORS)
    with pytest.raises(ValueError, match="unknown scenario"):
        build_scenarios(["nope"], base, 6, 3600.0)
    alone = build_scenarios(["flash_crowd"], base, 6, 3600.0, seed=1)[0]
    among = [t for t in build_scenarios([], base, 6, 3600.0, seed=1)
             if t.name == "flash_crowd"][0]
    np.testing.assert_array_equal(alone.rates, among.rates)


def _binding_spec(ref: bool, n=18, classes=3, quota=True):
    """A split-pool fleet whose budgets are 60% of its base consumption
    (plus a tighter gen0/r0 carve-out), built from the reference's
    fixture so both packages see one document."""
    from inferno_tpu.config.types import CapacitySpec as RefCapacitySpec
    from inferno_tpu.testing.fleet import fleet_capacity as ref_fleet_capacity

    spec = ref_fleet_system_spec(n, shapes_per_variant=2,
                                 priority_classes=classes, split_pools=True)
    usage = ref_fleet_capacity(spec, 1.0, backend="jax")
    ref_reset_fleet_state()
    spec.capacity = RefCapacitySpec(
        chips={p: max(int(c * 0.6), 1) for p, c in usage.items()},
        quotas={"gen0/r0": max(int(usage["gen0"] * 0.3), 1)} if quota else {},
    )
    return spec if ref else port_spec(spec)


def _strip_profile(report):
    report = dict(report)
    report.pop("profile", None)
    return report


@pytest.mark.parametrize("quota", [True, False])
def test_replay_report_matches_reference_under_binding_budgets(quota):
    """First binds, the zeroed upper bound in priority order,
    violation-seconds and cost bands: the port's report document equals
    the reference's when the two batch surfaces agree cell for cell."""
    from inferno_tpu.planner.replay import replay_scenario as ref_replay_scenario
    from inferno_tpu_torch.planner.replay import replay_scenario
    from inferno_tpu_torch.planner.scenarios import base_rates_from_system, diurnal

    ref_spec = _binding_spec(True, quota=quota)
    system = System(port_spec(ref_spec))
    trace = diurnal(base_rates_from_system(system), 24, 3600.0, seed=2)
    port = replay_scenario(system, trace, include_series=True, **CPU)
    ref_reset_fleet_state()
    ref = ref_replay_scenario(RefSystem(ref_spec), trace, include_series=True, **REF)

    block = port["reactive"]
    assert block["binding_steps"] > 0
    assert block["zeroed_upper_bound"]["variant_steps"] > 0
    assert block["violation_seconds"] == (
        block["zeroed_upper_bound"]["variant_steps"] * 3600.0)
    if quota:
        assert block["quotas"]["gen0/r0"]["first_bind_step"] is not None
    else:
        assert block["quotas"] == {}
    _, ref_res, _, port_res = both_batches(ref_spec, trace.rates)
    assert (port_res.replicas == ref_res.replicas).all(), "boundary cell"
    assert _strip_profile(port) == _strip_profile(ref)


def test_unconfigured_pools_report_demand_only():
    from inferno_tpu_torch.planner.replay import replay_scenario
    from inferno_tpu_torch.planner.scenarios import base_rates_from_system, diurnal

    system = System(fleet_system_spec(10, shapes_per_variant=1))
    trace = diurnal(base_rates_from_system(system), 6, 3600.0, seed=0)
    block = replay_scenario(system, trace, **CPU)["reactive"]
    pool = block["pools"]["v5e"]
    assert pool["peak"] > 0
    assert "budget_chips" not in pool and "first_bind_step" not in pool
    assert block["binding_steps"] == 0 and block["violation_seconds"] == 0.0


def test_forecast_bound_rates_match_reference():
    """The forecast filter is the port's copy of the forecaster, f64
    host code: bit-identical to the reference's."""
    from inferno_tpu.planner.replay import forecast_bound_rates as ref_fbr
    from inferno_tpu_torch.planner.replay import forecast_bound_rates

    rng = np.random.default_rng(0)
    rates = 100.0 + np.cumsum(rng.uniform(-2.0, 6.0, size=(40, 3)), axis=0)
    eff = forecast_bound_rates(rates, 60.0, 120.0)
    assert eff.shape == rates.shape
    assert (eff >= rates - 1e-9).all() and (eff > rates).any()
    np.testing.assert_array_equal(eff, ref_fbr(rates, 60.0, 120.0))


def test_forecast_replay_pass_matches_reference():
    from inferno_tpu.planner.replay import replay_scenario as ref_replay_scenario
    from inferno_tpu_torch.planner.replay import replay_scenario
    from inferno_tpu_torch.planner.scenarios import base_rates_from_system, ramp

    ref_spec = ref_fleet_system_spec(16, shapes_per_variant=1)
    system = System(port_spec(ref_spec))
    trace = ramp(base_rates_from_system(system), 12, 3600.0, seed=1)
    port = replay_scenario(system, trace, forecast=True, **CPU)
    ref = ref_replay_scenario(RefSystem(ref_spec), trace, forecast=True, **REF)
    assert "forecast_bound" in port
    assert _strip_profile(port) == _strip_profile(ref)


def test_planner_cli_smoke(tmp_path):
    from inferno_tpu_torch.planner.__main__ import main

    out = tmp_path / "plan.json"
    rc = main([
        "--variants", "12", "--steps", "6", "--shapes", "1",
        "--scenarios", "diurnal,ramp", "--backend", "torch", "--device", "cpu",
        "--quotas", '{"gen0": 64}', "--out", str(out),
    ])
    assert rc == 0
    report = json.loads(out.read_text())
    assert report["fleet"]["variants"] == 12
    assert report["fleet"]["backend"] == "torch"
    assert [s["scenario"] for s in report["scenarios"]] == ["diurnal", "ramp"]
    for s in report["scenarios"]:
        assert "gen0" in s["reactive"]["quotas"]
        assert s["reactive"]["cost"]["total_usd"] >= 0


def test_planner_cli_report_matches_reference(tmp_path):
    """One CLI invocation per package (capacity fraction, quotas, skew):
    the report documents are equal apart from the backend names and the
    wall-clock profile blocks."""
    from inferno_tpu.planner.__main__ import main as ref_main
    from inferno_tpu_torch.planner.__main__ import main

    args = ["--variants", "14", "--steps", "8", "--shapes", "2",
            "--scenarios", "diurnal,flash_crowd", "--capacity-fraction", "0.7",
            "--quotas", '{"gen0/r0": 40}', "--skew", "--seed", "3"]
    rc = main(args + ["--backend", "torch", "--device", "cpu",
                      "--out", str(tmp_path / "port.json")])
    assert rc == 0
    ref_reset_fleet_state()
    assert ref_main(args + ["--backend", "jax",
                            "--out", str(tmp_path / "ref.json")]) == 0
    port = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "ref.json").read_text())
    assert port["fleet"].pop("backend") == "torch"
    assert port["fleet"].pop("device") == "cpu"
    assert ref["fleet"].pop("backend") == "jax"
    for doc in (port, ref):
        for block in doc["scenarios"]:
            block.pop("profile")
    assert port == ref


def test_planner_backend_resolution(monkeypatch):
    """auto (flag or PLANNER_BACKEND) is cuda on a card and an error
    naming the CPU route without one; an unknown PLANNER_BACKEND fails
    fast; the reference's backends are not choices."""
    from inferno_tpu_torch.planner.__main__ import _resolve_backend, main

    assert _resolve_backend("torch") == "torch"
    monkeypatch.setenv("PLANNER_BACKEND", "torch")
    assert _resolve_backend("auto") == "torch"
    monkeypatch.setenv("PLANNER_BACKEND", "jax")
    with pytest.raises(SystemExit, match="not one of"):
        _resolve_backend("auto")
    with pytest.raises(SystemExit):
        main(["--variants", "4", "--backend", "tpu"])
    if torch.cuda.is_available():
        return
    for env in ("", "auto"):
        monkeypatch.setenv("PLANNER_BACKEND", env)
        with pytest.raises(SystemExit, match="--backend torch --device cpu"):
            _resolve_backend("auto")
