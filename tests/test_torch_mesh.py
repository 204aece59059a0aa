"""The port's lane mesh (inferno_tpu_torch.parallel.mesh, the sharded
dispatch of parallel.fleet.solve_slots) on the CPU, backend "torch".

Contracts:

* shards ≡ single, bit for bit: `calculate_fleet(mesh=fleet_mesh(
  devices=["cpu"] * m))` for m in 1, 2, 4 and 8 sizes every candidate of
  every server to the same bits as no mesh, on the full path and through
  `calculate_fleet_batch`; `SIZING_SHARDS=4` is the same, and a
  one-device mesh runs the unsharded code (the counterparts of
  tests/test_fleet.py:150-164, 267-279 and tests/test_incremental.py:
  530-560; the incremental path's cases are in test_torch_incremental.py);
* the layout facts of tests/test_fleet.py:306-335: an even, contiguous
  split of the lane axis, no replication, every device used;
* against the reference: the port's 8-shard decisions equal the
  reference's `calculate_fleet(backend="jax", mesh=fleet_mesh(8))` (8
  virtual CPU devices, tests/conftest.py) under the round's rule
  (`testing.fleet.assert_same_decisions`).
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from inferno_tpu_torch.config.types import SystemSpec
from inferno_tpu_torch.core import System
from inferno_tpu_torch.parallel import (
    FleetMesh,
    build_fleet,
    calculate_fleet,
    calculate_fleet_batch,
    fleet_mesh,
    reset_fleet_state,
    shard_fleet_params,
)
from inferno_tpu_torch.parallel import fleet as port_fleet
from inferno_tpu_torch.parallel import incremental as port_incremental
from inferno_tpu_torch.parallel.mesh import FLEET_AXIS
from inferno_tpu_torch.solver.solver import solve_unlimited
from inferno_tpu_torch.testing.fleet import assert_same_decisions, fleet_system_spec

CPU = dict(backend="torch", device="cpu")
EDGE = dict(shapes_per_variant=3, tandem_every=5, zero_load_every=7,
            pinned_every=11, infeasible_every=13)
SHARDS = [1, 2, 4, 8]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The fleets here are small, and the tests run beside other test
    workers: torch's intra-op threads would only contend with them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_fleet_state(monkeypatch):
    monkeypatch.delenv("SIZING_SHARDS", raising=False)
    reset_fleet_state()
    yield
    reset_fleet_state()


def _cpu_mesh(m: int) -> FleetMesh:
    return fleet_mesh(devices=["cpu"] * m)


def _candidates(system: System) -> dict:
    """Every candidate of every server, every number the sizing produced."""
    return {
        (name, acc): (a.num_replicas, a.cost, a.value, a.max_arrv_rate_per_replica,
                      a.itl, a.ttft, a.rho, a.batch_size)
        for name, server in system.servers.items()
        for acc, a in server.all_allocations.items()
    }


def _picks(system: System) -> dict:
    return {
        name: None if s.allocation is None else
        (s.allocation.accelerator, s.allocation.num_replicas, s.allocation.cost,
         s.allocation.value)
        for name, s in system.servers.items()
    }


def _sized(spec, **kw):
    reset_fleet_state()
    system = System(SystemSpec.from_dict(spec.to_dict()))
    calculate_fleet(system, **CPU, **kw)
    solve_unlimited(system)
    return system


@pytest.fixture(scope="module")
def edge_spec():
    return fleet_system_spec(60, **EDGE)


@pytest.fixture(scope="module")
def unsharded_full(edge_spec):
    prior = os.environ.get("INCREMENTAL_CYCLE")
    os.environ["INCREMENTAL_CYCLE"] = "0"
    try:
        system = _sized(edge_spec)
    finally:
        if prior is None:
            os.environ.pop("INCREMENTAL_CYCLE")
        else:
            os.environ["INCREMENTAL_CYCLE"] = prior
    reset_fleet_state()
    return _candidates(system), _picks(system)


# -- layout -----------------------------------------------------------------


def test_fleet_mesh_and_sharding_layout(edge_spec):
    """8 devices, each holding exactly lanes/8 contiguous rows of every
    FleetParams column: an even split, no replication, every device used."""
    mesh = _cpu_mesh(8)
    assert mesh.size == 8 and FLEET_AXIS == "fleet"
    assert fleet_mesh(n_devices=4, devices=["cpu"] * 8).size == 4
    assert _cpu_mesh(8) is mesh  # one object per device list
    plan = build_fleet(System(edge_spec))
    n = plan.num_lanes
    total = n + ((-n) % 8)
    padded = port_fleet.pad_params_rows(plan.params, total)
    shards = shard_fleet_params(padded, mesh)
    assert len(shards) == mesh.size
    for field, column in zip(padded._fields, padded):
        rows = [np.asarray(getattr(s, field)) for s in shards]
        assert {len(r) for r in rows} == {total // 8}
        np.testing.assert_array_equal(np.concatenate(rows), np.asarray(column))
    with pytest.raises(ValueError, match="do not split evenly"):
        shard_fleet_params(port_fleet.pad_params_rows(plan.params, total + 3), mesh)


def test_pad_lanes_rounds_to_the_mesh():
    from inferno_tpu.parallel.fleet import _pad_lanes as ref_pad_lanes

    for chunk in (1, 2, 3, 4, 8):
        for n in (1, 7, 9, 100, 2048, 2049, 5000):
            assert port_fleet._pad_lanes(n, chunk) == ref_pad_lanes(n, chunk), (n, chunk)
    assert [port_fleet._pad_lanes(n, 3) for n in (1, 9, 2049)] == [9, 18, 2562]
    assert port_fleet._pad_lanes(9) == port_fleet._pad_lanes(9, 1) == 16


def test_fleet_mesh_needs_the_cards_it_names(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fleet_mesh(devices=["cuda:0"] * 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 CUDA devices requested, 1 visible"):
        fleet_mesh(2)
    with pytest.raises(ValueError, match="at least one device"):
        fleet_mesh(devices=[])


def test_use_mesh_without_a_card_raises(edge_spec):
    """`use_mesh=True` means every visible card: with none it raises, it
    never moves the split to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: use_mesh takes it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calculate_fleet(System(edge_spec), **CPU, use_mesh=True)


def test_mesh_on_another_device_type_raises(edge_spec):
    with pytest.raises(ValueError, match="do not match the solve's device"):
        calculate_fleet(System(edge_spec), **CPU, mesh=fleet_mesh(devices=["meta"] * 2))


# -- shards ≡ single ----------------------------------------------------------


@pytest.mark.parametrize("m", SHARDS)
def test_full_path_sharded_equals_single(edge_spec, unsharded_full, m, monkeypatch):
    monkeypatch.setenv("INCREMENTAL_CYCLE", "0")
    system = _sized(edge_spec, mesh=_cpu_mesh(m))
    want_cands, want_picks = unsharded_full
    assert _candidates(system) == want_cands
    assert _picks(system) == want_picks


@pytest.mark.parametrize("m", SHARDS)
def test_incremental_cold_cycle_sharded_equals_single(edge_spec, unsharded_full, m):
    system = _sized(edge_spec, mesh=_cpu_mesh(m))
    assert _candidates(system) == unsharded_full[0]
    assert _picks(system) == unsharded_full[1]


def test_sizing_shards_env_splits_on_the_cpu(edge_spec, unsharded_full, monkeypatch):
    """SIZING_SHARDS=4 with backend "torch" on the CPU runs four CPU shards
    (the reference splits over its virtual devices), cached so that its
    identity holds across cycles; unset, 0, 1 or garbage is no mesh."""
    monkeypatch.setenv("SIZING_SHARDS", "4")
    mesh = port_fleet._env_mesh(torch.device("cpu"))
    assert mesh.size == 4 and port_fleet._env_mesh(torch.device("cpu")) is mesh
    system = _sized(edge_spec)
    assert port_incremental._state.mesh is mesh
    assert _candidates(system) == unsharded_full[0]
    for raw in ("", "0", "1", "four"):
        monkeypatch.setenv("SIZING_SHARDS", raw)
        assert port_fleet._env_mesh(torch.device("cpu")) is None


def test_one_device_mesh_is_the_unsharded_path(edge_spec, unsharded_full, monkeypatch):
    def no_split(*a, **k):
        raise AssertionError("a one-device mesh took the sharded dispatch")

    monkeypatch.setattr(port_fleet, "_solve_sharded", no_split)
    system = _sized(edge_spec, mesh=_cpu_mesh(1))
    assert _candidates(system) == unsharded_full[0]
    assert port_incremental._state.mesh is None


def test_every_shard_launches_with_its_real_lanes(monkeypatch):
    """A bucket of 13 lanes over 8 shards pads to 16: shards 0-5 hold two
    real lanes, shard 6 one, shard 7 only pad rows — it runs as one real
    lane (its rows repeat the bucket's row 0), so every shard runs the
    bucket's program; only real lanes are read back."""
    from inferno_tpu_torch.graft_entry import _example_fleet_params, size_lanes

    seen = []
    real_solve = port_fleet._solve_slot

    def spy(slot, device, n_iters, use_kernel, real_lanes=None):
        seen.append((slot.width, real_lanes))
        return real_solve(slot, device, n_iters, use_kernel, real_lanes)

    params = _example_fleet_params(13)
    width = port_fleet._pad_lanes(13, 8)
    padded = port_fleet.pad_params_rows(params, width)
    slot = port_fleet.BucketSlot("agg", 128, padded, np.arange(13), width)
    monkeypatch.setattr(port_fleet, "_solve_slot", spy)
    packed = port_fleet.solve_slots([slot], torch.device("cpu"), 32, False, _cpu_mesh(8))
    assert seen == [(2, 2)] * 6 + [(2, 1), (2, 1)]
    monkeypatch.setattr(port_fleet, "_solve_slot", real_solve)
    single = port_fleet.solve_slots([slot], torch.device("cpu"), 32, False)
    np.testing.assert_array_equal(packed[:, :13], single[:, :13])
    assert size_lanes("agg", params, 128, "cpu", False).num_replicas.shape == (13,)


@pytest.mark.parametrize("m", SHARDS)
def test_batch_prep_sharded_equals_single(m):
    spec = fleet_system_spec(40, **EDGE)
    rng = np.random.default_rng(3)
    system = System(SystemSpec.from_dict(spec.to_dict()))
    rates = rng.uniform(0.0, 400.0, size=(5, len(system.servers)))
    rates[1, ::4] = 0.0
    want = calculate_fleet_batch(system, rates, **CPU)
    reset_fleet_state()
    got = calculate_fleet_batch(System(SystemSpec.from_dict(spec.to_dict())), rates, **CPU,
                                mesh=_cpu_mesh(m))
    for field in ("choice", "replicas", "chips", "cost", "value"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)


def test_native_backend_ignores_the_mesh(edge_spec, monkeypatch):
    monkeypatch.setenv("INCREMENTAL_CYCLE", "0")
    reset_fleet_state()
    plain = System(SystemSpec.from_dict(edge_spec.to_dict()))
    calculate_fleet(plain, backend="native")
    reset_fleet_state()
    meshed = System(SystemSpec.from_dict(edge_spec.to_dict()))
    calculate_fleet(meshed, backend="native", mesh=_cpu_mesh(4))
    assert _candidates(meshed) == _candidates(plain)


# -- the port against the reference's sharded solve ---------------------------


@pytest.mark.parametrize("fleet", ["shapes2", "edge"])
def test_sharded_decisions_match_reference_sharded(fleet):
    from inferno_tpu.core import System as RefSystem
    from inferno_tpu.parallel import calculate_fleet as ref_calculate_fleet
    from inferno_tpu.parallel import fleet_mesh as ref_fleet_mesh
    from inferno_tpu.parallel import reset_fleet_state as ref_reset_fleet_state
    from inferno_tpu.solver.solver import solve_unlimited as ref_solve_unlimited
    from inferno_tpu.testing.fleet import fleet_system_spec as ref_fleet_system_spec

    kw = dict(shapes_per_variant=2) if fleet == "shapes2" else EDGE
    ref_spec = ref_fleet_system_spec(48, **kw)
    ref_reset_fleet_state()
    try:
        ref = RefSystem(ref_spec)
        ref_calculate_fleet(ref, backend="jax", mesh=ref_fleet_mesh(8))
        ref_solve_unlimited(ref)
    finally:
        ref_reset_fleet_state()
    port = _sized(ref_spec, mesh=_cpu_mesh(8))
    assert assert_same_decisions(ref, port) <= 2
