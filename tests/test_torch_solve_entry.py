"""The port's public solve entries, `parallel.solve_fleet` and
`parallel.solve_tandem_fleet`, against the JAX reference's on the CPU.

The same plans (built from one spec by each package) go through the
reference's `solve_fleet` / `solve_tandem_fleet` (XLA on the CPU) and the
port's (`backend="torch"`, `device="cpu"`), compared under the port's
rule: feasibility exactly, replicas exactly except ±1 on a ceil boundary
whose rate_star agrees within 1e-4, the other floats at the tolerances of
tests/test_pallas.py (`test_torch_queueing._assert_results_match`). The
fleets are the reference's edge fleet (aggregated and tandem lanes, zero
load, pinned and infeasible variants) and the two-server disaggregated
spec of tests/test_native.py.

Inside the port, bit for bit: an entry's result equals what
`calculate_fleet` solved for the same plan, and a 4-device mesh equals no
mesh.
"""

import numpy as np
import pytest
import torch

from fixtures import make_server, make_system_spec
from inferno_tpu.config.types import DisaggSpec
from inferno_tpu.core import System as RefSystem
from inferno_tpu.parallel import build_fleet as ref_build_fleet
from inferno_tpu.parallel import build_tandem_fleet as ref_build_tandem_fleet
from inferno_tpu.parallel import reset_fleet_state as ref_reset_fleet_state
from inferno_tpu.parallel import solve_fleet as ref_solve_fleet
from inferno_tpu.parallel import solve_tandem_fleet as ref_solve_tandem_fleet
from inferno_tpu.testing.fleet import fleet_system_spec as ref_fleet_system_spec
from inferno_tpu_torch.config.types import SystemSpec
from inferno_tpu_torch.core.system import System
from inferno_tpu_torch.ops.queueing import FleetResult
from inferno_tpu_torch.parallel import (
    build_fleet,
    build_tandem_fleet,
    calculate_fleet,
    fleet_mesh,
    reset_fleet_state,
    solve_fleet,
    solve_tandem_fleet,
)
from inferno_tpu_torch.parallel import fleet as port_fleet
from test_torch_queueing import _assert_results_match

CPU = dict(backend="torch", device="cpu")
EDGE = dict(shapes_per_variant=3, tandem_every=5, zero_load_every=7,
            pinned_every=11, infeasible_every=13)
ENTRIES = {"agg": (solve_fleet, ref_solve_fleet), "tan": (solve_tandem_fleet,
                                                          ref_solve_tandem_fleet)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_fleet_state(monkeypatch):
    monkeypatch.delenv("SIZING_SHARDS", raising=False)
    reset_fleet_state()
    ref_reset_fleet_state()
    yield
    reset_fleet_state()
    ref_reset_fleet_state()


def _edge_spec():
    return ref_fleet_system_spec(300, **EDGE)


def _disagg_spec():
    """tests/test_native.py:228-241: two servers of 2+3-slice tandem units."""
    spec = make_system_spec([
        make_server(name="ns/a", class_name="Premium", arrival_rate=900.0),
        make_server(name="ns/b", class_name="Freemium", arrival_rate=3000.0,
                    in_tokens=512, out_tokens=96),
    ])
    for perf in spec.models:
        perf.disagg = DisaggSpec(prefill_slices=2, decode_slices=3)
    return spec


SPECS = {"edge": _edge_spec, "disagg": _disagg_spec}


def _plans(system, builders):
    """A plan of each kind (None where there are no lanes), after the
    candidate scaffolding that calculate_fleet does first."""
    for server in system.servers.values():
        server.all_allocations = {}
    return {kind: build(system) for kind, build in zip(("agg", "tan"), builders)}


def _bits(a: FleetResult, b: FleetResult) -> None:
    for name, fa, fb in zip(FleetResult._fields, a, b):
        fa, fb = np.asarray(fa), np.asarray(fb)
        assert fa.dtype == fb.dtype, name
        np.testing.assert_array_equal(fa.view(np.uint8), fb.view(np.uint8), err_msg=name)


@pytest.mark.parametrize("spec_name,kind", [("edge", "agg"), ("edge", "tan"),
                                            ("disagg", "tan")])
def test_solve_entry_matches_reference(spec_name, kind):
    ref_spec = SPECS[spec_name]()
    ref_plan = _plans(RefSystem(ref_spec), (ref_build_fleet, ref_build_tandem_fleet))[kind]
    plan = _plans(System(SystemSpec.from_dict(ref_spec.to_dict())),
                  (build_fleet, build_tandem_fleet))[kind]
    assert plan is not None and plan.num_lanes >= 4
    assert plan.lanes == ref_plan.lanes
    port_entry, ref_entry = ENTRIES[kind]
    got = port_entry(plan, **CPU)
    ref = ref_entry(ref_plan)
    assert len(got.feasible) == plan.num_lanes
    _assert_results_match(ref, FleetResult(*(torch.from_numpy(np.asarray(f)) for f in got)))
    assert got.feasible.any() and (spec_name == "disagg" or not got.feasible.all())


def test_solve_entries_equal_calculate_fleets_solve(monkeypatch):
    """A full pass's own plans, solved again through the entries: the
    results calculate_fleet computed, bit for bit."""
    monkeypatch.setenv("INCREMENTAL_CYCLE", "0")
    system = System(SystemSpec.from_dict(_edge_spec().to_dict()))
    calculate_fleet(system, **CPU)
    memo = port_fleet._solve_memo["last"]
    agg, tan = memo["results"]
    assert memo["plan"].num_lanes and memo["tandem"].num_lanes
    _bits(solve_fleet(memo["plan"], **CPU), agg)
    _bits(solve_tandem_fleet(memo["tandem"], **CPU), tan)


@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_solve_entries_on_a_mesh_equal_no_mesh(spec_name):
    system = System(SystemSpec.from_dict(SPECS[spec_name]().to_dict()))
    plans = _plans(system, (build_fleet, build_tandem_fleet))
    mesh = fleet_mesh(devices=["cpu"] * 4)
    for kind, (entry, _) in ENTRIES.items():
        if plans[kind] is None:
            continue
        _bits(entry(plans[kind], mesh=mesh, **CPU), entry(plans[kind], **CPU))


def test_empty_plans_give_the_references_empty_result():
    system = System(SystemSpec.from_dict(_edge_spec().to_dict()))
    plan = _plans(system, (build_fleet, build_tandem_fleet))["agg"]
    empty = port_fleet.FleetPlan(
        params=type(plan.params)(*(np.asarray(a)[:0] for a in plan.params)), lanes=[])
    ref = ref_solve_fleet(None)
    for got in (solve_fleet(None, **CPU), solve_tandem_fleet(None, **CPU),
                solve_fleet(empty, **CPU)):
        _bits(got, FleetResult(*(np.asarray(f) for f in ref)))


def test_solve_entries_run_on_the_card_unless_asked():
    """backend "cuda" needs a CUDA device, device None is the card (raises
    without one), backend "native" has no batched sizing program, and a
    mesh must hold devices of the solve's type."""
    system = System(SystemSpec.from_dict(_disagg_spec().to_dict()))
    plan = _plans(system, (build_fleet, build_tandem_fleet))["tan"]
    with pytest.raises(ValueError, match="needs a CUDA device"):
        solve_tandem_fleet(plan, backend="cuda", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            solve_tandem_fleet(plan)
    with pytest.raises(ValueError, match="native"):
        solve_tandem_fleet(plan, backend="native", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        solve_fleet(None, backend="jax", device="cpu")
    with pytest.raises(ValueError, match="do not match"):
        solve_tandem_fleet(plan, mesh=fleet_mesh(devices=["meta"] * 2), **CPU)
