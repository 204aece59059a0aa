"""The port's sizing writeback held to its own scalar path on the CPU.

The candidate objective, the spot terms, the candidate table and the
zero-load pick each live in one function of `parallel/fleet.py`, shared by
the full pass, the incremental writeback and the planner's host fold:

* `_transition_value` equals the scalar `transition_penalty(cur, alloc) +
  alloc.spot_premium` bit for bit (`==` on f64) in every regime of the
  penalty, with and without a spot tier, on per-cycle lanes and on the
  planner's [rows, L] slabs;
* a source check (AST) finds exactly one site in `parallel/` for the
  penalty arithmetic, `spot_split(`, `candidate_order(`,
  `_zero_load_allocation(` and `FleetCandidates(`;
* `FleetBatchPrep.zero_columns()` is each server's `_zero_load_dict` pick
  under the solvers' (value, cost, accelerator) key, over the transition
  basis the prep pinned.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

from inferno_tpu_torch.config.types import CapacitySpec, SpotPoolSpec
from inferno_tpu_torch.core import System
from inferno_tpu_torch.core.allocation import Allocation, transition_penalty
from inferno_tpu_torch.parallel import prepare_fleet_batch, reset_fleet_state
from inferno_tpu_torch.parallel.fleet import _transition_value, _zero_load_dict
from inferno_tpu_torch.solver.greedy import candidate_sort_key
from inferno_tpu_torch.spot.market import spot_split
from inferno_tpu_torch.testing.fleet import SIZING_SHAPES, fleet_system_spec

PARALLEL = Path(__file__).resolve().parent.parent / "inferno_tpu_torch" / "parallel"
SHAPES = [name for name, _ in SIZING_SHAPES]
REGIMES = ("same_shape_same_replicas", "same_shape", "other_shape", "no_current")


@pytest.fixture(autouse=True)
def _fresh_fleet_state():
    reset_fleet_state()
    yield
    reset_fleet_state()


# -- the objective against the scalar path ------------------------------------


def _lanes(regime: str, spot: bool, shape: tuple[int, ...], seed: int):
    """Current and proposed allocations of `shape` lanes in one regime:
    the broadcast columns `_transition_value` takes (the current basis
    per lane, the proposal per cell) and the scalar pair per cell."""
    rng = np.random.default_rng(seed)
    n_lanes = shape[-1]
    cur_acc = rng.choice(SHAPES, n_lanes)
    cur_reps = rng.integers(1, 9, n_lanes)
    cur_cost = rng.uniform(5.0, 400.0, n_lanes) * cur_reps
    if regime == "no_current":
        cur_acc[:] = ""
        cur_reps[:] = 0
        cur_cost[:] = 0.0
    if regime in ("same_shape_same_replicas", "same_shape"):
        acc = np.broadcast_to(cur_acc, shape)
    else:
        acc = np.broadcast_to(
            np.asarray([SHAPES[(SHAPES.index(a) + 1) % len(SHAPES)] if a else SHAPES[0]
                        for a in cur_acc]), shape)
    if regime == "same_shape_same_replicas":
        reps = np.broadcast_to(cur_reps, shape).astype(np.int64)
    else:
        reps = rng.integers(1, 9, shape)
        if regime == "same_shape":
            reps = np.where(reps == cur_reps, reps + 1, reps)
    cost = reps * rng.uniform(5.0, 400.0, shape)
    premium = None
    if spot:
        required = rng.integers(0, 9, shape)
        # a risky tier (premium below the discount): every replica rides
        # spot, the unsafe ones carry the risk premium
        _, disc, premium, _ = spot_split(reps, required, cost / reps, 0.4, 0.7, 0.1, True)
        cost = cost - disc
        assert (premium > 0).any()
    same = np.broadcast_to(cur_acc, shape) == acc
    got = _transition_value(same, reps, cur_reps, cost, cur_cost, premium)
    want = np.empty(shape, np.float64)
    for idx in np.ndindex(*shape):
        lane = idx[-1]
        current = Allocation(accelerator=str(cur_acc[lane]), num_replicas=int(cur_reps[lane]),
                             batch_size=0, cost=float(cur_cost[lane]))
        proposed = Allocation(accelerator=str(acc[idx]), num_replicas=int(reps[idx]),
                              batch_size=0, cost=float(cost[idx]))
        if premium is not None:
            proposed.spot_premium = float(premium[idx])
        want[idx] = transition_penalty(current, proposed) + proposed.spot_premium
    return got, want


@pytest.mark.parametrize("shape", [(97,), (6, 41)], ids=["lanes", "rows_x_lanes"])
@pytest.mark.parametrize("spot", [False, True], ids=["no_spot", "spot"])
@pytest.mark.parametrize("regime", REGIMES)
def test_transition_value_is_the_scalar_objective(regime, spot, shape):
    got, want = _lanes(regime, spot, shape, seed=len(shape) * 10 + REGIMES.index(regime))
    assert got.dtype == np.float64 and got.shape == shape
    assert (got == want).all(), np.flatnonzero(got != want)[:5]
    if regime == "same_shape_same_replicas" and not spot:
        assert (got == 0.0).all()


# -- one site for each decision ----------------------------------------------


def _sites(name: str) -> list[str]:
    """Where `parallel/*.py` calls `name` (a call by name or attribute),
    or, for ACCEL_PENALTY_FACTOR, uses it as an operand of arithmetic."""
    out = []
    for path in sorted(PARALLEL.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if name == "ACCEL_PENALTY_FACTOR":
                operands = (
                    (node.left, node.right) if isinstance(node, ast.BinOp)
                    else (node.value,) if isinstance(node, ast.AugAssign) else ()
                )
                hit = any(isinstance(o, ast.Name) and o.id == name for o in operands)
            elif isinstance(node, ast.Call):
                f = node.func
                hit = (f.id if isinstance(f, ast.Name)
                       else f.attr if isinstance(f, ast.Attribute) else None) == name
            else:
                hit = False
            if hit:
                out.append(f"{path.name}:{node.lineno}")
    return out


@pytest.mark.parametrize("name", [
    "ACCEL_PENALTY_FACTOR", "spot_split", "candidate_order",
    "_zero_load_allocation", "FleetCandidates",
])
def test_each_writeback_decision_has_one_site(name):
    sites = _sites(name)
    assert len(sites) == 1, sites


def test_site_finder_sees_calls_and_arithmetic():
    """The check above counts what it claims to: a call by attribute
    (`F._spot_terms(`) and the prep's kernel argument, which is not
    arithmetic."""
    assert len(_sites("_spot_terms")) == 3
    assert len(_sites("_transition_value")) == 3
    assert len(_sites("_CandidateTable")) == 3
    src = (PARALLEL / "fleet.py").read_text()
    assert "cq.plan_rows(rates, self.lanes, ACCEL_PENALTY_FACTOR" in src


# -- the planner's zero-load table -------------------------------------------


def _spot_fleet(n: int = 40) -> System:
    """An edge fleet with a spot tier, current allocations on every shape
    and zero-replica floors (the shortcut's empty pick) here and there."""
    spec = fleet_system_spec(n, shapes_per_variant=3, tandem_every=5, zero_load_every=7,
                             pinned_every=11, infeasible_every=13)
    spec.capacity = CapacitySpec(chips={}, spot={"v5e": SpotPoolSpec(
        discount=0.3, hazard_per_hr=0.005, blast_radius=0.6)})
    for i, server in enumerate(spec.servers):
        server.current_alloc = dataclasses.replace(
            server.current_alloc, accelerator=SHAPES[i % 3] if i % 9 else "",
            num_replicas=1 + i % 4, cost=37.5 * (1 + i % 5))
        server.min_num_replicas = 0 if i % 6 == 5 else 1 + i % 3
    return System(spec)


def _picks(system: System, basis) -> dict[str, np.ndarray]:
    """The zero columns built the long way: each loaded server's
    `_zero_load_dict` over `basis[i]`, its min under candidate_sort_key."""
    accs = sorted(system.accelerators)
    n = len(system.servers)
    out = {"choice": np.full(n, -1, np.int32), "replicas": np.zeros(n, np.int32),
           "chips": np.zeros(n, np.int64), "cost": np.zeros(n, np.float32),
           "value": np.zeros(n, np.float64), "spot_replicas": np.zeros(n, np.int32)}
    for i, server in enumerate(system.servers.values()):
        if server.load is None:
            continue
        d = _zero_load_dict(system, server, basis[i])
        if not d:
            continue
        best = min(d.values(), key=candidate_sort_key)
        if not best.accelerator:
            continue
        model = system.models[server.model_name]
        out["choice"][i] = accs.index(best.accelerator)
        out["replicas"][i] = best.num_replicas
        out["chips"][i] = (best.num_replicas * model.slices_per_replica(best.accelerator)
                           * system.accelerators[best.accelerator].chips)
        out["cost"][i] = best.cost
        out["value"][i] = best.value
        out["spot_replicas"][i] = best.spot_replicas
    return out


@pytest.mark.parametrize("basis", ["current", "replaced_after_prep"])
def test_zero_columns_are_each_servers_zero_load_pick(basis):
    system = _spot_fleet()
    prep = prepare_fleet_batch(system, backend="torch", device="cpu")
    assert prep.spot_on
    pinned = [s.cur_allocation for s in system.servers.values()]
    if basis == "replaced_after_prep":
        # a reconcile between prep and solve replaces the current
        # allocations: the table keeps the basis the prep pinned
        for i, server in enumerate(system.servers.values()):
            server.cur_allocation = Allocation(
                accelerator=SHAPES[(i + 1) % 3], num_replicas=2, batch_size=0, cost=90.0)
    table = prep.zero_columns()
    want = _picks(system, pinned)
    for key, col in want.items():
        np.testing.assert_array_equal(table[key], col, err_msg=key)
    assert table["required"] == 0
    # the fixture reaches every branch of the pick
    assert (want["choice"] >= 0).sum() > 10 and (want["spot_replicas"] > 0).any()
    assert len(set(want["choice"][want["choice"] >= 0].tolist())) == 3
    if basis == "replaced_after_prep":
        moved = _picks(system, [s.cur_allocation for s in system.servers.values()])
        assert (moved["value"] != want["value"]).any()
