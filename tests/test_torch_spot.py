"""The port's spot tier (inferno_tpu_torch.spot.market and the spot
columns of the fleet writeback and the capacity ledgers) on the CPU.

* The risk model's functions against the reference's on seeded inputs.
* Inside the port, with the tier on: the vectorized limited solve equals
  the scalar one bit for bit over the four regimes of tests/test_spot.py
  (trimming, spot-budget pressure, binding capacity), and a tiny spot
  budget demotes with a `spot_headroom` event.
* Against the JAX reference: the unlimited solve and the limited solve
  (the solver alone on carried candidates, and end to end) with a tier.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from inferno_tpu_torch.config.types import CapacitySpec, OptimizerSpec, SpotPoolSpec, SystemSpec
from inferno_tpu_torch.core import System
from inferno_tpu_torch.parallel import calculate_fleet, reset_fleet_state
from inferno_tpu_torch.solver.greedy import DEGRADE_SPOT_HEADROOM, solve_greedy
from inferno_tpu_torch.solver.greedy_vec import solve_greedy_fleet
from inferno_tpu_torch.solver.solver import solve_unlimited
from inferno_tpu_torch.spot import market
from inferno_tpu_torch.testing.fleet import fleet_capacity, fleet_system_spec

CPU = dict(backend="torch", device="cpu")

# the risk premium beats the discount (every replica may ride spot):
# premium = 0.001 * 0.5 * (180/3600) * 1000 = 0.025 < 0.5
CHEAP_HAZARD = SpotPoolSpec(discount=0.5, hazard_per_hr=0.001, blast_radius=0.5, recovery_s=180.0)
# risk outweighs the discount (only storm-safe slack rides):
# premium = 0.05 * 0.5 * (180/3600) * 1000 = 1.25 > 0.5
RISKY_HAZARD = SpotPoolSpec(discount=0.5, hazard_per_hr=0.05, blast_radius=0.5, recovery_s=180.0)
REGIMES = [
    (CHEAP_HAZARD, 1.2, 0),   # loose capacity, elastic spot, all-spot
    (CHEAP_HAZARD, 0.8, 24),  # binding + bounded spot -> demotions
    (RISKY_HAZARD, 0.5, 16),  # trimming + deep capacity pressure
    (CHEAP_HAZARD, 1.0, 8),   # exact capacity, tiny spot budget
]
REGIME_IDS = ["cheap-loose", "cheap-binding", "risky-deep", "cheap-tiny-budget"]


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


def spot_spec(n=40, tier=CHEAP_HAZARD, spot_chips=0, fraction=None, **kw):
    """The reference's spot fixture on the port: all shapes in the v5e
    pool, the tier on v5e, pools sized at `fraction` of the unlimited
    solve (limited mode) when given."""
    kw.setdefault("shapes_per_variant", 3)
    kw.setdefault("priority_classes", 3)
    spec = fleet_system_spec(n, **kw)
    cap = {}
    if fraction is not None:
        cap = fleet_capacity(spec, fraction, device="cpu")
        reset_fleet_state()
        spec.optimizer = OptimizerSpec(unlimited=False)
    spec.capacity = CapacitySpec(chips=cap, spot={"v5e": dataclasses.replace(tier, chips=spot_chips)})
    return spec


def _surface(system) -> dict:
    out = {}
    for name, server in system.servers.items():
        a = server.allocation
        out[name] = None if a is None else (
            a.accelerator, a.num_replicas, a.cost, a.value,
            a.spot_replicas, a.spot_discount, a.spot_premium, a.spot_trimmed,
        )
    return out


def _events(system) -> dict:
    return {k: dataclasses.asdict(v) for k, v in system.degradations.items()}


# -- the risk model against the reference ------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spot_split_and_premium_match_reference(seed):
    from inferno_tpu.config.types import SpotPoolSpec as RefSpotPoolSpec
    from inferno_tpu.spot import market as ref_market

    rng = np.random.default_rng(seed)
    n = 4096
    reps = rng.integers(1, 40, n).astype(np.int64)
    required = np.maximum(reps - rng.integers(0, 6, n), 0).astype(np.int32)
    cost = rng.uniform(1.0, 400.0, n)
    discount = rng.uniform(0.05, 0.9, n)
    blast = rng.uniform(0.05, 1.0, n)
    premium = rng.uniform(0.0, 2.0, n)
    eligible = rng.uniform(size=n) < 0.8
    got = market.spot_split(reps, required, cost, discount, blast, premium, eligible)
    want = ref_market.spot_split(reps, required, cost, discount, blast, premium, eligible)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    for _ in range(8):
        kw = dict(discount=float(rng.uniform(0.05, 0.95)),
                  hazard_per_hr=float(rng.uniform(0, 0.2)),
                  blast_radius=float(rng.uniform(0.05, 1.0)),
                  recovery_s=float(rng.uniform(30, 900)))
        assert market.premium_rate(SpotPoolSpec(**kw)) == ref_market.premium_rate(
            RefSpotPoolSpec(**kw))


def test_spot_split_safe_slack_and_cheap_risk():
    k, disc, prem, trimmed = market.spot_split(
        reps=6, required=4, cost_per_replica=100.0,
        discount=0.5, blast=0.5, premium=2.0, eligible=True,
    )
    assert (int(k), float(disc), float(prem), bool(trimmed)) == (4, 200.0, 0.0, True)
    k, disc, prem, trimmed = market.spot_split(
        reps=6, required=4, cost_per_replica=100.0,
        discount=0.5, blast=0.5, premium=0.1, eligible=True,
    )
    assert int(k) == 6 and float(prem) == pytest.approx(20.0) and not bool(trimmed)


@pytest.mark.parametrize("raw", [
    "",
    json.dumps({"v5e": {"discount": 0.6, "hazardPerHr": 0.05, "blastRadius": 0.25,
                        "recoverySeconds": 120, "chips": 64},
                "v5p": {"discount": 0.3}}),
    "{broken",
    "[1, 2]",
    '{"v5e": {}}',
    '{"v5e": {"discount": 1.5}}',
    '{"v5e": {"discount": 0.5, "blastRadius": 0}}',
    '{"v5e": {"discount": 0.5, "hazardperhr": 0.1}}',
])
def test_parse_spot_pools_matches_reference(raw):
    """Same tiers, or the same actionable error, as the reference."""
    from inferno_tpu.spot import market as ref_market

    def outcome(mod):
        try:
            return {k: dataclasses.asdict(v) for k, v in mod.parse_spot_pools(raw).items()}
        except mod.SpotConfigError as exc:
            return ("error", str(exc))

    assert outcome(market) == outcome(ref_market)


@pytest.mark.parametrize("raw", ['{"v5e": 48, "v5e/us-east1": 16}', '{"a/b/c": 4}', '{"v5e": -4}'])
def test_parse_pool_quotas_matches_reference(raw):
    from inferno_tpu.spot import market as ref_market

    def outcome(mod):
        try:
            return mod.parse_pool_quotas(raw)
        except mod.SpotConfigError as exc:
            return ("error", str(exc))

    assert outcome(market) == outcome(ref_market)


# -- sizing with a tier inside the port ---------------------------------------


def test_vectorized_sizing_matches_scalar_oracle_with_a_tier():
    """The spot columns of the fleet writeback against the scalar
    `System.calculate_all` (which now sizes tiers too): the same spot
    split wherever the replica counts agree."""
    spec = spot_spec(24, tier=CHEAP_HAZARD)
    scalar = System(SystemSpec.from_dict(spec.to_dict()))
    scalar.calculate_all()
    fleet = System(spec)
    calculate_fleet(fleet, **CPU)
    placed = 0
    for name, s_server in scalar.servers.items():
        f_allocs = fleet.servers[name].all_allocations
        assert set(f_allocs) == set(s_server.all_allocations), name
        for acc, s in s_server.all_allocations.items():
            f = f_allocs[acc]
            if f.num_replicas == s.num_replicas:
                assert f.spot_replicas == s.spot_replicas, (name, acc)
                assert f.spot_discount == pytest.approx(s.spot_discount, rel=1e-5)
                placed += f.spot_replicas > 0
    assert placed


def test_spot_ineligible_shape_stays_reserved():
    spec = spot_spec(12, shapes_per_variant=1, priority_classes=1)
    for acc in spec.accelerators:
        acc.spot_eligible = False
    system = System(spec)
    calculate_fleet(system, **CPU)
    solve_unlimited(system)
    assert all(s.allocation is None or s.allocation.spot_replicas == 0
               for s in system.servers.values())


def test_discount_restores_exactly_on_demotion():
    system = System(spot_spec(12))
    calculate_fleet(system, **CPU)
    solve_unlimited(system)
    priced = [s.allocation for s in system.servers.values()
              if s.allocation and s.allocation.spot_replicas]
    assert priced, "a cheap hazard must place spot"
    for alloc in priced:
        assert 0 < alloc.spot_replicas <= alloc.num_replicas and alloc.spot_discount > 0
        restored = market.demote_spot(alloc)
        assert restored.cost == pytest.approx(alloc.cost + alloc.spot_discount)
        assert restored.spot_replicas == 0


@pytest.mark.parametrize("tier,fraction,spot_chips", REGIMES, ids=REGIME_IDS)
def test_greedy_spot_parity_scalar_vs_vectorized(tier, fraction, spot_chips):
    """Allocations AND degradation events, bit for bit, with the tier on."""
    spec = spot_spec(40, tier=tier, fraction=fraction, spot_chips=spot_chips)
    a = System(spec)
    calculate_fleet(a, **CPU)
    reset_fleet_state()  # b shares no candidate objects with a
    b = System(spec)
    calculate_fleet(b, **CPU)
    solve_greedy(a, spec.optimizer)
    solve_greedy_fleet(b, spec.optimizer)
    assert b.fleet_candidates is not None and b.fleet_candidates.num_rows > 0
    assert _surface(a) == _surface(b)
    assert a.degradations == b.degradations


def test_spot_headroom_demotion_event_and_ledger():
    """A spot budget too small for the placement demotes candidates to
    all-reserved: the event names the binding `pool:spot` bucket, and the
    demoted allocation pays the undiscounted price."""
    spec = spot_spec(40, fraction=1.0, spot_chips=8)
    system = System(spec)
    calculate_fleet(system, **CPU)
    solve_greedy_fleet(system, spec.optimizer)
    events = [e for e in system.degradations.values() if e.step == DEGRADE_SPOT_HEADROOM]
    assert events, "a tiny spot budget must demote someone"
    for e in events:
        assert e.pool.endswith(":spot") and e.shortfall_chips > 0
        assert e.from_accelerator == e.to_accelerator
        assert e.from_replicas == e.to_replicas
        alloc = system.servers[e.server].allocation
        assert alloc is not None and alloc.spot_replicas == 0 and alloc.spot_discount == 0.0


# -- the port against the JAX reference ---------------------------------------


def _ref_spot(n, tier, fraction, spot_chips):
    """The same fixture built by the reference, with its pool budgets from
    the reference's own unlimited solve (backend "jax")."""
    from inferno_tpu.config.types import CapacitySpec as RefCapacitySpec
    from inferno_tpu.config.types import OptimizerSpec as RefOptimizerSpec
    from inferno_tpu.config.types import SpotPoolSpec as RefSpotPoolSpec
    from inferno_tpu.parallel import reset_fleet_state as ref_reset
    from inferno_tpu.testing.fleet import fleet_capacity as ref_fleet_capacity
    from inferno_tpu.testing.fleet import fleet_system_spec as ref_fleet_system_spec

    ref_reset()
    spec = ref_fleet_system_spec(n, shapes_per_variant=3, priority_classes=3)
    cap = {}
    if fraction is not None:
        cap = ref_fleet_capacity(spec, fraction, backend="jax")
        ref_reset()
        spec.optimizer = RefOptimizerSpec(unlimited=False)
    ref_tier = RefSpotPoolSpec(**{**dataclasses.asdict(tier), "chips": spot_chips})
    spec.capacity = RefCapacitySpec(chips=cap, spot={"v5e": ref_tier})
    return spec


def _spot_boundary(ref, port) -> int:
    """Spot splits of every candidate agree, except on ceil-boundary lanes
    (rate_star within 1e-4), where the load-required count may move by
    one; returns how many such candidates there were."""
    boundary = 0
    for name, server in ref.servers.items():
        for acc, a in server.all_allocations.items():
            b = port.servers[name].all_allocations[acc]
            if (a.num_replicas, a.spot_replicas) != (b.num_replicas, b.spot_replicas):
                ra, rb = a.max_arrv_rate_per_replica, b.max_arrv_rate_per_replica
                assert abs(ra - rb) <= 1e-4 * max(abs(ra), abs(rb)), (name, acc, a, b)
                boundary += 1
    return boundary


@pytest.mark.parametrize("tier", [CHEAP_HAZARD, RISKY_HAZARD], ids=["cheap", "risky"])
def test_unlimited_with_a_tier_matches_reference(tier):
    from inferno_tpu.core import System as RefSystem
    from inferno_tpu.parallel import calculate_fleet as ref_calculate_fleet
    from inferno_tpu.parallel import reset_fleet_state as ref_reset
    from inferno_tpu.solver.solver import solve_unlimited as ref_solve_unlimited
    from inferno_tpu_torch.testing.fleet import assert_same_decisions

    ref_spec = _ref_spot(40, tier, None, 0)
    try:
        ref = RefSystem(ref_spec)
        ref_calculate_fleet(ref, backend="jax")
        ref_solve_unlimited(ref)
        port = System(SystemSpec.from_dict(ref_spec.to_dict()))
        assert port.spot and port.spot["v5e"].discount == tier.discount
        calculate_fleet(port, **CPU)
        solve_unlimited(port)
        assert assert_same_decisions(ref, port) + _spot_boundary(ref, port) <= 2
        assert any(s.allocation and s.allocation.spot_replicas for s in port.servers.values())
    finally:
        ref_reset()


@pytest.mark.parametrize("tier,fraction,spot_chips", REGIMES[1:3], ids=REGIME_IDS[1:3])
def test_limited_with_a_tier_matches_reference(tier, fraction, spot_chips):
    """The solver alone on the reference's carried candidates (port vec ≡
    reference vec ≡ port scalar), and end to end when the two sizings
    agree on every candidate."""
    from inferno_tpu.core import System as RefSystem
    from inferno_tpu.parallel import calculate_fleet as ref_calculate_fleet
    from inferno_tpu.parallel import reset_fleet_state as ref_reset
    from inferno_tpu.solver.greedy_vec import solve_greedy_fleet as ref_solve_greedy_fleet
    from test_torch_capacity import _carry, _empty_table

    ref_spec = _ref_spot(40, tier, fraction, spot_chips)
    try:
        port_spec = SystemSpec.from_dict(ref_spec.to_dict())
        ref = RefSystem(ref_spec)
        ref_calculate_fleet(ref, backend="jax")
        vec, scalar = System(port_spec), System(port_spec)
        _carry(ref, vec)
        _carry(ref, scalar)
        port = System(port_spec)
        calculate_fleet(port, **CPU)
        agree = _spot_boundary(ref, port) == 0
        ref_solve_greedy_fleet(ref, ref_spec.optimizer)
        vec.fleet_candidates = _empty_table()
        solve_greedy_fleet(vec, port_spec.optimizer)
        solve_greedy(scalar, port_spec.optimizer)
        solve_greedy_fleet(port, port_spec.optimizer)
    finally:
        ref_reset()
    assert _surface(vec) == _surface(ref) == _surface(scalar)
    assert _events(vec) == _events(ref) == _events(scalar)
    assert ref.degradations
    assert agree
    assert _surface(port) == _surface(ref)
    assert _events(port) == _events(ref)
