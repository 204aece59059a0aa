"""The capacity planner's rows: the card path (`ops/csrc/plan_rows_kernel.cu`,
`FleetBatchPrep.rows_on_card`) against the numpy path of the same prep.

On the card (marked `cuda`; they skip without one), bit for bit: every
output of every slab, the kernel's `slab.demand` against the numpy
accumulator's, and whole `replay_montecarlo` reports with `per_seed` and
`keep_seeds`, over multi-lane and single-lane fleets, zero-rate columns
that are zero for a whole slab and for part of it, servers without
output tokens, lanes with TPS targets, a capacity that binds rows across
a `BINDING_FLUSH_ROWS` boundary, a slab read after the binding flush its
own consumer ran, chunks that split seeds, and hand-made lanes whose
quotient leaves int32 or is NaN, or whose cost is NaN.

On the CPU: the path chooser keeps the numpy path for backend "torch" and
for fleets with a spot tier, and the accumulator's `slab.demand` seam,
fed the demand the numpy path sums, gives the same envelopes.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from inferno_tpu_torch.config.types import CapacitySpec, SpotPoolSpec
from inferno_tpu_torch.core import System
from inferno_tpu_torch.obs.profiler import CycleProfiler
from inferno_tpu_torch.ops import cuda_queueing
from inferno_tpu_torch.parallel import prepare_fleet_batch, reset_fleet_state
from inferno_tpu_torch.parallel.fleet import BATCH_OUTPUTS, FleetBatchPrep
from inferno_tpu_torch.planner import montecarlo
from inferno_tpu_torch.solver.greedy_vec import capacity_buckets
from inferno_tpu_torch.testing.fleet import fleet_capacity, fleet_system_spec

CPU = {"backend": "torch", "device": "cpu"}
SPOT_TIER = SpotPoolSpec(discount=0.5, hazard_per_hr=0.001, blast_radius=0.5, recovery_s=180.0)


@pytest.fixture
def cuda_device():
    """The card, for `cuda`-marked tests; decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _fresh_fleet_state():
    reset_fleet_state()
    yield
    reset_fleet_state()


def edge_spec(n, shapes, capacity=None, spot=False):
    """`fleet_system_spec` with the rows' edge lanes: every 9th server
    without output tokens (the zero-load overlay whatever its rate) and a
    TPS target on every 4th model target; `capacity` sizes the pools at
    that share of the unlimited solve, with a regional quota."""
    spec = fleet_system_spec(n, shapes_per_variant=shapes, priority_classes=3,
                             split_pools=not spot)
    for i, server in enumerate(spec.servers):
        if i % 9 == 4:
            server.current_alloc.load.avg_out_tokens = 0.0
    for cls in spec.service_classes:
        cls.model_targets = [
            dataclasses.replace(t, slo_tps=40.0 * (j + 1)) if j % 4 == 1 else t
            for j, t in enumerate(cls.model_targets)
        ]
    if capacity is not None:
        usage = fleet_capacity(spec, 1.0, **CPU)
        reset_fleet_state()
        spec.capacity = CapacitySpec(
            chips={p: max(int(c * capacity), 1) for p, c in usage.items()},
            quotas={"gen0/r0": max(int(usage["gen0"] * 0.3), 1)})
    if spot:
        spec.capacity = CapacitySpec(chips={}, spot={"v5e": SPOT_TIER})
    return spec


def edge_rates(system, seeds, steps, seed=7):
    """[seeds, steps, S] rates: low cells zeroed (columns zero in part of a
    slab), every 6th column zero throughout (zero for whole slabs)."""
    rng = np.random.default_rng(seed)
    base = np.array([s.load.arrival_rate if s.load is not None else 0.0
                     for s in system.servers.values()])
    rates = base[None, None, :] * rng.uniform(0.0, 2.5, size=(seeds, steps, len(base)))
    rates[rates < 40.0] = 0.0
    rates[..., ::6] = 0.0
    return rates


def numpy_demand(ledger, slab):
    """A slab's bucket demand summed from its winners with `np.add.at`: a
    witness apart from `_EnvelopeAccumulator`'s own sums, for the seam
    test on the CPU."""
    n_pools = len(ledger.pools)
    demand = np.zeros((slab.rows, n_pools + len(ledger.quota_keys)), np.float64)
    valid = slab.choice >= 0
    rank = np.maximum(slab.choice, 0)
    for qmap, off in ((ledger.rank_pid, 0), (ledger.rank_q1, n_pools),
                      (ledger.rank_q2, n_pools)):
        bucket = np.where(valid, qmap[rank], -1)
        ok = bucket >= 0
        rows = np.broadcast_to(np.arange(slab.rows)[:, None], rank.shape)[ok]
        np.add.at(demand, (rows, bucket[ok] + off), slab.chips[ok].astype(np.float64))
    return demand


def streamed(prep, system, rates, chunk):
    """Every surface of a streamed solve, copied out of the reused slabs,
    and the bucket demand `_EnvelopeAccumulator` holds after the slabs:
    the kernel's `slab.demand` on the card, the accumulator's own sums on
    the numpy path."""
    acc = montecarlo._EnvelopeAccumulator(prep, system, rates.size // rates.shape[-1],
                                          chunk_steps=chunk)
    got = {f: [] for f in BATCH_OUTPUTS}

    def consume(slab):
        for f in BATCH_OUTPUTS:
            got[f].append(getattr(slab, f).copy())
        acc.feed(slab)

    prep.solve(rates, chunk_steps=chunk, consume=consume, buckets=acc.ledger)
    got = {f: np.concatenate(v) for f, v in got.items()}
    got["demand"] = np.hstack([acc.pool_demand, acc.quota_demand])
    return got


def both_paths(prep, fn):
    """`fn()` on the card's rows, then on the numpy path of the same prep."""
    assert prep.rows_on_card
    card = fn()
    prep.rows_on_card = False
    try:
        host = fn()
    finally:
        prep.rows_on_card = True
    return card, host


@pytest.mark.cuda
@pytest.mark.parametrize("shapes,chunk", [(1, 5), (2, 1), (2, 7), (3, 40)])
def test_slabs_match_the_host_path_on_card(shapes, chunk, cuda_device):
    system = System(edge_spec(30, shapes))
    prep = prepare_fleet_batch(system, backend="cuda", device=cuda_device)
    assert prep.all_seg1 == (shapes == 1)
    rates = edge_rates(system, 3, 12)
    assert (rates == 0).any() and (rates > 0).any()
    card, host = both_paths(prep, lambda: streamed(prep, system, rates, chunk))
    for f in card:
        np.testing.assert_array_equal(card[f], host[f], err_msg=f)
    card, host = both_paths(prep, lambda: prep.solve(rates, chunk_steps=chunk))
    for f in BATCH_OUTPUTS:
        np.testing.assert_array_equal(getattr(card, f), getattr(host, f), err_msg=f)


@pytest.mark.cuda
def test_hand_made_lanes_take_the_host_semantics_on_card(cuda_device):
    """Hand-made lanes: a capacity so small the quotient leaves int32, a
    zero capacity (inf, or NaN at rate 0) and a NaN one, where numpy's cast
    gives INT_MIN and the replica floor replaces it; and, on servers of
    two lanes, a NaN cost a replica and a NaN current cost, where the
    host's minimum.reduceat makes the server's first lane the winner; and
    on a server of three, a first lane that loses, a second of value 0 and
    cost 0, and a third that ties it on value 0 with a NaN cost."""
    system = System(edge_spec(24, 3))
    prep = prepare_fleet_batch(system, backend="cuda", device=cuda_device)
    star = prep._l_rate_star.copy()
    star[0], star[3], star[7] = np.float32(1e-30), np.float32(0.0), np.float32(np.nan)
    prep._l_rate_star = star
    pairs = np.flatnonzero(prep._seg_len >= 2)
    assert len(pairs) >= 4
    second = prep._starts[pairs] + 1
    cpr, ccost = prep._l_cpr.copy(), prep._l_ccost.copy()
    cpr[second[0]] = np.float32(np.nan)
    cpr[prep._starts[pairs[1]]] = np.float32(np.nan)
    ccost[second[2]] = np.nan
    ccost[prep._starts[pairs[3]]: second[3] + 1] = np.nan
    first = prep._starts[np.flatnonzero(prep._seg_len >= 3)[0]]
    same, creps = prep._l_same.copy(), prep._l_creps.copy()
    star[first + 2] = np.float32(1e30)  # one replica whatever the rate
    same[first: first + 3] = False, False, True
    creps[first + 2] = 1
    ccost[first: first + 2] = -1e6, 0.0
    cpr[first + 1: first + 3] = np.float32(0.0), np.float32(np.nan)
    prep._l_cpr, prep._l_ccost, prep._l_same, prep._l_creps = cpr, ccost, same, creps
    rates = edge_rates(system, 2, 6)
    rates[:, :, prep.lane_server[[0, 3, 7]]] = 5000.0
    rates[0, 0, prep.lane_server[3]] = 0.0
    card, host = both_paths(prep, lambda: prep.solve(rates, chunk_steps=5))
    for f in BATCH_OUTPUTS:
        np.testing.assert_array_equal(getattr(card, f), getattr(host, f), err_msg=f)
    assert (card.replicas > 0).any()


def _montecarlo(system, on_card, chunk, monkeypatch, **kw):
    """A profiled `replay_montecarlo` whose prep runs its rows on the card
    or, with `on_card` False, on the numpy path."""
    made = montecarlo.prepare_fleet_batch

    def prep_fn(*args, **kwargs):
        prep = made(*args, **kwargs)
        prep.rows_on_card = prep.rows_on_card and on_card
        return prep

    monkeypatch.setattr(montecarlo, "prepare_fleet_batch", prep_fn)
    prof = CycleProfiler()
    prof.activate()
    try:
        report = montecarlo.replay_montecarlo(
            system, "diurnal", 10, 3600.0, seeds=4, base_seed=3, per_seed=True,
            keep_seeds=(0, 2), chunk_steps=chunk, **kw)
    finally:
        prof.deactivate()
    report.pop("profile")
    return report, prof.counters


@pytest.mark.cuda
@pytest.mark.parametrize("shapes,capacity,chunk", [
    (1, None, None), (2, None, 7), (2, 0.6, 3), (1, 0.6, 13), (3, 0.5, None),
])
def test_montecarlo_reports_match_the_host_path_on_card(shapes, capacity, chunk,
                                                         cuda_device, monkeypatch):
    monkeypatch.setattr(montecarlo, "BINDING_FLUSH_ROWS", 4)
    spec = edge_spec(24, shapes, capacity)
    card, counters = _montecarlo(System(spec), True, chunk, monkeypatch,
                                 backend="cuda", device=cuda_device)
    reset_fleet_state()
    host, host_counters = _montecarlo(System(spec), False, chunk, monkeypatch,
                                      backend="cuda", device=cuda_device)
    kept_card, kept_host = card.pop("_kept"), host.pop("_kept")
    assert card == host
    for k in kept_card:
        for f in kept_card[k]:
            np.testing.assert_array_equal(kept_card[k][f], kept_host[k][f], err_msg=(k, f))
    if capacity is not None:
        assert card["binding_rows"] > 4  # the flush boundary was crossed
    assert counters["plan_card_rows"] >= 4 * 10 and "plan_host_rows" not in counters
    assert counters["plan_rows_kernel_launches"] >= -(-10 // (chunk or 10)) * 4
    assert host_counters["plan_host_rows"] == counters["plan_card_rows"]


@pytest.mark.cuda
def test_a_binding_flush_leaves_the_callers_slab_as_it_was_on_card(cuda_device,
                                                                     monkeypatch):
    """The accumulator's binding flush re-solves through the same prep
    inside `feed`: the slab its caller holds must read the same after the
    flush as before it. Every row binds; the flush comes at the second
    slab and re-solves both slabs' rows in chunks of 4, so a flush that
    shared the caller's buffers would leave other rows' winners there."""
    monkeypatch.setattr(montecarlo, "BINDING_FLUSH_ROWS", 8)
    system = System(edge_spec(24, 2, capacity=0.5))
    prep = prepare_fleet_batch(system, backend="cuda", device=cuda_device)
    rates = edge_rates(system, 1, 12)[0]
    acc = montecarlo._EnvelopeAccumulator(prep, system, len(rates), chunk_steps=4)
    flushed = []

    def consume(slab):
        before = {f: getattr(slab, f).copy() for f in BATCH_OUTPUTS}
        demand = slab.demand.copy()
        n = len(acc.zeroed_by_row)
        acc.feed(slab)
        flushed.append(len(acc.zeroed_by_row) - n)
        for f in BATCH_OUTPUTS:
            np.testing.assert_array_equal(getattr(slab, f), before[f], err_msg=f)
        np.testing.assert_array_equal(slab.demand, demand)

    prep.solve(rates, chunk_steps=6, consume=consume, buckets=acc.ledger)
    assert flushed == [0, 12]


@pytest.mark.cuda
def test_a_prep_and_its_card_buffers_go_with_its_last_user_on_card(cuda_device):
    """No reference cycle holds a prep's pinned and device buffers until
    a cyclic collection: a planner that prepares a fleet a call would
    otherwise pile them up."""
    system = System(edge_spec(12, 2))
    prep = prepare_fleet_batch(system, backend="cuda", device=cuda_device)
    prep.solve(edge_rates(system, 1, 4), consume=lambda slab: None,
               buckets=capacity_buckets(system))
    refs = (weakref.ref(prep), weakref.ref(prep._card_rows))
    gc.disable()
    try:
        del prep
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


@pytest.mark.cuda
def test_spot_fleets_keep_the_host_rows_on_card(cuda_device):
    system = System(edge_spec(16, 3, spot=True))
    prep = prepare_fleet_batch(system, backend="cuda", device=cuda_device)
    assert prep.spot_on and not prep.rows_on_card


@pytest.mark.parametrize("spot", [False, True])
def test_rows_stay_on_the_host_off_the_card(spot):
    """Backend "torch" on the CPU, with and without a spot tier: the numpy
    path, every row counted as the host's."""
    system = System(edge_spec(16, 2, spot=spot))
    prof = CycleProfiler()
    prof.activate()
    try:
        report = montecarlo.replay_montecarlo(system, "diurnal", 6, 3600.0, seeds=3, **CPU)
    finally:
        prof.deactivate()
    assert report["binding_rows"] == 0
    assert prof.counters.get("plan_card_rows", 0) == 0
    assert prof.counters["plan_host_rows"] == 3 * 6
    assert "plan_rows_kernel_launches" not in prof.counters
    assert not FleetBatchPrep(system, **CPU).rows_on_card


@pytest.mark.parametrize("shapes,capacity", [(1, None), (2, None), (2, 0.6)])
def test_accumulator_demand_seam_gives_the_same_envelopes(shapes, capacity, monkeypatch):
    """The accumulator fed `slab.demand` (here the numpy path's own sum,
    with the lane fold and overlay mask taken away) reports exactly what
    it reports summing the demand itself."""
    monkeypatch.setattr(montecarlo, "BINDING_FLUSH_ROWS", 4)
    spec = edge_spec(20, shapes, capacity)
    want = montecarlo.replay_montecarlo(System(spec), "diurnal", 8, 3600.0, seeds=3,
                                        per_seed=True, keep_seeds=(1,), chunk_steps=5, **CPU)
    solve = FleetBatchPrep.solve

    def with_demand(self, rates, chunk_steps=None, consume=None, needs=None,
                    validate=True, buckets=None):
        if consume is None:
            return solve(self, rates, chunk_steps=chunk_steps, validate=validate)

        def fed(slab):
            consume(dataclasses.replace(
                slab, demand=numpy_demand(buckets, slab), lane_reps=None, zmask=None))

        return solve(self, rates, chunk_steps=chunk_steps, consume=fed,
                     needs={"choice", "chips", *(needs or ())}, validate=validate)

    monkeypatch.setattr(FleetBatchPrep, "solve", with_demand)
    reset_fleet_state()
    got = montecarlo.replay_montecarlo(System(spec), "diurnal", 8, 3600.0, seeds=3,
                                       per_seed=True, keep_seeds=(1,), chunk_steps=5, **CPU)
    for report in (want, got):
        report.pop("profile")
    kept_want, kept_got = want.pop("_kept"), got.pop("_kept")
    assert got == want
    for f in kept_want[1]:
        np.testing.assert_array_equal(kept_got[1][f], kept_want[1][f], err_msg=f)
    if capacity is not None:
        assert want["binding_rows"] > 4


def test_plan_rows_refuses_the_cpu():
    lanes = cuda_queueing.PlanLanes(*(torch.zeros(1) for _ in cuda_queueing.PlanLanes._fields))
    with pytest.raises(ValueError, match="numpy path"):
        cuda_queueing.plan_rows(torch.zeros((2, 3), dtype=torch.float64), lanes, 0.1, None, {})
