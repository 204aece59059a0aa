"""Sharded controllers: consistent-hash fleet partitioning,
deterministic handoff on membership change, and the closed-loop contract
that N shards jointly reproduce the single-controller decision surface
bit-identically (each variant's unlimited-path solve is independent, so
partitioning the fleet must never change any decision).

Port of tests/test_shard.py on the port's controller and fixtures; every
Reconciler gets `compute_device="cpu"` (the profile corrector's device).
"""

import numpy as np
import pytest

from inferno_tpu_torch.controller.crd import (
    TYPE_METRICS_AVAILABLE,
    TYPE_OPTIMIZATION_READY,
)
from inferno_tpu_torch.controller.reconciler import Reconciler, ReconcilerConfig
from inferno_tpu_torch.controller.shard import ShardMap, handoff, shard_from_env
from inferno_tpu_torch.testing.fleet import (
    CONFIG_NS,
    FLEET_NS,
    fleet_cluster,
    fleet_fake_prom,
    fleet_model,
    fleet_variant,
)

# -- pure partition properties ------------------------------------------------


def names(n):
    return [f"{fleet_variant(i)}:{FLEET_NS}" for i in range(n)]


def test_membership_is_a_set():
    """Order and duplicates don't matter: two controllers configured
    with the same members in any spelling hold equal maps — the
    precondition for coordination-free agreement."""
    assert ShardMap(["b", "a", " a ", "b"]) == ShardMap(["a", "b"])
    assert ShardMap(["x"]).members == ("x",)
    with pytest.raises(ValueError):
        ShardMap([])


def test_partition_exact_cover():
    """Every name is owned by exactly one member: no double-owned, no
    orphaned — the partition is an exact cover of the fleet."""
    m = ShardMap(["ctrl-0", "ctrl-1", "ctrl-2"])
    fleet = names(200)
    buckets = m.partition(fleet)
    assert set(buckets) == set(m.members)
    flat = sorted(n for b in buckets.values() for n in b)
    assert flat == sorted(fleet)
    for member, bucket in buckets.items():
        assert bucket == m.owned(fleet, member)
        for n in bucket:
            assert m.owner(n) == member


def test_partition_roughly_balanced():
    """Rendezvous hashing spreads a large fleet near-uniformly; a badly
    skewed split would defeat the point of sharding."""
    m = ShardMap(["ctrl-0", "ctrl-1", "ctrl-2", "ctrl-3"])
    sizes = [len(b) for b in m.partition(names(4000)).values()]
    assert min(sizes) > 0.7 * (4000 / 4)
    assert max(sizes) < 1.3 * (4000 / 4)


def test_handoff_leave_moves_only_departed():
    """A leave redistributes exactly the departed member's names: every
    survivor's ownership elsewhere is untouched (the rendezvous
    minimal-movement property)."""
    old = ShardMap(["a", "b", "c"])
    new = ShardMap(["a", "b"])
    fleet = names(300)
    departed = set(old.owned(fleet, "c"))
    moves = handoff(old, new, fleet)
    assert {n for n, _, _ in moves} == departed
    for n, frm, to in moves:
        assert frm == "c" and to in ("a", "b")


def test_handoff_join_moves_only_to_joiner():
    """A join pulls an expected 1/N slice — every move lands on the
    newcomer, nothing shuffles between incumbents."""
    old = ShardMap(["a", "b"])
    new = ShardMap(["a", "b", "c"])
    fleet = names(300)
    moves = handoff(old, new, fleet)
    assert moves, "a join of 300 names must move something"
    assert all(to == "c" for _, _, to in moves)
    assert len(moves) < 0.5 * len(fleet)  # ~1/3 expected, never half


def test_membership_change_fuzz_seeded():
    """Seeded join/leave churn: after every membership change the
    partition stays an exact cover and the stated handoff is exactly
    the ownership delta (applying the moves to the old partition yields
    the new one)."""
    rng = np.random.default_rng(20)
    fleet = names(150)
    pool = [f"ctrl-{i}" for i in range(6)]
    members = {"ctrl-0", "ctrl-1"}
    current = ShardMap(members)
    for _ in range(25):
        if len(members) <= 1 or (len(members) < len(pool) and rng.random() < 0.5):
            joiner = rng.choice([p for p in pool if p not in members])
            members.add(str(joiner))
        else:
            leaver = rng.choice(sorted(members))
            members.discard(str(leaver))
        new = ShardMap(members)
        moves = handoff(current, new, fleet)
        owner_old = {n: current.owner(n) for n in fleet}
        owner_new = {n: new.owner(n) for n in fleet}
        # the move list IS the ownership delta, nothing more or less
        assert {n: (a, b) for n, a, b in moves} == {
            n: (owner_old[n], owner_new[n])
            for n in fleet if owner_old[n] != owner_new[n]
        }
        # exact cover after the change: no double-owned, no orphaned
        buckets = new.partition(fleet)
        assert sorted(n for b in buckets.values() for n in b) == sorted(fleet)
        current = new


def test_env_configuration():
    """SHARD_MEMBERS/SHARD_NAME wiring: off by default, strict on
    misconfiguration (a member name outside the set would silently own
    nothing)."""
    assert shard_from_env() == (None, "")


def test_env_misconfiguration_raises(monkeypatch):
    monkeypatch.setenv("SHARD_MEMBERS", "ctrl-0,ctrl-1")
    monkeypatch.setenv("SHARD_NAME", "ctrl-9")
    with pytest.raises(ValueError):
        shard_from_env()
    monkeypatch.delenv("SHARD_NAME")
    with pytest.raises(ValueError):
        shard_from_env()
    monkeypatch.setenv("SHARD_NAME", "ctrl-1")
    m, me = shard_from_env()
    assert me == "ctrl-1" and m.members == ("ctrl-0", "ctrl-1")


# -- closed-loop: shards jointly == single controller -------------------------

N = 10
MEMBERS = ("ctrl-0", "ctrl-1")


def rows(n=N, arrival_rps=5.0):
    return {
        (fleet_model(i), FLEET_NS): {
            "running": 3.0, "arrival_rps": arrival_rps, "in_tokens": 128.0,
            "out_tokens": 128.0, "ttft_s": 0.05, "itl_s": 0.02,
            "max_batch": 64.0,
        }
        for i in range(n)
    }


def reconciler(cluster, prom):
    cfg = ReconcilerConfig(compute_device="cpu", config_namespace=CONFIG_NS,
                           compute_backend="scalar")
    return Reconciler(kube=cluster, prom=prom, config=cfg)


def statuses(cluster, n=N):
    out = []
    for i in range(n):
        va = cluster.get_variant_autoscaling(FLEET_NS, fleet_variant(i))
        out.append((
            va.status.desired_optimized_alloc.num_replicas,
            va.status.desired_optimized_alloc.accelerator,
            va.status.current_alloc.to_dict(),
            va.status.condition(TYPE_METRICS_AVAILABLE).status,
            va.status.condition(TYPE_OPTIMIZATION_READY).status,
        ))
    return out


def run_shards(cluster, members, monkeypatch, n=N):
    """One cycle per shard member against the SAME cluster; returns the
    union decision list keyed by variant."""
    decisions = {}
    monkeypatch.setenv("SHARD_MEMBERS", ",".join(members))
    for member in members:
        monkeypatch.setenv("SHARD_NAME", member)
        rec = reconciler(cluster, fleet_fake_prom(rows(n)))
        report = rec.run_cycle()
        assert report.errors == []
        for d in report.decisions:
            assert d.variant not in decisions, "double-owned variant"
            decisions[d.variant] = d
    return decisions


def test_two_shards_jointly_reproduce_single_controller(monkeypatch):
    """The tentpole parity contract: two shards, each reconciling only
    its rendezvous-owned slice of an identical twin fleet, jointly
    actuate the exact statuses a single controller produces — decision
    surface bit-identical, every variant covered exactly once."""
    single_cluster = fleet_cluster(N)
    single = reconciler(single_cluster, fleet_fake_prom(rows()))
    report = single.run_cycle()
    assert report.errors == []
    want = statuses(single_cluster)

    shard_cluster = fleet_cluster(N)
    decisions = run_shards(shard_cluster, MEMBERS, monkeypatch)
    assert len(decisions) == N  # no orphaned variant
    assert statuses(shard_cluster) == want

    # per-variant decisions agree with the single controller's records
    by_name = {d.variant: d for d in report.decisions}
    for name, d in decisions.items():
        s = by_name[name]
        assert (d.replicas, d.accelerator, d.cost, d.reason) == (
            s.replicas, s.accelerator, s.cost, s.reason), name


def test_shard_metrics_labelled_per_member(monkeypatch):
    """Every replica exports the full partition's ownership counts under
    inferno_shard_owned_servers{shard=...} — a pure function of the
    listed fleet, identical from any member."""
    cluster = fleet_cluster(N)
    monkeypatch.setenv("SHARD_MEMBERS", ",".join(MEMBERS))
    monkeypatch.setenv("SHARD_NAME", MEMBERS[0])
    rec = reconciler(cluster, fleet_fake_prom(rows()))
    rec.run_cycle()
    owned = {m: rec.event_instruments.shard_owned.get({"shard": m})
             for m in MEMBERS}
    assert sum(owned.values()) == float(N)
    assert all(v > 0 for v in owned.values())
    expected = ShardMap(MEMBERS).partition(names(N))
    assert owned == {m: float(len(expected[m])) for m in MEMBERS}


def test_membership_change_mid_sequence_matches_fresh_single(monkeypatch):
    """Join mid-sequence: a fleet reconciled by two shards, then — after
    ctrl-2 joins — by three, lands on exactly the statuses a fresh
    single controller computes. Handoff is deterministic re-hashing, so
    no variant is skipped or actuated twice during the change."""
    cluster = fleet_cluster(N)
    run_shards(cluster, MEMBERS, monkeypatch)
    grown = MEMBERS + ("ctrl-2",)
    decisions = run_shards(cluster, grown, monkeypatch)
    assert len(decisions) == N

    fresh = fleet_cluster(N)
    monkeypatch.delenv("SHARD_MEMBERS")
    monkeypatch.delenv("SHARD_NAME")
    single = reconciler(fresh, fleet_fake_prom(rows()))
    single.run_cycle()
    assert statuses(cluster) == statuses(fresh)
