"""Lease-based leader election (reference: controller-runtime election,
cmd/main.go:74-76,206-207), on the port's `LeaderElector`.

Port of tests/test_leader.py. Lease expiry and the renew deadline run on
an injected monotonic clock (`lease_clock`): a test steps past a
duration instead of sleeping through it.
"""

import time

import pytest

from inferno_tpu_torch.controller.kube import Conflict, InMemoryCluster, NotFound
from inferno_tpu_torch.controller.leader import LeaderElector

from test_torch_apiserver import lease_clock  # noqa: F401 (fixture)

NS = "inferno-system"


def elector(cluster, identity, **kw):
    # leaseDurationSeconds serializes in whole seconds, so test timings
    # run at 1s scale
    kw.setdefault("lease_duration", 1.0)
    kw.setdefault("renew_deadline", 0.8)
    kw.setdefault("retry_period", 0.05)
    return LeaderElector(kube=cluster, identity=identity, namespace=NS, **kw)


def test_first_candidate_acquires():
    cluster = InMemoryCluster()
    a = elector(cluster, "a")
    assert a.try_acquire_or_renew()
    assert a.is_leader()
    lease = cluster.get_lease(NS, a.lease_name)
    assert lease["spec"]["holderIdentity"] == "a"


def test_second_candidate_blocked_while_held():
    cluster = InMemoryCluster()
    a, b = elector(cluster, "a"), elector(cluster, "b")
    assert a.try_acquire_or_renew()
    assert not b.try_acquire_or_renew()
    assert not b.is_leader()


def _poll_until_leader(e, clock, timeout=3.0, step=0.05):
    """Election rounds `step` apart on the lease clock, for at most
    `timeout` seconds of it."""
    waited = 0.0
    while waited < timeout:
        if e.try_acquire_or_renew():
            return True
        clock.advance(step)
        waited += step
    return False


def test_takeover_after_expiry(lease_clock):
    cluster = InMemoryCluster()
    a, b = elector(cluster, "a"), elector(cluster, "b")
    assert a.try_acquire_or_renew()
    # expiry is judged from the observer's clock (clock-skew safe): b must
    # watch the same unrenewed (holder, renewTime) for a full duration
    assert not b.try_acquire_or_renew()
    lease_clock.advance(0.9)
    assert not b.try_acquire_or_renew()  # not yet a full duration
    assert _poll_until_leader(b, lease_clock)
    assert b.is_leader()
    lease = cluster.get_lease(NS, b.lease_name)
    assert lease["spec"]["holderIdentity"] == "b"
    assert lease["spec"]["leaseTransitions"] == 1
    # the stale holder observes the loss on its next round
    assert not a.try_acquire_or_renew()
    assert not a.is_leader()


def test_renewal_keeps_leadership(lease_clock):
    cluster = InMemoryCluster()
    a, b = elector(cluster, "a"), elector(cluster, "b")
    assert a.try_acquire_or_renew()
    for _ in range(3):
        lease_clock.advance(0.4)
        assert a.try_acquire_or_renew()
        assert not b.try_acquire_or_renew()
    assert a.is_leader()


def test_leadership_lapses_without_renewal(lease_clock):
    cluster = InMemoryCluster()
    a = elector(cluster, "a")
    assert a.try_acquire_or_renew()
    lease_clock.advance(0.75)
    assert a.is_leader()  # within renew_deadline
    lease_clock.advance(0.1)  # past renew_deadline
    assert not a.is_leader()


def test_conflict_race_yields_not_leader(lease_clock):
    """b races c for an expired lease and loses: b's write carries the
    resourceVersion of the lease it read before c's takeover, so the
    optimistic-concurrency check rejects it and b stays a non-leader."""
    cluster = InMemoryCluster()
    a = elector(cluster, "a")
    assert a.try_acquire_or_renew()
    stale = cluster.get_lease(NS, a.lease_name)  # rv as of a's acquisition

    b, c = elector(cluster, "b"), elector(cluster, "c")
    assert _poll_until_leader(c, lease_clock)  # bumps the rv past the stale copy

    # b's reads are frozen at the pre-takeover lease: it sees holder a,
    # unrenewed, waits out the duration, then writes with the stale rv
    orig_get = cluster.get_lease
    cluster.get_lease = lambda ns, name: dict(stale)
    try:
        assert not _poll_until_leader(b, lease_clock, timeout=2.0)
        assert not b.is_leader()
    finally:
        cluster.get_lease = orig_get
    assert cluster.get_lease(NS, b.lease_name)["spec"]["holderIdentity"] == "c"


def test_voluntary_release_enables_immediate_takeover():
    cluster = InMemoryCluster()
    a, b = elector(cluster, "a"), elector(cluster, "b")
    assert a.try_acquire_or_renew()
    a.stop(release=True)
    assert b.try_acquire_or_renew()
    assert b.is_leader()


def test_background_loop_and_gate():
    cluster = InMemoryCluster()
    a = elector(cluster, "a")
    a.start()
    deadline = time.time() + 2
    while not a.is_leader() and time.time() < deadline:
        time.sleep(0.02)
    assert a.is_leader()
    a.stop()
    assert not a.is_leader()


def test_inmemory_lease_optimistic_concurrency():
    cluster = InMemoryCluster()
    with pytest.raises(NotFound):
        cluster.get_lease(NS, "x")
    created = cluster.create_lease(NS, "x", {"spec": {"holderIdentity": "a"}})
    assert created["metadata"]["resourceVersion"] == "1"
    with pytest.raises(Conflict):
        cluster.create_lease(NS, "x", {"spec": {}})
    stale = dict(created)
    updated = cluster.update_lease(NS, "x", created)
    assert updated["metadata"]["resourceVersion"] == "2"
    with pytest.raises(Conflict):
        cluster.update_lease(NS, "x", stale)
