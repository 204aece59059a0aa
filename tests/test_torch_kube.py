"""kube utility tests: the exponential-backoff wrapper every API-server
call rides (reference: internal/utils/utils.go:31-104), on the port's
`controller.kube`. Port of tests/test_kube.py."""

import urllib.error

import pytest

from inferno_tpu_torch.controller import kube as K
from inferno_tpu_torch.controller.kube import Conflict, KubeError, NotFound, with_backoff


@pytest.fixture(autouse=True)
def no_sleep(monkeypatch):
    sleeps = []
    monkeypatch.setattr(K.time, "sleep", sleeps.append)
    return sleeps


def test_retries_conflict_then_succeeds(no_sleep):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) < 3:
            raise Conflict("409")
        return "ok"

    assert with_backoff(fn) == "ok"
    assert len(calls) == 3
    # exponential: each retry waits longer than the one before
    assert len(no_sleep) == 2 and no_sleep[1] > no_sleep[0]


def test_url_errors_are_retriable(no_sleep):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) == 1:
            raise urllib.error.URLError("connection refused")
        return 7

    assert with_backoff(fn) == 7


def test_non_retriable_raises_immediately(no_sleep):
    calls = []

    def fn():
        calls.append(1)
        raise NotFound("404")

    with pytest.raises(NotFound):
        with_backoff(fn)
    assert len(calls) == 1 and no_sleep == []


def test_exhaustion_raises_last_error(no_sleep):
    calls = []

    def fn():
        calls.append(1)
        raise Conflict(f"attempt {len(calls)}")

    with pytest.raises(Conflict, match=f"attempt {K.BACKOFF_STEPS}"):
        with_backoff(fn)
    assert len(calls) == K.BACKOFF_STEPS


def test_custom_retriable_set(no_sleep):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) == 1:
            raise KubeError("transient")
        return "done"

    assert with_backoff(fn, retriable=(KubeError,)) == "done"


def test_backoff_schedule_matches_reference():
    """Standard schedule: initial delay doubling per step (the reference
    uses 100ms x 2^5, utils.go:31-55)."""
    assert K.BACKOFF_STEPS >= 3
    assert 0 < K.BACKOFF_INITIAL <= 1.0
    assert K.BACKOFF_FACTOR == 2.0
