"""Lease-based leader election.

The reference delegates leader election to controller-runtime with lease
ID `72dd1cf1.llm-d.ai` (upstream cmd/main.go:74-76,206-207). This
is the same protocol, implemented against the coordination.k8s.io Lease
API: acquire when the lease is free or expired, renew while holding,
step back when another holder renews first. Timings default to the
client-go/controller-runtime values (15s lease, 10s renew deadline, 2s
retry period).

Optimistic concurrency: every write carries the lease's
resourceVersion; a Conflict means another candidate won the race and is
treated as "not leader this round". The elector itself keeps no state
beyond the last observed lease, so a crashed leader is taken over one
lease-duration later — and because the reconcile loop is stateless
(SURVEY §5.4), the new leader resumes cleanly from CR status.

Port copy of `inferno_tpu/controller/leader.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import threading
import time

from inferno_tpu_torch.controller.kube import Conflict, KubeError, NotFound

LEASE_NAME = "inferno-tpu-autoscaler-leader"

# client-go defaults (controller-runtime LeaderElectionConfig)
LEASE_DURATION_SECONDS = 15
RENEW_DEADLINE_SECONDS = 10
RETRY_PERIOD_SECONDS = 2


def _now() -> datetime.datetime:
    return datetime.datetime.now(datetime.timezone.utc)


def _fmt(t: datetime.datetime) -> str:
    return t.strftime("%Y-%m-%dT%H:%M:%S.%f") + "Z"


def _parse(s: str) -> datetime.datetime | None:
    if not s:
        return None
    try:
        return datetime.datetime.fromisoformat(s.replace("Z", "+00:00"))
    except ValueError:
        return None


@dataclasses.dataclass
class LeaderElector:
    kube: object  # KubeClient with get_lease/create_lease/update_lease
    identity: str
    namespace: str
    lease_name: str = LEASE_NAME
    lease_duration: float = LEASE_DURATION_SECONDS
    renew_deadline: float = RENEW_DEADLINE_SECONDS
    retry_period: float = RETRY_PERIOD_SECONDS

    def __post_init__(self) -> None:
        self._held_since: float | None = None
        self._last_renew: float = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # last observed (holder, renewTime) and the local monotonic time of
        # that observation — expiry is judged from OUR clock, like
        # client-go, so holder clock skew cannot cause a spurious takeover
        self._observed: tuple[str, str] | None = None
        self._observed_at: float = 0.0
        self._fail_reported = False

    # -- leadership state ----------------------------------------------------

    def is_leader(self) -> bool:
        """Held and renewed within the renew deadline."""
        return (
            self._held_since is not None
            and time.monotonic() - self._last_renew < self.renew_deadline
        )

    # -- protocol ------------------------------------------------------------

    def _spec(self, transitions: int) -> dict:
        now = _fmt(_now())
        return {
            "holderIdentity": self.identity,
            # the Lease API takes whole seconds; round up so a sub-second
            # configured duration never serializes as 0 (= instantly expired)
            "leaseDurationSeconds": max(1, int(math.ceil(self.lease_duration))),
            "acquireTime": now,
            "renewTime": now,
            "leaseTransitions": transitions,
        }

    def try_acquire_or_renew(self) -> bool:
        """One election round; returns current leadership."""
        try:
            lease = self.kube.get_lease(self.namespace, self.lease_name)
        except NotFound:
            lease = None
        except (KubeError, OSError) as e:
            # OSError covers connection-level failures (URLError, timeouts)
            # that bypass the HTTP error mapping
            self._note_failure("lease read failed", e)
            return self._lost()

        try:
            if lease is None:
                self.kube.create_lease(
                    self.namespace, self.lease_name, {"spec": self._spec(0)}
                )
                return self._won()

            spec = lease.get("spec", {}) or {}
            holder = spec.get("holderIdentity", "")
            renew_raw = spec.get("renewTime", "")
            duration = float(spec.get("leaseDurationSeconds", self.lease_duration))
            # clock-skew-safe expiry: the lease is expired when WE have
            # observed the same (holder, renewTime) for longer than the
            # duration — the holder's wall clock is never trusted
            observation = (holder, renew_raw)
            if observation != self._observed:
                self._observed = observation
                self._observed_at = time.monotonic()
            expired = (
                not renew_raw
                or _parse(renew_raw) is None
                or time.monotonic() - self._observed_at > duration
            )

            if holder == self.identity:
                new_spec = dict(spec)
                new_spec["renewTime"] = _fmt(_now())
                new_spec["holderIdentity"] = self.identity
                lease["spec"] = new_spec
                self.kube.update_lease(self.namespace, self.lease_name, lease)
                return self._won()

            if not holder or expired:
                # empty holder = voluntarily released; acquirable at once
                transitions = int(spec.get("leaseTransitions", 0)) + 1
                lease["spec"] = self._spec(transitions)
                self.kube.update_lease(self.namespace, self.lease_name, lease)
                return self._won()

            return self._lost()
        except Conflict:
            # another candidate raced us; observe again next round
            return self._lost()
        except (KubeError, OSError) as e:
            # persistent write failures (e.g. RBAC Forbidden) must be
            # visible: a silent non-leader gates reconciliation forever
            self._note_failure("lease write failed", e)
            return self._lost()

    def _note_failure(self, what: str, err: Exception) -> None:
        if not self._fail_reported:
            from inferno_tpu_torch.controller.logger import get_logger

            get_logger("inferno.leader").warning(
                "%s for %s/%s: %s", what, self.namespace, self.lease_name, err
            )
            self._fail_reported = True

    def _won(self) -> bool:
        if self._held_since is None:
            self._held_since = time.monotonic()
        self._last_renew = time.monotonic()
        self._fail_reported = False
        return True

    def _lost(self) -> bool:
        self._held_since = None
        return False

    # -- background loop -----------------------------------------------------

    def start(self) -> None:
        def loop():
            import logging

            from inferno_tpu_torch.controller.logger import get_logger

            log = get_logger("inferno.leader")
            while not self._stop.is_set():
                try:
                    self.try_acquire_or_renew()
                except Exception:  # the election thread must never die:
                    # a dead thread stalls is_leader() (and reconciliation)
                    # forever on every replica
                    self._lost()
                    log.exception("election round failed")
                self._stop.wait(self.retry_period)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self, release: bool = True) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        if release and self._held_since is not None:
            # voluntary hand-off: clear the holder (client-go's release
            # semantics) so the next candidate can take over immediately
            # instead of waiting out the lease
            try:
                lease = self.kube.get_lease(self.namespace, self.lease_name)
                spec = lease.get("spec", {}) or {}
                if spec.get("holderIdentity") == self.identity:
                    spec["holderIdentity"] = ""
                    lease["spec"] = spec
                    self.kube.update_lease(self.namespace, self.lease_name, lease)
            except (KubeError, OSError):
                pass  # shutdown must not raise; the lease just times out
        self._held_since = None
