"""Event-driven reconcile triggers.

The reference controller is not purely interval-driven: reconciles are
triggered by VariantAutoscaling *create* events (update/delete filtered
out) and by edits to the named ConfigMaps, with steady state handled by
RequeueAfter (upstream internal/controller/
variantautoscaling_controller.go:456-487). This module reproduces that:
a `Watcher` wakes the reconcile loop early when

* a VariantAutoscaling is ADDED (a new variant should not wait out the
  rest of a 60s interval before its first sizing), or
* one of the controller ConfigMaps changes (config edits apply at once).

Two transports:
* in-process subscription when the kube client offers `subscribe`
  (InMemoryCluster) — used by tests and the emulated stack;
* Kubernetes watch streams (`?watch=true`, JSON-lines) against the real
  API server, with automatic reconnect and jittered backoff.

Event-driven reconcile: beyond waking the loop, events now
carry WHICH variant changed. A `DirtyQueue` coalesces those names
across a debounce window; the reconciler drains it at cycle start and
feeds the set into the targeted incremental scan
(`FleetSnapshot.scan_event_update`) instead of diffing the whole fleet.
Three dirty sources:

* **watch** — VA ADDED/MODIFIED/DELETED events mark the named variant
  (ADDED additionally wakes the loop, reference parity);
* **lambda** — the grouped collector (or any λ-delta observer) marks
  variants whose arrival rate moved, with a debounced wake;
* **config** — watched-ConfigMap edits mark the WHOLE fleet dirty
  (`mark_all`): the next cycle runs the full poll scan.

Every `EVENT_ANTI_ENTROPY_CYCLES`-th drain is deliberately
non-authoritative (returns None) so a periodic full scan bounds any
drift from missed events.

Port copy of `inferno_tpu/controller/watch.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Iterable

from inferno_tpu_torch.config.defaults import env_float, env_int
from inferno_tpu_torch.controller.constants import (
    CM_ACCELERATOR_COSTS,
    CM_CONFIG,
    CM_SERVICE_CLASSES,
)
from inferno_tpu_torch.controller.crd import GROUP, PLURAL, VERSION

WATCHED_CONFIGMAPS = (CM_CONFIG, CM_ACCELERATOR_COSTS, CM_SERVICE_CLASSES)

# Coalescing window of the event-driven wake path: wakes within this
# many seconds of the previous one are absorbed into the same targeted
# cycle (storm -> one cycle), and the reconciler sleeps this long after
# a wake before draining so the burst lands in ONE dirty set. 0 disables
# coalescing (every wake is immediate).
EVENT_DEBOUNCE_SECONDS = env_float("EVENT_DEBOUNCE_SECONDS", 0.2)
# Every Nth drain of the DirtyQueue is non-authoritative: the cycle runs
# the full poll scan (anti-entropy), bounding the staleness of anything
# an event source failed to report.
EVENT_ANTI_ENTROPY_CYCLES = max(env_int("EVENT_ANTI_ENTROPY_CYCLES", 32), 1)

# dirty-source tags (docs/performance.md "Event-driven reconcile")
SOURCE_WATCH = "watch"
SOURCE_LAMBDA = "lambda"
SOURCE_CONFIG = "config"
SOURCE_ACTUATE = "actuate"  # reconciler self-mark: just-actuated variants


class DirtyQueue:
    """Coalescing dirty-variant set between the event sources and the
    reconciler's targeted cycle.

    `mark(names)` is called from watch/collector threads; `drain()` from
    the reconcile thread at cycle start. Wakes are debounced on the
    leading edge: the first mark of a quiet period fires `wake_fn`
    immediately, further marks inside the window coalesce silently (the
    cycle the first wake triggers drains them all). The clock is
    injectable (INF005) so tests drive the window deterministically.

    `drain()` returns the coalesced name list — or None when the cycle
    must NOT trust the event sources and run the full poll scan instead:
    after a `mark_all` (config change), and on the periodic anti-entropy
    cadence (every `anti_entropy_cycles`-th drain).
    """

    def __init__(
        self,
        wake: Callable[[], None] | None = None,
        debounce_s: float | None = None,
        anti_entropy_cycles: int | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.wake_fn = wake
        self.debounce_s = (
            EVENT_DEBOUNCE_SECONDS if debounce_s is None else debounce_s
        )
        self.anti_entropy_cycles = (
            EVENT_ANTI_ENTROPY_CYCLES
            if anti_entropy_cycles is None
            else max(anti_entropy_cycles, 1)
        )
        self.clock = clock
        self._lock = threading.Lock()
        self._names: dict[str, str] = {}  # name -> source (last writer wins)
        self._all_dirty = False
        self._last_wake: float | None = None
        self._drains = 0
        # observability counters (EventInstruments reads them per cycle)
        self.marks = 0  # names marked (incl. re-marks of a pending name)
        self.wakes_fired = 0
        self.wakes_coalesced = 0

    def depth(self) -> int:
        """Pending distinct dirty names (the queue-depth gauge)."""
        with self._lock:
            return len(self._names)

    def mark(
        self,
        names: Iterable[str],
        source: str = SOURCE_WATCH,
        wake: bool = True,
    ) -> None:
        """Mark variants dirty; optionally request a (debounced) wake."""
        fire = False
        with self._lock:
            for name in names:
                self._names[name] = source
                self.marks += 1
            if wake:
                now = self.clock()
                if (
                    self._last_wake is None
                    or now - self._last_wake >= self.debounce_s
                ):
                    self._last_wake = now
                    self.wakes_fired += 1
                    fire = True
                else:
                    self.wakes_coalesced += 1
        if fire and self.wake_fn is not None:
            self.wake_fn()  # outside the lock: wake_fn may re-enter

    def mark_all(self, source: str = SOURCE_CONFIG, wake: bool = True) -> None:
        """Global doubt (config edit): the next drain is non-authoritative."""
        with self._lock:
            self._all_dirty = True
        self.mark((), source=source, wake=wake)

    def drain(self) -> list[str] | None:
        """Swap out the pending set. A name list (possibly empty) means
        the event sources are authoritative for this cycle; None means
        run the full poll scan (config change or anti-entropy due)."""
        with self._lock:
            names = sorted(self._names)
            self._names.clear()
            all_dirty = self._all_dirty
            self._all_dirty = False
            self._drains += 1
            anti_entropy = self._drains % self.anti_entropy_cycles == 0
        if all_dirty or anti_entropy:
            return None
        return names


class Watcher:
    """Wakes `wake()` on VA creation and watched-ConfigMap changes; with
    a `DirtyQueue` attached, also marks WHICH variant each event names
    (the targeted-cycle feed).

    `sleep` is the reconnect-backoff timing seam (defaults to the stop
    event's wait, so `stop()` interrupts a backoff immediately); tests
    inject a deterministic substitute (INF005: no free-running waits)."""

    def __init__(
        self,
        kube,
        wake: Callable[[], None],
        config_namespace: str,
        dirty: DirtyQueue | None = None,
        sleep: Callable[[float], object] | None = None,
    ):
        self.kube = kube
        self.wake = wake
        self.config_namespace = config_namespace
        self.dirty = dirty
        self._stop = threading.Event()
        self._sleep = sleep if sleep is not None else self._stop.wait
        self._threads: list[threading.Thread] = []

    # -- event filtering (reference parity) ----------------------------------

    def _on_va_event(
        self, event_type: str, name: str = "", namespace: str = ""
    ) -> None:
        # every named event marks its variant dirty (the targeted scan
        # re-verifies the claim, so marking DELETED/MODIFIED is safe) …
        if (
            self.dirty is not None
            and name
            and event_type in ("ADDED", "MODIFIED", "DELETED")
        ):
            self.dirty.mark(
                (f"{name}:{namespace}",), source=SOURCE_WATCH, wake=False
            )
        # … but only creation wakes the loop early, like the reference's
        # event filter (controller.go:473-486); modifications ride the
        # interval (RequeueAfter steady state)
        if event_type == "ADDED":
            self.wake()

    def _on_cm_event(self, name: str, namespace: str) -> None:
        if namespace == self.config_namespace and name in WATCHED_CONFIGMAPS:
            if self.dirty is not None:
                # a config edit can change any variant's sizing inputs:
                # whole-fleet doubt, next cycle runs the full poll scan
                self.dirty.mark_all(source=SOURCE_CONFIG, wake=False)
            self.wake()

    # -- in-process transport ------------------------------------------------

    def _subscribe_local(self) -> bool:
        subscribe = getattr(self.kube, "subscribe", None)
        if subscribe is None:
            return False

        def on_event(kind: str, event_type: str, namespace: str, name: str):
            if kind == "VariantAutoscaling":
                self._on_va_event(event_type, name, namespace)
            elif kind == "ConfigMap":
                self._on_cm_event(name, namespace)

        subscribe(on_event)
        return True

    # -- API-server watch streams --------------------------------------------

    def _stream(self, base_path: str, handle) -> None:
        """List-then-watch with reconnect, tracking resourceVersion so a
        reconnect resumes where the stream left off instead of replaying
        every existing object as a synthetic ADDED (which would defeat
        the create-only filter at each server-side timeout)."""
        import http.client

        backoff = 1.0
        rv: str | None = None
        while not self._stop.is_set():
            try:
                if rv is None:
                    # list to learn the current resourceVersion; the watch
                    # then starts "now", with no initial replay burst
                    req = self.kube.watch_request(base_path)
                    with urllib.request.urlopen(
                        req, context=self.kube.ctx, timeout=30
                    ) as resp:
                        body = json.loads(resp.read())
                    rv = str((body.get("metadata") or {}).get("resourceVersion") or "")
                # bookmarks keep rv fresh across quiet periods, so a
                # reconnect rv is unlikely to be compaction-stale
                path = (
                    f"{base_path}?watch=true&timeoutSeconds=300"
                    "&allowWatchBookmarks=true"
                )
                if rv:
                    path += f"&resourceVersion={rv}"
                req = self.kube.watch_request(path)
                with urllib.request.urlopen(
                    req, context=self.kube.ctx, timeout=330
                ) as resp:
                    backoff = 1.0
                    for line in resp:
                        if self._stop.is_set():
                            return
                        if not line.strip():
                            continue
                        try:
                            evt = json.loads(line)
                        except json.JSONDecodeError:
                            continue
                        if evt.get("type") == "ERROR":
                            rv = None  # e.g. 410 Gone: relist and resume
                            break
                        meta = (evt.get("object") or {}).get("metadata") or {}
                        new_rv = meta.get("resourceVersion")
                        if new_rv:
                            rv = str(new_rv)
                        if evt.get("type") == "BOOKMARK":
                            continue  # rv refresh only, no user event
                        try:
                            handle(evt)
                        except (KeyError, TypeError):
                            continue
            except urllib.error.HTTPError as e:
                if e.code == 410:
                    # compacted resourceVersion rejected at establishment
                    # (not as an in-stream ERROR event): relist
                    rv = None
            except (OSError, http.client.HTTPException, json.JSONDecodeError):
                # connection-level and mid-stream failures (IncompleteRead
                # is an HTTPException, not an OSError) both just reconnect
                pass
            except Exception:
                # Anything else (a kube client without .ctx, an unexpected
                # watch_request error, …) must not kill the stream thread
                # silently — that would permanently degrade the controller
                # to interval-only reconciles with no trace. Log, resync,
                # and reconnect with backoff like any other failure.
                self._log().exception("watch stream error on %s", base_path)
                rv = None
            self._sleep(backoff)
            backoff = min(backoff * 2, 30.0)

    @staticmethod
    def _log():
        from inferno_tpu_torch.controller.logger import get_logger

        return get_logger("inferno.watch")

    def _run_va_stream(self) -> None:
        def handle(evt: dict) -> None:
            meta = (evt.get("object", {}) or {}).get("metadata", {}) or {}
            self._on_va_event(
                evt.get("type", ""),
                meta.get("name", ""),
                meta.get("namespace", ""),
            )

        self._stream(f"/apis/{GROUP}/{VERSION}/{PLURAL}", handle)

    def _run_cm_stream(self) -> None:
        def handle(evt: dict) -> None:
            meta = (evt.get("object", {}) or {}).get("metadata", {}) or {}
            self._on_cm_event(meta.get("name", ""), meta.get("namespace", ""))

        self._stream(f"/api/v1/namespaces/{self.config_namespace}/configmaps", handle)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._subscribe_local():
            return
        if not hasattr(self.kube, "watch_request"):
            return  # client offers neither transport; interval-only
        for target in (self._run_va_stream, self._run_cm_stream):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
