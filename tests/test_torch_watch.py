"""Event-driven reconcile triggers (reference watch config:
variantautoscaling_controller.go:456-487 — VA create-only + named
ConfigMaps), on the port's `controller.watch`.

Port of tests/test_watch.py; every Reconciler gets `compute_device="cpu"`
(the profile corrector's device).
"""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from inferno_tpu_torch.controller.kube import InMemoryCluster
from inferno_tpu_torch.controller.reconciler import Reconciler, ReconcilerConfig
from inferno_tpu_torch.controller.watch import (
    WATCHED_CONFIGMAPS,
    DirtyQueue,
    Watcher,
)

from test_torch_apiserver import CFG_NS, make_cluster, make_prom, wait_for


def test_va_create_wakes_update_does_not():
    cluster = InMemoryCluster()
    woke = []
    w = Watcher(cluster, lambda: woke.append(1), config_namespace=CFG_NS)
    w.start()
    cluster.set_configmap(CFG_NS, "inferno-autoscaler-config", {"k": "v"})
    assert len(woke) == 1  # watched ConfigMap created
    cluster.set_configmap(CFG_NS, "inferno-autoscaler-config", {"k": "v2"})
    assert len(woke) == 2  # and modified
    cluster.set_configmap(CFG_NS, "unrelated-cm", {"k": "v"})
    assert len(woke) == 2  # unrelated ConfigMap ignored
    cluster.set_configmap("elsewhere", "inferno-autoscaler-config", {"k": "v"})
    assert len(woke) == 2  # right name, wrong namespace

    from inferno_tpu_torch.controller.crd import VariantAutoscaling, VariantAutoscalingSpec

    va = VariantAutoscaling(name="x", namespace="ns",
                            spec=VariantAutoscalingSpec(model_id="m"))
    cluster.add_variant_autoscaling(va)
    assert len(woke) == 3  # VA ADDED wakes
    cluster.add_variant_autoscaling(va)
    assert len(woke) == 3  # VA MODIFIED filtered (create-only, reference parity)
    w.stop()


def test_poke_interrupts_interval_sleep():
    cluster = make_cluster(replicas=1)
    # long interval: without the wake, the second cycle would be a minute out
    cluster.set_configmap(CFG_NS, "inferno-autoscaler-config",
                          {"GLOBAL_OPT_INTERVAL": "60s"})
    rec = Reconciler(kube=cluster, prom=make_prom(arrival_rps=5.0),
                     config=ReconcilerConfig(compute_device="cpu", config_namespace=CFG_NS,
                                             compute_backend="scalar"))
    cycles = []
    orig = rec.run_cycle
    rec.run_cycle = lambda: (cycles.append(time.time()), orig())[1]
    stopping = {"stop": False}
    t = threading.Thread(
        target=lambda: rec.run_forever(stop_check=lambda: stopping["stop"])
    )
    t.start()
    try:
        deadline = time.time() + 2
        while not cycles and time.time() < deadline:
            time.sleep(0.02)
        assert cycles, "first cycle never ran"
        n = len(cycles)
        rec.poke()
        deadline = time.time() + 2
        while len(cycles) <= n and time.time() < deadline:
            time.sleep(0.02)
        assert len(cycles) > n, "poke did not trigger an early cycle"
    finally:
        # stop + poke, as main's signal handler does, so shutdown does not
        # wait out the 60s interval
        stopping["stop"] = True
        rec.poke()
        t.join(timeout=5)
    assert not t.is_alive()


class _StreamingWatchServer:
    """Fake API server: answers the initial list (resourceVersion), then
    streams watch events as JSON lines."""

    def __init__(self, events):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                if "watch=true" not in self.path:
                    outer.list_requests.append(self.path)
                    self.wfile.write(
                        json.dumps({"metadata": {"resourceVersion": "41"},
                                    "items": []}).encode()
                    )
                    return
                outer.watch_requests.append(self.path)
                for evt in outer.events:
                    self.wfile.write((json.dumps(evt) + "\n").encode())
                    self.wfile.flush()
                    time.sleep(0.02)
                outer.done.set()
                time.sleep(1)  # hold the stream open briefly

            def log_message(self, *a):
                pass

        self.events = events
        self.done = threading.Event()
        self.list_requests: list[str] = []
        self.watch_requests: list[str] = []
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_port
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def stop(self):
        self.httpd.shutdown()


class _FakeRestKube:
    """Just enough of RestKubeClient for the stream transport."""

    def __init__(self, base_url):
        self.base_url = base_url
        self.ctx = None
        self.token = ""

    def watch_request(self, path: str):
        import urllib.request

        return urllib.request.Request(self.base_url + path)


def test_http_watch_stream_wakes_on_va_added():
    events = [
        {"type": "ADDED", "object": {"kind": "VariantAutoscaling"}},
        {"type": "MODIFIED", "object": {"kind": "VariantAutoscaling"}},
        {"type": "ADDED", "object": {"kind": "VariantAutoscaling"}},
    ]
    srv = _StreamingWatchServer(events)
    woke = []
    w = Watcher(_FakeRestKube(f"http://127.0.0.1:{srv.port}"),
                lambda: woke.append(1), config_namespace=CFG_NS)
    # drive only the VA stream (the CM stream would hit the same fake)
    t = threading.Thread(target=w._run_va_stream, daemon=True)
    t.start()
    assert srv.done.wait(5)
    assert wait_for(lambda: len(woke) >= 2, timeout=2.0)  # the client caught up
    w.stop()
    srv.stop()
    assert len(woke) == 2  # two ADDED, MODIFIED filtered
    # list-then-watch: the watch carried the listed resourceVersion, so a
    # reconnect would not replay existing objects as synthetic ADDEDs
    assert srv.list_requests and "watch" not in srv.list_requests[0]
    assert "resourceVersion=41" in srv.watch_requests[0]


def test_http_watch_recovers_from_410_gone():
    """A compacted resourceVersion rejected at watch establishment (HTTP
    410 before any ERROR event) must trigger a relist, not a dead retry
    loop: the first list hands out a soon-compacted rv=41; the watch at
    rv=41 is rejected with 410; the relist returns rv=42 and the watch at
    rv=42 streams an event."""
    events = [{"type": "ADDED", "object": {"kind": "VariantAutoscaling",
                                           "metadata": {"resourceVersion": "50"}}}]
    state = {"lists": 0, "gones": 0}
    srv_done = threading.Event()

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            if "watch=true" not in self.path:
                state["lists"] += 1
                rv = "41" if state["lists"] == 1 else "42"
                body = json.dumps({"metadata": {"resourceVersion": rv},
                                   "items": []}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if "resourceVersion=41" in self.path:
                state["gones"] += 1
                self.send_response(410)
                self.end_headers()
                return
            self.send_response(200)
            self.end_headers()
            for evt in events:
                self.wfile.write((json.dumps(evt) + "\n").encode())
                self.wfile.flush()
            srv_done.set()
            time.sleep(0.5)

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()

    woke = []
    w = Watcher(_FakeRestKube(f"http://127.0.0.1:{httpd.server_port}"),
                lambda: woke.append(1), config_namespace=CFG_NS)
    t = threading.Thread(target=w._run_va_stream, daemon=True)
    t.start()
    assert srv_done.wait(10)
    assert wait_for(lambda: len(woke) >= 1, timeout=2.0)  # the client caught up
    w.stop()
    httpd.shutdown()
    assert state["gones"] == 1  # stale rv rejected exactly once
    assert state["lists"] == 2  # initial list + post-410 relist
    assert len(woke) == 1


def test_http_watch_stream_wakes_on_watched_cm():
    events = [
        {"type": "MODIFIED", "object": {"kind": "ConfigMap", "metadata":
            {"name": WATCHED_CONFIGMAPS[0], "namespace": CFG_NS}}},
        {"type": "MODIFIED", "object": {"kind": "ConfigMap", "metadata":
            {"name": "other", "namespace": CFG_NS}}},
    ]
    srv = _StreamingWatchServer(events)
    woke = []
    w = Watcher(_FakeRestKube(f"http://127.0.0.1:{srv.port}"),
                lambda: woke.append(1), config_namespace=CFG_NS)
    t = threading.Thread(target=w._run_cm_stream, daemon=True)
    t.start()
    assert srv.done.wait(5)
    assert wait_for(lambda: len(woke) >= 1, timeout=2.0)  # the client caught up
    w.stop()
    srv.stop()
    assert len(woke) == 1


def test_watch_stream_survives_unexpected_exception():
    """An exception outside the anticipated set (here: a kube client whose
    watch_request itself raises) must not kill the stream thread silently
    — it logs, backs off, and reconnects."""
    calls = []

    class BrokenKube:
        def watch_request(self, path):
            calls.append(path)
            raise AttributeError("no ctx on this client")

    w = Watcher(BrokenKube(), lambda: None, config_namespace=CFG_NS)
    t = threading.Thread(target=w._run_va_stream, daemon=True)
    t.start()
    deadline = time.time() + 5
    while len(calls) < 2 and time.time() < deadline:
        time.sleep(0.05)
    assert t.is_alive()
    assert len(calls) >= 2  # retried after the unexpected exception
    w.stop()


def test_bookmark_refreshes_rv_without_waking():
    """BOOKMARK events keep resourceVersion fresh across quiet periods but
    must not trigger reconciles; garbage lines are skipped; the rv carried
    into the NEXT watch is the newest seen mid-stream (the MODIFIED
    event's 100, not the listed 41)."""
    events = [
        {"type": "BOOKMARK", "object": {"metadata": {"resourceVersion": "99"}}},
    ]
    srv = _StreamingWatchServer(events)
    # interleave a malformed line by monkeypatching the event list with a
    # sentinel the server writes verbatim
    srv.events = [
        {"type": "BOOKMARK", "object": {"metadata": {"resourceVersion": "99"}}},
        "this is not json",
        {"type": "MODIFIED", "object": {"kind": "VariantAutoscaling",
                                        "metadata": {"resourceVersion": "100"}}},
    ]

    # the fake server json.dumps each event; emit the garbage raw instead
    real_dumps = json.dumps

    def dumps(obj, *a, **k):
        if isinstance(obj, str):
            return obj  # write the malformed line as-is
        return real_dumps(obj, *a, **k)

    woke = []
    w = Watcher(_FakeRestKube(f"http://127.0.0.1:{srv.port}"),
                lambda: woke.append(1), config_namespace=CFG_NS)
    import unittest.mock as mock

    with mock.patch("test_torch_watch.json.dumps", side_effect=dumps):
        t = threading.Thread(target=w._run_va_stream, daemon=True)
        t.start()
        assert srv.done.wait(5)
        # wait for the RECONNECT watch request carrying the updated rv
        deadline = time.time() + 5
        while len(srv.watch_requests) < 2 and time.time() < deadline:
            time.sleep(0.05)
    w.stop()
    srv.stop()
    assert woke == []  # neither BOOKMARK, garbage, nor MODIFIED wake
    assert len(srv.watch_requests) >= 2
    # reconnect resumed from the newest rv seen mid-stream (100), so no
    # replay of older events
    assert "resourceVersion=100" in srv.watch_requests[1]


def test_cm_event_namespace_filter():
    """A watched ConfigMap name in the WRONG namespace must not wake."""
    woke = []
    w = Watcher(object(), lambda: woke.append(1), config_namespace=CFG_NS)
    w._on_cm_event(WATCHED_CONFIGMAPS[0], "elsewhere")
    assert woke == []
    w._on_cm_event(WATCHED_CONFIGMAPS[0], CFG_NS)
    assert woke == [1]
    w._on_cm_event("unwatched-cm", CFG_NS)
    assert woke == [1]


def test_va_event_type_filter():
    woke = []
    w = Watcher(object(), lambda: woke.append(1), config_namespace=CFG_NS)
    for t in ("MODIFIED", "DELETED", "BOOKMARK", "ERROR", ""):
        w._on_va_event(t)
    assert woke == []
    w._on_va_event("ADDED")
    assert woke == [1]


# -- DirtyQueue: coalescing dirty sets ----------------------------------------


class _Clock:
    """Deterministic injected clock: the debounce window advances only
    when the test says so (INF005: no free-running waits)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_dirty_queue_drain_sorted_and_empties():
    q = DirtyQueue(wake=None, debounce_s=0.0, anti_entropy_cycles=1000)
    q.mark(["b:ns", "a:ns"], wake=False)
    q.mark(["a:ns"], wake=False)  # re-mark coalesces into one entry …
    assert q.depth() == 2
    assert q.marks == 3  # … but the mark COUNTER sees every event
    assert q.drain() == ["a:ns", "b:ns"]
    assert q.depth() == 0
    # empty is still authoritative: "no events" means "nothing moved",
    # not "run the full scan"
    assert q.drain() == []


def test_dirty_queue_wake_debounce_leading_edge():
    clock = _Clock()
    woke = []
    q = DirtyQueue(wake=lambda: woke.append(1), debounce_s=0.2,
                   anti_entropy_cycles=1000, clock=clock)
    q.mark(["a"])  # leading edge: the first mark of a quiet period fires
    q.mark(["b"])
    q.mark(["c"])  # inside the window: absorbed silently
    assert woke == [1]
    assert (q.wakes_fired, q.wakes_coalesced) == (1, 2)
    clock.t = 0.25  # window expired: the next mark fires again
    q.mark(["d"])
    assert woke == [1, 1]
    assert q.wakes_fired == 2
    q.mark(["e"], wake=False)  # wake=False neither fires nor counts
    assert q.wakes_fired == 2 and len(woke) == 2
    assert q.drain() == ["a", "b", "c", "d", "e"]


def test_dirty_queue_mark_all_forces_full_scan():
    q = DirtyQueue(wake=None, debounce_s=0.0, anti_entropy_cycles=1000)
    q.mark(["a"], wake=False)
    q.mark_all(wake=False)
    assert q.drain() is None  # non-authoritative: run the full poll scan
    assert q.drain() == []  # the doubt is consumed by one drain


def test_dirty_queue_anti_entropy_cadence():
    """Every Nth drain is deliberately non-authoritative so a periodic
    full scan bounds drift from any missed event."""
    q = DirtyQueue(wake=None, debounce_s=0.0, anti_entropy_cycles=3)
    outs = [q.drain() for _ in range(6)]
    assert [o is None for o in outs] == [
        False, False, True, False, False, True,
    ]


# -- watcher events feed the dirty queue --------------------------------------


def test_va_events_mark_named_variant():
    """Every NAMED VA event marks `name:namespace` dirty — the targeted
    scan re-verifies the claim, so marking MODIFIED/DELETED is safe —
    while only ADDED additionally wakes (create-only reference parity)."""
    woke = []
    q = DirtyQueue(wake=None, debounce_s=0.0, anti_entropy_cycles=1000)
    w = Watcher(object(), lambda: woke.append(1),
                config_namespace=CFG_NS, dirty=q)
    w._on_va_event("MODIFIED", "v", "ns")
    w._on_va_event("DELETED", "w", "ns")
    assert woke == []  # neither wakes …
    assert q.drain() == ["v:ns", "w:ns"]  # … but both mark
    w._on_va_event("ADDED", "x", "ns")
    assert woke == [1]
    assert q.drain() == ["x:ns"]
    w._on_va_event("BOOKMARK", "y", "ns")  # non-mutation types never mark
    w._on_va_event("ERROR", "z", "ns")
    assert q.drain() == []


def test_cm_event_marks_whole_fleet_dirty():
    """A watched-ConfigMap edit can change ANY variant's sizing inputs:
    it marks the whole fleet (the next drain demands a full poll scan),
    while filtered CM events leave no doubt behind."""
    q = DirtyQueue(wake=None, debounce_s=0.0, anti_entropy_cycles=1000)
    w = Watcher(object(), lambda: None, config_namespace=CFG_NS, dirty=q)
    w._on_cm_event("unwatched-cm", CFG_NS)
    w._on_cm_event(WATCHED_CONFIGMAPS[0], "elsewhere")
    assert q.drain() == []
    w._on_cm_event(WATCHED_CONFIGMAPS[0], CFG_NS)
    assert q.drain() is None


def test_va_burst_debounces_into_one_cycle():
    """Regression: a burst of VA events inside one
    debounce window produces ONE extra reconcile cycle — run_forever
    absorbs the storm in the debounce sleep while the marks coalesce in
    the queue — instead of a full reconcile per event."""
    cluster = make_cluster(replicas=1)
    # long interval so only wakes (never the timer) drive extra cycles
    cluster.set_configmap(CFG_NS, "inferno-autoscaler-config",
                          {"GLOBAL_OPT_INTERVAL": "60s"})
    rec = Reconciler(kube=cluster, prom=make_prom(arrival_rps=5.0),
                     config=ReconcilerConfig(compute_device="cpu", config_namespace=CFG_NS,
                                             compute_backend="scalar"))
    # freeze the queue clock: every wake-mark after the first coalesces
    # regardless of host scheduling
    rec.dirty_queue.clock = lambda: 0.0
    rec.dirty_queue.debounce_s = 0.05

    burst_landed = threading.Event()
    absorbed = []

    def absorb(seconds):
        # run_forever's debounce sleep: the rest of the burst lands
        # while the loop sits here, then drains as ONE dirty set
        absorbed.append(seconds)
        burst_landed.wait(5)

    rec.sleep = absorb

    depths = []
    orig = rec.run_cycle
    rec.run_cycle = lambda: (depths.append(rec.dirty_queue.depth()),
                             orig())[1]
    stopping = {"stop": False}
    t = threading.Thread(
        target=lambda: rec.run_forever(stop_check=lambda: stopping["stop"])
    )
    t.start()
    try:
        deadline = time.time() + 5
        while not depths and time.time() < deadline:
            time.sleep(0.02)
        assert depths, "first cycle never ran"

        # an 8-event VA burst: the first mark pokes the loop (leading
        # edge), the remaining 7 coalesce silently in the queue
        for i in range(8):
            rec.dirty_queue.mark([f"burst-{i}:ns"], wake=True)
        assert rec.dirty_queue.wakes_fired == 1
        assert rec.dirty_queue.wakes_coalesced == 7
        burst_landed.set()

        deadline = time.time() + 5
        while len(depths) < 2 and time.time() < deadline:
            time.sleep(0.02)
        assert len(depths) >= 2, "burst cycle never ran"
        time.sleep(0.2)  # settle: no further wake is pending
        assert len(depths) == 2, "burst produced more than one extra cycle"
        # the one burst cycle drained ALL 8 marks (queue may also carry
        # the first cycle's wake-less self-marks, hence >=)
        assert depths[1] >= 8
        assert absorbed and absorbed[0] == rec.dirty_queue.debounce_s
    finally:
        stopping["stop"] = True
        burst_landed.set()
        rec.poke()
        t.join(timeout=5)
    assert not t.is_alive()
