"""TLS on the controller metrics endpoint with cert rotation
(reference certwatchers: cmd/main.go:122-199).

Port of tests/test_metrics_tls.py on the port's modules, the expectations unchanged.
"""

import ssl
import subprocess
import urllib.error
import urllib.request

import pytest

from inferno_tpu_torch.controller.metrics import MetricsServer, Registry, TLSConfig


def make_cert(tmp_path, name, cn="localhost"):
    cert = tmp_path / f"{name}.crt"
    key = tmp_path / f"{name}.key"
    subprocess.run(
        [
            "openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
            "-keyout", str(key), "-out", str(cert), "-days", "1",
            "-subj", f"/CN={cn}",
            "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1",
        ],
        check=True,
        capture_output=True,
    )
    return str(cert), str(key)


@pytest.fixture()
def tls_server(tmp_path):
    from inferno_tpu_torch.controller.metrics import CycleInstruments, MetricsEmitter

    cert, key = make_cert(tmp_path, "srv")
    registry = Registry()
    emitter = MetricsEmitter(registry)
    emitter.emit_replica_metrics(
        variant="v", namespace="ns", accelerator="v5e-4", current=1, desired=2
    )
    instruments = CycleInstruments(registry)
    instruments.observe_cycle(0.012)
    instruments.observe_analysis("ns", "v", 0.003)
    server = MetricsServer(registry, port=0, tls=TLSConfig(cert, key))
    server.start()
    yield server, cert, key, tmp_path
    server.stop()


def _fetch(port, cafile):
    ctx = ssl.create_default_context(cafile=cafile)
    with urllib.request.urlopen(
        f"https://localhost:{port}/metrics", context=ctx, timeout=10
    ) as resp:
        return resp.read().decode()


def test_metrics_served_over_tls(tls_server):
    server, cert, _, _ = tls_server
    body = _fetch(server.port, cert)
    assert "inferno_desired_replicas" in body


def test_histograms_render_over_tls(tls_server):
    """The histogram kind rides the same TLS metrics route as the
    gauges: cumulative buckets, +Inf, _sum/_count, labels intact."""
    server, cert, _, _ = tls_server
    body = _fetch(server.port, cert)
    assert "# TYPE inferno_cycle_duration_seconds histogram" in body
    lines = body.splitlines()
    buckets = [
        float(ln.rsplit(" ", 1)[1])
        for ln in lines
        if ln.startswith("inferno_cycle_duration_seconds_bucket")
    ]
    assert buckets and buckets == sorted(buckets)  # cumulative
    assert 'inferno_cycle_duration_seconds_bucket{le="+Inf"} 1' in body
    assert "inferno_cycle_duration_seconds_count 1" in body
    assert any(
        ln.startswith("inferno_variant_analysis_seconds_bucket")
        and 'namespace="ns"' in ln and 'variant_name="v"' in ln
        for ln in lines
    )


def test_histogram_series_survive_gauge_pruning():
    """Pruning a variant's gauge series (MetricsEmitter.prune_variants)
    must not disturb histogram series registered on the same registry —
    and vice versa the per-variant histogram pruning must not touch the
    gauges of variants still active (the two prune paths are disjoint)."""
    from inferno_tpu_torch.controller.metrics import CycleInstruments, MetricsEmitter

    registry = Registry()
    emitter = MetricsEmitter(registry)
    emitter.emit_replica_metrics(
        variant="gone", namespace="ns", accelerator="v5e-4", current=1, desired=2
    )
    emitter.emit_replica_metrics(
        variant="kept", namespace="ns", accelerator="v5e-4", current=1, desired=1
    )
    instruments = CycleInstruments(registry)
    instruments.observe_analysis("ns", "gone", 0.002)
    instruments.observe_analysis("ns", "kept", 0.002)
    instruments.observe_cycle(0.05)

    active = {("ns", "kept")}
    emitter.prune_variants(active)
    instruments.prune_variants(active)

    lines = registry.render().splitlines()
    for prefix in ("inferno_desired_replicas", "inferno_variant_analysis_seconds"):
        assert not any(
            ln.startswith(prefix) and 'variant_name="gone"' in ln for ln in lines
        ), prefix
        assert any(
            ln.startswith(prefix) and 'variant_name="kept"' in ln for ln in lines
        ), prefix
    # the unlabeled cycle histogram is untouched by variant pruning
    assert "inferno_cycle_duration_seconds_count 1" in "\n".join(lines)


def _fetch_json(port, cafile, path):
    ctx = ssl.create_default_context(cafile=cafile)
    import json

    with urllib.request.urlopen(
        f"https://localhost:{port}{path}", context=ctx, timeout=10
    ) as resp:
        return json.load(resp)


def test_debug_routes_served_over_tls(tmp_path):
    """/debug/profile and /debug/attainment ride the
    same TLS listener as /metrics and /debug/decisions — filters, 400s,
    and payload shape intact through the wrapped socket."""
    import json

    from inferno_tpu_torch.obs import TraceBuffer
    from inferno_tpu_torch.obs.attainment import AttainmentTracker
    from inferno_tpu_torch.obs.profiler import PROFILE_SCHEMA

    cert, key = make_cert(tmp_path, "srv")
    profiles = TraceBuffer(capacity=4)
    for i in range(3):
        profiles.append({
            "schema": PROFILE_SCHEMA,
            "cycle": {"wall_ms": 100.0 + i},
            "phases": {"solve": {"wall_ms": 10.0 + i, "cpu_ms": 9.0}},
            "counters": {"dispatches": 1},
        })
    attainment = AttainmentTracker()
    attainment.observe("v:ns", predicted_ttft_ms=10.0, predicted_itl_ms=5.0,
                       observed_ttft_ms=12.0, observed_itl_ms=6.0,
                       slo_ttft_ms=100.0, slo_itl_ms=20.0)
    traces = TraceBuffer(capacity=4)
    traces.append({"decisions": []})
    server = MetricsServer(
        Registry(), port=0, tls=TLSConfig(cert, key),
        traces=traces, attainment=attainment, profiles=profiles,
    )
    server.start()
    try:
        doc = _fetch_json(server.port, cert, "/debug/profile?cycles=2")
        assert len(doc["cycles"]) == 2
        assert doc["cycles"][-1]["phases"]["solve"]["wall_ms"] == 12.0

        doc = _fetch_json(server.port, cert, "/debug/profile?phase=solve")
        assert all("counters" not in c for c in doc["cycles"])

        doc = _fetch_json(server.port, cert, "/debug/attainment?variant=v:ns")
        assert set(doc["variants"]) == {"v:ns"}

        doc = _fetch_json(server.port, cert, "/debug/decisions")
        assert len(doc["cycles"]) == 1

        # the 400 contract holds through TLS on both new routes
        ctx = ssl.create_default_context(cafile=cert)
        for path in ("/debug/profile?cycles=0", "/debug/attainment?bad=1"):
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(
                    f"https://localhost:{server.port}{path}",
                    context=ctx, timeout=10,
                )
            assert exc.value.code == 400, path
            assert "error" in json.load(exc.value)
    finally:
        server.stop()


def test_plain_http_rejected(tls_server):
    server, *_ = tls_server
    with pytest.raises(Exception):
        urllib.request.urlopen(f"http://localhost:{server.port}/metrics", timeout=5)


def test_cert_rotation_without_restart(tls_server):
    server, cert, key, tmp_path = tls_server
    _fetch(server.port, cert)
    # rotate: overwrite cert+key in place with a fresh pair
    new_cert, new_key = make_cert(tmp_path, "rotated")
    import os
    import shutil
    import time

    shutil.copy(new_cert, cert)
    shutil.copy(new_key, key)
    future = time.time() + 2
    os.utime(cert, (future, future))
    os.utime(key, (future, future))
    body = _fetch(server.port, new_cert)  # must validate against the NEW cert
    assert "inferno_desired_replicas" in body
    # an unrelated CA no longer matches what the server presents, proving
    # verification actually ran above (urllib wraps the SSL failure)
    other_cert, _ = make_cert(tmp_path, "other")
    with pytest.raises((ssl.SSLError, urllib.error.URLError)):
        _fetch(server.port, other_cert)
