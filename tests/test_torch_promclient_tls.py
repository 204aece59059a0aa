"""Client-side Prometheus transport security (controller/promclient.py):
HTTPS enforcement, CA verification, insecure opt-out, bearer rotation —
the analogue of the reference's transport tests
(internal/utils/{tls,prometheus_transport}.go, e2e TLS scenarios at
test/e2e/e2e_test.go:565-630).

Port of tests/test_promclient_tls.py on the port's modules, the expectations unchanged.
"""

import json
import ssl
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler
from http.server import ThreadingHTTPServer

import pytest

from inferno_tpu_torch.controller.promclient import HttpPromClient, PromConfig, PromError

from test_torch_metrics_tls import make_cert


class TlsProm:
    """Minimal HTTPS Prometheus answering /api/v1/query, recording the
    Authorization header of every request."""

    def __init__(self, cert, key):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                outer.auth_headers.append(self.headers.get("Authorization"))
                body = json.dumps({
                    "status": "success",
                    "data": {"resultType": "vector", "result": [
                        {"metric": {"m": "x"}, "value": [0, "1.5"]}
                    ]},
                }).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.auth_headers: list = []
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(cert, key)
        self.httpd.socket = ctx.wrap_socket(self.httpd.socket, server_side=True)
        self.port = self.httpd.server_port
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def stop(self):
        self.httpd.shutdown()


@pytest.fixture()
def tls_prom(tmp_path):
    cert, key = make_cert(tmp_path, "prom")
    srv = TlsProm(cert, key)
    yield srv, cert, tmp_path
    srv.stop()


def test_http_scheme_rejected_by_default():
    with pytest.raises(PromError, match="https"):
        HttpPromClient(PromConfig(base_url="http://prom:9090"))


def test_http_scheme_allowed_only_with_opt_in():
    HttpPromClient(PromConfig(base_url="http://prom:9090", allow_http=True))


def test_min_tls_version_enforced():
    client = HttpPromClient(PromConfig(base_url="https://prom:9090"))
    assert client.ctx.minimum_version == ssl.TLSVersion.TLSv1_2


def test_query_with_trusted_ca(tls_prom):
    srv, cert, _ = tls_prom
    client = HttpPromClient(PromConfig(
        base_url=f"https://127.0.0.1:{srv.port}", ca_file=cert,
    ))
    samples = client.query('up{job="x"}')
    assert samples and samples[0].value == 1.5


def test_untrusted_cert_fails_as_prom_error(tls_prom):
    srv, _, _ = tls_prom
    client = HttpPromClient(PromConfig(base_url=f"https://127.0.0.1:{srv.port}"))
    with pytest.raises(PromError):
        client.query("up")
    assert not client.healthy()


def test_insecure_skip_verify_opt_out(tls_prom):
    srv, _, _ = tls_prom
    client = HttpPromClient(PromConfig(
        base_url=f"https://127.0.0.1:{srv.port}", insecure_skip_verify=True,
    ))
    assert client.query("up")


def test_bearer_token_file_rotation(tls_prom):
    """Projected service-account tokens rotate without restart: the file
    is re-read per request (reference prometheus_transport.go:33-80)."""
    srv, cert, tmp_path = tls_prom
    token_file = tmp_path / "token"
    token_file.write_text("token-one")
    client = HttpPromClient(PromConfig(
        base_url=f"https://127.0.0.1:{srv.port}", ca_file=cert,
        bearer_token_file=str(token_file),
    ))
    client.query("up")
    token_file.write_text("token-two")
    client.query("up")
    assert srv.auth_headers[-2:] == ["Bearer token-one", "Bearer token-two"]


def test_static_bearer_token(tls_prom):
    srv, cert, _ = tls_prom
    client = HttpPromClient(PromConfig(
        base_url=f"https://127.0.0.1:{srv.port}", ca_file=cert,
        bearer_token="static-tok",
    ))
    client.query("up")
    assert srv.auth_headers[-1] == "Bearer static-tok"


class TransportProm:
    """Plain-HTTP Prometheus stub recording (method, path, promql) per
    request — for the transport-semantics tests the fleet-scale grouped
    selectors made real: status surfacing, redirect following, and the
    oversized-query POST switch."""

    def __init__(self):
        outer = self
        self.requests: list[tuple[str, str, str]] = []
        self.status = 200
        self.redirect_once_to: str | None = None
        self.lowercase_location = False

        class Handler(BaseHTTPRequestHandler):
            def _handle(self):
                parsed = urllib.parse.urlparse(self.path)
                if self.command == "POST":
                    length = int(self.headers.get("Content-Length", "0"))
                    raw = self.rfile.read(length).decode()
                else:
                    raw = parsed.query
                q = urllib.parse.parse_qs(raw).get("query", [""])[0]
                outer.requests.append((self.command, parsed.path, q))
                if outer.redirect_once_to is not None:
                    loc, outer.redirect_once_to = outer.redirect_once_to, None
                    self.send_response(308)
                    self.send_header(
                        "location" if outer.lowercase_location else "Location",
                        loc,
                    )
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                if outer.status != 200:
                    self.send_response(outer.status)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                body = json.dumps({
                    "status": "success",
                    "data": {"resultType": "vector", "result": [
                        {"metric": {"m": "x"}, "value": [0, "1.0"]}
                    ]},
                }).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            do_GET = _handle  # noqa: N815
            do_POST = _handle  # noqa: N815

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_port}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def stop(self):
        self.httpd.shutdown()


@pytest.fixture()
def plain_prom():
    srv = TransportProm()
    yield srv
    srv.stop()


def plain_client(srv: TransportProm) -> HttpPromClient:
    return HttpPromClient(PromConfig(base_url=srv.url, allow_http=True))


def test_non_2xx_surfaces_status_in_prom_error(plain_prom):
    """A 503 from an auth proxy must read as 'HTTP 503', not as the
    JSON-decode confusion of parsing an empty error body."""
    plain_prom.status = 503
    with pytest.raises(PromError, match="HTTP 503"):
        plain_client(plain_prom).query("up")


def test_same_origin_redirect_followed(plain_prom):
    """An ingress normalizing the path (301/308) worked under urllib's
    auto-follow; the keep-alive client must keep following it."""
    plain_prom.redirect_once_to = "/prom/api/v1/query"
    samples = plain_client(plain_prom).query("up")
    assert samples and samples[0].value == 1.0
    method, path, q = plain_prom.requests[-1]
    assert (method, path, q) == ("GET", "/prom/api/v1/query", "up")


def test_cross_origin_redirect_rejected(plain_prom):
    plain_prom.redirect_once_to = "https://elsewhere.example/api/v1/query"
    with pytest.raises(PromError, match="off-origin"):
        plain_client(plain_prom).query("up")


def test_lowercase_location_header_redirect_followed(plain_prom):
    """Header names are case-insensitive (RFC 9110): a proxy emitting
    `location:` must redirect exactly like one emitting `Location:`."""
    plain_prom.redirect_once_to = "/prom/api/v1/query"
    plain_prom.lowercase_location = True
    samples = plain_client(plain_prom).query("up")
    assert samples and samples[0].value == 1.0
    assert plain_prom.requests[-1][1] == "/prom/api/v1/query"


def test_http_proxy_env_routes_through_proxy(plain_prom, monkeypatch):
    """HTTP_PROXY routed queries under the old urllib transport; the
    keep-alive client must keep honoring it — the origin here is
    unresolvable, so success proves the bytes went via the proxy (which
    sees the absolute-form request target)."""
    monkeypatch.setenv("HTTP_PROXY", plain_prom.url)
    monkeypatch.setenv("http_proxy", plain_prom.url)
    monkeypatch.delenv("NO_PROXY", raising=False)
    monkeypatch.delenv("no_proxy", raising=False)
    client = HttpPromClient(
        PromConfig(base_url="http://prom.invalid:9090", allow_http=True)
    )
    assert client.query("up")[0].value == 1.0
    method, path, q = plain_prom.requests[-1]
    assert (method, path, q) == ("GET", "/api/v1/query", "up")


def test_no_proxy_bypass_connects_direct(plain_prom, monkeypatch):
    """NO_PROXY covering the target host skips the (dead) proxy and
    connects straight to the origin."""
    monkeypatch.setenv("HTTP_PROXY", "http://127.0.0.1:1")
    monkeypatch.setenv("http_proxy", "http://127.0.0.1:1")
    monkeypatch.setenv("NO_PROXY", "127.0.0.1")
    monkeypatch.setenv("no_proxy", "127.0.0.1")
    assert plain_client(plain_prom).query("up")[0].value == 1.0


def test_oversized_query_switches_to_post(plain_prom):
    """A grouped fleet selector outgrowing the GET request line (~4 KB,
    nginx/envoy defaults) rides a form-encoded POST with the promql
    intact; short queries stay on GET."""
    client = plain_client(plain_prom)
    long_q = 'up{job=~"' + "|".join(f"job-{i:04d}" for i in range(700)) + '"}'
    assert len(urllib.parse.urlencode({"query": long_q})) > client._POST_THRESHOLD
    assert client.query(long_q)[0].value == 1.0
    method, _path, q = plain_prom.requests[-1]
    assert method == "POST"
    assert q == long_q  # survives the round trip byte-for-byte
    client.query("up")
    assert plain_prom.requests[-1][0] == "GET"


def test_mutual_tls_client_pair(tmp_path):
    """mTLS: a server requiring client certificates accepts the client
    pair from PromConfig and rejects clients without one
    (reference tls.go:31-55)."""
    server_cert, server_key = make_cert(tmp_path, "srv")
    client_cert, client_key = make_cert(tmp_path, "cli")

    outer_headers = []

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            outer_headers.append(1)
            body = json.dumps({"status": "success",
                               "data": {"resultType": "vector", "result": []}}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(server_cert, server_key)
    ctx.load_verify_locations(client_cert)
    ctx.verify_mode = ssl.CERT_REQUIRED
    httpd.socket = ctx.wrap_socket(httpd.socket, server_side=True)
    port = httpd.server_port
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        with_pair = HttpPromClient(PromConfig(
            base_url=f"https://127.0.0.1:{port}", ca_file=server_cert,
            client_cert_file=client_cert, client_key_file=client_key,
        ))
        assert with_pair.query("up") == []
        without = HttpPromClient(PromConfig(
            base_url=f"https://127.0.0.1:{port}", ca_file=server_cert,
        ))
        with pytest.raises(PromError):
            without.query("up")
    finally:
        httpd.shutdown()
