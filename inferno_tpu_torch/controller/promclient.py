"""Prometheus query clients.

`PromClient` is the two-method interface the collector needs. The HTTP
implementation enforces the reference's transport rules
(upstream internal/utils/{tls.go,prometheus_transport.go}):
HTTPS-only unless explicitly allowed, TLS >= 1.2, optional CA bundle and
mTLS client certs, bearer token from value or file. `FakeProm` serves
canned or computed samples for tests (the analogue of MockPromAPI,
upstream test/utils/unitutils.go:137-241).

Port copy of `inferno_tpu/controller/promclient.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import os
import ssl
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Protocol


class PromError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class Sample:
    labels: dict[str, str]
    value: float
    timestamp: float  # unix seconds


class PromClient(Protocol):
    def query(self, promql: str) -> list[Sample]: ...

    def healthy(self) -> bool: ...


@dataclasses.dataclass
class PromConfig:
    """(reference PrometheusConfig: internal/interfaces/types.go:33-47)"""

    base_url: str = ""
    bearer_token: str = ""
    bearer_token_file: str = ""
    ca_file: str = ""
    client_cert_file: str = ""
    client_key_file: str = ""
    insecure_skip_verify: bool = False
    allow_http: bool = False  # reference enforces https (tls.go:63-68)
    # per-query timeout in seconds (was a hardcoded 30 before it
    # became a knob; a fleet-scale cycle cannot afford one
    # blackholed query stalling collection for half a minute)
    query_timeout_seconds: float = 30.0


class HttpPromClient:
    """Keep-alive Prometheus client.

    Connections are persistent and PER-THREAD (`threading.local`): the
    reconciler's bounded-concurrency collect pool issues queries from
    worker threads, and `http.client` connections are not thread-safe —
    one connection per thread gives keep-alive reuse without locking the
    hot path. A request failing on a kept-alive connection (server closed
    it between cycles) is retried once on a fresh connection before
    surfacing as a PromError.
    """

    def __init__(self, config: PromConfig):
        url = urllib.parse.urlparse(config.base_url)
        if url.scheme != "https" and not (config.allow_http and url.scheme == "http"):
            raise PromError(
                f"Prometheus URL must use https (got {config.base_url!r}); "
                "set allow_http for test environments only"
            )
        self.config = config
        self._url = url
        # environment proxy (HTTP(S)_PROXY / NO_PROXY), resolved once:
        # the old urllib transport honored these by default, and an
        # egress-proxied deployment must keep working after the
        # keep-alive rewrite. https targets tunnel via CONNECT; http
        # targets send absolute-form request lines to the proxy.
        self._proxy = self._resolve_proxy()
        self._local = threading.local()  # per-thread keep-alive connection
        # bearer_token_file contents cached on mtime (satellite: the old
        # client re-opened the file on EVERY query; projected SA tokens
        # rotate by file replacement, so st_mtime_ns catches rotation)
        self._token_cache: tuple[int, str] | None = None
        self._token_lock = threading.Lock()
        if url.scheme == "http":
            self.ctx = None
        elif config.insecure_skip_verify:
            self.ctx = ssl._create_unverified_context()  # noqa: S323 — explicit opt-in
        else:
            self.ctx = ssl.create_default_context(
                cafile=config.ca_file or None
            )
            self.ctx.minimum_version = ssl.TLSVersion.TLSv1_2  # tls.go:27
            if config.client_cert_file and config.client_key_file:
                self.ctx.load_cert_chain(
                    config.client_cert_file, config.client_key_file
                )

    def _resolve_proxy(self) -> urllib.parse.ParseResult | None:
        host = self._url.hostname or ""
        try:
            if urllib.request.proxy_bypass(host):
                return None
        except OSError:  # platform proxy lookup failed: no bypass info
            pass
        proxy = urllib.request.getproxies().get(self._url.scheme)
        return urllib.parse.urlparse(proxy) if proxy else None

    def _token(self) -> str:
        if self.config.bearer_token:
            return self.config.bearer_token
        path = self.config.bearer_token_file
        if path:
            mtime = os.stat(path).st_mtime_ns
            with self._token_lock:
                if self._token_cache is not None and self._token_cache[0] == mtime:
                    return self._token_cache[1]
            with open(path) as f:
                token = f.read().strip()
            with self._token_lock:
                self._token_cache = (mtime, token)
            return token
        return ""

    def _connection(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            host = self._url.hostname or ""
            timeout = self.config.query_timeout_seconds
            if self._proxy is not None:
                phost = self._proxy.hostname or ""
                pport = self._proxy.port or (
                    443 if self._proxy.scheme == "https" else 80
                )
                if self._url.scheme == "https":
                    # TCP to the proxy, CONNECT tunnel, then TLS to the
                    # real host (cert checked against the tunnel target)
                    conn = http.client.HTTPSConnection(
                        phost, pport, timeout=timeout, context=self.ctx,
                    )
                    conn.set_tunnel(host, self._url.port or 443)
                else:
                    conn = http.client.HTTPConnection(
                        phost, pport, timeout=timeout
                    )
            elif self._url.scheme == "http":
                conn = http.client.HTTPConnection(
                    host, self._url.port or 80, timeout=timeout
                )
            else:
                conn = http.client.HTTPSConnection(
                    host, self._url.port or 443, timeout=timeout,
                    context=self.ctx,
                )
            self._local.conn = conn
        return conn

    def _drop_connection(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
            self._local.conn = None
        # the next connection this thread opens is fresh — it must get
        # the no-retry treatment, not the stale-keep-alive retry
        self._local.used = False

    def _request(
        self, path: str, headers: dict[str, str], body: bytes | None = None
    ) -> tuple[int, dict[str, str], bytes]:
        """One request over this thread's keep-alive connection; a failure
        on a REUSED connection (server closed the idle socket between
        cycles) retries once on a fresh one. Returns (status, response
        headers, body) — status handling is the caller's job."""
        if self._proxy is not None and self._url.scheme == "http":
            # plain-http proxying uses absolute-form request targets
            path = f"http://{self._url.netloc}{path}"
        for attempt in (0, 1):
            conn = self._connection()
            fresh = not getattr(self._local, "used", False)
            try:
                conn.request(
                    "POST" if body is not None else "GET",
                    path, body=body, headers=headers,
                )
                resp = conn.getresponse()
                out = resp.read()
                self._local.used = True
                status = resp.status
                resp_headers = dict(resp.getheaders())
                if resp.will_close:
                    self._drop_connection()
                return status, resp_headers, out
            except TimeoutError:
                # a timeout is a hung server, not an idle keep-alive
                # close (those fail instantly) — retrying would double
                # the stall to 2x query_timeout_seconds per query
                self._drop_connection()
                raise
            except (OSError, http.client.HTTPException):
                self._drop_connection()
                if fresh or attempt == 1:
                    raise
        raise AssertionError("unreachable")

    # grouped fleet selectors grow with variant count; past this the GET
    # request line risks proxy header limits (nginx default 8k), so the
    # query moves to a form-encoded POST (supported by /api/v1/query)
    _POST_THRESHOLD = 4000

    def _fetch(self, qs: str, headers: dict[str, str]) -> bytes:
        """Issue the query, following same-origin redirects (an ingress
        normalizing trailing slashes); non-2xx and cross-origin redirects
        surface as PromError with the status instead of a confusing
        JSON-decode failure downstream."""
        base_path = self._url.path.rstrip("/")
        path = f"{base_path}/api/v1/query"
        post = len(qs) > self._POST_THRESHOLD
        for _hop in range(3):
            if post:
                status, rheaders, body = self._request(
                    path,
                    {**headers,
                     "Content-Type": "application/x-www-form-urlencoded"},
                    body=qs.encode(),
                )
            else:
                status, rheaders, body = self._request(
                    f"{path}?{qs}", headers
                )
            if status in (301, 302, 303, 307, 308):
                # header names are case-insensitive (RFC 9110); a proxy
                # may emit `location:`
                location = next(
                    (v for k, v in rheaders.items()
                     if k.lower() == "location"), "",
                )
                target = urllib.parse.urlparse(
                    urllib.parse.urljoin(self.config.base_url, location)
                )
                if (target.scheme, target.netloc) != (
                    self._url.scheme, self._url.netloc,
                ):
                    raise PromError(
                        f"query redirected off-origin to {location!r} "
                        f"(HTTP {status}); point base_url at the final "
                        f"endpoint"
                    )
                path = target.path.rstrip("/") or path
                if status == 303:
                    # See Other asks for GET — honor it only while the
                    # query still fits the request line; an oversized
                    # selector stays on POST (GET here would hit the
                    # very proxy header limits the POST switch avoids)
                    post = len(qs) > self._POST_THRESHOLD
                continue
            if status != 200:
                raise PromError(f"query failed: HTTP {status}")
            return body
        raise PromError("query failed: too many redirects")

    def query(self, promql: str) -> list[Sample]:
        qs = urllib.parse.urlencode({"query": promql})
        headers = {"Host": self._url.netloc, "Accept-Encoding": "identity"}
        token = self._token()
        if token:
            headers["Authorization"] = f"Bearer {token}"
        try:
            payload = json.loads(self._fetch(qs, headers))
        except (
            # OSError covers URLError (handshake-time TLS failures,
            # refused connections), ssl.SSLError raised mid-read (TLS 1.3
            # alerts surface on first read, not at connect), and timeouts
            OSError,
            http.client.HTTPException,  # truncated chunked responses
            json.JSONDecodeError,
        ) as e:
            raise PromError(f"query failed: {e}") from e
        if payload.get("status") != "success":
            raise PromError(f"query error: {payload.get('error', 'unknown')}")
        data = payload.get("data", {})
        if data.get("resultType") != "vector":
            return []
        out = []
        try:
            for item in data.get("result", []):
                ts, val = item.get("value", [time.time(), "0"])
                try:
                    fval = float(val)
                except (ValueError, TypeError):
                    fval = 0.0
                out.append(
                    Sample(labels=dict(item.get("metric", {})),
                           value=fval, timestamp=float(ts or 0.0))
                )
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            # a proxy returning structurally-broken 200s must land on the
            # same handled path as transport failures
            raise PromError(f"malformed query response: {e}") from e
        return out

    def healthy(self) -> bool:
        """Connectivity gate via an `up` query
        (reference ValidatePrometheusAPI: internal/utils/utils.go:390-410)."""
        try:
            self.query("up")
            return True
        except PromError:
            return False


class FakeProm:
    """Canned results keyed by exact query string, plus optional dynamic
    handlers; unknown queries return empty vectors or raise if configured."""

    def __init__(self):
        self.results: dict[str, list[Sample]] = {}
        self.errors: dict[str, Exception] = {}
        self.handlers: list[tuple[Callable[[str], bool], Callable[[str], list[Sample]]]] = []
        self.queries: list[str] = []
        self.is_healthy = True

    def set_result(self, promql: str, value: float, labels: dict | None = None,
                   age_seconds: float = 0.0) -> None:
        self.results[promql] = [
            Sample(labels=labels or {}, value=value, timestamp=time.time() - age_seconds)
        ]

    def set_samples(self, promql: str, rows: list[tuple[dict, float]],
                    age_seconds: float = 0.0) -> None:
        """Multi-sample result for one query — the grouped-by vector shape
        (one labelled sample per group) the coalesced collector consumes."""
        ts = time.time() - age_seconds
        self.results[promql] = [
            Sample(labels=dict(labels), value=value, timestamp=ts)
            for labels, value in rows
        ]

    def set_error(self, promql: str, err: Exception) -> None:
        self.errors[promql] = err

    def add_handler(self, match, handler) -> None:
        self.handlers.append((match, handler))

    def query(self, promql: str) -> list[Sample]:
        self.queries.append(promql)
        if promql in self.errors:
            raise self.errors[promql]
        if promql in self.results:
            return self.results[promql]
        for match, handler in self.handlers:
            if match(promql):
                return handler(promql)
        return []

    def healthy(self) -> bool:
        return self.is_healthy
