"""A miniature Prometheus for sockets-level e2e testing.

The reference's e2e tier deploys kube-prometheus on Kind to sit between
the emulated engines and the controller
(the upstream project's Makefile:146-156, test/e2e/e2e_test.go:341-517). This
module is the hardware-free, cluster-free equivalent: an HTTP server
that *scrapes* real `/metrics` exposition endpoints over sockets,
keeps a short sample history, and answers the controller collector's
query shapes on `/api/v1/query` in the Prometheus JSON wire format —
so an e2e test exercises the full metrics path:

    engine /metrics exposition -> scrape+parse -> rate()/ratio eval
    -> /api/v1/query JSON -> HttpPromClient -> collector -> reconciler

Supported query shapes (exactly what the collector emits,
inferno_tpu_torch.controller.collector):

* `sum(rate(NAME{sel}[1m]))`                      -> windowed counter rate
* `sum(rate(A{sel}[1m]))/sum(rate(B{sel}[1m]))`   -> ratio of rates
* `NAME{sel}`                                     -> latest instant vector
* `max(NAME{sel}) by (a, b)`                      -> the prometheus-adapter
  sample rules' metricsQuery shape (testing/hpa.ExternalMetricsAdapter)
* `up`                                            -> 1 per scrape target

The `[1m]` literal is cosmetic: the evaluation window is the
constructor's `window_seconds` so tests can compress time.

Port copy of `inferno_tpu/emulator/miniprom.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import json
import re
import threading
import time
import urllib.parse
import urllib.request
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_LINE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+([^\s]+)")
_MATCHER = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)(=~|=)"([^"]*)"')


class _Regex:
    """A compiled `=~` matcher value (Prometheus regexes are anchored)."""

    def __init__(self, pattern: str):
        self.pattern = pattern
        self._re = re.compile(pattern)

    def matches(self, value: str) -> bool:
        return self._re.fullmatch(value) is not None


def _unquote(value: str) -> str:
    """Undo string-literal escaping (the shared subset of PromQL/Go and
    exposition-format rules): `\\\\` -> `\\`, `\\"` -> `"`, `\\n` ->
    newline. The collector's grouped selectors double their regex
    backslashes for the string layer (collector._promql_quote) — a
    matcher value must be unescaped HERE, like real Prometheus does,
    before it is compiled as a regex."""
    if "\\" not in value:
        return value
    out = []
    i = 0
    while i < len(value):
        c = value[i]
        if c == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            out.append({"n": "\n", "t": "\t"}.get(nxt, nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _matcher_dict(raw: str) -> dict:
    """`a="x",b=~"y|z"` -> {a: "x", b: _Regex}; exposition label parsing
    keeps using plain equality (series never carry regex values)."""
    out: dict = {}
    for name, op, value in _MATCHER.findall(raw):
        value = _unquote(value)
        out[name] = _Regex(value) if op == "=~" else value
    return out


def _label_match(labels: dict, matchers: dict) -> bool:
    for k, v in matchers.items():
        got = labels.get(k, "")
        if isinstance(v, _Regex):
            if not v.matches(got):
                return False
        elif got != v:
            return False
    return True


def parse_exposition(text: str):
    """Parse text exposition into [(name, labels_dict, value)]."""
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _LINE.match(line)
        if not m:
            continue
        name, raw_labels, raw_val = m.groups()
        try:
            value = float(raw_val)
        except ValueError:
            continue
        labels = (
            {n: _unquote(v) for n, _op, v in _MATCHER.findall(raw_labels)}
            if raw_labels else {}
        )
        out.append((name, labels, value))
    return out


def _parse_vector_selector(expr: str):
    """`name{a="b",c=~"d|e",...}` -> (name, matcher dict); bare `name` ->
    (name, {}). Matcher values are plain strings for `=` and _Regex for
    `=~` (the coalesced collector's fleet selectors)."""
    brace = expr.find("{")
    if brace < 0:
        return expr.strip(), {}
    return expr[:brace].strip(), _matcher_dict(expr[brace:])


_RATE = re.compile(r"sum\(rate\(([^\[]+)\[[^\]]*\]\)\)")
_MAX_BY = re.compile(r"^max\(([^)]+)\)\s*by\s*\(([^)]*)\)$")
# coalesced collector shapes (inferno_tpu_torch.controller.collector
# .grouped_queries): one query per metric over the whole fleet, split
# back out per variant with a by() clause
_SUM_BY = re.compile(r"^sum\(([^)]+)\)\s*by\s*\(([^)]*)\)$")
_RATE_BY = re.compile(r"^sum\(rate\(([^\[]+)\[[^\]]*\]\)\)\s*by\s*\(([^)]*)\)$")
_RATIO_BY = re.compile(
    r"^sum\(rate\(([^\[]+)\[[^\]]*\]\)\)\s*by\s*\(([^)]*)\)"
    r"/sum\(rate\(([^\[]+)\[[^\]]*\]\)\)\s*by\s*\(([^)]*)\)$"
)


class MiniProm:
    """Scrapes `targets` every `scrape_interval` seconds; serves
    /api/v1/query. Start with `start()`; URL at `self.url`."""

    def __init__(
        self,
        targets: list,
        scrape_interval: float = 0.5,
        window_seconds: float = 60.0,
        port: int = 0,
    ):
        # each target: "url" or ("url", {extra labels}) — extra labels play
        # the role of Prometheus target relabeling (e.g. the namespace label
        # a ServiceMonitor attaches to every series of a scraped pod). A
        # target may also be a zero-arg callable returning exposition text
        # (in-process engines, no sockets).
        self.targets = [t if isinstance(t, tuple) else (t, {}) for t in targets]
        self.scrape_interval = scrape_interval
        self.window_seconds = window_seconds
        # (target, name, labels_key) -> deque[(t, value)]
        self.history: dict[tuple, deque] = {}
        self.lock = threading.Lock()
        self._stop = threading.Event()
        self._scraper: threading.Thread | None = None
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def _answer(self, raw_qs: str) -> None:
                query = urllib.parse.parse_qs(raw_qs).get("query", [""])[0]
                body = json.dumps(outer.evaluate(query)).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                parsed = urllib.parse.urlparse(self.path)
                if parsed.path != "/api/v1/query":
                    self.send_response(404)
                    self.end_headers()
                    return
                self._answer(parsed.query)

            def do_POST(self):  # noqa: N802
                # form-encoded /api/v1/query — the client switches to
                # POST when a coalesced fleet selector outgrows the GET
                # request line (promclient._POST_THRESHOLD)
                if urllib.parse.urlparse(self.path).path != "/api/v1/query":
                    self.send_response(404)
                    self.end_headers()
                    return
                length = int(self.headers.get("Content-Length", "0"))
                self._answer(self.rfile.read(length).decode())

            def log_message(self, *args):  # quiet
                pass

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_port
        self.url = f"http://127.0.0.1:{self.port}"

    # -- scraping ------------------------------------------------------------

    def add_target(self, url: str, labels: dict | None = None) -> None:
        with self.lock:
            self.targets.append((url, labels or {}))

    def remove_target(self, target) -> None:
        """Drop a target AND its series history — the compressed-time
        analogue of Prometheus staleness handling when the scraped pods
        are gone (a scaled-to-zero engine's series stop resolving ~5 min
        after the last scrape; tests can't wait that long)."""
        with self.lock:
            self.targets = [(t, ex) for t, ex in self.targets if t != target]
            for key in [k for k in self.history if k[0] == target]:
                del self.history[key]

    def scrape_once(self) -> None:
        with self.lock:
            targets = list(self.targets)
        now = time.time()
        for target, extra in targets:
            if callable(target):
                try:
                    text = target()
                except Exception:
                    # a failing in-process target is a failed scrape, not a
                    # dead scraper thread
                    continue
            else:
                try:
                    with urllib.request.urlopen(target, timeout=5) as resp:
                        text = resp.read().decode()
                except OSError:
                    continue
            series = parse_exposition(text)
            with self.lock:
                seen = set()
                for name, labels, value in series:
                    # series-native labels win over target labels
                    merged = {**extra, **labels}
                    key = (target, name, tuple(sorted(merged.items())))
                    seen.add(key)
                    self.history.setdefault(key, deque(maxlen=512)).append((now, value))
                # Staleness markers, like real Prometheus: a series that
                # disappears from a successful scrape (a pruned gauge, a
                # re-keyed label set) is tombstoned so instant queries stop
                # returning its last value immediately — without this, a
                # variant's old accelerator-labelled gauges would answer
                # KEDA/adapter queries forever.
                for key, hist in self.history.items():
                    if key[0] == target and key not in seen and hist[-1][1] is not None:
                        hist.append((now, None))

    def _scrape_loop(self) -> None:
        while not self._stop.is_set():
            self.scrape_once()
            self._stop.wait(self.scrape_interval)

    def start(self) -> None:
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()
        self._scraper = threading.Thread(target=self._scrape_loop, daemon=True)
        self._scraper.start()

    def stop(self) -> None:
        self._stop.set()
        self._httpd.shutdown()

    # -- evaluation ----------------------------------------------------------

    def _matching(self, name: str, matchers: dict):
        """All LIVE series histories matching name + label equality
        matchers (tombstoned series — last sample None — are stale and
        excluded; rate windows filter the markers out per-point)."""
        with self.lock:
            items = list(self.history.items())
        out = []
        for (target, sname, labels_key), hist in items:
            if sname != name:
                continue
            if hist and hist[-1][1] is None:
                continue  # stale: vanished from its target's last scrape
            labels = dict(labels_key)
            if _label_match(labels, matchers):
                out.append((labels, [(t, v) for t, v in hist if v is not None]))
        return out

    @staticmethod
    def _group_by(series, by: tuple[str, ...]) -> dict[tuple, list]:
        """Series grouped by their values of the by() labels. Series
        missing one of the labels are excluded — the coalesced collector
        drops unlabelled samples from grouped responses anyway (they take
        the per-variant fallback path)."""
        groups: dict[tuple, list] = {}
        for labels, hist in series:
            key = tuple(labels.get(k) for k in by)
            if any(v is None for v in key):
                continue
            groups.setdefault(key, []).append((labels, hist))
        return groups

    def _rate_of(self, series, cutoff: float) -> float:
        """Windowed counter rate summed over the given series: positive
        deltas within the window / covered time (counter-reset safe).
        The one rate evaluator — grouped queries run it per group over
        the same per-series accumulation, so coalescing cannot drift
        from the per-variant result."""
        total = 0.0
        elapsed = 0.0
        for _, hist in series:
            pts = [(t, v) for t, v in hist if t >= cutoff]
            if len(pts) < 2:
                continue
            inc = sum(
                max(b[1] - a[1], 0.0) for a, b in zip(pts, pts[1:])
            )
            total += inc
            elapsed = max(elapsed, pts[-1][0] - pts[0][0])
        if elapsed <= 0:
            return 0.0
        return total / elapsed

    def _rate(self, name: str, matchers: dict) -> float:
        return self._rate_of(
            self._matching(name, matchers), time.time() - self.window_seconds
        )

    def evaluate(self, query: str) -> dict:
        query = query.strip()

        def vector(results):
            return {
                "status": "success",
                "data": {"resultType": "vector", "result": results},
            }

        if query == "up":
            now = time.time()
            with self.lock:
                targets = list(self.targets)
            return vector(
                [
                    {"metric": {"instance": t if isinstance(t, str) else getattr(t, "__name__", "in-process")},
                     "value": [now, "1"]}
                    for t, _ in targets
                ]
            )

        # `max(NAME{sel}) by (a, b)` — the exact metricsQuery shape the
        # prometheus-adapter sample rules emit for the actuation gauges
        # (deploy/samples/prometheus-adapter-values.yaml); max() keeps the
        # value stable if two controller replicas briefly emit during a
        # leader transition
        m = _MAX_BY.match(query)
        if m:
            name, matchers = _parse_vector_selector(m.group(1))
            by = tuple(k.strip() for k in m.group(2).split(",") if k.strip())
            grouped: dict[tuple, float] = {}
            labels_by_key: dict[tuple, dict] = {}
            for labels, hist in self._matching(name, matchers):
                key = tuple(labels.get(k, "") for k in by)
                _, v = hist[-1]
                if key not in grouped or v > grouped[key]:
                    grouped[key] = v
                labels_by_key[key] = {k: labels.get(k, "") for k in by}
            return vector(
                [{"metric": labels_by_key[k], "value": [time.time(), str(v)]}
                 for k, v in sorted(grouped.items())]
            )

        # coalesced fleet shapes (grouped by variant-identifying labels),
        # checked BEFORE the generic rate forms their bodies also match
        def by_labels(raw: str) -> tuple[str, ...]:
            return tuple(k.strip() for k in raw.split(",") if k.strip())

        def group_vector(values: dict[tuple, float], by: tuple[str, ...]):
            now = time.time()
            return vector(
                [{"metric": dict(zip(by, key)), "value": [now, str(v)]}
                 for key, v in sorted(values.items())]
            )

        m = _RATIO_BY.match(query)
        if m:
            num_sel, by_raw, den_sel, _ = m.groups()
            by = by_labels(by_raw)
            cutoff = time.time() - self.window_seconds
            num_name, num_matchers = _parse_vector_selector(num_sel)
            den_name, den_matchers = _parse_vector_selector(den_sel)
            num_groups = self._group_by(self._matching(num_name, num_matchers), by)
            den_groups = self._group_by(self._matching(den_name, den_matchers), by)
            out: dict[tuple, float] = {}
            for key in set(num_groups) | set(den_groups):
                den = self._rate_of(den_groups.get(key, []), cutoff)
                num = self._rate_of(num_groups.get(key, []), cutoff)
                out[key] = num / den if den > 0 else 0.0
            return group_vector(out, by)

        m = _RATE_BY.match(query)
        if m:
            name, matchers = _parse_vector_selector(m.group(1))
            by = by_labels(m.group(2))
            cutoff = time.time() - self.window_seconds
            groups = self._group_by(self._matching(name, matchers), by)
            return group_vector(
                {k: self._rate_of(s, cutoff) for k, s in groups.items()}, by
            )

        m = _SUM_BY.match(query)
        if m and not m.group(1).startswith("rate("):
            name, matchers = _parse_vector_selector(m.group(1))
            by = by_labels(m.group(2))
            groups = self._group_by(self._matching(name, matchers), by)
            return group_vector(
                {k: sum(hist[-1][1] for _, hist in s if hist)
                 for k, s in groups.items()},
                by,
            )

        rates = _RATE.findall(query)
        if rates:
            selectors = [_parse_vector_selector(r) for r in rates]
            values = [self._rate(name, matchers) for name, matchers in selectors]
            if len(values) == 2 and ")/sum(rate(" in query.replace(" ", ""):
                value = values[0] / values[1] if values[1] > 0 else 0.0
            else:
                value = values[0]
            name, matchers = selectors[0]
            if not self._matching(name, matchers):
                return vector([])
            return vector(
                [{"metric": {k: v for k, v in matchers.items()
                             if isinstance(v, str)},
                  "value": [time.time(), str(value)]}]
            )

        # instant vector selector
        name, matchers = _parse_vector_selector(query)
        results = []
        for labels, hist in self._matching(name, matchers):
            t, v = hist[-1]
            results.append({"metric": labels, "value": [t, str(v)]})
        return vector(results)

    # -- in-process use ------------------------------------------------------

    def client(self) -> "MiniPromClient":
        """A socketless PromClient over this MiniProm: queries evaluate
        directly against the scrape history (same evaluator the HTTP
        endpoint uses), for tests that wire the collector in-process."""
        return MiniPromClient(self)

    @classmethod
    def for_engines(
        cls,
        engines: dict,
        vocab=None,
        labels: dict | None = None,
        scrape_interval: float = 0.25,
        window_seconds: float = 60.0,
    ) -> "MiniProm":
        """MiniProm scraping in-process EmulatedEngines — the cluster-free
        replacement for the former EmulatorProm, minus its substring query
        matching: engines' metrics are rendered through the real exposition
        path and queried through the real PromQL-shape evaluator.

        engines: model_id -> list of replica engines (or one engine).
        """
        from inferno_tpu_torch.controller.engines import engine_for
        from inferno_tpu_torch.emulator.server import render_engine_metrics

        vocab = vocab or engine_for("vllm-tpu")
        targets = []
        for model_id, replicas in engines.items():
            if not isinstance(replicas, (list, tuple)):
                replicas = [replicas]
            for i, engine in enumerate(replicas):
                target = lambda e=engine, m=model_id: render_engine_metrics(e, m, vocab)  # noqa: E731
                target.__name__ = f"{model_id}/{i}"  # `up` instance label
                targets.append((target, dict(labels or {})))
        return cls(targets, scrape_interval=scrape_interval, window_seconds=window_seconds)


class MiniPromClient:
    """PromClient adapter over MiniProm.evaluate (no sockets)."""

    def __init__(self, prom: MiniProm):
        self.prom = prom

    def query(self, promql: str):
        from inferno_tpu_torch.controller.promclient import Sample

        doc = self.prom.evaluate(promql)
        out = []
        for item in doc.get("data", {}).get("result", []):
            ts, val = item["value"]
            out.append(Sample(labels=dict(item["metric"]), value=float(val), timestamp=float(ts)))
        return out

    def healthy(self) -> bool:
        return True
