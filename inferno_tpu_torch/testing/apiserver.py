"""MiniApiServer: a Kubernetes API server over real sockets for tests/CI.

The envtest analogue (reference: internal/controller/suite_test.go:66-84)
for an image with no kind/etcd/docker: an HTTP server implementing the
exact REST dialect the controller's transports speak —

* typed storage with monotonically increasing ``resourceVersion``s and
  uids; PUT **requires** ``metadata.resourceVersion`` (kube's
  "must be specified for an update") and answers stale versions with the
  409 Conflict message shape a real apiserver emits;
* subresource isolation: ``PUT/PATCH /status`` moves ONLY status, a
  main-resource update cannot touch status — a stale controller can
  never smuggle a spec change through a status write;
* patch dialect dispatched on Content-Type like kube-apiserver:
  ``application/json-patch+json`` (RFC 6902 add/replace/remove/test,
  failing ``test`` → 409), ``application/merge-patch+json`` /
  ``strategic-merge-patch+json`` deep merge, mismatched body shape → 400,
  unknown types → 415; ``GET /scale`` serves the autoscaling/v1 Scale
  projection and scale patches address it;
* chunked ``?watch=true`` streams (JSON lines) with per-event
  resourceVersions, resuming from ``resourceVersion=N``, **410 Gone**
  once the event log has been compacted past the requested version
  (``compact()`` forces this so the Watcher's relist path is testable),
  and ``allowWatchBookmarks=true`` periodic BOOKMARK events carrying the
  resume rv;
* Lease optimistic concurrency: POST → 409 on exists, PUT → 409 on
  resourceVersion mismatch — the semantics leader election races on;
* VariantAutoscaling objects are validated against the **committed CRD
  manifest's OpenAPI schema** (deploy/crd/) on create/update, so a drift
  between the controller's objects and the published CRD fails tests the
  way a real API server would reject the write.

Conformance behaviors above are pinned by tests/test_apiserver.py's
``TestConformance*`` classes; when the kind CI job
(.github/workflows/ci.yaml ``kind-e2e``) records real-apiserver traces,
byte-level fixtures can replace the documented-behavior assertions.

Not implemented (not used by any transport in this repo): field
selectors, server-side apply (apply-patch+yaml accepted as merge),
strategic merge-key list semantics (no transport here patches lists),
authn/authz, CRD registration API.

Port copy of `inferno_tpu/testing/apiserver.py`, verbatim apart from
this paragraph and the provenance tags dropped from its comments; it
imports nothing of either package. The port's own
conformance cases are tests/test_torch_apiserver.py, which also holds
the two servers to the same status codes and bodies on one scripted
request sequence.
"""

from __future__ import annotations

import copy
import itertools
import json
import re
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import yaml

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
DEFAULT_CRD_PATHS = [_REPO_ROOT / "deploy/crd/llmd.ai_variantautoscalings.yaml"]

EVENT_LOG_LIMIT = 512


# -- OpenAPI structural-schema validation -------------------------------------


class ValidationError(ValueError):
    pass


def _validate(obj, schema, path="") -> None:
    """Minimal structural-schema check: type, required, properties, items.
    Unknown fields are tolerated (the API server prunes; we accept)."""
    if not isinstance(schema, dict):
        return
    stype = schema.get("type")
    if stype == "object":
        if not isinstance(obj, dict):
            raise ValidationError(f"{path or '.'}: expected object, got {type(obj).__name__}")
        for req in schema.get("required", []) or []:
            if req not in obj:
                raise ValidationError(f"{path}.{req}: required field missing")
        props = schema.get("properties", {}) or {}
        for key, sub in props.items():
            if key in obj and obj[key] is not None:
                _validate(obj[key], sub, f"{path}.{key}")
        addl = schema.get("additionalProperties")
        if isinstance(addl, dict):
            for key, val in obj.items():
                if key not in props and val is not None:
                    _validate(val, addl, f"{path}.{key}")
    elif stype == "array":
        if not isinstance(obj, list):
            raise ValidationError(f"{path}: expected array, got {type(obj).__name__}")
        items = schema.get("items")
        if items:
            for i, item in enumerate(obj):
                _validate(item, items, f"{path}[{i}]")
    elif stype == "string":
        if not isinstance(obj, str):
            raise ValidationError(f"{path}: expected string, got {type(obj).__name__}")
    elif stype == "integer":
        if not isinstance(obj, int) or isinstance(obj, bool):
            raise ValidationError(f"{path}: expected integer, got {type(obj).__name__}")
    elif stype == "number":
        if not isinstance(obj, (int, float)) or isinstance(obj, bool):
            raise ValidationError(f"{path}: expected number, got {type(obj).__name__}")
    elif stype == "boolean":
        if not isinstance(obj, bool):
            raise ValidationError(f"{path}: expected boolean, got {type(obj).__name__}")


def apply_json_patch(target: dict, ops: list) -> dict:
    """RFC 6902 JSON patch (application/json-patch+json) — the subset a
    kube client actually sends: add / replace / remove / test with plain
    JSON-pointer paths. Mirrors kube-apiserver behavior: an invalid op or
    a failing `test` raises (the server maps it to the HTTP error a real
    apiserver returns)."""
    out = copy.deepcopy(target)

    def resolve(path: str):
        if not path.startswith("/"):
            raise ValidationError(f"json patch path must start with '/': {path!r}")
        parts = [p.replace("~1", "/").replace("~0", "~") for p in path[1:].split("/")]
        node = out
        for p in parts[:-1]:
            if isinstance(node, list):
                node = node[int(p)]
            elif isinstance(node, dict):
                if p not in node:
                    raise KeyError(path)
                node = node[p]
            else:
                raise KeyError(path)
        return node, parts[-1]

    for op in ops:
        if not isinstance(op, dict) or "op" not in op or "path" not in op:
            raise ValidationError(f"malformed json patch op: {op!r}")
        kind_, path = op["op"], op["path"]
        if kind_ == "add":
            node, leaf = resolve(path)
            if isinstance(node, list):
                if leaf == "-":
                    node.append(op.get("value"))
                else:
                    node.insert(int(leaf), op.get("value"))
            else:
                node[leaf] = op.get("value")
        elif kind_ == "replace":
            node, leaf = resolve(path)
            if isinstance(node, list):
                node[int(leaf)] = op.get("value")
            else:
                if leaf not in node:
                    raise KeyError(path)
                node[leaf] = op.get("value")
        elif kind_ == "remove":
            node, leaf = resolve(path)
            if isinstance(node, list):
                del node[int(leaf)]
            else:
                del node[leaf]
        elif kind_ == "test":
            node, leaf = resolve(path)
            cur = node[int(leaf)] if isinstance(node, list) else node[leaf]
            if cur != op.get("value"):
                raise _JsonPatchTestFailed(path)
        else:
            raise ValidationError(f"unsupported json patch op {kind_!r}")
    return out


class _JsonPatchTestFailed(Exception):
    """A failing RFC 6902 `test` op — kube-apiserver answers 409."""


def _apply_scale(cur: dict, replicas) -> dict | None:
    """Validated scale application shared by PUT /scale and PATCH /scale
    (their semantics must never diverge): None when replicas is invalid,
    else the updated object (readyReplicas follows instantly — this fake
    has no kubelet to converge it)."""
    # bool is an int subclass: {"replicas": true} must be 422, like kube
    if not isinstance(replicas, int) or isinstance(replicas, bool) or replicas < 0:
        return None
    merged = copy.deepcopy(cur)
    merged.setdefault("spec", {})["replicas"] = replicas
    merged.setdefault("status", {})["replicas"] = replicas
    merged["status"]["readyReplicas"] = replicas
    return merged


def _scale_of(obj: dict) -> dict:
    """The autoscaling/v1 Scale projection of a scalable object — what a
    real apiserver serves on GET /scale and applies patches against."""
    meta = obj.get("metadata", {})
    return {
        "apiVersion": "autoscaling/v1",
        "kind": "Scale",
        "metadata": {
            "name": meta.get("name"),
            "namespace": meta.get("namespace"),
            "resourceVersion": meta.get("resourceVersion"),
            "uid": meta.get("uid"),
        },
        "spec": {"replicas": int((obj.get("spec") or {}).get("replicas", 0))},
        "status": {"replicas": int((obj.get("status") or {}).get("replicas", 0))},
    }


def merge_patch(target, patch):
    """RFC 7386 JSON merge patch."""
    if not isinstance(patch, dict):
        return copy.deepcopy(patch)
    out = dict(target) if isinstance(target, dict) else {}
    for key, val in patch.items():
        if val is None:
            out.pop(key, None)
        else:
            out[key] = merge_patch(out.get(key), val)
    return out


class _Store:
    """Typed object storage + watch event log, one lock for everything."""

    def __init__(self):
        self.lock = threading.Condition()
        self.rv = itertools.count(1)
        self.last_rv = 0
        self.objects: dict[tuple, dict] = {}  # (kind_key, ns, name) -> object
        # kind_key -> list of (rv:int, type:str, object:dict)
        self.events: dict[str, list] = {}
        self.compaction_floor: dict[str, int] = {}
        self.uid = itertools.count(1000)

    def next_rv(self) -> int:
        self.last_rv = next(self.rv)
        return self.last_rv

    def record(self, kind_key: str, event_type: str, obj: dict) -> None:
        log = self.events.setdefault(kind_key, [])
        log.append((int(obj["metadata"]["resourceVersion"]), event_type, copy.deepcopy(obj)))
        if len(log) > EVENT_LOG_LIMIT:
            dropped = log[: len(log) - EVENT_LOG_LIMIT]
            del log[: len(log) - EVENT_LOG_LIMIT]
            self.compaction_floor[kind_key] = max(
                self.compaction_floor.get(kind_key, 0), dropped[-1][0]
            )
        self.lock.notify_all()

    def compact(self, kind_key: str | None = None) -> None:
        """Drop retained events (all kinds by default): any watch resuming
        from a pre-compaction resourceVersion now gets 410 Gone."""
        with self.lock:
            keys = [kind_key] if kind_key else list(self.events)
            for key in keys:
                log = self.events.get(key, [])
                if log:
                    self.compaction_floor[key] = max(
                        self.compaction_floor.get(key, 0), log[-1][0]
                    )
                    log.clear()
            # nudge blocked watchers so they observe the new floor
            self.lock.notify_all()


_ROUTES = [
    # (regex, kind_key, has_namespace)
    (re.compile(r"^/api/v1/namespaces/(?P<ns>[^/]+)/configmaps(?:/(?P<name>[^/]+))?$"),
     "ConfigMap", True),
    (re.compile(r"^/api/v1/nodes(?:/(?P<name>[^/]+))?$"), "Node", False),
    (re.compile(r"^/apis/apps/v1/namespaces/(?P<ns>[^/]+)/deployments"
                r"(?:/(?P<name>[^/]+))?(?P<sub>/scale)?$"), "Deployment", True),
    (re.compile(r"^/apis/leaderworkerset\.x-k8s\.io/v1/namespaces/(?P<ns>[^/]+)"
                r"/leaderworkersets(?:/(?P<name>[^/]+))?(?P<sub>/scale)?$"),
     "LeaderWorkerSet", True),
    (re.compile(r"^/apis/llmd\.ai/v1alpha1/variantautoscalings$"),
     "VariantAutoscaling", False),
    (re.compile(r"^/apis/llmd\.ai/v1alpha1/namespaces/(?P<ns>[^/]+)"
                r"/variantautoscalings(?:/(?P<name>[^/]+))?(?P<sub>/status)?$"),
     "VariantAutoscaling", True),
    (re.compile(r"^/apis/coordination\.k8s\.io/v1/namespaces/(?P<ns>[^/]+)"
                r"/leases(?:/(?P<name>[^/]+))?$"), "Lease", True),
]

_API_VERSIONS = {
    "ConfigMap": "v1",
    "Node": "v1",
    "Deployment": "apps/v1",
    "LeaderWorkerSet": "leaderworkerset.x-k8s.io/v1",
    "VariantAutoscaling": "llmd.ai/v1alpha1",
    "Lease": "coordination.k8s.io/v1",
}


class MiniApiServer:
    def __init__(self, crd_paths=None, port: int = 0):
        self.store = _Store()
        self.schemas: dict[str, dict] = {}
        for path in crd_paths if crd_paths is not None else DEFAULT_CRD_PATHS:
            doc = yaml.safe_load(Path(path).read_text())
            kind = doc["spec"]["names"]["kind"]
            version = doc["spec"]["versions"][0]
            self.schemas[kind] = version.get("schema", {}).get("openAPIV3Schema", {})
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _send(self, code: int, body) -> None:
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _status(self, code: int, reason: str, message: str) -> None:
                self._send(code, {
                    "kind": "Status", "apiVersion": "v1", "status": "Failure",
                    "reason": reason, "message": message, "code": code,
                })

            def _route(self):
                parsed = urllib.parse.urlparse(self.path)
                for regex, kind, _ in _ROUTES:
                    m = regex.match(parsed.path)
                    if m:
                        g = m.groupdict()
                        return (kind, g.get("ns"), g.get("name"),
                                (g.get("sub") or "").lstrip("/"),
                                urllib.parse.parse_qs(parsed.query))
                return None

            def _read_body(self):
                length = int(self.headers.get("Content-Length", "0") or 0)
                raw = self.rfile.read(length) if length else b""
                return json.loads(raw) if raw else None

            def do_GET(self):  # noqa: N802
                route = self._route()
                if route is None:
                    return self._status(404, "NotFound", self.path)
                kind, ns, name, sub, query = route
                if query.get("watch", ["false"])[0] == "true":
                    return outer._serve_watch(self, kind, ns, query)
                with outer.store.lock:
                    if name:
                        obj = outer.store.objects.get((kind, ns, name))
                        if obj is None:
                            return self._status(404, "NotFound", f"{kind} {ns}/{name}")
                        if sub == "scale":
                            return self._send(200, _scale_of(obj))
                        return self._send(200, obj)
                    items = [
                        copy.deepcopy(obj)
                        for (k, o_ns, _), obj in sorted(outer.store.objects.items())
                        if k == kind and (ns is None or o_ns == ns)
                    ]
                    rv = str(outer._current_rv())
                    return self._send(200, {
                        "kind": f"{kind}List",
                        "apiVersion": _API_VERSIONS[kind],
                        "metadata": {"resourceVersion": rv},
                        "items": items,
                    })

            def do_POST(self):  # noqa: N802
                route = self._route()
                if route is None:
                    return self._status(404, "NotFound", self.path)
                kind, ns, _, _, _ = route
                body = self._read_body() or {}
                name = (body.get("metadata") or {}).get("name", "")
                if not name:
                    return self._status(422, "Invalid", "metadata.name required")
                try:
                    outer.validate(kind, body)
                except ValidationError as e:
                    return self._status(422, "Invalid", str(e))
                with outer.store.lock:
                    if (kind, ns, name) in outer.store.objects:
                        return self._status(409, "AlreadyExists", f"{kind} {ns}/{name}")
                    stored = outer._stamp(kind, ns, name, body)
                    outer.store.objects[(kind, ns, name)] = stored
                    outer.store.record(kind, "ADDED", stored)
                    return self._send(201, stored)

            def do_PUT(self):  # noqa: N802
                route = self._route()
                if route is None:
                    return self._status(404, "NotFound", self.path)
                kind, ns, name, sub, _ = route
                body = self._read_body() or {}
                with outer.store.lock:
                    cur = outer.store.objects.get((kind, ns, name))
                    if cur is None:
                        return self._status(404, "NotFound", f"{kind} {ns}/{name}")
                    sent_rv = (body.get("metadata") or {}).get("resourceVersion")
                    if sent_rv is None:
                        # kube-apiserver REQUIRES resourceVersion on update
                        # ("metadata.resourceVersion: Invalid value: 0x0:
                        # must be specified for an update") — an
                        # unconditional PUT is a fake-server-only illusion
                        # that would hide lost-update races
                        return self._status(
                            422, "Invalid",
                            "metadata.resourceVersion: must be specified "
                            "for an update",
                        )
                    if str(sent_rv) != cur["metadata"]["resourceVersion"]:
                        return self._status(
                            409, "Conflict",
                            f"Operation cannot be fulfilled on {kind} "
                            f"{ns}/{name}: the object has been modified; "
                            "please apply your changes to the latest "
                            f"version and try again (sent {sent_rv}, "
                            f"have {cur['metadata']['resourceVersion']})",
                        )
                    # subresource isolation, as a real apiserver with the
                    # status subresource enabled: PUT /status takes ONLY
                    # status from the body; PUT /scale updates replicas
                    # through the Scale projection (client-go
                    # ScaleInterface.Update); a main-resource PUT ignores
                    # status changes
                    if sub == "scale":
                        merged = _apply_scale(cur, (body.get("spec") or {}).get("replicas"))
                        if merged is None:
                            return self._status(
                                422, "Invalid", "spec.replicas must be >= 0")
                    elif sub == "status":
                        merged = copy.deepcopy(cur)
                        merged["status"] = copy.deepcopy(body.get("status", {}))
                    else:
                        merged = copy.deepcopy(body)
                        if "status" in cur or "status" in merged:
                            merged["status"] = copy.deepcopy(cur.get("status", {}))
                    try:
                        outer.validate(kind, merged)
                    except ValidationError as e:
                        return self._status(422, "Invalid", str(e))
                    stored = outer._stamp(kind, ns, name, merged, uid=cur["metadata"]["uid"])
                    outer.store.objects[(kind, ns, name)] = stored
                    outer.store.record(kind, "MODIFIED", stored)
                    return self._send(200, stored)

            def do_PATCH(self):  # noqa: N802
                route = self._route()
                if route is None:
                    return self._status(404, "NotFound", self.path)
                kind, ns, name, sub, _ = route
                # kube-apiserver dispatches patch SEMANTICS on the declared
                # Content-Type; an undeclared or unsupported one is 415,
                # and a body whose JSON shape contradicts the declared
                # type (e.g. a RFC-6902 op list sent as merge-patch) is
                # 400 — a fake that silently merge-patched everything
                # would accept requests a real apiserver rejects.
                ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
                known = {
                    "application/merge-patch+json",
                    "application/strategic-merge-patch+json",
                    "application/json-patch+json",
                    "application/apply-patch+yaml",
                }
                if ctype not in known:  # absent counts: kube-apiserver 415s
                    # a PATCH with no declared patch type too
                    return self._status(
                        415, "UnsupportedMediaType", ctype or "(no Content-Type)")
                is_json_patch = ctype == "application/json-patch+json"
                body = self._read_body()
                if body is None:
                    body = [] if is_json_patch else {}
                if is_json_patch and not isinstance(body, list):
                    return self._status(
                        400, "BadRequest",
                        "json patch must be an array of operations")
                if not is_json_patch and not isinstance(body, dict):
                    return self._status(
                        400, "BadRequest",
                        f"cannot unmarshal array into object ({ctype or 'merge patch'})")
                with outer.store.lock:
                    cur = outer.store.objects.get((kind, ns, name))
                    if cur is None:
                        return self._status(404, "NotFound", f"{kind} {ns}/{name}")
                    try:
                        if sub == "scale":
                            # the Scale subresource: patches address the
                            # autoscaling/v1 Scale object, whose only
                            # mutable field is spec.replicas
                            scale = _scale_of(cur)
                            if is_json_patch:
                                scale = apply_json_patch(scale, body)
                            else:
                                scale = merge_patch(scale, body)
                            merged = _apply_scale(
                                cur, (scale.get("spec") or {}).get("replicas"))
                            if merged is None:
                                return self._status(
                                    422, "Invalid", "spec.replicas must be >= 0")
                        elif sub == "status":
                            merged = copy.deepcopy(cur)
                            if is_json_patch:
                                merged = apply_json_patch(merged, body)
                                # subresource isolation: only status moves
                                merged = {**copy.deepcopy(cur),
                                          "status": merged.get("status", {})}
                            else:
                                merged["status"] = merge_patch(
                                    cur.get("status", {}), body.get("status", {}))
                        else:
                            if is_json_patch:
                                merged = apply_json_patch(cur, body)
                            else:
                                merged = merge_patch(cur, body)
                            # a patch cannot move/rename the object
                            merged.setdefault("metadata", {})["name"] = name
                            merged["metadata"]["namespace"] = ns
                            # subresource isolation holds for PATCH too: a
                            # main-resource patch cannot touch status (a
                            # real apiserver with the status subresource
                            # drops such changes silently)
                            if "status" in cur or "status" in merged:
                                merged["status"] = copy.deepcopy(cur.get("status", {}))
                    except _JsonPatchTestFailed as e:
                        return self._status(409, "Conflict", f"test failed: {e}")
                    except (KeyError, IndexError, ValueError, ValidationError) as e:
                        return self._status(
                            422, "Invalid", f"the provided patch is invalid: {e}")
                    try:
                        outer.validate(kind, merged)
                    except ValidationError as e:
                        return self._status(422, "Invalid", str(e))
                    stored = outer._stamp(kind, ns, name, merged, uid=cur["metadata"]["uid"])
                    outer.store.objects[(kind, ns, name)] = stored
                    outer.store.record(kind, "MODIFIED", stored)
                    return self._send(200, stored)

            def do_DELETE(self):  # noqa: N802
                route = self._route()
                if route is None:
                    return self._status(404, "NotFound", self.path)
                kind, ns, name, _, _ = route
                with outer.store.lock:
                    obj = outer.store.objects.pop((kind, ns, name), None)
                    if obj is None:
                        return self._status(404, "NotFound", f"{kind} {ns}/{name}")
                    obj["metadata"]["resourceVersion"] = str(outer.store.next_rv())
                    outer.store.record(kind, "DELETED", obj)
                    return self._send(200, obj)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_port
        self.url = f"http://127.0.0.1:{self.port}"
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "MiniApiServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    def compact(self, kind: str | None = None) -> None:
        self.store.compact(kind)

    # -- helpers -------------------------------------------------------------

    def _current_rv(self) -> int:
        """Peek the last issued resourceVersion without consuming one (two
        LISTs with no intervening writes must return the same rv)."""
        return self.store.last_rv

    def _stamp(self, kind: str, ns: str | None, name: str, body: dict, uid: str | None = None) -> dict:
        stored = copy.deepcopy(body)
        meta = stored.setdefault("metadata", {})
        meta["name"] = name
        if ns is not None:
            meta["namespace"] = ns
        meta["uid"] = uid or f"uid-{next(self.store.uid)}"
        meta["resourceVersion"] = str(self.store.next_rv())
        stored.setdefault("apiVersion", _API_VERSIONS[kind])
        stored.setdefault("kind", kind)
        return stored

    def validate(self, kind: str, obj: dict) -> None:
        schema = self.schemas.get(kind)
        if schema:
            _validate(obj, schema)

    # -- watch ---------------------------------------------------------------

    def _serve_watch(self, handler, kind: str, ns: str | None, query) -> None:
        try:
            since = int(query.get("resourceVersion", ["0"])[0] or 0)
        except ValueError:
            since = 0
        timeout_s = float(query.get("timeoutSeconds", ["30"])[0])
        deadline = time.time() + min(timeout_s, 300.0)
        # kube-apiserver sends periodic BOOKMARK events (an object carrying
        # only metadata.resourceVersion) when the client opts in — clients
        # use them to advance their resume point across quiet periods so a
        # later reconnect does not land below the compaction floor
        bookmarks = query.get("allowWatchBookmarks", ["false"])[0] == "true"
        next_bookmark = time.time() + 1.0

        with self.store.lock:
            floor = self.store.compaction_floor.get(kind, 0)
            if since and since < floor:
                # resourceVersion already compacted away
                handler._status(410, "Expired", f"resourceVersion {since} is too old")
                return

        handler.send_response(200)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Transfer-Encoding", "chunked")
        handler.end_headers()

        initial = []
        if since == 0:
            # rv-less watch: Kubernetes "get state and start at most
            # recent" — synthetic ADDED for current objects, then events
            # from now; never replays the historical event log and is
            # immune to compaction
            with self.store.lock:
                initial = [
                    copy.deepcopy(obj)
                    for (k, o_ns, _), obj in sorted(self.store.objects.items())
                    if k == kind and (ns is None or o_ns == ns)
                ]
                since = self._current_rv()

        def send_line(payload: dict) -> bool:
            data = json.dumps(payload).encode() + b"\n"
            try:
                handler.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                handler.wfile.flush()
                return True
            except OSError:
                return False

        last = since
        for obj in initial:
            if not send_line({"type": "ADDED", "object": obj}):
                return
        while time.time() < deadline:
            # ALL socket writes happen outside the store lock: a slow
            # watch client must never block every other request handler
            expired = False
            with self.store.lock:
                floor = self.store.compaction_floor.get(kind, 0)
                if last < floor:
                    expired = True
                    pending = []
                else:
                    pending = [
                        (rv, etype, obj)
                        for rv, etype, obj in self.store.events.get(kind, [])
                        if rv > last
                        and (ns is None or obj["metadata"].get("namespace") == ns)
                    ]
                    if not pending:
                        self.store.lock.wait(timeout=0.1)
                        send_bookmark = bookmarks and time.time() >= next_bookmark
            if expired:
                send_line({
                    "type": "ERROR",
                    "object": {"kind": "Status", "code": 410,
                               "reason": "Expired",
                               "message": f"resourceVersion {last} is too old"},
                })
                break
            if not pending:
                # socket writes happen OUTSIDE the store lock (like the
                # pending-event loop below): a slow watch client must
                # never block every other request handler on the lock
                if send_bookmark:
                    next_bookmark = time.time() + 1.0
                    bm = {
                        "type": "BOOKMARK",
                        "object": {
                            "kind": kind,
                            "apiVersion": _API_VERSIONS[kind],
                            "metadata": {"resourceVersion": str(last)},
                        },
                    }
                    if not send_line(bm):
                        return
                continue
            ok = True
            for rv, etype, obj in pending:
                last = max(last, rv)
                ok = send_line({"type": etype, "object": obj})
                if not ok:
                    break
            if not ok:
                break
        try:
            handler.wfile.write(b"0\r\n\r\n")
        except OSError:
            pass
