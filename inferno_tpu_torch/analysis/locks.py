"""INF004 lock-discipline: shared writes are guarded, lock order is acyclic.

The control plane runs real threads — the reconciler's bounded worker
pool, the flight recorder's writer thread, the TLS-reloading metrics
listener, the emulator engines — and the check-then-append race review
caught in EmulatedEngine.submit is exactly the class this rule
pins down statically:

  a. Unguarded shared writes: inside a class that owns a lock AND spawns
     a thread entry point (threading.Thread(target=self.m) /
     pool.submit(self.m)), an instance attribute assigned both by a
     thread-entry method (or a method it calls) and by any other method
     must have every such write lexically inside a `with self.<lock>:`
     block. `__init__` writes are exempt (Thread.start() is the
     happens-before edge).
  b. Lock-order graph: `with lock_b:` nested inside `with lock_a:`
     contributes the edge a->b, identified per (module, class, attr).
     A cycle in that graph is a potential deadlock; re-acquiring a plain
     (non-reentrant) Lock inside itself is a guaranteed one. Both are
     findings anchored at the inner acquisition.

Port of `inferno_tpu/analysis/locks.py`, verbatim apart from its imports
(the rule names no package path).
"""

from __future__ import annotations

import ast

from inferno_tpu_torch.analysis.core import Finding, Module, dotted

RULE = "INF004"

LOCK_CTORS = {
    "threading.Lock": "lock",
    "threading.RLock": "rlock",
    "threading.Condition": "rlock",  # default Condition wraps an RLock
    "Lock": "lock",
    "RLock": "rlock",
    "Condition": "rlock",
}


def _lock_kind(node: ast.AST) -> str | None:
    if isinstance(node, ast.Call):
        return LOCK_CTORS.get(dotted(node.func) or "")
    return None


class _ClassInfo:
    def __init__(self, module: Module, name: str, node: ast.ClassDef):
        self.module = module
        self.name = name
        self.node = node
        self.locks: dict[str, str] = {}  # attr -> kind
        self.methods: dict[str, ast.AST] = {}
        self.thread_targets: set[str] = set()
        # attr -> [(method, node, guarded, held_locks)]
        self.writes: dict[str, list[tuple[str, ast.AST, bool]]] = {}
        self.calls: dict[str, set[str]] = {}  # method -> self.X() callees


def _scan_class(module: Module, cls: ast.ClassDef, prefix: str) -> _ClassInfo:
    info = _ClassInfo(module, f"{prefix}{cls.name}", cls)
    for item in cls.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            info.methods[item.name] = item
    # lock attrs first, across ALL methods (conventionally __init__, but
    # lazy init happens), so every method's walk sees the full lock set
    for meth in info.methods.values():
        for node in ast.walk(meth):
            if isinstance(node, ast.Assign):
                kind = _lock_kind(node.value)
                if kind:
                    for t in node.targets:
                        attr = _self_attr(t)
                        if attr:
                            info.locks[attr] = kind
    for name, meth in info.methods.items():
        _scan_method(info, name, meth)
    return info


def _self_attr(node: ast.AST) -> str | None:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _target_method(node: ast.AST) -> str | None:
    """`self.m` (or `self.m` wrapped in nothing) as a thread target."""
    attr = _self_attr(node)
    return attr


def _scan_method(info: _ClassInfo, mname: str, meth: ast.AST) -> None:
    held: list[str] = []  # lock attrs currently held, outermost first
    calls = info.calls.setdefault(mname, set())

    def walk(node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node is not meth:
            # nested defs (incl. closures passed to threads) share the
            # method's analysis: keep walking, they execute with no
            # statically-known extra locks — treat conservatively as
            # part of this method with NO inherited held set
            saved = list(held)
            held.clear()
            for child in ast.iter_child_nodes(node):
                walk(child)
            held.extend(saved)
            return
        if isinstance(node, ast.With):
            lock_attrs = []
            for item in node.items:
                expr = item.context_expr
                # `with self._lock:` or `with self._lock.acquire_timeout()`…
                attr = _self_attr(expr)
                if attr is None and isinstance(expr, ast.Call):
                    attr = _self_attr(expr.func)
                if attr is not None and attr in info.locks:
                    lock_attrs.append((attr, expr))
            for attr, expr in lock_attrs:
                _record_edge(info, held, attr, expr)
                held.append(attr)
            for child in node.body:
                walk(child)
            for attr, _expr in reversed(lock_attrs):
                held.pop()
            return
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                attr = _self_attr(t)
                if attr is not None and attr not in info.locks:
                    info.writes.setdefault(attr, []).append(
                        (mname, node, bool(held))
                    )
        if isinstance(node, ast.Call):
            # thread entry points + self-call graph
            name = dotted(node.func) or ""
            bare = name.rsplit(".", 1)[-1]
            if bare == "Thread":
                for kw in node.keywords:
                    if kw.arg == "target":
                        tm = _target_method(kw.value)
                        if tm:
                            info.thread_targets.add(tm)
            elif bare in ("submit", "start_soon", "run_in_executor"):
                if node.args:
                    tm = _target_method(node.args[0])
                    if tm:
                        info.thread_targets.add(tm)
            callee = _self_attr(node.func)
            if callee is not None:
                calls.add(callee)
        for child in ast.iter_child_nodes(node):
            walk(child)

    walk(meth)


# (module.path, class, attr) -> {(inner_key): (node, module)} edges
_EdgeMap = dict


def _record_edge(info: _ClassInfo, held: list[str], attr: str, expr: ast.AST) -> None:
    edges = getattr(info, "edges", None)
    if edges is None:
        edges = info.edges = []
    for outer in held:
        edges.append((outer, attr, expr))


def _reachable_from_targets(info: _ClassInfo) -> set[str]:
    """Thread-target methods plus everything they reach via self calls."""
    out: set[str] = set()
    work = list(info.thread_targets & set(info.methods))
    while work:
        m = work.pop()
        if m in out:
            continue
        out.add(m)
        work.extend(c for c in info.calls.get(m, ()) if c in info.methods and c not in out)
    return out


def check(modules: list[Module]) -> list[Finding]:
    findings: list[Finding] = []
    classes: list[_ClassInfo] = []
    for mod in modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                classes.append(_scan_class(mod, node, ""))

    # a) unguarded shared writes
    for info in classes:
        if not info.locks or not info.thread_targets:
            continue
        threaded = _reachable_from_targets(info)
        if not threaded:
            continue
        for attr, writes in sorted(info.writes.items()):
            methods = {m for m, _n, _g in writes}
            non_init = [(m, n, g) for m, n, g in writes if m != "__init__"]
            writer_methods = {m for m, _n, _g in non_init}
            if len(methods) < 2 or not (writer_methods & threaded):
                continue
            # shared: written by a thread-entry path AND at least one
            # other method — every non-__init__ write must be guarded
            for m, n, guarded in non_init:
                if not guarded:
                    findings.append(
                        Finding(
                            rule=RULE,
                            path=info.module.path,
                            line=n.lineno,
                            qualname=f"{info.name}.{m}",
                            message=(
                                f"self.{attr} is written from thread entry "
                                f"point(s) {sorted(writer_methods & threaded)} "
                                f"and from {sorted(methods - {m}) or [m]} but "
                                f"this write holds no lock "
                                f"(class owns {sorted(info.locks)})"
                            ),
                        )
                    )

    # b) lock-order graph over (class, attr) identities
    graph: dict[tuple[str, str], set[tuple[str, str]]] = {}
    sites: dict[tuple[tuple[str, str], tuple[str, str]], tuple[Module, ast.AST, str]] = {}
    for info in classes:
        for outer, inner, expr in getattr(info, "edges", []):
            a, b = (info.name, outer), (info.name, inner)
            if a == b and info.locks.get(inner) == "rlock":
                continue  # reentrant self-acquisition is legal
            graph.setdefault(a, set()).add(b)
            sites.setdefault((a, b), (info.module, expr, info.name))

    # cycle detection (includes self-edges = non-reentrant re-acquire)
    def find_cycle() -> list[tuple[str, str]] | None:
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {n: 0 for n in graph}
        stack: list[tuple[str, str]] = []

        def dfs(n) -> list | None:
            color[n] = GRAY
            stack.append(n)
            for m in sorted(graph.get(n, ())):
                if color.get(m, 0) == GRAY:
                    return stack[stack.index(m):] + [m]
                if color.get(m, 0) == 0:
                    got = dfs(m)
                    if got:
                        return got
            stack.pop()
            color[n] = BLACK
            return None

        for n in sorted(graph):
            if color[n] == 0:
                got = dfs(n)
                if got:
                    return got
        return None

    cycle = find_cycle()
    if cycle:
        # anchor at the first edge of the cycle we have a site for
        for a, b in zip(cycle, cycle[1:]):
            if (a, b) in sites:
                mod, expr, cls = sites[(a, b)]
                pretty = " -> ".join(f"{c}.{l}" for c, l in cycle)
                findings.append(
                    Finding(
                        rule=RULE,
                        path=mod.path,
                        line=expr.lineno,
                        qualname=cls,
                        message=(
                            f"lock-order cycle {pretty}: acquiring these locks "
                            "in inconsistent order can deadlock; pick one "
                            "global order"
                        ),
                    )
                )
                break
    return findings
