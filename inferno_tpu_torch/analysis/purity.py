"""INF002 jit-purity: anything a jitted or graph-captured function can reach is pure.

A traced function executes at unpredictable times (compile vs execute,
cache replay, cross-device shard_map) — an environment read, wall-clock
read, RNG draw, or module-global mutation inside one is a value that
silently freezes at first trace and diverges from the scalar oracle.
This checker roots a static call graph at every `jax.jit` / `shard_map`
call site (call-expression arguments, decorators, including
`functools.partial(jax.jit, ...)`, and names called inside jitted
lambdas), follows name/attribute calls it can resolve inside the
package (lexical scope chain, then module scope, then imports), and
flags the impure operations in every reachable function.

Port of `inferno_tpu/analysis/purity.py`. The port's counterpart of a
trace is a CUDA-graph capture: a graph bakes every host read made while
it is captured into the replayed program, so an environment read, a
clock read or an RNG draw there freezes at capture exactly as one under
`jax.jit` freezes at trace. The port's roots are therefore the calls
inside a `with torch.cuda.graph(...)` body and the callables passed to
`torch.cuda.make_graphed_callables` and `torch.compile` (as calls,
decorators or through `functools.partial`), beside the reference's jax
roots, which stay AST names (so the rule finds the reference's roots
when it analyses `inferno_tpu/`). Intra-package resolution follows the
analysed package's imports (the reference matches the bare prefix
`inferno_tpu`, which `inferno_tpu_torch` shares).

On the port's tree the rule reports nothing today: its one capture body
(`tools/profile_gpu.py::replayable`) calls `step()`, a parameter that a
static call graph cannot resolve to a function.
"""

from __future__ import annotations

import ast
from collections import deque

from inferno_tpu_torch.analysis.core import Finding, Module, dotted

RULE = "INF002"

JIT_NAMES = frozenset({"jax.jit", "jit", "pjit", "jax.pjit"})
SHARD_NAMES = frozenset({"shard_map", "jax.experimental.shard_map.shard_map"})
PARTIAL_NAMES = frozenset({"functools.partial", "partial"})
# the torch roots: a graph-capture context, and the functions that
# capture or compile a callable
GRAPH_CONTEXTS = frozenset({"torch.cuda.graph", "cuda.graph"})
GRAPH_NAMES = frozenset(
    {
        "torch.cuda.make_graphed_callables",
        "cuda.make_graphed_callables",
        "make_graphed_callables",
        "torch.compile",
    }
)
ROOT_NAMES = JIT_NAMES | SHARD_NAMES | GRAPH_NAMES

# Impure call prefixes: any call whose dotted name starts with one of
# these is an impurity inside a jit-reachable or graph-captured function.
IMPURE_PREFIXES = (
    "os.environ",
    "os.getenv",
    "time.",
    "random.",
    "np.random.",
    "numpy.random.",
    "jnp.random.",  # not a real API — catches confusion early
    "datetime.now",
    "datetime.utcnow",
    "datetime.datetime.now",
    "datetime.datetime.utcnow",
)
# The typed env accessors are a seam for CONFIG code — under jit they
# are exactly as impure as os.environ.
IMPURE_CALLS = frozenset(
    {"env_str", "env_int", "env_float", "env_bool", "env_flag", "getenv"}
)


class _FuncInfo:
    __slots__ = ("node", "module", "qualname", "scope_key", "parent_key", "class_name")

    def __init__(self, node, module, qualname, scope_key, parent_key, class_name):
        self.node = node
        self.module = module
        self.qualname = qualname
        self.scope_key = scope_key  # (module.name, qualname)
        self.parent_key = parent_key  # enclosing function's scope_key or None
        self.class_name = class_name  # nearest enclosing class or None


class _Index(ast.NodeVisitor):
    """Per-module symbol index: functions by qualname, imports, and the
    raw (caller, callee-expression) call pairs for the graph."""

    def __init__(self, module: Module, package: str):
        self.module = module
        self.package = package
        self.scope: list[tuple[str, str]] = []  # (kind, name); kind in {c,f}
        self.funcs: dict[str, _FuncInfo] = {}  # qualname -> info
        self.imports: dict[str, str] = {}  # local name -> dotted module/attr
        self.roots: list[tuple[ast.AST, str]] = []  # (expr, caller qualname)
        self.decorated: list[str] = []  # qualnames of @jit/@shard_map/@compile defs

    def _qual(self) -> str:
        return ".".join(n for _k, n in self.scope)

    def _enclosing_func(self) -> str | None:
        for kind, _n in reversed(self.scope):
            if kind == "f":
                return ".".join(
                    n for k, n in self.scope[: self._last_f_index() + 1]
                )
        return None

    def _last_f_index(self) -> int:
        for i in range(len(self.scope) - 1, -1, -1):
            if self.scope[i][0] == "f":
                return i
        return -1

    def _enclosing_class(self) -> str | None:
        for kind, n in reversed(self.scope):
            if kind == "c":
                return n
        return None

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self.imports[a.asname or a.name.split(".")[0]] = a.name

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module:
            for a in node.names:
                self.imports[a.asname or a.name] = f"{node.module}.{a.name}"

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.scope.append(("c", node.name))
        self.generic_visit(node)
        self.scope.pop()

    def _visit_func(self, node) -> None:
        parent = self._enclosing_func()
        self.scope.append(("f", node.name))
        qual = self._qual()
        self.funcs[qual] = _FuncInfo(
            node,
            self.module,
            qual,
            (self.module.name, qual),
            (self.module.name, parent) if parent else None,
            self._enclosing_class(),
        )
        # decorator roots: @jax.jit, @partial(jax.jit, ...), @torch.compile,
        # @torch.compile(...). Seeded by the
        # decorated def's own qualname (not a bare name re-resolved
        # later), so class methods — whose bare name is not in scope
        # anywhere — are reached too.
        for dec in node.decorator_list:
            name = dotted(dec) or (
                dotted(dec.func) if isinstance(dec, ast.Call) else None
            )
            if name in ROOT_NAMES:
                self.decorated.append(qual)
            elif (
                isinstance(dec, ast.Call)
                and name in PARTIAL_NAMES
                and dec.args
                and dotted(dec.args[0]) in ROOT_NAMES
            ):
                self.decorated.append(qual)
        self.generic_visit(node)
        self.scope.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted(node.func)
        target = None
        if name in ROOT_NAMES:
            target = node.args[0] if node.args else None
        elif name in PARTIAL_NAMES and node.args:
            inner = dotted(node.args[0])
            if inner in ROOT_NAMES:
                target = node.args[1] if len(node.args) > 1 else None
        if isinstance(target, (ast.Tuple, ast.List)):
            # make_graphed_callables((f, g), ...): every element is a root
            for elt in target.elts:
                self.roots.append((elt, self._qual()))
        elif target is not None:
            self.roots.append((target, self._qual()))
        self.generic_visit(node)

    def visit_With(self, node: ast.With) -> None:
        # `with torch.cuda.graph(g):` captures every call of its body
        for item in node.items:
            expr = item.context_expr
            if isinstance(expr, ast.Call) and dotted(expr.func) in GRAPH_CONTEXTS:
                for stmt in node.body:
                    for sub in ast.walk(stmt):
                        if isinstance(sub, ast.Call):
                            self.roots.append((sub.func, self._qual()))
                break
        self.generic_visit(node)


def _called_names(func: ast.AST) -> list[tuple[str, ast.AST]]:
    """Dotted names referenced inside `func` (conservatively: a function
    ALIASED here — `sizer = fleet_refold; sizer(x)` — is as reachable as
    one called directly), excluding nested function bodies (nested defs
    are separate graph nodes, reached via the reference that names them
    — which sits in OUR body and is kept)."""
    out: list[tuple[str, ast.AST]] = []
    stack = list(ast.iter_child_nodes(func))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(node, ast.Call):
            name = dotted(node.func)
            if name:
                out.append((name, node))
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            out.append((node.id, node))
        stack.extend(ast.iter_child_nodes(node))
    return out


def _resolve(
    name: str,
    caller: _FuncInfo,
    indexes: dict[str, _Index],
    by_scope: dict[tuple[str, str], _FuncInfo],
) -> _FuncInfo | None:
    """Resolve a dotted callee name from `caller`'s scope: lambdas/
    locals via the lexical chain, `self.m` via the enclosing class,
    bare names via module scope, `mod.f` via imports."""
    idx = indexes[caller.module.name]
    if name.startswith("self.") and caller.class_name:
        cand = f"{caller.class_name}.{name[5:]}"
        if cand in idx.funcs:
            return idx.funcs[cand]
        return None
    if "." not in name:
        # lexical chain: nested defs of the caller, then its ancestors,
        # then (class-level sibling methods are NOT bare-callable), then
        # module scope
        info: _FuncInfo | None = caller
        while info is not None:
            cand = f"{info.qualname}.{name}"
            if cand in idx.funcs:
                return idx.funcs[cand]
            info = by_scope.get(info.parent_key) if info.parent_key else None
        if name in idx.funcs:
            return idx.funcs[name]
        # from-import of a package function
        target = idx.imports.get(name)
        if target and target.startswith(idx.package + "."):
            mod_name, _, fn = target.rpartition(".")
            tidx = indexes.get(mod_name)
            if tidx and fn in tidx.funcs:
                return tidx.funcs[fn]
        return None
    head, _, rest = name.partition(".")
    target = idx.imports.get(head)
    if target and (target == idx.package or target.startswith(idx.package + ".")):
        tidx = indexes.get(target)
        if tidx and rest in tidx.funcs:
            return tidx.funcs[rest]
    return None


def _impurities(info: _FuncInfo) -> list[tuple[ast.AST, str]]:
    out: list[tuple[ast.AST, str]] = []
    func = info.node
    stack = list(ast.iter_child_nodes(func))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue  # separate graph node
        if isinstance(node, ast.Global):
            out.append((node, f"mutates module global(s) {', '.join(node.names)}"))
        elif isinstance(node, ast.Attribute) and dotted(node) == "os.environ":
            out.append((node, "reads os.environ"))
        elif isinstance(node, ast.Call):
            name = dotted(node.func)
            if name:
                bare = name.rsplit(".", 1)[-1]
                if name.startswith(IMPURE_PREFIXES):
                    out.append((node, f"calls {name}()"))
                elif bare in IMPURE_CALLS:
                    out.append((node, f"calls {name}() (an env-read accessor)"))
        stack.extend(ast.iter_child_nodes(node))
    return out


def check(modules: list[Module], *, package: str) -> list[Finding]:
    indexes = {m.name: _Index(m, package) for m in modules}
    for m in modules:
        indexes[m.name].visit(m.tree)
    by_scope: dict[tuple[str, str], _FuncInfo] = {}
    for idx in indexes.values():
        for info in idx.funcs.values():
            by_scope[info.scope_key] = info

    # seed the worklist: every jit/shard_map/graph target expression
    work: deque[tuple[_FuncInfo, str]] = deque()
    seen: set[tuple[str, str]] = set()

    def _seed(expr: ast.AST, caller_qual: str, idx: _Index) -> None:
        caller = idx.funcs.get(caller_qual) or _ModuleScope(idx)
        names: list[str] = []
        if isinstance(expr, ast.Lambda):
            for sub in ast.walk(expr):
                if isinstance(sub, ast.Call):
                    n = dotted(sub.func)
                    if n:
                        names.append(n)
        else:
            n = dotted(expr)
            if n:
                names.append(n)
        for n in names:
            info = _resolve(n, caller, indexes, by_scope)
            if info and info.scope_key not in seen:
                seen.add(info.scope_key)
                work.append((info, f"{idx.module.name}:{caller_qual or '<module>'}"))

    for idx in indexes.values():
        for expr, caller_qual in idx.roots:
            _seed(expr, caller_qual, idx)
        for qual in idx.decorated:
            info = idx.funcs[qual]
            if info.scope_key not in seen:
                seen.add(info.scope_key)
                work.append((info, f"{idx.module.name}:@{qual}"))

    findings: list[Finding] = []
    while work:
        info, root = work.popleft()
        for node, why in _impurities(info):
            findings.append(
                Finding(
                    rule=RULE,
                    path=info.module.path,
                    line=getattr(node, "lineno", info.node.lineno),
                    qualname=info.qualname,
                    message=(
                        f"{why} inside a jit-reachable or graph-captured "
                        f"function (traced or captured via {root})"
                    ),
                )
            )
        for name, _call in _called_names(info.node):
            callee = _resolve(name, info, indexes, by_scope)
            if callee and callee.scope_key not in seen:
                seen.add(callee.scope_key)
                work.append((callee, root))
    return findings


class _ModuleScope:
    """Resolution context for root call sites at module level."""

    def __init__(self, idx: _Index):
        self.module = idx.module
        self.qualname = "<module>"
        self.scope_key = (idx.module.name, "<module>")
        self.parent_key = None
        self.class_name = None
