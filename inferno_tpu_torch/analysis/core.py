"""Shared infrastructure for the invariant checkers.

One parse per module, one qualname-tracking visitor base, one finding
type, and one suppression pipeline (`# noqa: INF0xx` per line, then the
pinned allowlist file) — every INF0xx checker builds on these so the
reporting surface, escape hatches, and CLI behavior cannot drift apart.

Port of `inferno_tpu/analysis/core.py`. Changes against the reference:
the analysed package is a parameter that reaches every checker (each
derives its seam files and scoped directories from it) instead of a
hard-coded `inferno_tpu/`; the defaults are the port's package
(`inferno_tpu_torch`), its `allowlist.txt` and its environment table,
`docs/user-guide/configuration-torch.md`. Run with
`package="inferno_tpu"`, the reference's allowlist and
`docs/user-guide/configuration.md`, it reports what the reference's
analyzer reports on the reference's tree.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path

# Rules are registered here by the checker modules (imported in
# run_analysis) so `--list-rules` and the docs test can enumerate them.
RULES: dict[str, str] = {
    "INF001": (
        "env reads via config/defaults.py accessors, documented in the env table "
        "(configuration-torch.md)"
    ),
    "INF002": (
        "jit/shard_map/CUDA-graph-reachable functions are pure "
        "(no env/clock/RNG/global writes)"
    ),
    "INF003": "parity-critical numerics: no f32xf64 promotion, unstable sorts, or set iteration",
    "INF004": "multi-thread shared writes are lock-guarded; lock-order graph is acyclic",
    "INF005": "wall-clock reads only inside the injectable-clock seams",
}

_NOQA_RE = re.compile(r"#\s*noqa:\s*([A-Z0-9, ]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str  # "INF001".."INF005"
    path: str  # repo-relative posix path
    line: int  # 1-based
    qualname: str  # "Class.method", "function", or "<module>"
    message: str

    @property
    def key(self) -> str:
        """Allowlist identity: line numbers churn with unrelated edits,
        so grandfathering is per (rule, file, qualified name)."""
        return f"{self.rule} {self.path}::{self.qualname}"

    def render(self) -> str:
        return f"{self.path}:{self.line} {self.rule} [{self.qualname}] {self.message}"


class Module:
    """One parsed source file: AST + raw lines + per-line noqa codes."""

    def __init__(self, root: Path, path: Path):
        self.abspath = path
        self.path = path.relative_to(root).as_posix()
        self.source = path.read_text()
        self.lines = self.source.splitlines()
        self.tree = ast.parse(self.source, filename=str(path))
        # dotted module name ("inferno_tpu_torch.parallel.fleet")
        parts = list(path.relative_to(root).with_suffix("").parts)
        if parts and parts[-1] == "__init__":
            parts = parts[:-1]
        self.name = ".".join(parts)
        # line -> set of INF codes suppressed there
        self.noqa: dict[int, set[str]] = {}
        for i, line in enumerate(self.lines, 1):
            m = _NOQA_RE.search(line)
            if m:
                codes = {c.strip() for c in m.group(1).split(",")}
                inf = {c for c in codes if c.startswith("INF")}
                if inf:
                    self.noqa[i] = inf

    def suppressed(self, rule: str, line: int) -> bool:
        return rule in self.noqa.get(line, ())


class QualnameVisitor(ast.NodeVisitor):
    """Visitor base tracking the lexical scope chain, so every checker
    reports the same `Class.method`-style qualified names the allowlist
    keys on."""

    def __init__(self, module: Module):
        self.module = module
        self.scope: list[str] = []
        self.findings: list[Finding] = []

    @property
    def qualname(self) -> str:
        return ".".join(self.scope) or "<module>"

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    def _visit_func(self, node) -> None:
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def add(self, rule: str, node: ast.AST, message: str, qualname: str | None = None) -> None:
        self.findings.append(
            Finding(
                rule=rule,
                path=self.module.path,
                line=getattr(node, "lineno", 1),
                qualname=qualname if qualname is not None else self.qualname,
                message=message,
            )
        )


def dotted(node: ast.AST) -> str | None:
    """`a.b.c` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> str | None:
    return dotted(node.func)


PACKAGE = "inferno_tpu_torch"  # the package analysed by default


def load_modules(root: Path, package: str = PACKAGE) -> list[Module]:
    """Parse every .py file under root/package (sorted, skipping caches).
    A syntactically-broken file is a finding in itself downstream — here
    it raises, because compileall gates the same tree first."""
    files = sorted((root / package).rglob("*.py"))
    return [
        Module(root, f)
        for f in files
        if "__pycache__" not in f.parts
    ]


DEFAULT_ALLOWLIST = Path(__file__).with_name("allowlist.txt")
# the port's environment table (repo-relative); the reference's own is
# docs/user-guide/configuration.md
DEFAULT_DOCS = Path("docs/user-guide/configuration-torch.md")


def load_allowlist(path: Path) -> dict[str, int]:
    """`rule path::qualname` entries (one per line; '#' comments) ->
    {entry key: line number in the allowlist file}."""
    entries: dict[str, int] = {}
    if not path.exists():
        return entries
    for i, raw in enumerate(path.read_text().splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split(None, 1)
        if len(parts) != 2 or parts[0] not in RULES or "::" not in parts[1]:
            raise ValueError(
                f"{path}:{i}: malformed allowlist entry {line!r} "
                f"(expected 'INF00x path::qualname')"
            )
        entries[f"{parts[0]} {parts[1]}"] = i
    return entries


@dataclasses.dataclass
class Report:
    findings: list[Finding]  # surviving (post-noqa, post-allowlist)
    grandfathered: int  # suppressed by allowlist entries
    noqa_suppressed: int  # suppressed by inline noqa
    stale_entries: list[str]  # allowlist entries matching nothing

    @property
    def clean(self) -> bool:
        # a stale allowlist entry is itself a violation: the pinned list
        # must shrink the moment a grandfathered site is fixed, or the
        # grandfather set silently stops describing the codebase
        return not self.findings and not self.stale_entries


def run_analysis(
    root: Path,
    *,
    allowlist_path: Path | None = DEFAULT_ALLOWLIST,
    docs_path: Path | None = None,
    rules: set[str] | None = None,
    package: str = PACKAGE,
) -> Report:
    """Parse once, run every checker, apply noqa + allowlist. `docs_path`
    defaults to `root / DEFAULT_DOCS`."""
    from inferno_tpu_torch.analysis import (
        clocks,
        config_registry,
        locks,
        numerics,
        purity,
    )

    modules = load_modules(root, package=package)
    by_path = {m.path: m for m in modules}
    docs = docs_path if docs_path is not None else root / DEFAULT_DOCS
    raw: list[Finding] = []
    raw += config_registry.check(modules, root=root, docs_path=docs, package=package)
    raw += purity.check(modules, package=package)
    raw += numerics.check(modules, package=package)
    raw += locks.check(modules)
    raw += clocks.check(modules, package=package)
    if rules is not None:
        raw = [f for f in raw if f.rule in rules]

    noqa_suppressed = 0
    visible: list[Finding] = []
    for f in raw:
        mod = by_path.get(f.path)
        if mod is not None and mod.suppressed(f.rule, f.line):
            noqa_suppressed += 1
        else:
            visible.append(f)

    allow = load_allowlist(allowlist_path) if allowlist_path else {}
    if rules is not None:
        # a --rules subset must not report the OTHER rules' allowlist
        # entries as stale: their findings were filtered out above, not
        # fixed
        allow = {k: v for k, v in allow.items() if k.split(None, 1)[0] in rules}
    matched: set[str] = set()
    grandfathered = 0
    surviving: list[Finding] = []
    for f in visible:
        if f.key in allow:
            matched.add(f.key)
            grandfathered += 1
        else:
            surviving.append(f)
    stale = sorted(set(allow) - matched) if allowlist_path else []
    surviving.sort(key=lambda f: (f.path, f.line, f.rule))
    return Report(
        findings=surviving,
        grandfathered=grandfathered,
        noqa_suppressed=noqa_suppressed,
        stale_entries=stale,
    )
