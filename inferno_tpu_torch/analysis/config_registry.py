"""INF001 config-registry: the environment surface is typed, seamed,
and documented.

Three sub-rules, diffing code against docs in BOTH directions:

  1. No direct `os.environ` / `os.getenv` reads anywhere in the package
     except inside config/defaults.py (the accessor seam itself). The
     measured drift this rule closes: 55 scattered env reads across 10
     modules vs 39 documented rows before this rule.
  2. Every env_str/env_int/env_float/env_bool/env_flag call names its
     variable as a string LITERAL — the literal is what makes the
     configuration surface statically enumerable.
  3. The set of accessor-read variable names must equal the set of
     `VARIABLE` rows in the environment tables of the package's docs
     (the port's: docs/user-guide/configuration-torch.md): a read without
     a row is undocumented configuration, a row without a read is
     documentation for dead configuration.

Port of `inferno_tpu/analysis/config_registry.py`: the seam module is
`<package>/config/defaults.py` of the analysed package, and the docs
table is the caller's (`core.run_analysis` defaults it to the port's).
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from inferno_tpu_torch.analysis.core import Finding, Module, QualnameVisitor, dotted

RULE = "INF001"

ACCESSORS = frozenset({"env_str", "env_int", "env_float", "env_bool", "env_flag"})

# The accessor seam itself, under the analysed package — the one module
# allowed to touch os.environ.
SEAM = "config/defaults.py"

_VAR_RE = re.compile(r"`([A-Z][A-Z0-9_]{2,})(?:\[?_FILE\]?)?`")


class _EnvVisitor(QualnameVisitor):
    def __init__(self, module: Module):
        super().__init__(module)
        # (name, node, qualname) per accessor call with a literal first arg
        self.reads: list[tuple[str, ast.AST, str]] = []

    def visit_Attribute(self, node: ast.Attribute) -> None:
        # os.environ in any position (get/[]/setdefault/in — every
        # spelling is a direct read of the raw environment)
        if node.attr == "environ" and dotted(node) == "os.environ":
            self.add(
                RULE,
                node,
                "direct os.environ access; read the environment through the "
                "typed config/defaults.py accessors (env_str/env_int/"
                "env_float/env_bool/env_flag)",
            )
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted(node.func)
        if name in ("os.getenv", "getenv"):
            self.add(
                RULE,
                node,
                "direct os.getenv call; read the environment through the "
                "typed config/defaults.py accessors",
            )
        elif name is not None and name.rsplit(".", 1)[-1] in ACCESSORS:
            if node.args and isinstance(node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str
            ):
                self.reads.append((node.args[0].value, node, self.qualname))
            else:
                self.add(
                    RULE,
                    node,
                    f"{name}() requires a string-literal variable name so the "
                    "configuration surface stays statically enumerable",
                )
        self.generic_visit(node)


def documented_vars(docs_path: Path) -> dict[str, int]:
    """`VARIABLE` tokens from the first cell of every markdown-table row
    whose table header names a Variable column -> line number. Combined
    rows (`A` / `B`, `A`, `B`) contribute every backticked token."""
    out: dict[str, int] = {}
    in_env_table = False
    for i, line in enumerate(docs_path.read_text().splitlines(), 1):
        stripped = line.strip()
        if not stripped.startswith("|"):
            in_env_table = False
            continue
        first_cell = stripped.strip("|").split("|", 1)[0]
        if "Variable" in first_cell:
            in_env_table = True
            continue
        if not in_env_table or set(first_cell.strip()) <= {"-", ":", " "}:
            continue
        for m in _VAR_RE.finditer(first_cell):
            out.setdefault(m.group(1), i)
    return out


def check(
    modules: list[Module],
    *,
    root: Path,
    docs_path: Path,
    package: str,
) -> list[Finding]:
    findings: list[Finding] = []
    reads: dict[str, tuple[Module, ast.AST, str]] = {}
    seam = f"{package}/{SEAM}"
    for mod in modules:
        if mod.path == seam:
            # the seam reads os.environ by design; its accessor helpers
            # are not themselves env reads
            continue
        v = _EnvVisitor(mod)
        v.visit(mod.tree)
        findings.extend(v.findings)
        for name, node, qual in v.reads:
            reads.setdefault(name, (mod, node, qual))
    docs = docs_path
    documented = documented_vars(docs) if docs.exists() else {}
    docs_rel = docs.relative_to(root).as_posix() if docs.is_absolute() else str(docs)
    for name, (mod, node, qual) in sorted(reads.items()):
        if name not in documented:
            findings.append(
                Finding(
                    rule=RULE,
                    path=mod.path,
                    line=node.lineno,
                    qualname=qual,
                    message=(
                        f"env var {name} is read here but has no row in "
                        f"{docs_rel} (undocumented configuration)"
                    ),
                )
            )
    for name, line in sorted(documented.items()):
        if name not in reads:
            findings.append(
                Finding(
                    rule=RULE,
                    path=docs_rel,
                    line=line,
                    qualname=name,
                    message=(
                        f"documented env var {name} is never read through a "
                        "config/defaults.py accessor (dead documentation, or "
                        "a read bypassing the seam)"
                    ),
                )
            )
    return findings
