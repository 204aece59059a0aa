"""INF003 parity-numerics: the bit-parity contract of the decision path.

The scalar/vectorized/incremental solve paths are pinned bit-identical
(docs/performance.md); three statically-checkable disciplines keep them
that way, enforced in the parity-critical packages only (ops/,
parallel/, solver/, planner/, spot/):

  a. No dtype-promoting mixed-precision arithmetic: a BinOp with one
     explicitly-f32 operand and one explicitly-f64 operand silently
     promotes and re-rounds differently than the blessed
     f64-accumulate-then-f32-cast idiom (`np.divide(..., out=f32)` /
     `f64_expr.astype(np.float32)` — both of which tag the RESULT, not
     a mixed operand pair, and never trigger this rule).
  b. No numpy sorts without a stable kind: np.sort/np.argsort default to
     introsort, whose tie order is an implementation detail — ties in
     (value, cost) candidate keys would resolve nondeterministically.
     `kind="stable"`, a `key=`, or np.lexsort (always stable) pass;
     Python's sorted()/list.sort are stable by specification and pass.
     torch.sort/torch.argsort (and a tensor's .sort()/.argsort()) default
     to an unstable sort too: they pass with `stable=True`. A receiver is
     a tensor when it is a torch.* call, a local name assigned from one,
     or a .to()/.cpu()/... of either; a method-form .sort() on a receiver
     of unknown type is taken as a list's and passes.
  c. No iteration over sets: set order is hash-seed order; a set-driven
     loop that feeds decision values (the dict-order fingerprint drift
     class of review bug) is nondeterministic across processes. Wrap in
     sorted(...) to iterate.

Port of `inferno_tpu/analysis/numerics.py`. Changes against the
reference: the scoped packages are named relative to the analysed
package, and the rules read torch's vocabulary beside numpy's and jnp's:
`torch.float32`/`torch.float`/`torch.float64`/`torch.double` are dtypes,
`t.to(<dtype>)` and a torch constructor's `dtype=` tag their result as
`.astype` does, and a torch sort (module form, or the method form on a
receiver known to be a tensor) needs `stable=True`.
"""

from __future__ import annotations

import ast

from inferno_tpu_torch.analysis.core import Finding, Module, QualnameVisitor, dotted

RULE = "INF003"

# the parity-critical packages, relative to the analysed package
PACKAGES = (
    "ops/",
    "parallel/",
    "solver/",
    "planner/",
    "spot/",
)

STABLE_KINDS = frozenset({"stable", "mergesort"})
NUMPY_SORTS = frozenset({"sort", "argsort"})
# module aliases whose sort/argsort default to an unstable sort
NUMPY_MODULES = frozenset({"np", "numpy", "jnp", "jax.numpy", "torch"})

_F32 = "f32"
_F64 = "f64"

_DTYPE_NAMES = {
    "float32": _F32,
    "np.float32": _F32,
    "numpy.float32": _F32,
    "jnp.float32": _F32,
    "float64": _F64,
    "np.float64": _F64,
    "numpy.float64": _F64,
    "jnp.float64": _F64,
    "torch.float32": _F32,
    "torch.float": _F32,
    "torch.float64": _F64,
    "torch.double": _F64,
}

# numpy constructors whose dtype argument tags the result
_CTORS = frozenset(
    {"zeros", "ones", "empty", "full", "asarray", "array", "arange", "fromiter"}
)
# torch constructors (as torch.<name>) whose dtype= tags the result
_TORCH_CTORS = _CTORS | frozenset(
    {"tensor", "as_tensor", "zeros_like", "ones_like", "empty_like", "full_like",
     "linspace"}
)
# tensor methods whose result is again a tensor (for the receiver check)
_TENSOR_METHODS = frozenset(
    {"to", "cpu", "cuda", "clone", "contiguous", "detach", "float", "double", "flatten"}
)


def _dtype_of_expr(node: ast.AST) -> str | None:
    """f32/f64 tag for expressions that name their dtype explicitly."""
    if isinstance(node, ast.Call):
        name = dotted(node.func)
        if name in _DTYPE_NAMES:  # np.float32(x)
            return _DTYPE_NAMES[name]
        if name is not None:
            bare = name.rsplit(".", 1)[-1]
            if bare in ("astype", "to"):
                return _dtype_arg(node)
            if bare in _CTORS:
                return _dtype_arg(node)
            if name.startswith("torch.") and bare in _TORCH_CTORS:
                return _dtype_arg(node)
            if bare == "divide":
                # np.divide(a, b, out=f32_buffer): the blessed idiom —
                # the out= buffer's dtype tags the result
                for kw in node.keywords:
                    if kw.arg == "out":
                        return _dtype_of_expr(kw.value)
    return None


def _dtype_arg(call: ast.Call) -> str | None:
    for kw in call.keywords:
        if kw.arg == "dtype":
            return _tag_of_dtype_expr(kw.value)
    for arg in call.args:
        tag = _tag_of_dtype_expr(arg)
        if tag:
            return tag
    return None


def _tag_of_dtype_expr(node: ast.AST) -> str | None:
    name = dotted(node)
    if name in _DTYPE_NAMES:
        return _DTYPE_NAMES[name]
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return _DTYPE_NAMES.get(node.value)
    return None


class _FuncScope:
    """Single-assignment dtype/set inference for local names."""

    def __init__(self):
        self.dtypes: dict[str, str] = {}
        self.sets: set[str] = set()
        self.tensors: set[str] = set()  # names last assigned a torch tensor
        self.killed: set[str] = set()  # reassigned with a different tag


class _Visitor(QualnameVisitor):
    def __init__(self, module: Module):
        super().__init__(module)
        self.scopes: list[_FuncScope] = [_FuncScope()]

    # -- scope plumbing -------------------------------------------------
    def _visit_func(self, node) -> None:
        self.scope.append(node.name)
        self.scopes.append(_FuncScope())
        self.generic_visit(node)
        self.scopes.pop()
        self.scope.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    @property
    def fscope(self) -> _FuncScope:
        return self.scopes[-1]

    # -- inference ------------------------------------------------------
    def _is_set_expr(self, node: ast.AST) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Call):
            name = dotted(node.func)
            if name in ("set", "frozenset"):
                return True
            bare = (name or "").rsplit(".", 1)[-1]
            if bare in (
                "union", "intersection", "difference", "symmetric_difference"
            ) and isinstance(node.func, ast.Attribute):
                return self._is_set_expr(node.func.value)
            if bare == "keys" or bare == "values" or bare == "items":
                return False  # dict views: insertion-ordered, allowed
        if isinstance(node, ast.Name):
            s = self.fscope
            return node.id in s.sets and node.id not in s.killed
        if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.Sub, ast.BitAnd, ast.BitOr, ast.BitXor)
        ):
            return self._is_set_expr(node.left) or self._is_set_expr(node.right)
        return False

    def _dtype_of(self, node: ast.AST) -> str | None:
        tag = _dtype_of_expr(node)
        if tag:
            return tag
        if isinstance(node, ast.Name):
            s = self.fscope
            if node.id in s.killed:
                return None
            return s.dtypes.get(node.id)
        return None

    def _is_tensor(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.fscope.tensors
        if isinstance(node, ast.Call):
            name = dotted(node.func) or ""
            if name.startswith("torch."):
                return True
            if isinstance(node.func, ast.Attribute) and node.func.attr in _TENSOR_METHODS:
                return self._is_tensor(node.func.value)
        return False

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            s = self.fscope
            tag = self._dtype_of(node.value)
            if name in s.dtypes and s.dtypes.get(name) != tag:
                s.killed.add(name)
            elif tag:
                s.dtypes[name] = tag
            if self._is_tensor(node.value):
                s.tensors.add(name)
            else:
                s.tensors.discard(name)
            if self._is_set_expr(node.value):
                s.sets.add(name)
            elif name in s.sets:
                s.sets.discard(name)
                s.killed.add(name)

    # -- rules ----------------------------------------------------------
    def visit_BinOp(self, node: ast.BinOp) -> None:
        if isinstance(node.op, (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod)):
            lt, rt = self._dtype_of(node.left), self._dtype_of(node.right)
            if {lt, rt} == {_F32, _F64}:
                self.add(
                    RULE,
                    node,
                    "mixed f32xf64 arithmetic promotes and re-rounds; use the "
                    "blessed f64-accumulate-then-f32-cast idiom "
                    "(np.divide(..., out=f32) / result.astype(np.float32))",
                )
        self.generic_visit(node)

    def _is_numpy_sort(self, node: ast.Call, bare: str) -> bool:
        """True when this sort call targets a numpy array. Python's
        list.sort() is stable by specification and passes, so a
        method-form .sort() on a receiver we cannot type is treated as a
        list; .argsort() (lists have none), module-form np/jnp sorts,
        bare/imported sort(x) (method calls are always attribute-form),
        and .sort() on a receiver with a known ndarray dtype are numpy;
        .sort() on a torch tensor is torch's."""
        if bare == "argsort":
            return True
        if not isinstance(node.func, ast.Attribute):
            return True
        recv = node.func.value
        recv_name = dotted(recv)
        if recv_name in NUMPY_MODULES or self._is_tensor(recv):
            return True
        return self._dtype_of(recv) is not None

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted(node.func)
        bare = (name or "").rsplit(".", 1)[-1]
        if (name is None and isinstance(node.func, ast.Attribute)
                and self._is_tensor(node.func.value)):
            bare = node.func.attr  # torch.randn(n).sort(): no dotted name
        if bare in NUMPY_SORTS and self._is_numpy_sort(node, bare):
            kind = None
            has_key = False
            stable = False
            for kw in node.keywords:
                if kw.arg == "kind" and isinstance(kw.value, ast.Constant):
                    kind = kw.value.value
                if kw.arg == "key":
                    has_key = True
                if kw.arg == "stable" and isinstance(kw.value, ast.Constant):
                    stable = kw.value.value is True
            # a deterministic key= passes; otherwise np sorts need a
            # stable kind (np.lexsort needs neither — always stable) and
            # torch sorts stable=True
            recv = node.func.value if isinstance(node.func, ast.Attribute) else None
            module = dotted(recv) if recv is not None else None
            if module == "torch" or (recv is not None and self._is_tensor(recv)):
                if not stable:
                    self.add(
                        RULE,
                        node,
                        f"{name or bare}() without stable=True: torch's default sort "
                        "tie order is nondeterministic in parity-critical code",
                    )
            elif not has_key and not (stable and module not in NUMPY_MODULES) and (
                kind is None or str(kind) not in STABLE_KINDS
            ):
                self.add(
                    RULE,
                    node,
                    f"{name or bare}() without kind='stable' (or an explicit "
                    "key=, or stable=True on a tensor): default introsort tie "
                    "order is nondeterministic in parity-critical code",
                )
        self.generic_visit(node)

    def _check_iter(self, iter_node: ast.AST) -> None:
        if self._is_set_expr(iter_node):
            self.add(
                RULE,
                iter_node,
                "iteration over a set: hash order feeds decision values "
                "nondeterministically; iterate sorted(...) instead",
            )

    def visit_For(self, node: ast.For) -> None:
        self._check_iter(node.iter)
        self.generic_visit(node)

    def _visit_comp(self, node) -> None:
        for gen in node.generators:
            self._check_iter(gen.iter)
        self.generic_visit(node)

    visit_ListComp = _visit_comp
    visit_SetComp = _visit_comp
    visit_DictComp = _visit_comp
    visit_GeneratorExp = _visit_comp


def check(modules: list[Module], *, package: str) -> list[Finding]:
    findings: list[Finding] = []
    scoped = tuple(f"{package}/{p}" for p in PACKAGES)
    for mod in modules:
        if not mod.path.startswith(scoped):
            continue
        v = _Visitor(mod)
        v.visit(mod.tree)
        findings.extend(v.findings)
    return findings
