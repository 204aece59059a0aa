"""Port of tests/test_analysis.py: the port's invariant analyzer
(`python -m inferno_tpu_torch.analysis`) on crafted fixtures and on the
port's own tree.

One crafted-violation fixture per checker (each INF0xx fires on a
minimal repro and stays silent on the blessed idiom), the noqa and
allowlist escape hatches round-tripped, the CLI's exit-code contract, and
the meta-checks that pin the port itself: its tree is clean under its
committed allowlist, the allowlist only shrinks, holds INF005 entries
only, and every rule is catalogued in docs/analysis-torch.md.

Fixtures live under `inferno_tpu_torch/`. Every one of them is also
mirrored under `inferno_tpu/` and run through the reference's analyzer
and through the port's (`package="inferno_tpu"`): all three runs give the
same `(rule, path without the package prefix, line, qualname)` set. The
torch-vocabulary fixtures (CUDA-graph roots, torch sorts and casts) make
that comparison on the rules the reference can see, leaving out the one
whose torch vocabulary it lacks. Each INF002 case runs with a CUDA-graph
root on the port's package and, as the reference wrote it, with a jax
root on `package="inferno_tpu"`. The whole reference tree gives the
reference's report under the port's analyzer.

The reference's `test_lint_gate_is_wired_into_make_and_ci` is not carried:
the Makefile and the CI workflow belong to the reference, and the port's
analyzer runs from the command line and these tests.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import pytest

from inferno_tpu.analysis import run_analysis as ref_run_analysis
from inferno_tpu.analysis.core import DEFAULT_ALLOWLIST as REF_ALLOWLIST
from inferno_tpu_torch.analysis import load_allowlist, run_analysis
from inferno_tpu_torch.analysis.__main__ import main as cli_main
from inferno_tpu_torch.analysis.core import DEFAULT_ALLOWLIST, RULES

REPO = Path(__file__).resolve().parent.parent
PORT, REF = "inferno_tpu_torch", "inferno_tpu"
DOCS = {
    PORT: "docs/user-guide/configuration-torch.md",
    REF: "docs/user-guide/configuration.md",
}

# Minimal environment table documenting FOO_KNOB.
DOCS_FOO = """# Configuration

| Variable | Default | Meaning |
|---|---|---|
| `FOO_KNOB` | `3` | a documented knob |
"""


def write_tree(root: Path, files: dict[str, str], docs: str | None = None,
               package: str = PORT) -> Path:
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    if docs is not None:
        d = root / DOCS[package]
        d.parent.mkdir(parents=True, exist_ok=True)
        d.write_text(docs)
    return root


def _mirror(files: dict[str, str]) -> dict[str, str]:
    """The fixture in the reference's package: paths and imports renamed."""
    return {rel.replace(PORT, REF, 1): src.replace(PORT, REF) for rel, src in files.items()}


def _keys(report, package: str, skip=()) -> set:
    """(rule, path without the package prefix, line, qualname); a finding
    in the docs table is keyed by the table's role, not its file name."""
    out = set()
    for f in report.findings:
        if f.rule in skip:
            continue
        path = f.path
        if path.startswith(package + "/"):
            path = path[len(package) + 1:]
        elif path in DOCS.values():
            path = "<docs>"
        out.add((f.rule, path, f.line, f.qualname))
    return out


def assert_parity(root: Path, files, docs, rules, report, package, skip=()) -> None:
    """The fixture mirrored under inferno_tpu/ gives the same finding set
    through the reference's analyzer and the port's as `report` gave."""
    mroot = root / "_reference"
    write_tree(mroot, _mirror(files) if package == PORT else files, docs, REF)
    ref = ref_run_analysis(mroot, allowlist_path=None, rules=rules)
    port_on_ref = run_analysis(mroot, allowlist_path=None, rules=rules, package=REF,
                               docs_path=mroot / DOCS[REF])
    want = _keys(ref, REF, skip)
    assert _keys(port_on_ref, REF, skip) == want
    assert _keys(report, package, skip) == want
    assert port_on_ref.noqa_suppressed == ref.noqa_suppressed


def analyze(tmp_path, files, docs=None, rules=None, allowlist=None, package=PORT,
            torch_rules=()):
    """The port's analyzer on the fixture (under `package`), held against
    the reference on its mirror unless an allowlist is given; the rules in
    `torch_rules` read torch vocabulary the reference lacks and are left
    out of that comparison."""
    write_tree(tmp_path, files, docs, package)
    report = run_analysis(tmp_path, allowlist_path=allowlist, rules=rules, package=package,
                          docs_path=tmp_path / DOCS[package])
    if allowlist is None:
        assert_parity(tmp_path, files, docs, rules, report, package, torch_rules)
    return report


# -- INF001 config-registry ---------------------------------------------------


def test_inf001_direct_environ_read_fires(tmp_path):
    report = analyze(tmp_path, {
        "inferno_tpu_torch/controller/x.py": (
            "import os\n"
            "MODE = os.environ.get('MODE', 'auto')\n"
        ),
    }, docs=DOCS_FOO)
    # the environ read itself, plus the dead FOO_KNOB docs row
    assert any(
        f.rule == "INF001" and "os.environ" in f.message for f in report.findings
    )


def test_inf001_getenv_fires(tmp_path):
    report = analyze(tmp_path, {
        "inferno_tpu_torch/controller/x.py": "import os\nV = os.getenv('V')\n",
    })
    assert any(
        f.rule == "INF001" and "os.getenv" in f.message for f in report.findings
    )


def test_inf001_nonliteral_accessor_arg_fires(tmp_path):
    report = analyze(tmp_path, {
        "inferno_tpu_torch/controller/x.py": (
            "from inferno_tpu_torch.config.defaults import env_int\n"
            "def read(name):\n"
            "    return env_int(name, 3)\n"
        ),
    })
    assert any(
        f.rule == "INF001" and "string-literal" in f.message for f in report.findings
    )


def test_inf001_docs_diff_both_directions(tmp_path):
    # UNDOC_KNOB read but not documented; FOO_KNOB documented but never read
    report = analyze(tmp_path, {
        "inferno_tpu_torch/controller/x.py": (
            "from inferno_tpu_torch.config.defaults import env_str\n"
            "V = env_str('UNDOC_KNOB', '')\n"
        ),
    }, docs=DOCS_FOO)
    msgs = [f.message for f in report.findings if f.rule == "INF001"]
    assert any("UNDOC_KNOB" in m and "no row" in m for m in msgs)
    assert any("FOO_KNOB" in m and "never read" in m for m in msgs)
    # the port's table is the one read and named
    assert any("configuration-torch.md" in m for m in msgs)


def test_inf001_silent_on_blessed_idiom(tmp_path):
    report = analyze(tmp_path, {
        "inferno_tpu_torch/controller/x.py": (
            "from inferno_tpu_torch.config.defaults import env_int\n"
            "V = env_int('FOO_KNOB', 3)\n"
        ),
    }, docs=DOCS_FOO)
    assert report.findings == []


def test_inf001_seam_module_is_exempt(tmp_path):
    report = analyze(tmp_path, {
        "inferno_tpu_torch/config/defaults.py": (
            "import os\n"
            "def env_str(name, default=''):\n"
            "    return os.environ.get(name, default)\n"
        ),
    })
    assert report.findings == []


# -- INF002 jit-purity: CUDA-graph roots on the port, jax roots as the
# reference wrote them (package="inferno_tpu") ---------------------------------

INF002_VIOLATION = {
    "cuda_graph": {
        "inferno_tpu_torch/ops/x.py": (
            "import time\n"
            "import torch\n"
            "def helper(x):\n"
            "    time.perf_counter()\n"
            "    return x\n"
            "def kernel(x):\n"
            "    return helper(x)\n"
            "def capture(x):\n"
            "    graph = torch.cuda.CUDAGraph()\n"
            "    with torch.cuda.graph(graph):\n"
            "        kernel(x)\n"
            "    return graph.replay\n"
        ),
    },
    "jax": {
        "inferno_tpu/ops/x.py": (
            "import time\n"
            "import jax\n"
            "def helper(x):\n"
            "    time.perf_counter()\n"
            "    return x\n"
            "def kernel(x):\n"
            "    return helper(x)\n"
            "jit_kernel = jax.jit(kernel)\n"
        ),
    },
}
ROOTS = sorted(INF002_VIOLATION)


def analyze_rooted(tmp_path, root, files):
    """A graph-rooted fixture on the port's package (the reference cannot
    see its INF002 root), a jax-rooted one on the reference's."""
    if root == "jax":
        return analyze(tmp_path, files, package=REF)
    return analyze(tmp_path, files, torch_rules=("INF002",))


@pytest.mark.parametrize("root", ROOTS)
def test_inf002_impurity_through_call_graph_fires(tmp_path, root):
    report = analyze_rooted(tmp_path, root, INF002_VIOLATION[root])
    # (the same wall-clock read also trips INF005 — independently correct)
    inf002 = [f for f in report.findings if f.rule == "INF002"]
    assert len(inf002) == 1
    f = inf002[0]
    assert f.qualname == "helper" and "time.perf_counter" in f.message


DECORATORS = {"cuda_graph": ("torch", "@torch.compile"), "jax": ("jax", "@jax.jit")}


def _pkg(root: str) -> str:
    return REF if root == "jax" else PORT


@pytest.mark.parametrize("root", ROOTS)
def test_inf002_decorator_and_global_mutation_fire(tmp_path, root):
    mod, dec = DECORATORS[root]
    report = analyze_rooted(tmp_path, root, {
        f"{_pkg(root)}/ops/x.py": (
            f"import {mod}\n"
            "_CACHE = None\n"
            f"{dec}\n"
            "def kernel(x):\n"
            "    global _CACHE\n"
            "    _CACHE = x\n"
            "    return x\n"
        ),
    })
    assert any(
        f.rule == "INF002" and "module global" in f.message for f in report.findings
    )


@pytest.mark.parametrize("root", ROOTS)
def test_inf002_decorated_method_fires(tmp_path, root):
    # decorator roots seed the def's own QUALNAME: a decorated method's
    # bare name resolves nowhere, and re-resolving it would silently skip
    # the method entirely
    mod, dec = DECORATORS[root]
    report = analyze_rooted(tmp_path, root, {
        f"{_pkg(root)}/ops/x.py": (
            "import time\n"
            f"import {mod}\n"
            "class K:\n"
            f"    {dec}\n"
            "    def kernel(self, x):\n"
            "        time.perf_counter()\n"
            "        return x\n"
        ),
    })
    inf002 = [f for f in report.findings if f.rule == "INF002"]
    assert len(inf002) == 1 and inf002[0].qualname == "K.kernel"


PURE_KERNEL = {
    "cuda_graph": (
        "import time\n"
        "import torch\n"
        "def kernel(x):\n"
        "    return x * 2\n"
        "def driver(x):\n"
        "    t0 = time.perf_counter()  # noqa: INF005\n"
        "    graph = torch.cuda.CUDAGraph()\n"
        "    with torch.cuda.graph(graph):\n"
        "        kernel(x)\n"
        "    return graph, t0\n"
    ),
    "jax": (
        "import time\n"
        "import jax\n"
        "def kernel(x):\n"
        "    return x * 2\n"
        "jit_kernel = jax.jit(kernel)\n"
        "def driver(x):\n"
        "    t0 = time.perf_counter()  # noqa: INF005\n"
        "    return jit_kernel(x), t0\n"
    ),
}


@pytest.mark.parametrize("root", ROOTS)
def test_inf002_silent_on_pure_kernel_and_unjitted_impurity(tmp_path, root):
    report = analyze_rooted(tmp_path, root, {f"{_pkg(root)}/ops/x.py": PURE_KERNEL[root]})
    assert not [f for f in report.findings if f.rule == "INF002"]


def test_inf002_graphed_callables_and_compile_calls_are_roots(tmp_path):
    # make_graphed_callables((f, g), ...) roots every element;
    # torch.compile(h) roots its argument; a parameter called in a capture
    # body (the port's profile_gpu.replayable) resolves to nothing
    report = analyze(tmp_path, {
        "inferno_tpu_torch/ops/x.py": (
            "import os\n"
            "import random\n"
            "import torch\n"
            "def f(x):\n"
            "    return x + random.random()\n"
            "def g(x):\n"
            "    return x * len(os.environ)\n"
            "def h(x):\n"
            "    return x + random.random()\n"
            "graphed = torch.cuda.make_graphed_callables((f, g), ((1,), (1,)))\n"
            "compiled = torch.compile(h)\n"
            "def replayable(step):\n"
            "    graph = torch.cuda.CUDAGraph()\n"
            "    with torch.cuda.graph(graph):\n"
            "        step()\n"
            "    return graph.replay\n"
        ),
    }, torch_rules=("INF002",))
    inf002 = sorted(f.qualname for f in report.findings if f.rule == "INF002")
    assert inf002 == ["f", "g", "h"]


def test_inf002_port_capture_body_is_unresolvable():
    # the rule's docstring and catalogue say so: the port's one capture
    # body calls a parameter, so the port's tree has no INF002 finding
    src = (REPO / "inferno_tpu_torch/tools/profile_gpu.py").read_text()
    assert "with torch.cuda.graph(graph):\n        step()" in src
    report = run_analysis(REPO, allowlist_path=None, rules={"INF002"})
    assert report.findings == []


# -- INF003 parity-numerics ---------------------------------------------------

INF003_VIOLATION = {
    "inferno_tpu_torch/solver/x.py": (
        "import numpy as np\n"
        "def decide(vals):\n"
        "    a = np.zeros(4, dtype=np.float32)\n"
        "    b = np.zeros(4, dtype=np.float64)\n"
        "    mixed = a + b\n"
        "    order = np.argsort(mixed)\n"
        "    chosen = {1, 2, 3}\n"
        "    return [v for v in chosen], order\n"
    ),
}


def test_inf003_all_three_subrules_fire(tmp_path):
    report = analyze(tmp_path, INF003_VIOLATION)
    msgs = [f.message for f in report.findings if f.rule == "INF003"]
    assert any("mixed f32xf64" in m for m in msgs)
    assert any("kind='stable'" in m for m in msgs)
    assert any("iteration over a set" in m for m in msgs)


def test_inf003_silent_on_blessed_idioms(tmp_path):
    report = analyze(tmp_path, {
        "inferno_tpu_torch/solver/x.py": (
            "import numpy as np\n"
            "def decide(a64, b64):\n"
            "    out = np.zeros(4, dtype=np.float32)\n"
            "    np.divide(a64, b64, out=out)\n"
            "    acc = (a64 + b64).astype(np.float32)\n"
            "    order = np.argsort(acc, kind='stable')\n"
            "    lanes = np.lexsort((acc, order))\n"
            "    chosen = {1, 2, 3}\n"
            "    stable = [v for v in sorted(chosen)]\n"
            "    return out, order, lanes, stable\n"
        ),
    })
    assert not [f for f in report.findings if f.rule == "INF003"]


def test_inf003_list_sort_is_stable_and_passes(tmp_path):
    # Python's list.sort() is stable by specification (and kind= would be
    # a TypeError on it): a method-form .sort() on an untyped receiver
    # passes, while .argsort() (lists have none) and .sort() on a known
    # ndarray receiver still fire
    report = analyze(tmp_path, {
        "inferno_tpu_torch/solver/x.py": (
            "import numpy as np\n"
            "def decide(entries, vals):\n"
            "    entries.sort()\n"
            "    arr = np.zeros(4, dtype=np.float64)\n"
            "    arr.sort()\n"
            "    rank = vals.argsort()\n"
            "    return entries, arr, rank\n"
        ),
    })
    msgs = [f.message for f in report.findings if f.rule == "INF003"]
    assert len(msgs) == 2
    assert any("arr.sort()" in m for m in msgs)
    assert any("vals.argsort()" in m for m in msgs)
    assert not any("entries.sort()" in m for m in msgs)


def test_inf003_scoped_to_parity_packages(tmp_path):
    # the identical code OUTSIDE ops/parallel/solver/planner/spot passes
    src = INF003_VIOLATION["inferno_tpu_torch/solver/x.py"]
    report = analyze(tmp_path, {"inferno_tpu_torch/controller/x.py": src})
    assert not [f for f in report.findings if f.rule == "INF003"]


def test_inf003_unstable_torch_sort_fires_and_stable_passes(tmp_path):
    report = analyze(tmp_path, {
        "inferno_tpu_torch/parallel/x.py": (
            "import torch\n"
            "def order(vals, keys):\n"
            "    a = torch.sort(vals)\n"
            "    b = torch.argsort(vals, dim=0)\n"
            "    c = keys.argsort()\n"
            "    t = torch.zeros(4, dtype=torch.float64)\n"
            "    d = t.sort()\n"
            "    e = torch.sort(vals, stable=True)\n"
            "    f = torch.argsort(vals, dim=0, stable=True)\n"
            "    g = keys.argsort(stable=True)\n"
            "    h = t.sort(stable=True)\n"
            "    return a, b, c, d, e, f, g, h\n"
        ),
    }, torch_rules=("INF003",))
    lines = sorted(f.line for f in report.findings if f.rule == "INF003")
    assert lines == [3, 4, 5, 7]
    msgs = [f.message for f in report.findings if f.line in (3, 4)]
    assert all("stable=True" in m for m in msgs)


def test_inf003_tensor_method_sort_needs_stable(tmp_path):
    # t.sort() on a receiver known to be a tensor (a torch.* call, a name
    # assigned from one, or a .to()/.clone() of either) needs stable=True,
    # typed or not; kind= is not torch's and does not pass; a name last
    # assigned a list keeps list.sort()'s stable pass
    report = analyze(tmp_path, {
        "inferno_tpu_torch/solver/x.py": (
            "import torch\n"
            "def order(vals):\n"
            "    t = torch.zeros(4, dtype=torch.float32)\n"
            "    a = t.sort()\n"
            "    u = torch.as_tensor(vals)\n"
            "    b = u.sort(descending=True)\n"
            "    w = u.to('cpu').clone()\n"
            "    c = w.sort(kind='stable')\n"
            "    d = torch.randn(4).sort()\n"
            "    e = t.sort(stable=True)\n"
            "    f = w.sort(stable=True, descending=True)\n"
            "    u = list(vals)\n"
            "    u.sort()\n"
            "    return a, b, c, d, e, f, u\n"
        ),
    }, torch_rules=("INF003",))
    found = sorted((f.line, f.message) for f in report.findings if f.rule == "INF003")
    assert [line for line, _ in found] == [4, 6, 8, 9]
    assert all("without stable=True" in m for _, m in found)


def test_inf003_torch_casts_and_constructors_tag_dtypes(tmp_path):
    # x.to(torch.float32) tags its result f32 as .astype does; a torch
    # constructor's dtype= tags its result: mixing the two precisions
    # fires, the f64-accumulate-then-cast idiom passes
    report = analyze(tmp_path, {
        "inferno_tpu_torch/ops/x.py": (
            "import torch\n"
            "def fold(x, y):\n"
            "    y64 = torch.zeros(4, dtype=torch.float64)\n"
            "    bad = x.to(torch.float32) * y64\n"
            "    also = torch.tensor([1.0], dtype=torch.float) + torch.ones(4, dtype=torch.double)\n"
            "    good = (x.to(torch.float64) * y64).to(torch.float32)\n"
            "    moved = x.to('cpu') * y64\n"
            "    return bad, also, good, moved\n"
        ),
    }, torch_rules=("INF003",))
    lines = sorted(f.line for f in report.findings if f.rule == "INF003")
    assert lines == [4, 5]


# -- INF004 lock-discipline ---------------------------------------------------

INF004_VIOLATION = {
    "inferno_tpu_torch/obs/x.py": (
        "import threading\n"
        "class Worker:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.total = 0\n"
        "        threading.Thread(target=self._run).start()\n"
        "    def _run(self):\n"
        "        self.total = self.total + 1\n"
        "    def reset(self):\n"
        "        with self._lock:\n"
        "            self.total = 0\n"
    ),
}


def test_inf004_unguarded_shared_write_fires(tmp_path):
    report = analyze(tmp_path, INF004_VIOLATION)
    assert [f.rule for f in report.findings] == ["INF004"]
    f = report.findings[0]
    assert f.qualname == "Worker._run" and "holds no lock" in f.message


def test_inf004_lock_order_cycle_fires(tmp_path):
    report = analyze(tmp_path, {
        "inferno_tpu_torch/obs/x.py": (
            "import threading\n"
            "class Dining:\n"
            "    def __init__(self):\n"
            "        self._a = threading.Lock()\n"
            "        self._b = threading.Lock()\n"
            "    def one(self):\n"
            "        with self._a:\n"
            "            with self._b:\n"
            "                pass\n"
            "    def two(self):\n"
            "        with self._b:\n"
            "            with self._a:\n"
            "                pass\n"
        ),
    })
    assert any(
        f.rule == "INF004" and "lock-order cycle" in f.message
        for f in report.findings
    )


def test_inf004_nonreentrant_self_reacquire_fires(tmp_path):
    report = analyze(tmp_path, {
        "inferno_tpu_torch/obs/x.py": (
            "import threading\n"
            "class Nested:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "    def work(self):\n"
            "        with self._lock:\n"
            "            with self._lock:\n"
            "                pass\n"
        ),
    })
    assert any(
        f.rule == "INF004" and "cycle" in f.message for f in report.findings
    )


def test_inf004_silent_on_guarded_writes_and_rlock(tmp_path):
    report = analyze(tmp_path, {
        "inferno_tpu_torch/obs/x.py": (
            "import threading\n"
            "class Worker:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.RLock()\n"
            "        self.total = 0\n"
            "        threading.Thread(target=self._run).start()\n"
            "    def _run(self):\n"
            "        with self._lock:\n"
            "            self.total = self.total + 1\n"
            "    def reset(self):\n"
            "        with self._lock:\n"
            "            with self._lock:\n"
            "                self.total = 0\n"
        ),
    })
    assert not [f for f in report.findings if f.rule == "INF004"]


# -- INF005 clock-injection ---------------------------------------------------

INF005_VIOLATION = {
    "inferno_tpu_torch/controller/x.py": (
        "import time\n"
        "def deadline():\n"
        "    return time.time() + 5.0\n"
    ),
}


def test_inf005_wall_clock_fires(tmp_path):
    report = analyze(tmp_path, INF005_VIOLATION)
    assert [f.rule for f in report.findings] == ["INF005"]
    assert "time.time" in report.findings[0].message


def test_inf005_seam_files_are_exempt(tmp_path):
    report = analyze(tmp_path, {
        "inferno_tpu_torch/obs/trace.py": (
            "import time\n"
            "def now():\n"
            "    return time.perf_counter()\n"
        ),
        "inferno_tpu_torch/emulator/disagg.py": (
            "import time\n"
            "def virtual_base():\n"
            "    return time.monotonic()\n"
        ),
    })
    assert report.findings == []


def test_inf005_engine_graduated_out_of_seam_set(tmp_path):
    # emulator/engine.py takes its wall source via the constructor-injected
    # `clock`, so a raw read there must fire like anywhere else (the fleet
    # twin's determinism depends on it)
    report = analyze(tmp_path, {
        "inferno_tpu_torch/emulator/engine.py": (
            "import time\n"
            "def virtual_base():\n"
            "    return time.monotonic()\n"
        ),
    })
    assert [f.rule for f in report.findings] == ["INF005"]


# -- escape hatches -----------------------------------------------------------


def test_noqa_suppresses_only_named_rule(tmp_path):
    report = analyze(tmp_path, {
        "inferno_tpu_torch/controller/x.py": (
            "import time\n"
            "def deadline():\n"
            "    return time.time() + 5.0  # noqa: INF005\n"
            "def other():\n"
            "    return time.time()  # noqa: INF001\n"
        ),
    })
    # the INF005 noqa suppresses line 3; the mismatched INF001 noqa on
    # line 5 suppresses nothing
    assert len(report.findings) == 1
    assert report.findings[0].line == 5
    assert report.noqa_suppressed == 1


def test_allowlist_round_trip(tmp_path):
    write_tree(tmp_path, INF005_VIOLATION)
    found = run_analysis(tmp_path, allowlist_path=None)
    assert len(found.findings) == 1
    key = found.findings[0].key
    assert key.startswith("INF005 inferno_tpu_torch/")
    allow = tmp_path / "allow.txt"
    allow.write_text(f"# grandfathered\n{key}\n")
    report = run_analysis(tmp_path, allowlist_path=allow)
    assert report.clean and report.grandfathered == 1
    # fix the violation: the now-stale entry itself fails the gate
    (tmp_path / "inferno_tpu_torch/controller/x.py").write_text(
        "def deadline(clock):\n    return clock() + 5.0\n"
    )
    stale = run_analysis(tmp_path, allowlist_path=allow)
    assert not stale.clean and stale.stale_entries == [key]


def test_allowlist_rejects_malformed_entries(tmp_path):
    allow = tmp_path / "allow.txt"
    allow.write_text("INF999 nope::x\n")
    with pytest.raises(ValueError, match="malformed allowlist entry"):
        load_allowlist(allow)


def test_rules_filter_does_not_stale_other_rules_entries(tmp_path):
    # a --rules subset filters findings BEFORE the allowlist pass, so
    # other rules' grandfather entries must not read as stale
    write_tree(tmp_path, INF005_VIOLATION)
    found = run_analysis(tmp_path, allowlist_path=None)
    allow = tmp_path / "allow.txt"
    allow.write_text(found.findings[0].key + "\n")
    report = run_analysis(tmp_path, allowlist_path=allow, rules={"INF001"})
    assert report.clean


# -- CLI exit-code contract ---------------------------------------------------

VIOLATION_FIXTURES = {
    "INF001": {
        "inferno_tpu_torch/controller/x.py": "import os\nV = os.getenv('V')\n",
    },
    "INF002": INF002_VIOLATION["cuda_graph"],
    "INF003": INF003_VIOLATION,
    "INF004": INF004_VIOLATION,
    "INF005": INF005_VIOLATION,
}


@pytest.mark.parametrize("rule", sorted(VIOLATION_FIXTURES))
def test_cli_exits_nonzero_on_each_crafted_violation(tmp_path, rule):
    write_tree(tmp_path, VIOLATION_FIXTURES[rule])
    assert cli_main(["--root", str(tmp_path), "--no-allowlist"]) == 1
    # and the finding survives a --rules subset naming just this rule
    assert cli_main(
        ["--root", str(tmp_path), "--no-allowlist", "--rules", rule]
    ) == 1


def test_cli_exits_zero_on_clean_tree(tmp_path):
    write_tree(
        tmp_path,
        {"inferno_tpu_torch/controller/x.py": "def f(clock):\n    return clock()\n"},
    )
    assert cli_main(["--root", str(tmp_path), "--no-allowlist"]) == 0


def test_cli_rejects_unknown_rule(tmp_path, capsys):
    assert cli_main(["--root", str(tmp_path), "--rules", "INF999"]) == 2


def test_cli_list_rules(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in RULES:
        assert rule in out


def test_module_entry_point_runs_from_the_repo_root():
    # python -m inferno_tpu_torch.analysis --budget-seconds 30 from the
    # repo root: the gate must hold at HEAD
    proc = subprocess.run(
        [sys.executable, "-m", "inferno_tpu_torch.analysis", "--budget-seconds", "30"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "clean" in proc.stdout


# -- the reference's tree under the port's analyzer ---------------------------


def test_reference_tree_gives_the_reference_report():
    """Run on inferno_tpu/ with the reference's allowlist and table, the
    port's analyzer reproduces the reference analyzer's report: the same
    findings (none), grandfathered and noqa counts, no stale entry; and
    without an allowlist the same finding set, line for line."""
    ref = ref_run_analysis(REPO)
    port = run_analysis(REPO, allowlist_path=REF_ALLOWLIST, package=REF,
                        docs_path=REPO / DOCS[REF])
    assert port.findings == ref.findings == []
    assert port.stale_entries == ref.stale_entries == []
    assert (port.grandfathered, port.noqa_suppressed) == (
        ref.grandfathered, ref.noqa_suppressed)
    assert port.grandfathered == 91 and port.noqa_suppressed == 2
    raw_ref = ref_run_analysis(REPO, allowlist_path=None)
    raw_port = run_analysis(REPO, allowlist_path=None, package=REF,
                            docs_path=REPO / DOCS[REF])
    assert [f.key for f in raw_port.findings] == [f.key for f in raw_ref.findings]
    assert _keys(raw_port, REF) == _keys(raw_ref, REF)


def test_cli_on_the_reference_tree_prints_the_reference_summary():
    args = ["--package", REF, "--allowlist", str(REF_ALLOWLIST), "--docs", DOCS[REF]]
    outs = []
    for cmd in ([sys.executable, "-m", "inferno_tpu.analysis"],
                [sys.executable, "-m", "inferno_tpu_torch.analysis", *args]):
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        outs.append(proc.stdout.split("(", 1)[1])
    assert outs[0] == outs[1] == "91 grandfathered, 2 noqa-suppressed)\n"


# -- the port's meta-checks ---------------------------------------------------


def test_port_head_is_clean_under_its_allowlist():
    t0 = time.perf_counter()  # noqa: INF005 (test harness timing)
    report = run_analysis(REPO)
    elapsed = time.perf_counter() - t0  # noqa: INF005
    assert report.clean, "\n".join(
        [f.render() for f in report.findings] + report.stale_entries
    )
    assert elapsed < 30.0, f"analyzer took {elapsed:.1f}s (budget 30s)"


# The committed allowlist may only SHRINK: 34 of the reference's 39 INF005
# entries, re-pathed (the five parallel/ timing sites went onto the cycle
# profiler's span). Fixing a site deletes its line and LOWERS the pin —
# never raise it to land new code (use a seam, or a justified noqa).
ALLOWLIST_CEILING = 34


def test_allowlist_only_shrinks():
    entries = load_allowlist(DEFAULT_ALLOWLIST)
    assert len(entries) <= ALLOWLIST_CEILING, (
        f"allowlist grew to {len(entries)} entries (ceiling "
        f"{ALLOWLIST_CEILING}): fix the new finding instead of "
        "grandfathering it"
    )


def test_allowlist_is_the_references_repathed():
    # every entry is one of the reference's, under the port's package; the
    # read of the reference's fleet._solve_all sits in the port's solve_slots
    ref = {k.replace("inferno_tpu/", "inferno_tpu_torch/", 1)
           for k in load_allowlist(REF_ALLOWLIST)}
    ref = {k.replace("fleet.py::_solve_all", "fleet.py::solve_slots") for k in ref}
    assert set(load_allowlist(DEFAULT_ALLOWLIST)) <= ref


def test_hot_paths_carry_no_purity_or_numerics_entries():
    # ops/, parallel/, solver/ have ZERO allowlist entries for INF002
    # (jit-purity) and INF003 (parity-numerics)
    hot = ("inferno_tpu_torch/ops/", "inferno_tpu_torch/parallel/",
           "inferno_tpu_torch/solver/")
    offenders = [
        key
        for key in load_allowlist(DEFAULT_ALLOWLIST)
        if key.split()[0] in ("INF002", "INF003")
        and key.split()[1].startswith(hot)
    ]
    assert offenders == []


def test_no_config_registry_entries_remain():
    # the port's INF001 findings were FIXED (routed through accessors,
    # documented, or argv), not allowlisted
    entries = [k for k in load_allowlist(DEFAULT_ALLOWLIST) if k.startswith("INF001")]
    assert entries == []


def test_allowlist_holds_only_inf005():
    rules = {k.split()[0] for k in load_allowlist(DEFAULT_ALLOWLIST)}
    assert rules <= {"INF005"}


def test_every_rule_is_catalogued_in_docs():
    doc = (REPO / "docs/analysis-torch.md").read_text()
    for rule in RULES:
        assert rule in doc, f"{rule} missing from docs/analysis-torch.md"


def test_env_table_documents_the_ports_values():
    # the port's table, not the reference's: its backends and its device
    from inferno_tpu_torch.analysis.config_registry import documented_vars

    path = REPO / DOCS[PORT]
    assert len(documented_vars(path)) == 71 and "COMPUTE_DEVICE" in documented_vars(path)
    text = path.read_text()
    row = next(line for line in text.splitlines() if line.startswith("| `COMPUTE_BACKEND`"))
    for value in ("cuda", "torch", "native", "scalar"):
        assert f"`{value}`" in row
    twin = next(line for line in text.splitlines() if line.startswith("| `TWIN_BACKEND`"))
    assert "| `torch` |" in twin and "`numpy`" in twin
