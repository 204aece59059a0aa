"""Repo-wide invariant analyzer for the port (`python -m inferno_tpu_torch.analysis`).

Port of `inferno_tpu/analysis/__init__.py`. Five AST checkers on one
shared visitor/reporting core enforce the contracts the control plane's
correctness story rests on but that no compiler checks — the analogue of
obs/lint.py's metric-catalog lint, for source code:

  INF001 config-registry   every environment read goes through the typed
                           config/defaults.py accessors AND has a row in
                           docs/user-guide/configuration-torch.md
                           (diffed both directions)
  INF002 jit-purity        functions reachable from a CUDA-graph capture
                           (`with torch.cuda.graph(...)`,
                           make_graphed_callables, torch.compile) or from
                           jax.jit / shard_map call sites must not read
                           the environment, wall clocks, or RNG state,
                           nor mutate module globals
  INF003 parity-numerics   in the parity-critical packages (ops/,
                           parallel/, solver/, planner/, spot/): no
                           dtype-promoting f32xf64 arithmetic outside
                           the blessed f64-accumulate-then-f32-cast
                           idiom, no numpy or torch sorts without a
                           stable kind, no iteration over hash-ordered
                           sets
  INF004 lock-discipline   fields written from more than one thread
                           entry point are accessed under a lock, and
                           the static lock-order graph is acyclic
  INF005 clock-injection   wall-clock reads only inside the injectable-
                           clock seams (Reconciler.clock, the Tracer,
                           the emulator's virtual-clock plumbing)

The analysed package is a parameter (`run_analysis(package=...)`,
`--package`): the port's by default, the reference's with its own
allowlist and docs table, on which it reports what the reference's
analyzer reports. It lints source only: it imports no torch and touches
no device.

Escape hatches: a per-line `# noqa: INF0xx` comment, and the pinned
allowlist file (analysis/allowlist.txt) that grandfathers existing
violations explicitly — entries may only be removed, never added (the
meta-check in tests/test_torch_analysis.py pins the count). The hot-path
packages ops/, parallel/, solver/ carry ZERO allowlist entries for
INF002/INF003.

Run `python -m inferno_tpu_torch.analysis` (non-zero exit on findings),
or see docs/analysis-torch.md for the full rule catalog and rationale.
"""

from inferno_tpu_torch.analysis.core import (
    Finding,
    Module,
    load_allowlist,
    load_modules,
    run_analysis,
)

__all__ = [
    "Finding",
    "Module",
    "load_allowlist",
    "load_modules",
    "run_analysis",
]
