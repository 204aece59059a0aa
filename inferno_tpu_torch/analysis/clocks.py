"""INF005 clock-injection: wall-clock reads stay behind injectable seams.

The emu-vs-wall flake class the emulator's tests kept chasing (tests asserting
virtual-clock behavior against wall-clock-paced code) exists because
wall-clock reads leak into logic that has an injectable clock available.
This rule bans `time.time()/monotonic()/perf_counter()/..._ns()` and
`datetime.now()/utcnow()/today()` everywhere in the package EXCEPT the
designated seams, which own the clock and hand it out injectably:

  - obs/trace.py      the Tracer's span clock (constructor-injectable)
  - emulator/disagg.py
                      the tandem engine's virtual-clock plumbing (it
                      derives its discrete-event clock from wall time by
                      design; everything downstream reads the EMULATED
                      clock). emulator/engine.py graduated OUT of the
                      seam set: its wall source is now the
                      constructor-injected `clock` and the sync-stepped
                      oracle mode never consults it.

Everything else either takes a clock (Reconciler.clock, the forecaster
and stabilizer timestamps, LoadGenerator pacing) or is grandfathered
explicitly in analysis/allowlist.txt — new code must inject.

Port of `inferno_tpu/analysis/clocks.py`: the seam files are named
relative to the analysed package. The port adds no seam file; its own
host-clock sites (the kernel build's duration, the profiling tool's
timers) carry a `# noqa: INF005` with their reason, and
`parallel.ranks.run_ranks` takes a clock.
"""

from __future__ import annotations

import ast

from inferno_tpu_torch.analysis.core import Finding, Module, QualnameVisitor, dotted

RULE = "INF005"

# relative to the analysed package
SEAM_FILES = frozenset(
    {
        "obs/trace.py",
        "emulator/disagg.py",
    }
)

WALL_CALLS = frozenset(
    {
        "time.time",
        "time.monotonic",
        "time.perf_counter",
        "time.process_time",
        "time.time_ns",
        "time.monotonic_ns",
        "time.perf_counter_ns",
        "datetime.now",
        "datetime.utcnow",
        "datetime.today",
        "datetime.datetime.now",
        "datetime.datetime.utcnow",
        "datetime.datetime.today",
        "date.today",
        "datetime.date.today",
    }
)


class _Visitor(QualnameVisitor):
    def visit_Call(self, node: ast.Call) -> None:
        name = dotted(node.func)
        if name in WALL_CALLS:
            self.add(
                RULE,
                node,
                f"wall-clock read {name}() outside an injectable-clock seam; "
                "take a clock parameter (like Reconciler.clock) or read the "
                "virtual clock",
            )
        self.generic_visit(node)


def check(modules: list[Module], *, package: str) -> list[Finding]:
    findings: list[Finding] = []
    seams = {f"{package}/{f}" for f in SEAM_FILES}
    for mod in modules:
        if mod.path in seams:
            continue
        v = _Visitor(mod)
        v.visit(mod.tree)
        findings.extend(v.findings)
    return findings
