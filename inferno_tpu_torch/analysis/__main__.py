"""CLI: `python -m inferno_tpu_torch.analysis [--root .] [--budget-seconds 30]`.

Port of `inferno_tpu/analysis/__main__.py`, with the reference's
exit-code contract: 0 clean, 1 findings (or stale allowlist entries), 2
usage / budget exceeded. `--budget-seconds` asserts the analyzer never
becomes the slow step (the bound is 30 s). It analyses the port's
package against the port's allowlist and environment table unless
`--package`, `--allowlist` and `--docs` name others (the reference's:
`--package inferno_tpu --allowlist inferno_tpu/analysis/allowlist.txt
--docs docs/user-guide/configuration.md`).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from inferno_tpu_torch.analysis.core import (
    DEFAULT_ALLOWLIST,
    DEFAULT_DOCS,
    PACKAGE,
    RULES,
    run_analysis,
)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m inferno_tpu_torch.analysis",
        description="repo-wide invariant analyzer (INF001-INF005; docs/analysis-torch.md)",
    )
    ap.add_argument(
        "--root", default=".", help="repository root (contains the package and docs/)"
    )
    ap.add_argument(
        "--package", default=PACKAGE, help=f"the package to analyse (default: {PACKAGE})"
    )
    ap.add_argument(
        "--docs",
        default=str(DEFAULT_DOCS),
        help=f"the environment table, relative to --root (default: {DEFAULT_DOCS})",
    )
    ap.add_argument(
        "--allowlist",
        default=str(DEFAULT_ALLOWLIST),
        help="pinned grandfather allowlist (default: analysis/allowlist.txt)",
    )
    ap.add_argument(
        "--no-allowlist",
        action="store_true",
        help="report every finding, grandfathered or not",
    )
    ap.add_argument(
        "--rules",
        default="",
        help="comma-separated subset (e.g. INF001,INF003); default all",
    )
    ap.add_argument(
        "--budget-seconds",
        type=float,
        default=0.0,
        help="fail (exit 2) if the analysis itself exceeds this wall time",
    )
    ap.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog and exit"
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}  {desc}")
        return 0

    rules = None
    if args.rules:
        rules = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = rules - set(RULES)
        if unknown:
            print(f"lint-invariants: unknown rule(s) {sorted(unknown)}", file=sys.stderr)
            return 2

    root = Path(args.root).resolve()
    # the CLI is an offline gate: wall time here is the gate's own
    # runtime budget, not control-plane logic (hence the noqa)
    t0 = time.perf_counter()  # noqa: INF005
    report = run_analysis(
        root,
        allowlist_path=None if args.no_allowlist else Path(args.allowlist),
        docs_path=root / args.docs,
        rules=rules,
        package=args.package,
    )
    elapsed = time.perf_counter() - t0  # noqa: INF005

    for f in report.findings:
        print(f"lint-invariants: {f.render()}", file=sys.stderr)
    for entry in report.stale_entries:
        print(
            f"lint-invariants: stale allowlist entry (fixed? delete its line): {entry}",
            file=sys.stderr,
        )
    status = 0
    if report.findings or report.stale_entries:
        status = 1
    else:
        print(
            f"lint-invariants: clean in {elapsed:.1f}s "
            f"({report.grandfathered} grandfathered, "
            f"{report.noqa_suppressed} noqa-suppressed)"
        )
    if args.budget_seconds and elapsed > args.budget_seconds:
        print(
            f"lint-invariants: analyzer took {elapsed:.1f}s "
            f"> budget {args.budget_seconds:.0f}s",
            file=sys.stderr,
        )
        return 2
    return status


if __name__ == "__main__":
    sys.exit(main())
