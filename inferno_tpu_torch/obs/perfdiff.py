"""Per-phase performance diff over profile sources (`make perf-gate`).

``python -m inferno_tpu_torch.obs.perfdiff BASE CANDIDATE`` compares two
profile sources and emits a per-metric regression verdict. Three source
shapes are understood, sniffed by content — no flags needed:

* **BENCH_r trajectory point** (``BENCH_r01.json`` ... — the recorded
  capture of one bench revision): metrics come from the compact line's
  ``parsed.extra`` numeric keys (``fleet_cycle_ms``, ``sizing_10k_ms``,
  ``cycle_jit_ms``, ``profile_overhead_pct``, ...). ``BASE`` may be the
  literal ``auto``: the highest-numbered ``BENCH_r*.json`` next to the
  candidate (or under ``--repo``) is picked — the compact line's
  ``bench_rev`` tag exists so this join needs no filename guessing.
* **bench_full.json** (the full payload ``bench.py`` writes): the
  ``profile`` block's per-phase attribution plus the per-subsystem bench
  blocks (sizing curve, capacity points, planner, fleet cycle, the
  incremental dirty-set points — ``incremental_steady_ms`` /
  ``incremental_cold_ms``), each carrying its repeat-noise spread where
  the bench measured one.
* **live profile artifact**: a single per-cycle profile document
  (``inferno.profile/v1``) or a ``/debug/profile`` download
  (``{"cycles": [...]}``); per-phase wall times and ``*_ms`` counters
  are medianed over the cycles with max-min spread as the noise band.

Verdict rule, per metric present in BOTH sources: the candidate
regresses when it exceeds the base by more than
``max(threshold, relative repeat-noise)`` AND by at least
``--min-abs-ms`` (so a 0.4 ms phase doubling does not fail a CI run).
The noise band reuses the bench's spread machinery: every ``*_ms_spread``
(max-min over repeats) recorded next to a bench number widens that
metric's band. Exit codes: 0 clean, 2 regression (named metric on
stderr), 1 usage/load error — ``make perf-gate`` branches on these.

Port of `inferno_tpu/obs/perfdiff.py`, verbatim apart from its imports
and the profile documents' counters: it reads the port's cycle profiles
(`obs/profiler.py`, the same ``inferno.profile/v1`` schema) as well as
the reference's bench files. A port profile's solve dispatch is its
``dispatch_ms`` counter, diffed like every ``*_ms`` counter; the
reference's compile-vs-execute sum (``cycle_jit_ms``) has no port
counterpart and is not derived from a profile.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys
from typing import Any

from inferno_tpu_torch.obs.profiler import PROFILE_SCHEMA

# default multiplicative tolerance: generous enough for cross-run CPU
# variance on shared CI boxes, tight enough that the 2x regressions the
# gate exists for (an accidentally-disabled memo, a recompile every
# cycle) cannot hide inside it
DEFAULT_THRESHOLD = 0.5
DEFAULT_MIN_ABS_MS = 5.0
# absolute floor for *_pct metrics (percentage points, NOT ms): the ms
# floor would render any percentage bounded near 1 — like
# profile_overhead_pct, whose own bench raises above 1.0 — permanently
# un-gateable
MIN_ABS_PCT = 0.5


def _num(v) -> float | None:
    return float(v) if isinstance(v, (int, float)) and not isinstance(v, bool) else None


class Metric(dict):
    """{"value": float, "spread": float} — plain dict for JSON output."""

    def __init__(self, value: float, spread: float = 0.0):
        super().__init__(value=round(value, 3), spread=round(spread, 3))


# configuration constants that ride the bench blocks next to the
# measurements — never comparable metrics
_NON_METRIC_KEYS = frozenset({
    "overhead_budget_pct", "overhead_reference_ms",
})


def _is_metric_key(key: str) -> bool:
    return (
        key.endswith(("_ms", "_pct"))
        and not key.endswith("_spread")
        and key not in _NON_METRIC_KEYS
    )


def metrics_from_bench_r(doc: dict) -> dict[str, Metric]:
    """A recorded trajectory point: parsed.extra numeric keys."""
    extra = ((doc.get("parsed") or {}).get("extra") or {})
    out = {}
    for key, val in extra.items():
        v = _num(val)
        if v is not None and _is_metric_key(key):
            out[key] = Metric(v)
    return out


def metrics_from_profile_cycles(cycles: list[dict]) -> dict[str, Metric]:
    """Median + max-min spread over per-cycle profile documents."""
    series: dict[str, list[float]] = {}
    for cyc in cycles:
        wall = _num((cyc.get("cycle") or {}).get("wall_ms"))
        if wall is not None:
            series.setdefault("cycle_ms", []).append(wall)
        for phase, entry in (cyc.get("phases") or {}).items():
            v = _num((entry or {}).get("wall_ms"))
            if v is not None:
                series.setdefault(f"phase_{phase}_ms", []).append(v)
        for name, val in (cyc.get("counters") or {}).items():
            v = _num(val)
            if v is not None and name.endswith("_ms"):
                series.setdefault(name, []).append(v)
    return {
        k: Metric(statistics.median(vs), max(vs) - min(vs))
        for k, vs in series.items()
    }


def metrics_from_bench_full(doc: dict) -> dict[str, Metric]:
    """The bench_full.json payload: the profile block plus every
    subsystem block that records a spread next to its headline number."""
    out: dict[str, Metric] = {}

    prof = doc.get("profile") or {}
    for key, val in prof.items():
        v = _num(val)
        if v is not None and _is_metric_key(key):
            out[key] = Metric(v, _num(prof.get(f"{key}_spread")) or 0.0)
    for phase, entry in (prof.get("phases") or {}).items():
        v = _num((entry or {}).get("wall_ms"))
        if v is not None:
            out[f"phase_{phase}_ms"] = Metric(v)

    sizing = doc.get("sizing") or {}
    for point in sizing.get("curve") or []:
        v = _num(point.get("sizing_ms"))
        n = point.get("n_variants")
        if v is not None and n:
            m = Metric(v, _num(point.get("sizing_ms_spread")) or 0.0)
            out[f"sizing_{n}_ms"] = m
            if n == 10000:
                out["sizing_10k_ms"] = m  # the compact-line alias

    capacity = doc.get("capacity") or {}
    points = capacity.get("points") or []
    for point in points:
        v = _num(point.get("solve_ms"))
        frac = _num(point.get("fraction"))
        if v is not None and frac is not None:
            out[f"capacity_{int(frac * 100)}pct_ms"] = Metric(
                v, _num(point.get("solve_ms_spread")) or 0.0
            )
    if points and _num(points[-1].get("solve_ms")) is not None:
        out["capacity_10k_ms"] = Metric(
            _num(points[-1].get("solve_ms")),
            _num(points[-1].get("solve_ms_spread")) or 0.0,
        )

    planner = doc.get("planner") or {}
    if _num(planner.get("planner_week_ms")) is not None:
        out["planner_week_ms"] = Metric(_num(planner.get("planner_week_ms")))

    # Monte Carlo seed-axis ensemble (`make bench-montecarlo`):
    # the steady-state ensemble wall is the phase to watch, noise-banded
    # by its recorded warm-repeat spread. mc_cold_ms is deliberately NOT
    # gated: it is a single unrepeated cold measurement (memo rebuild +
    # jit dispatch) with no spread to widen the band, and would flap on
    # shared runners.
    montecarlo = doc.get("montecarlo") or {}
    if _num(montecarlo.get("mc_week_ms")) is not None:
        out["mc_week_ms"] = Metric(
            _num(montecarlo.get("mc_week_ms")),
            _num(montecarlo.get("mc_week_ms_spread")) or 0.0,
        )

    cycles = doc.get("cycles") or {}
    if _num(cycles.get("auto_selected_ms")) is not None and "fleet_cycle_ms" not in out:
        out["fleet_cycle_ms"] = Metric(_num(cycles.get("auto_selected_ms")))

    recorder = doc.get("recorder") or {}
    for key in ("recorder_overhead_pct", "recorder_replay_ms"):
        if _num(recorder.get(key)) is not None:
            out[key] = Metric(_num(recorder.get(key)))

    # incremental dirty-set reconcile (`make bench-incremental`):
    # the steady-state cycle is the one to watch — a regression there is
    # named like any other phase. Spread bands ride along where measured.
    incremental = doc.get("incremental") or {}
    for key in (
        "incremental_steady_ms", "incremental_cold_ms",
        "incremental_all_rate_ms",
    ):
        if _num(incremental.get(key)) is not None:
            out[key] = Metric(
                _num(incremental.get(key)),
                _num(incremental.get(f"{key}_spread")) or 0.0,
            )
    # compact-line aliases (the BENCH_r trajectory join uses these names)
    if "incremental_steady_ms" in out:
        out["incr_steady_ms"] = out["incremental_steady_ms"]
    if "incremental_cold_ms" in out:
        out["incr_cold_ms"] = out["incremental_cold_ms"]

    # event-driven reconcile (`make bench-event`): the p99
    # single-variant event->decision latency and the 1%-events steady
    # cycle are the deliverables — both noise-banded by their recorded
    # warm-repeat spreads (batch-p99 spread for the latency, warm-cycle
    # spread for the steady point). poll_steady_ms is a baseline, not a
    # deliverable, and the storm entry/exit are single unrepeated
    # whole-fleet measurements — deliberately NOT gated.
    event = doc.get("event") or {}
    for key in ("event_p99_latency_ms", "event_steady_ms"):
        if _num(event.get(key)) is not None:
            out[key] = Metric(
                _num(event.get(key)),
                _num(event.get(f"{key}_spread")) or 0.0,
            )
    # compact-line alias (the BENCH_r trajectory join uses this name)
    if "event_p99_latency_ms" in out:
        out["event_p99_ms"] = out["event_p99_latency_ms"]

    # vectorized fleet twin (`make bench-twin`): the warm
    # 1000-engine pass is the phase to watch, noise-banded by its
    # recorded warm-repeat spread. twin_fleet_cold_ms is deliberately
    # NOT gated (single unrepeated allocation-heavy measurement, same
    # rationale as mc_cold_ms); oracle_serial_ms is a baseline, not a
    # deliverable — a slower oracle is not a product regression.
    twin = doc.get("twin") or {}
    if _num(twin.get("twin_fleet_ms")) is not None:
        out["twin_fleet_ms"] = Metric(
            _num(twin.get("twin_fleet_ms")),
            _num(twin.get("twin_fleet_ms_spread")) or 0.0,
        )
    return out


def extract_metrics(doc: Any) -> dict[str, Metric]:
    """Sniff the source shape and normalize it to {metric: Metric}."""
    if isinstance(doc, dict) and doc.get("schema") == PROFILE_SCHEMA:
        return metrics_from_profile_cycles([doc])
    if isinstance(doc, dict) and isinstance(doc.get("cycles"), list) and any(
        isinstance(c, dict) and c.get("schema") == PROFILE_SCHEMA
        for c in doc["cycles"]
    ):
        return metrics_from_profile_cycles(
            [c for c in doc["cycles"] if isinstance(c, dict)]
        )
    if isinstance(doc, dict) and "parsed" in doc:
        return metrics_from_bench_r(doc)
    if isinstance(doc, dict):
        return metrics_from_bench_full(doc)
    raise ValueError(f"unrecognized profile source shape: {type(doc).__name__}")


def compare(
    base: dict[str, Metric],
    cand: dict[str, Metric],
    threshold: float = DEFAULT_THRESHOLD,
    min_abs_ms: float = DEFAULT_MIN_ABS_MS,
) -> dict[str, Any]:
    """Per-metric verdicts over the overlap of two normalized sources.

    ``regression`` iff candidate > base * (1 + max(threshold, noise))
    and the absolute excess is >= min_abs_ms, where noise is the summed
    relative repeat-spread of both measurements (the repeat-noise band)."""
    rows: list[dict[str, Any]] = []
    regressions: list[str] = []
    for key in sorted(set(base) & set(cand)):
        b, c = base[key], cand[key]
        bval, cval = b["value"], c["value"]
        noise = (
            (b["spread"] + c["spread"]) / bval if bval > 0 else 0.0
        )
        band = max(threshold, noise)
        floor = min_abs_ms if not key.endswith("_pct") else MIN_ABS_PCT
        verdict = "ok"
        if bval >= 0 and cval > bval * (1.0 + band) and (cval - bval) >= floor:
            verdict = "REGRESSION"
            regressions.append(key)
        elif bval > 0 and cval < bval * (1.0 - band):
            verdict = "improved"
        rows.append({
            "metric": key,
            "base": bval,
            "candidate": cval,
            "ratio": round(cval / bval, 3) if bval > 0 else None,
            "band_pct": round(band * 100.0, 1),
            "verdict": verdict,
        })
    return {
        "compared": len(rows),
        "regressions": regressions,
        "rows": rows,
        "only_in_base": sorted(set(base) - set(cand)),
        "only_in_candidate": sorted(set(cand) - set(base)),
    }


_BENCH_R_RE = re.compile(r"^BENCH_r(\d+)\.json$")


def trajectory_tip(search_dir: str) -> tuple[int, str | None]:
    """(highest revision index, path) of the committed BENCH_r*.json
    trajectory in `search_dir`; (0, None) when the trajectory is empty.
    THE one scan of the trajectory file-naming convention — the `auto`
    baseline resolution here and bench.py's `bench_rev` stamp both go
    through it, so the convention cannot drift between the two."""
    best: tuple[int, str] | None = None
    try:
        names = os.listdir(search_dir)
    except OSError:
        return 0, None
    for name in names:
        m = _BENCH_R_RE.match(name)
        if m and (best is None or int(m.group(1)) > best[0]):
            best = (int(m.group(1)), name)
    if best is None:
        return 0, None
    return best[0], os.path.join(search_dir, best[1])


def latest_bench_r(search_dir: str) -> str | None:
    """Path of the trajectory's committed tip — what `auto` resolves to."""
    return trajectory_tip(search_dir)[1]


def _load(path: str) -> Any:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m inferno_tpu_torch.obs.perfdiff",
        description="Per-phase perf regression verdict between two "
                    "profile sources (BENCH_r*.json, bench_full.json, or "
                    "a /debug/profile artifact)",
    )
    ap.add_argument("base", help="baseline source path, or 'auto' for the "
                                 "highest committed BENCH_r*.json")
    ap.add_argument("candidate", help="candidate source path")
    ap.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD,
                    help="relative regression tolerance (default %(default)s "
                         "= +50%%; the repeat-noise band widens it)")
    ap.add_argument("--min-abs-ms", type=float, default=DEFAULT_MIN_ABS_MS,
                    help="ignore regressions smaller than this many ms "
                         "(default %(default)s)")
    ap.add_argument("--gate", action="store_true",
                    help="CI mode: exit 2 on any regression, exit 1 when "
                         "the sources share no metric (nothing was gated)")
    ap.add_argument("--json", action="store_true",
                    help="emit the full verdict document as JSON")
    ap.add_argument("--repo", default="",
                    help="directory to search for BENCH_r*.json when base "
                         "is 'auto' (default: the candidate's directory)")
    args = ap.parse_args(argv)

    base_path = args.base
    if base_path == "auto":
        search = args.repo or os.path.dirname(os.path.abspath(args.candidate))
        base_path = latest_bench_r(search)
        if base_path is None:
            print(f"perfdiff: no BENCH_r*.json found under {search!r}",
                  file=sys.stderr)
            return 1
    try:
        base = extract_metrics(_load(base_path))
        cand = extract_metrics(_load(args.candidate))
    except (OSError, json.JSONDecodeError, ValueError) as e:
        print(f"perfdiff: {e}", file=sys.stderr)
        return 1

    result = compare(base, cand, threshold=args.threshold,
                     min_abs_ms=args.min_abs_ms)
    result["base_source"] = base_path
    result["candidate_source"] = args.candidate

    if args.json:
        print(json.dumps(result, indent=1))
    else:
        width = max([len("metric")] + [len(r["metric"]) for r in result["rows"]])
        print(f"base: {base_path}\ncandidate: {args.candidate}")
        print(f"{'metric'.ljust(width)}  {'base':>10}  {'candidate':>10}  "
              f"{'ratio':>6}  {'band':>6}  verdict")
        for r in result["rows"]:
            ratio = f"{r['ratio']:.2f}" if r["ratio"] is not None else "-"
            print(f"{r['metric'].ljust(width)}  {r['base']:>10.1f}  "
                  f"{r['candidate']:>10.1f}  {ratio:>6}  "
                  f"{r['band_pct']:>5.0f}%  {r['verdict']}")
        for key in result["only_in_base"]:
            print(f"{key.ljust(width)}  (base only — not gated)")
        for key in result["only_in_candidate"]:
            print(f"{key.ljust(width)}  (candidate only — not gated)")

    if result["regressions"]:
        for key in result["regressions"]:
            row = next(r for r in result["rows"] if r["metric"] == key)
            print(
                f"perfdiff: REGRESSION in {key}: base {row['base']:.1f}, "
                f"candidate {row['candidate']:.1f} "
                f"(allowed band +{row['band_pct']:.0f}%)",
                file=sys.stderr,
            )
        return 2
    if args.gate and result["compared"] == 0:
        print("perfdiff: --gate with zero shared metrics — nothing was "
              "actually gated; refusing to report a clean pass",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
