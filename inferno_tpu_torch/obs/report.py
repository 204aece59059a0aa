"""Offline attainment / model-error report over a recorded trace.

``python -m inferno_tpu_torch.obs.report <dir>`` loads a flight-recorder
artifact (obs/recorder.py), replays it through the planner's batched
solve to check replica/choice parity against the recorded live
decisions, re-runs the SLO-attainment scoreboard (obs/attainment.py)
over the recorded predicted/observed latency columns, and prints a
per-variant table:

    variant  cycles  mean_rpm  att_ttft  att_itl  err_ttft_ms  err_itl_ms  burn  replay_match

The EWMA gain mirrors the live controller's (``--ewma-gain``, default
the ATTAINMENT_EWMA_GAIN default), so the offline table reproduces what
the ``inferno_model_error_*`` / ``inferno_slo_attainment_ratio`` gauges
showed during the recorded window. ``--json`` emits the same data as
one JSON document; ``--no-replay`` skips the (solver-invoking) parity
pass for a pure telemetry read.

Port of `inferno_tpu/obs/report.py`, verbatim apart from its imports and
the parity replay's backend: `--backend` is "cuda" (the default) or
"torch", `--device` the device it sizes on (default: the CUDA card).
"""

from __future__ import annotations

import argparse
import json
import sys

from inferno_tpu_torch.obs.attainment import AttainmentConfig, AttainmentTracker
from inferno_tpu_torch.obs.recorder import read_artifact


def scoreboard_from_recorded(recorded, ewma_gain: float = 0.2) -> dict:
    """Run the attainment tracker over every recorded cycle in order,
    exactly as the live reconciler would have, and return per-variant
    rows keyed by variant id."""
    tracker = AttainmentTracker(AttainmentConfig(ewma_gain=ewma_gain))
    cycles_seen: dict[str, int] = {}
    rpm_sum: dict[str, float] = {}
    for cyc in recorded.cycles:
        for j, v in enumerate(cyc.variants):
            cycles_seen[v] = cycles_seen.get(v, 0) + 1
            rpm_sum[v] = rpm_sum.get(v, 0.0) + float(cyc.columns["arrival_rpm"][j])
            tracker.observe(
                v,
                predicted_ttft_ms=float(cyc.columns["ttft_predicted_ms"][j]),
                predicted_itl_ms=float(cyc.columns["itl_predicted_ms"][j]),
                observed_ttft_ms=float(cyc.columns["ttft_observed_ms"][j]),
                observed_itl_ms=float(cyc.columns["itl_observed_ms"][j]),
                slo_ttft_ms=float(cyc.columns["slo_ttft_ms"][j]),
                slo_itl_ms=float(cyc.columns["slo_itl_ms"][j]),
            )
    rows = {}
    snap = tracker.snapshot()["variants"]
    for v, n in cycles_seen.items():
        entry = snap.get(v, {})
        rows[v] = {
            "cycles": n,
            "mean_rpm": rpm_sum[v] / max(n, 1),
            "ttft_attainment": entry.get("ttft_attainment"),
            "itl_attainment": entry.get("itl_attainment"),
            "ttft_error_ewma_ms": entry.get("ttft_error_ewma_ms", 0.0),
            "itl_error_ewma_ms": entry.get("itl_error_ewma_ms", 0.0),
            "error_budget_burn": entry.get("error_budget_burn", 0.0),
        }
    return rows


def replay_match_by_variant(
    recorded, backend: str = "cuda", device=None
) -> tuple[dict[str, str], int]:
    """Per-variant replay verdict over the sampled parity cycles
    (first / middle / last): 'ok', 'MISMATCH', or 'skipped' (every
    record of the variant carried a non-replayable reason). Also
    returns how many sampled cycles actually replayed — a cycle whose
    snapshot is unresolvable cannot be checked, and zero checked cycles
    must never read as a clean pass."""
    from inferno_tpu_torch.planner.replay import PARITY_SKIP_REASONS, replay_cycle_parity

    verdict: dict[str, str] = {}
    checked = 0
    for k in recorded.sampled_cycles():
        cyc = recorded.cycles[k]
        if cyc.fingerprint not in recorded.snapshots:
            continue
        checked += 1
        parity = replay_cycle_parity(
            recorded, k, backend=backend, device=device
        )
        bad = {m["variant"] for m in parity["mismatches"]}
        for j, v in enumerate(cyc.variants):
            if v in bad:
                verdict[v] = "MISMATCH"
            elif str(cyc.columns["reason"][j]) in PARITY_SKIP_REASONS:
                verdict.setdefault(v, "skipped")
            elif verdict.get(v) != "MISMATCH":
                verdict[v] = "ok"
    return verdict, checked


def _fmt(v, width: int, digits: int = 2) -> str:
    if v is None:
        return "-".rjust(width)
    if isinstance(v, float):
        return f"{v:.{digits}f}".rjust(width)
    return str(v).rjust(width)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m inferno_tpu_torch.obs.report",
        description="Attainment / model-error scoreboard over a recorded "
                    "flight-recorder artifact",
    )
    ap.add_argument("dir", help="flight-recorder artifact directory "
                                "(FLIGHT_RECORDER_DIR of the recorded run)")
    ap.add_argument("--ewma-gain", type=float, default=0.2,
                    help="scoreboard EWMA gain (mirror the live "
                         "ATTAINMENT_EWMA_GAIN; default 0.2)")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "torch"),
                    help="compute backend for the parity replay")
    ap.add_argument("--device", default=None,
                    help="device the parity replay sizes on (default: the "
                         "CUDA card; 'cpu' with --backend torch)")
    ap.add_argument("--no-replay", action="store_true",
                    help="skip the solver parity replay (pure telemetry read)")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON document instead of the table")
    ap.add_argument("--top", type=int, default=0,
                    help="print only the N worst variants by burn rate "
                         "(0 = all)")
    args = ap.parse_args(argv)

    recorded = read_artifact(args.dir)
    for w in recorded.warnings:
        print(f"warning: {w}", file=sys.stderr)
    if not recorded.cycles:
        print(f"no recorded cycles in {args.dir!r}", file=sys.stderr)
        return 1

    rows = scoreboard_from_recorded(recorded, ewma_gain=args.ewma_gain)
    replay: dict[str, str] = {}
    parity_checked = 0
    if not args.no_replay:
        replay, parity_checked = replay_match_by_variant(
            recorded, backend=args.backend, device=args.device
        )
        if parity_checked == 0:
            # a requested parity pass that could not check ANYTHING (no
            # resolvable snapshots — damaged/rotated artifact) must fail
            # loudly, not exit 0 looking like a clean pass
            print(
                "error: replay parity requested but no sampled cycle has a "
                "resolvable fleet snapshot (damaged or rotated artifact); "
                "use --no-replay for a telemetry-only read",
                file=sys.stderr,
            )
            return 1
    for v, row in rows.items():
        row["replay"] = replay.get(v, "-")

    # worst burn first; burn ties broken by model error
    ordered = sorted(
        rows.items(),
        key=lambda kv: (-kv[1]["error_budget_burn"],
                        -kv[1]["itl_error_ewma_ms"], kv[0]),
    )
    if args.top > 0:
        ordered = ordered[: args.top]
    # one exit-code contract for BOTH output modes: parity mismatches
    # fail the run (CI pipelines branch on this, table or --json alike)
    mismatched = sum(1 for r in rows.values() if r["replay"] == "MISMATCH")

    # profile column: the recorded cycles' own cost
    # attribution, aggregated — None for pre-profiler artifacts
    profile = recorded.profile_summary()

    if args.json:
        print(json.dumps({
            "trace_dir": recorded.dir,
            "cycles": recorded.num_cycles,
            "ewma_gain": args.ewma_gain,
            "replay_mismatches": mismatched,
            "profile": profile,
            "variants": dict(ordered),
        }, indent=1))
        return 1 if mismatched else 0

    name_w = max([len("variant")] + [len(v) for v, _ in ordered])
    print(f"{recorded.num_cycles} recorded cycles, {len(rows)} variants "
          f"({recorded.dir}); ewma gain {args.ewma_gain}")
    if profile is not None:
        breakdown = " + ".join(
            f"{name} {ms:.1f}"
            for name, ms in profile["mean_phase_ms"].items()
        )
        print(
            f"recorded profile ({profile['cycles_profiled']} cycles): "
            f"mean cycle {profile['mean_cycle_ms']:.1f} ms"
            + (f" = {breakdown}" if breakdown else "")
        )
    print(
        f"{'variant'.ljust(name_w)}  {'cycles':>6}  {'mean_rpm':>9}  "
        f"{'att_ttft':>8}  {'att_itl':>8}  {'err_ttft_ms':>11}  "
        f"{'err_itl_ms':>10}  {'burn':>6}  replay"
    )
    for v, row in ordered:
        print(
            f"{v.ljust(name_w)}  {row['cycles']:>6}  "
            f"{_fmt(row['mean_rpm'], 9, 1)}  "
            f"{_fmt(row['ttft_attainment'], 8, 3)}  "
            f"{_fmt(row['itl_attainment'], 8, 3)}  "
            f"{_fmt(row['ttft_error_ewma_ms'], 11)}  "
            f"{_fmt(row['itl_error_ewma_ms'], 10)}  "
            f"{_fmt(row['error_budget_burn'], 6)}  {row['replay']}"
        )
    if mismatched:
        print(f"{mismatched} variant(s) FAILED replay parity", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
