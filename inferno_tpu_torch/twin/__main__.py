"""Fleet-twin CLI: closed-loop policy A/B at fleet scale, one JSON
report.

Examples::

    # the headline: two solver policies through the same seeded burst
    # trace against 1000 emulated engines, scored on SLO-violation
    # seconds and provisioned cost
    python -m inferno_tpu_torch.twin --policies reactive,predictive --engines 1000

    # spot-storm overlay (spot injector contract): 5%% of the pool dies
    # at t=30s, another 3%% at t=45s
    python -m inferno_tpu_torch.twin --engines 200 --kills 30:10,45:6

    # an agentic-session trace with grown multi-turn context
    python -m inferno_tpu_torch.twin --trace agentic --duration 120 --seed 7

    # on the CPU instead of the card, or on the host's numpy path
    python -m inferno_tpu_torch.twin --engines 8 --duration 10 --backend torch --device cpu
    python -m inferno_tpu_torch.twin --engines 8 --duration 10 --backend numpy

    # replay a recorded flight-recorder artifact through the twin fleet
    python -m inferno_tpu_torch.twin --replay /var/lib/inferno/recorder --engines 64

Port copy of `inferno_tpu/twin/__main__.py`, verbatim apart from its
imports and three options: `--backend`/`--device` choose where the
plant's step cost runs (the CUDA card by default), and `--variant` replays
one variant of a recorded artifact.
"""

from __future__ import annotations

import argparse
import json
import sys


def _parse_kills(text: str) -> tuple[tuple[float, int], ...]:
    """"30:10,45:6" -> ((30.0, 10), (45.0, 6))."""
    kills = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            t_s, count = part.split(":")
            kills.append((float(t_s), int(count)))
        except ValueError:
            raise SystemExit(
                f"--kills entry {part!r} is not t_seconds:count"
            )
    return tuple(sorted(kills))


def main(argv=None) -> int:
    from inferno_tpu_torch.config.defaults import env_int
    from inferno_tpu_torch.twin.plant import BACKENDS, resolve_backend, twin_device
    from inferno_tpu_torch.twin.traces import TRACES

    ap = argparse.ArgumentParser(
        prog="python -m inferno_tpu_torch.twin",
        description="Vectorized fleet twin: closed-loop policy A/B over "
                    "thousands of emulated engines in one event loop",
    )
    ap.add_argument("--engines", type=int, default=None,
                    help="emulated engine pool size (default: env "
                         "TWIN_ENGINES, else 1000)")
    ap.add_argument("--policies", default="reactive,predictive",
                    help="comma-separated policies to A/B on the same "
                         "seeded trace (reactive, predictive); one name "
                         "runs a single closed loop")
    ap.add_argument("--trace", default="ramp_burst",
                    choices=sorted(TRACES),
                    help="trace generator (twin/traces.py)")
    ap.add_argument("--duration", type=float, default=92.0,
                    help="trace duration, seconds of emulated time "
                         "(default: the canonical 92 s burst schedule)")
    ap.add_argument("--rate", type=float, default=None,
                    help="base (1x) fleet arrival rate, req/s (default: "
                         "sized so the 9x burst peak approaches the full "
                         "pool's sustainable ceiling)")
    ap.add_argument("--seed", type=int, default=0,
                    help="trace seed (fixed-generator-index "
                         "derivation; same seed => bit-identical report)")
    ap.add_argument("--slo-ttft-ms", type=float, default=2000.0,
                    help="TTFT SLO gating violation-seconds")
    ap.add_argument("--spinup", type=float, default=4.0,
                    help="replica spin-up latency, seconds")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="control interval, seconds")
    ap.add_argument("--kills", default="",
                    help="spot-storm schedule t_seconds:count[,...] — at "
                         "each instant the count lowest-index surviving "
                         "engines are preempted (the spot injector contract)")
    ap.add_argument("--replay", default="",
                    help="replay a flight-recorder artifact directory "
                         "through the twin fleet instead of a synthetic "
                         "trace (twin/replay.py)")
    ap.add_argument("--variant", default=None,
                    help="with --replay: replay this variant's recorded "
                         "load only (default: every variant's, summed)")
    ap.add_argument("--backend", default=None, choices=BACKENDS,
                    help="where the plant's step cost runs: torch (on "
                         "--device) or numpy (the host); default: env "
                         "TWIN_BACKEND, else torch")
    ap.add_argument("--device", default=None,
                    help="torch device of the step cost (default: the "
                         "CUDA card; cpu runs it on the CPU)")
    ap.add_argument("--out", default="",
                    help="write the JSON report here instead of stdout")
    args = ap.parse_args(argv)

    engines = (
        args.engines
        if args.engines is not None
        else (env_int("TWIN_ENGINES", 1000))
    )
    if engines <= 0:
        raise SystemExit(f"--engines / TWIN_ENGINES must be > 0, got {engines}")
    # fail before any trace is built: an unknown TWIN_BACKEND, or the
    # default torch backend on a machine without a card
    backend = resolve_backend(args.backend)
    device = twin_device(args.device) if backend == "torch" else None

    if args.replay:
        from inferno_tpu_torch.twin.replay import replay_artifact

        report = replay_artifact(args.replay, engines=engines, seed=args.seed,
                                 variant=args.variant, backend=backend,
                                 device=device)
    else:
        from inferno_tpu_torch.twin.abtest import (
            POLICIES,
            TwinABScenario,
            run_twin_ab,
        )

        policies = tuple(
            p.strip() for p in args.policies.split(",") if p.strip()
        )
        unknown = [p for p in policies if p not in POLICIES]
        if unknown:
            raise SystemExit(
                f"unknown policy(ies) {unknown}; available: {list(POLICIES)}"
            )
        if not policies:
            raise SystemExit("--policies must name at least one policy")
        scenario = TwinABScenario(
            engines=engines,
            trace=args.trace,
            rate_rps=args.rate,
            duration_s=args.duration,
            seed=args.seed,
            control_interval_s=args.interval,
            spinup_s=args.spinup,
            slo_ttft_ms=args.slo_ttft_ms,
            kills=_parse_kills(args.kills),
        )
        report = run_twin_ab(scenario, policies, backend=backend, device=device)

    text = json.dumps(report, indent=1)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
