"""Planner CLI: replay traffic scenarios over a synthetic fleet and
print the capacity report as one JSON document.

Examples::

    # a week of hourly steps, all scenarios, 200-variant fleet
    python -m inferno_tpu_torch.planner --variants 200

    # binding pools: budgets at 80% of the base-load consumption, plus a
    # regional quota carve-out, diurnal + flash crowds only
    python -m inferno_tpu_torch.planner --variants 500 --capacity-fraction 0.8 \
        --quotas '{"gen0/r0": 512}' --scenarios diurnal,flash_crowd

    # reactive vs forecast-bound sizing side by side
    python -m inferno_tpu_torch.planner --variants 100 --steps 48 --forecast

    # replay a RECORDED production trace (flight-recorder artifact,
    # env FLIGHT_RECORDER_DIR on the live controller) instead of
    # synthetic generators; --forecast works over the real history too
    python -m inferno_tpu_torch.planner --trace /var/lib/inferno/recorder

    # Monte Carlo: 200 seeded replays per scenario folded into
    # percentile envelopes; exit non-zero unless every configured
    # bucket survives 99% of seeds without binding — the one-command
    # "do we have enough reserved quota" answer
    python -m inferno_tpu_torch.planner --variants 500 --capacity-fraction 0.9 \
        --scenarios flash_crowd --seeds 200 --survival-percentile 99

    # on a machine without a card: the plain torch path on the CPU, or
    # the C++ solver (needs g++)
    python -m inferno_tpu_torch.planner --backend torch --device cpu
    python -m inferno_tpu_torch.planner --backend native

Port of `inferno_tpu/planner/__main__.py`, verbatim apart from its
imports and the backend: `--backend` is auto|cuda|torch|native and
`--device` the device the fleet is sized on (default: the CUDA card;
ignored by `native`, the C++ solver on the host). `auto` (and
PLANNER_BACKEND=auto) resolves to `cuda` when a card is present and
raises otherwise; nothing falls back to the CPU unless asked.
"""

from __future__ import annotations

import argparse
import json
import sys


_BACKENDS = ("auto", "cuda", "torch", "native")


def _resolve_backend(requested: str) -> str:
    if requested != "auto":
        return requested
    from inferno_tpu_torch.config.defaults import env_str

    env = env_str("PLANNER_BACKEND").strip()
    if env and env != "auto":
        # the env route must fail as fast as the validated CLI flag — an
        # unknown string would otherwise silently run the default while
        # the report claims the misspelled backend ran
        if env not in _BACKENDS:
            raise SystemExit(
                f"PLANNER_BACKEND={env!r} is not one of {_BACKENDS}"
            )
        return env
    import torch

    if torch.cuda.is_available():
        return "cuda"
    raise SystemExit(
        "--backend auto found no CUDA device; pass --backend torch "
        "--device cpu to plan on the CPU"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m inferno_tpu_torch.planner",
        description="Offline fleet capacity planner: batched scenario replay",
    )
    ap.add_argument("--trace", default="",
                    help="replay a RECORDED flight-recorder artifact "
                         "(obs/recorder.py directory) instead of synthetic "
                         "scenarios; the fleet is reconstructed from the "
                         "recording's own snapshot and drift/parity are "
                         "reported (docs/observability.md)")
    ap.add_argument("--trace-rate-field", default="sizing_rpm",
                    choices=("sizing_rpm", "arrival_rpm"),
                    help="which recorded per-variant rate drives the "
                         "replay: the rate sizing actually ran against "
                         "(default) or the raw observed arrival rate")
    ap.add_argument("--variants", type=int, default=200,
                    help="synthetic fleet size (testing.fleet.fleet_system_spec)")
    ap.add_argument("--shapes", type=int, default=2,
                    help="candidate slice shapes per variant")
    ap.add_argument("--steps", type=int, default=168,
                    help="timesteps to replay (default: a week of hours)")
    ap.add_argument("--step-seconds", type=float, default=3600.0,
                    help="seconds per timestep")
    ap.add_argument("--scenarios", default="",
                    help="comma-separated scenario names (default: all); "
                         "available: diurnal, ramp, flash_crowd, launch, "
                         "regional_skew")
    ap.add_argument("--seed", type=int, default=0,
                    help="base seed; each scenario adds its fixed offset "
                         "(its position in planner.scenarios.GENERATORS), "
                         "so a scenario's trace is the same whether it "
                         "runs alone or with others")
    ap.add_argument("--capacity-fraction", type=float, default=None,
                    help="set per-pool chip budgets to this fraction of the "
                         "base-load unconstrained consumption (enables "
                         "first-bind / violation reporting)")
    ap.add_argument("--quotas", default="",
                    help='quota buckets as JSON, TPU_POOL_QUOTAS syntax: '
                         '{"pool": chips, "pool/region": chips}')
    ap.add_argument("--backend", default="auto", choices=_BACKENDS,
                    help="compute backend (auto: cuda when a card is "
                         "present, else an error; PLANNER_BACKEND env "
                         "overrides auto)")
    ap.add_argument("--device", default=None,
                    help="device the fleet is sized on (default: the CUDA "
                         "card; 'cpu' with --backend torch)")
    ap.add_argument("--chunk-steps", type=int, default=None,
                    help="timesteps per replay slab (default auto; "
                         "PLANNER_CHUNK_STEPS env)")
    ap.add_argument("--seeds", type=int, default=None,
                    help="Monte Carlo mode: replay this many seeded "
                         "ensemble members per scenario (streamed through "
                         "ONE prepared solve context) and report "
                         "p50/p95/p99/max envelopes instead of a single "
                         "replay (default: env PLANNER_SEEDS, else off; "
                         "seed derivation: scenarios.ensemble_seeds)")
    ap.add_argument("--survival-percentile", type=float, default=None,
                    help="with --seeds: exit non-zero (3) unless every "
                         "CONFIGURED pool/quota budget survives this "
                         "percentage of seeds without binding — the "
                         "reserved-quota gate (e.g. 99 = a 99%% winter "
                         "peak must fit)")
    ap.add_argument("--forecast", action="store_true",
                    help="add the forecast-bound sizing pass per scenario")
    ap.add_argument("--forecast-horizon-s", type=float, default=None,
                    help="forecast horizon (default: one step)")
    ap.add_argument("--skew", action="store_true",
                    help="apply a seeded per-variant base-rate skew before "
                         "replay (testing.fleet.perturb_loads rng mode)")
    ap.add_argument("--series", action="store_true",
                    help="include full per-bucket demand/cost time series "
                         "in the report (large)")
    ap.add_argument("--out", default="",
                    help="write the JSON report here instead of stdout")
    args = ap.parse_args(argv)

    if args.seeds is None:
        from inferno_tpu_torch.config.defaults import env_str

        env = env_str("PLANNER_SEEDS").strip()
        try:
            args.seeds = int(env) if env else 0
        except ValueError:
            raise SystemExit(f"PLANNER_SEEDS={env!r} is not an integer")
    if args.seeds < 0:
        # a negative count must not silently degrade to the single-replay
        # path — the user asked for an ensemble and would get none
        raise SystemExit("--seeds / PLANNER_SEEDS must be >= 0, "
                         f"got {args.seeds}")
    if args.survival_percentile is not None:
        if args.seeds <= 0:
            raise SystemExit("--survival-percentile needs --seeds N (or "
                             "PLANNER_SEEDS) — the gate is a fraction of "
                             "seeds, there is nothing to gate on a single "
                             "replay")
        if not 0.0 < args.survival_percentile <= 100.0:
            raise SystemExit("--survival-percentile must be in (0, 100]")
    if args.seeds > 0 and args.trace:
        raise SystemExit("--seeds replays a synthetic scenario ensemble; "
                         "a recorded --trace has no seed axis")
    if args.seeds > 0 and args.forecast:
        raise SystemExit("--forecast is not supported with --seeds yet: "
                         "the forecast filter is O(T x S) Python per "
                         "member and would dominate the ensemble")

    if args.trace:
        return _replay_trace(args)

    import numpy as np

    from inferno_tpu_torch.core import System
    from inferno_tpu_torch.config.types import CapacitySpec
    from inferno_tpu_torch.planner.replay import replay_scenario
    from inferno_tpu_torch.planner.scenarios import base_rates_from_system, build_scenarios
    from inferno_tpu_torch.testing.fleet import (
        fleet_capacity,
        fleet_system_spec,
        perturb_loads,
    )

    backend = _resolve_backend(args.backend)
    device = args.device
    spec = fleet_system_spec(
        args.variants, shapes_per_variant=args.shapes,
        priority_classes=3, split_pools=True,
    )
    quotas = json.loads(args.quotas) if args.quotas else {}
    if args.capacity_fraction is not None:
        chips = fleet_capacity(
            spec, args.capacity_fraction, backend=backend, device=device
        )
        spec.capacity = CapacitySpec(
            chips=chips, quotas={k: int(v) for k, v in quotas.items()}
        )
    elif quotas:
        spec.capacity = CapacitySpec(
            chips=dict(spec.capacity.chips),
            quotas={k: int(v) for k, v in quotas.items()},
        )
    system = System(spec)
    if args.skew:
        perturb_loads(system, scale=1.0, rng=np.random.default_rng(args.seed))
    base = base_rates_from_system(system)

    names = [s.strip() for s in args.scenarios.split(",") if s.strip()]
    fleet_block = {
        "variants": args.variants,
        "shapes_per_variant": args.shapes,
        "seed": args.seed,
        "backend": backend,
        "device": device,
        "capacity_chips": dict(system.capacity),
        "quotas": dict(system.quotas),
        "base_rate_total_rpm": float(base.sum()),
    }
    if args.seeds > 0:
        # Monte Carlo mode: per scenario, an S-member seeded ensemble
        # streamed through one prepared solve context, folded into
        # percentile envelopes (planner/montecarlo.py)
        from inferno_tpu_torch.planner.montecarlo import (
            replay_montecarlo,
            survival_failures,
        )
        from inferno_tpu_torch.planner.scenarios import GENERATORS

        picked = names or list(GENERATORS)
        unknown = [n for n in picked if n not in GENERATORS]
        if unknown:
            raise SystemExit(
                f"unknown scenario(s) {unknown}; "
                f"available: {sorted(GENERATORS)}"
            )
        scenarios = [
            replay_montecarlo(
                system, name, args.steps, args.step_seconds,
                seeds=args.seeds, base_seed=args.seed, backend=backend,
                device=device, chunk_steps=args.chunk_steps, include_series=args.series,
            )
            for name in picked
        ]
        report = {
            "fleet": fleet_block,
            "steps": args.steps,
            "step_seconds": args.step_seconds,
            "seeds": args.seeds,
            "scenarios": scenarios,
        }
        failures = []
        if args.survival_percentile is not None:
            for block in scenarios:
                for f in survival_failures(block, args.survival_percentile):
                    failures.append({"scenario": block["scenario"], **f})
            report["survival_gate"] = {
                "percentile": args.survival_percentile,
                "failures": failures,
                "pass": not failures,
            }
    else:
        traces = build_scenarios(
            names, base, args.steps, args.step_seconds, seed=args.seed
        )
        failures = []
        report = {
            "fleet": fleet_block,
            "steps": args.steps,
            "step_seconds": args.step_seconds,
            "scenarios": [
                replay_scenario(
                    system, trace,
                    backend=backend,
                    device=device,
                    chunk_steps=args.chunk_steps,
                    include_series=args.series,
                    forecast=args.forecast,
                    forecast_horizon_s=args.forecast_horizon_s,
                )
                for trace in traces
            ],
        }
    text = json.dumps(report, indent=1)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        print(text)
    if failures:
        for f in failures:
            print(
                f"survival gate FAILED: {f['kind'][:-1]} {f['bucket']!r} "
                f"({f['scenario']}) survives only "
                f"{f['survival_fraction'] * 100.0:.1f}% of seeds "
                f"(required {args.survival_percentile}%); p99 peak "
                f"{f['p99_peak_chips']:.0f} chips vs budget "
                f"{f['budget_chips']:.0f}",
                file=sys.stderr,
            )
        return 3
    return 0


def _replay_trace(args) -> int:
    """--trace mode: recorded-artifact replay. The fleet System is reconstructed from the
    recording's latest snapshot; drift names variants added/removed
    relative to it, and choice/replica parity is checked at sampled
    cycles (first / middle / last)."""
    from inferno_tpu_torch.obs.recorder import read_artifact
    from inferno_tpu_torch.planner.replay import (
        replay_cycle_parity,
        replay_recorded,
        system_from_recorded,
    )

    backend = _resolve_backend(args.backend)
    device = args.device
    recorded = read_artifact(args.trace)
    if not recorded.cycles:
        raise SystemExit(f"no recorded cycles in {args.trace!r}")
    # anchor the replay fleet on the NEWEST cycle whose snapshot
    # resolves — a damaged/rotated artifact can carry cycles whose
    # fingerprint resolves nowhere (the same state the parity loop below
    # reports as skip_reason), and that must degrade, not KeyError
    anchor = next(
        (k for k in range(recorded.num_cycles - 1, -1, -1)
         if recorded.cycles[k].fingerprint in recorded.snapshots),
        None,
    )
    if anchor is None:
        raise SystemExit(
            f"{args.trace!r} carries no resolvable fleet snapshot; cannot "
            "reconstruct a System to replay against"
        )
    system = system_from_recorded(recorded, anchor)
    # T=1 parity at sampled cycles, each against its OWN snapshot; a
    # sample whose snapshot was lost (rotated away, damaged) is reported
    # as skipped — an empty or partial parity list must never read as a
    # vacuous clean pass
    parity_sampled = []
    for k in recorded.sampled_cycles():
        if recorded.cycles[k].fingerprint in recorded.snapshots:
            parity_sampled.append(
                replay_cycle_parity(
                    recorded, k, backend=backend, device=device
                )
            )
        else:
            parity_sampled.append({
                "cycle_index": k,
                "skip_reason": "snapshot unavailable (rotated away or damaged)",
                "match": None,
            })
    report = {
        "trace_dir": recorded.dir,
        "schema_version": recorded.schema_version,
        "read_warnings": list(recorded.warnings),
        "fleet": {
            "variants": len(system.servers),
            "backend": backend,
            "device": device,
            "capacity_chips": dict(system.capacity),
            "quotas": dict(system.quotas),
            "snapshot_fingerprint": recorded.cycles[anchor].fingerprint,
            "snapshot_cycle_index": anchor,
            "snapshots": len(recorded.snapshots),
        },
        "steps": recorded.num_cycles,
        "step_seconds": recorded.step_seconds(),
        "recorded": replay_recorded(
            system, recorded,
            backend=backend,
            device=device,
            rate_field=args.trace_rate_field,
            chunk_steps=args.chunk_steps,
            include_series=args.series,
            forecast=args.forecast,
            forecast_horizon_s=args.forecast_horizon_s,
        ),
        "parity_sampled": parity_sampled,
    }
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
