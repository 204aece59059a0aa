"""Replay a flight-recorder artifact through the fleet twin.

A recorded trace carries, per reconcile cycle, the fleet's observed
arrival rate (`arrival_rpm`), token mix (`avg_in_tokens` /
`avg_out_tokens`), and the fitted latency profile
(`decode_alpha`/`decode_beta`/`prefill_gamma`/`prefill_delta`). This
module turns that into a request-level `TwinTrace` — a seeded
nonhomogeneous Poisson process whose piecewise rate follows the recorded
cycles — and drives a `TwinPlant` fleet with it, so an incident captured
in production can be re-run at request granularity against any engine
count or policy ("what if we'd had 2x the pool when that burst hit?").

The rate schedule is exact (cycle-by-cycle); the request stream is a
seeded STATISTICAL realization of it — the recorder stores windowed
aggregates, not individual requests, so same artifact + same seed gives
a bit-reproducible replay, different seeds give fresh draws from the
same recorded load shape.

Port copy of `inferno_tpu/twin/replay.py`, verbatim apart from its imports
and the `backend`/`device` arguments `replay_artifact` passes on to
`TwinPlant`.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from inferno_tpu_torch.emulator.engine import EngineProfile
from inferno_tpu_torch.emulator.loadgen import RateSpec, TokenDistribution
from inferno_tpu_torch.obs.recorder import RecordedTrace, read_artifact
from inferno_tpu_torch.twin.plant import TwinPlant
from inferno_tpu_torch.twin.traces import TwinTrace, _poisson_arrivals, _tokens


def recorded_rate_schedule(
    rec: RecordedTrace, variant: str | None = None
) -> tuple[RateSpec, float]:
    """(piecewise rate schedule in req/s, total duration s) from the
    recorded cycles — one phase per cycle at its `arrival_rpm`, summed
    across variants unless one is named."""
    variants = rec.variant_ids()
    if variant is not None:
        if variant not in variants:
            raise ValueError(
                f"variant {variant!r} not in artifact (has {variants})"
            )
        variants = [variant]
    rpm, present = rec.column_matrix("arrival_rpm", variants)
    step = rec.step_seconds()
    phases = tuple(
        (step, float(np.where(present[t], rpm[t], 0.0).sum()) / 60.0)
        for t in range(rpm.shape[0])
    )
    return RateSpec(phases), step * rpm.shape[0]


def recorded_profile(
    rec: RecordedTrace, variant: str | None = None
) -> EngineProfile:
    """EngineProfile from the artifact's fitted latency columns (first
    cycle where the variant is present; zeros fall back to defaults —
    pre-fit cycles record 0.0)."""
    variants = rec.variant_ids()
    cols = {
        f: rec.column_matrix(f, variants)
        for f in ("decode_alpha", "decode_beta", "prefill_gamma",
                  "prefill_delta")
    }
    pick = {}
    for f, (mat, present) in cols.items():
        vals = mat[present & (mat > 0)]
        pick[f] = float(vals[0]) if len(vals) else 0.0
    base = EngineProfile()
    return EngineProfile(
        alpha=pick["decode_alpha"] or base.alpha,
        beta=pick["decode_beta"] or base.beta,
        gamma=pick["prefill_gamma"] or base.gamma,
        delta=pick["prefill_delta"] or base.delta,
    )


def trace_from_artifact(
    rec: RecordedTrace,
    variant: str | None = None,
    seed: int = 0,
    rate_scale: float = 1.0,
) -> TwinTrace:
    """Seeded request-level realization of the recorded load shape."""
    schedule, duration_s = recorded_rate_schedule(rec, variant)
    if rate_scale != 1.0:
        schedule = RateSpec(
            tuple((d, r * rate_scale) for d, r in schedule.phases)
        )
    rng = np.random.default_rng(seed)
    arr = _poisson_arrivals(rng, schedule, duration_s)
    # token mix around the recorded means (medians of the lognormals;
    # the modest sigma keeps the mix realistic without inventing a tail
    # the recorder never saw)
    variants = rec.variant_ids() if variant is None else [variant]
    in_mat, in_p = rec.column_matrix("avg_in_tokens", variants)
    out_mat, out_p = rec.column_matrix("avg_out_tokens", variants)
    med_in = float(in_mat[in_p & (in_mat > 0)].mean()) if in_p.any() else 0.0
    med_out = (
        float(out_mat[out_p & (out_mat > 0)].mean()) if out_p.any() else 0.0
    )
    i, o = _tokens(
        rng, len(arr),
        TokenDistribution(median=med_in or 160.0, sigma=0.5,
                          max_tokens=int(max(4 * (med_in or 160.0), 64))),
        TokenDistribution(median=med_out or 120.0, sigma=0.5,
                          max_tokens=int(max(4 * (med_out or 120.0), 64))),
    )
    return TwinTrace("replay", seed, duration_s, arr, i, o)


def replay_artifact(
    artifact: str | RecordedTrace,
    engines: int = 8,
    seed: int = 0,
    variant: str | None = None,
    rate_scale: float = 1.0,
    profile: EngineProfile | None = None,
    backend: str | None = None,
    device=None,
) -> dict[str, Any]:
    """Replay the artifact's load shape through a TwinPlant fleet and
    return the plant report plus replay provenance. `backend`/`device`
    choose where the plant's step cost runs (`TwinPlant`)."""
    rec = read_artifact(artifact) if isinstance(artifact, str) else artifact
    trace = trace_from_artifact(rec, variant, seed, rate_scale)
    prof = profile if profile is not None else recorded_profile(rec, variant)
    plant = TwinPlant(prof, engines, backend=backend, device=device)
    eng = (
        np.arange(trace.requests, dtype=np.int64) % engines
        if trace.requests else np.zeros(0, dtype=np.int64)
    )
    plant.inject_bulk(eng, trace.arr_ms, trace.in_tokens, trace.out_tokens)
    step = rec.step_seconds()
    t = 0.0
    while t < trace.duration_s - 1e-9:
        t = min(t + step, trace.duration_s)
        plant.advance_to(t * 1000.0)
    plant.drain_completions()
    rep = plant.report()
    rep["replay"] = {
        "artifact_cycles": rec.num_cycles,
        "variant": variant or "all",
        "seed": seed,
        "rate_scale": rate_scale,
        "duration_s": round(trace.duration_s, 3),
        "offered_rps": round(trace.offered_rps(), 4),
        "profile": {
            "alpha": prof.alpha, "beta": prof.beta,
            "gamma": prof.gamma, "delta": prof.delta,
        },
    }
    return rep
