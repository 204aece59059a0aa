"""Serial scalar oracle for the vectorized fleet twin.

Drives real `EmulatedEngine` instances — the semantic oracle — in their
synchronous deterministic stepping mode (`submit_at` / `step_sync` /
`advance_idle_to`, no threads, no sleeps, no wall reads) over the same
trace, barriers, and kill schedule as `TwinPlant`, and returns the same
columnar result vocabulary. tests/test_twin.py pins BIT-equality between
the two on the canonical scenarios; bench.py's `--twin` speedup claim
measures against this runner (one honest apples-to-apples baseline: the
identical discrete-event semantics, executed one engine at a time).

Port copy of `inferno_tpu/twin/oracle.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import numpy as np

from inferno_tpu_torch.emulator.engine import EmulatedEngine, EngineProfile


def _frozen_clock() -> float:
    """The engines never consult wall time in sync mode; a frozen clock
    keeps the run bit-deterministic whatever the host is doing."""
    return 0.0


def run_serial_oracle(
    profile: EngineProfile | list[EngineProfile],
    engine_of: np.ndarray,
    arr_ms: np.ndarray,
    in_tokens: np.ndarray,
    out_tokens: np.ndarray,
    end_ms: float,
    barrier_ms: float | None = None,
    kills: list[tuple[float, int]] | None = None,
) -> dict[str, np.ndarray]:
    """Run the trace through scalar engines, one at a time.

    `engine_of[k]` routes request k; arrivals must be nondecreasing per
    engine (the same FIFO contract `TwinPlant.inject_bulk` enforces).
    `kills` follows the spot injector contract: at each (t_s, count)
    the `count` lowest-index surviving engines are preempted, applied at
    the same virtual instants the twin applies them (kill times join the
    barrier walk). Returns columnar per-request outcomes matching
    `TwinPlant.results()`.
    """
    engine_of = np.asarray(engine_of, dtype=np.int64)
    arr_ms = np.asarray(arr_ms, dtype=np.float64)
    in_tokens = np.asarray(in_tokens, dtype=np.int64)
    out_tokens = np.asarray(out_tokens, dtype=np.int64)
    profiles = (
        [profile] * (int(engine_of.max()) + 1 if len(engine_of) else 1)
        if isinstance(profile, EngineProfile)
        else list(profile)
    )
    E = len(profiles)
    kills = sorted(kills or [])
    barrier = barrier_ms if barrier_ms is not None else end_ms
    n = len(arr_ms)

    # per-engine request index lists, in arrival order
    order = np.argsort(arr_ms, kind="stable")
    per_engine: list[list[int]] = [[] for _ in range(E)]
    for k in order:
        per_engine[int(engine_of[k])].append(int(k))

    state = np.zeros(n, dtype=np.int8)  # QUEUED/RUNNING/DONE/REJECTED
    eff = arr_ms.copy()
    first = np.full(n, np.nan)
    finish = np.full(n, np.nan)

    engines = [
        EmulatedEngine(p, time_scale=1.0, clock=_frozen_clock)
        for p in profiles
    ]
    cursor = [0] * E  # next-unsubmitted index into per_engine[e]
    reqs: dict[int, object] = {}  # request index -> _Request

    def _submit_ready(e: int) -> None:
        """Make every arrival that has occurred by the engine clock
        visible in its waiting deque (what wall time does for the
        threaded engine)."""
        eng, lst = engines[e], per_engine[e]
        while cursor[e] < len(lst):
            k = lst[cursor[e]]
            if arr_ms[k] > eng.emu_ms:
                break
            cursor[e] += 1
            req = eng.submit_at(
                int(in_tokens[k]), int(out_tokens[k]), float(arr_ms[k])
            )
            reqs[k] = req
            if req.rejected:
                state[k] = 3

    def _advance_engine(e: int, t: float) -> None:
        """Whole decode iterations until the engine clock reaches the
        barrier — the same runnable rule as `TwinPlant._runnable`, so
        the two sides take identical step sequences."""
        eng, lst = engines[e], per_engine[e]
        while True:
            _submit_ready(e)
            if eng.num_running == 0 and eng.num_waiting == 0:
                # idle: jump across the gap to the next arrival, if it
                # lands inside this window
                if cursor[e] < len(lst) and arr_ms[lst[cursor[e]]] <= t:
                    eng.advance_idle_to(float(arr_ms[lst[cursor[e]]]))
                    continue
                return
            if eng.num_running > 0 and eng.emu_ms >= t:
                return  # whole steps only; the last one may overshoot
            eng.step_sync()

    # barrier walk, kill times joining the edge set
    edges: list[float] = []
    t = barrier
    while t < end_ms - 1e-9:
        edges.append(t)
        t += barrier
    edges.append(end_ms)
    all_edges = sorted(set(edges) | {kt * 1000.0 for kt, _ in kills})

    killed: set[int] = set()
    ki = 0
    for t in all_edges:
        for e in range(E):
            if e not in killed:
                _advance_engine(e, t)
        while ki < len(kills) and kills[ki][0] * 1000.0 <= t + 1e-9:
            count = kills[ki][1]
            for e in range(E):  # lowest surviving index first
                if count == 0:
                    break
                if e in killed:
                    continue
                engines[e].preempt()
                killed.add(e)
                count -= 1
            ki += 1

    # read stamps back off the captured request objects
    for k, req in reqs.items():
        if req.rejected:
            state[k] = 3
            continue
        eff[k] = req.arrived_emu
        if req.finished_at is not None:
            state[k] = 2
            first[k] = req.first_token_emu
            finish[k] = req.finished_emu
        elif req.prefilled or any(
            r is req
            for r in engines[int(engine_of[k])].running.values()
        ):
            state[k] = 1
    # future arrivals to killed engines that were never submitted: the
    # twin rejects the whole queue at kill time; match that outcome
    for e in killed:
        for k in per_engine[e][cursor[e]:]:
            state[k] = 3

    return {
        "engine": engine_of,
        "state": state,
        "in_tokens": in_tokens,
        "out_tokens": np.maximum(out_tokens, 1),
        "arrived_ms": arr_ms,
        "ttft_emu_ms": first - eff,
        "latency_emu_ms": finish - eff,
    }


def parity_diff(
    twin: dict[str, np.ndarray], oracle: dict[str, np.ndarray]
) -> list[str]:
    """Differences between a twin `results()` dict and the oracle's —
    empty means BIT-identical outcomes. Compares completion states,
    rejections, and exact TTFT/latency on completed requests."""
    diffs: list[str] = []
    if len(twin["state"]) != len(oracle["state"]):
        return [
            f"request count: twin {len(twin['state'])} vs "
            f"oracle {len(oracle['state'])}"
        ]
    t_done = twin["state"] == 2
    o_done = oracle["state"] == 2
    if not np.array_equal(t_done, o_done):
        k = int(np.flatnonzero(t_done != o_done)[0])
        diffs.append(
            f"completion mask differs first at request {k}: "
            f"twin state {int(twin['state'][k])} vs "
            f"oracle {int(oracle['state'][k])}"
        )
    if not np.array_equal(twin["state"] == 3, oracle["state"] == 3):
        k = int(
            np.flatnonzero((twin["state"] == 3) != (oracle["state"] == 3))[0]
        )
        diffs.append(f"rejection mask differs first at request {k}")
    both = t_done & o_done
    for field in ("ttft_emu_ms", "latency_emu_ms"):
        tv, ov = twin[field][both], oracle[field][both]
        if not np.array_equal(tv, ov):
            k = int(np.flatnonzero(tv != ov)[0])
            diffs.append(
                f"{field} diverges at completed request {k}: "
                f"twin {tv[k]!r} vs oracle {ov[k]!r} "
                f"(delta {tv[k] - ov[k]:.3e})"
            )
    return diffs
