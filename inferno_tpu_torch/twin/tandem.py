"""Deterministic virtual-clock sim of one disaggregated tandem unit.

`emulator.disagg.DisaggEngine` runs its prefill/decode pools on threads
whose virtual clock DIVIDES WALL TIME — host scheduling noise lands
directly in the emulated latencies, which is exactly why its closed-loop
analyzer test sat in the slow tier. This module
re-expresses the same tandem semantics as a discrete-event simulation on
accumulated virtual clocks, so the disagg modeled-vs-works check runs in
the fast tier bit-deterministically:

* prefill pool — each of `prefill_engines` takes a fresh batch (up to
  `prefill_max_batch`) of arrived prompts per iteration; the iteration
  costs gamma + delta * max_in * batch and stamps every prompt's TTFT at
  its end (JetStream semantics: BEFORE the KV transfer);
* KV transfer — prefilled requests become decode-admissible
  `kv_transfer_ms` after their prefill iteration ends; the handoff queue
  is kept sorted by ready time (disagg.py r4 advisor);
* decode pool — each of `decode_engines` admits ready requests under
  reservation KV (in + out against its own `kv_tokens_capacity`, FIFO
  break, matching engine._admit), then steps alpha + beta * batch,
  one token per request per step, finishing at out_tokens.

Over-length requests (in + out > kv_tokens_capacity) are rejected at
submit, as `DisaggEngine.submit` does. One request with out_tokens == 1
finishes at prefill completion (tokens_done starts at 1).

This is a STATISTICAL twin of the threaded engine — same queueing
structure and step costs, so means/tails match the tandem analyzer the
same way — not a bit-parity oracle pair (that contract belongs to the
aggregated TwinPlant/EmulatedEngine pair in plant.py/oracle.py, where
the threaded engine has a synchronous stepping mode to pin against).

Port copy of `inferno_tpu/twin/tandem.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import bisect
from typing import Any

import numpy as np

from inferno_tpu_torch.emulator.disagg import DisaggProfile

QUEUED, RUNNING, DONE, REJECTED = 0, 1, 2, 3


def run_tandem(
    profile: DisaggProfile,
    arr_ms: np.ndarray,
    in_tokens: np.ndarray,
    out_tokens: np.ndarray,
) -> dict[str, Any]:
    """Run one tandem replica unit over a request trace; returns the
    twin's columnar result vocabulary (`TwinPlant.results()` keys)."""
    p = profile
    arr = np.asarray(arr_ms, dtype=np.float64)
    itok = np.asarray(in_tokens, dtype=np.int64)
    otok = np.maximum(np.asarray(out_tokens, dtype=np.int64), 1)
    n = len(arr)
    state = np.zeros(n, dtype=np.int8)
    first = np.full(n, np.nan)
    finish = np.full(n, np.nan)
    tokens_done = np.zeros(n, dtype=np.int64)

    # submit-time rejection: a footprint that can never fit an empty
    # decode engine would head-of-line-block the FIFO admission forever
    overlong = itok + otok > p.kv_tokens_capacity
    state[overlong] = REJECTED

    order = np.argsort(arr, kind="stable")
    queue = [int(k) for k in order if not overlong[k]]  # arrival FIFO
    qh = 0  # next unclaimed prompt
    nq = len(queue)

    pc = [0.0] * p.prefill_engines  # prefill engine clocks, emu msec
    dc = [0.0] * p.decode_engines  # decode engine clocks
    # (ready_ms, seq, request) sorted by ready time; seq breaks ties
    # deterministically in prefill-completion order
    decode_waiting: list[tuple[float, int, int]] = []
    seq = 0
    running: list[list[int]] = [[] for _ in range(p.decode_engines)]
    remaining = nq

    while remaining > 0:
        # the engine (either pool) whose next action lands earliest acts;
        # ties break prefill-first then lowest index — any fixed order
        # works, this one is pinned for determinism
        best: tuple[float, int, int] | None = None
        if qh < nq:
            for i in range(p.prefill_engines):
                t = max(pc[i], arr[queue[qh]])
                cand = (t, 0, i)
                if best is None or cand < best:
                    best = cand
        for j in range(p.decode_engines):
            if running[j]:
                cand = (dc[j], 1, j)
            elif decode_waiting:
                cand = (max(dc[j], decode_waiting[0][0]), 1, j)
            else:
                continue
            if best is None or cand < best:
                best = cand
        if best is None:
            break  # nothing in flight and no prompts left
        t, pool, i = best

        if pool == 0:
            # one prefill iteration: fresh batch of arrived prompts
            pc[i] = t
            batch: list[int] = []
            while (
                qh < nq
                and len(batch) < p.prefill_max_batch
                and arr[queue[qh]] <= pc[i]
            ):
                batch.append(queue[qh])
                qh += 1
            max_in = max(int(itok[k]) for k in batch)
            pc[i] += p.gamma + p.delta * max_in * len(batch)
            ready = pc[i] + p.kv_transfer_ms
            for k in batch:
                first[k] = pc[i]
                tokens_done[k] = 1
                if tokens_done[k] >= otok[k]:
                    state[k] = DONE
                    finish[k] = pc[i]
                    remaining -= 1
                else:
                    state[k] = RUNNING
                    bisect.insort(decode_waiting, (ready, seq, k))
                    seq += 1
        else:
            # decode engine i: admit transferred requests (reservation
            # KV, ready-order FIFO), then one generation step
            dc[i] = max(dc[i], t)
            kv_used = sum(int(itok[k] + otok[k]) for k in running[i])
            while decode_waiting and len(running[i]) < p.decode_max_batch:
                ready, _, k = decode_waiting[0]
                if ready > dc[i]:
                    break
                if kv_used + int(itok[k] + otok[k]) > p.kv_tokens_capacity:
                    break  # KV admission control (FIFO, anti-starvation)
                decode_waiting.pop(0)
                running[i].append(k)
                kv_used += int(itok[k] + otok[k])
            if not running[i]:
                continue  # ready time jumped past by another engine
            dc[i] += p.alpha + p.beta * len(running[i])
            done: list[int] = []
            for k in running[i]:
                tokens_done[k] += 1
                if tokens_done[k] >= otok[k]:
                    done.append(k)
            for k in done:
                running[i].remove(k)
                state[k] = DONE
                finish[k] = dc[i]
                remaining -= 1

    return {
        "engine": np.zeros(n, dtype=np.int64),
        "state": state,
        "in_tokens": itok,
        "out_tokens": otok,
        "arrived_ms": arr,
        "ttft_emu_ms": first - arr,
        "latency_emu_ms": finish - arr,
    }


def run_tandem_poisson(
    profile: DisaggProfile,
    rate_rps: float,
    duration_s: float,
    in_tokens: int,
    out_tokens: int,
    seed: int = 0,
) -> dict[str, Any]:
    """Steady fixed-size Poisson drive of one tandem unit — the shape
    the disagg closed-loop analyzer test uses (arrivals seeded, tokens
    constant so the analyzer's RequestSize is exact)."""
    rng = np.random.default_rng(seed)
    arr: list[float] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / rate_rps))
        if t >= duration_s:
            break
        arr.append(t * 1000.0)
    n = len(arr)
    return run_tandem(
        profile,
        np.asarray(arr, dtype=np.float64),
        np.full(n, in_tokens, dtype=np.int64),
        np.full(n, out_tokens, dtype=np.int64),
    )
