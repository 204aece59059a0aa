"""Input-signature sizing cache (layer 3).

Candidate sizing is a pure function of its inputs: the variant's load
shape, its (possibly corrector-calibrated) profile parameters, the SLO
targets, the accelerator catalog/capacity, and the candidate shape set.
At fleet scale most variants' inputs are UNCHANGED from the previous
cycle — re-packing and re-solving their lanes every cycle buys nothing.
This cache keys each server's candidate-allocation dict by that input
signature and replays it on a hit, with two deliberate semantics:

* the arrival rate compares within a RELATIVE TOLERANCE (the cache
  knob): λ jitters scrape-to-scrape, and a sub-percent wiggle almost
  never crosses a replica boundary. Tolerance 0 means exact-λ only —
  with live telemetry that effectively disables reuse.
* the solver objective (`Allocation.value`, the transition penalty from
  the CURRENT allocation) is recomputed on every replay — it depends on
  where the variant is now, which changes as actuation proceeds, and is
  a cheap scalar.

Anything else in the signature changing — corrected parms, SLOs, shape
catalog, capacity, token mix, min replicas, the pinned shape — is a
miss, so every invalidation trigger the docs list
(docs/performance.md) is structural, not heuristic.

Port copy of `inferno_tpu/controller/sizing_cache.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import dataclasses

from inferno_tpu_torch.config.defaults import rate_within_tolerance
from inferno_tpu_torch.core.allocation import Allocation, transition_penalty


def _perf_key(perf) -> tuple:
    """Hashable fingerprint of one (model, shape) profile as the sizing
    consumes it — AFTER context-bucket resolution and corrector
    calibration (prepare materializes both into the spec's parms)."""
    return (
        perf.acc,
        perf.slices_per_replica,
        perf.max_batch_size,
        perf.at_tokens,
        perf.decode_parms,   # frozen dataclasses: hashable, exact floats
        perf.prefill_parms,
        perf.disagg,
        tuple(
            (b.max_in_tokens, b.max_batch_size, b.decode_parms, b.prefill_parms)
            for b in perf.context_buckets
        ),
    )


def system_fingerprint(system) -> tuple:
    """The cycle-global signature component: the accelerator catalog
    (incl. placement regions) and the chip capacity AND quota state.
    Candidate sizing is per-lane and does not read capacity, but a
    capacity, quota, or catalog change is exactly the moment an operator
    expects every cached decision to be re-derived — the limited-mode
    solve consumes the cached candidates, so a quota edit must not
    replay sizings whose solve context changed."""
    return (
        tuple(
            (a.name, a.pool, a.chips, a.cost, a.region, a.spec.spot_eligible)
            for a in sorted(system.accelerators.values(), key=lambda a: a.name)
        ),
        tuple(sorted(system.capacity.items())),
        tuple(sorted(getattr(system, "quotas", {}).items())),
        # the spot tier changes candidate COSTS (discount, premium,
        # split), not just the solve context — a TPU_SPOT_POOLS edit
        # must re-derive every cached sizing
        tuple(sorted(getattr(system, "spot", {}).items())),
    )


def server_signature(server, system, global_fp: tuple) -> tuple | None:
    """Everything candidate sizing reads for one server, EXCEPT the
    arrival rate (compared separately under the tolerance). None when
    the server can't be fingerprinted (missing model/class — the sizing
    path produces no candidates for it anyway)."""
    model = system.models.get(server.model_name)
    svc = system.service_classes.get(server.service_class_name)
    if model is None or svc is None:
        return None
    target = svc.target_for(server.model_name)
    if target is None:
        return None
    load = server.load
    candidates = tuple(sorted(server.candidate_accelerators(system)))
    return (
        global_fp,
        server.model_name,
        candidates,
        tuple(
            _perf_key(model.perf_data[acc])
            for acc in candidates
            if acc in model.perf_data
        ),
        (target.slo_itl, target.slo_ttft, target.slo_tps),
        (load.avg_in_tokens, load.avg_out_tokens) if load is not None else None,
        server.max_batch_size,
        server.min_num_replicas,
        server.keep_accelerator,
        server.cur_allocation.accelerator,  # pins the candidate set
    )


@dataclasses.dataclass
class _Entry:
    arrival_rate: float
    signature: tuple
    # Solve-time candidates, held by REFERENCE: nothing mutates a
    # candidate Allocation after the solve (greedy clones before
    # scaling), and every replay clones before touching `value`. For a
    # lazy `parallel.fleet.LaneAllocations` this defers per-lane
    # materialization to the first hit — storing must stay O(1) so the
    # cache doesn't reinstate the O(lanes) writeback the lazy view
    # removed. The view pins its cycle-scoped result arrays (one shared
    # source per solve, bounded by max_age_cycles entries).
    allocations: dict[str, Allocation]
    hits_served: int = 0


class SizingCache:
    """Per-variant candidate-allocation cache keyed by input signature.

    Single-threaded by design: lookups and stores happen on the
    reconcile thread around the solve phase (the concurrent pipeline
    parallelizes collection and actuation, never sizing bookkeeping).

    `max_age_cycles` bounds how long one solve can be replayed: the λ
    anchor is the SOLVE-time rate, so a persistent shift that stays
    inside the tolerance (e.g. a +1.9% step at a replica boundary)
    would otherwise never trigger a fresh solve. After this many
    consecutive hits the entry is treated as a miss and re-anchored by
    the re-solve — worst-case staleness is max_age_cycles reconcile
    intervals.
    """

    DEFAULT_MAX_AGE_CYCLES = 10

    def __init__(self, rel_tolerance: float = 0.0,
                 max_age_cycles: int = DEFAULT_MAX_AGE_CYCLES):
        if rel_tolerance < 0:
            raise ValueError(f"rel_tolerance must be >= 0, got {rel_tolerance}")
        if max_age_cycles < 1:
            raise ValueError(
                f"max_age_cycles must be >= 1, got {max_age_cycles}"
            )
        self.rel_tolerance = rel_tolerance
        self.max_age_cycles = max_age_cycles
        self._entries: dict[str, _Entry] = {}
        self.hits = 0
        self.misses = 0

    def _rate_close(self, cached: float, observed: float) -> bool:
        # the SHARED tolerance predicate (config.defaults): the incremental
        # dirty scan (parallel/snapshot.py) compares λ with the same
        # function, so cache-hit and skipped-server decisions never drift
        return rate_within_tolerance(cached, observed, self.rel_tolerance)

    def lookup(
        self, name: str, signature: tuple, arrival_rate: float, cur_allocation
    ) -> dict[str, Allocation] | None:
        """Cached candidates for `name`, with transition penalties
        recomputed against the CURRENT allocation; None on miss."""
        entry = self._entries.get(name)
        if (
            entry is None
            or entry.signature != signature
            or not self._rate_close(entry.arrival_rate, arrival_rate)
            or entry.hits_served >= self.max_age_cycles
        ):
            self.misses += 1
            return None
        entry.hits_served += 1
        self.hits += 1
        out: dict[str, Allocation] = {}
        for acc, alloc in entry.allocations.items():
            replay = alloc.clone()
            # the same objective every fresh sizing path computes:
            # transition penalty PLUS the spot-tier risk premium (zero
            # without a tier) — a cached cycle must not solve a
            # different objective than the solved cycle it replays
            replay.value = (
                transition_penalty(cur_allocation, replay)
                + replay.spot_premium
            )
            out[acc] = replay
        return out

    def store(
        self,
        name: str,
        signature: tuple,
        arrival_rate: float,
        allocations: dict[str, Allocation],
    ) -> None:
        self._entries[name] = _Entry(
            arrival_rate=arrival_rate,
            signature=signature,
            allocations=allocations,
        )

    def invalidate(self, name: str) -> None:
        self._entries.pop(name, None)

    def prune(self, active: set[str]) -> None:
        """Drop state of variants no longer managed (same contract as the
        corrector/forecaster prune paths — a deleted VA must not leave
        cached allocations behind)."""
        for name in [n for n in self._entries if n not in active]:
            del self._entries[name]

    def reset_cycle_counts(self) -> None:
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)
