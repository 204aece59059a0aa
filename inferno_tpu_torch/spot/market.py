"""Spot-tier economics: config parsing + the eviction-risk model.

One implementation of the spot-replica split, shared — via numpy on
whatever shape the caller brings — by every sizing path so they cannot
drift: the scalar `create_allocation` (0-d arrays), the vectorized
per-cycle writeback in `parallel.fleet.calculate_fleet` ([lanes]), and
the batched time-axis replay `calculate_fleet_batch` ([T_chunk, lanes]).

The model (`SpotPoolSpec` per pool, env/ConfigMap `TPU_SPOT_POOLS`):

* A replica placed on the spot tier costs ``(1 - discount)`` of the
  reserved price.
* A correlated storm arrives at ``hazard_per_hr`` and reclaims
  ``blast_radius`` of the pool's spot replicas at once; each evicted
  replica takes ``recovery_s`` to re-provision. The expected SLO-breach
  replica-time per hour of one *risky* spot replica is therefore
  ``hazard x blast x recovery_hr``, priced into the solver objective at
  ``penalty_factor`` times the replica's reserved cost.
* A variant's *safe* spot count is bounded by its SLO headroom in
  replica units: with ``slack = sized - load-required`` replicas, up to
  ``floor(slack / blast_radius)`` replicas can ride spot and a storm
  still leaves enough survivors to carry the load. Spot beyond that is
  *risky*: it is taken only when the premium is below the discount
  (``hazard x blast x recovery_hr x penalty < discount``), otherwise the
  placement is trimmed to the safe count — surfaced as the
  ``spot_risk_bound`` decision reason.

With no spot configuration every function here is a no-op and the
sizing/solve paths are bit-identical to the pre-spot code (pinned by the
existing parity suites).

Port copy of `inferno_tpu/spot/market.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import json
import math
from typing import TYPE_CHECKING, Mapping

import numpy as np

from inferno_tpu_torch.config.types import SpotPoolSpec

if TYPE_CHECKING:  # pure-data module otherwise; no core import at runtime
    from inferno_tpu_torch.core.allocation import Allocation

SPOT_POOLS_FORMAT = (
    'JSON object mapping pool name -> {"discount": 0.6, "hazardPerHr": 0.05, '
    '"blastRadius": 0.5, "recoverySeconds": 180, "chips": 0, '
    '"penaltyFactor": 1000}; only "discount" is required'
)
_SPOT_POOL_KEYS = frozenset({
    "discount", "hazardPerHr", "blastRadius", "recoverySeconds", "chips",
    "penaltyFactor",
})
POOL_QUOTAS_FORMAT = (
    'JSON object mapping "pool" or "pool/region" -> whole chip count, '
    'e.g. {"v5e": 48, "v5e/us-east1": 16}'
)


class SpotConfigError(ValueError):
    """A malformed TPU_SPOT_POOLS / TPU_POOL_QUOTAS entry, with the
    offending key and the expected format in the message — raised at
    config-parse time so a typo surfaces as one actionable log line,
    never a KeyError mid-cycle."""


def parse_spot_pools(raw: str) -> dict[str, SpotPoolSpec]:
    """Validated `TPU_SPOT_POOLS` parse; {} for empty input."""
    if not raw or not raw.strip():
        return {}
    try:
        doc = json.loads(raw)
    except json.JSONDecodeError as e:
        raise SpotConfigError(
            f"TPU_SPOT_POOLS is not valid JSON ({e}); expected {SPOT_POOLS_FORMAT}"
        ) from e
    if not isinstance(doc, Mapping):
        raise SpotConfigError(
            f"TPU_SPOT_POOLS must be a JSON object, got {type(doc).__name__}; "
            f"expected {SPOT_POOLS_FORMAT}"
        )
    out: dict[str, SpotPoolSpec] = {}
    for pool, entry in doc.items():
        if not isinstance(entry, Mapping):
            raise SpotConfigError(
                f"TPU_SPOT_POOLS[{pool!r}] must be an object, got "
                f"{type(entry).__name__}; expected {SPOT_POOLS_FORMAT}"
            )
        if "discount" not in entry:
            raise SpotConfigError(
                f"TPU_SPOT_POOLS[{pool!r}] is missing required key "
                f'"discount"; expected {SPOT_POOLS_FORMAT}'
            )
        unknown = set(entry) - _SPOT_POOL_KEYS
        if unknown:
            # a misspelled optional key (hazardperhr, blast_radius, ...)
            # would otherwise silently default — e.g. hazard 0 turns the
            # risk model off, the exact misconfiguration this validation
            # exists to surface
            raise SpotConfigError(
                f"TPU_SPOT_POOLS[{pool!r}] has unknown key(s) "
                f"{sorted(unknown)}; expected {SPOT_POOLS_FORMAT}"
            )
        try:
            spec = SpotPoolSpec.from_dict(entry)
            spec.validate()
        except (TypeError, ValueError) as e:
            raise SpotConfigError(
                f"TPU_SPOT_POOLS[{pool!r}]: {e}; expected {SPOT_POOLS_FORMAT}"
            ) from e
        out[pool] = spec
    return out


def parse_pool_quotas(raw: str) -> dict[str, int]:
    """Validated `TPU_POOL_QUOTAS` parse; {} for empty input."""
    if not raw or not raw.strip():
        return {}
    try:
        doc = json.loads(raw)
    except json.JSONDecodeError as e:
        raise SpotConfigError(
            f"TPU_POOL_QUOTAS is not valid JSON ({e}); "
            f"expected {POOL_QUOTAS_FORMAT}"
        ) from e
    if not isinstance(doc, Mapping):
        raise SpotConfigError(
            f"TPU_POOL_QUOTAS must be a JSON object, got "
            f"{type(doc).__name__}; expected {POOL_QUOTAS_FORMAT}"
        )
    out: dict[str, int] = {}
    for key, value in doc.items():
        if not key or key.count("/") > 1 or key.startswith("/") or key.endswith("/"):
            raise SpotConfigError(
                f"TPU_POOL_QUOTAS key {key!r} is not a pool or pool/region "
                f"bucket; expected {POOL_QUOTAS_FORMAT}"
            )
        try:
            chips = int(value)
        except (TypeError, ValueError) as e:
            raise SpotConfigError(
                f"TPU_POOL_QUOTAS[{key!r}] must be a whole chip count, got "
                f"{value!r}; expected {POOL_QUOTAS_FORMAT}"
            ) from e
        if chips < 0:
            raise SpotConfigError(
                f"TPU_POOL_QUOTAS[{key!r}] must be >= 0 chips, got {chips}; "
                f"expected {POOL_QUOTAS_FORMAT}"
            )
        out[key] = chips
    return out


# -- the risk model -----------------------------------------------------------


def spot_enabled(system) -> bool:
    """Whether any pool of this System carries a spot tier — the single
    gate every spot branch checks, so disabled fleets pay nothing."""
    return bool(getattr(system, "spot", None))


def premium_rate(spec: SpotPoolSpec) -> float:
    """Objective premium per risky spot replica, as a dimensionless
    multiple of the replica's reserved cost per hour: the expected
    SLO-breach replica-time (hazard x blast x recovery hours) priced at
    the pool's penalty factor."""
    return (
        spec.hazard_per_hr
        * spec.blast_radius
        * (spec.recovery_s / 3600.0)
        * spec.penalty_factor
    )


def rank_columns(system, acc_names: list[str]):
    """Per-accelerator-rank spot columns for the vectorized paths:
    (discount f64, blast f64, premium f64, eligible bool) over the
    sorted catalog. A shape whose pool has no spot tier — or that is
    marked not spot-eligible — gets eligible=False and zeros."""
    n = len(acc_names)
    discount = np.zeros(n, np.float64)
    blast = np.zeros(n, np.float64)
    prem = np.zeros(n, np.float64)
    eligible = np.zeros(n, bool)
    spot = getattr(system, "spot", {}) or {}
    for i, name in enumerate(acc_names):
        acc = system.accelerators.get(name)
        if acc is None:
            continue
        spec = spot.get(acc.pool)
        if spec is None or not acc.spec.spot_eligible:
            continue
        discount[i] = spec.discount
        blast[i] = spec.blast_radius
        prem[i] = premium_rate(spec)
        eligible[i] = True
    return discount, blast, prem, eligible


def spot_split(reps, required, cost_per_replica, discount, blast, premium,
               eligible):
    """THE spot-replica split, one op order for every caller (inputs are
    broadcastable numpy arrays; 0-d for the scalar path).

    Returns (spot_reps i64, discount_amount f64, risk_premium f64,
    trimmed bool):

    * ``spot_reps`` — replicas placed on the spot tier: all of them when
      the risk premium is below the discount, else only the safe count
      ``min(reps, floor(slack / blast))``;
    * ``discount_amount`` — cents/hr taken off the reserved price
      (``spot_reps x cost_per_replica x discount``);
    * ``risk_premium`` — cents/hr added to the solver *objective* for
      the risky spot replicas (never to the reported cost);
    * ``trimmed`` — risk (not price) capped the placement below the full
      replica count: the ``spot_risk_bound`` decision signal.
    """
    reps = np.asarray(reps, np.int64)
    required = np.minimum(np.asarray(required, np.int64), reps)
    cpr = np.asarray(cost_per_replica, np.float64)
    d = np.asarray(discount, np.float64)
    b = np.asarray(blast, np.float64)
    pr = np.asarray(premium, np.float64)
    has = np.asarray(eligible, bool) & (d > 0.0)

    slack = (reps - required).astype(np.float64)
    b_safe = np.where(b > 0.0, b, 1.0)
    # ceil(b*k) <= slack  <=>  k <= slack/b (slack is whole replicas)
    k_safe = np.minimum(reps, (slack / b_safe).astype(np.int64))
    all_spot = pr < d
    k = np.where(has, np.where(all_spot, reps, k_safe), 0)
    risky = np.where(has & all_spot, reps - k_safe, 0)
    discount_amount = k.astype(np.float64) * cpr * d
    risk_premium = risky.astype(np.float64) * cpr * pr
    trimmed = has & ~all_spot & (k < reps)
    return k, discount_amount, risk_premium, trimmed


def apply_spot(system, alloc: "Allocation", cost_per_replica: float,
               required: int) -> None:
    """Scalar-path application onto one sized Allocation (the exact 0-d
    run of `spot_split`): discounts the cost, stamps the spot fields,
    and leaves the risk premium on `alloc.spot_premium` for
    `Server.calculate` to fold into the transition-penalty value."""
    if not spot_enabled(system) or not alloc.accelerator:
        return
    if alloc.num_replicas <= 0:
        return
    acc = system.accelerators.get(alloc.accelerator)
    if acc is None or not acc.spec.spot_eligible:
        return
    spec = system.spot.get(acc.pool)
    if spec is None:
        return
    k, discount_amount, risk_premium, trimmed = spot_split(
        alloc.num_replicas, required, cost_per_replica,
        spec.discount, spec.blast_radius, premium_rate(spec), True,
    )
    alloc.spot_replicas = int(k)
    alloc.spot_discount = float(discount_amount)
    alloc.spot_premium = float(risk_premium)
    alloc.spot_trimmed = bool(trimmed)
    alloc.cost = alloc.cost - float(discount_amount)
    # create_allocation seeds value = cost before the transition penalty
    # overwrites it; keep the seed consistent with the discounted price
    alloc.value = alloc.value - float(discount_amount)


def demote_spot(alloc: "Allocation") -> "Allocation":
    """Clone with the spot placement stripped: every replica back on
    reserved capacity at the undiscounted price. The limited-mode
    solvers use this when the spot tier (or the reserved headroom the
    blast radius demands) cannot be held — the pre-positioner's
    fallback, surfaced as a `spot_headroom` DegradationEvent."""
    out = alloc.clone()
    out.cost += out.spot_discount
    out.spot_replicas = 0
    out.spot_discount = 0.0
    out.spot_premium = 0.0
    out.spot_trimmed = False
    return out


def headroom_chips(blast_radius: float, spot_chips: int) -> int:
    """Reserved chips the pre-positioner holds free to absorb one storm
    over `spot_chips` of spot placement."""
    if spot_chips <= 0:
        return 0
    return int(math.ceil(blast_radius * spot_chips))


def split_needs(alloc: "Allocation", per_replica_chips: int,
                blast_radius: float) -> tuple[int, int, int]:
    """(reserved_chips, spot_chips, headroom_chips) one candidate
    allocation demands from the capacity ledger — the split both the
    scalar and vectorized greedy fit-check identically. The headroom
    charge rides every reserved bucket (pool + quotas): it is capacity
    *held*, not allocated, so lower-priority entries cannot consume the
    slack the blast radius of higher classes implies."""
    k = alloc.spot_replicas
    spot = k * per_replica_chips
    reserved = (alloc.num_replicas - k) * per_replica_chips
    return reserved, spot, headroom_chips(blast_radius, spot)
