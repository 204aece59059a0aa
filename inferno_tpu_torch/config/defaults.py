"""System-wide defaults and enums.

Capability parity with the reference's tuning constants
(upstream pkg/config/defaults.go:12-33 and
upstream pkg/config/config.go:4-41), re-expressed for the TPU
domain where noted.

Port copy of `inferno_tpu/config/defaults.py`, verbatim apart from its imports.
"""

import enum
import math
import os

# -- environment accessors -----------------------------------------
# THE env-read seam: every `os.environ` read in the package goes through
# one of these typed accessors, with the variable name as a string
# literal, so the INF001 config-registry checker
# (inferno_tpu/analysis/config_registry.py) can enumerate the live
# configuration surface from source and diff it against the documented
# table in docs/user-guide/configuration.md — both directions. A direct
# `os.environ` / `os.getenv` read anywhere else in the package is an
# INF001 violation.


def parse_bool(value: str, default: bool = False) -> bool:
    """Truthy-string parsing shared by env knobs (env_bool) and ConfigMap
    knobs (controller/reconciler.py, via the controller.constants
    re-export) so accepted spellings cannot diverge."""
    v = (value or "").strip().lower()
    if not v:
        return default
    return v in ("1", "true", "yes", "on")


def env_str(name: str, default: str = "") -> str:
    """String knob; unset returns the default verbatim."""
    return os.environ.get(name, default)


def env_int(name: str, default: int) -> int:
    """Integer knob; unset or set-empty returns the default (matching the
    historical `int(os.environ.get(X, d) or d)` call sites)."""
    raw = os.environ.get(name, "").strip()
    return default if not raw else int(raw)


def env_float(name: str, default: float) -> float:
    """Float knob; unset or set-empty returns the default."""
    raw = os.environ.get(name, "").strip()
    return default if not raw else float(raw)


def env_bool(name: str, default: bool = False) -> bool:
    """Opt-IN boolean knob: only 1/true/yes/on enable it; anything else
    (including garbage) resolves False. Unset/empty = default."""
    return parse_bool(os.environ.get(name, ""), default)


def env_flag(name: str, default: bool = True) -> bool:
    """Opt-OUT gate (kill switch): only an explicit 0/false/no/off
    disables it; unset, empty, or garbage leaves it at the historical
    call sites' permissive reading (anything not falsy = on). Used by the
    default-on fast paths (FLEET_SNAPSHOT, INCREMENTAL_CYCLE,
    GREEDY_VECTORIZED) whose semantics predate env_bool."""
    raw = os.environ.get(name, "true" if default else "false")
    return raw.lower() not in ("0", "false", "no", "off")


# Percentile at which latency SLO targets are interpreted
# (reference: pkg/config/defaults.go:12).
SLO_PERCENTILE = 0.95

# Multiplier taking the *mean queueing wait* to its SLO_PERCENTILE quantile
# under an exponential-tail assumption: P(W > m·E[W]) = e^-m for exponential
# W, so m = -ln(1 - percentile). The reference defines the same constant and
# leaves its application commented out (pkg/config/defaults.go:15,
# pkg/core/allocation.go:117); here sizing actually applies it — TTFT
# targets bound margin·wait + prefill, so the *percentile* TTFT meets the
# SLO, not just the mean (prefill time at a given concurrency is
# deterministic; the queueing wait carries the tail).
SLO_MARGIN = -math.log(1.0 - SLO_PERCENTILE)


def slo_margin_for(percentile: float) -> float:
    """Mean-wait multiplier reaching `percentile` under an exponential tail
    (e.g. 0.99 -> 4.6)."""
    if not 0.0 < percentile < 1.0:
        raise ValueError(f"percentile must be in (0,1), got {percentile}")
    return -math.log(1.0 - percentile)

# Maximum queue length as a multiple of the max batch size
# (reference: pkg/config/defaults.go:18).
MAX_QUEUE_TO_BATCH_RATIO = 10

# Penalty factor applied when an optimization decision moves a server between
# slice shapes. Re-provisioning a TPU pod-slice (multi-host, atomically
# scheduled) is substantially more disruptive than adding a replica on the
# same shape, so transitions are taxed (reference: pkg/config/defaults.go:21).
ACCEL_PENALTY_FACTOR = 0.1

# Fraction of maximum stable throughput held back as safety headroom when a
# TPS target is active (reference: pkg/analyzer/queueanalyzer.go:11).
STABILITY_SAFETY_FRACTION = 0.1

# -- spot-market economics (inferno_tpu/spot/) --------------------------------
# Objective premium per *risky* spot replica, as a multiple of the expected
# SLO-breach replica-time it implies: a risky spot replica (one whose storm
# eviction would push the variant below its load-required replica count)
# carries premium = hazard/hr x blast_radius x recovery_hr x
# SPOT_RISK_PENALTY_FACTOR x replica cost. The factor prices the *violation*,
# not the chip-hours — losing an SLO-critical replica costs far more than the
# hardware it ran on. With the default, risky spot wins only when
# hazard x blast x recovery_hr x 1000 < discount.
SPOT_RISK_PENALTY_FACTOR = 1000.0

# Default replica re-provision latency after a spot eviction, seconds
# (overridable per pool via the TPU_SPOT_POOLS `recoverySeconds` field);
# roughly the v5e multi-host pod-slice spin-up the catalog models.
SPOT_RECOVERY_SECONDS = 180.0

def rate_within_tolerance(anchor: float, observed: float, tolerance: float) -> bool:
    """THE arrival-rate tolerance predicate, shared by the sizing cache
    (controller/sizing_cache.py) and the incremental dirty scan
    (parallel/snapshot.py): |observed - anchor| <= tolerance * max(anchor, 0).

    One definition on purpose: a variant the cache would
    replay as a hit must also count as *clean* for the fleet dirty set,
    or the two skip layers would disagree about the same λ wiggle and a
    `sizing_provenance: cached` decision could drift from a
    skipped-server decision. Tolerance 0 means exact-λ only."""
    return abs(observed - anchor) <= tolerance * max(anchor, 0.0)


# Service class fallbacks (reference: pkg/config/defaults.go:24-33).
DEFAULT_SERVICE_CLASS_NAME = "Free"
DEFAULT_SERVICE_CLASS_PRIORITY = 100
MIN_PRIORITY = 1  # highest priority (lower value = higher priority)
MAX_PRIORITY = 100  # lowest priority


class SaturationPolicy(str, enum.Enum):
    """Best-effort allocation policy when chip capacity cannot satisfy all
    SLOs (reference: pkg/config/config.go:4-41)."""

    NONE = "None"
    PRIORITY_EXHAUSTIVE = "PriorityExhaustive"
    PRIORITY_ROUND_ROBIN = "PriorityRoundRobin"
    ROUND_ROBIN = "RoundRobin"
