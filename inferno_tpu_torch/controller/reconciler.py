"""The reconcile loop.

Capability parity with the reference controller
(upstream internal/controller/variantautoscaling_controller.go:
86-407), same cycle shape (SURVEY §3.2):

  read config -> list VAs -> per-VA prepare (SLO lookup, profiles,
  deployment, owner-ref, metrics validation, load collection) ->
  build System -> size candidates (TPU fleet path) -> solve ->
  per-VA apply (status + conditions + actuation metrics)

Per-VA errors skip that variant for the cycle; optimization failure
marks OptimizationReady=False on all VAs and retries next cycle.

Port of `inferno_tpu/controller/reconciler.py`, verbatim apart from its
imports and these changes:

* the backend set: `compute_backend` is `auto|cuda|torch|scalar`, with
  `compute_device` (None = the CUDA card). `auto` resolves to `cuda` when
  a card is present and raises otherwise (`COMPUTE_BACKEND=torch
  COMPUTE_DEVICE=cpu` is the explicit CPU choice); the reference's
  `tpu`, `tpu-pallas`, `jax` and `native` are rejected at config time,
  and its TPU probe does not come over;
* the solve span sizes through `inferno_tpu_torch.parallel.
  calculate_fleet(system, backend, device=compute_device, ...)`: on
  backend `cuda` every stationary solve runs on `stats_kernel` and every
  bisection on `bisect_kernel`. The profile corrector's surrogate trains
  on `compute_device` too;
* the flight recorder is not ported yet (it goes with the planner slice,
  which reads its artifacts): `flight_recorder_dir` set to anything but
  "" raises NotImplementedError at config time.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import logging
import threading
import time
from typing import Any, Callable

import yaml

from inferno_tpu_torch.config.defaults import env_str
from inferno_tpu_torch.config.types import (
    AcceleratorSpec,
    AllocationData,
    CapacitySpec,
    ModelTarget,
    OptimizerSpec,
    ServerLoadSpec,
    ServerSpec,
    ServiceClassSpec,
    SystemSpec,
)
from inferno_tpu_torch.controller.actuator import Actuator
from inferno_tpu_torch.controller.collector import (
    FleetSamples,
    MetricsValidation,
    collect_alloc_from_fleet,
    collect_current_alloc,
    collect_fleet_samples,
    collect_sleeping_alloc,
    validate_from_fleet,
    validate_metrics_availability,
)
from inferno_tpu_torch.controller.crd import (
    GROUP,
    REASON_METRICS_MISSING,
    REASON_METRICS_UNAVAILABLE,
    REASON_OPTIMIZATION_FAILED,
    REASON_OPTIMIZATION_SUCCEEDED,
    TYPE_METRICS_AVAILABLE,
    TYPE_OPTIMIZATION_READY,
    VERSION,
    VariantAutoscaling,
    _utcnow,
)
from inferno_tpu_torch.controller.engines import EngineMetrics, engine_for
from inferno_tpu_torch.controller.inventory import collect_tpu_inventory
from inferno_tpu_torch.controller.kube import KubeClient, KubeError, NotFound
from inferno_tpu_torch.controller.workload import get_workload
from inferno_tpu_torch.controller.logger import kv
from inferno_tpu_torch.controller.promclient import PromClient, PromError
from inferno_tpu_torch.core import System
from inferno_tpu_torch.obs import (
    PROVENANCE_CORRECTED,
    RATE_PROVENANCE_FORECAST,
    REASON_ASLEEP,
    REASON_CAPACITY_LIMITED,
    REASON_COST_BOUND,
    REASON_ERROR,
    REASON_FORECAST_BOUND,
    REASON_SLO_BOUND,
    REASON_SPOT_RISK_BOUND,
    REASON_STABILIZATION_HOLD,
    SIZING_PROVENANCE_CACHED,
    DecisionRecord,
    Span,
    TraceBuffer,
    Tracer,
)
from inferno_tpu_torch.solver import Optimizer

DEFAULT_INTERVAL_SECONDS = 60  # reference: variantautoscaling_controller.go:94-101

# ConfigMap names live in the dependency-free constants module so the
# watch transport can import them without the solver/jax stack
from inferno_tpu_torch.controller.constants import (  # noqa: E402,F401 (re-export)
    CM_ACCELERATOR_COSTS,
    CM_CONFIG,
    CM_SERVICE_CLASSES,
    parse_bool,
)


BACKENDS = ("auto", "cuda", "torch", "scalar")
# the reference's backends, which need jax, a TPU or its C++ solver
REFERENCE_ONLY_BACKENDS = ("tpu", "tpu-pallas", "jax", "native")


def resolve_compute_backend() -> str:
    """'auto' resolution: `cuda` when a CUDA card is present. Without one
    it raises: the port runs on the card unless the operator asks for the
    CPU explicitly, and a silent CPU fallback would size a production
    fleet on the plain torch path without anyone choosing it."""
    import torch

    if torch.cuda.is_available():
        return "cuda"
    raise RuntimeError(
        "COMPUTE_BACKEND=auto found no CUDA device; set "
        "COMPUTE_BACKEND=torch COMPUTE_DEVICE=cpu to size on the CPU"
    )


@dataclasses.dataclass
class ReconcilerConfig:
    config_namespace: str = "inferno-system"
    engine: str = "vllm-tpu"  # serving engine metric vocabulary
    scale_to_zero: bool = False  # reference env WVA_SCALE_TO_ZERO (utils.go:282-285)
    # candidate-sizing backend: "auto" (resolved once at Reconciler init
    # and logged: "cuda" when a card is present, else an error), "cuda"
    # (the hand-written kernels), "torch" (their plain torch versions, on
    # `compute_device`), or "scalar" (the per-variant pure-Python loop,
    # kept as a PARITY ORACLE — never auto-selected)
    compute_backend: str = "auto"
    # the device the fleet is sized on: None = the CUDA card; "cpu" only
    # with backend "torch" (or "scalar", where it places the corrector's
    # surrogate training)
    compute_device: str | None = None

    def __post_init__(self) -> None:
        if self.compute_backend in REFERENCE_ONLY_BACKENDS:
            raise ValueError(
                f"compute_backend {self.compute_backend!r} belongs to the JAX "
                f"reference (inferno_tpu); the port takes auto|cuda|torch|scalar"
            )
        if self.compute_backend not in BACKENDS:
            raise ValueError(
                f"compute_backend must be auto|cuda|torch|scalar, "
                f"got {self.compute_backend!r}"
            )
        if self.flight_recorder_dir:
            raise NotImplementedError(
                "the flight recorder is not ported yet (it comes with the "
                "planner slice); leave FLIGHT_RECORDER_DIR unset"
            )
        if self.scale_down_stabilization_s < 0:
            raise ValueError(
                f"scale_down_stabilization_s must be >= 0, "
                f"got {self.scale_down_stabilization_s}"
            )
        if self.reconcile_concurrency < 1:
            raise ValueError(
                f"reconcile_concurrency must be >= 1, "
                f"got {self.reconcile_concurrency}"
            )
        if self.sizing_cache_tolerance < 0:
            raise ValueError(
                f"sizing_cache_tolerance must be >= 0, "
                f"got {self.sizing_cache_tolerance}"
            )
        if not (0.0 < self.attainment_ewma_gain <= 1.0):
            raise ValueError(
                f"attainment_ewma_gain must be in (0, 1], "
                f"got {self.attainment_ewma_gain}"
            )
        if self.flight_recorder_max_mb <= 0:
            raise ValueError(
                f"flight_recorder_max_mb must be > 0, "
                f"got {self.flight_recorder_max_mb}"
            )
        if self.flight_recorder_max_age_s <= 0:
            raise ValueError(
                f"flight_recorder_max_age_s must be > 0, "
                f"got {self.flight_recorder_max_age_s}"
            )
        engine_for(self.engine)  # raise at config time on unknown engines
        if not self.keep_accelerator and self.direct_scale:
            # direct_scale only patches replica counts on the EXISTING
            # workload; it cannot re-provision pods onto a different slice
            # shape, so a migration decision would be actuated as a bare
            # scale-down on the old hardware — a guaranteed SLO breach.
            # Shape migration needs an external actuator that watches
            # desiredOptimizedAlloc.accelerator (HPA/KEDA + llm-d infra).
            raise ValueError(
                "KEEP_ACCELERATOR=false is incompatible with DIRECT_SCALE=true: "
                "direct scaling cannot re-provision a variant onto a different "
                "slice shape"
            )
    direct_scale: bool = False  # actuate Deployments directly (no HPA)
    interval_seconds: int = DEFAULT_INTERVAL_SECONDS
    # calibrate CR-carried linear profiles against observed telemetry,
    # consulting the learned surrogate where residuals are large
    # (models/corrector.py); disable for reference-exact static profiles
    profile_correction: bool = True
    # pin each variant to its current slice shape across cycles (the
    # reference hardcodes this, utils.go:290). False lets the optimizer
    # MIGRATE variants between shapes when the economics demand it —
    # expect churn tolerance from the serving stack (a shape change
    # re-provisions every pod-slice of the variant)
    keep_accelerator: bool = True
    # predictive scaling (inferno_tpu/forecast/, docs/forecasting.md):
    # size scale-UP against max(observed λ, forecast upper band at the
    # replica spin-up horizon) so a traffic ramp is provisioned for
    # BEFORE it breaches, instead of one spin-up interval after. OFF by
    # default: anticipatory sizing deliberately holds capacity above the
    # instantaneous observed demand while a ramp decays, which changes
    # the scale-release timing every reactive deployment was tuned
    # around — operators opt in (env PREDICTIVE_SCALING)
    predictive_scaling: bool = False
    # scale-down stabilization window in seconds (0 = disabled): desired
    # replicas act on the PEAK recommendation of the trailing window,
    # mirroring HPA behavior.scaleDown.stabilizationWindowSeconds.
    # Meaningful for the direct_scale/KEDA actuation paths — when an HPA
    # enacts the gauges, its own stabilization already applies and this
    # window should usually stay 0 (double-gating delays legitimate
    # scale-down twice)
    scale_down_stabilization_s: float = 0.0
    # -- fleet-scale cycle knobs (docs/performance.md) -----------------------
    # bounded concurrency for the per-variant collect stage and _apply's
    # Kube patches (env RECONCILE_CONCURRENCY). 1 = today's serial
    # behavior exactly; per-variant failures stay isolated either way,
    # and CycleReport records/spans keep variant-list order regardless
    # of completion order
    reconcile_concurrency: int = 1
    # coalesced Prometheus collection (env GROUPED_COLLECTION): one query
    # per metric covering every active variant, fanned back out per
    # variant; a variant missing from the grouped response falls back to
    # its per-variant queries, so disabling only costs round trips
    grouped_collection: bool = True
    # input-signature sizing cache (env SIZING_CACHE, default off):
    # variants whose sizing inputs are unchanged since last cycle (λ
    # within sizing_cache_tolerance relative; profile parms incl.
    # corrector output, SLOs, capacity, shape set exact) replay their
    # candidate allocations instead of re-solving
    sizing_cache: bool = False
    sizing_cache_tolerance: float = 0.02
    # -- flight recorder + attainment scoreboard (obs/) -----------------------
    # durable per-cycle trace capture (env FLIGHT_RECORDER_DIR, default
    # off): every cycle's fleet snapshot + per-variant inputs/decisions
    # land in an append-only, rotated artifact written off the hot path
    # (obs/recorder.py); replayable via `python -m inferno_tpu.planner
    # --trace` and scored by `python -m inferno_tpu.obs.report`
    flight_recorder_dir: str = ""
    flight_recorder_max_mb: float = 64.0  # env FLIGHT_RECORDER_MAX_MB
    flight_recorder_max_age_s: float = 3600.0  # env FLIGHT_RECORDER_MAX_AGE_S
    # EWMA gain for the model-error / SLO-attainment scoreboard
    # (obs/attainment.py; env ATTAINMENT_EWMA_GAIN)
    attainment_ewma_gain: float = 0.2
    # -- cycle profiler (obs/profiler.py) -------------------------------------
    # per-cycle cost attribution: phase wall/CPU splits, jit
    # compile-vs-execute, memo/cache hit-miss counts — aggregated into a
    # profile document per cycle (served at /debug/profile, exported as
    # inferno_profile_* series, recorded by the flight recorder).
    # Default ON (env CYCLE_PROFILER): `make bench-profile` pins the
    # overhead at <= 1% of the reference cycle, and profiling is
    # observation-only — decisions are bit-identical either way
    # (tests/test_profiler.py)
    cycle_profiler: bool = True
    # additionally sample the tracemalloc traced-memory peak per cycle
    # (env PROFILE_TRACEMALLOC, default off: tracing costs real CPU and
    # is excluded from the 1% overhead contract)
    profiler_tracemalloc: bool = False


@dataclasses.dataclass
class CycleReport:
    """What one reconcile cycle did (returned for tests/observability)."""

    interval_seconds: int
    variants_seen: int = 0
    variants_prepared: int = 0
    variants_applied: int = 0
    # variants sized with corrector-calibrated (non-CR) profile parms this
    # cycle: observability for the closed calibration loop — a count that
    # flaps across cycles under steady telemetry is the no-flapping bug
    # the corrector's hysteresis band exists to prevent
    corrections_active: int = 0
    optimization_ok: bool = True
    solver_ms: float = 0.0
    analysis_ms: float = 0.0
    # fleet-scale cycle telemetry: Prometheus queries issued
    # this cycle (the coalesced collector's ~Q vs the serial path's
    # Q x V), and the sizing cache's per-cycle outcome counts
    prom_queries: int = 0
    sizing_cache_hits: int = 0
    sizing_cache_misses: int = 0
    errors: list[str] = dataclasses.field(default_factory=list)
    # one DecisionRecord per VA seen this cycle (obs/decision.py): the
    # per-variant sizing rationale — observed λ, provenance, λ_max, SLO
    # headroom, chosen shape/replicas, cost delta, and a reason code
    decisions: list[DecisionRecord] = dataclasses.field(default_factory=list)
    # root span of the cycle trace (obs/trace.py): collect -> analyze
    # (one child per variant) -> solve -> actuate
    trace: Span | None = None
    # per-cycle profile document (obs/profiler.py): per-phase
    # wall/CPU attribution + typed counters; None with CYCLE_PROFILER off
    profile: dict | None = None


class _CountingProm:
    """Per-cycle PromClient view counting every query issued — feeds
    CycleReport.prom_queries and inferno_cycle_prom_queries_total (the
    instrument that makes the coalesced collector's Q-vs-QxV win, or a
    fallback regression, visible). Wraps whatever self.prom currently is
    at cycle start, so tests swapping the client keep working."""

    def __init__(self, inner: PromClient):
        self.inner = inner
        self.count = 0
        self._lock = threading.Lock()

    def query(self, promql: str):
        with self._lock:
            self.count += 1
        return self.inner.query(promql)

    def healthy(self) -> bool:
        return self.inner.healthy()


@dataclasses.dataclass
class _Collected:
    """Per-variant outcome of the collect stage (the I/O half of what
    used to be one monolithic prepare()): everything the serial assembly
    stage needs to finish the variant deterministically. Workers only
    touch per-variant state (the VA object, its DecisionRecord, this
    container), never the shared spec/classes/report."""

    rec: DecisionRecord
    ok: bool = False
    errors: list[str] = dataclasses.field(default_factory=list)
    class_name: str = ""
    target: Any = None
    matching_profiles: list = dataclasses.field(default_factory=list)
    workload: Any = None
    validation: MetricsValidation | None = None
    asleep: bool = False
    current: Any = None  # CurrentAlloc
    elapsed_s: float = 0.0  # worker wall time (per-variant analysis metric)


class Reconciler:
    def __init__(
        self,
        kube: KubeClient,
        prom: PromClient,
        config: ReconcilerConfig | None = None,
        emitter=None,
        trace_buffer: TraceBuffer | None = None,
    ):
        from inferno_tpu_torch.controller.metrics import (
            AttainmentInstruments,
            CycleInstruments,
            EventInstruments,
            ForecastInstruments,
            MetricsEmitter,
            ProfilerInstruments,
            SpotInstruments,
        )
        from inferno_tpu_torch.controller.shard import shard_from_env
        from inferno_tpu_torch.controller.watch import DirtyQueue

        from inferno_tpu_torch.controller.logger import get_logger

        self.kube = kube
        self.prom = prom
        self.config = config or ReconcilerConfig()
        self.emitter = emitter or MetricsEmitter()
        # cycle-latency histograms share the emitter's registry so one
        # /metrics listener exposes the whole catalog
        self.instruments = CycleInstruments(self.emitter.registry)
        # ring of recent cycle traces, served at /debug/decisions when
        # main() hands the same buffer to the MetricsServer (identity
        # check: an EMPTY shared buffer is falsy — len() == 0 — and `or`
        # would silently disconnect it)
        self.traces = trace_buffer if trace_buffer is not None else TraceBuffer()
        # cycle profiler (obs/profiler.py): the last-K profile
        # documents, served at /debug/profile when main() hands this
        # buffer to the MetricsServer. The instrument block registers
        # unconditionally (lint parity); the buffer simply stays empty
        # with CYCLE_PROFILER off.
        self.profiles = TraceBuffer()
        self.profiler_instruments = ProfilerInstruments(self.emitter.registry)
        # readiness heartbeat (metrics._probe_routes): run_cycle stamps
        # last_cycle_monotonic + max_cycle_age_s into this dict when set
        self.ready_flag: dict | None = None
        self.actuator = Actuator(
            kube=kube, emitter=self.emitter, direct_scale=self.config.direct_scale
        )
        self.log = get_logger("inferno.reconciler")
        if self.config.compute_backend == "auto":
            resolved = resolve_compute_backend()
            self.config = dataclasses.replace(self.config, compute_backend=resolved)
            self.log.info(
                "compute_backend auto-resolved to %r (a CUDA card is present)",
                resolved,
            )
        if self.config.profile_correction:
            from inferno_tpu_torch.models.corrector import ProfileCorrector

            self.corrector = ProfileCorrector(device=self.config.compute_device)
        else:
            self.corrector = None
        # predictive scaling (forecast/): the per-variant arrival-rate
        # forecaster consulted before sizing, and the peak-over-window
        # scale-down gate. The forecast gauges register unconditionally
        # so the metric catalog (and `make lint-metrics`) is identical
        # whether or not the feature is on.
        self.forecast_instruments = ForecastInstruments(self.emitter.registry)
        if self.config.predictive_scaling:
            from inferno_tpu_torch.forecast import ArrivalForecaster, ForecastConfig

            # EWMA gains are calibrated per reconcile interval: the
            # forecaster time-weights them by actual observation spacing
            self.forecaster = ArrivalForecaster(
                ForecastConfig(
                    reference_interval_s=max(self.config.interval_seconds, 1)
                )
            )
        else:
            self.forecaster = None
        if self.config.scale_down_stabilization_s > 0:
            from inferno_tpu_torch.forecast import ScaleDownStabilizer

            self.stabilizer = ScaleDownStabilizer(
                self.config.scale_down_stabilization_s
            )
        else:
            self.stabilizer = None
        # input-signature sizing cache (controller/sizing_cache.py):
        # replay candidate allocations for variants whose sizing inputs
        # are unchanged since the previous cycle
        if self.config.sizing_cache:
            from inferno_tpu_torch.controller.sizing_cache import SizingCache

            self.sizing_cache = SizingCache(self.config.sizing_cache_tolerance)
        else:
            self.sizing_cache = None
        # SLO-attainment / model-error scoreboard (obs/attainment.py):
        # always on — it only consumes telemetry the cycle already
        # collected. Gauges register unconditionally (lint parity).
        from inferno_tpu_torch.obs.attainment import AttainmentConfig, AttainmentTracker

        self.attainment = AttainmentTracker(
            AttainmentConfig(ewma_gain=self.config.attainment_ewma_gain)
        )
        self.attainment_instruments = AttainmentInstruments(self.emitter.registry)
        # spot-market placement gauges + preemption counter (spot/,
        # TPU_SPOT_POOLS): registered unconditionally (lint parity);
        # populated only when a solve places spot. _prev_spot remembers
        # last cycle's desired (replicas, spot, pool) per variant so a
        # later cycle observing fewer live replicas on a spot-placed
        # variant counts a detected preemption.
        self.spot_instruments = SpotInstruments(self.emitter.registry)
        self._prev_spot: dict[str, tuple[int, int, str]] = {}
        # event-driven reconcile: the coalescing dirty queue
        # the Watcher (and any λ-delta observer) feeds; drained at solve
        # time into the targeted incremental scan. Gauges register
        # unconditionally (lint parity); an interval-only controller
        # just drains empty sets.
        self.event_instruments = EventInstruments(self.emitter.registry)
        self.dirty_queue = DirtyQueue(wake=self.poke)
        # last cycle's per-variant load signature (arrival, in, out) —
        # the λ-delta dirty source: collect-stage changes are diffed
        # here and marked into the queue before the targeted scan
        self._prev_load_sig: dict[str, tuple | None] = {}
        # consistent-hash fleet partition (SHARD_MEMBERS /
        # SHARD_NAME): when sharded, this controller reconciles only the
        # variants the rendezvous hash assigns to shard_name; None means
        # unsharded (whole fleet)
        self.shard_map, self.shard_name = shard_from_env()
        # persistent worker pool shared by the collect and apply stages
        # (reconcile_concurrency > 1 only; lazily created, kept across
        # cycles). Tearing a pool down every cycle would kill the worker
        # threads — and with them HttpPromClient's per-thread keep-alive
        # connections — re-paying thread spawn + TCP/TLS handshakes
        # every cycle, exactly what the connection cache amortizes.
        self._pool: concurrent.futures.ThreadPoolExecutor | None = None
        # forecast/stabilizer timestamp source — injectable so tests can
        # step cycles at a controlled cadence instead of real time
        self.clock: Callable[[], float] = time.monotonic
        # event-storm absorb sleep (run_forever's debounce window) —
        # injectable so the burst-coalescing test steps it virtually
        self.sleep: Callable[[float], None] = time.sleep
        # set by a Watcher (or anyone) to trigger the next cycle early
        self._wake = threading.Event()
        # Leadership gate, re-checked at every write: a leader deposed
        # mid-cycle (renew failure / lease takeover) must not keep writing
        # VA status or actuating scale concurrently with the new leader.
        # controller-runtime avoids this window by killing the process on
        # lost leadership; we stop at the next write instead.
        self.gate: Callable[[], bool] = lambda: True

    def poke(self) -> None:
        """Request an immediate reconcile (watch-event trigger)."""
        self._wake.set()

    def _executor(self) -> concurrent.futures.ThreadPoolExecutor:
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=self.config.reconcile_concurrency,
                thread_name_prefix="inferno-reconcile",
            )
        return self._pool

    def close(self) -> None:
        """Release the persistent worker pool (main() on shutdown; safe
        to call on a never-pooled or already-closed reconciler)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    # -- config reading -----------------------------------------------------

    def _read_cm(self, name: str) -> dict[str, str]:
        try:
            return self.kube.get_configmap(self.config.config_namespace, name)
        except NotFound:
            return {}

    def read_interval(self) -> int:
        """(reference readOptimizationConfig: controller.go:584-594)"""
        data = self._read_cm(CM_CONFIG)
        try:
            return int(data.get("GLOBAL_OPT_INTERVAL", "").rstrip("s") or 0) or (
                self.config.interval_seconds
            )
        except ValueError:
            return self.config.interval_seconds

    def read_accelerators(self) -> list[AcceleratorSpec]:
        """Slice-shape catalog with per-chip-hour costs
        (reference readAcceleratorConfig: controller.go:499-514, JSON value
        per accelerator type)."""
        data = self._read_cm(CM_ACCELERATOR_COSTS)
        out = []
        for name, raw in sorted(data.items()):
            try:
                obj = json.loads(raw)
            except json.JSONDecodeError:
                continue
            out.append(
                AcceleratorSpec(
                    name=name,
                    cost_per_chip_hr=float(obj.get("cost", 0.0) or 0.0),
                    mem_per_chip_gb=float(obj.get("memPerChipGB", 16.0) or 16.0),
                    # placement region: selects the "pool/region" quota
                    # bucket (TPU_POOL_QUOTAS) this shape draws from
                    region=str(obj.get("region", "") or ""),
                    # '"spot": false' keeps this shape off its pool's
                    # preemptible tier (TPU_SPOT_POOLS) entirely
                    spot_eligible=bool(obj.get("spot", True)),
                )
            )
        return out

    def read_service_classes(self) -> list[ServiceClassSpec]:
        """YAML documents, one per ConfigMap key
        (reference shape: internal/interfaces/types.go:20-30)."""
        data = self._read_cm(CM_SERVICE_CLASSES)
        out = []
        for _, raw in sorted(data.items()):
            try:
                doc = yaml.safe_load(raw)
            except yaml.YAMLError:
                continue
            if not isinstance(doc, dict) or "name" not in doc:
                continue
            targets = []
            for entry in doc.get("data", []) or []:
                targets.append(
                    ModelTarget(
                        model=str(entry.get("model", "")),
                        slo_itl=float(entry.get("slo-tpot", 0) or 0),
                        slo_ttft=float(entry.get("slo-ttft", 0) or 0),
                        slo_tps=float(entry.get("slo-tps", 0) or 0),
                    )
                )
            out.append(
                ServiceClassSpec(
                    name=str(doc["name"]),
                    priority=int(doc.get("priority", 100) or 100),
                    model_targets=targets,
                )
            )
        return out

    def read_optimizer_and_capacity(self) -> tuple[OptimizerSpec, CapacitySpec]:
        data = self._read_cm(CM_CONFIG)
        optimizer = OptimizerSpec(
            unlimited=(data.get("OPTIMIZER_MODE", "unlimited").lower() != "limited"),
            saturation_policy=data.get("SATURATION_POLICY", "None"),
            delayed_best_effort=parse_bool(data.get("DELAYED_BEST_EFFORT", "")),
        )
        capacity = CapacitySpec()
        raw = data.get("TPU_CAPACITY", "")
        if raw:
            try:
                capacity = CapacitySpec(
                    chips={k: int(v) for k, v in json.loads(raw).items()}
                )
            except (json.JSONDecodeError, ValueError, AttributeError):
                pass
        # per-pool[/region] quota carve-outs layered on the pool budgets
        # ({"v5e": 256, "v5e/us-east1": 64}). Validated at parse time
        # (spot/market.py): a malformed entry logs ONE actionable error
        # naming the offending key and the expected format, and the
        # whole key is ignored this cycle — a ConfigMap typo must
        # surface loudly but never abort the cycle
        from inferno_tpu_torch.spot.market import (
            SpotConfigError,
            parse_pool_quotas,
            parse_spot_pools,
        )

        try:
            capacity.quotas = parse_pool_quotas(data.get("TPU_POOL_QUOTAS", ""))
        except SpotConfigError as e:
            self.log.error("ignoring TPU_POOL_QUOTAS this cycle: %s", e)
        # the spot tier per pool: ConfigMap key first, env var fallback
        # (emulator/bench runs configure spot without a cluster)
        raw_spot = data.get("TPU_SPOT_POOLS", "") or env_str(
            "TPU_SPOT_POOLS"
        )
        try:
            capacity.spot = parse_spot_pools(raw_spot)
        except SpotConfigError as e:
            self.log.error("ignoring TPU_SPOT_POOLS this cycle: %s", e)
        if not optimizer.unlimited and not capacity.chips:
            # limited mode with no static capacity: discover chip pools from
            # node google.com/tpu resources (inventory.py); an inventory
            # failure leaves capacity empty, and the greedy solver then has
            # nothing to assign — safer than inventing capacity, but it must
            # be visible in the logs. Configured quotas survive discovery
            # (they carve the discovered budgets, not replace them).
            try:
                # quotas AND spot tiers survive discovery: both carve or
                # price the discovered budgets, they don't replace them
                capacity = dataclasses.replace(
                    collect_tpu_inventory(self.kube),
                    quotas=capacity.quotas, spot=capacity.spot,
                )
            except (KubeError, OSError):
                # OSError: connection-level failures (URLError) bypass the
                # HTTP error mapping in the REST client
                self.log.exception("TPU inventory discovery failed; "
                                   "limited mode has no capacity this cycle")
        return optimizer, capacity

    # -- per-VA preparation -------------------------------------------------

    def _find_slo(
        self, classes: list[ServiceClassSpec], va: VariantAutoscaling
    ) -> tuple[str, ModelTarget] | None:
        """Service class + target for the VA's model. The sloClassRef names
        the preferred class; otherwise first class listing the model wins
        (reference FindModelSLO: internal/utils/utils.go:369-383)."""
        preferred = va.spec.slo_class_ref.key or va.spec.slo_class_ref.name
        for sc in classes:
            if sc.name == preferred:
                t = sc.target_for(va.spec.model_id)
                if t is not None:
                    return sc.name, t
        for sc in classes:
            t = sc.target_for(va.spec.model_id)
            if t is not None:
                if preferred:
                    # the fallback is reference parity, but silently sizing a
                    # variant against a different class's SLOs (a typo'd
                    # sloClassRef) must at least be visible in the logs
                    self.log.warning(
                        "%s: sloClassRef %r matched no class with model %s; "
                        "falling back to class %r",
                        va.full_name, preferred, va.spec.model_id, sc.name,
                    )
                return sc.name, t
        return None

    def _set_owner_reference(self, va: VariantAutoscaling, workload) -> None:
        """The workload (Deployment or LeaderWorkerSet) owns the VA so
        deleting it GCs the VA (reference: controller.go:276-293)."""
        ref = {
            "apiVersion": workload.api_version,
            "kind": workload.kind,
            "name": workload.name or va.name,
            "uid": workload.uid,
            "controller": True,
            "blockOwnerDeletion": False,
        }
        for existing in va.owner_references:
            if existing.get("kind") == ref["kind"] and existing.get("name") == ref["name"]:
                return
        # only one controller ref may exist: a workload-kind change
        # (Deployment -> LWS of the same name) replaces OUR stale ref
        # instead of appending a second controller:True entry, which a real
        # API server rejects. Controller refs of foreign kinds are left
        # alone — stealing ownership from another controller breaks its GC
        # and invites a reconcile fight.
        ours = {"Deployment", "LeaderWorkerSet"}
        if any(
            r.get("controller") and r.get("kind") not in ours
            for r in va.owner_references
        ):
            return
        va.owner_references[:] = [
            r for r in va.owner_references
            if not (r.get("controller") and r.get("kind") in ours)
        ]
        va.owner_references.append(ref)
        if not self.gate():
            return  # deposed mid-cycle: leave the patch to the new leader
        try:
            self.kube.patch_variant_autoscaling_meta(va)
        except KubeError:
            pass  # retried next cycle

    def _collect_variant(
        self,
        va: VariantAutoscaling,
        engine: EngineMetrics,
        prom: PromClient,
        fleet: FleetSamples | None,
        slo: tuple[str, ModelTarget] | None,
        accelerators: dict[str, AcceleratorSpec],
    ) -> _Collected:
        """The I/O half of variant preparation (reference
        prepareVariantAutoscalings: controller.go:218-335): workload
        lookup, owner reference, metrics validation, load collection.
        Runs on a pool worker when RECONCILE_CONCURRENCY > 1 and touches
        only per-variant state; any failure lands in the returned
        container (the variant's skip/error path), never the cycle."""
        t0 = time.perf_counter()
        rec = DecisionRecord(
            variant=va.full_name,
            namespace=va.namespace,
            name=va.name,
            model=va.spec.model_id,
        )
        c = _Collected(rec=rec)
        try:
            self._collect_variant_inner(c, va, engine, prom, fleet, slo, accelerators)
        except Exception as e:  # noqa: BLE001 — per-variant isolation
            c.ok = False
            rec.detail = f"collect: {e}"
            c.errors.append(f"{va.full_name}: collect: {e}")
        c.elapsed_s = time.perf_counter() - t0
        return c

    def _collect_variant_inner(
        self,
        c: _Collected,
        va: VariantAutoscaling,
        engine: EngineMetrics,
        prom: PromClient,
        fleet: FleetSamples | None,
        slo: tuple[str, ModelTarget] | None,
        accelerators: dict[str, AcceleratorSpec],
    ) -> None:
        rec = c.rec
        if slo is None:
            rec.detail = f"no SLO entry for model {va.spec.model_id}"
            c.errors.append(f"{va.full_name}: no SLO entry for model {va.spec.model_id}")
            return
        class_name, target = slo
        c.class_name, c.target = class_name, target
        rec.slo_ttft_ms = target.slo_ttft
        rec.slo_itl_ms = target.slo_itl

        # per-accelerator perf profiles from the CR
        # (reference AddModelAcceleratorProfileToSystemData: utils.go:185-234);
        # materialized after load collection so context-bucketed profiles can
        # select the bucket matching the observed average input length
        matching_profiles = [p for p in va.spec.accelerators if p.acc in accelerators]
        if not matching_profiles:
            rec.detail = "no profile matches a known slice shape"
            c.errors.append(f"{va.full_name}: no profile matches a known slice shape")
            return
        c.matching_profiles = matching_profiles

        try:
            wl = get_workload(self.kube, va.namespace, va.name)
        except KubeError as e:
            rec.detail = f"workload: {e}"
            c.errors.append(f"{va.full_name}: workload: {e}")
            return
        c.workload = wl
        self._set_owner_reference(va, wl)

        # metrics validation: the coalesced fleet probe answers with zero
        # additional queries; a variant absent from the grouped response
        # falls back to the per-variant path (which keeps the
        # namespace-less emulator fallback and exact messages)
        validation = None
        if fleet is not None:
            validation = validate_from_fleet(fleet, va.spec.model_id, va.namespace)
        if validation is None:
            scrape_t0 = time.perf_counter()
            try:
                validation = validate_metrics_availability(
                    prom, engine, va.spec.model_id, va.namespace
                )
            finally:
                self.instruments.observe_scrape(time.perf_counter() - scrape_t0)
        c.validation = validation
        # Scaled-to-zero is ASLEEP, not broken (the metric-series
        # stranding hazard): at 0 replicas every engine series died with
        # the pods, so MetricsMissing is the EXPECTED state — skipping
        # would freeze the desired gauge forever and demand could never
        # wake the variant. Only the exact combination qualifies: the
        # feature enabled, series missing (not stale, not a Prometheus
        # error), and the workload truly at zero.
        # SPEC replicas, not readiness: intent is what distinguishes
        # asleep from broken — a workload WANTING pods (spec > 0) whose
        # pods are crash-looping with no metrics is MetricsMissing
        # breakage and must be skipped, never optimized down to zero
        asleep = (
            not validation.available
            and self.config.scale_to_zero
            and validation.reason == REASON_METRICS_MISSING
            and wl.replicas == 0
        )
        va.status.set_condition(
            TYPE_METRICS_AVAILABLE,
            "True" if validation.available else "False",
            validation.reason,
            validation.message + (
                " Variant is scaled to zero; optimizing from gateway demand."
                if asleep else ""
            ),
        )
        rec.asleep = asleep
        c.asleep = asleep
        if not validation.available and not asleep:
            rec.detail = f"metrics unavailable ({validation.reason}); variant skipped"
            va.status.set_condition(
                TYPE_OPTIMIZATION_READY,
                "False",
                REASON_METRICS_UNAVAILABLE,
                "metrics unavailable; skipping optimization for this variant",
            )
            if self.gate():  # a deposed leader must not write status
                try:
                    self.kube.update_variant_autoscaling_status(va)
                except KubeError:
                    pass
            return

        acc_name = va.labels.get("inference.optimization/acceleratorName", "")
        # per-REPLICA price, matching the desired-side formula (core/
        # allocation.py: cost = slices x chips/slice x $/chip-hr): the
        # whole slice's chips, times the replica's slice footprint
        # (acc_count, x the prefill+decode unit size when disaggregated).
        # Reference parity: collector.go:255 cost = replicas x unitCost.
        cost = accelerators[acc_name].cost if acc_name in accelerators else 0.0
        prof = next((p for p in va.spec.accelerators if p.acc == acc_name), None)
        if prof is not None:
            cost *= prof.acc_count * (prof.disagg.slices_per_unit if prof.disagg else 1)
        # load collection: the coalesced tables answer loaded variants
        # with zero additional queries; asleep variants keep the
        # per-variant gateway path (their demand signal lives upstream
        # of the engine series the fleet queries cover)
        current = None
        if fleet is not None and not asleep:
            current = collect_alloc_from_fleet(fleet, va, wl, cost)
        if current is None:
            scrape_t0 = time.perf_counter()
            try:
                if asleep:
                    current = collect_sleeping_alloc(prom, engine, va, wl)
                else:
                    current = collect_current_alloc(prom, engine, va, wl, cost)
            except PromError as e:
                rec.detail = f"collect: {e}"
                c.errors.append(f"{va.full_name}: collect: {e}")
                return
            finally:
                self.instruments.observe_scrape(time.perf_counter() - scrape_t0)
        va.status.current_alloc = current
        rec.arrival_rpm = current.load.arrival_rate
        rec.ttft_observed_ms = current.ttft_average
        rec.itl_observed_ms = current.itl_average
        rec.avg_in_tokens = current.load.avg_input_tokens
        rec.avg_out_tokens = current.load.avg_output_tokens
        rec.prev_accelerator = current.accelerator
        rec.prev_replicas = current.num_replicas
        rec.prev_cost = current.variant_cost
        c.current = current
        c.ok = True

    def _assemble_variant(
        self,
        c: _Collected,
        va: VariantAutoscaling,
        classes: list[ServiceClassSpec],
        spec: SystemSpec,
        report: CycleReport,
    ) -> bool:
        """The serial half of variant preparation: every shared-state
        mutation (classes/spec appends, forecaster/corrector state, the
        report's records and errors) in variant-list order, so the solver
        input and CycleReport are deterministic no matter how the collect
        pool interleaved. Returns True if the VA was added as a server."""
        report.decisions.append(c.rec)
        report.errors.extend(c.errors)
        if not c.ok:
            return False
        rec = c.rec
        current = c.current
        validation = c.validation
        asleep = c.asleep
        class_name, target = c.class_name, c.target
        matching_profiles = c.matching_profiles

        # detected spot preemption: replicas DROPPED below what was both
        # running and desired last cycle, on a spot-placed variant —
        # count up to the spot count as evicted. The baseline is
        # min(observed, desired): still-spinning-up capacity never
        # "drops" (scale-up lag is not an eviction), and an intentional
        # scale-down lowered the desired side first.
        prev = self._prev_spot.get(va.full_name)
        if prev is not None:
            baseline, prev_spot, prev_pool = prev
            lost = baseline - current.num_replicas
            if prev_spot > 0 and lost > 0:
                counted = min(lost, prev_spot)
                self.spot_instruments.count_preemptions(prev_pool, counted)
                # lower the stored baseline to what was counted against:
                # if this cycle fails before _publish_spot refreshes it,
                # the next cycle must not re-count the same eviction
                self._prev_spot[va.full_name] = (
                    current.num_replicas, prev_spot - counted, prev_pool,
                )

        # Perf data registers under a per-variant model key: the registry is
        # keyed (model, acc) with last-wins semantics, so two variants
        # sharing a modelID would otherwise overwrite each other's
        # CR-carried profiles. (Bucket selection by observed load is
        # per-variant only across namespaces: metrics are queried by
        # (model, namespace), the same granularity as the reference, so
        # same-namespace variants of one model see a blended series.) The
        # SLO target is duplicated onto the key; `classes` is rebuilt every
        # cycle.
        model_key = f"{va.spec.model_id}@{va.full_name}"
        for sc in classes:
            if sc.name == class_name and sc.target_for(model_key) is None:
                sc.model_targets.append(dataclasses.replace(target, model=model_key))

        # predictive scaling: feed this cycle's observed λ into the
        # forecaster and size scale-UP against max(observed, forecast
        # upper band) at the spin-up horizon — capacity requested now
        # serves only one spin-up latency from now, so the rate to
        # provision for is the one the forecast sees there. Asleep
        # variants participate too: gateway demand is a real arrival
        # series and the wake-up decision benefits from its trend.
        lam_sizing = current.load.arrival_rate
        rec.sizing_rpm = lam_sizing
        if self.forecaster is not None:
            from inferno_tpu_torch.config.tpu_catalog import spinup_seconds

            self.forecaster.observe(
                va.full_name, self.clock(), current.load.arrival_rate
            )
            acc_now = current.accelerator or matching_profiles[0].acc
            # horizon = spin-up latency + one reconcile interval: a ramp
            # breach just after this decision is only re-decided one
            # interval from now, and THAT capacity serves one spin-up
            # later still — so this cycle must cover demand through
            # interval + spin-up (same horizon the closed-loop scenario
            # validates, emulator/experiment.py)
            horizon = spinup_seconds(acc_now) + report.interval_seconds
            fc = self.forecaster.forecast(va.full_name, horizon)
            rec.forecast_rpm = fc.rate
            rec.forecast_upper_rpm = fc.upper
            rec.forecast_band_rpm = fc.band
            rec.forecast_horizon_s = horizon
            rec.forecast_burst = fc.burst
            self.forecast_instruments.set_forecast(
                va.namespace,
                va.name,
                fc.rate,
                fc.band,
                self.forecaster.realized_abs_error(va.full_name),
            )
            if fc.valid and fc.upper > lam_sizing:
                lam_sizing = fc.upper
                rec.sizing_rpm = lam_sizing
                rec.rate_provenance = RATE_PROVENANCE_FORECAST

        # profile correction: feed this cycle's observation, compute the
        # current slice shape's corrected parms once, and carry the
        # multiplicative residual onto the other candidate shapes (their
        # miscalibration is assumed systematic; only the running shape has
        # direct telemetry)
        corr_key = ""
        corr_decode = corr_prefill = corr_state = None
        # no latency telemetry exists while asleep: a zeroed observation
        # would corrupt the running correction state
        if self.corrector is not None and not asleep:
            from inferno_tpu_torch.models.corrector import Observation

            acc_now = current.accelerator or matching_profiles[0].acc
            corr_key = f"{va.full_name}@{acc_now}"
            replicas = max(current.num_replicas, 1)
            self.corrector.observe(
                corr_key,
                Observation(
                    concurrency=validation.running / replicas,
                    in_tokens=current.load.avg_input_tokens,
                    out_tokens=current.load.avg_output_tokens,
                    itl_ms=current.itl_average,
                    ttft_ms=current.ttft_average,
                ),
            )

        for prof in matching_profiles:
            perf = prof.to_perf_spec(
                model_key, avg_in_tokens=current.load.avg_input_tokens
            )
            if self.corrector is not None and f"{va.full_name}@{prof.acc}" == corr_key:
                corr_decode, corr_prefill, corr_state = self.corrector.corrected_parms(
                    corr_key, perf.decode_parms, perf.prefill_parms
                )
                if corr_state.active:
                    report.corrections_active += 1
                    rec.profile_provenance = PROVENANCE_CORRECTED
                    self.log.info(
                        "profile correction active for %s: decode x%.2f "
                        "prefill x%.2f (surrogate=%s, %d obs)",
                        corr_key, corr_state.decode_ratio,
                        corr_state.prefill_ratio, corr_state.surrogate_used,
                        corr_state.observations,
                    )
                    perf.decode_parms, perf.prefill_parms = corr_decode, corr_prefill
            spec.models.append(perf)

        # the parameters sizing actually runs with for the CURRENT slice
        # shape (post-corrector), onto the record — the flight recorder's
        # "corrected profile parms" column and the scoreboard's
        # prediction provenance
        acc_cur = current.accelerator or matching_profiles[0].acc
        for perf in spec.models[-len(matching_profiles):]:
            if perf.acc == acc_cur:
                rec.decode_alpha = perf.decode_parms.alpha
                rec.decode_beta = perf.decode_parms.beta
                rec.prefill_gamma = perf.prefill_parms.gamma
                rec.prefill_delta = perf.prefill_parms.delta
                break

        if corr_state is not None and corr_state.active:
            # the running shape has direct telemetry; the other candidate
            # shapes carry the multiplicative residual (assumed systematic)
            for perf in spec.models[-len(matching_profiles):]:
                if f"{va.full_name}@{perf.acc}" == corr_key:
                    continue  # already surrogate/ratio-corrected directly
                perf.decode_parms = dataclasses.replace(
                    perf.decode_parms,
                    alpha=perf.decode_parms.alpha * corr_state.decode_ratio,
                    beta=perf.decode_parms.beta * corr_state.decode_ratio,
                )
                if corr_state.prefill_ratio != 1.0:
                    perf.prefill_parms = dataclasses.replace(
                        perf.prefill_parms,
                        gamma=perf.prefill_parms.gamma * corr_state.prefill_ratio,
                        delta=perf.prefill_parms.delta * corr_state.prefill_ratio,
                    )

        # server entry (reference AddServerInfoToSystemData: utils.go:237-311)
        min_replicas = 0 if self.config.scale_to_zero else 1
        spec.servers.append(
            ServerSpec(
                name=va.full_name,
                class_name=class_name,
                model=model_key,
                # pinned across cycles by default (the reference hardcodes
                # this, utils.go:290); KEEP_ACCELERATOR=false enables
                # economic migration between slice shapes
                keep_accelerator=self.config.keep_accelerator,
                min_num_replicas=min_replicas,
                current_alloc=AllocationData(
                    accelerator=current.accelerator,
                    num_replicas=current.num_replicas,
                    max_batch=current.max_batch,
                    cost=current.variant_cost,
                    itl_average=current.itl_average,
                    ttft_average=current.ttft_average,
                    # the sizing rate: observed λ, or the forecast upper
                    # band when predictive scaling found it higher (the
                    # OBSERVED rate still lands in VA status/telemetry
                    # via current_alloc above)
                    load=ServerLoadSpec(
                        arrival_rate=lam_sizing,
                        avg_in_tokens=int(current.load.avg_input_tokens),
                        avg_out_tokens=int(current.load.avg_output_tokens),
                    ),
                ),
            )
        )
        return True

    # -- the cycle ----------------------------------------------------------

    def run_cycle(self) -> CycleReport:
        """One reconcile cycle. The returned report carries a span trace
        (collect -> analyze -> solve -> actuate) and one DecisionRecord
        per variant seen; both are also retained on the trace ring buffer
        for /debug/decisions and emitted as structured log events."""
        profiler = None
        if self.config.cycle_profiler:
            from inferno_tpu_torch.obs.profiler import CycleProfiler

            profiler = CycleProfiler(
                sample_malloc=self.config.profiler_tracemalloc
            ).activate()
        # cpu=True only under the profiler: the plain trace document
        # stays byte-identical to the pre-profiler format
        tracer = Tracer("reconcile-cycle", cpu=profiler is not None)
        report = CycleReport(interval_seconds=self.config.interval_seconds)
        try:
            self._cycle(tracer, report)
        finally:
            # every exit path — happy, early-return, raise — finishes the
            # trace, records the cycle histogram, and publishes the
            # heartbeat; an unexplainable cycle is the bug this PR removes
            self._finish_cycle(tracer, report, profiler)
        return report

    def _cycle(self, tracer: Tracer, report: CycleReport) -> None:
        # one counting view per cycle (wraps whatever self.prom is NOW,
        # so tests that swap the client mid-flight still count)
        prom = _CountingProm(self.prom)
        try:
            self._cycle_inner(tracer, report, prom)
        finally:
            report.prom_queries = prom.count
            self.instruments.count_prom_queries(prom.count)

    def _cycle_inner(
        self, tracer: Tracer, report: CycleReport, prom: _CountingProm
    ) -> None:
        with tracer.span("collect") as sp:
            engine = engine_for(self.config.engine)
            try:
                # _read_cm absorbs NotFound only; a transient apiserver
                # 500/timeout must be recorded and retried next cycle like
                # the VA-list failure below, never crash run_forever (the
                # staleness heartbeat assumes the loop survives errors)
                report.interval_seconds = self.read_interval()
                accelerators = {a.name: a for a in self.read_accelerators()}
                classes = self.read_service_classes()
                optimizer_spec, capacity = self.read_optimizer_and_capacity()
            except KubeError as e:
                report.errors.append(f"config: {e}")
                report.optimization_ok = False
                sp.set(error=str(e))
                return

            try:
                vas = [va for va in self.kube.list_variant_autoscalings() if va.active]
            except KubeError as e:
                report.errors.append(f"list: {e}")
                report.optimization_ok = False
                sp.set(error=str(e))
                return
            if self.shard_map is not None:
                # sharded controller: reconcile only the
                # variants the rendezvous hash assigns to this member.
                # Export the full partition's ownership counts — a pure
                # function of (membership, listed fleet), so every
                # replica publishes identical inferno_shard_owned_servers
                # series and dashboards need not join across scrapes.
                buckets = self.shard_map.partition(va.full_name for va in vas)
                for member, names in buckets.items():
                    self.event_instruments.observe_shard(member, len(names))
                mine = set(buckets[self.shard_name])
                vas = [va for va in vas if va.full_name in mine]
            report.variants_seen = len(vas)
            sp.set(variants_seen=len(vas), accelerators=len(accelerators))
            # deleted variants: drop their telemetry state, gauge series,
            # and per-variant latency-histogram series (leaving frozen
            # gauges would keep external actuators acting on a variant
            # that no longer exists)
            active = {(va.namespace, va.name) for va in vas}
            self.emitter.prune_variants(active)
            self.instruments.prune_variants(active)
            self.forecast_instruments.prune_variants(active)
            self.attainment_instruments.prune_variants(active)
            self.attainment.prune({va.full_name for va in vas})
            if self.corrector is not None:
                self.corrector.prune({va.full_name for va in vas})
            # forecaster/stabilizer state is keyed by variant full name:
            # a deleted VA must not leave a rate history or a
            # stabilization peak behind (unbounded per-variant state)
            if self.forecaster is not None:
                self.forecaster.prune({va.full_name for va in vas})
            if self.stabilizer is not None:
                self.stabilizer.prune({va.full_name for va in vas})
            if self.sizing_cache is not None:
                self.sizing_cache.prune({va.full_name for va in vas})

            # coalesced Prometheus collection: ~Q grouped queries cover
            # the whole fleet; per-variant fallback handles the rest. A
            # grouped failure (None) degrades to the per-variant path.
            fleet: FleetSamples | None = None
            if self.config.grouped_collection and vas:
                scrape_t0 = time.perf_counter()
                fleet = collect_fleet_samples(
                    prom, engine,
                    {(va.spec.model_id, va.namespace) for va in vas},
                )
                self.instruments.observe_scrape(time.perf_counter() - scrape_t0)
                if fleet is None:
                    # not silent: an operator watching
                    # inferno_cycle_prom_queries_total spike to Q x V
                    # deserves the reason in the log stream
                    self.log.warning(
                        "grouped collection failed; degrading to "
                        "per-variant queries this cycle"
                    )
                sp.set(
                    grouped_queries=fleet.queries_issued if fleet else 0,
                    grouped_variants=(
                        sum(1 for va in vas
                            if fleet.has(va.spec.model_id, va.namespace))
                        if fleet else 0
                    ),
                )
        if not vas:
            return

        spec = SystemSpec(
            accelerators=list(accelerators.values()),
            service_classes=classes,
            optimizer=optimizer_spec,
            capacity=capacity,
        )
        prepared: list[VariantAutoscaling] = []
        with tracer.span("analyze") as sp:
            # SLO lookup up front on the reconcile thread: _find_slo reads
            # `classes`, which assembly mutates per variant — workers must
            # never race that (and the fallback warnings stay ordered)
            slos = {va.full_name: self._find_slo(classes, va) for va in vas}
            workers = min(self.config.reconcile_concurrency, max(len(vas), 1))
            self.instruments.observe_collect_concurrency(workers)
            sp.set(collect_concurrency=workers)
            collected: list[_Collected] | None = None
            if workers > 1:
                # bounded-concurrency collect on the PERSISTENT pool:
                # submit in variant order, harvest in variant order. A
                # failed future degrades to that variant's error path,
                # never the cycle's.
                pool = self._executor()
                futures = [
                    pool.submit(
                        self._collect_variant, va, engine, prom, fleet,
                        slos[va.full_name], accelerators,
                    )
                    for va in vas
                ]
                collected = []
                for va, fut in zip(vas, futures):
                    try:
                        collected.append(fut.result())
                    except Exception as e:  # noqa: BLE001 — isolation
                        rec = DecisionRecord(
                            variant=va.full_name, namespace=va.namespace,
                            name=va.name, model=va.spec.model_id,
                            detail=f"collect: {e}",
                        )
                        collected.append(_Collected(
                            rec=rec, ok=False,
                            errors=[f"{va.full_name}: collect: {e}"],
                        ))
            for i, va in enumerate(vas):
                t0 = time.perf_counter()
                with tracer.span("variant", variant=va.full_name) as vsp:
                    if collected is None:
                        c = self._collect_variant(
                            va, engine, prom, fleet,
                            slos[va.full_name], accelerators,
                        )
                    else:
                        c = collected[i]
                        vsp.set(collect_ms=round(c.elapsed_s * 1000.0, 3))
                    ok = self._assemble_variant(c, va, classes, spec, report)
                    vsp.set(prepared=ok)
                assemble_s = time.perf_counter() - t0
                self.instruments.observe_analysis(
                    va.namespace, va.name,
                    assemble_s + (c.elapsed_s if collected is not None else 0.0),
                )
                if ok:
                    prepared.append(va)
            sp.set(variants_prepared=len(prepared))
        report.variants_prepared = len(prepared)
        if not prepared:
            return

        system = System(spec)
        with tracer.span("solve", backend=self.config.compute_backend) as sp:
            t0 = time.perf_counter()
            try:
                cached_names, signatures = self._replay_sizing_cache(system)
                to_size = (
                    None  # size everything (cache off)
                    if self.sizing_cache is None
                    else {n for n in system.servers if n not in cached_names}
                )
                if to_size is None or to_size:
                    if self.config.compute_backend != "scalar":
                        # both batched backends (cuda, torch) route
                        # through the vectorized fleet pipeline; "scalar"
                        # is the explicit parity oracle
                        from inferno_tpu_torch.parallel import calculate_fleet

                        # SIZING_CACHE and INCREMENTAL_CYCLE are
                        # ALTERNATIVE skip layers: with the cache on,
                        # sizing runs over the cache-miss subset
                        # (`only=to_size`) and calculate_fleet routes
                        # that through the full path — the incremental
                        # cycle engages only with the cache off. The λ
                        # tolerance semantics stay consistent either way
                        # because both layers compare through ONE
                        # predicate (config.defaults.
                        # rate_within_tolerance, pinned in tests);
                        # prefer INCREMENTAL_CYCLE at fleet scale — its
                        # skip covers fold, writeback, and solve, not
                        # just the sizing replay (docs/performance.md).
                        event_dirty = self._drain_event_dirty(system)
                        calculate_fleet(
                            system, backend=self.config.compute_backend,
                            device=self.config.compute_device,
                            only=to_size, event_dirty=event_dirty,
                        )
                        self._publish_dirty(system)
                        self._remark_event_dirty(system, event_dirty)
                    else:
                        system.calculate_all(only=to_size)
                else:
                    # every variant replayed: nothing to pack or solve
                    system.candidates_calculated = True
                self._store_sizing_cache(
                    system, to_size, cached_names, signatures, report
                )
                report.analysis_ms = (time.perf_counter() - t0) * 1000.0
                result = Optimizer(optimizer_spec).optimize(system, calculate=False)
                report.solver_ms = result.solution_time_msec
                solution = result.solution
            except Exception as e:  # optimization failed: mark all, retry next cycle
                # (reference: controller.go:168-186)
                report.optimization_ok = False
                report.errors.append(f"optimize: {e}")
                sp.set(error=str(e))
                prepared_names = {va.full_name for va in prepared}
                for rec in report.decisions:
                    if rec.variant in prepared_names:
                        rec.decide(REASON_ERROR, detail=f"optimization failed: {e}")
                for va in prepared:
                    if not self.gate():
                        report.errors.append("leadership lost; stopping status writes")
                        break
                    va.status.set_condition(
                        TYPE_OPTIMIZATION_READY, "False", REASON_OPTIMIZATION_FAILED, str(e)
                    )
                    try:
                        self.kube.update_variant_autoscaling_status(va)
                    except KubeError:
                        pass
                return
            self.instruments.observe_solver(report.solver_ms / 1000.0)
            sp.set(
                sizing_ms=round(report.analysis_ms, 3),
                solver_ms=round(report.solver_ms, 3),
            )
            self._publish_spot(system)

        with tracer.span("actuate") as sp:
            self._apply(prepared, solution, report, system)
            sp.set(variants_applied=report.variants_applied)

    def _drain_event_dirty(self, system: System) -> list[str] | None:
        """The targeted cycle's dirty set: drain the coalesced event
        queue after folding in the λ-delta source. Returns None — run
        the full poll scan — when targeting is disabled
        (EVENT_TARGETED_CYCLE=0), after a config-change `mark_all`, or
        on the queue's periodic anti-entropy cadence.

        The λ-delta source is the collect stage itself: each cycle's
        per-variant load signature (arrival rate, token mix — the
        grouped collector's output) is diffed against the previous
        cycle's and movers are marked. Combined with the Watcher's VA
        marks and `_remark_event_dirty` (actuation changes current
        allocations), every mutation path THIS controller can see is an
        event source; external drift (kubectl scale, a missed watch
        event) is bounded by the anti-entropy full scan."""
        from inferno_tpu_torch.config.defaults import env_flag

        if not env_flag("EVENT_TARGETED_CYCLE", True):
            return None
        from inferno_tpu_torch.controller.watch import SOURCE_LAMBDA

        prev = self._prev_load_sig
        cur: dict[str, tuple | None] = {}
        moved: list[str] = []
        for name, server in system.servers.items():
            load = server.load
            sig = None if load is None else (
                load.arrival_rate, load.avg_in_tokens, load.avg_out_tokens
            )
            cur[name] = sig
            if name not in prev or prev[name] != sig:
                moved.append(name)
        self._prev_load_sig = cur
        q = self.dirty_queue
        if moved:
            q.mark(moved, source=SOURCE_LAMBDA, wake=False)
        self.event_instruments.observe_drain(q.depth())
        return q.drain()

    def _remark_event_dirty(self, system: System, event_dirty) -> None:
        """Re-mark this cycle's dirty variants for the NEXT cycle: the
        actuation that follows may change their current allocations, and
        an event-authoritative scan would otherwise not re-read them
        (stale transition penalties until anti-entropy). Converges: a
        variant that comes back CLEAN stops being re-marked."""
        if event_dirty is None:
            return
        fd = getattr(system, "fleet_dirty", None)
        if fd is None or not len(fd.dirty_pos):
            return
        from inferno_tpu_torch.controller.watch import SOURCE_ACTUATE

        names = list(system.servers)
        self.dirty_queue.mark(
            (names[p] for p in fd.dirty_pos.tolist()),
            source=SOURCE_ACTUATE,
            wake=False,
        )

    def _publish_dirty(self, system: System) -> None:
        """Publish the incremental cycle's dirty outcome
        (inferno_cycle_dirty_*). A cycle that ran the full
        path (INCREMENTAL_CYCLE=0, sizing-cache subset, non-jitted
        backend) carries no dirty info and publishes nothing."""
        fd = getattr(system, "fleet_dirty", None)
        if fd is None:
            return
        per_variant: list[tuple[str, str, bool]] = []
        for pos, name in enumerate(system.servers):
            # server key = VariantAutoscaling.full_name = "name:namespace"
            short, _, ns = name.partition(":")
            per_variant.append((ns, short, bool(fd.codes[pos])))
        self.instruments.set_dirty_outcome(
            fd.dirty_lanes, fd.skipped_servers, per_variant
        )

    def _publish_spot(self, system: System) -> None:
        """Per-pool spot gauges from the solved placement, and the
        next-cycle preemption-detection baseline. Pools that stopped
        placing spot read 0 (an operator must see the drain); with no
        tier configured anywhere this is a no-op beyond zeroing."""
        if not getattr(system, "spot", None):
            if self._prev_spot:
                self._prev_spot = {}
                self.spot_instruments.zero_missing_pools(set())
            return
        from inferno_tpu_torch.spot.market import headroom_chips

        usage = system.allocate_by_pool()
        live: set[str] = set()
        for pool, spec in system.spot.items():
            u = usage.get(pool)
            spot_replicas = u.spot_replicas if u else 0
            spot_chips = u.spot_chips if u else 0
            self.spot_instruments.set_pool(
                pool, spot_replicas,
                headroom_chips(spec.blast_radius, spot_chips),
            )
            live.add(pool)
        self.spot_instruments.zero_missing_pools(live)
        self._prev_spot = {}
        for name, server in system.servers.items():
            alloc = server.allocation
            if alloc is None or not alloc.accelerator:
                continue
            acc = system.accelerators.get(alloc.accelerator)
            self._prev_spot[name] = (
                # eviction-detection baseline: what was BOTH running and
                # desired (see _assemble_variant's detector)
                min(alloc.num_replicas, server.cur_allocation.num_replicas),
                alloc.spot_replicas,
                acc.pool if acc is not None else "",
            )

    # -- sizing cache (controller/sizing_cache.py) ---------------------------

    def _replay_sizing_cache(
        self, system: System
    ) -> tuple[set[str], dict[str, tuple | None]]:
        """Populate all_allocations from the cache for every server whose
        input signature is unchanged; returns the replayed names and the
        per-server signatures (for the post-solve store)."""
        if self.sizing_cache is None:
            return set(), {}
        from inferno_tpu_torch.controller.sizing_cache import (
            server_signature,
            system_fingerprint,
        )

        self.sizing_cache.reset_cycle_counts()
        global_fp = system_fingerprint(system)
        signatures: dict[str, tuple | None] = {}
        cached: set[str] = set()
        for name, server in system.servers.items():
            sig = server_signature(server, system, global_fp)
            signatures[name] = sig
            if sig is None:
                continue
            lam = server.load.arrival_rate if server.load is not None else 0.0
            allocs = self.sizing_cache.lookup(name, sig, lam, server.cur_allocation)
            if allocs is not None:
                server.all_allocations = allocs
                cached.add(name)
        return cached, signatures

    def _store_sizing_cache(
        self,
        system: System,
        to_size: set[str] | None,
        cached_names: set[str],
        signatures: dict[str, tuple | None],
        report: CycleReport,
    ) -> None:
        """Store freshly solved candidates, publish hit/miss telemetry,
        and stamp `cached` sizing provenance onto the replayed variants'
        DecisionRecords."""
        if self.sizing_cache is None:
            return
        for name in (to_size or ()):
            server = system.servers.get(name)
            sig = signatures.get(name)
            if server is None or sig is None:
                continue
            lam = server.load.arrival_rate if server.load is not None else 0.0
            self.sizing_cache.store(name, sig, lam, server.all_allocations)
        report.sizing_cache_hits = self.sizing_cache.hits
        report.sizing_cache_misses = self.sizing_cache.misses
        self.instruments.set_cache_outcome(
            self.sizing_cache.hits, self.sizing_cache.misses
        )
        for rec in report.decisions:
            if rec.variant in cached_names:
                rec.sizing_provenance = SIZING_PROVENANCE_CACHED

    def _finish_cycle(
        self, tracer: Tracer, report: CycleReport, profiler=None
    ) -> None:
        """Seal the cycle's observability outputs: attainment scoring,
        trace, profile document, histogram, decision log events,
        ring-buffer entries, readiness heartbeat."""
        root = tracer.finish()
        report.trace = root
        self.instruments.observe_cycle(root.duration_ms / 1000.0)
        # one timestamp rendering for every per-cycle artifact (profile
        # document, trace ring entry, recorder meta) — they must never
        # disagree on when the cycle started
        started_iso = time.strftime(
            "%Y-%m-%dT%H:%M:%SZ", time.gmtime(tracer.started_at)
        )
        if profiler is not None:
            from inferno_tpu_torch.obs.profiler import build_profile_doc

            profiler.deactivate()
            # fold in the cycle-report counters the sites don't see:
            # the sizing cache counts are tallied by the cache itself and
            # the prom-query count by the per-cycle counting wrapper
            profiler.counters["prom_queries"] = report.prom_queries
            if self.sizing_cache is not None:
                profiler.counters["sizing_cache_hits"] = report.sizing_cache_hits
                profiler.counters["sizing_cache_misses"] = (
                    report.sizing_cache_misses
                )
            report.profile = build_profile_doc(
                root, profiler,
                started_at=started_iso,
                interval_seconds=report.interval_seconds,
            )
            self.profiles.append(report.profile)
            self.profiler_instruments.observe_profile(
                report.profile, report.interval_seconds
            )
        # model-error / SLO-attainment scoreboard: score last cycle's
        # prediction against this cycle's observation and store this
        # cycle's prediction — BEFORE the records are logged/retained,
        # so the error fields ride every downstream copy
        for rec in report.decisions:
            # a stabilization hold actuates the held PEAK count, not the
            # size the prediction was computed for — storing that
            # prediction would score next cycle's held-size telemetry
            # against a different operating point and report spurious
            # model drift through every scale-down window (the same
            # reason replay parity skips holds)
            held = rec.reason == REASON_STABILIZATION_HOLD
            score = self.attainment.observe(
                rec.variant,
                predicted_ttft_ms=0.0 if held else rec.ttft_predicted_ms,
                predicted_itl_ms=0.0 if held else rec.itl_predicted_ms,
                observed_ttft_ms=rec.ttft_observed_ms,
                observed_itl_ms=rec.itl_observed_ms,
                slo_ttft_ms=rec.slo_ttft_ms,
                slo_itl_ms=rec.slo_itl_ms,
            )
            rec.ttft_model_error_ms = score.ttft_error_ms or 0.0
            rec.itl_model_error_ms = score.itl_error_ms or 0.0
            rec.ttft_model_error_ewma_ms = score.ttft_error_ewma_ms
            rec.itl_model_error_ewma_ms = score.itl_error_ewma_ms
            self.attainment_instruments.set_score(rec.namespace, rec.name, score)
        for rec in report.decisions:
            kv(self.log, logging.INFO, "decision", **rec.to_dict())
        self.traces.append(
            {
                "started_at": started_iso,
                "duration_ms": round(root.duration_ms, 3),
                "optimization_ok": report.optimization_ok,
                "errors": list(report.errors),
                "spans": root.to_dict(),
                "decisions": [rec.to_dict() for rec in report.decisions],
            }
        )
        # stale-controller detection (metrics._probe_routes): readiness
        # fails when the newest heartbeat is older than 3x the interval
        self._heartbeat(report.interval_seconds)

    def _heartbeat(self, interval_seconds: int) -> None:
        """Refresh the readiness staleness heartbeat (cycle completion or
        non-leader standby idle). Reads `self.clock` (default wall
        monotonic, matching the probe's comparison clock) — injectable,
        so the INF005 allowlist entry for this method is gone."""
        if self.ready_flag is not None:
            self.ready_flag["last_cycle_monotonic"] = self.clock()
            self.ready_flag["max_cycle_age_s"] = 3.0 * max(interval_seconds, 1)

    def _apply(
        self,
        prepared: list[VariantAutoscaling],
        solution: dict[str, Any],
        report: CycleReport,
        system: System | None = None,
    ) -> None:
        """(reference applyOptimizedAllocations: controller.go:338-407)
        Also completes each prepared variant's DecisionRecord: the solved
        allocation (or its absence) is the decision being explained.

        With RECONCILE_CONCURRENCY > 1 the per-variant refetch + status
        writes + actuation run on a bounded pool (variants are
        independent Kube objects); outcomes merge back in variant-list
        order so report.errors and applied counts stay deterministic. A
        failed future is that variant's error path, never the cycle's.
        """
        now = _utcnow()
        recs = {r.variant: r for r in report.decisions}
        workers = min(self.config.reconcile_concurrency, max(len(prepared), 1))
        if workers > 1:
            pool = self._executor()
            futures = [
                pool.submit(
                    self._apply_one, va, recs.get(va.full_name),
                    solution.get(va.full_name), now, system,
                )
                for va in prepared
            ]
            gate_lost = False
            for va, fut in zip(prepared, futures):
                try:
                    errors, applied, lost = fut.result()
                except Exception as e:  # noqa: BLE001 — isolation
                    errors, applied, lost = (
                        [f"{va.full_name}: apply: {e}"], False, False,
                    )
                    rec = recs.get(va.full_name)
                    if rec is not None:
                        rec.decide(REASON_ERROR, detail=f"apply: {e}")
                report.errors.extend(errors)
                if applied:
                    report.variants_applied += 1
                gate_lost = gate_lost or lost
            if gate_lost:
                report.errors.append(
                    "leadership lost mid-cycle; aborting actuation and "
                    "status writes"
                )
            return
        for i, va in enumerate(prepared):
            if not self.gate():
                report.errors.append(
                    "leadership lost mid-cycle; aborting actuation and status writes"
                )
                # every not-yet-applied variant gets the explanation — not
                # just the one being processed: an operator reading
                # /debug/decisions must see "handoff", not bare errors
                for later in prepared[i:]:
                    lrec = recs.get(later.full_name)
                    if lrec is not None:
                        lrec.detail = "leadership lost mid-cycle; decision not actuated"
                return
            errors, applied, _ = self._apply_one(
                va, recs.get(va.full_name), solution.get(va.full_name), now, system
            )
            report.errors.extend(errors)
            if applied:
                report.variants_applied += 1

    def _apply_one(
        self,
        va: VariantAutoscaling,
        rec: DecisionRecord | None,
        alloc,
        now: str,
        system: System | None,
    ) -> tuple[list[str], bool, bool]:
        """Apply one variant's decision: refetch, stabilize, write status
        and conditions, emit actuation metrics. Returns (errors, applied,
        gate_lost); safe to run on a pool worker — touches only this
        variant's objects plus the thread-safe emitter/stabilizer."""
        errors: list[str] = []
        if not self.gate():
            # deposed mid-cycle: the new leader owns this write
            if rec is not None:
                rec.detail = "leadership lost mid-cycle; decision not actuated"
            return errors, False, True
        try:
            fresh = self.kube.get_variant_autoscaling(va.namespace, va.name)
        except KubeError as e:
            errors.append(f"{va.full_name}: refetch: {e}")
            if rec is not None:
                rec.decide(REASON_ERROR, detail=f"refetch: {e}")
            return errors, False, False
        fresh.status = va.status
        if alloc is not None:
            # scale-down stabilization (forecast/stabilizer.py): act
            # on the PEAK recommendation within the trailing window —
            # upscales pass through, downscales wait until every
            # higher recommendation has aged out (HPA scaleDown
            # stabilization semantics). Gated here, at the single
            # point the solver's answer becomes the actuated desired,
            # so the direct-scale path, the emitted gauges, and the
            # CR status all see the same stabilized count.
            desired = alloc.num_replicas
            held = False
            if self.stabilizer is not None:
                # keyed by variant AND slice shape: replica counts
                # are not comparable across a shape migration
                # (keep_accelerator=false) — 3x v5e-16 after 8x
                # v5e-8 is a shape change, not a scale-down to gate.
                # A migration therefore starts a fresh window; stale
                # shape keys are pruned with the variant.
                desired, held = self.stabilizer.recommend(
                    f"{va.full_name}@{alloc.accelerator}",
                    alloc.num_replicas,
                    self.clock(),
                )
            fresh.status.desired_optimized_alloc.accelerator = alloc.accelerator
            fresh.status.desired_optimized_alloc.num_replicas = desired
            fresh.status.desired_optimized_alloc.last_run_time = now
            fresh.status.set_condition(
                TYPE_OPTIMIZATION_READY,
                "True",
                REASON_OPTIMIZATION_SUCCEEDED,
                "optimization completed",
            )
            if rec is not None:
                self._explain_decision(rec, va.full_name, alloc, system)
                if held:
                    rec.decide(
                        REASON_STABILIZATION_HOLD,
                        accelerator=alloc.accelerator,
                        replicas=desired,
                        detail=(
                            f"scale-down gated: solver recommended "
                            f"{alloc.num_replicas} but the peak within the "
                            f"{self.config.scale_down_stabilization_s:.0f}s "
                            f"stabilization window is {desired}"
                        ),
                    )
        else:
            # squeezed out (capacity exhausted / SLO unachievable): the
            # decision this cycle is the minimum — leaving the stale
            # desired from an earlier cycle standing would keep the
            # variant scaled out on chips the solver just reassigned to
            # higher-priority classes. Floor at 1 unless scale-to-zero
            # is enabled: scaling to 0 kills the engine's metric
            # series, which would keep the variant out of the solver
            # (metrics unavailable) even after capacity frees — a
            # stranding loop.
            # exactly the minimum, not min(stale, floor): a fresh VA's
            # stale desired is 0, and clamping against it would scale a
            # never-optimized variant to zero with scale-to-zero off
            floor = 0 if self.config.scale_to_zero else 1
            fresh.status.desired_optimized_alloc.num_replicas = floor
            fresh.status.desired_optimized_alloc.last_run_time = now
            fresh.status.set_condition(
                TYPE_OPTIMIZATION_READY,
                "False",
                REASON_OPTIMIZATION_FAILED,
                "no feasible allocation (SLO unachievable or capacity exhausted)",
            )
            if rec is not None:
                detail = (
                    "no feasible allocation "
                    "(SLO unachievable or capacity exhausted)"
                )
                degr = (
                    getattr(system, "degradations", {}).get(va.full_name)
                    if system is not None
                    else None
                )
                if degr is not None:
                    rec.degradation_step = degr.step
                    rec.chip_shortfall = degr.shortfall_chips
                    detail = (
                        f"zeroed by capacity: preferred "
                        f"{degr.from_accelerator} x{degr.from_replicas} "
                        f"short {degr.shortfall_chips} chips in pool "
                        f"{degr.pool}"
                    )
                rec.decide(REASON_CAPACITY_LIMITED, replicas=floor, detail=detail)
        try:
            self.actuator.emit_metrics(fresh)
            fresh.status.actuation_applied = True
        except KubeError as e:
            # metric emission failure must not fail the cycle
            # (reference: actuator.go:69-74)
            errors.append(f"{va.full_name}: actuate: {e}")
            fresh.status.actuation_applied = False
        applied = False
        try:
            self.kube.update_variant_autoscaling_status(fresh)
            applied = True
        except KubeError as e:
            errors.append(f"{va.full_name}: status: {e}")
        return errors, applied, False

    def _explain_decision(
        self, rec: DecisionRecord, server_name: str, alloc, system: System | None
    ) -> None:
        """Fill a DecisionRecord from the solved allocation. Reason-code
        semantics: `asleep` when the variant was sized from gateway demand
        at zero replicas; `slo_bound` when load pushed the replica count
        above the configured floor (the SLO ceiling λ_max dictated N);
        `cost_bound` when the variant sits at its floor and the choice was
        purely cost-minimal."""
        import math

        server = system.servers.get(server_name) if system is not None else None
        chosen = server.allocation if server is not None else None
        min_replicas = server.min_num_replicas if server is not None else 1
        # capacity degradation (limited mode): the solver stepped this
        # variant down the graceful-degradation ladder — that IS the
        # decision, whatever the replica arithmetic below would say
        degr = (
            getattr(system, "degradations", {}).get(server_name)
            if system is not None
            else None
        )
        rec.spot_replicas = alloc.spot_replicas
        if degr is not None:
            rec.degradation_step = degr.step
            rec.chip_shortfall = degr.shortfall_chips
            rec.decide(
                REASON_CAPACITY_LIMITED,
                accelerator=alloc.accelerator,
                replicas=alloc.num_replicas,
                detail=(
                    f"capacity degradation ({degr.step}): preferred "
                    f"{degr.from_accelerator} x{degr.from_replicas} short "
                    f"{degr.shortfall_chips} chips in pool {degr.pool}; "
                    f"allocated {alloc.accelerator} x{alloc.num_replicas}"
                ),
            )
            rec.ttft_predicted_ms = alloc.ttft_average
            rec.itl_predicted_ms = alloc.itl_average
            rec.ttft_headroom_ms = rec.slo_ttft_ms - alloc.ttft_average
            rec.itl_headroom_ms = rec.slo_itl_ms - alloc.itl_average
            rec.cost = alloc.cost
            rec.cost_delta = alloc.cost - rec.prev_cost
            if chosen is not None:
                rec.lambda_max_rpm = chosen.max_rpm
            return
        # forecast_bound: the forecast upper band (not the observed λ)
        # was the binding sizing input — observed load alone would have
        # needed strictly fewer replicas at the chosen λ_max ceiling
        forecast_bound = (
            rec.rate_provenance == RATE_PROVENANCE_FORECAST
            and chosen is not None
            and chosen.max_rpm > 0
            and alloc.num_replicas > math.ceil(rec.arrival_rpm / chosen.max_rpm)
        )
        if rec.asleep:
            reason = REASON_ASLEEP
            detail = "scaled to zero; sized from gateway demand"
        elif forecast_bound and alloc.num_replicas > min_replicas:
            reason = REASON_FORECAST_BOUND
            detail = (
                "replicas sized by the forecast upper band at the spin-up "
                f"horizon ({rec.forecast_upper_rpm:.1f} rpm over observed "
                f"{rec.arrival_rpm:.1f} rpm)"
            )
        elif chosen is not None and chosen.spot_trimmed:
            reason = REASON_SPOT_RISK_BOUND
            detail = (
                "spot placement capped by eviction risk: "
                f"{alloc.spot_replicas}/{alloc.num_replicas} replicas on the "
                "spot tier (the hazard-implied premium outweighs the "
                "discount for SLO-critical replicas)"
            )
        elif alloc.num_replicas > min_replicas:
            reason = REASON_SLO_BOUND
            detail = "replicas sized by observed load against the SLO ceiling"
        else:
            reason = REASON_COST_BOUND
            detail = "at the replica floor; cost-minimal shape retained"
        rec.decide(
            reason,
            accelerator=alloc.accelerator,
            replicas=alloc.num_replicas,
            detail=detail,
        )
        rec.ttft_predicted_ms = alloc.ttft_average
        rec.itl_predicted_ms = alloc.itl_average
        # headroom = SLO minus prediction (positive = margin); a 0 SLO
        # means the dimension is unconstrained and its headroom is noise
        rec.ttft_headroom_ms = rec.slo_ttft_ms - alloc.ttft_average
        rec.itl_headroom_ms = rec.slo_itl_ms - alloc.itl_average
        rec.cost = alloc.cost
        rec.cost_delta = alloc.cost - rec.prev_cost
        if chosen is not None:
            rec.lambda_max_rpm = chosen.max_rpm

    def run_forever(self, stop_check=lambda: False, gate=lambda: True) -> None:
        """Interval-driven steady state (the reference uses RequeueAfter,
        controller.go:201). `gate` is the leadership check: a non-leader
        idles without reconciling (reference: manager suspends controllers
        until elected)."""
        self.gate = gate
        # initial heartbeat BEFORE the first cycle: a controller that
        # hangs inside cycle #1 (blackholed Prom query after the startup
        # gate passed) must still trip the staleness check — without this
        # stamp the age test never arms and /readyz stays 200 forever
        self._heartbeat(self.config.interval_seconds)
        while not stop_check():
            if not gate():
                # a non-leader standby idles BY DESIGN: refresh the
                # readiness heartbeat so the staleness check (metrics.
                # _probe_routes) doesn't mark a healthy standby not-ready
                # for never cycling
                self._heartbeat(self.config.interval_seconds)
                time.sleep(1)
                continue
            report = self.run_cycle()
            kv(
                self.log,
                logging.ERROR if not report.optimization_ok else logging.INFO,
                "cycle",
                variants_seen=report.variants_seen,
                variants_prepared=report.variants_prepared,
                variants_applied=report.variants_applied,
                corrections_active=report.corrections_active,
                optimization_ok=report.optimization_ok,
                analysis_ms=round(report.analysis_ms, 3),
                solver_ms=round(report.solver_ms, 3),
                errors=report.errors,
            )
            # interval sleep, interruptible by watch events (reference:
            # RequeueAfter steady state + create/ConfigMap triggers)
            woke = self._wake.wait(max(report.interval_seconds, 1))
            if woke:
                # debounce: absorb the rest of the event
                # storm before cycling, so a burst of wakes inside one
                # window produces ONE cycle (their dirty marks coalesce
                # in the queue and drain together) instead of
                # back-to-back full reconciles per event
                debounce = self.dirty_queue.debounce_s
                if debounce > 0:
                    self.sleep(debounce)
            self._wake.clear()
