"""Controller process entry point.

The analogue of the reference's manager main
(upstream cmd/main.go:62-279): env/flag configuration, Prometheus
client with TLS validation, metrics + health endpoints, then the
interval-driven reconcile loop. Leader election: single-replica
deployments need none (the chart default); multi-replica deployments set
LEADER_ELECT=true for lease-based election (wired below, `LeaderElector`).
Either way the loop is stateless, so a restart resumes cleanly from CR
status (SURVEY §5.4).

Environment (reference parity: internal/utils/tls.go:101-118 and
controller.go:516-582):
  PROMETHEUS_BASE_URL           https://... (required; http only with
                                PROMETHEUS_ALLOW_HTTP=true, test envs)
  PROMETHEUS_BEARER_TOKEN[_FILE]
  PROMETHEUS_CA_CERT_PATH, PROMETHEUS_CLIENT_CERT_PATH/KEY_PATH
  PROMETHEUS_TLS_INSECURE_SKIP_VERIFY=true|false
  WVA_SCALE_TO_ZERO=true|false
  CONFIG_NAMESPACE              (default inferno-system)
  SERVING_ENGINE                vllm-tpu | jetstream
  METRICS_PORT                  (default 8443)
  METRICS_TLS_CERT_PATH/KEY_PATH  serve /metrics over TLS, certs reloaded
                                on rotation; plain HTTP when unset
  HEALTH_PORT                   (default 8081; liveness/readiness probes)
  COMPUTE_BACKEND               auto | cuda | torch | scalar
                                (default auto: cuda when a CUDA card is
                                present, else startup fails — the CPU is
                                an explicit choice, COMPUTE_BACKEND=torch
                                COMPUTE_DEVICE=cpu; "scalar" is the
                                per-variant parity oracle, reached only
                                explicitly or via USE_TPU_FLEET=false; the
                                reference's tpu/tpu-pallas/jax/native are
                                rejected)
  COMPUTE_DEVICE                torch device the fleet is sized and the
                                surrogate trained on (default unset = the
                                CUDA card; "cpu" with COMPUTE_BACKEND=torch)
  DIRECT_SCALE                  true|false (default false; HPA otherwise)
  LEADER_ELECT                  true|false (default false; lease-based
                                election for multi-replica deployments)
  PROFILE_CORRECTION            true|false (default true; telemetry-driven
                                recalibration of CR perf profiles —
                                models/corrector.py; false = reference-
                                exact static profiles)
  KEEP_ACCELERATOR              true|false (default true, reference-exact
                                pin of each variant to its current slice
                                shape; false allows economic migration
                                between shapes)
  DECISION_TRACE_BUFFER         how many recent reconcile-cycle traces the
                                metrics listener retains for
                                /debug/decisions (default 32;
                                docs/observability.md)
  RECONCILE_CONCURRENCY         bounded worker pool for per-variant collect
                                and actuation I/O (default 1 = serial;
                                docs/performance.md)
  GROUPED_COLLECTION            true|false (default true): coalesce the
                                collector's Prometheus queries into one
                                per metric for the whole fleet; variants
                                missing from a grouped response fall back
                                to per-variant queries
  SIZING_CACHE                  true|false (default false): reuse candidate
                                allocations for variants whose sizing
                                inputs are unchanged since last cycle
  SIZING_CACHE_TOLERANCE        relative arrival-rate tolerance for sizing-
                                cache hits (default 0.02 = 2%)
  GREEDY_VECTORIZED             true|false (default true): limited-mode
                                solve over the columnar fleet candidate
                                table; 0 forces the scalar reference
                                implementation (bit-identical results;
                                docs/performance.md)
  PROMETHEUS_QUERY_TIMEOUT      per-query timeout in seconds (default 30)
  FLIGHT_RECORDER_DIR           directory for the per-cycle flight-recorder
                                artifact (default unset = recording off).
                                Not ported yet: any other value fails at
                                startup (the recorder comes with the
                                planner slice).
  FLIGHT_RECORDER_MAX_MB        artifact retention budget in MB (default 64;
                                oldest rotation segments deleted beyond it)
  FLIGHT_RECORDER_MAX_AGE_S     segment age before rotation (default 3600)
  ATTAINMENT_EWMA_GAIN          EWMA gain of the SLO-attainment/model-error
                                scoreboard in (0,1] (default 0.2; see
                                /debug/attainment and the
                                inferno_model_error_* gauges)
  CYCLE_PROFILER                true|false (default true): per-cycle cost
                                attribution — phase wall/CPU, jit
                                compile-vs-execute, memo/cache hit counts —
                                served at /debug/profile, exported as
                                inferno_profile_* series, recorded by the
                                flight recorder (docs/observability.md;
                                <=1% overhead, `make bench-profile`)
  PROFILE_TRACEMALLOC           true|false (default false): additionally
                                sample the tracemalloc traced-memory peak
                                per cycle (costs CPU; excluded from the
                                profiler's 1% overhead contract)
  TPU_SPOT_POOLS                fallback for the ConfigMap key of the same
                                name: per-pool preemptible (spot) tiers —
                                discount, eviction hazard, blast radius —
                                for clusterless runs (docs/user-guide/
                                configuration.md; validated at parse time
                                by inferno_tpu/spot/market.py)

Port copy of `inferno_tpu/controller/main.py`, verbatim apart from its
imports, the backend set above, COMPUTE_DEVICE, and the config read moved
into `reconciler_config_from_env()` so that it can be checked without
starting the process.
"""

from __future__ import annotations

import os
import signal
import sys
import time

# Typed env accessors: every environment read in the package
# goes through config/defaults.py so the INF001 config-registry checker
# can diff the live env surface against docs/user-guide/configuration.md.
# env_bool is re-exported here because main() is its historical home and
# tests/deploy tooling import it from this module.
from inferno_tpu_torch.config.defaults import (  # noqa: F401
    env_bool,
    env_float,
    env_int,
    env_str,
)


def prom_config_from_env():
    from inferno_tpu_torch.controller.promclient import PromConfig

    return PromConfig(
        base_url=env_str("PROMETHEUS_BASE_URL"),
        bearer_token=env_str("PROMETHEUS_BEARER_TOKEN"),
        bearer_token_file=env_str("PROMETHEUS_BEARER_TOKEN_FILE"),
        ca_file=env_str("PROMETHEUS_CA_CERT_PATH"),
        client_cert_file=env_str("PROMETHEUS_CLIENT_CERT_PATH"),
        client_key_file=env_str("PROMETHEUS_CLIENT_KEY_PATH"),
        insecure_skip_verify=env_bool("PROMETHEUS_TLS_INSECURE_SKIP_VERIFY"),
        allow_http=env_bool("PROMETHEUS_ALLOW_HTTP"),
        query_timeout_seconds=env_float("PROMETHEUS_QUERY_TIMEOUT", 30),
    )


def reconciler_config_from_env():
    """The `ReconcilerConfig` the environment describes (raises on an
    invalid value, as the config's own checks do)."""
    from inferno_tpu_torch.controller.reconciler import ReconcilerConfig

    return ReconcilerConfig(
        config_namespace=env_str("CONFIG_NAMESPACE", "inferno-system"),
        engine=env_str("SERVING_ENGINE", "vllm-tpu"),
        scale_to_zero=env_bool("WVA_SCALE_TO_ZERO"),
        compute_backend=env_str(
            "COMPUTE_BACKEND", "auto" if env_bool("USE_TPU_FLEET", True) else "scalar"
        ).lower(),
        compute_device=env_str("COMPUTE_DEVICE").strip() or None,
        direct_scale=env_bool("DIRECT_SCALE"),
        profile_correction=env_bool("PROFILE_CORRECTION", True),
        keep_accelerator=env_bool("KEEP_ACCELERATOR", True),
        # predictive scaling (docs/forecasting.md): forecast-bounded
        # scale-up sizing, and the peak-over-window scale-down gate
        # (seconds; keep 0 when an HPA with its own stabilization
        # enacts the gauges)
        predictive_scaling=env_bool("PREDICTIVE_SCALING"),
        scale_down_stabilization_s=env_float("SCALE_DOWN_STABILIZATION_SECONDS", 0),
        # fleet-scale cycle knobs (docs/performance.md)
        reconcile_concurrency=env_int("RECONCILE_CONCURRENCY", 1),
        grouped_collection=env_bool("GROUPED_COLLECTION", True),
        sizing_cache=env_bool("SIZING_CACHE"),
        sizing_cache_tolerance=env_float("SIZING_CACHE_TOLERANCE", 0.02),
        # flight recorder + attainment scoreboard (docs/observability.md)
        flight_recorder_dir=env_str("FLIGHT_RECORDER_DIR").strip(),
        flight_recorder_max_mb=env_float("FLIGHT_RECORDER_MAX_MB", 64),
        flight_recorder_max_age_s=env_float("FLIGHT_RECORDER_MAX_AGE_S", 3600),
        attainment_ewma_gain=env_float("ATTAINMENT_EWMA_GAIN", 0.2),
        # cycle profiler (docs/observability.md): default-on per-cycle
        # cost attribution; tracemalloc sampling opt-in (it costs CPU)
        cycle_profiler=env_bool("CYCLE_PROFILER", True),
        profiler_tracemalloc=env_bool("PROFILE_TRACEMALLOC"),
    )


def main() -> int:
    from inferno_tpu_torch.controller.kube import RestKubeClient
    from inferno_tpu_torch.controller.metrics import (
        HealthServer,
        MetricsEmitter,
        MetricsServer,
        Registry,
    )
    from inferno_tpu_torch.controller.promclient import HttpPromClient
    from inferno_tpu_torch.controller.reconciler import Reconciler

    from inferno_tpu_torch.controller.logger import get_logger

    log = get_logger("inferno.main")

    prom_cfg = prom_config_from_env()
    if not prom_cfg.base_url:
        log.error("PROMETHEUS_BASE_URL is required")
        return 2
    prom = HttpPromClient(prom_cfg)
    # connectivity gate with backoff (reference: utils.go:390-410 called
    # from SetupWithManager; 5s doubling)
    delay = 5.0
    for _ in range(6):
        if prom.healthy():
            break
        log.warning("prometheus not reachable; retrying in %ss", delay)
        time.sleep(delay)
        delay *= 2
    else:
        log.error("prometheus unreachable; exiting")
        return 1

    from inferno_tpu_torch.controller.metrics import TLSConfig
    from inferno_tpu_torch.obs import TraceBuffer

    kube = RestKubeClient()
    registry = Registry()
    emitter = MetricsEmitter(registry)
    # last-K reconcile-cycle traces + decision records, shared between the
    # reconciler (writer) and the metrics listener (/debug/decisions)
    traces = TraceBuffer(capacity=env_int("DECISION_TRACE_BUFFER", 32))

    config = reconciler_config_from_env()
    rec = Reconciler(
        kube=kube, prom=prom, config=config, emitter=emitter, trace_buffer=traces
    )
    # the metrics listener starts after the reconciler exists so
    # /debug/attainment can serve the reconciler's live scoreboard
    server = MetricsServer(
        registry,
        port=env_int("METRICS_PORT", 8443),
        tls=TLSConfig.from_env(),
        traces=traces,
        attainment=rec.attainment,
        # /debug/profile serves the reconciler's per-cycle profile ring
        # (empty when CYCLE_PROFILER=false — the route still exists)
        profiles=rec.profiles,
    )
    server.start()
    # dedicated probe port so liveness/readiness don't ride the metrics
    # listener (the manager Deployment probes :8081)
    health = HealthServer(server.ready_flag, port=env_int("HEALTH_PORT", 8081))
    health.start()
    # readiness heartbeat: both probe listeners share this dict, so a
    # reconcile loop that stops cycling (> 3x interval) fails /readyz
    rec.ready_flag = server.ready_flag

    stopping = {"stop": False}

    def _stop(_sig, _frm):
        stopping["stop"] = True
        rec.poke()  # wake the loop so shutdown doesn't wait out the interval

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)

    # optional lease-based leader election for multi-replica deployments
    # (reference: cmd/main.go:74-76; off by default, like the reference flag)
    elector = None
    if env_bool("LEADER_ELECT"):
        import socket

        from inferno_tpu_torch.controller.leader import LeaderElector

        # the lease lives in the pod's own namespace (downward-API
        # POD_NAMESPACE; that's where the RBAC Role grants lease access),
        # like controller-runtime's default
        elector = LeaderElector(
            kube=kube,
            identity=f"{socket.gethostname()}_{os.getpid()}",
            namespace=env_str("POD_NAMESPACE")
            or getattr(kube, "namespace", "")
            or config.config_namespace,
        )
        elector.start()

    # event-driven triggers: VA creation and ConfigMap edits wake the loop
    # early (reference: watch config, controller.go:456-487); with the
    # reconciler's DirtyQueue attached, events also mark WHICH variant
    # changed, feeding the targeted incremental scan
    from inferno_tpu_torch.controller.watch import Watcher

    watcher = Watcher(
        kube, rec.poke,
        config_namespace=config.config_namespace,
        dirty=rec.dirty_queue,
    )
    watcher.start()

    try:
        rec.run_forever(
            stop_check=lambda: stopping["stop"],
            gate=(elector.is_leader if elector else (lambda: True)),
        )
    finally:
        watcher.stop()
        if elector:
            elector.stop()
        rec.close()  # join the persistent collect/apply worker pool
        health.stop()
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
