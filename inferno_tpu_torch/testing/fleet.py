"""Synthetic N-variant fleet fixtures for the port's tests and chip_smoke.py.

Port copy of `inferno_tpu/testing/fleet.py`: `SIZING_SHAPES`,
`fleet_system_spec`, `perturb_loads`, `fleet_capacity`, `fleet_model`,
`fleet_variant`, and the reconcile-cycle fixtures `fleet_cluster` (an
`InMemoryCluster` of N variants), `fleet_targets` (MiniProm scrape
targets whose counters advance with wall time) and `fleet_fake_prom` (a
FakeProm answering the collector's grouped and per-variant queries from
a static table), verbatim apart from the imports (and `fleet_capacity`'s
backend and device).

`fleet_system_spec` builds an N-variant SystemSpec spanning the sizing
edge lanes — aggregated and tandem (disagg) shapes, zero-load variants,
pinned (keep_accelerator) variants, infeasible SLO targets.
`assert_same_decisions` holds two sized-and-solved Systems to the port's
comparison rule, `assert_same_batch` two batched time-axis results.
"""

from __future__ import annotations

import time

from inferno_tpu_torch.config.types import DecodeParms, PrefillParms
from inferno_tpu_torch.controller.crd import (
    ACCELERATOR_LABEL,
    AcceleratorProfile,
    ConfigMapKeyRef,
    VariantAutoscaling,
    VariantAutoscalingSpec,
)
from inferno_tpu_torch.controller.engines import EngineMetrics, engine_for
from inferno_tpu_torch.controller.kube import InMemoryCluster

CONFIG_NS = "inferno-system"

FLEET_NS = "fleet"
SERVICE_CLASS = "Premium"

# the sizing-spec slice-shape catalog: (shape, cents per chip-hour)
SIZING_SHAPES = (("v5e-4", 10.0), ("v5e-8", 12.0), ("v5e-16", 10.0))


def fleet_system_spec(
    n_variants: int,
    shapes_per_variant: int = 2,
    tandem_every: int = 7,
    zero_load_every: int = 11,
    pinned_every: int = 5,
    infeasible_every: int = 13,
    seed: int = 0,
    priority_classes: int = 1,
    split_pools: bool = False,
):
    """An N-variant SystemSpec exercising every sizing edge lane.

    Each variant serves its own model (distinct profiles, so the
    columnar snapshot tracks N independent structures) on
    `shapes_per_variant` candidate slice shapes. Deterministic in
    `seed`; the periodic knobs fold in the edge cases (`0` disables
    one): every `tandem_every`-th variant's profiles are disaggregated
    (prefill/decode tandem units), every `zero_load_every`-th variant
    has zero arrival (the closed-form shortcut path), every
    `pinned_every`-th variant pins candidates to its current shape
    (`keep_accelerator`), and every `infeasible_every`-th variant gets
    an unmeetable ITL target (no feasible lane on any shape).

    `priority_classes` > 1 spreads variants round-robin over that many
    service classes at distinct priorities (1, 6, 11, ...) — the
    capacity-constrained solver's priority-bucket fixture; 1 keeps the
    single-class shape every existing caller relies on. `split_pools`
    gives each candidate shape its own capacity pool (gen0, gen1, ...)
    and alternating placement regions (r0/r1), so a binding pool forces
    cross-pool shape step-downs instead of uniform zeroing — the
    degradation-ladder fixture; False keeps every shape in the v5e pool.
    """
    import numpy as np

    from inferno_tpu_torch.config import (
        AcceleratorSpec,
        AllocationData,
        CapacitySpec,
        DecodeParms,
        DisaggSpec,
        ModelPerfSpec,
        ModelTarget,
        OptimizerSpec,
        PrefillParms,
        ServerLoadSpec,
        ServerSpec,
        ServiceClassSpec,
        SystemSpec,
    )

    rng = np.random.default_rng(seed)
    shapes = SIZING_SHAPES[: max(shapes_per_variant, 1)]
    accelerators = [
        AcceleratorSpec(
            name=name, cost_per_chip_hr=cost,
            **({"pool": f"gen{s}", "region": f"r{s % 2}"} if split_pools else {}),
        )
        for s, (name, cost) in enumerate(shapes)
    ]
    n_classes = max(priority_classes, 1)
    class_names = (
        [SERVICE_CLASS]
        if n_classes == 1
        else [f"{SERVICE_CLASS}-p{c}" for c in range(n_classes)]
    )
    class_targets: list[list] = [[] for _ in range(n_classes)]
    models, servers = [], []
    for i in range(n_variants):
        model = fleet_model(i)
        tandem = tandem_every and i % tandem_every == tandem_every - 1
        size = float(rng.uniform(0.8, 2.5))
        for s, (shape, _) in enumerate(shapes):
            speed = (s + 1) ** 0.5
            models.append(ModelPerfSpec(
                name=model, acc=shape,
                max_batch_size=max(8, int(48 / size) * (s + 1)),
                at_tokens=128,
                decode_parms=DecodeParms(
                    alpha=10.0 * size / speed + 4.0, beta=0.25 * size / speed,
                ),
                prefill_parms=PrefillParms(
                    gamma=3.0 * size / speed + 1.0, delta=0.015 * size / speed,
                ),
                disagg=(
                    DisaggSpec(prefill_slices=1, decode_slices=2,
                               prefill_max_batch=8)
                    if tandem else None
                ),
            ))
        infeasible = infeasible_every and i % infeasible_every == infeasible_every - 1
        cls = i % n_classes
        class_targets[cls].append(ModelTarget(
            model=model,
            slo_itl=0.001 if infeasible else 60.0,
            slo_ttft=1.0 if infeasible else 1500.0,
        ))
        zero = zero_load_every and i % zero_load_every == zero_load_every - 1
        pinned = pinned_every and i % pinned_every == pinned_every - 1
        cur = AllocationData(
            accelerator=shapes[0][0], num_replicas=1 + i % 3,
        )
        cur.load = ServerLoadSpec(
            arrival_rate=0.0 if zero else float(rng.uniform(30.0, 900.0)),
            avg_in_tokens=float(rng.integers(32, 512)),
            avg_out_tokens=float(rng.integers(16, 384)),
        )
        servers.append(ServerSpec(
            name=f"{FLEET_NS}/{fleet_variant(i)}",
            class_name=class_names[cls],
            model=model,
            keep_accelerator=bool(pinned),
            min_num_replicas=1,
            current_alloc=cur,
        ))
    return SystemSpec(
        accelerators=accelerators,
        models=models,
        service_classes=[
            ServiceClassSpec(
                name=class_names[c], priority=1 + 5 * c,
                model_targets=class_targets[c],
            )
            for c in range(n_classes)
        ],
        servers=servers,
        optimizer=OptimizerSpec(unlimited=True),
        capacity=CapacitySpec(chips={}),
    )


def perturb_loads(system, scale: float = 1.02, rng=None, spread: float = 0.25) -> None:
    """Scale every loaded server's arrival rate in place — the cheapest
    'every variant changed' cycle input (defeats plan replay so repeated
    sizing passes measure honest recompute, as a live fleet would).

    With a seeded `rng` (np.random.Generator) each server draws its OWN
    factor from `scale * [1 - spread, 1 + spread]` — a reproducible
    per-variant skew (the planner's regional-skew scenario generators
    need dispersion a uniform fixed scale can't express). `rng=None`
    keeps the legacy uniform behavior every existing caller relies on."""
    for server in system.servers.values():
        if server.load is not None and server.load.arrival_rate > 0:
            factor = scale
            if rng is not None:
                factor *= 1.0 + spread * float(rng.uniform(-1.0, 1.0))
            server.load.arrival_rate *= factor


def fleet_model(i: int) -> str:
    return f"bench/model-{i:03d}"


def fleet_variant(i: int) -> str:
    return f"variant-{i:03d}"


def fleet_cluster(
    n_variants: int,
    namespace: str = FLEET_NS,
    config_namespace: str = CONFIG_NS,
    replicas: int = 1,
    slo_ttft: float = 500.0,
    slo_itl: float = 24.0,
) -> InMemoryCluster:
    """An in-memory cluster with N variants of distinct models, each
    owning a Deployment, plus the accelerator-cost / service-class /
    controller ConfigMaps a cycle reads."""
    cluster = InMemoryCluster()
    cluster.set_configmap(config_namespace, "accelerator-unit-costs", {
        "v5e-4": '{"cost": 10.0}',
        "v5e-16": '{"cost": 10.0}',
    })
    entries = "".join(
        f"  - model: {fleet_model(i)}\n"
        f"    slo-ttft: {slo_ttft}\n    slo-tpot: {slo_itl}\n"
        for i in range(n_variants)
    )
    cluster.set_configmap(config_namespace, "service-classes-config", {
        "premium.yaml": f"name: {SERVICE_CLASS}\npriority: 1\ndata:\n{entries}",
    })
    cluster.set_configmap(config_namespace, "inferno-autoscaler-config", {})
    for i in range(n_variants):
        va = VariantAutoscaling(
            name=fleet_variant(i),
            namespace=namespace,
            labels={ACCELERATOR_LABEL: "v5e-4"},
            spec=VariantAutoscalingSpec(
                model_id=fleet_model(i),
                slo_class_ref=ConfigMapKeyRef(
                    name="service-classes-config", key=SERVICE_CLASS
                ),
                accelerators=[
                    AcceleratorProfile(
                        acc="v5e-4", acc_count=1, max_batch_size=64,
                        at_tokens=128,
                        decode_parms=DecodeParms(alpha=18.0, beta=0.3),
                        prefill_parms=PrefillParms(gamma=5.0, delta=0.02),
                    ),
                ],
            ),
        )
        cluster.add_variant_autoscaling(va)
        cluster.add_deployment(namespace, fleet_variant(i), replicas=replicas)
    return cluster


def fleet_targets(
    n_variants: int,
    arrival_rps: float = 5.0,
    in_tokens: float = 128.0,
    out_tokens: float = 128.0,
    ttft_s: float = 0.05,
    itl_s: float = 0.02,
    running: float = 3.0,
):
    """MiniProm scrape targets: one exposition callable per variant whose
    counters advance with WALL time at the requested rates, so rate()
    reads arrival_rps regardless of the scrape cadence. Pass to
    MiniProm([...], ...) with a namespace relabel, e.g.::

        MiniProm([(t, {"namespace": FLEET_NS}) for t in fleet_targets(50)])
    """
    t0 = time.time()

    def make(i: int):
        model = fleet_model(i)

        def render() -> str:
            count = arrival_rps * (time.time() - t0)
            sel = f'{{model_name="{model}"}}'
            return "\n".join([
                f"vllm:num_requests_running{sel} {running}",
                f"vllm:request_success_total{sel} {count}",
                f"vllm:request_prompt_tokens_sum{sel} {in_tokens * count}",
                f"vllm:request_prompt_tokens_count{sel} {count}",
                f"vllm:request_generation_tokens_sum{sel} {out_tokens * count}",
                f"vllm:request_generation_tokens_count{sel} {count}",
                f"vllm:time_to_first_token_seconds_sum{sel} {ttft_s * count}",
                f"vllm:time_to_first_token_seconds_count{sel} {count}",
                f"vllm:time_per_output_token_seconds_sum{sel} {itl_s * count}",
                f"vllm:time_per_output_token_seconds_count{sel} {count}",
                f"vllm:num_requests_max{sel} 64",
            ]) + "\n"

        render.__name__ = f"{model}/0"  # `up` instance label
        return render

    return [make(i) for i in range(n_variants)]


def fleet_fake_prom(
    rows: dict[tuple[str, str], dict],
    engine: EngineMetrics | None = None,
    age_seconds: float = 0.0,
    grouped: bool = True,
):
    """A FakeProm answering BOTH the coalesced grouped shapes and the
    per-variant single-query shapes from one static table, for bit-exact
    parity tests (grouped on vs off must produce identical cycles).

    rows: (model, namespace) -> dict with any of running, arrival_rps,
    in_tokens, out_tokens, ttft_s, itl_s, max_batch. `grouped=False`
    leaves the grouped queries unanswered (empty vectors), forcing the
    per-variant fallback — the lever for fallback tests.
    """
    from inferno_tpu_torch.controller.collector import grouped_queries
    from inferno_tpu_torch.controller.promclient import FakeProm, Sample

    engine = engine or engine_for("vllm-tpu")
    prom = FakeProm()
    ml = engine.model_label

    def col(field: str, default: float = 0.0):
        return [
            ({ml: m, "namespace": ns}, float(vals.get(field, default)))
            for (m, ns), vals in sorted(rows.items())
        ]

    if grouped and rows:
        qs = grouped_queries(engine, set(rows))
        prom.set_samples(qs["running"], col("running"), age_seconds=age_seconds)
        prom.set_samples(qs["arrival"], col("arrival_rps"), age_seconds=age_seconds)
        prom.set_samples(qs["avg_in"], col("in_tokens"), age_seconds=age_seconds)
        prom.set_samples(qs["avg_out"], col("out_tokens"), age_seconds=age_seconds)
        prom.set_samples(qs["ttft"], col("ttft_s"), age_seconds=age_seconds)
        prom.set_samples(qs["itl"], col("itl_s"), age_seconds=age_seconds)
        if "max_batch" in qs:
            prom.set_samples(qs["max_batch"], col("max_batch", 64.0),
                             age_seconds=age_seconds)

    def handler(q: str):
        # per-variant shapes: find the row whose model id appears in the
        # query selector (the collector always filters on the model label)
        for (m, ns), vals in sorted(rows.items()):
            if f'"{m}"' not in q:
                continue

            def s(v: float):
                return [Sample(labels={}, value=float(v),
                               timestamp=time.time() - age_seconds)]

            if "num_requests_running" in q or "slots_used" in q:
                return s(vals.get("running", 0.0))
            if "num_requests_max" in q or "total_slots" in q:
                return s(vals.get("max_batch", 64.0))
            if "success" in q:
                return s(vals.get("arrival_rps", 0.0))
            if "prompt_tokens" in q or "input_length" in q:
                return s(vals.get("in_tokens", 0.0))
            if "generation_tokens" in q or "output_length" in q:
                return s(vals.get("out_tokens", 0.0))
            if "first_token" in q:
                return s(vals.get("ttft_s", 0.0))
            if "per_output_token" in q:
                return s(vals.get("itl_s", 0.0))
        return []

    prom.add_handler(lambda q: True, handler)
    return prom


def fleet_capacity(
    spec, fraction: float = 1.0, backend: str = "torch", device=None,
) -> dict:
    """Per-pool chip budgets sized at `fraction` of what the
    UNCONSTRAINED solve of `spec` consumes — the lever for loose
    (fraction >= 1) vs binding (fraction < 1) capacity fixtures. The
    reference's `fleet_capacity` on the port's path: `backend`/`device`
    go to `calculate_fleet` (callers on the CPU pass `device="cpu"`)."""
    from inferno_tpu_torch.core import System
    from inferno_tpu_torch.parallel import calculate_fleet
    from inferno_tpu_torch.solver.solver import solve_unlimited

    system = System(spec)
    calculate_fleet(system, backend=backend, device=device)
    solve_unlimited(system)
    usage = system.allocate_by_pool()
    return {pool: max(int(u.chips * fraction), 0) for pool, u in usage.items()}


def assert_same_decisions(a, b, rtol: float = 1e-5) -> int:
    """Hold two Systems, each sized by `calculate_fleet` and solved by
    `solve_unlimited`, to the port's comparison rule, server by server:

    * the picked accelerator and the set of feasible candidates exactly;
    * replicas exactly, except ±1 where the per-replica capacity
      (rate_star) agrees within 1e-4 relative — a ceil boundary, where a
      last-ulp f32 difference legitimately moves the count;
    * cost and value within `rtol` off those boundary lanes.

    Raises AssertionError naming the first diverging server; returns the
    number of boundary lanes it accepted."""
    boundary = 0
    assert list(a.servers) == list(b.servers), "different server sets"
    for name, sa in a.servers.items():
        sb = b.servers[name]
        ca, cb = sa.all_allocations, sb.all_allocations
        assert set(ca) == set(cb), (name, sorted(ca), sorted(cb))
        xa, xb = sa.allocation, sb.allocation
        assert (xa is None) == (xb is None), (name, xa, xb)
        if xa is None:
            continue
        assert xa.accelerator == xb.accelerator, (name, xa, xb)
        for acc in ca:
            pa, pb = ca[acc], cb[acc]
            ra, rb = pa.max_arrv_rate_per_replica, pb.max_arrv_rate_per_replica
            if pa.num_replicas != pb.num_replicas:
                close = abs(ra - rb) <= 1e-4 * max(abs(ra), abs(rb))
                assert abs(pa.num_replicas - pb.num_replicas) == 1 and close, (
                    name, acc, pa, pb
                )
                boundary += 1
                continue
            for field in ("cost", "value"):
                va, vb = getattr(pa, field), getattr(pb, field)
                assert abs(va - vb) <= rtol * max(abs(va), abs(vb), 1e-9), (
                    name, acc, field, va, vb
                )
    return boundary


def assert_same_batch(prep_a, res_a, prep_b, res_b) -> int:
    """Hold two results of the batched time-axis solve of one fleet
    (`FleetBatchPrep` + its `FleetBatchResult`, from either package) to
    the port's comparison rule, cell by cell:

    * the chosen accelerator exactly;
    * replicas exactly, except ±1 where the chosen lane's rate_star agrees
      within 1e-4 relative (a ceil boundary);
    * chips, cost, value and the spot columns exactly off those cells:
      both sides compute them in the same f32/f64 host arithmetic from
      equal replica counts.

    Raises AssertionError naming the first diverging cell; returns the
    number of boundary cells it accepted."""
    import numpy as np

    if res_a.servers != res_b.servers or res_a.accelerators != res_b.accelerators:
        raise AssertionError("different server or accelerator axes")
    if not np.array_equal(res_a.choice, res_b.choice):
        raise AssertionError(f"choices differ in {int((res_a.choice != res_b.choice).sum())} cells")
    n_srv = len(res_a.servers)
    choice = res_a.choice.reshape(-1, n_srv)
    diff = (res_a.replicas.astype(np.int64) - res_b.replicas).reshape(-1, n_srv)
    for row, s in zip(*np.nonzero(diff)):
        stars = []
        for prep in (prep_a, prep_b):
            hit = np.flatnonzero((prep.lane_server == s) & (prep.lane_rank == choice[row, s]))
            stars.append(float(prep._l_rate_star[hit[0]]))
        close = abs(stars[0] - stars[1]) <= 1e-4 * max(abs(stars[0]), abs(stars[1]))
        if abs(diff[row, s]) != 1 or not close:
            raise AssertionError(f"row {row} server {s}: replicas differ by {diff[row, s]} "
                                 f"at rate_star {stars}")
    keep = diff == 0
    for field in ("chips", "cost", "value", "spot_replicas", "required"):
        a, b = getattr(res_a, field), getattr(res_b, field)
        if (a is None) != (b is None):
            raise AssertionError(f"{field} present on one side only")
        if a is not None and not np.array_equal(a.reshape(-1, n_srv)[keep],
                                                b.reshape(-1, n_srv)[keep]):
            raise AssertionError(f"{field} differs off the boundary cells")
    return int((~keep).sum())
