"""The whole reconcile cycle of the controller, driven back to back.

One `Reconciler` is kept across cycles, as the controller keeps it, over
an in-memory API server holding the configuration's ConfigMaps, one
VariantAutoscaling a variant (every shape its model has a profile for,
its current shape labelled) and the Deployment it owns, and an
in-process Prometheus answering the collector's grouped queries from one
table a cycle. Between cycles, outside the timed part, each Deployment
is scaled to its variant's `inferno_desired_replicas` gauge, as the HPA
would, and the table is swapped for the next cycle's. A step times
`run_cycle` from call to return, by which time every status is written
and every gauge emitted.

`correct` compares, for a cycle drawn from the seed and for the last
cycle of the window, every variant's written shape, replicas and
OptimizationReady condition, its gauge, and its decision record's rate a
replica with the plain reference (`reference/reconcile.py`) on the
table that cycle was served.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time

import numpy as np

from benchmark import common, roofline
from benchmark.entries import cycle
from benchmark.inputs import traffic
from benchmark.reference import reconcile as ref
from benchmark.reference import sizing
from inferno_tpu_torch.controller.engines import (
    LABEL_ACCELERATOR, LABEL_OUT_NAMESPACE, LABEL_VARIANT,
)
from inferno_tpu_torch.controller.kube import InMemoryCluster

NAMESPACE = "fleet"
CHECKED = ("rate_gap", "decisions_off", "gauges_off", "unwritten")
SPAN_CYCLE = "run_cycle"
SPAN_PREPARE = "prepare"


def variant_name(i: int) -> str:
    return f"variant-{i:05d}"


@contextlib.contextmanager
def environ(values: dict):
    """`values` set in the process environment for the block's duration."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class ApiServer(InMemoryCluster):
    """The in-memory API server, stamping every VariantAutoscaling status
    write with the cycle it landed in (as a real one bumps the object's
    resourceVersion)."""

    def __init__(self):
        super().__init__()
        self.cycle = -1
        self.written: dict[tuple[str, str], int] = {}

    def update_variant_autoscaling_status(self, va) -> None:
        super().update_variant_autoscaling_status(va)
        self.written[(va.namespace, va.name)] = self.cycle

    def stored_status(self, namespace: str, name: str) -> dict:
        """The status as stored, read in place (no copy: a read of 5,000
        objects would otherwise grow the heap it measures)."""
        return self._vas[(namespace, name)]["status"]


def build_cluster(config: dict, fleet: dict):
    """The in-memory API server of the deployment: the configuration's
    ConfigMaps as shipped, every variant's model listed in its service
    class at the class's SLOs, and one VariantAutoscaling and Deployment
    a variant."""
    import yaml

    from inferno_tpu_torch.config.types import DecodeParms, PrefillParms
    from inferno_tpu_torch.controller.crd import (
        ACCELERATOR_LABEL, AcceleratorProfile, ConfigMapKeyRef, VariantAutoscaling,
        VariantAutoscalingSpec,
    )

    cluster = ApiServer()
    ns = config["config_namespace"]
    sc = config["service_class"]
    for name, data in config["configmaps"].items():
        data = dict(data)
        if name == "service-classes-config":
            for key, raw in data.items():
                doc = yaml.safe_load(raw)
                if doc.get("name") == sc["name"]:
                    doc["data"] = list(doc.get("data") or []) + [
                        {"model": cycle.model_name(fleet, i), "slo-ttft": sc["slo_ttft_ms"],
                         "slo-tpot": sc["slo_tpot_ms"]}
                        for i in range(fleet["n"])]
                    data[key] = yaml.safe_dump(doc, sort_keys=False)
        cluster.set_configmap(ns, name, data)
    names = fleet["shape_names"]
    for i in range(fleet["n"]):
        profiles = [
            AcceleratorProfile(
                acc=names[s], acc_count=1, max_batch_size=int(fleet["max_batch"][i, s]),
                at_tokens=int(fleet["at_tokens"][i, s]),
                decode_parms=DecodeParms(alpha=float(fleet["alpha"][i, s]),
                                         beta=float(fleet["beta"][i, s])),
                prefill_parms=PrefillParms(gamma=float(fleet["gamma"][i, s]),
                                           delta=float(fleet["delta"][i, s])),
            )
            for s in np.flatnonzero(fleet["offered"][i])
        ]
        cluster.add_variant_autoscaling(VariantAutoscaling(
            name=variant_name(i), namespace=NAMESPACE,
            labels={ACCELERATOR_LABEL: names[fleet["cur_rank"][i]]},
            spec=VariantAutoscalingSpec(
                model_id=cycle.model_name(fleet, i),
                slo_class_ref=ConfigMapKeyRef(name="service-classes-config", key=sc["name"]),
                accelerators=profiles,
            ),
        ))
        cluster.add_deployment(NAMESPACE, variant_name(i), replicas=int(fleet["cur_reps"][i]))
    return cluster


def decode_batch(fleet: dict, out_tok) -> np.ndarray:
    """Each variant's decode batch on its current shape at `out_tok`
    output tokens: the profile's max batch scaled to the tokens it was
    measured at, as `reference/sizing.py` has it."""
    i = np.arange(fleet["n"])
    s = fleet["cur_rank"]
    mbs, at = fleet["max_batch"][i, s], fleet["at_tokens"][i, s]
    return np.maximum(np.floor(mbs * at / np.maximum(out_tok, 1.0)), 1.0)


def scrape(fleet: dict, state: dict, replicas, scrape_mix: dict, seed: int, c: int) -> dict:
    """Cycle `c`'s Prometheus table as numpy columns over variants: the
    state's rates (req/s) and tokens, the requests running at an occupancy
    U(lo, hi) of the current shape's decode batch, and TTFT and ITL on the
    CR profile's line at the per-replica concurrency, each times
    U(1 - j, 1 + j). Idle variants report 0, apart from the engine's max
    batch."""
    rng = np.random.default_rng([int(seed), int(c), 2])
    n = fleet["n"]
    i, s = np.arange(n), fleet["cur_rank"]
    loaded = state["lam"] > 0
    lo, hi = scrape_mix["occupancy"]
    j = float(scrape_mix["latency_jitter"])
    running = rng.uniform(lo, hi, n) * decode_batch(fleet, state["out_tok"])
    conc = running / np.maximum(replicas, 1)
    itl = (fleet["alpha"][i, s] + fleet["beta"][i, s] * conc) * rng.uniform(1 - j, 1 + j, n)
    ttft = (fleet["gamma"][i, s] + fleet["delta"][i, s] * state["in_tok"] * conc) * rng.uniform(
        1 - j, 1 + j, n)
    zero = np.zeros(n)
    return {
        "rps": np.where(loaded, state["lam"] / 60.0, zero),
        "in_tok": np.where(loaded, state["in_tok"], zero),
        "out_tok": np.where(loaded, state["out_tok"], zero),
        "running": np.where(loaded, running, zero),
        "ttft_s": np.where(loaded, ttft / 1e3, zero),
        "itl_s": np.where(loaded, itl / 1e3, zero),
        "max_batch": fleet["max_batch"][i, s].astype(np.float64),
    }


def fake_prom(fleet: dict, table: dict):
    """The in-process Prometheus serving `table`: the collector's grouped
    queries answered from it (and its per-variant queries, should a
    variant fall back)."""
    from inferno_tpu_torch.testing.fleet import fleet_fake_prom

    rows = {
        (cycle.model_name(fleet, i), NAMESPACE): {
            "running": float(table["running"][i]), "arrival_rps": float(table["rps"][i]),
            "in_tokens": float(table["in_tok"][i]), "out_tokens": float(table["out_tok"][i]),
            "ttft_s": float(table["ttft_s"][i]), "itl_s": float(table["itl_s"][i]),
            "max_batch": float(table["max_batch"][i]),
        }
        for i in range(fleet["n"])
    }
    return fleet_fake_prom(rows)


def rss_kb() -> int:
    """The process's resident set now (VmRSS), kB; 0 where /proc has none."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


class Bench:
    """One cell of the reconcile entry: set up by `__init__` + `warm`, one
    timed `run_cycle` a `step`, then `check` against the reference."""

    def __init__(self, config, mix, seed, device, backend, spans):
        import torch

        from inferno_tpu_torch.controller import Reconciler
        from inferno_tpu_torch.controller.main import reconciler_config_from_env
        from inferno_tpu_torch.obs import TraceBuffer
        from inferno_tpu_torch.parallel import reset_fleet_state

        self.torch = torch
        self.mix, self.scrape_mix = mix["cycle"], mix["scrape"]
        self.seed = seed
        self.warm_cycles = int(mix["warm_cycles"])
        self.device, self.backend = device, backend
        self.spans = spans
        self.fleet = common.load_generator(config["generator"]).make(config, seed)
        self.state = traffic.initial(self.fleet)
        self.replicas = np.array(self.fleet["cur_reps"], np.int64)
        self.cluster = build_cluster(config, self.fleet)
        self.table = scrape(self.fleet, self.state, self.replicas, self.scrape_mix, seed, 0)
        settings = config["controller"]
        reset_fleet_state()
        # the controller's settings as its environment states them, read
        # as `controller.main` reads them; the harness picks the backend
        with environ(settings):
            rc = dataclasses.replace(
                reconciler_config_from_env(), config_namespace=config["config_namespace"],
                compute_backend=backend,
                compute_device=None if device.type == "cuda" else str(device))
            self.rec = Reconciler(
                self.cluster, fake_prom(self.fleet, self.table), rc,
                trace_buffer=TraceBuffer(capacity=int(settings["DECISION_TRACE_BUFFER"])))
        self.cycle_index = 0
        self.sample_at = self.warm_cycles + 1 + int(
            np.random.default_rng([int(seed), 1]).integers(0, int(mix["sample_within"])))
        self.captured = {}
        self.tables = {}
        self.counters: dict[str, float] = {}  # the window's cycles' own profile counters
        self._last = None  # the newest cycle's report
        self.rss = []  # VmRSS (kB) after the warm cycles, then after each timed cycle
        self.step_ms = []
        self.launches = []  # the kernels' launch counters as the window opens and closes

    def _run_cycle(self):
        self.cluster.cycle = self.cycle_index
        report = self.rec.run_cycle()
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()
        if report.errors or not report.optimization_ok:
            raise RuntimeError(f"cycle {self.cycle_index}: optimization_ok "
                               f"{report.optimization_ok}, errors {report.errors[:3]}")
        return report

    def warm(self):
        """The cold cycle on the fleet as generated, then the mix's warm
        cycles: every memo, snapshot table and kernel the window's cycles
        use is built here, and the trace ring fills."""
        self._run_cycle()
        for _ in range(self.warm_cycles):
            self.prepare()
            self._run_cycle()
        self.rss.append(rss_kb())
        self.launches.append(self._launch_counts())

    def _launch_counts(self):
        """(stats_kernel, bisect_kernel) launches so far in this process;
        None off the card, where the kernels never run."""
        if self.device.type != "cuda":
            return None
        from inferno_tpu_torch.ops import cuda_queueing

        return cuda_queueing.LAUNCHES, cuda_queueing.BISECT_LAUNCHES

    def prepare(self):
        """The next cycle's inputs, outside the timed part: each Deployment
        scaled to its gauge, as the HPA would, and the table swapped."""
        self.cycle_index += 1
        with self.spans.span(SPAN_PREPARE):
            gauges = self.gauges()
            for i, (desired, _) in enumerate(gauges):
                if desired >= 0 and desired != self.replicas[i]:
                    self.cluster.scale_deployment(NAMESPACE, variant_name(i), int(desired))
                    self.replicas[i] = desired
            traffic.step(self.fleet, self.state, self.mix, self.seed, self.cycle_index)
            self.table = scrape(self.fleet, self.state, self.replicas, self.scrape_mix,
                                self.seed, self.cycle_index)
            self.rec.prom = fake_prom(self.fleet, self.table)

    def step(self) -> tuple[float, int]:
        """One timed reconcile cycle: (its host milliseconds, 1 cycle done)."""
        self.prepare()
        t0 = time.perf_counter()
        with self.spans.span(SPAN_CYCLE):
            report = self._run_cycle()
        ms = (time.perf_counter() - t0) * 1000.0
        self.rss.append(rss_kb())
        self.step_ms.append(ms)
        for k, v in (report.profile or {}).get("counters", {}).items():
            self.counters[k] = self.counters.get(k, 0) + v
        if self.cycle_index == self.sample_at:
            self._capture(report)
        self._last = report
        return ms, 1

    def gauges(self) -> list[tuple[int, str]]:
        """Every variant's `inferno_desired_replicas` gauge: (replicas,
        shape label), (-1, "") where none is set."""
        index = {variant_name(i): i for i in range(self.fleet["n"])}
        out = [(-1, "")] * self.fleet["n"]
        for labels, value in self.rec.emitter.desired_replicas.values.values():
            i = index.get(labels.get(LABEL_VARIANT))
            if i is not None and labels.get(LABEL_OUT_NAMESPACE) == NAMESPACE:
                out[i] = (int(value), labels.get(LABEL_ACCELERATOR, ""))
        return out

    def _capture(self, report):
        """What the cycle wrote, read back: each variant's status from the
        API server, its gauge, and its decision record's rate a replica."""
        from inferno_tpu_torch.controller.crd import TYPE_OPTIMIZATION_READY

        n, names = self.fleet["n"], self.fleet["shape_names"]
        index = {name: s for s, name in enumerate(names)}
        got = {k: np.full(n, -1, np.int64) for k in ("shape", "replicas", "gauge",
                                                     "gauge_shape")}
        got["written"] = np.zeros(n, bool)
        got["ready"] = np.zeros(n, bool)
        got["rate"] = np.full(n, np.nan)
        for i in range(n):
            status = self.cluster.stored_status(NAMESPACE, variant_name(i))
            alloc = status.get("desiredOptimizedAlloc") or {}
            got["shape"][i] = index.get(alloc.get("accelerator", ""), -1)
            got["replicas"][i] = int(alloc.get("numReplicas", 0) or 0)
            got["ready"][i] = any(c.get("type") == TYPE_OPTIMIZATION_READY
                                  and c.get("status") == "True"
                                  for c in status.get("conditions") or [])
            got["written"][i] = self.cluster.written.get(
                (NAMESPACE, variant_name(i))) == self.cycle_index
        for i, (reps, shape) in enumerate(self.gauges()):
            got["gauge"][i] = reps
            got["gauge_shape"][i] = index.get(shape, -1)
        position = {variant_name(i): i for i in range(n)}
        for rec in report.decisions:
            i = position.get(rec.name)
            if i is not None and rec.namespace == NAMESPACE and rec.lambda_max_rpm > 0:
                got["rate"][i] = rec.lambda_max_rpm / 60.0
        self.captured[self.cycle_index] = got
        self.tables[self.cycle_index] = {k: self.table[k].copy()
                                         for k in ("rps", "in_tok", "out_tok")}

    def finish(self):
        """Close the window: read the last cycle back and free the
        program's state."""
        from inferno_tpu_torch.parallel import reset_fleet_state

        if self.cycle_index not in self.captured and self.cycle_index > self.warm_cycles:
            self._capture(self._last)
        self.launches.append(self._launch_counts())
        self._last = None
        self.rec.close()
        self.rec = None
        reset_fleet_state()
        if self.step_ms:
            print(f"reconcile: {len(self.step_ms)} cycles, {sum(self.step_ms) / len(self.step_ms):.1f} "
                  f"ms a cycle ({', '.join(f'{ms:.0f}' for ms in self.step_ms)}); "
                  f"VmRSS (kB) after the warm cycles, then after each cycle: "
                  f"{self.rss} ({100.0 * (self.rss[-1] / max(self.rss[0], 1) - 1.0):+.3f}% "
                  f"over the window)", file=sys.stderr)

    def check(self, limits, program=None):
        """Each compared number, the worst over the captured cycles, beside
        its limit: [(name, value, limit)]. `program` (a torch dtype)
        replaces the program's answers by the reference's at that
        precision (the control)."""
        torch = self.torch
        worst = {k: 0 for k in CHECKED}
        for c in sorted(self.captured):
            table = self.tables[c]
            want = ref.decide(self.fleet, table, dtype=torch.float64, device=self.device)
            got = self.captured[c] if program is None else ref.as_written(
                ref.decide(self.fleet, table, dtype=program, device=self.device))
            for k, v in ref.compare(want, got, limits["rate_gap"]).items():
                worst[k] = max(worst[k], v)
        return [(k, worst[k], limits[k]) for k in CHECKED]

    def layer_context(self, traced: bool) -> dict:
        """What the per-layer readers need of this entry: the window's
        cycles' own profile counters, summed (inside a cycle its own
        profiler, not the window's, is active); with a trace, the least
        device seconds of the window's cycles (`roofline`) and, on the
        card, each sizing kernel's launches a cycle."""
        ctx = {"cycle_counters": dict(self.counters)}
        if not traced:
            return ctx
        first = self.warm_cycles + 1
        ctx["sizing_bound_s"] = self.bound_s(first, self.cycle_index)
        cycles = self.cycle_index - self.warm_cycles
        opened, closed = self.launches
        if opened is not None and cycles > 0:
            ctx["stats_kernel_launches"] = (closed[0] - opened[0]) / cycles
            ctx["bisect_kernel_launches"] = (closed[1] - opened[1]) / cycles
        return ctx

    def bound_s(self, first: int, last: int) -> float:
        """The least device seconds for cycles first..last: each cycle's
        changed lanes, found by content against the cycle before, among
        the lanes the controller's rules size (the current shape's,
        KEEP_ACCELERATOR)."""
        pinned = ref.pinned(self.fleet)
        prev = traffic.state_at(self.fleet, self.mix, self.seed, first - 1)
        total = 0.0
        for c in range(first, last + 1):
            state = {k: v.copy() for k, v in prev.items()}
            traffic.step(self.fleet, state, self.mix, self.seed, c)
            lanes = sizing.lanes_of(pinned, state)
            var = lanes["var"]
            tokens = (state["in_tok"] != prev["in_tok"]) | (state["out_tok"] != prev["out_tok"])
            rate = state["lam"] != prev["lam"]
            sized = None
            if tokens[var].any():
                sized = sizing.size(lanes, dtype=self.torch.float64, device=self.device)
            total += roofline.cycle_bound_s(lanes, sized, tokens[var], rate[var])
            prev = state
        return total
