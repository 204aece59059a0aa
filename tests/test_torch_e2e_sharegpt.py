"""ShareGPT-style scale-up e2e: the hardware-free analogue of the
reference's OpenShift real-vLLM scenario
(upstream test/e2e-openshift/sharegpt_scaleup_test.go:39-227).

Shape of the reference test, reproduced at the sockets tier:
  1. record the initial optimized/actual replica state,
  2. verify the external-metrics surface (here: the controller's emitted
     gauges, which prometheus-adapter would re-serve) matches CR status,
  3. run a heavy-tailed "ShareGPT" load job — open-loop Poisson arrivals
     with lognormal prompt/completion lengths — against the engine
     endpoint, and assert the optimizer scales the variant out,
  4. after the job completes, assert capacity is released again.

Port of tests/test_e2e_sharegpt.py on the port's controller, emulator and
fixtures (every Reconciler gets `compute_device="cpu"`). MiniProm is
scraped by hand while the job runs, and "after the job" is its clock
stepped past the rate window.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from inferno_tpu_torch.controller.engines import (
    LABEL_ACCELERATOR,
    LABEL_OUT_NAMESPACE,
    LABEL_VARIANT,
)
from inferno_tpu_torch.emulator.loadgen import TokenDistribution

from test_torch_apiserver import NS, e2e_stack, go_idle, prom_clock, wait_for  # noqa: F401

MODEL = "meta-llama/Llama-3.1-8B"

# Tails capped well below the presets so the emulated "job" finishes in
# test time; the shape (lognormal, sigma ~ 1) is what matters.
IN_DIST = TokenDistribution(median=96.0, sigma=1.0, max_tokens=512)
OUT_DIST = TokenDistribution(median=48.0, sigma=0.8, max_tokens=192)


class ShareGPTJob:
    """Open-loop Poisson load with lognormal token lengths over HTTP —
    the guidellm-job stand-in. Fire-and-forget: each arrival gets its own
    thread, as an open-loop generator must (a closed loop would throttle
    itself to the engine's capacity and mask the overload)."""

    def __init__(self, port: int, rate_rps: float, num_prompts: int, seed: int = 7):
        self.url = f"http://127.0.0.1:{port}/v1/chat/completions"
        self.rate = rate_rps
        self.num_prompts = num_prompts
        self.rng = np.random.default_rng(seed)
        self.completed = 0
        self.failed = 0
        self._lock = threading.Lock()
        self._threads: list[threading.Thread] = []

    def _one(self, in_tokens: int, out_tokens: int) -> None:
        body = json.dumps(
            {
                "model": MODEL,
                "messages": [{"role": "user", "content": "x " * in_tokens}],
                "max_tokens": out_tokens,
            }
        ).encode()
        req = urllib.request.Request(
            self.url, data=body, headers={"Content-Type": "application/json"}
        )
        try:
            urllib.request.urlopen(req, timeout=60).read()
            with self._lock:
                self.completed += 1
        except OSError:
            with self._lock:
                self.failed += 1

    def run(self) -> None:
        """Blocks until all prompts are submitted (not completed)."""
        for _ in range(self.num_prompts):
            time.sleep(float(self.rng.exponential(1.0 / self.rate)))
            t = threading.Thread(
                target=self._one,
                args=(IN_DIST.sample(self.rng), OUT_DIST.sample(self.rng)),
                daemon=True,
            )
            t.start()
            self._threads.append(t)

    def wait(self, timeout: float) -> None:
        deadline = time.time() + timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.time()))


def test_sharegpt_scaleup_and_release(e2e_stack, prom_clock):
    srv, prom, cluster, rec = e2e_stack

    # -- 1. initial state ---------------------------------------------------
    rec.run_cycle()
    va = cluster.get_variant_autoscaling(NS, "llama-premium")
    initial_optimized = va.status.desired_optimized_alloc.num_replicas
    initial_replicas = cluster.get_deployment(NS, "llama-premium")["spec"]["replicas"]
    assert initial_optimized <= 1

    # -- 2. external-metrics surface ----------------------------------------
    labels = {
        LABEL_OUT_NAMESPACE: NS,
        LABEL_VARIANT: "llama-premium",
        LABEL_ACCELERATOR: "v5e-4",
    }
    assert rec.emitter.desired_replicas.get(labels) == float(initial_optimized)
    assert rec.emitter.current_replicas.get(labels) == float(initial_replicas)

    # -- 3. the ShareGPT job ------------------------------------------------
    job = ShareGPTJob(srv.port, rate_rps=30.0, num_prompts=90)
    runner = threading.Thread(target=job.run, daemon=True)
    # the counters as the job starts, the quiet before it out of the window
    prom_clock.advance(prom.window_seconds)
    prom.scrape_once()
    runner.start()
    # the job is well under way (two thirds submitted): scrape the running
    # job's counters
    assert wait_for(lambda: len(job._threads) >= 60, timeout=10.0)
    prom.scrape_once()

    rec.run_cycle()
    va = cluster.get_variant_autoscaling(NS, "llama-premium")
    scaled_optimized = va.status.desired_optimized_alloc.num_replicas
    assert scaled_optimized > initial_optimized, (initial_optimized, scaled_optimized)
    assert scaled_optimized > 1

    # heavy-tailed lengths flow through collector averages: the observed
    # mean completion length must exceed the lognormal median (tail pull)
    load = va.status.current_alloc.load
    assert load.arrival_rate > 0
    assert load.avg_output_tokens > OUT_DIST.median * 0.8

    # actuation + gauge/status agreement under load
    assert cluster.get_deployment(NS, "llama-premium")["spec"]["replicas"] == scaled_optimized
    assert rec.emitter.desired_replicas.get(labels) == float(scaled_optimized)

    runner.join()
    job.wait(timeout=30.0)
    assert job.failed == 0, f"{job.failed} requests failed"
    assert job.completed == 90

    # -- 4. release after the job -------------------------------------------
    go_idle(prom, prom_clock)  # arrivals age out of the rate window
    rec.run_cycle()
    va = cluster.get_variant_autoscaling(NS, "llama-premium")
    released = va.status.desired_optimized_alloc.num_replicas
    assert released < scaled_optimized
    assert released <= max(initial_optimized, 1)
