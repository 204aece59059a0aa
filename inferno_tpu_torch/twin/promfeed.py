"""MiniProm/FakeProm seam between the fleet twin and the real collector.

`TwinPromFeed` owns a `controller.promclient.FakeProm` and answers the
collector's five query shapes (collect_current_alloc /
collect_grouped) from the twin's windowed observations, in the engine
series vocabulary (`controller.engines.EngineMetrics`). That couples the
REAL reconciler/solver observation path to the emulated fleet: anything
that sizes from Prometheus — the collector, the forecaster's arrival
feed, a closed-loop policy — reads the twin exactly as it would read a
live fleet, with no twin-specific branches on the controller side.

Port copy of `inferno_tpu/twin/promfeed.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import time
from collections.abc import Callable

from inferno_tpu_torch.controller.engines import VLLM_TPU, EngineMetrics
from inferno_tpu_torch.controller.promclient import FakeProm, Sample


class TwinPromFeed:
    """Publish twin window stats; serve them through FakeProm queries.

    One feed per emulated variant. `publish` replaces the current
    observation window; the FakeProm handler answers any query
    mentioning one of the engine's series names with the matching
    value, labelled for the grouped (`by (model, namespace)`) fan-out.
    """

    def __init__(
        self,
        model_id: str = "twin",
        namespace: str = "default",
        engine: EngineMetrics = VLLM_TPU,
        prom: FakeProm | None = None,
        clock: Callable[[], float] = time.time,
    ):
        """`clock` stamps served samples (INF005 seam: injectable, the
        default-arg reference) so collector staleness checks see fresh
        observations."""
        self.model_id = model_id
        self.namespace = namespace
        self.engine = engine
        self.prom = prom or FakeProm()
        self._clock = clock
        self._obs: dict[str, float] = {
            "arrival_rps": 0.0, "avg_in": 0.0, "avg_out": 0.0,
            "ttft_s": 0.0, "itl_s": 0.0, "running": 0.0,
        }
        self.prom.add_handler(self._matches, self._answer)

    # -- publication (twin side) --------------------------------------------

    def publish(
        self,
        arrival_rps: float,
        avg_in_tokens: float,
        avg_out_tokens: float,
        ttft_ms: float,
        itl_ms: float,
        running: float,
    ) -> None:
        """Install one observation window (emulated units converted to
        the wire units the engines expose: seconds, not msec)."""
        self._obs = {
            "arrival_rps": float(arrival_rps),
            "avg_in": float(avg_in_tokens),
            "avg_out": float(avg_out_tokens),
            "ttft_s": float(ttft_ms) / 1000.0,
            "itl_s": float(itl_ms) / 1000.0,
            "running": float(running),
        }

    def arrival_rpm(self) -> float:
        """The number `collect_current_alloc` derives (req/min) — kept
        readable directly so closed loops and the collector see
        one value by construction."""
        return self._obs["arrival_rps"] * 60.0

    def token_means(self) -> tuple[float, float]:
        """(avg_in_tokens, avg_out_tokens) of the current window — the
        request shape the collector's token-rate ratios derive."""
        return self._obs["avg_in"], self._obs["avg_out"]

    # -- FakeProm handler (collector side) ----------------------------------

    def _matches(self, promql: str) -> bool:
        e = self.engine
        return any(
            name and name in promql
            for name in (
                e.request_success_total, e.prompt_tokens_sum,
                e.generation_tokens_sum, e.ttft_seconds_sum,
                e.tpot_seconds_sum, e.num_requests_running,
                e.max_batch_metric,
            )
        )

    def _answer(self, promql: str) -> list[Sample]:
        e, o = self.engine, self._obs
        if e.request_success_total in promql:
            value = o["arrival_rps"]  # sum(rate(...[1m])) is req/sec
        elif e.prompt_tokens_sum in promql:
            value = o["avg_in"]
        elif e.generation_tokens_sum in promql:
            value = o["avg_out"]
        elif e.ttft_seconds_sum in promql:
            value = o["ttft_s"]
        elif e.tpot_seconds_sum in promql:
            value = o["itl_s"]
        elif e.max_batch_metric and e.max_batch_metric in promql:
            return []  # fall back to the CR profile's max batch
        else:
            value = o["running"]
        labels = {
            e.model_label: self.model_id,
            "namespace": self.namespace,
        }
        return [Sample(labels=labels, value=value, timestamp=self._clock())]
