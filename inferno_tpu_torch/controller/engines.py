"""Serving-engine metric vocabularies.

The reference hardcodes vLLM metric names
(upstream internal/constants/metrics.go:7-47). TPU clusters run a
mix of engines, so the collector resolves names through a per-engine
mapping: `vllm-tpu` (the vllm:* family, identical names to GPU vLLM) and
`jetstream` (Google's TPU LLM server, jetstream_* Prometheus names).

Port copy of `inferno_tpu/controller/engines.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import dataclasses

LABEL_MODEL_NAME = "model_name"
LABEL_NAMESPACE = "namespace"
# The gateway's model label is FIXED, not the engine's: the gateway
# series (gateway_request_total below) live on the inference gateway,
# which names models with the Gateway API inference extension's
# `model_name` label no matter which engine serves them — resolving it
# through engine.model_label would break JetStream (`id`) wake queries.
GATEWAY_MODEL_LABEL = LABEL_MODEL_NAME


@dataclasses.dataclass(frozen=True)
class EngineMetrics:
    """Prometheus series names for the five collector inputs."""

    name: str
    num_requests_running: str
    request_success_total: str
    prompt_tokens_sum: str
    prompt_tokens_count: str
    generation_tokens_sum: str
    generation_tokens_count: str
    ttft_seconds_sum: str
    ttft_seconds_count: str
    tpot_seconds_sum: str
    tpot_seconds_count: str
    # engine-reported max concurrent requests; "" = engine doesn't expose one
    # (the reference hardcodes 256 with a TODO, collector.go:257-259 — here
    # the collector prefers the live engine value, then the CR profile)
    max_batch_metric: str = ""
    model_label: str = LABEL_MODEL_NAME
    # Gateway-side request counter whose series exist INDEPENDENTLY of
    # engine pods — the scale-from-zero wake signal (docs/integrations/
    # keda.md): with WVA_SCALE_TO_ZERO and a variant at 0 replicas, every
    # engine series above is gone with the pods, so demand can only be
    # observed upstream. Default: the Gateway API inference extension /
    # llm-d inference-gateway per-model counter. "" disables the wake
    # signal (a sleeping variant then stays at 0 until the series name is
    # configured).
    gateway_request_total: str = "inference_model_request_total"


VLLM_TPU = EngineMetrics(
    name="vllm-tpu",
    # identical series names to CUDA vLLM (internal/constants/metrics.go:8-46)
    num_requests_running="vllm:num_requests_running",
    request_success_total="vllm:request_success_total",
    prompt_tokens_sum="vllm:request_prompt_tokens_sum",
    prompt_tokens_count="vllm:request_prompt_tokens_count",
    generation_tokens_sum="vllm:request_generation_tokens_sum",
    generation_tokens_count="vllm:request_generation_tokens_count",
    ttft_seconds_sum="vllm:time_to_first_token_seconds_sum",
    ttft_seconds_count="vllm:time_to_first_token_seconds_count",
    tpot_seconds_sum="vllm:time_per_output_token_seconds_sum",
    tpot_seconds_count="vllm:time_per_output_token_seconds_count",
    max_batch_metric="vllm:num_requests_max",
)

JETSTREAM = EngineMetrics(
    name="jetstream",
    num_requests_running="jetstream_slots_used_percentage",
    request_success_total="jetstream_request_success_count",
    prompt_tokens_sum="jetstream_request_input_length_sum",
    prompt_tokens_count="jetstream_request_input_length_count",
    generation_tokens_sum="jetstream_request_output_length_sum",
    generation_tokens_count="jetstream_request_output_length_count",
    ttft_seconds_sum="jetstream_time_to_first_token_sum",
    ttft_seconds_count="jetstream_time_to_first_token_count",
    tpot_seconds_sum="jetstream_time_per_output_token_sum",
    tpot_seconds_count="jetstream_time_per_output_token_count",
    max_batch_metric="jetstream_total_slots",
    model_label="id",
)

ENGINES: dict[str, EngineMetrics] = {e.name: e for e in (VLLM_TPU, JETSTREAM)}

# Output metric names (what the actuator emits for HPA/KEDA)
# (reference: internal/constants/metrics.go:49-79)
METRIC_SCALING_TOTAL = "inferno_replica_scaling_total"
METRIC_DESIRED_REPLICAS = "inferno_desired_replicas"
METRIC_CURRENT_REPLICAS = "inferno_current_replicas"
METRIC_DESIRED_RATIO = "inferno_desired_ratio"
LABEL_VARIANT = "variant_name"
LABEL_OUT_NAMESPACE = "namespace"
LABEL_ACCELERATOR = "accelerator"
LABEL_DIRECTION = "direction"


def engine_for(name: str) -> EngineMetrics:
    """Resolve an engine by name. Unknown names raise: a typo'd
    SERVING_ENGINE silently scraping the wrong vocabulary would surface
    only as a confusing MetricsMissing condition much later."""
    try:
        return ENGINES[name]
    except KeyError:
        raise ValueError(
            f"unknown serving engine {name!r}; supported: {sorted(ENGINES)}"
        ) from None
