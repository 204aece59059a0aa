"""Engine metric-vocabulary table tests (controller/engines.py): the
pluggable replacement for the reference's hardcoded vLLM names
(internal/constants/metrics.go:7-47).

Port of tests/test_engines.py on the port's modules, the expectations unchanged.
"""

import dataclasses

import pytest

from inferno_tpu_torch.controller.engines import ENGINES, JETSTREAM, VLLM_TPU, engine_for


def test_registry_contents():
    assert set(ENGINES) == {"vllm-tpu", "jetstream"}
    assert ENGINES["vllm-tpu"] is VLLM_TPU
    assert ENGINES["jetstream"] is JETSTREAM


def test_engine_for_lookup_and_unknown():
    assert engine_for("jetstream") is JETSTREAM
    with pytest.raises(Exception):
        engine_for("sglang")  # unknown engines fail loudly, not silently vLLM


@pytest.mark.parametrize("engine", [VLLM_TPU, JETSTREAM])
def test_all_series_names_populated(engine):
    for f in dataclasses.fields(engine):
        if f.name in ("max_batch_metric",):  # optional by contract
            continue
        assert getattr(engine, f.name), f"{engine.name}.{f.name} empty"


def test_vocabularies_do_not_overlap():
    """A scrape carrying both engines' series must never alias: no
    ENGINE-side series name may appear in both vocabularies. The
    gateway_request_total series is deliberately shared — it lives on the
    inference gateway, upstream of (and independent from) any engine."""
    def series(e):
        return {
            getattr(e, f.name)
            for f in dataclasses.fields(e)
            if f.name not in ("name", "model_label", "gateway_request_total")
            and getattr(e, f.name)
        }

    assert series(VLLM_TPU).isdisjoint(series(JETSTREAM))
    assert VLLM_TPU.gateway_request_total == JETSTREAM.gateway_request_total


def test_vllm_names_match_reference_constants():
    """Wire compatibility with real vLLM exporters is the point
    (reference internal/constants/metrics.go:8-46)."""
    assert VLLM_TPU.num_requests_running == "vllm:num_requests_running"
    assert VLLM_TPU.request_success_total == "vllm:request_success_total"
    assert VLLM_TPU.ttft_seconds_sum == "vllm:time_to_first_token_seconds_sum"
    assert VLLM_TPU.tpot_seconds_sum == "vllm:time_per_output_token_seconds_sum"
    assert VLLM_TPU.model_label == "model_name"


def test_jetstream_uses_id_label():
    assert JETSTREAM.model_label == "id"
