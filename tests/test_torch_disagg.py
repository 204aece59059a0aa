"""Port of tests/test_disagg.py, on the port's imports.

Tests for the disaggregated prefill/decode tandem analyzer
(inferno_tpu_torch.analyzer.disagg) and its integration into allocation sizing.

Mirrors the reference's analyzer test style (table-driven checks of the
sizing math, the upstream Go project's pkg/analyzer/queueanalyzer_test.go) for the
two-stage JetStream model the reference lacks.
"""

import dataclasses

import numpy as np
import pytest

from inferno_tpu_torch.analyzer import (
    AnalyzerError,
    RequestSize,
    TargetPerf,
    build_analyzer,
    build_disagg_analyzer,
)
from inferno_tpu_torch.config.types import (
    DecodeParms,
    DisaggSpec,
    ModelPerfSpec,
    PrefillParms,
)

DECODE = DecodeParms(alpha=20.58, beta=0.41)
PREFILL = PrefillParms(gamma=5.2, delta=0.1)
REQUEST = RequestSize(avg_in_tokens=128, avg_out_tokens=64)


def build(spec=DisaggSpec(), max_batch=16, max_queue=160, decode=DECODE,
          prefill=PREFILL, request=REQUEST):
    qa = build_disagg_analyzer(
        max_batch=max_batch,
        max_queue=max_queue,
        decode=decode,
        prefill=prefill,
        request=request,
        spec=spec,
    )
    # the reference's analyzer on the same inputs, which `analyze` and
    # `size` below hold the port's to (the analyzer is frozen: kept aside)
    _REFERENCE[id(qa)] = (qa, ref_build(spec, max_batch, max_queue, decode, prefill, request))
    return qa


_REFERENCE: dict = {}


def ref_build(spec, max_batch, max_queue, decode, prefill, request):
    from inferno_tpu.analyzer import RequestSize as RefRequestSize
    from inferno_tpu.analyzer import build_disagg_analyzer as ref_build_disagg_analyzer
    from inferno_tpu.config.types import DecodeParms as RefDecodeParms
    from inferno_tpu.config.types import DisaggSpec as RefDisaggSpec
    from inferno_tpu.config.types import PrefillParms as RefPrefillParms

    return ref_build_disagg_analyzer(
        max_batch=max_batch,
        max_queue=max_queue,
        decode=RefDecodeParms(**dataclasses.asdict(decode)),
        prefill=RefPrefillParms(**dataclasses.asdict(prefill)),
        request=RefRequestSize(**request._asdict()) if hasattr(request, "_asdict")
        else RefRequestSize(**dataclasses.asdict(request)),
        spec=RefDisaggSpec(**dataclasses.asdict(spec)),
    )


def analyze(qa, rate):
    """qa.analyze(rate), equal to the reference's in every field."""
    got = qa.analyze(rate)
    assert repr(got) == repr(_REFERENCE[id(qa)][1].analyze(rate))
    return got


def size(qa, targets):
    """qa.size(targets), equal to the reference's in every field."""
    from inferno_tpu.analyzer import TargetPerf as RefTargetPerf

    got = qa.size(targets)
    ref = _REFERENCE[id(qa)][1]
    assert repr(got) == repr(ref.size(RefTargetPerf(**dataclasses.asdict(targets))))
    return got


class TestBuild:
    def test_stable_range_positive(self):
        qa = build()
        assert 0 < qa.lambda_min < qa.lambda_max
        assert qa.max_rate == pytest.approx(qa.lambda_max * 1000.0)

    def test_unit_max_is_binding_stage(self):
        qa = build()
        p_max = float(qa.prefill_serv_rates[-1])
        d_max = float(qa.decode_serv_rates[-1])
        assert qa.lambda_max == pytest.approx(min(p_max, d_max), rel=2e-3)

    def test_prefill_batch_defaults_to_decode_batch(self):
        qa = build()
        assert qa.prefill_max_batch == qa.decode_max_batch == 16

    def test_prefill_batch_override(self):
        qa = build(spec=DisaggSpec(prefill_max_batch=4))
        assert qa.prefill_max_batch == 4
        assert qa.decode_max_batch == 16

    def test_requires_prefill_stage(self):
        with pytest.raises(AnalyzerError):
            build(request=RequestSize(avg_in_tokens=0, avg_out_tokens=64))

    def test_invalid_spec_rejected(self):
        with pytest.raises(AnalyzerError):
            build(spec=DisaggSpec(prefill_slices=0))

    def test_invalid_batch_rejected(self):
        with pytest.raises(AnalyzerError):
            build(max_batch=0)


class TestAnalyze:
    def test_metrics_sane_at_low_rate(self):
        qa = build()
        m = analyze(qa, qa.max_rate * 0.1)
        # near-idle: ITL ~ decode at batch ~1, TTFT ~ bare prefill
        assert DECODE.alpha < m.avg_token_time < DECODE.alpha + DECODE.beta * 16
        assert m.avg_prefill_time >= PREFILL.gamma
        assert m.avg_wait_time >= 0
        assert m.throughput == pytest.approx(qa.max_rate * 0.1, rel=0.05)

    def test_latency_increases_with_rate(self):
        qa = build()
        lo = analyze(qa, qa.max_rate * 0.2)
        hi = analyze(qa, qa.max_rate * 0.9)
        assert hi.avg_token_time > lo.avg_token_time
        assert hi.avg_resp_time > lo.avg_resp_time

    def test_rejects_rate_above_max(self):
        qa = build()
        with pytest.raises(AnalyzerError):
            analyze(qa, qa.max_rate * 1.5)

    def test_rejects_non_positive_rate(self):
        qa = build()
        with pytest.raises(AnalyzerError):
            analyze(qa, 0.0)

    def test_response_decomposition(self):
        qa = build()
        m = analyze(qa, qa.max_rate * 0.5)
        # response = waits + prefill + decode-stage service
        assert m.avg_resp_time >= m.avg_wait_time + m.avg_prefill_time

    def test_rho_reflects_binding_prefill_stage(self):
        # prefill-bound unit: long prompts, almost no decode work
        qa = build(
            prefill=PrefillParms(gamma=50.0, delta=1.0),
            request=RequestSize(avg_in_tokens=512, avg_out_tokens=4),
        )
        m = analyze(qa, qa.max_rate * 0.98)
        assert m.rho > 0.5, "saturated prefill-bound unit must not report idle"


class TestSize:
    def test_itl_binding_matches_single_stage_when_prefill_negligible(self):
        """With a vanishing prefill stage the tandem collapses to the
        aggregated model: the ITL-bound rates must agree closely."""
        tiny = PrefillParms(gamma=1e-4, delta=1e-7)
        request = RequestSize(avg_in_tokens=1, avg_out_tokens=64)
        targets = TargetPerf(target_itl=24.0)

        dis = build(prefill=tiny, request=request)
        agg = build_analyzer(
            max_batch=16, max_queue=160, decode=DECODE, prefill=tiny, request=request
        )
        r_dis, _, _ = size(dis, targets)
        r_agg, _, _ = agg.size(targets)
        assert r_dis.rate_target_itl == pytest.approx(r_agg.rate_target_itl, rel=0.02)

    def test_ttft_target_binds(self):
        # short outputs make decode fast, so the prefill stage binds
        qa = build(request=RequestSize(avg_in_tokens=128, avg_out_tokens=8))
        rates, metrics, achieved = size(qa, TargetPerf(target_ttft=50.0))
        assert rates.rate_target_ttft <= rates.rate_target_itl
        assert achieved.target_ttft == pytest.approx(50.0, rel=0.05)

    def test_itl_target_binds(self):
        qa = build()
        rates, metrics, achieved = size(qa, TargetPerf(target_itl=24.0))
        assert rates.rate_target_itl < qa.max_rate
        assert achieved.target_itl == pytest.approx(24.0, rel=0.05)

    def test_unachievable_itl_raises(self):
        qa = build()
        with pytest.raises(AnalyzerError):
            size(qa, TargetPerf(target_itl=DECODE.alpha * 0.5))

    def test_more_prefill_engines_raise_ttft_bound_rate(self):
        # near-instant decode (2 output tokens) keeps the prefill stage
        # binding regardless of how many prefill engines the unit has
        request = RequestSize(avg_in_tokens=128, avg_out_tokens=2)
        one = build(spec=DisaggSpec(prefill_slices=1), request=request)
        two = build(spec=DisaggSpec(prefill_slices=2), request=request)
        t = TargetPerf(target_ttft=400.0)
        r1, _, _ = size(one, t)
        r2, _, _ = size(two, t)
        assert r2.rate_target_ttft > r1.rate_target_ttft * 1.5

    def test_more_decode_engines_raise_itl_bound_rate(self):
        one = build(spec=DisaggSpec(decode_slices=1))
        two = build(spec=DisaggSpec(decode_slices=2))
        t = TargetPerf(target_itl=24.0)
        r1, _, _ = size(one, t)
        r2, _, _ = size(two, t)
        assert r2.rate_target_itl > r1.rate_target_itl * 1.5

    def test_tps_cap(self):
        qa = build()
        rates, _, _ = size(qa, TargetPerf(target_tps=100.0))
        assert rates.rate_target_tps < qa.max_rate


class TestEvalMonotonicity:
    """Bisection preconditions: stage evaluations are nondecreasing in
    lambda across the stable range."""

    def test_ttft_monotone(self):
        qa = build()
        lams = np.linspace(qa.lambda_min, qa.lambda_max, 12)
        vals = [qa._ttft_at(l) for l in lams]
        assert all(b >= a - 1e-9 for a, b in zip(vals, vals[1:]))

    def test_itl_monotone(self):
        qa = build()
        lams = np.linspace(qa.lambda_min, qa.lambda_max, 12)
        vals = [qa._itl_at(l) for l in lams]
        assert all(b >= a - 1e-9 for a, b in zip(vals, vals[1:]))


class TestSpecRoundTrip:
    def test_model_perf_spec_with_disagg(self):
        spec = ModelPerfSpec(
            name="llama-3.1-8b",
            acc="v5e-8",
            max_batch_size=32,
            at_tokens=64,
            decode_parms=DECODE,
            prefill_parms=PREFILL,
            disagg=DisaggSpec(prefill_slices=2, decode_slices=3, prefill_max_batch=4),
        )
        back = ModelPerfSpec.from_dict(spec.to_dict())
        assert back.disagg == spec.disagg
        assert back.disagg.slices_per_unit == 5

    def test_model_perf_spec_without_disagg(self):
        spec = ModelPerfSpec(name="m", acc="v5e-4")
        back = ModelPerfSpec.from_dict(spec.to_dict())
        assert back.disagg is None

    def test_empty_mapping_enables_defaults(self):
        # "disagg": {} means "enable with defaults", not "absent"
        spec = ModelPerfSpec.from_dict(
            {"name": "m", "acc": "v5e-4", "disagg": {}}
        )
        assert spec.disagg == DisaggSpec()

    def test_invalid_compute_backend_rejected(self):
        from inferno_tpu_torch.controller import ReconcilerConfig

        with pytest.raises(ValueError):
            ReconcilerConfig(compute_backend="Native")

    def test_explicit_zero_engines_not_coerced(self):
        # an explicit invalid 0 must survive parsing so validation rejects it
        spec = DisaggSpec.from_dict({"prefillSlices": 0, "decodeSlices": 4})
        assert spec.prefill_slices == 0
        with pytest.raises(AnalyzerError):
            build(spec=spec)


class TestAllocationIntegration:
    def _spec(self, disagg):
        from inferno_tpu_torch.config.types import (
            AcceleratorSpec,
            ModelTarget,
            ServerLoadSpec,
            ServerSpec,
            ServiceClassSpec,
            SystemSpec,
        )

        return SystemSpec(
            accelerators=[AcceleratorSpec(name="v5e-8", cost_per_chip_hr=1.2)],
            models=[
                ModelPerfSpec(
                    name="llama-3.1-8b",
                    acc="v5e-8",
                    max_batch_size=16,
                    at_tokens=64,
                    decode_parms=DECODE,
                    prefill_parms=PREFILL,
                    disagg=disagg,
                )
            ],
            service_classes=[
                ServiceClassSpec(
                    name="premium",
                    priority=1,
                    model_targets=[
                        ModelTarget(model="llama-3.1-8b", slo_itl=24.0, slo_ttft=500.0)
                    ],
                )
            ],
            servers=[
                ServerSpec(
                    name="default/llama",
                    class_name="premium",
                    model="llama-3.1-8b",
                    min_num_replicas=1,
                )
            ],
        )

    def _size(self, disagg):
        from inferno_tpu_torch.config.types import ServerLoadSpec
        from inferno_tpu_torch.core import System
        from inferno_tpu_torch.core.allocation import create_allocation

        spec = self._spec(disagg)
        system = System(spec)
        system.servers["default/llama"].load = ServerLoadSpec(
            arrival_rate=240.0, avg_in_tokens=128, avg_out_tokens=64
        )
        got = create_allocation(system, "default/llama", "v5e-8")
        # the reference's scalar sizing of the same spec: equal field for field
        from inferno_tpu.config.types import ServerLoadSpec as RefServerLoadSpec
        from inferno_tpu.config.types import SystemSpec as RefSystemSpec
        from inferno_tpu.core import System as RefSystem
        from inferno_tpu.core.allocation import create_allocation as ref_create_allocation

        ref = RefSystem(RefSystemSpec.from_dict(spec.to_dict()))
        ref.servers["default/llama"].load = RefServerLoadSpec(
            arrival_rate=240.0, avg_in_tokens=128, avg_out_tokens=64
        )
        assert repr(got) == repr(ref_create_allocation(ref, "default/llama", "v5e-8"))
        return got

    def test_disagg_cost_counts_unit_slices(self):
        base = self._size(None)
        dis = self._size(DisaggSpec(prefill_slices=1, decode_slices=1))
        assert base is not None and dis is not None
        # one disagg unit = 2 slices -> cost per replica doubles
        cost_per_replica_base = base.cost / base.num_replicas
        cost_per_replica_dis = dis.cost / dis.num_replicas
        assert cost_per_replica_dis == pytest.approx(2 * cost_per_replica_base)

    def test_footprint_multiplies_slices_per_engine(self):
        # each engine spanning 2 slices: unit = 2 * (1 + 1) = 4 slices
        from inferno_tpu_torch.core import System

        spec = self._spec(DisaggSpec(prefill_slices=1, decode_slices=1))
        spec.models[0].slices_per_replica = 2
        system = System(spec)
        assert (
            system.models["llama-3.1-8b"].slices_per_replica("v5e-8") == 4
        )

    def test_disagg_sizing_feasible(self):
        dis = self._size(DisaggSpec(prefill_slices=1, decode_slices=2))
        assert dis is not None
        assert dis.num_replicas >= 1
        assert dis.itl <= 24.0 * 1.05

    def test_fleet_path_covers_disagg_lanes(self):
        from inferno_tpu_torch.config.types import ServerLoadSpec
        from inferno_tpu_torch.core import System
        from inferno_tpu_torch.parallel import calculate_fleet

        spec = self._spec(DisaggSpec(prefill_slices=1, decode_slices=1))
        system = System(spec)
        system.servers["default/llama"].load = ServerLoadSpec(
            arrival_rate=240.0, avg_in_tokens=128, avg_out_tokens=64
        )
        n = calculate_fleet(system, backend="torch", device="cpu")
        assert n == 1
        allocs = system.servers["default/llama"].all_allocations
        assert "v5e-8" in allocs
        # parity with the scalar tandem analyzer (f32 batched kernel vs the
        # f64 DisaggAnalyzer: ceil() may round a near-integer boundary
        # differently, hence the 1-replica tolerance like test_fleet.py)
        scalar = self._size(DisaggSpec(prefill_slices=1, decode_slices=1))
        assert abs(allocs["v5e-8"].num_replicas - scalar.num_replicas) <= 1
        per_replica_cost = scalar.cost / scalar.num_replicas
        assert allocs["v5e-8"].cost == pytest.approx(
            per_replica_cost * allocs["v5e-8"].num_replicas
        )
        # the reference's batched path on the same lane
        from inferno_tpu.config.types import ServerLoadSpec as RefServerLoadSpec
        from inferno_tpu.config.types import SystemSpec as RefSystemSpec
        from inferno_tpu.core import System as RefSystem
        from inferno_tpu.parallel import calculate_fleet as ref_calculate_fleet

        ref = RefSystem(RefSystemSpec.from_dict(spec.to_dict()))
        ref.servers["default/llama"].load = RefServerLoadSpec(
            arrival_rate=240.0, avg_in_tokens=128, avg_out_tokens=64
        )
        assert ref_calculate_fleet(ref, backend="jax") == 1
        want = ref.servers["default/llama"].all_allocations["v5e-8"]
        got = allocs["v5e-8"]
        assert got.max_arrv_rate_per_replica == pytest.approx(
            want.max_arrv_rate_per_replica, rel=1e-4)
        if got.num_replicas == want.num_replicas:
            assert got.cost == pytest.approx(want.cost, rel=1e-5)
        else:  # a ceil boundary: the port's comparison rule
            assert abs(got.num_replicas - want.num_replicas) == 1
