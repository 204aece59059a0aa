"""Port of tests/test_fuzz_parity.py, on the port's imports.

Seeded randomized sweeps: CRD wire round-trips and scalar-vs-batched
backend parity on generated fleets.

The fixture-based parity tests pin known shapes; these sweeps walk a
randomized corner of the space every CI run (fixed seeds — failures are
reproducible) the way the reference's table-driven suites blanket theirs.
"""

import dataclasses

import numpy as np
import pytest

from inferno_tpu_torch.config.types import (
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
from inferno_tpu_torch.controller.crd import VariantAutoscaling
from inferno_tpu_torch.core import System
from inferno_tpu_torch.parallel import calculate_fleet, reset_fleet_state
from inferno_tpu_torch.solver import solve_unlimited
from inferno_tpu_torch.testing.fleet import assert_same_decisions

SHAPES = ["v5e-1", "v5e-4", "v5e-8", "v5e-16"]


def random_spec(rng: np.random.Generator, n_servers: int) -> SystemSpec:
    models = []
    for shape in SHAPES:
        models.append(ModelPerfSpec(
            name="m", acc=shape,
            max_batch_size=int(rng.choice([8, 16, 32, 64])),
            at_tokens=128,
            decode_parms=DecodeParms(
                alpha=float(rng.uniform(3.0, 20.0)),
                beta=float(rng.uniform(0.05, 0.5)),
            ),
            prefill_parms=PrefillParms(
                gamma=float(rng.uniform(1.0, 8.0)),
                delta=float(rng.uniform(0.005, 0.05)),
            ),
            disagg=(
                DisaggSpec(prefill_slices=1, decode_slices=int(rng.integers(1, 4)))
                if rng.random() < 0.3 else None
            ),
        ))
    classes = [ServiceClassSpec(
        name="C", priority=1,
        model_targets=[ModelTarget(
            model="m",
            slo_itl=float(rng.uniform(25.0, 200.0)),
            slo_ttft=float(rng.uniform(300.0, 3000.0)),
        )],
    )]
    servers = [
        ServerSpec(
            name=f"ns/s{i}", class_name="C", model="m", min_num_replicas=1,
            current_alloc=AllocationData(load=ServerLoadSpec(
                arrival_rate=float(rng.uniform(0.0, 6000.0)),  # incl. idle
                avg_in_tokens=int(rng.integers(16, 2048)),
                avg_out_tokens=int(rng.integers(8, 512)),
            )),
        )
        for i in range(n_servers)
    ]
    return SystemSpec(
        accelerators=[AcceleratorSpec(name=s, cost_per_chip_hr=1.2) for s in SHAPES],
        models=models, service_classes=classes, servers=servers,
        optimizer=OptimizerSpec(unlimited=True), capacity=CapacitySpec(),
    )


@pytest.mark.parametrize("seed", range(4))
def test_backend_parity_random_fleets(seed):
    """Scalar (semantic definition) vs the batched XLA kernel on random
    fleets, including disagg lanes and idle servers."""
    spec = random_spec(np.random.default_rng(seed), n_servers=8)
    scalar, batched = System(spec), System(spec)
    scalar.calculate_all()
    reset_fleet_state()
    calculate_fleet(batched, backend="torch", device="cpu")
    reset_fleet_state()
    checked = 0
    for name, s_server in scalar.servers.items():
        b_server = batched.servers[name]
        assert set(b_server.all_allocations) == set(s_server.all_allocations), name
        for acc, s_alloc in s_server.all_allocations.items():
            b_alloc = b_server.all_allocations[acc]
            assert b_alloc.batch_size == s_alloc.batch_size, (name, acc)
            assert abs(b_alloc.num_replicas - s_alloc.num_replicas) <= 1, (
                name, acc, b_alloc.num_replicas, s_alloc.num_replicas)
            if s_alloc.max_arrv_rate_per_replica > 0:
                assert b_alloc.max_arrv_rate_per_replica == pytest.approx(
                    s_alloc.max_arrv_rate_per_replica, rel=2e-2
                ), (name, acc)
            checked += 1
    assert checked >= 16
    # and the reference's batched path on the same fleet decides as the
    # port's (the port's comparison rule: ±1 replicas only at a ceil
    # boundary, cost and value within 1e-5)
    from inferno_tpu.config.types import SystemSpec as RefSystemSpec
    from inferno_tpu.core import System as RefSystem
    from inferno_tpu.parallel import calculate_fleet as ref_calculate_fleet
    from inferno_tpu.solver import solve_unlimited as ref_solve_unlimited

    ref = RefSystem(RefSystemSpec.from_dict(spec.to_dict()))
    ref_calculate_fleet(ref, backend="jax")
    ref_solve_unlimited(ref)
    solve_unlimited(batched)
    assert_same_decisions(ref, batched)


@pytest.mark.parametrize("seed", range(8))
def test_crd_round_trip_random_documents(seed):
    """to_dict/from_dict identity on randomized VariantAutoscaling docs,
    including disagg blocks, context buckets, conditions, and status."""
    rng = np.random.default_rng(seed)

    def parms():
        return {
            "decodeParms": {"alpha": str(round(rng.uniform(1, 30), 3)),
                            "beta": str(round(rng.uniform(0.01, 1), 4))},
            "prefillParms": {"gamma": str(round(rng.uniform(0.5, 10), 3)),
                             "delta": str(round(rng.uniform(1e-4, 0.1), 5))},
        }

    accels = []
    for shape in rng.choice(SHAPES, size=rng.integers(1, 4), replace=False):
        prof = {
            "acc": str(shape),
            "accCount": int(rng.integers(1, 3)),
            "maxBatchSize": int(rng.choice([8, 64, 256])),
            "atTokens": int(rng.choice([0, 128, 1280])),
            "perfParms": parms(),
        }
        if rng.random() < 0.5:
            prof["disagg"] = {"prefillSlices": int(rng.integers(1, 3)),
                              "decodeSlices": int(rng.integers(1, 5))}
        if rng.random() < 0.5:
            prof["contextBuckets"] = [
                {"maxInTokens": int(t), "maxBatchSize": int(rng.choice([0, 16])),
                 "perfParms": parms()}
                for t in rng.choice([2048, 8192, 32768],
                                    size=rng.integers(1, 3), replace=False)
            ]
        accels.append(prof)

    doc = {
        "apiVersion": "llmd.ai/v1alpha1",
        "kind": "VariantAutoscaling",
        "metadata": {"name": f"v{seed}", "namespace": "ns",
                     "labels": {"inference.optimization/acceleratorName": "v5e-4"}},
        "spec": {
            "modelID": "m/x",
            "sloClassRef": {"name": "svc", "key": "Premium"},
            "modelProfile": {"accelerators": accels},
        },
    }
    va = VariantAutoscaling.from_dict(doc)
    once = va.to_dict()
    again = VariantAutoscaling.from_dict(once).to_dict()
    assert once == again  # fixpoint after one normalization pass
    # the reference normalizes the same document to the same wire form
    from inferno_tpu.controller.crd import VariantAutoscaling as RefVariantAutoscaling

    assert RefVariantAutoscaling.from_dict(doc).to_dict() == once
    # structural checks survive the trip
    back = VariantAutoscaling.from_dict(again)
    assert len(back.spec.accelerators) == len(accels)
    for orig, parsed in zip(
        sorted(accels, key=lambda a: a["acc"]),
        sorted(back.spec.accelerators, key=lambda a: a.acc),
    ):
        assert parsed.acc == orig["acc"]
        assert parsed.max_batch_size == orig["maxBatchSize"]
        if "disagg" in orig:
            assert parsed.disagg.decode_slices == orig["disagg"]["decodeSlices"]
        if "contextBuckets" in orig:
            assert len(parsed.context_buckets) == len(orig["contextBuckets"])


@pytest.mark.parametrize("seed", range(4))
def test_native_backend_parity_random_fleets(seed):
    """The C++ solver (the compute_backend='auto' production path on
    controller pods without a TPU attachment) against the scalar
    definition on the same random fleets — aggregated AND tandem lanes,
    idle servers included."""
    from inferno_tpu_torch import native

    if not native.available():
        pytest.skip(f"native solver unavailable: {native.load_error()}")
    spec = random_spec(np.random.default_rng(seed), n_servers=8)
    scalar, nat = System(spec), System(spec)
    scalar.calculate_all()
    reset_fleet_state()
    calculate_fleet(nat, backend="native")
    reset_fleet_state()
    checked = 0
    for name, s_server in scalar.servers.items():
        n_server = nat.servers[name]
        assert set(n_server.all_allocations) == set(s_server.all_allocations), name
        for acc, s_alloc in s_server.all_allocations.items():
            n_alloc = n_server.all_allocations[acc]
            assert n_alloc.batch_size == s_alloc.batch_size, (name, acc)
            assert abs(n_alloc.num_replicas - s_alloc.num_replicas) <= 1, (
                name, acc, n_alloc.num_replicas, s_alloc.num_replicas)
            if s_alloc.max_arrv_rate_per_replica > 0:
                assert n_alloc.max_arrv_rate_per_replica == pytest.approx(
                    s_alloc.max_arrv_rate_per_replica, rel=2e-2
                ), (name, acc)
            checked += 1
    assert checked >= 16
    # the reference's C++ solver on the same fleet: every candidate equal
    # bit for bit (the same source, the same flags)
    from inferno_tpu import native as ref_native
    from inferno_tpu.config.types import SystemSpec as RefSystemSpec
    from inferno_tpu.core import System as RefSystem
    from inferno_tpu.parallel import calculate_fleet as ref_calculate_fleet

    assert ref_native.available(), ref_native.load_error()
    ref = RefSystem(RefSystemSpec.from_dict(spec.to_dict()))
    ref_calculate_fleet(ref, backend="native")
    for name, r_server in ref.servers.items():
        n_allocs = nat.servers[name].all_allocations
        assert set(n_allocs) == set(r_server.all_allocations), name
        for acc, r_alloc in r_server.all_allocations.items():
            assert dataclasses.asdict(n_allocs[acc]) == dataclasses.asdict(r_alloc), (name, acc)
