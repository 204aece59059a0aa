"""The port's native (C++) queueing solver (inferno_tpu_torch.native) and
its backend "native".

Port of tests/test_native.py: the C++ path must agree with the scalar
analyzer (the semantic definition) and with the batched sizing (here the
port's plain torch versions of the kernels, on the CPU), the same way the
upstream project validates its single solver with table-driven cases
(pkg/analyzer/queueanalyzer_test.go). No case skips: g++ is part of the
toolchain the port needs for this backend, and a failed build raises.

Added: the port's library against the reference's, bit for bit (the
same source, the same flags), for the sizers and both refolds; backend
"native" against backend "torch" on a 200-variant edge fleet (equal
feasibility, replicas within ±1, rate_star and itl within 5e-3: the
tolerances of tests/test_native.py's kernel comparison); a controller
cycle on COMPUTE_BACKEND=native and a planner week on --backend native;
a broken build raises instead of falling back.
"""

import numpy as np
import pytest
import torch

from inferno_tpu_torch import native
from inferno_tpu_torch.analyzer import RequestSize, TargetPerf, build_analyzer
from inferno_tpu_torch.config.types import DecodeParms, PrefillParms, SystemSpec
from inferno_tpu_torch.ops import queueing as Q
from inferno_tpu_torch.ops.queueing import FleetParams

CPU = torch.device("cpu")


def _t(params):
    """numpy FleetParams/TandemParams -> the port's CPU tensors."""
    if isinstance(params, Q.TandemParams):
        return Q.tandem_params_from_numpy(params, CPU)
    return Q.fleet_params_from_numpy(params, CPU)


def _np(res):
    return Q.FleetResult(*(np.asarray(f) for f in res))


def _port_spec(ref_spec):
    return SystemSpec.from_dict(ref_spec.to_dict())


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for a test's torch passes: they are small, and
    the suite's other workers already hold the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_params(n_lanes=16, seed=0):
    rng = np.random.default_rng(seed)
    max_batch = rng.integers(4, 48, n_lanes).astype(np.int32)
    return FleetParams(
        alpha=rng.uniform(3.0, 25.0, n_lanes).astype(np.float64),
        beta=rng.uniform(0.05, 0.5, n_lanes).astype(np.float64),
        gamma=rng.uniform(1.0, 8.0, n_lanes).astype(np.float64),
        delta=rng.uniform(0.005, 0.05, n_lanes).astype(np.float64),
        in_tokens=rng.integers(32, 1024, n_lanes).astype(np.float64),
        out_tokens=rng.integers(8, 256, n_lanes).astype(np.float64),
        max_batch=max_batch,
        occupancy_cap=(max_batch * 11).astype(np.int32),
        target_ttft=np.full(n_lanes, 1000.0),
        target_itl=rng.uniform(25.0, 150.0, n_lanes),
        target_tps=np.zeros(n_lanes),
        total_rate=rng.uniform(1.0, 60.0, n_lanes),
        min_replicas=np.ones(n_lanes, np.int32),
        cost_per_replica=rng.uniform(10.0, 500.0, n_lanes),
    )


def test_builds_and_loads():
    assert native.available()


def test_matches_scalar_analyzer():
    """Lane-by-lane agreement with the scalar (semantic-definition) path."""
    params = make_params(n_lanes=24, seed=3)
    res = native.fleet_size_native(params)
    for i in range(24):
        qa = build_analyzer(
            max_batch=int(params.max_batch[i]),
            max_queue=int(params.occupancy_cap[i] - params.max_batch[i]),
            decode=DecodeParms(float(params.alpha[i]), float(params.beta[i])),
            prefill=PrefillParms(float(params.gamma[i]), float(params.delta[i])),
            request=RequestSize(
                avg_in_tokens=int(params.in_tokens[i]),
                avg_out_tokens=int(params.out_tokens[i]),
            ),
        )
        try:
            rates, metrics, _ = qa.size(
                TargetPerf(
                    target_ttft=float(params.target_ttft[i]),
                    target_itl=float(params.target_itl[i]),
                )
            )
        except Exception:
            assert not res.feasible[i], f"lane {i}: scalar infeasible, native not"
            continue
        assert res.feasible[i], f"lane {i}: scalar feasible, native not"
        lam_scalar = min(rates.rate_target_ttft, rates.rate_target_itl) / 1000.0
        assert res.lambda_star[i] == pytest.approx(lam_scalar, rel=1e-3), f"lane {i}"
        assert res.rate_star[i] == pytest.approx(metrics.throughput, rel=1e-3), (
            f"lane {i}"
        )


def test_matches_torch_fleet_size():
    """Batched agreement with the port's sizing program (the plain torch
    version of the kernels, on the CPU) on its own grid."""
    params = make_params(n_lanes=16, seed=7)
    f32 = FleetParams(
        *(
            np.asarray(a, np.float32) if a.dtype == np.float64 else a
            for a in params
        )
    )
    k_max = int(params.occupancy_cap.max())
    jres = _np(Q.fleet_size(_t(f32), k_max))
    nres = native.fleet_size_native(params)
    np.testing.assert_array_equal(np.asarray(jres.feasible), nres.feasible)
    # f32 vs f64 bisection: replica counts may differ by 1 at ceil boundaries
    assert (
        np.abs(np.asarray(jres.num_replicas) - nres.num_replicas) <= 1
    ).all()
    np.testing.assert_allclose(
        np.asarray(jres.rate_star), nres.rate_star, rtol=5e-3
    )
    np.testing.assert_allclose(np.asarray(jres.itl), nres.itl, rtol=5e-3)


def test_replica_arithmetic():
    """ceil(total/rate*), min_replicas floor, cost multiplication."""
    params = make_params(n_lanes=8, seed=11)
    res = native.fleet_size_native(params)
    for i in range(8):
        if not res.feasible[i]:
            continue
        expect = max(
            int(np.ceil(params.total_rate[i] / res.rate_star[i])),
            int(params.min_replicas[i]),
            1,
        )
        assert res.num_replicas[i] == expect
        assert res.cost[i] == pytest.approx(
            expect * params.cost_per_replica[i]
        )


def test_infeasible_itl_flagged():
    params = make_params(n_lanes=4, seed=5)
    tight = params._replace(target_itl=params.alpha * 0.5)  # below decode base
    res = native.fleet_size_native(tight)
    assert not res.feasible.any()


def test_invalid_lane_rejected_not_crashing():
    params = make_params(n_lanes=3, seed=1)
    bad = params._replace(max_batch=np.array([0, 8, 8], np.int32))
    res = native.fleet_size_native(bad)
    assert not res.feasible[0]
    assert res.num_replicas[0] == 0
    assert res.feasible[1] or res.feasible[2] or True  # others processed


def test_threaded_matches_sequential():
    params = make_params(n_lanes=32, seed=13)
    seq = native.fleet_size_native(params, n_threads=1)
    par = native.fleet_size_native(params, n_threads=4)
    np.testing.assert_array_equal(seq.feasible, par.feasible)
    np.testing.assert_array_equal(seq.num_replicas, par.num_replicas)
    np.testing.assert_allclose(seq.rate_star, par.rate_star)


def test_calculate_fleet_native_backend():
    """The native backend plugs into calculate_fleet with identical results
    to the scalar path."""
    from fixtures import make_server, make_system_spec
    from inferno_tpu_torch.core import System
    from inferno_tpu_torch.parallel import calculate_fleet

    servers = [
        make_server(name="ns/premium", class_name="Premium", arrival_rate=600.0),
        make_server(name="ns/freemium", class_name="Freemium", arrival_rate=2400.0,
                    in_tokens=256, out_tokens=64),
    ]
    sys_native = System(_port_spec(make_system_spec(servers)))
    sys_scalar = System(_port_spec(make_system_spec(servers)))
    calculate_fleet(sys_native, backend="native")
    sys_scalar.calculate_all()
    for name, server in sys_scalar.servers.items():
        nat = sys_native.servers[name].all_allocations
        assert set(nat) == set(server.all_allocations)
        for acc, alloc in server.all_allocations.items():
            assert nat[acc].num_replicas == alloc.num_replicas, (name, acc)
            assert nat[acc].cost == pytest.approx(alloc.cost, rel=1e-6)


def test_tandem_native_matches_scalar_disagg():
    """Lane-by-lane parity of the C++ tandem solver vs DisaggAnalyzer
    through calculate_fleet(backend="native") — the native backend now
    covers disaggregated variants on the host."""
    from inferno_tpu.config.types import DisaggSpec
    from fixtures import make_server, make_system_spec
    from inferno_tpu_torch.core import System
    from inferno_tpu_torch.parallel import calculate_fleet

    servers = [
        make_server(name="ns/jet-premium", class_name="Premium", arrival_rate=600.0),
        make_server(name="ns/jet-freemium", class_name="Freemium",
                    arrival_rate=2400.0, in_tokens=256, out_tokens=64),
    ]
    spec = make_system_spec(servers)
    for perf in spec.models:
        if perf.acc == "v5p-8":
            continue  # mixed fleet: one shape stays aggregated
        perf.disagg = DisaggSpec(
            prefill_slices=1, decode_slices=2,
            prefill_max_batch=8 if perf.acc == "v5e-4" else 0,
        )
    sys_native = System(_port_spec(spec))
    sys_scalar = System(_port_spec(spec))
    calculate_fleet(sys_native, backend="native")
    sys_scalar.calculate_all()
    n_checked = 0
    for name, server in sys_scalar.servers.items():
        nat = sys_native.servers[name].all_allocations
        assert set(nat) == set(server.all_allocations), name
        for acc, alloc in server.all_allocations.items():
            got = nat[acc]
            assert got.batch_size == alloc.batch_size, (name, acc)
            assert abs(got.num_replicas - alloc.num_replicas) <= 1, (name, acc)
            assert got.max_arrv_rate_per_replica == pytest.approx(
                alloc.max_arrv_rate_per_replica, rel=2e-2
            ), (name, acc)
            assert got.itl == pytest.approx(alloc.itl, rel=5e-2, abs=0.5)
            assert got.ttft == pytest.approx(alloc.ttft, rel=5e-2, abs=2.0)
            assert got.rho == pytest.approx(alloc.rho, rel=5e-2, abs=0.02)
            # compare per-replica pricing, not total cost: replica counts
            # may legitimately differ by 1 at a ceil() boundary
            assert got.cost == pytest.approx(
                got.num_replicas * alloc.cost / alloc.num_replicas, rel=1e-5
            )
            n_checked += 1
    assert n_checked >= 6


def test_tandem_native_matches_torch_tandem_sizing():
    """Raw solver parity: inferno_tandem_size vs the port's batched tandem
    sizing (plain torch, on the CPU) on the same TandemParams."""
    from inferno_tpu.config.types import DisaggSpec
    from fixtures import make_server, make_system_spec
    from inferno_tpu_torch.core import System
    from inferno_tpu_torch.parallel import build_tandem_fleet
    from inferno_tpu_torch.parallel.fleet import _solve_all

    spec = make_system_spec([
        make_server(name="ns/a", class_name="Premium", arrival_rate=900.0),
        make_server(name="ns/b", class_name="Freemium", arrival_rate=3000.0,
                    in_tokens=512, out_tokens=96),
    ])
    for perf in spec.models:
        perf.disagg = DisaggSpec(prefill_slices=2, decode_slices=3)
    system = System(_port_spec(spec))
    # candidate scaffolding (normally done inside calculate_fleet)
    for server in system.servers.values():
        server.all_allocations = {}
    plan = build_tandem_fleet(system)
    assert plan is not None and plan.num_lanes >= 4

    _, batched = _solve_all(None, plan, CPU, Q.DEFAULT_BISECT_ITERS, False)
    nat = native.tandem_size_native(plan.params)
    np.testing.assert_array_equal(np.asarray(batched.feasible), nat.feasible)
    for i in range(plan.num_lanes):
        if not nat.feasible[i]:
            continue
        assert nat.rate_star[i] == pytest.approx(
            float(np.asarray(batched.rate_star)[i]), rel=2e-2
        )
        assert abs(int(nat.num_replicas[i]) - int(np.asarray(batched.num_replicas)[i])) <= 1
        assert nat.itl[i] == pytest.approx(float(np.asarray(batched.itl)[i]), rel=5e-2, abs=0.5)
        assert nat.ttft[i] == pytest.approx(float(np.asarray(batched.ttft)[i]), rel=5e-2, abs=2.0)


def test_tandem_native_invalid_lane_rejected_not_crashing():
    class P:
        alpha = np.array([5.0]); beta = np.array([0.1])
        gamma = np.array([2.0]); delta = np.array([0.01])
        in_tokens = np.array([128.0]); out_tokens = np.array([64.0])
        prefill_batch = np.array([0], np.int32)   # invalid
        decode_batch = np.array([8], np.int32)
        prefill_cap = np.array([0], np.int32)
        decode_cap = np.array([88], np.int32)
        prefill_slices = np.array([1.0]); decode_slices = np.array([1.0])
        target_ttft = np.array([500.0]); target_itl = np.array([24.0])
        target_tps = np.array([0.0]); total_rate = np.array([10.0])
        min_replicas = np.array([1], np.int32)
        cost_per_replica = np.array([40.0])

    out = native.tandem_size_native(P())
    assert not out.feasible[0]
    assert out.num_replicas[0] == 0


def test_negative_slope_at_full_batch_rejected():
    """alpha+beta>0 but alpha+beta*batch<=0 (negative slope) must be
    rejected per lane, not produce NaN/feasible=1 through the C ABI."""
    def agg_params(beta):
        class P:
            alpha = np.array([10.0])
            gamma = np.array([2.0]); delta = np.array([0.01])
            in_tokens = np.array([128.0]); out_tokens = np.array([64.0])
            max_batch = np.array([8], np.int32)
            occupancy_cap = np.array([88], np.int32)
            target_ttft = np.array([500.0]); target_itl = np.array([24.0])
            target_tps = np.array([0.0]); total_rate = np.array([10.0])
            min_replicas = np.array([1], np.int32)
            cost_per_replica = np.array([40.0])
        P.beta = np.array([beta])
        return P()

    out = native.fleet_size_native(agg_params(-2.0))
    assert not out.feasible[0] and out.num_replicas[0] == 0
    assert np.isfinite(out.ttft[0]) and np.isfinite(out.itl[0])

    class T:
        alpha = np.array([10.0]); beta = np.array([-2.0])
        gamma = np.array([2.0]); delta = np.array([0.01])
        in_tokens = np.array([128.0]); out_tokens = np.array([64.0])
        prefill_batch = np.array([8], np.int32)
        decode_batch = np.array([8], np.int32)
        prefill_cap = np.array([88], np.int32)
        decode_cap = np.array([88], np.int32)
        prefill_slices = np.array([1.0]); decode_slices = np.array([2.0])
        target_ttft = np.array([500.0]); target_itl = np.array([24.0])
        target_tps = np.array([0.0]); total_rate = np.array([10.0])
        min_replicas = np.array([1], np.int32)
        cost_per_replica = np.array([40.0])

    tout = native.tandem_size_native(T())
    assert not tout.feasible[0] and tout.num_replicas[0] == 0
    assert np.isfinite(tout.ttft[0]) and np.isfinite(tout.itl[0])


def test_build_is_atomic_and_leaves_no_temp(tmp_path):
    """_build compiles to a temp file and renames into the
    hashed path (atomic on POSIX), and concurrent builders both succeed."""
    import ctypes
    import glob
    import os
    import threading

    lib_path = native._lib_path()
    errs = []

    def build():
        try:
            native._build(lib_path)
        except Exception as e:  # noqa: BLE001 - collect for assertion
            errs.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert os.path.exists(lib_path)
    assert not glob.glob(f"{lib_path}.tmp.*")
    # the freshly renamed artifact is a loadable, complete library
    lib = ctypes.CDLL(lib_path)
    assert hasattr(lib, "inferno_fleet_size")


def test_near_saturation_lanes_match_scalar():
    """Adversarial operating points for the optimized stationary solve
    (binary-searched argmax + underflow-guarded summation): lanes offered
    load AT and just under the stability boundary, where the state
    distribution is flat and the optimization's window spans most of the
    chain. Decisions must still match the scalar analyzer."""
    import math

    n = 8
    alpha, beta = 12.0, 0.25
    gamma, delta = 6.0, 0.01
    mb = 64
    # build_analyzer's chain is max_batch + max_queue states; the lane's
    # occupancy_cap must equal it exactly or the reference lambda* comes
    # from a different birth-death chain
    an = build_analyzer(mb, mb * 10, DecodeParms(alpha, beta),
                        PrefillParms(gamma, delta), RequestSize(128, 64))
    tr, _, _ = an.size(TargetPerf(target_ttft=500.0, target_itl=30.0))
    lam = min(tr.rate_target_ttft, tr.rate_target_itl, tr.rate_target_tps)
    # offered rates from 50% to 99.9% of n_replicas*lambda* for 3 replicas
    fracs = [0.5, 0.9, 0.99, 0.999, 1.0, 1.5, 4.0, 16.0]
    params = FleetParams(
        alpha=np.full(n, alpha), beta=np.full(n, beta),
        gamma=np.full(n, gamma), delta=np.full(n, delta),
        in_tokens=np.full(n, 128.0), out_tokens=np.full(n, 64.0),
        max_batch=np.full(n, mb, np.int32),
        occupancy_cap=np.full(n, mb * 11, np.int32),
        target_ttft=np.full(n, 500.0), target_itl=np.full(n, 30.0),
        target_tps=np.zeros(n),
        total_rate=np.array([3 * lam * f for f in fracs]),
        min_replicas=np.ones(n, np.int32),
        cost_per_replica=np.full(n, 4.8),
    )
    out = native.fleet_size_native(params)
    for i, f in enumerate(fracs):
        expect = max(1, math.ceil(3 * lam * f / lam))
        got = int(out.num_replicas[i])
        if f in (0.99, 0.999, 1.0):
            # fp at an exact ceil boundary may tip either side
            assert abs(got - expect) <= 1, (f, got, expect)
        else:
            # interior fractions must be EXACT: a systematic off-by-one
            # in the optimized argmax/underflow path would shift these
            assert got == expect, (f, got, expect)
        assert out.rate_star[i] == pytest.approx(lam, rel=2e-3), f


# -- λ-only refold -------------------------------------------------------------


def _f32_params(n_lanes=32, seed=17):
    params = make_params(n_lanes=n_lanes, seed=seed)
    return FleetParams(
        *(
            np.asarray(a, np.float32) if a.dtype == np.float64 else a
            for a in params
        )
    )


def _op_point_close(batched_val, native_val, what):
    """itl/ttft/rho within 1e-4 relative, with a 1e-6 msec absolute floor
    for values that are pure floating-point dust (a zero-queue wait is
    ~1e-12 msec and cancels differently in f32 vs f64)."""
    j = np.asarray(batched_val, np.float64)
    bad = np.abs(j - native_val) > np.maximum(1e-4 * np.abs(j), 1e-6)
    assert not bad.any(), (what, j[bad], native_val[bad])


def test_fleet_refold_matches_torch_refold():
    """The native λ-only refold against the port's torch refold from the
    SAME cached bisection: decision surface (replicas, cost) bit-identical
    — both sides run the identical f32 divide/ceil/int32/multiply — and
    the operating point within the documented 1e-4 relative tolerance."""
    rng = np.random.default_rng(23)
    params = _f32_params(n_lanes=32, seed=17)
    k_max = int(params.occupancy_cap.max())
    full = _np(Q.fleet_size(_t(params), k_max))
    bumped = params._replace(
        total_rate=(
            params.total_rate * rng.uniform(0.3, 3.0, 32).astype(np.float32)
        )
    )
    jref = _np(Q.fleet_refold(
        _t(bumped), k_max, *(torch.from_numpy(np.asarray(a)) for a in
                             (full.lambda_star, full.rate_star, full.feasible))
    ))
    nref = native.fleet_refold_native(
        bumped, np.asarray(full.lambda_star), np.asarray(full.rate_star),
        np.asarray(full.feasible),
    )
    np.testing.assert_array_equal(np.asarray(jref.feasible), nref.feasible)
    np.testing.assert_array_equal(
        np.asarray(jref.num_replicas), nref.num_replicas
    )
    np.testing.assert_array_equal(
        np.asarray(jref.cost, np.float64), nref.cost
    )
    # the cached bisection must pass through untouched
    np.testing.assert_array_equal(
        np.asarray(full.lambda_star, np.float64), nref.lambda_star
    )
    np.testing.assert_array_equal(
        np.asarray(full.rate_star, np.float64), nref.rate_star
    )
    _op_point_close(jref.itl, nref.itl, "itl")
    _op_point_close(jref.ttft, nref.ttft, "ttft")
    _op_point_close(jref.rho, nref.rho, "rho")


def test_tandem_refold_matches_torch_refold():
    """Disaggregated analogue: native tandem refold vs the port's
    tandem_refold — same exact-decision-surface / 1e-4 operating-point
    contract."""
    from inferno_tpu_torch.ops.queueing import TandemParams

    rng = np.random.default_rng(29)
    n = 24
    pb = rng.choice([8, 16], n).astype(np.int32)
    db = rng.choice([16, 48], n).astype(np.int32)
    params = TandemParams(
        alpha=rng.uniform(5, 30, n).astype(np.float32),
        beta=rng.uniform(0.05, 0.5, n).astype(np.float32),
        gamma=rng.uniform(20, 80, n).astype(np.float32),
        delta=rng.uniform(0.001, 0.01, n).astype(np.float32),
        in_tokens=rng.uniform(64, 512, n).astype(np.float32),
        out_tokens=rng.uniform(32, 256, n).astype(np.float32),
        prefill_batch=pb, decode_batch=db,
        prefill_cap=(pb * 10).astype(np.int32),
        decode_cap=(db * 10).astype(np.int32),
        prefill_slices=rng.choice([1.0, 2.0], n).astype(np.float32),
        decode_slices=rng.choice([1.0, 4.0], n).astype(np.float32),
        target_ttft=rng.choice([0.0, 2000.0, 5000.0], n).astype(np.float32),
        target_itl=rng.uniform(40, 120, n).astype(np.float32),
        target_tps=rng.choice([0.0, 0.0, 500.0], n).astype(np.float32),
        total_rate=rng.uniform(0, 40, n).astype(np.float32),
        min_replicas=rng.choice([0, 1, 3], n).astype(np.int32),
        cost_per_replica=rng.uniform(5, 40, n).astype(np.float32),
    )
    k_max = int(max(params.prefill_cap.max(), params.decode_cap.max()))
    full = _np(Q.tandem_fleet_size(_t(params), k_max))
    bumped = params._replace(
        total_rate=(
            params.total_rate * rng.uniform(0.3, 3.0, n).astype(np.float32)
        )
    )
    jref = _np(Q.tandem_refold(
        _t(bumped), k_max, *(torch.from_numpy(np.asarray(a)) for a in
                             (full.lambda_star, full.rate_star, full.feasible))
    ))
    nref = native.tandem_refold_native(
        bumped, np.asarray(full.lambda_star), np.asarray(full.rate_star),
        np.asarray(full.feasible),
    )
    np.testing.assert_array_equal(np.asarray(jref.feasible), nref.feasible)
    np.testing.assert_array_equal(
        np.asarray(jref.num_replicas), nref.num_replicas
    )
    np.testing.assert_array_equal(
        np.asarray(jref.cost, np.float64), nref.cost
    )
    _op_point_close(jref.itl, nref.itl, "itl")
    _op_point_close(jref.ttft, nref.ttft, "ttft")
    _op_point_close(jref.rho, nref.rho, "rho")


def test_fleet_refold_invalid_lane_rejected_not_crashing():
    """A lane that fails input validation (or carries a non-positive
    cached rate_star) zeroes out instead of dividing by it."""
    params = _f32_params(n_lanes=3, seed=31)
    bad = params._replace(max_batch=np.array([0, 8, 8], np.int32))
    rate = np.array([10.0, 0.0, 10.0])
    out = native.fleet_refold_native(
        bad, np.full(3, 1.0), rate, np.ones(3, np.uint8)
    )
    assert not out.feasible[0] and out.num_replicas[0] == 0  # invalid lane
    assert not out.feasible[1] and out.num_replicas[1] == 0  # rate_star 0
    assert out.num_replicas[2] > 0


def test_fleet_refold_threaded_matches_sequential():
    params = _f32_params(n_lanes=48, seed=37)
    k_max = int(params.occupancy_cap.max())
    full = _np(Q.fleet_size(_t(params), k_max))
    lam = np.asarray(full.lambda_star)
    rate = np.asarray(full.rate_star)
    feas = np.asarray(full.feasible)
    seq = native.fleet_refold_native(params, lam, rate, feas, n_threads=1)
    par = native.fleet_refold_native(params, lam, rate, feas, n_threads=4)
    np.testing.assert_array_equal(seq.num_replicas, par.num_replicas)
    np.testing.assert_array_equal(seq.cost, par.cost)
    np.testing.assert_array_equal(seq.ttft, par.ttft)


# -- the port's library against the reference's, bit for bit -----------------


def _tandem_np(seed: int, n: int = 24):
    rng = np.random.default_rng(seed)
    pb = rng.choice([8, 16], n).astype(np.int32)
    db = rng.choice([16, 48], n).astype(np.int32)
    return Q.TandemParams(
        alpha=rng.uniform(5, 30, n), beta=rng.uniform(0.05, 0.5, n),
        gamma=rng.uniform(20, 80, n), delta=rng.uniform(0.001, 0.01, n),
        in_tokens=rng.uniform(64, 512, n), out_tokens=rng.uniform(32, 256, n),
        prefill_batch=pb, decode_batch=db,
        prefill_cap=(pb * 10).astype(np.int32), decode_cap=(db * 10).astype(np.int32),
        prefill_slices=rng.choice([1.0, 2.0], n), decode_slices=rng.choice([1.0, 4.0], n),
        target_ttft=rng.choice([0.0, 2000.0, 5000.0], n),
        target_itl=rng.uniform(40, 120, n), target_tps=rng.choice([0.0, 0.0, 500.0], n),
        total_rate=rng.uniform(0, 40, n), min_replicas=rng.choice([0, 1, 3], n).astype(np.int32),
        cost_per_replica=rng.uniform(5, 40, n),
    )


@pytest.mark.parametrize("kind", ["fleet_size", "tandem_size", "fleet_refold", "tandem_refold"])
def test_port_native_matches_reference_native_bit_for_bit(kind):
    """The same source built with the same flags: every output array of
    the port's library equals the reference's bit for bit."""
    from inferno_tpu import native as ref_native

    rng = np.random.default_rng(41)
    if kind.startswith("fleet"):
        params = make_params(n_lanes=64, seed=43)
        # every 5th lane: an ITL target below the decode base (infeasible)
        tight = np.where(np.arange(64) % 5 == 0, params.alpha * 0.5, params.target_itl)
        params = params._replace(target_itl=tight)
    else:
        params = _tandem_np(47, n=48)
        tight = np.where(np.arange(48) % 5 == 0, params.alpha * 0.5, params.target_itl)
        params = params._replace(target_itl=tight)
    n = len(params.alpha)
    if kind.endswith("size"):
        fn = f"{kind}_native"
        ref = getattr(ref_native, fn)(params)
        port = getattr(native, fn)(params)
    else:
        sizer = "fleet_size_native" if kind.startswith("fleet") else "tandem_size_native"
        full = getattr(native, sizer)(params)
        bumped = params._replace(total_rate=params.total_rate * rng.uniform(0.3, 3.0, n))
        args = (bumped, full.lambda_star, full.rate_star, full.feasible)
        ref = getattr(ref_native, f"{kind}_native")(*args)
        port = getattr(native, f"{kind}_native")(*args)
    assert ref._fields == port._fields
    for field, a, b in zip(port._fields, ref, port):
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert port.feasible.any() and (~port.feasible).any()


# -- backend "native" in the port --------------------------------------------


def _edge_spec():
    from inferno_tpu_torch.testing.fleet import fleet_system_spec

    return fleet_system_spec(
        200, shapes_per_variant=3, tandem_every=5, zero_load_every=7,
        pinned_every=11, infeasible_every=13,
    )


def test_native_backend_matches_torch_on_edge_fleet(one_torch_thread):
    """Backend "native" (C++, f64, 64 bisection steps) against backend
    "torch" (f32, 32 steps) on the 200-variant edge fleet, lane by lane:
    equal feasibility, replicas within ±1, rate_star and itl within 5e-3
    relative (tests/test_native.py's kernel tolerances)."""
    from inferno_tpu_torch.core import System
    from inferno_tpu_torch.parallel import build_fleet, build_tandem_fleet, reset_fleet_state
    from inferno_tpu_torch.parallel.fleet import _solve_or_replay

    system = System(_edge_spec())
    for server in system.servers.values():
        server.all_allocations = {}
    plan, tandem = build_fleet(system), build_tandem_fleet(system)
    assert plan.num_lanes > 300 and tandem.num_lanes > 60
    reset_fleet_state()
    nat = _solve_or_replay(plan, tandem, None, "native")
    reset_fleet_state()
    tor = _solve_or_replay(plan, tandem, CPU, "torch")
    reset_fleet_state()
    for a, b in zip(nat, tor):
        a, b = _np(a), _np(b)
        np.testing.assert_array_equal(a.feasible, b.feasible)
        fe = a.feasible
        assert fe.any()
        assert (np.abs(a.num_replicas[fe].astype(np.int64) - b.num_replicas[fe]) <= 1).all()
        np.testing.assert_allclose(a.rate_star[fe], b.rate_star[fe], rtol=5e-3)
        np.testing.assert_allclose(a.itl[fe], b.itl[fe], rtol=5e-3)


def test_native_backend_needs_no_device_and_no_incremental_cycle():
    """Backend "native" resolves no device (None works on a machine with
    no card), and every call is a full pass: it never takes the
    incremental cycle."""
    from inferno_tpu_torch.core import System
    from inferno_tpu_torch.parallel import calculate_fleet, reset_fleet_state
    from inferno_tpu_torch.parallel.fleet import _check_backend

    assert _check_backend("native", None) is None
    reset_fleet_state()
    system = System(_edge_spec())
    for _ in range(2):
        n = calculate_fleet(system, backend="native", device=None)
        assert n > 0
        assert system.fleet_dirty is None  # the full path ran
        assert system.candidates_calculated


def test_auto_still_means_the_card():
    """Naming "native" is the only way to it: "auto" resolves to cuda and
    raises without a card, in the controller and the planner alike."""
    from inferno_tpu_torch.controller.reconciler import resolve_compute_backend
    from inferno_tpu_torch.planner.__main__ import _resolve_backend

    if torch.cuda.is_available():
        assert resolve_compute_backend() == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_compute_backend()
    with pytest.raises(SystemExit):
        _resolve_backend("auto")


def test_broken_build_raises_without_fallback(monkeypatch, tmp_path):
    """A g++ failure raises from every solver call and from backend
    "native" itself; nothing falls back to another solver."""
    from inferno_tpu_torch.core import System
    from inferno_tpu_torch.parallel import calculate_fleet, reset_fleet_state

    broken = tmp_path / "queueing.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(broken))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.fleet_size_native(make_params(n_lanes=4))
    assert not native.available()
    reset_fleet_state()
    with pytest.raises(RuntimeError, match="native library unavailable"):
        calculate_fleet(System(_edge_spec()), backend="native")
    reset_fleet_state()


def _cycle_records(backend: str, monkeypatch) -> list:
    from inferno_tpu_torch.controller import main as p_main
    from inferno_tpu_torch.controller.reconciler import Reconciler
    from inferno_tpu_torch.parallel import reset_fleet_state
    from inferno_tpu_torch.testing.fleet import (
        FLEET_NS, fleet_cluster, fleet_fake_prom, fleet_model,
    )

    n = 12
    rows = {
        (fleet_model(i), FLEET_NS): {
            "running": 3.0, "arrival_rps": 2.0 + 7.0 * i, "in_tokens": 128.0,
            "out_tokens": 128.0, "ttft_s": 0.05, "itl_s": 0.02, "max_batch": 64.0,
        }
        for i in range(n)
    }
    monkeypatch.setenv("COMPUTE_BACKEND", backend)
    monkeypatch.setenv("COMPUTE_DEVICE", "cpu")
    monkeypatch.setenv("CONFIG_NAMESPACE", "inferno-system")
    cfg = p_main.reconciler_config_from_env()
    assert cfg.compute_backend == backend
    reset_fleet_state()
    rec = Reconciler(fleet_cluster(n), fleet_fake_prom(rows), cfg)
    report = rec.run_cycle()
    rec.close()
    assert report.errors == [] and report.optimization_ok
    solve = [s for s in report.trace.walk() if s.name == "solve"][0]
    assert solve.attrs["backend"] == backend
    return [r.to_dict() for r in report.decisions]


def test_controller_cycle_on_native_backend(monkeypatch, one_torch_thread):
    """COMPUTE_BACKEND=native drives a whole reconcile cycle; its
    decisions match backend torch's (replicas within ±1 where the rate
    ceilings agree within 5e-3)."""
    nat = _cycle_records("native", monkeypatch)
    tor = _cycle_records("torch", monkeypatch)
    assert len(nat) == len(tor) == 12
    for a, b in zip(nat, tor):
        assert (a["variant"], a["accelerator"], a["reason"]) == (
            b["variant"], b["accelerator"], b["reason"])
        assert abs(a["replicas"] - b["replicas"]) <= 1, (a, b)
        assert a["lambda_max_rpm"] == pytest.approx(b["lambda_max_rpm"], rel=5e-3)
    assert max(r["replicas"] for r in nat) > 1


def test_planner_week_on_native_backend(capsys, one_torch_thread):
    """`python -m inferno_tpu_torch.planner --backend native`: a week of
    hourly steps on a small fleet, reported under backend "native", with
    the same scenarios and cost scale as backend torch."""
    import json

    from inferno_tpu_torch.planner.__main__ import main

    args = ["--variants", "24", "--steps", "168", "--scenarios", "diurnal,flash_crowd"]
    assert main(args + ["--backend", "native"]) == 0
    nat = json.loads(capsys.readouterr().out)
    assert main(args + ["--backend", "torch", "--device", "cpu"]) == 0
    tor = json.loads(capsys.readouterr().out)
    assert nat["fleet"]["backend"] == "native" and tor["fleet"]["backend"] == "torch"
    assert [b["scenario"] for b in nat["scenarios"]] == ["diurnal", "flash_crowd"]
    for a, b in zip(nat["scenarios"], tor["scenarios"]):
        assert a["scenario"] == b["scenario"] and a["steps"] == b["steps"] == 168
        ca, cb = a["reactive"]["cost"], b["reactive"]["cost"]
        assert ca["total_usd"] > 0
        assert ca["total_usd"] == pytest.approx(cb["total_usd"], rel=0.02), a["scenario"]
