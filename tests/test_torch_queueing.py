"""The port's queueing ops (inferno_tpu_torch.ops) against the JAX reference.

Inputs are drawn with numpy from fixed seeds and fed to both packages:
the reference `inferno_tpu.ops.queueing` (XLA on the CPU) and its Pallas
kernel `inferno_tpu.ops.pallas_queueing` (interpret mode on the CPU, as
tests/test_pallas.py runs it) on one side, the port's plain torch
versions on the CPU on the other. The CUDA kernel itself runs only on a
card: its comparison with the plain version is a phase of chip_smoke.py
and the `cuda`-marked test at the bottom.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferno_tpu.analyzer.queue import RequestSize as RefRequestSize
from inferno_tpu.analyzer.queue import build_analyzer as ref_build_analyzer
from inferno_tpu.config.types import DecodeParms as RefDecodeParms
from inferno_tpu.config.types import PrefillParms as RefPrefillParms
from inferno_tpu.ops import pallas_queueing as rpq
from inferno_tpu.ops import queueing as rq
from inferno_tpu_torch.analyzer.queue import RequestSize, build_analyzer
from inferno_tpu_torch.config.types import DecodeParms, PrefillParms
from inferno_tpu_torch.ops import cuda_queueing as cq
from inferno_tpu_torch.ops import queueing as tq

# the stationary-solve tolerance of tests/test_pallas.py:47-56: 5e-3
# relative, wait and serv on the response-time scale (wait is a small
# difference of large terms when the queue is empty)
STATS_RTOL = 5e-3


@pytest.fixture
def cuda_device():
    """The card, for `cuda`-marked tests; decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fleet_np(P, rng, k_max=256):
    def arr(lo, hi):
        return rng.uniform(lo, hi, P).astype(np.float32)

    batch = rng.integers(4, min(24, k_max) + 1, P).astype(np.int32)
    return rq.FleetParams(
        alpha=arr(5, 25),
        beta=arr(0.1, 0.5),
        gamma=arr(2, 8),
        delta=arr(0.005, 0.03),
        in_tokens=arr(64, 512),
        out_tokens=arr(32, 256),
        max_batch=batch,
        occupancy_cap=(batch * 11).astype(np.int32),
        target_ttft=arr(200, 900),
        target_itl=arr(15, 40),
        target_tps=np.zeros(P, np.float32),
        total_rate=arr(0.5, 30),
        min_replicas=np.ones(P, np.int32),
        cost_per_replica=arr(1, 10),
    )


def _tandem_np(P, rng):
    def arr(lo, hi):
        return rng.uniform(lo, hi, P).astype(np.float32)

    pb = rng.integers(4, 16, P)
    db = rng.integers(8, 24, P)
    mq = db * 10
    return rq.TandemParams(
        alpha=arr(5, 25),
        beta=arr(0.1, 0.5),
        gamma=arr(2, 8),
        delta=arr(0.005, 0.03),
        in_tokens=rng.integers(64, 512, P).astype(np.float32),
        out_tokens=rng.integers(32, 256, P).astype(np.float32),
        prefill_batch=pb.astype(np.int32),
        decode_batch=db.astype(np.int32),
        prefill_cap=(pb + mq).astype(np.int32),
        decode_cap=(db + mq).astype(np.int32),
        prefill_slices=rng.integers(1, 3, P).astype(np.float32),
        decode_slices=rng.integers(1, 4, P).astype(np.float32),
        target_ttft=arr(200, 900),
        target_itl=arr(15, 40),
        target_tps=np.zeros(P, np.float32),
        total_rate=arr(0.5, 30),
        min_replicas=np.ones(P, np.int32),
        cost_per_replica=arr(1, 10),
    )


def _ref(params_np):
    return type(params_np)(*(jnp.asarray(a) for a in params_np))


def _port(params_np):
    if isinstance(params_np, rq.TandemParams):
        return tq.tandem_params_from_numpy(params_np, "cpu")
    return tq.fleet_params_from_numpy(params_np, "cpu")


def _grid_pair(P, K, seed, batch_range=None, cap_mult=11):
    """Reference and port grids over the same stage parameters."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(5.0, 60.0, P).astype(np.float32)
    slope = rng.uniform(0.05, 1.0, P).astype(np.float32)
    lo, hi = batch_range or (max(1, K // 4), K)
    nmax = rng.integers(lo, hi + 1, P).astype(np.int32)
    cap = (nmax * cap_mult).astype(np.int32)
    ref = rq._make_stage_grid(
        jnp.asarray(base), jnp.asarray(slope), jnp.asarray(nmax), jnp.asarray(cap), K
    )
    port = tq._make_stage_grid(
        torch.from_numpy(base), torch.from_numpy(slope), torch.from_numpy(nmax),
        torch.from_numpy(cap), K,
    )
    return ref, port, rng


def _assert_stats_close(ref, got, rtol=STATS_RTOL):
    ref = [np.asarray(r, np.float64) for r in ref]
    got = [np.asarray(g, np.float64) for g in got]
    scale = np.abs(ref[0]) + np.abs(ref[1]) + 1e-6
    for i, (name, r, g) in enumerate(zip(("wait", "serv", "in_servers", "tput"), ref, got)):
        assert g.shape == r.shape, name
        assert np.all(np.isfinite(r)) and np.all(np.isfinite(g)), name
        den = scale if i < 2 else np.abs(r) + 1e-6
        err = np.max(np.abs(r - g) / den)
        assert err < rtol, (name, err)


def _stats(fn, lam, grid):
    return [t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t) for t in fn(lam, grid)]


@pytest.mark.parametrize("P", [1, 13, 300])
@pytest.mark.parametrize("K", [128, 512])
def test_make_grid_matches_reference(P, K):
    rng = np.random.default_rng(P * 1000 + K)
    params = _fleet_np(P, rng, K)
    ref = rq._make_grid(_ref(params), K)
    port = tq._make_grid(_port(params), K)
    for name in ("cml", "kk", "nmax", "log_mu_full", "tail_len"):
        r = np.asarray(getattr(ref, name))
        g = getattr(port, name).numpy()
        assert g.dtype == np.float32, name
        # cml is +inf beyond each lane's max batch on both sides
        np.testing.assert_array_equal(np.isfinite(r), np.isfinite(g), err_msg=name)
        f = np.isfinite(r)
        np.testing.assert_allclose(g[f], r[f], rtol=1e-6, atol=0, err_msg=name)


@pytest.mark.parametrize("P", [1, 8, 13, 300])
@pytest.mark.parametrize("K", [128, 512])
def test_solve_stats_matches_reference_and_pallas(P, K):
    ref_grid, grid, rng = _grid_pair(P, K, seed=P + K)
    mu_n = np.exp(grid.log_mu_full.numpy())
    lam = (rng.uniform(0.05, 0.95, P) * mu_n).astype(np.float32)
    got = _stats(tq._solve_stats, torch.from_numpy(lam), grid)
    _assert_stats_close(_stats(rq._solve_stats, jnp.asarray(lam), ref_grid), got)
    _assert_stats_close(_stats(rpq.solve_stats, jnp.asarray(lam), ref_grid), got)
    # the kernel's wrapper takes the plain version for CPU tensors
    via_wrapper = _stats(cq.solve_stats, torch.from_numpy(lam), grid)
    for a, b in zip(got, via_wrapper):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "case", ["saturated", "empty_tail", "cap_beyond_grid", "batch_beyond_grid"]
)
def test_solve_stats_edge_cases(case):
    """q >= 1 (the blocking-state branch of _fold_tail), an empty tail
    (cap == max batch), a cap beyond the grid (test_pallas.py:127) and a
    max batch truncated at the grid edge."""
    P, K = 16, 128
    kwargs = {
        "saturated": {},
        "empty_tail": {"cap_mult": 1},
        "cap_beyond_grid": {"batch_range": (4, 24), "cap_mult": 40},
        "batch_beyond_grid": {"batch_range": (K // 2, 2 * K)},
    }[case]
    ref_grid, grid, rng = _grid_pair(P, K, seed=7, **kwargs)
    mu_n = np.exp(grid.log_mu_full.numpy())
    q = rng.uniform(1.5, 20.0, P) if case == "saturated" else rng.uniform(0.05, 1.5, P)
    lam = (q * mu_n).astype(np.float32)
    got = _stats(tq._solve_stats, torch.from_numpy(lam), grid)
    _assert_stats_close(_stats(rq._solve_stats, jnp.asarray(lam), ref_grid), got)
    _assert_stats_close(_stats(rpq.solve_stats, jnp.asarray(lam), ref_grid), got)


@pytest.mark.parametrize("logq", [-1.0, -1e-7, 0.0, 1e-7, 1.0])
def test_fold_tail_matches_reference(logq):
    rng = np.random.default_rng(5)
    n = 12
    m_head = rng.uniform(0.0, 30.0, n).astype(np.float32)
    logp_n = (m_head - rng.uniform(0.0, 5.0, n)).astype(np.float32)
    tail_len = np.asarray([0, 1, 2, 5, 10, 40, 80, 100, 160, 400, 1000, 2560], np.float32)
    lq = np.full(n, logq, np.float32)
    ref = rq._fold_tail(*(jnp.asarray(a) for a in (m_head, logp_n, lq, tail_len)))
    got = tq._fold_tail(*(torch.from_numpy(a) for a in (m_head, logp_n, lq, tail_len)))
    # atol: XLA on the CPU flushes f32 subnormals to zero, torch keeps
    # them (r^L at L = 1000, log q = -1); anything normal is held to 1e-5
    tiny = float(np.finfo(np.float32).tiny)
    for name, r, g in zip(("m", "z_tail", "jsum_tail", "p_block"), ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=tiny, err_msg=name)


def _assert_results_match(ref, got):
    """The port's comparison rule for sizing results: feasibility exact;
    replicas exact except ±1 on a ceil-boundary lane whose rate_star
    agrees within 1e-4 relative (__graft_entry__.py:334-376); rate_star
    and lambda_star within 1e-4; cost within 1e-5 and itl/ttft/rho within
    5e-3 off the boundary lanes."""
    r = {k: np.asarray(v) for k, v in ref._asdict().items()}
    g = {k: v.numpy() for k, v in got._asdict().items()}
    np.testing.assert_array_equal(g["feasible"], r["feasible"])
    for name in ("rate_star", "lambda_star"):
        np.testing.assert_allclose(g[name], r[name], rtol=1e-4, err_msg=name)
    diff = g["num_replicas"].astype(np.int64) - r["num_replicas"].astype(np.int64)
    rates_close = np.isclose(g["rate_star"], r["rate_star"], rtol=1e-4, atol=0)
    boundary = (diff != 0) & (np.abs(diff) == 1) & rates_close
    assert np.all((diff == 0) | boundary), np.flatnonzero((diff != 0) & ~boundary)
    keep = ~boundary
    np.testing.assert_allclose(g["cost"][keep], r["cost"][keep], rtol=1e-5)
    for name in ("itl", "ttft", "rho"):
        np.testing.assert_allclose(g[name][keep], r[name][keep], rtol=5e-3, err_msg=name)


def test_fleet_size_matches_reference():
    params = _fleet_np(24, np.random.default_rng(7))
    ref = rq.fleet_size(_ref(params), 256)
    got = tq.fleet_size(_port(params), 256)
    _assert_results_match(ref, got)
    assert got.num_replicas.dtype == torch.int32 and got.cost.dtype == torch.float32


def test_tandem_fleet_size_matches_reference():
    params = _tandem_np(24, np.random.default_rng(11))
    _assert_results_match(
        rq.tandem_fleet_size(_ref(params), 256), tq.tandem_fleet_size(_port(params), 256)
    )


def test_fleet_refold_matches_reference():
    params = _fleet_np(24, np.random.default_rng(3))
    full = rq.fleet_size(_ref(params), 256)
    # a changed offered load against the cached rate-independent outputs
    params2 = params._replace(total_rate=(params.total_rate * 1.7).astype(np.float32))
    ref = rq.fleet_refold(
        _ref(params2), 256, full.lambda_star, full.rate_star, full.feasible
    )
    got = tq.fleet_refold(
        _port(params2), 256, *(torch.from_numpy(np.array(a)) for a in
                               (full.lambda_star, full.rate_star, full.feasible))
    )
    _assert_results_match(ref, got)


def test_tandem_refold_matches_reference():
    params = _tandem_np(24, np.random.default_rng(4))
    full = rq.tandem_fleet_size(_ref(params), 256)
    params2 = params._replace(total_rate=(params.total_rate * 0.6).astype(np.float32))
    ref = rq.tandem_refold(
        _ref(params2), 256, full.lambda_star, full.rate_star, full.feasible
    )
    got = tq.tandem_refold(
        _port(params2), 256, *(torch.from_numpy(np.array(a)) for a in
                               (full.lambda_star, full.rate_star, full.feasible))
    )
    _assert_results_match(ref, got)


def test_refold_reproduces_full_solve():
    """Refolding the full solve's own bisection outputs at the same load
    is the full solve's rate-dependent half, bit for bit."""
    params = _port(_fleet_np(24, np.random.default_rng(9)))
    full = tq.fleet_size(params, 256)
    re = tq.fleet_refold(params, 256, full.lambda_star, full.rate_star, full.feasible)
    for name in ("num_replicas", "cost", "itl", "ttft", "rho"):
        assert torch.equal(getattr(full, name), getattr(re, name)), name


def test_fleet_analyze_matches_reference():
    rng = np.random.default_rng(21)
    params = _fleet_np(16, rng)
    lam = rng.uniform(0.001, 0.01, 16).astype(np.float32)
    ref = rq.fleet_analyze(jnp.asarray(lam), _ref(params), 256)
    got = tq.fleet_analyze(torch.from_numpy(lam), _port(params), 256)
    for name, r, g in zip(("ttft", "itl", "rho", "tput"), ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=5e-3, err_msg=name)


def test_kernel_path_on_cpu_is_the_plain_path():
    """use_kernel=True on CPU tensors routes through the wrapper, which
    takes the plain version: identical results, no launch counted."""
    params = _port(_fleet_np(12, np.random.default_rng(2)))
    before = cq.LAUNCHES
    a = tq.fleet_size(params, 128, use_kernel=False)
    b = tq.fleet_size(params, 128, use_kernel=True)
    assert cq.LAUNCHES == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_kernel_against_scalar_analyzer():
    """Ground truth: the float64 scalar analyzer (the port's own copy,
    which equals the reference's), as tests/test_pallas.py:74-106."""
    rate = 0.8  # req/s, stable region
    req = RequestSize(avg_in_tokens=128, avg_out_tokens=64)
    qa = build_analyzer(max_batch=16, max_queue=160, decode=DecodeParms(18.0, 0.3),
                        prefill=PrefillParms(5.0, 0.02), request=req)
    m = qa.analyze(rate)
    ref_m = ref_build_analyzer(
        max_batch=16, max_queue=160, decode=RefDecodeParms(18.0, 0.3),
        prefill=RefPrefillParms(5.0, 0.02),
        request=RefRequestSize(avg_in_tokens=128, avg_out_tokens=64),
    ).analyze(rate)
    assert dataclasses.asdict(m) == dataclasses.asdict(ref_m)

    def full(v, dtype=torch.float32):
        return torch.full((1,), v, dtype=dtype)

    params = tq.FleetParams(
        alpha=full(18.0), beta=full(0.3), gamma=full(5.0), delta=full(0.02),
        in_tokens=full(128.0), out_tokens=full(64.0),
        max_batch=full(16, torch.int32), occupancy_cap=full(176, torch.int32),
        target_ttft=full(0.0), target_itl=full(0.0), target_tps=full(0.0),
        total_rate=full(rate), min_replicas=full(1, torch.int32), cost_per_replica=full(1.0),
    )
    grid = tq._make_grid(params, 256)
    wait, serv, in_servers, tput = cq.solve_stats(full(rate / 1000.0), grid)
    assert float(tput[0]) * 1000.0 == pytest.approx(m.throughput, rel=1e-3)
    assert float(wait[0]) == pytest.approx(m.avg_wait_time, rel=2e-2, abs=0.05)


def test_tandem_against_scalar_analyzer():
    """Tandem sizing lane by lane against the float64 DisaggAnalyzer."""
    from inferno_tpu_torch.analyzer import TargetPerf, build_disagg_analyzer
    from inferno_tpu_torch.config.types import DisaggSpec

    P = 12
    pn = _tandem_np(P, np.random.default_rng(3))
    res = tq.tandem_fleet_size(_port(pn), 256)
    for i in range(P):
        qa = build_disagg_analyzer(
            max_batch=int(pn.decode_batch[i]),
            max_queue=int(pn.decode_cap[i] - pn.decode_batch[i]),
            decode=DecodeParms(alpha=float(pn.alpha[i]), beta=float(pn.beta[i])),
            prefill=PrefillParms(gamma=float(pn.gamma[i]), delta=float(pn.delta[i])),
            request=RequestSize(avg_in_tokens=int(pn.in_tokens[i]),
                                avg_out_tokens=int(pn.out_tokens[i])),
            spec=DisaggSpec(prefill_slices=int(pn.prefill_slices[i]),
                            decode_slices=int(pn.decode_slices[i]),
                            prefill_max_batch=int(pn.prefill_batch[i])),
        )
        targets = TargetPerf(target_ttft=float(pn.target_ttft[i]),
                             target_itl=float(pn.target_itl[i]))
        try:
            rates, metrics, _ = qa.size(targets)
            feasible = True
        except Exception:
            feasible = False
        assert bool(res.feasible[i]) == feasible, i
        if feasible:
            lam_star = min(rates.rate_target_ttft, rates.rate_target_itl) / 1000.0
            assert float(res.lambda_star[i]) == pytest.approx(lam_star, rel=2e-2), i
            assert float(res.rate_star[i]) == pytest.approx(metrics.throughput, rel=2e-2), i


def test_fold_replicas_saturating_cast():
    """XLA's f32 -> i32 conversion saturates (inf, 3e10 -> INT32_MAX) and
    maps NaN to 0; the port reproduces it instead of torch's cast."""
    total = np.asarray([1.0, 0.0, 3e10, -1.0, 5.0, 7.5, 0.0], np.float32)
    rate = np.asarray([0.0, 0.0, 1.0, 0.0, 2.0, 2.5, -0.0], np.float32)
    mins = np.asarray([1, 2, 0, 3, 1, 4, 0], np.int32)
    with np.errstate(divide="ignore", invalid="ignore"):
        ref = np.asarray(rq.fold_replicas(jnp.asarray(total), jnp.asarray(rate),
                                          jnp.asarray(mins)))
    got = tq.fold_replicas(torch.from_numpy(total), torch.from_numpy(rate),
                           torch.from_numpy(mins))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got[0] == 2147483647 and got[1] == 2 and got[2] == 2147483647
    # the numpy host path is the reference's own, verbatim
    with np.errstate(divide="ignore", invalid="ignore"):
        np.testing.assert_array_equal(
            tq.fold_replicas(total, rate, mins, xp=np),
            rq.fold_replicas(total, rate, mins, xp=np),
        )


def test_offered_load_both_namespaces():
    tr = np.asarray([1.0, 2.0, 3.0], np.float32)
    tps = np.asarray([0.0, 50.0, 0.0], np.float32)
    out = np.asarray([10.0, 25.0, 7.0], np.float32)
    ref = np.asarray(rq.offered_load(jnp.asarray(tr), jnp.asarray(tps), jnp.asarray(out)))
    got = tq.offered_load(*(torch.from_numpy(a) for a in (tr, tps, out)))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(tq.offered_load(tr, tps, out, np), ref)


@pytest.mark.parametrize("kind", ["fleet", "tandem"])
def test_params_from_numpy_round_trip(kind):
    """Carrying the reference's params across: np.asarray of each field
    goes in, the port's NamedTuple comes out with f32 floats and i32
    counts, and goes back to the same numpy arrays."""
    rng = np.random.default_rng(13)
    params = _fleet_np(9, rng) if kind == "fleet" else _tandem_np(9, rng)
    ref = _ref(params)
    conv = tq.fleet_params_from_numpy if kind == "fleet" else tq.tandem_params_from_numpy
    port = conv(type(ref)(*(np.asarray(a) for a in ref)), "cpu")
    assert port._fields == ref._fields
    for name, r, g in zip(ref._fields, ref, port):
        assert g.dtype == (torch.int32 if np.asarray(r).dtype.kind == "i" else torch.float32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    # a float64 column is cast to f32 on the way in, never carried as f64
    as64 = conv(type(params)(*(np.asarray(a, np.float64) if np.asarray(a).dtype.kind == "f"
                               else a for a in params)), "cpu")
    assert all(t.dtype in (torch.float32, torch.int32) for t in as64)


def test_pack_unpack_round_trip():
    params = _port(_fleet_np(10, np.random.default_rng(17)))
    res = tq.fleet_size(params, 128)
    packed = tq.pack_result(res)
    assert packed.shape == (8, 10) and packed.dtype == torch.float32
    buf = torch.zeros(8, 14)
    tq.pack_result(res, out=buf[:, 2:12])
    assert torch.equal(buf[:, 2:12], packed)
    back = tq.unpack_result(packed.numpy())
    for name, a, b in zip(res._fields, res, back):
        np.testing.assert_array_equal(np.asarray(b), a.numpy(), err_msg=name)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, grid, _ = _grid_pair(4, 128, seed=1)
    lam = torch.full((4,), 0.01)
    with pytest.raises(ValueError):
        cq.solve_stats(lam.to("meta"), grid)
    # nothing was built or loaded for CPU tensors
    cq.solve_stats(lam, grid)
    assert cq._lib is None or torch.cuda.is_available()


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    """The CUDA kernel against its plain version, on the card."""
    _, grid, rng = _grid_pair(300, 512, seed=3)
    grid = tq._Grid(*(t.to(cuda_device).contiguous() for t in grid))
    lam = (torch.from_numpy(rng.uniform(0.05, 1.5, 300).astype(np.float32)).to(cuda_device)
           * torch.exp(grid.log_mu_full))
    before = cq.LAUNCHES
    got = cq.solve_stats(lam, grid)
    torch.cuda.synchronize()
    assert cq.LAUNCHES == before + 1
    _assert_stats_close([t.cpu() for t in tq._solve_stats(lam, grid)], [t.cpu() for t in got])
    assert math.isfinite(float(got[0].sum()))
