"""The port's fused bisection (ops.queueing `_bisect_plain`, the wrapper
ops.cuda_queueing.bisect and its CUDA kernel csrc/bisect_kernel.cu).

The plain version evaluates each metric from per-lane constants instead of
the sizing programs' closures; on the CPU it must reproduce the per-step
composition it replaces bit for bit, for each of the four metrics. The
kernel itself runs only on a card: the `cuda`-marked test at the bottom
holds it against the plain version there (as chip_smoke.py does at the
main path's shapes). Inputs are drawn with numpy from fixed seeds.
"""

import numpy as np
import pytest
import torch

from inferno_tpu_torch.config.defaults import SLO_MARGIN
from inferno_tpu_torch.ops import cuda_queueing as cq
from inferno_tpu_torch.ops import queueing as tq

N_ITERS = tq.DEFAULT_BISECT_ITERS
METRICS = {"agg_ttft": tq.AGG_TTFT, "agg_itl": tq.AGG_ITL,
           "tan_ttft": tq.TAN_TTFT, "tan_itl": tq.TAN_ITL}


@pytest.fixture
def cuda_device():
    """The card, for `cuda`-marked tests; decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fleet_params(P, K, rng):
    """Aggregated lanes whose max batch fills a K-wide grid; a few lanes
    have no input tokens (the prefill-free branch)."""
    def arr(lo, hi):
        return rng.uniform(lo, hi, P).astype(np.float32)

    batch = rng.integers(max(1, K // 4), K + 1, P).astype(np.int32)
    in_tokens = rng.integers(64, 512, P).astype(np.float32)
    in_tokens[::5] = 0.0
    return tq.fleet_params_from_numpy(tq.FleetParams(
        alpha=arr(5, 25), beta=arr(0.1, 0.5), gamma=arr(2, 8), delta=arr(0.005, 0.03),
        in_tokens=in_tokens, out_tokens=rng.integers(1, 256, P).astype(np.float32),
        max_batch=batch, occupancy_cap=(batch * 11).astype(np.int32),
        target_ttft=arr(200, 900), target_itl=arr(15, 40),
        target_tps=np.zeros(P, np.float32), total_rate=arr(0.5, 30),
        min_replicas=np.ones(P, np.int32), cost_per_replica=arr(1, 10),
    ), "cpu")


def _tandem_params(P, K, rng):
    def arr(lo, hi):
        return rng.uniform(lo, hi, P).astype(np.float32)

    pb = rng.integers(max(1, K // 8), K // 2 + 1, P)
    db = rng.integers(max(1, K // 4), K + 1, P)
    return tq.tandem_params_from_numpy(tq.TandemParams(
        alpha=arr(5, 25), beta=arr(0.1, 0.5), gamma=arr(2, 8), delta=arr(0.005, 0.03),
        in_tokens=rng.integers(64, 512, P).astype(np.float32),
        out_tokens=rng.integers(1, 256, P).astype(np.float32),
        prefill_batch=pb.astype(np.int32), decode_batch=db.astype(np.int32),
        prefill_cap=(pb * 10).astype(np.int32), decode_cap=(db * 10).astype(np.int32),
        prefill_slices=rng.integers(1, 3, P).astype(np.float32),
        decode_slices=rng.integers(1, 4, P).astype(np.float32),
        target_ttft=arr(200, 900), target_itl=arr(15, 40),
        target_tps=np.zeros(P, np.float32), total_rate=arr(0.5, 30),
        min_replicas=np.ones(P, np.int32), cost_per_replica=arr(1, 10),
    ), "cpu")


def _case(metric, P, K, seed, device="cpu"):
    """(case, params, grids) with targets spread over each lane's metric
    range and past both ends, and a few disabled (0) targets."""
    rng = np.random.default_rng(seed)
    solve = tq._solve_stats
    if metric in (tq.AGG_TTFT, tq.AGG_ITL):
        params = _fleet_params(P, K, rng)
        grids = (tq._make_grid(params, K),)
        cases = tq._agg_bisections(params, grids[0], solve, SLO_MARGIN)
    else:
        params = _tandem_params(P, K, rng)
        gp, gd, lam_min, lam_max = tq._tandem_grids(params, K)
        grids = (gp, gd)
        cases = tq._tandem_bisections(params, gp, gd, lam_min, lam_max, solve, SLO_MARGIN)
    case = cases[metric % 2]
    u = torch.from_numpy(rng.uniform(-0.2, 1.2, P).astype(np.float32))
    target = case.y_lo + u * (case.y_hi - case.y_lo)
    target[::7] = 0.0
    case = case._replace(target=target.contiguous())
    if device != "cpu":
        case = _to(case, device)
    return case, params, grids


def _to(case, device):
    def move(x):
        if isinstance(x, torch.Tensor):
            return x.to(device).contiguous()
        if isinstance(x, tq._Grid):
            return tq._Grid(*(t.to(device).contiguous() for t in x))
        return x

    return tq.BisectCase(*(move(x) for x in case))


def _old_composition(case, params, grids, solve=tq._solve_stats):
    """The per-step composition fleet_size and tandem_fleet_size ran before
    the bisection became one function: `_bisect_increasing` over the
    sizing programs' own metric closures."""
    m, margin = case.metric, case.wait_margin
    y_at = {
        tq.AGG_TTFT: lambda lam: tq._ttft_itl_at(lam, params, grids[0], solve, margin)[0],
        tq.AGG_ITL: lambda lam: tq._ttft_itl_at(lam, params, grids[0], solve)[1],
        tq.TAN_TTFT: lambda lam: tq._tandem_ttft_at(lam, params, grids[0], solve, margin),
        tq.TAN_ITL: lambda lam: tq._tandem_eval(lam, params, grids[0], grids[1], solve)[1],
    }[m]
    return tq._bisect_increasing(
        case.lam_min, case.lam_max, case.target, case.y_lo, case.y_hi, y_at, N_ITERS
    )


@pytest.mark.parametrize("metric", list(METRICS))
@pytest.mark.parametrize("P", [1, 13, 300])
@pytest.mark.parametrize("K", [128, 512])
def test_plain_bisection_equals_per_step_composition(metric, P, K):
    case, params, grids = _case(METRICS[metric], P, K, seed=P * 7 + K)
    lam, ok = tq._bisect_plain(case, N_ITERS)
    ref_lam, ref_ok = _old_composition(case, params, grids)
    assert lam.dtype == torch.float32 and ok.dtype == torch.bool
    assert torch.equal(ok, ref_ok)
    assert torch.equal(lam.view(torch.int32), ref_lam.view(torch.int32))
    # the targets reach both sides: some lanes infeasible, some clamped
    if P == 300:
        assert 0 < int(ok.sum()) < P
        assert bool((lam == case.lam_max).any())


@pytest.mark.parametrize("kind", ["agg", "tan"])
@pytest.mark.parametrize("P", [1, 13, 300])
@pytest.mark.parametrize("K", [128, 512])
def test_sizing_kernel_flag_on_cpu_is_bitwise(kind, P, K):
    """use_kernel=True on CPU tensors routes both kernels' wrappers to
    their plain versions: bit-identical results, no launch counted."""
    rng = np.random.default_rng(P + K)
    if kind == "agg":
        params, size = _fleet_params(P, K, rng), tq.fleet_size
    else:
        params, size = _tandem_params(P, K, rng), tq.tandem_fleet_size
    before = (cq.LAUNCHES, cq.BISECT_LAUNCHES)
    a = size(params, K, use_kernel=False)
    b = size(params, K, use_kernel=True)
    assert (cq.LAUNCHES, cq.BISECT_LAUNCHES) == before
    for name, x, y in zip(a._fields, a, b):
        assert x.dtype == y.dtype, name
        assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                           y.view(torch.int32) if y.dtype == torch.float32 else y), name


def _bad(case, what):
    if what == "dtype":
        return case._replace(target=case.target.double())
    if what == "shape":
        return case._replace(y_lo=torch.cat([case.y_lo, case.y_lo[:1]]))
    if what == "device":
        return case._replace(y_hi=case.y_hi.to("meta"))
    if what == "contiguity":
        return case._replace(consts=case.consts.t().contiguous().t())
    if what == "consts_rows":
        return case._replace(consts=case.consts[:-1].contiguous())
    if what == "grid_dtype":
        return case._replace(gp=case.gp._replace(cml=case.gp.cml.double()))
    if what == "grid_lanes":
        return case._replace(gp=case.gp._replace(tail_len=case.gp.tail_len[:-1]))
    if what == "metric":
        return case._replace(metric=7)
    if what == "no_decode_grid":
        return case._replace(gd=None)
    raise AssertionError(what)


@pytest.mark.parametrize("what", ["dtype", "shape", "device", "contiguity", "consts_rows",
                                  "grid_dtype", "grid_lanes", "metric", "no_decode_grid"])
def test_bisect_wrapper_rejects_what_the_kernel_does_not_take(what):
    case, _, _ = _case(tq.TAN_ITL, 6, 128, seed=1)
    with pytest.raises(ValueError):
        cq.bisect(_bad(case, what), N_ITERS)


def test_bisect_wrapper_on_cpu_is_the_plain_version():
    """A CPU call takes the plain version and builds or loads nothing."""
    for metric in METRICS.values():
        case, _, _ = _case(metric, 9, 128, seed=metric)
        before = cq.BISECT_LAUNCHES
        lam, ok = cq.bisect(case, N_ITERS)
        ref_lam, ref_ok = tq._bisect_plain(case, N_ITERS)
        assert torch.equal(lam, ref_lam) and torch.equal(ok, ref_ok)
        assert cq.BISECT_LAUNCHES == before
    with pytest.raises(ValueError):
        cq.bisect(case, -1)
    assert cq._lib is None or torch.cuda.is_available()


@pytest.mark.cuda
@pytest.mark.parametrize("metric", list(METRICS))
def test_bisect_kernel_matches_plain_on_card(metric, cuda_device):
    """The bisection kernel against its plain version on the card:
    feasibility exact, lam_star within 1e-4 relative on at least 99.9% of
    lanes; against the per-step composition on the stationary-solve
    kernel, which runs the same device code, bit for bit."""
    case, _, _ = _case(METRICS[metric], 3000, 512, seed=11, device=cuda_device)
    before = cq.BISECT_LAUNCHES
    lam, ok = cq.bisect(case, N_ITERS)
    torch.cuda.synchronize()
    assert cq.BISECT_LAUNCHES == before + 1
    ref_lam, ref_ok = tq._bisect_plain(case, N_ITERS)
    assert torch.equal(ok, ref_ok)
    rel = ((lam - ref_lam).abs() / ref_lam.abs()).cpu().numpy()
    assert np.mean(rel > 1e-4) <= 1e-3, np.sort(rel)[-5:]
    step_lam, step_ok = tq._bisect_plain(case, N_ITERS, solve=cq.solve_stats)
    assert torch.equal(step_ok, ok)
    assert torch.equal(step_lam.view(torch.int32), lam.view(torch.int32))
