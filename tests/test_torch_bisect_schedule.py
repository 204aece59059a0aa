"""The schedule of the port's bisection kernel (csrc/bisect_kernel.cu):
speculative rounds of several steps, the real-lane count of a padded
bucket, and the exact early exit.

On the CPU the kernel's schedule runs as its torch twin,
`ops.queueing._bisect_speculative_plain`, which must give `_bisect_plain`'s
bits at every depth, step count and exit setting; `_bisect_steps_needed`
counts each lane's steps to its fixed point, and stopping there must not
change a bit. The wrapper's depth chooser (`cuda_queueing.choose_depth`)
is a plain function of the card's numbers. One case is held against the
reference's `_bisect_increasing` through JAX on the CPU. The `cuda`-marked
tests at the bottom run the kernel itself at every depth on a card (run
them there with `python -m pytest tests/test_torch_bisect_schedule.py -m
cuda`). Inputs are drawn with numpy from fixed seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferno_tpu.ops import queueing as rq
from inferno_tpu_torch.config.defaults import SLO_MARGIN
from inferno_tpu_torch.ops import cuda_queueing as cq
from inferno_tpu_torch.ops import queueing as tq
from inferno_tpu_torch.parallel.fleet import pad_params_rows

METRICS = {"agg_ttft": tq.AGG_TTFT, "agg_itl": tq.AGG_ITL,
           "tan_ttft": tq.TAN_TTFT, "tan_itl": tq.TAN_ITL}
DEPTHS = [1, 2, 3, 4]
# the sizing path's 32 steps, a count no depth divides but 1, and a short one
N_ITERS = [32, 31, 7]
# the reference comparison's tolerance (chip_smoke.py, tests/test_torch_bisect.py)
LAM_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The cases here are small, and the tests run beside other test
    workers: torch's intra-op threads would only contend with them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda_device():
    """The card, for `cuda`-marked tests; decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fleet_np(P, K, rng):
    """Aggregated lanes whose max batch fills a K-wide grid; some lanes
    without input tokens."""
    def arr(lo, hi):
        return rng.uniform(lo, hi, P).astype(np.float32)

    batch = rng.integers(max(1, K // 4), K + 1, P).astype(np.int32)
    in_tokens = rng.integers(64, 512, P).astype(np.float32)
    in_tokens[::5] = 0.0
    return rq.FleetParams(
        alpha=arr(5, 25), beta=arr(0.1, 0.5), gamma=arr(2, 8), delta=arr(0.005, 0.03),
        in_tokens=in_tokens, out_tokens=rng.integers(1, 256, P).astype(np.float32),
        max_batch=batch, occupancy_cap=(batch * 11).astype(np.int32),
        target_ttft=arr(200, 900), target_itl=arr(15, 40),
        target_tps=np.zeros(P, np.float32), total_rate=arr(0.5, 30),
        min_replicas=np.ones(P, np.int32), cost_per_replica=arr(1, 10),
    )


def _tandem_np(P, K, rng):
    def arr(lo, hi):
        return rng.uniform(lo, hi, P).astype(np.float32)

    pb = rng.integers(max(1, K // 8), K // 2 + 1, P)
    db = rng.integers(max(1, K // 4), K + 1, P)
    return rq.TandemParams(
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
    )


def _case(metric, P, K, seed, pad_to=None, device="cpu"):
    """(case, numpy params): one bisection of a sizing program, targets
    spread over each lane's metric range and past both ends, some disabled
    (0). With `pad_to`, the params are padded to that many lanes by the
    fleet's own rule (copies of lane 0) before anything is computed."""
    rng = np.random.default_rng(seed)
    agg = metric in (tq.AGG_TTFT, tq.AGG_ITL)
    params_np = (_fleet_np if agg else _tandem_np)(P, K, rng)
    u = rng.uniform(-0.2, 1.2, P).astype(np.float32)
    if pad_to is not None:
        params_np = pad_params_rows(params_np, pad_to)
        u = np.concatenate([u, np.repeat(u[:1], pad_to - P)])
    solve = tq._solve_stats
    if agg:
        params = tq.fleet_params_from_numpy(params_np, device)
        cases = tq._agg_bisections(params, tq._make_grid(params, K), solve, SLO_MARGIN)
    else:
        params = tq.tandem_params_from_numpy(params_np, device)
        gp, gd, lam_min, lam_max = tq._tandem_grids(params, K)
        cases = tq._tandem_bisections(params, gp, gd, lam_min, lam_max, solve, SLO_MARGIN)
    case = cases[metric % 2]
    target = case.y_lo + torch.from_numpy(u).to(device) * (case.y_hi - case.y_lo)
    target[1:P:7] = 0.0  # real lanes only: a pad lane stays a copy of lane 0
    return case._replace(target=target.contiguous()), params_np


def _bits(x):
    return x.view(torch.int32)


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("n_iters", N_ITERS)
@pytest.mark.parametrize("metric", list(METRICS))
@pytest.mark.parametrize("P", [1, 13, 300])
@pytest.mark.parametrize("K", [128, 256, 512])
def test_speculative_twin_is_bitwise_plain(depth, n_iters, metric, P, K):
    """The kernel's rounds and paths, with and without the early exit,
    land on the sequential bisection's bits (K = 256 is a strided width)."""
    case, _ = _case(METRICS[metric], P, K, seed=P * 7 + K + n_iters)
    ref_lam, ref_ok = tq._bisect_plain(case, n_iters)
    for early_exit in (False, True):
        lam, ok, steps = tq._bisect_speculative_plain(case, n_iters, depth, early_exit)
        assert torch.equal(ok, ref_ok)
        assert torch.equal(_bits(lam), _bits(ref_lam)), (depth, early_exit)
        assert steps.dtype == torch.int32 and bool((steps <= n_iters).all())
        if not early_exit:
            assert bool((steps == n_iters).all())


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("metric", list(METRICS))
def test_twin_with_pad_lanes(depth, metric):
    """A bucket padded by the fleet's rule: the pad lanes hold lane 0's
    inputs, so every schedule gives them lane 0's bits, which the kernel
    writes for them without solving."""
    real, width = 13, 32
    case, _ = _case(METRICS[metric], real, 128, seed=5 + depth, pad_to=width)
    lam, ok, steps = tq._bisect_speculative_plain(case, 32, depth, True)
    ref_lam, ref_ok = tq._bisect_plain(case, 32)
    assert torch.equal(_bits(lam), _bits(ref_lam)) and torch.equal(ok, ref_ok)
    assert torch.equal(_bits(lam[real:]), _bits(lam[:1]).expand(width - real))
    assert torch.equal(ok[real:], ok[:1].expand(width - real))
    assert torch.equal(steps[real:], steps[:1].expand(width - real))


@pytest.mark.parametrize("metric", list(METRICS))
@pytest.mark.parametrize("K", [128, 512])
def test_steps_needed_is_each_lanes_fixed_point(metric, K):
    """Stopping every lane after its own count of `_bisect_steps_needed`
    gives the bits of all n_iters steps; the twin's early exit stops each
    lane within one round of it; lanes whose result does not read the loop
    (infeasible, clamped) need none."""
    n_iters = 32
    case, _ = _case(METRICS[metric], 300, K, seed=K + METRICS[metric])
    needed = tq._bisect_steps_needed(case, n_iters)
    assert needed.dtype == torch.int32
    assert bool(((needed >= 0) & (needed <= n_iters)).all())
    ref_lam, ref_ok = tq._bisect_plain(case, n_iters)
    feasible = case.target >= case.y_lo * (1.0 - 1e-6)
    no_loop = ~feasible | (case.target >= case.y_hi)
    assert bool((needed[no_loop] == 0).all()) and bool(no_loop.any())
    # every lane holds its final bits after its own count of steps
    for n in sorted(set(needed.tolist())):
        lam, _ = tq._bisect_plain(case, n)
        at = needed == n
        assert torch.equal(_bits(lam[at]), _bits(ref_lam[at])), n
    # the data leaves most looping lanes short of 32 steps
    assert 0 < float(needed[~no_loop].float().median()) < n_iters
    for depth in DEPTHS:
        _, _, steps = tq._bisect_speculative_plain(case, n_iters, depth, True)
        looping = ~no_loop & (needed < n_iters)
        assert bool((steps[no_loop] == 0).all())
        # done after the round whose last step is the first that left (lo, hi) alone
        bound = torch.clamp(((needed + 1 + depth - 1) // depth) * depth, max=n_iters)
        assert bool((steps[looping] >= needed[looping] + 1).all())
        assert bool((steps[~no_loop] <= bound[~no_loop]).all()), depth


# the 10k edge fleet's bisections on an H100 (80GB HBM3, 700 W; chip_smoke.py
# phase 4b prints them): (real lanes, resident lanes at depths 1-4) per
# bucket and metric, as `bisect_shape` reported them, and the depth the
# chooser gives
RUN_SHAPES = {
    ("agg", 128, tq.AGG_TTFT): (16917, (19008, 3168, 1584, 528), 1),
    ("agg", 128, tq.AGG_ITL): (16917, (19008, 4224, 1584, 528), 1),
    ("agg", 512, tq.AGG_TTFT): (2249, (4752, 792, 396, 132), 1),
    ("agg", 512, tq.AGG_ITL): (2249, (4752, 792, 396, 132), 1),
    ("agg", 2048, tq.AGG_TTFT): (157, (1188, 132, 66, 30), 1),
    ("agg", 2048, tq.AGG_ITL): (157, (1188, 132, 66, 30), 1),
    ("tan", 128, tq.TAN_TTFT): (4183, (19008, 3168, 2112, 528), 1),
    ("tan", 128, tq.TAN_ITL): (4183, (10560, 3168, 1056, 528), 1),
    ("tan", 512, tq.TAN_TTFT): (600, (4752, 792, 528, 132), 2),
    ("tan", 512, tq.TAN_ITL): (600, (2112, 792, 264, 132), 2),
    ("tan", 2048, tq.TAN_TTFT): (50, (1188, 132, 66, 30), 3),
    ("tan", 2048, tq.TAN_ITL): (50, (660, 132, 66, 30), 3),
}


@pytest.mark.parametrize("bucket", list(RUN_SHAPES), ids=lambda b: f"{b[0]}{b[1]}-m{b[2]}")
def test_depth_chooser_at_the_fleets_buckets(bucket):
    """The largest depth whose lanes fit in one wave: depth 1 for the
    large aggregated buckets, deeper rounds for the small tandem ones."""
    lanes, resident, expected = RUN_SHAPES[bucket]
    chosen = cq.choose_depth(lanes, dict(zip(DEPTHS, resident)))
    assert chosen == expected
    assert cq.waves(lanes, resident[chosen - 1]) == 1
    assert all(lanes > cap for d, cap in zip(DEPTHS, resident) if d > chosen)


def test_depth_chooser_edges():
    assert cq.choose_depth(10**6, {1: 100, 2: 50}) == 1  # nothing fits: depth 1
    assert cq.choose_depth(1, {1: 100, 2: 50, 3: 7, 4: 1}) == 4
    assert cq.choose_depth(50, {1: 100, 3: 60, 2: 80}) == 3  # any order
    assert cq.resident_lanes(132, 9, 16, 1, 0) == 19008
    assert cq.resident_lanes(132, 2, 1, 4, 62) == 62  # a lane a cluster
    assert cq.waves(17408, 16896) == 2 and cq.waves(16917, 19008) == 1
    assert cq.waves(5, 0) == 0


@pytest.mark.parametrize("bad", [
    dict(depth=0), dict(depth=cq.BISECT_MAX_DEPTH + 1), dict(depth=1.0), dict(depth="2"),
    dict(real_lanes=0), dict(real_lanes=7), dict(real_lanes=-1), dict(real_lanes=3.0),
    dict(steps_out="dtype"), dict(steps_out="shape"),
])
def test_wrapper_rejects_a_bad_schedule(bad):
    case, _ = _case(tq.AGG_TTFT, 6, 128, seed=2)
    if "steps_out" in bad:
        bad = dict(steps_out=torch.zeros(6, dtype=torch.int64) if bad["steps_out"] == "dtype"
                   else torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError):
        cq.bisect(case, 32, **bad)


def test_wrapper_schedule_on_cpu_is_the_plain_version():
    """On CPU tensors every schedule argument takes the plain version and
    launches nothing; the steps reported are the plain loop's."""
    case, _ = _case(tq.TAN_ITL, 9, 128, seed=4, pad_to=16)
    ref_lam, ref_ok = tq._bisect_plain(case, 32)
    before = cq.BISECT_LAUNCHES
    steps = torch.zeros(16, dtype=torch.int32)
    lam, ok = cq.bisect(case, 32, real_lanes=9, depth=3, early_exit=False, steps_out=steps)
    assert torch.equal(_bits(lam), _bits(ref_lam)) and torch.equal(ok, ref_ok)
    assert bool((steps == 32).all()) and cq.BISECT_LAUNCHES == before
    with pytest.raises(ValueError):
        cq.bisect_shape(tq.AGG_TTFT, 128, 1, "cpu")


@pytest.mark.parametrize("metric", list(METRICS))
def test_twin_matches_the_jax_reference(metric):
    """The twin at depth 3 with the early exit against the reference's
    `_bisect_increasing` (XLA on the CPU) over the reference's own metric
    closures, from the same inputs: feasibility exact on every lane,
    lam_star within LAM_RTOL relative on every lane whose target is set.
    A disabled target (0) makes the sizing programs discard the bisection
    (`fleet_size` takes lam_max there), and its search for where the
    queueing wait leaves an exact 0 turns on the rounding of denormals,
    which XLA and torch round apart."""
    P, K = 64, 128
    case, params_np = _case(METRICS[metric], P, K, seed=21)
    ref = type(params_np)(*(jnp.asarray(a) for a in params_np))
    m = case.metric
    if m in (tq.AGG_TTFT, tq.AGG_ITL):
        grid = rq._make_grid(ref, K)
        y_at = {
            tq.AGG_TTFT: lambda lam: rq._ttft_itl_at(lam, ref, grid, rq._solve_stats,
                                                     SLO_MARGIN)[0],
            tq.AGG_ITL: lambda lam: rq._ttft_itl_at(lam, ref, grid, rq._solve_stats)[1],
        }[m]
    else:
        # the stage grids of the reference's `tandem_fleet_size`, by its own
        # expressions
        nd = rq._tandem_num_decodes(ref)
        gp = rq._make_stage_grid(ref.gamma, ref.delta * ref.in_tokens, ref.prefill_batch,
                                 ref.prefill_cap, K)
        gd = rq._make_stage_grid(nd * ref.alpha, nd * ref.beta, ref.decode_batch,
                                 ref.decode_cap, K)
        y_at = {
            tq.TAN_TTFT: lambda lam: rq._tandem_ttft_at(lam, ref, gp, rq._solve_stats,
                                                        SLO_MARGIN),
            tq.TAN_ITL: lambda lam: rq._tandem_eval(lam, ref, gp, gd, rq._solve_stats)[1],
        }[m]
    j = [jnp.asarray(x.numpy()) for x in (case.lam_min, case.lam_max, case.target,
                                          case.y_lo, case.y_hi)]
    ref_lam, ref_ok = (np.asarray(x) for x in rq._bisect_increasing(*j, y_at, 32))
    lam, ok, _ = tq._bisect_speculative_plain(case, 32, 3, True)
    assert np.array_equal(ok.numpy(), ref_ok)
    set_ = case.target.numpy() > 0
    assert 0 < set_.sum() < P
    np.testing.assert_allclose(lam.numpy()[set_], ref_lam[set_], rtol=LAM_RTOL)


# -- on the card ------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("metric", list(METRICS))
@pytest.mark.parametrize("K", [128, 512, 2048, 256])
def test_kernel_every_depth_is_bitwise_per_step(depth, metric, K, cuda_device):
    """The kernel at each depth, with and without the exit, on a padded
    bucket with its real lane count ≡ depth 1 with no exit on every lane
    (the fixed schedule) ≡ the per-step composition on stats_kernel, bit for
    bit; the steps it reports are the twin's or more (a warp or block
    waits for its slowest lane), never past n_iters."""
    real, width = 300, 512
    case, _ = _case(METRICS[metric], real, K, seed=K + depth, pad_to=width, device=cuda_device)
    step_lam, step_ok = tq._bisect_plain(case, 32, solve=cq.solve_stats)
    old_lam, old_ok = cq.bisect(case, 32, depth=1, early_exit=False)
    assert torch.equal(_bits(old_lam), _bits(step_lam)) and torch.equal(old_ok, step_ok)
    # the twin on the same device arithmetic: a decision near a fixed point
    # can round otherwise on the CPU
    _, _, twin_steps = tq._bisect_speculative_plain(case, 32, depth, True, solve=cq.solve_stats)
    for early_exit in (False, True):
        steps = torch.full((width,), -1, dtype=torch.int32, device=cuda_device)
        before = cq.BISECT_LAUNCHES
        lam, ok = cq.bisect(case, 32, real_lanes=real, depth=depth, early_exit=early_exit,
                            steps_out=steps)
        torch.cuda.synchronize()
        assert cq.BISECT_LAUNCHES == before + 1
        assert torch.equal(_bits(lam), _bits(step_lam)) and torch.equal(ok, step_ok)
        assert bool((steps <= 32).all())
        if early_exit:
            assert bool((steps[:real] >= twin_steps[:real].to(cuda_device)).all())
        else:
            assert bool((steps == 32).all())


@pytest.mark.cuda
def test_kernel_agg_128_runs_in_one_wave(cuda_device):
    """The aggregated K = 128 bisections of the 10k edge fleet (16,917 real
    lanes) fit on the card in one wave at depth 1, with no spill."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for metric in (tq.AGG_TTFT, tq.AGG_ITL):
        shape = cq.bisect_shape(metric, 128, 1, cuda_device)
        assert shape.spill_bytes == 0 and shape.registers <= 56
        assert shape.resident_lanes == sms * shape.blocks_per_sm * shape.lanes_per_block
        if sms >= 132:
            assert cq.waves(16917, shape.resident_lanes) == 1
        assert cq.bisect_depth(metric, 128, 16917, cuda_device) == 1
