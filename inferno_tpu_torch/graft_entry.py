"""Entry points of the port: the counterpart of `__graft_entry__.py`.

entry(device=None):   (fn, args) of the flagship compute path, batched
                      fleet sizing (the SLO bisection over the birth-death
                      queueing model for every lane at once): the port's
                      `fleet_size(params, 768)` over the reference's 64
                      seed-0 example lanes, on backend "cuda" (the card;
                      `device="cpu"` runs the plain torch versions).
dryrun_multichip(n):  the four sharded programs of the reference's dry run
                      on n `torch.distributed` ranks (`parallel.ranks`):
                      (1) eight surrogate training steps on a (dp, tp)
                      mesh, tp = 2 when n is even, whose loss must fall
                      and equal the one-device steps; (2)-(3) the example
                      fleet and a tandem fleet, padded to a multiple of n,
                      sized over a `FleetMesh` of the n devices and on one
                      device, equal under `_assert_results_equal`; (4) a
                      tensor-parallel Llama decode at toy dims against the
                      unsharded decode (rtol 2e-4, atol 1e-5), where tp
                      divides the kv heads. `device=None` runs NCCL ranks
                      on n cards (raises with fewer); gloo ranks on the
                      CPU only with `device="cpu"`.
"""

from __future__ import annotations

import numpy as np
import torch

K_MAX = 768  # covers occupancy caps of the example batch (11 * 64 = 704)
TANDEM_K_MAX = 512
# the reference's tp decode dims: the 70B's GQA structure (n_heads /
# n_kv_heads = 8) at a size for the CPU
TP_DECODE = dict(hidden=32, n_heads=16, n_kv_heads=2, head_dim=8, ffn=64, vocab=64,
                 n_layers=2)
TP_DECODE_RUN = dict(n_layers=2, batch=4, s_max=16, steps=2, start=4)
DECODE_RTOL, DECODE_ATOL = 2e-4, 1e-5
LOSS_RTOL = 1e-5  # sharded against one-device steps (summation order only)


def _example_fleet_params(n_lanes: int = 64):
    """The reference's example lanes (seed 0), as host numpy columns."""
    from inferno_tpu_torch.ops.queueing import FleetParams

    rng = np.random.default_rng(0)
    max_batch = rng.integers(8, 64, n_lanes).astype(np.int32)
    return FleetParams(
        alpha=rng.uniform(3.0, 25.0, n_lanes).astype(np.float32),
        beta=rng.uniform(0.05, 0.5, n_lanes).astype(np.float32),
        gamma=rng.uniform(1.0, 8.0, n_lanes).astype(np.float32),
        delta=rng.uniform(0.005, 0.05, n_lanes).astype(np.float32),
        in_tokens=rng.integers(64, 1024, n_lanes).astype(np.float32),
        out_tokens=rng.integers(16, 256, n_lanes).astype(np.float32),
        max_batch=max_batch,
        occupancy_cap=(max_batch * 11).astype(np.int32),
        target_ttft=np.full(n_lanes, 1000.0, np.float32),
        target_itl=rng.uniform(30.0, 150.0, n_lanes).astype(np.float32),
        target_tps=np.zeros(n_lanes, np.float32),
        total_rate=rng.uniform(1.0, 100.0, n_lanes).astype(np.float32),
        min_replicas=np.ones(n_lanes, np.int32),
        cost_per_replica=rng.uniform(10.0, 500.0, n_lanes).astype(np.float32),
    )


def _example_tandem_params(n_lanes: int):
    """The reference dry run's disaggregated lanes (seed 1)."""
    from inferno_tpu_torch.ops.queueing import TandemParams

    rng = np.random.default_rng(1)
    pb = rng.integers(4, 16, n_lanes).astype(np.int32)
    db = rng.integers(8, 32, n_lanes).astype(np.int32)
    return TandemParams(
        alpha=rng.uniform(3.0, 15.0, n_lanes).astype(np.float32),
        beta=rng.uniform(0.05, 0.3, n_lanes).astype(np.float32),
        gamma=rng.uniform(1.0, 6.0, n_lanes).astype(np.float32),
        delta=rng.uniform(0.005, 0.03, n_lanes).astype(np.float32),
        in_tokens=rng.integers(64, 512, n_lanes).astype(np.float32),
        out_tokens=rng.integers(16, 128, n_lanes).astype(np.float32),
        prefill_batch=pb,
        decode_batch=db,
        prefill_cap=(pb * 11).astype(np.int32),
        decode_cap=(db * 11).astype(np.int32),
        prefill_slices=np.ones(n_lanes, np.float32),
        decode_slices=np.full(n_lanes, 2.0, np.float32),
        target_ttft=np.full(n_lanes, 1000.0, np.float32),
        target_itl=rng.uniform(30.0, 150.0, n_lanes).astype(np.float32),
        target_tps=np.zeros(n_lanes, np.float32),
        total_rate=rng.uniform(1.0, 50.0, n_lanes).astype(np.float32),
        min_replicas=np.ones(n_lanes, np.int32),
        cost_per_replica=rng.uniform(40.0, 800.0, n_lanes).astype(np.float32),
    )


def entry(device=None):
    """(fn, example_args): `fn(params)` is the port's `fleet_size(params,
    768)` on the example lanes, through both kernels on the card (backend
    "cuda"); `device="cpu"` runs their plain versions. `device=None` is the
    card and raises without one."""
    from inferno_tpu_torch.ops.queueing import fleet_params_from_numpy, fleet_size
    from inferno_tpu_torch.parallel.mesh import fleet_device

    device = fleet_device(device)
    params = fleet_params_from_numpy(_example_fleet_params(), device)
    use_kernel = device.type == "cuda"

    def fn(p):
        return fleet_size(p, K_MAX, use_kernel=use_kernel)

    return fn, (params,)


def size_lanes(kind: str, params_np, k: int, device, use_kernel: bool, mesh=None):
    """Size one bucket of host lanes ("agg" FleetParams or "tan"
    TandemParams, every row a real lane) at grid width `k` through the
    fleet's dispatch (`parallel.fleet.solve_slots`), on `device` or split
    over `mesh`; returns the host FleetResult."""
    from inferno_tpu_torch.ops.queueing import DEFAULT_BISECT_ITERS, unpack_result
    from inferno_tpu_torch.parallel.fleet import BucketSlot, solve_slots

    n = len(np.asarray(params_np[0]))
    slot = BucketSlot(kind, k, params_np, np.arange(n), n)
    packed = solve_slots([slot], torch.device(device), DEFAULT_BISECT_ITERS, use_kernel, mesh)
    return unpack_result(packed)


def dryrun_multichip(n_devices: int, device=None, timeout: float = 900.0) -> dict:
    """Run the four sharded programs on `n_devices` ranks (see the module
    docstring); returns rank 0's report. Raises if any rank fails or the
    ranks outlive `timeout` seconds. On NCCL the kernel library is built
    here once, before the ranks start."""
    from inferno_tpu_torch.parallel.ranks import rank_backend, run_ranks

    if rank_backend(n_devices, device) == "nccl":
        from inferno_tpu_torch.ops import cuda_queueing

        cuda_queueing.build()
    return run_ranks(
        "inferno_tpu_torch.graft_entry:_dryrun_rank", n_devices, device,
        {"n_devices": n_devices}, timeout=timeout,
    )[0]


def _rank_context():
    """(backend, rank, world size, this rank's device) inside a rank."""
    import torch.distributed as dist

    from inferno_tpu_torch.parallel.ranks import rank_device

    backend = dist.get_backend()
    rank = dist.get_rank()
    return backend, rank, dist.get_world_size(), rank_device(backend, rank)


def _train_rank(x, y, steps: int = 8, learning_rate: float = 1e-3, cfg=None,
                tp: int = 2, seed: int = 0, mesh=None) -> dict:
    """Inside a rank: `steps` training steps on a (dp, tp) mesh (default:
    `train_mesh` over every rank) and the same steps on one device from the
    same weights.
    Returns both loss lists, this rank's mesh coordinates and, after the
    first step, its gradient shards and the one-device gradients."""
    from inferno_tpu_torch.models.surrogate import SurrogateConfig
    from inferno_tpu_torch.parallel.train import (
        DP_AXIS,
        TP_AXIS,
        init_train_state,
        shard_batch,
        train_mesh,
        train_step,
    )

    _, _, world, device = _rank_context()
    cfg = SurrogateConfig() if cfg is None else cfg
    mesh = train_mesh(world, tp) if mesh is None else mesh
    state = init_train_state(device, cfg, learning_rate, seed, mesh)
    one = init_train_state(device, cfg, learning_rate, seed)
    bx, by = shard_batch(state, x, y)
    ox, oy = shard_batch(one, x, y)
    out = {"dp": mesh.size(0), "tp": mesh.size(1),
           "dp_rank": mesh.get_local_rank(DP_AXIS), "tp_rank": mesh.get_local_rank(TP_AXIS),
           "losses": [], "single": []}
    for i in range(steps):
        out["losses"].append(train_step(state, bx, by))
        out["single"].append(train_step(one, ox, oy))
        if i == 0:
            out["grads"] = {k: p.grad.detach().cpu().numpy()
                            for k, p in state.model.named_parameters()}
            out["single_grads"] = {k: p.grad.detach().cpu().numpy()
                                   for k, p in one.model.named_parameters()}
    return out


def _tp_decode_rank(params_np=None, x0=None) -> dict:
    """Inside a rank: `_tp_decode` tensor-parallel over every rank."""
    import torch.distributed as dist

    _, rank, world, device = _rank_context()
    return _tp_decode(dist.group.WORLD, rank, world, device, params_np, x0)


def _dryrun_rank(n_devices: int) -> dict:
    """One rank of `dryrun_multichip`: the four programs, asserting as it
    goes; rank 0 also runs the fleet programs, over a `FleetMesh` of every
    rank's device."""
    import torch.distributed as dist

    from inferno_tpu_torch.models.surrogate import N_FEATURES, N_OUTPUTS, SurrogateConfig
    from inferno_tpu_torch.parallel.mesh import fleet_mesh
    from inferno_tpu_torch.parallel.ranks import rank_device
    from inferno_tpu_torch.parallel.train import TP_AXIS, train_mesh

    backend, rank, world, device = _rank_context()
    if world != n_devices:
        raise RuntimeError(f"dry run of {n_devices} devices on {world} ranks")
    tp = 2 if n_devices % 2 == 0 else 1
    dp = n_devices // tp
    report: dict = {"backend": backend, "dp": dp, "tp": tp}

    # 1. full training steps: params tensor-parallel over tp, batch
    # data-parallel over dp, the optimizer update included. A wrong
    # collective still lowers a loss, so the steps must also equal the
    # one-device steps (bit for bit on a (1, 1) mesh)
    cfg = SurrogateConfig(d_model=32, n_heads=4, n_layers=2, d_ff=64)
    rng = np.random.default_rng(0)
    batch = 4 * dp  # always divisible by the dp axis
    x = rng.normal(size=(batch, N_FEATURES)).astype(np.float32)
    y = rng.normal(size=(batch, N_OUTPUTS)).astype(np.float32)
    mesh = train_mesh(n_devices, tp)
    train = _train_rank(x, y, steps=8, learning_rate=1e-3, cfg=cfg, mesh=mesh)
    losses, single = train["losses"], train["single"]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"sharded training: non-finite losses {losses}")
    if not losses[-1] < losses[0] * 0.9:
        raise AssertionError(
            f"sharded training does not learn: losses {losses[0]:.4f} -> {losses[-1]:.4f}")
    if n_devices == 1 and losses != single:
        raise AssertionError(f"(1, 1) mesh steps {losses} != one-device steps {single}")
    np.testing.assert_allclose(losses, single, rtol=LOSS_RTOL, atol=0)
    report.update(losses=losses, single_losses=single)

    # 2.-3. the fleet sizing, lanes sharded over every rank's device, against
    # the same solve on one device (rank 0 alone: one process drives them)
    if rank == 0:
        fmesh = fleet_mesh(devices=[rank_device(backend, r) for r in range(n_devices)])
        use_kernel = backend == "nccl"
        n_lanes = max(16, 2 * n_devices)
        n_lanes += (-n_lanes) % n_devices  # pad to a multiple of the mesh size
        for label, kind, params, k in (
            ("fleet", "agg", _example_fleet_params(n_lanes), K_MAX),
            ("tandem", "tan", _example_tandem_params(n_lanes), TANDEM_K_MAX),
        ):
            result = size_lanes(kind, params, k, device, use_kernel, fmesh)
            if int(np.sum(result.num_replicas)) <= 0:
                raise AssertionError(f"{label}: no replicas sized")
            _assert_results_equal(result, size_lanes(kind, params, k, device, use_kernel),
                                  label)
            report[f"{label}_lanes"] = n_lanes

    # 4. the tensor-parallel Llama decode, where tp divides the kv heads
    if tp > 1 and TP_DECODE["n_kv_heads"] % tp == 0:
        decode = _tp_decode(mesh.get_group(TP_AXIS), mesh.get_local_rank(TP_AXIS), tp, device)
        report["decode"] = {"acc": decode["acc"], "acc_single": decode["acc_single"]}
    dist.barrier()
    return report


def _tp_decode(group, rank: int, tp: int, device, params_np=None, x0=None) -> dict:
    """The Llama decode at `TP_DECODE` dims, tensor-parallel over the ranks
    of `group` (`make_decode_fn(tp_group=)` on `shard_stack` /
    `shard_caches`; `rank` of `tp` in it), against the unsharded decode on
    the same weights (rtol 2e-4, atol 1e-5). Weights and the first
    embedding are seeded (7 and 8) unless given as numpy (`params_np` in
    the reference's layout, `x0` [B, 1, H])."""
    from inferno_tpu_torch.models.llama_block import (
        LlamaDims,
        init_stack,
        make_decode_fn,
        params_from_jax,
        shard_caches,
        shard_stack,
    )

    dims = LlamaDims(**TP_DECODE)
    run = TP_DECODE_RUN
    if params_np is None:
        params = init_stack(torch.Generator(device=device).manual_seed(7), dims,
                            run["n_layers"], "float32", device)
    else:
        params = params_from_jax(params_np, device)
    if x0 is None:
        x0 = torch.randn((run["batch"], 1, dims.hidden),
                         generator=torch.Generator(device=device).manual_seed(8),
                         device=device)
    else:
        x0 = torch.as_tensor(np.asarray(x0, np.float32), device=device)
    caches = tuple(
        torch.zeros((run["batch"], dims.n_kv_heads, run["s_max"], dims.head_dim),
                    dtype=torch.float32, device=device)
        for _ in range(2 * run["n_layers"])
    )
    acc_s, x_s, _ = make_decode_fn(dims, run["n_layers"], run["steps"], tp_group=group)(
        shard_stack(params, rank, tp), x0, shard_caches(caches, rank, tp), run["start"])
    acc_r, x_r, _ = make_decode_fn(dims, run["n_layers"], run["steps"])(
        params, x0, caches, run["start"])
    out = {"acc": float(acc_s), "x": x_s.cpu().numpy(),
           "acc_single": float(acc_r), "x_single": x_r.cpu().numpy()}
    if not np.isfinite(out["acc"]):
        raise AssertionError(f"tp decode: non-finite accumulator {out['acc']}")
    np.testing.assert_allclose(out["x"], out["x_single"], rtol=DECODE_RTOL, atol=DECODE_ATOL)
    np.testing.assert_allclose(out["acc"], out["acc_single"], rtol=DECODE_RTOL)
    return out


def _assert_results_equal(sharded_result, replicated_result, label: str) -> None:
    """Sharded-vs-unsharded numerical equality over every result field.

    Float fields must agree to tight f32 tolerance (the sharded program
    runs the same ops, only laid out differently — different XLA fusion
    order gives ~1e-6-level drift). Integer fields derive from the floats
    through a ceil, so a legitimate float wiggle exactly AT a replica-
    count boundary may flip them by one; such lanes are accepted ONLY
    when |diff| == 1 AND the underlying rate floats agree — anything else
    (wrong collective, wrong layout) fails."""
    a = sharded_result._asdict() if hasattr(sharded_result, "_asdict") else vars(sharded_result)
    b = replicated_result._asdict() if hasattr(replicated_result, "_asdict") else vars(replicated_result)
    assert a.keys() == b.keys()
    rate_a = np.asarray(a.get("rate_star"), np.float64)
    rate_b = np.asarray(b.get("rate_star"), np.float64)
    rates_close = np.isclose(rate_a, rate_b, rtol=1e-4, atol=1e-6)
    # lanes where a legitimate float wiggle flipped the replica ceil by 1:
    # every replica-DERIVED field (cost = replicas*unit, itl/ttft/rho at
    # total/replicas) shifts by a whole step there, so those lanes are
    # excluded from the strict float comparison too — otherwise the ±1
    # integer tolerance below would be defeated by its own side effects
    reps_a = np.asarray(a["num_replicas"], np.int64)
    reps_b = np.asarray(b["num_replicas"], np.int64)
    boundary = (reps_a != reps_b) & (np.abs(reps_a - reps_b) <= 1) & rates_close
    replica_derived = {"num_replicas", "cost", "itl", "ttft", "rho", "feasible"}
    for name in a:
        x, y = np.asarray(a[name]), np.asarray(b[name])
        mask = boundary if name in replica_derived else np.zeros_like(boundary)
        if np.issubdtype(x.dtype, np.integer) or x.dtype == np.bool_:
            diff = x.astype(np.int64) - y.astype(np.int64)
            bad = np.flatnonzero((diff != 0) & ~mask)
            if bad.size:
                bad = bad[:8]
                raise AssertionError(
                    f"{label}.{name}: sharded != replicated at lanes {bad.tolist()} "
                    f"({x[bad]} vs {y[bad]})"
                )
        else:
            keep = ~mask
            np.testing.assert_allclose(
                x[keep], y[keep], rtol=1e-5, atol=1e-6,
                err_msg=f"{label}.{name}: sharded vs replicated",
            )
