"""Fleet-level candidate sizing on the GPU.

Port of `inferno_tpu/parallel/fleet.py`: the per-cycle solve, full and
incremental. `calculate_fleet(system)` is a drop-in replacement for
`System.calculate_all()`: it flattens every loaded (server, slice-shape)
pair into one `FleetParams` batch (the columnar snapshot), sizes it
bucket by bucket with the sizing programs of `ops.queueing` on one
device, and writes `Allocation` candidates back onto the servers,
including the zero-load shortcut and the transition-penalty values the
scalar path produces (reference: pkg/core/{server.go:55-67,
allocation.go:27-163}).

Backends: "cuda" (the default) routes every stationary solve through the
hand-written kernel `ops/csrc/stats_kernel.cu` and every bisection
through `ops/csrc/bisect_kernel.cu`; "torch" runs their plain torch
versions on whatever device it is given (the CPU tests use it). Both
backends take the incremental dirty-set cycle (`parallel/incremental.py`)
by default, and both paths dispatch through one function, `solve_slots`.
"native" sizes both lane kinds with the C++ solver of `native/` on the
host in f64, on no device; like the reference's, it never takes the
incremental cycle, so every call is a full pass.

The cycle profiler's spans (`obs/profiler.py`) time the layers of a
pass: `calculate_fleet` around the whole call, `snapshot_update`,
`plan_repack` and `dispatch` (`solve_slots`: the launches and the copy
back) inside it, and `plan_fold` around each row chunk of the planner's
`FleetBatchPrep.solve` (on the card: the copies, the launch and the sync
that lands the results on the host); `plan_card_rows` and
`plan_host_rows` count the rows each path solved. `dispatches` counts the dispatches of
`solve_slots` (one per full pass or incremental cycle that solves
anything). Nothing is compiled at dispatch: the kernel library's first
load is its own span (`ops/cuda_queueing.py`). The hooks only observe:
decisions are bit-identical with the profiler on and off.

The planner's batched time-axis solve (`prepare_fleet_batch`,
`calculate_fleet_batch`, `FleetBatchPrep`) is ported too: its prep runs
one full sizing of every bucket through `solve_slots` (the kernels on
backend "cuda"). Its per-row replica fold, transition penalties, segment
argmin and zero-load overlay run on the card on backend "cuda" without a
spot tier, one launch of `ops/csrc/plan_rows_kernel.cu` a chunk that also
sums each row's bucket demand for the Monte Carlo planner; on backend
"torch", on the CPU and with a spot tier they run in host numpy, as in
the reference (`FleetBatchPrep._solve_chunk`). Both give the same bits.

Sharding (the reference's `shard_map` over a `jax.sharding.Mesh`): with a
`parallel.mesh.FleetMesh` of more than one device (`mesh=`, `use_mesh=`,
or the `SIZING_SHARDS` environment variable), every bucket is padded to a
multiple of the mesh size and split into contiguous shards, one per
device; `solve_slots` queues every shard's copies and launches on its own
device before the first copy back, then gathers the results in lane
order. Lanes are independent, so the sharded solve gives the same bits
as the unsharded one. A one-device mesh, or none, runs the unsharded
code.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from inferno_tpu_torch.config.defaults import (
    ACCEL_PENALTY_FACTOR,
    MAX_QUEUE_TO_BATCH_RATIO,
    env_flag,
    env_int,
    env_str,
)
from inferno_tpu_torch.core.allocation import (
    Allocation,
    _apply_spot,
    _zero_load_allocation,
    transition_penalty,
)
from inferno_tpu_torch.core.system import System

# cycle-profiler hooks (obs/profiler.py): thread-local no-ops unless a
# profiler is active; observation only
from inferno_tpu_torch.obs import profiler as _prof
from inferno_tpu_torch.ops.queueing import (
    DEFAULT_BISECT_ITERS,
    FleetParams,
    FleetResult,
    TandemParams,
    fleet_params_from_numpy,
    fleet_refold,
    fleet_size,
    fold_replicas,
    offered_load,
    pack_result,
    tandem_fleet_size,
    tandem_params_from_numpy,
    tandem_refold,
    unpack_result,
)
from inferno_tpu_torch.parallel.mesh import (
    FleetMesh,
    fleet_device,
    fleet_mesh,
    shard_fleet_params,
)

_K_PAD = 128  # head (max-batch) grid padded to this floor

BACKENDS = ("cuda", "torch", "native")


@dataclasses.dataclass
class FleetPlan:
    """A flattened fleet batch plus the lane -> (server, acc) mapping.

    `params` holds host numpy columns (f32 floats, i32 counts); the solve
    moves each bucket to the device. `server_idx`/`acc_rank`/
    `chips_per_replica` (set by the snapshot packer) feed the vectorized
    per-server candidate argmin in `calculate_fleet`: lane -> position in
    the system's server order, lane accelerator -> sorted-catalog rank
    (the deterministic tie-break axis), and lane -> whole-slice chip
    demand per replica. Legacy-built plans leave them None and
    `calculate_fleet` derives all three from `lanes`."""

    params: FleetParams
    lanes: list[tuple[str, str]]  # (server_name, acc_name) per lane
    server_idx: np.ndarray | None = None
    acc_rank: np.ndarray | None = None
    chips_per_replica: np.ndarray | None = None

    @property
    def num_lanes(self) -> int:
        return len(self.lanes)


@dataclasses.dataclass
class TandemPlan:
    """Disaggregated (prefill/decode tandem) lanes of the fleet batch."""

    params: TandemParams
    lanes: list[tuple[str, str]]  # (server_name, acc_name) per lane
    server_idx: np.ndarray | None = None
    acc_rank: np.ndarray | None = None
    chips_per_replica: np.ndarray | None = None

    @property
    def num_lanes(self) -> int:
        return len(self.lanes)


@dataclasses.dataclass(frozen=True)
class _LaneBasis:
    """One eligible (server, slice shape) pair with everything
    build_fleet and build_tandem_fleet derive from the scalar
    create_allocation preamble."""

    server_name: str
    acc_name: str
    perf: object
    target: object
    load: object
    batch: int  # output-length-scaled batch (allocation.py:117-121)
    cost_per_replica: float
    min_replicas: int


def _eligible_lanes(system: System, only: set[str] | None = None):
    """Yield the lanes the scalar create_allocation would size: shared
    eligibility walk of build_fleet and build_tandem_fleet, so their
    candidate sets cannot diverge. Zero-load servers are excluded
    (handled by the closed-form shortcut in `calculate_fleet`); `only`
    restricts to a server subset."""
    for server_name, server in system.servers.items():
        if only is not None and server_name not in only:
            continue
        load = server.load
        if load is None or load.arrival_rate < 0:
            continue
        if load.avg_in_tokens < 0 or load.avg_out_tokens < 0:
            continue
        if load.arrival_rate == 0 or load.avg_out_tokens == 0:
            continue  # zero-load shortcut handled separately
        model = system.models.get(server.model_name)
        svc = system.service_classes.get(server.service_class_name)
        if model is None or svc is None:
            continue
        target = svc.target_for(server.model_name)
        if target is None:
            continue
        for acc in server.candidate_accelerators(system).values():
            perf = model.perf_data.get(acc.name)
            if perf is None:
                continue
            k_out = load.avg_out_tokens
            if server.max_batch_size > 0:
                batch = server.max_batch_size
            else:
                batch = max(perf.max_batch_size * perf.at_tokens // k_out, 1)
            yield _LaneBasis(
                server_name=server_name,
                acc_name=acc.name,
                perf=perf,
                target=target,
                load=load,
                batch=batch,
                cost_per_replica=acc.cost * model.slices_per_replica(acc.name),
                min_replicas=max(server.min_num_replicas, 0),
            )


def _pack(cls, cols: dict[str, list], int_fields: frozenset[str]):
    return cls(
        **{
            name: np.asarray(cols[name], np.int32 if name in int_fields else np.float32)
            for name in cls._fields
        }
    )


def _shared_cols(cols: dict[str, list], lane: _LaneBasis) -> None:
    cols["alpha"].append(lane.perf.decode_parms.alpha)
    cols["beta"].append(lane.perf.decode_parms.beta)
    cols["gamma"].append(lane.perf.prefill_parms.gamma)
    cols["delta"].append(lane.perf.prefill_parms.delta)
    cols["in_tokens"].append(float(lane.load.avg_in_tokens))
    cols["out_tokens"].append(float(lane.load.avg_out_tokens))
    cols["target_ttft"].append(lane.target.slo_ttft)
    cols["target_itl"].append(lane.target.slo_itl)
    cols["target_tps"].append(lane.target.slo_tps)
    cols["total_rate"].append(lane.load.arrival_rate / 60.0)
    cols["min_replicas"].append(lane.min_replicas)
    cols["cost_per_replica"].append(lane.cost_per_replica)


# Lane-set memo (one slot per lane kind): an unchanged fleet replays the
# previous cycle's plan OBJECT. On the snapshot path the key is (snapshot
# version, only-subset) — an O(1) check; the legacy walk (FLEET_SNAPSHOT=0)
# keys on the full column content.
_plan_memo: dict[str, tuple[tuple, object]] = {}


def _memoized_plan(kind: str, key: tuple, build):
    cached = _plan_memo.get(kind)
    if cached is not None and cached[0] == key:
        _prof.count("plan_memo_hits")
        return cached[1]
    _prof.count("plan_memo_misses")
    # "repack" attribution: the full lane-set rebuild the memo exists to
    # avoid — rows/columns/meta extraction on the snapshot path, the
    # per-lane Python walk on the legacy path
    with _prof.span("plan_repack"):
        plan = build()
    _plan_memo[kind] = (key, plan)
    return plan


def _snapshot_enabled() -> bool:
    return env_flag("FLEET_SNAPSHOT", True)


_snapshot = None  # lazily-created module singleton (parallel.snapshot)


def _get_snapshot():
    global _snapshot
    if _snapshot is None:
        from inferno_tpu_torch.parallel.snapshot import FleetSnapshot

        _snapshot = FleetSnapshot()
    return _snapshot


def _snapshot_plan(
    system: System, only: set[str] | None, kind: str,
    known_version: int | None = None,
):
    """Columnar-snapshot packing: O(servers) change detection + O(lanes)
    numpy, with an O(1) version-keyed memo. `known_version` skips the
    change-detection walk when the caller already reconciled the snapshot
    this cycle (calculate_fleet updates once and hands the version to
    build_fleet and build_tandem_fleet)."""
    snap = _get_snapshot()
    if known_version is None:
        # snapshot re-derivation: the O(servers) change-detection walk +
        # column refresh of changed servers (vs the O(1) memo replay above)
        with _prof.span("snapshot_update"):
            version = snap.update(system)
    else:
        version = known_version
    key = (version, None if only is None else frozenset(only))

    def build():
        rows, lanes = snap.rows(kind, only)
        if not lanes:
            return None
        cols = snap.columns(kind, rows)
        server_idx, acc_rank, chips = snap.meta(kind, rows)
        cls, pcls = (
            (FleetPlan, FleetParams) if kind == "agg" else (TandemPlan, TandemParams)
        )
        return cls(
            params=pcls(**cols), lanes=lanes,
            server_idx=server_idx, acc_rank=acc_rank,
            chips_per_replica=chips,
        )

    return _memoized_plan(f"snap-{kind}", key, build)


def reset_fleet_state() -> None:
    """Drop every cross-cycle cache (plan memo, solve memo, snapshot,
    incremental result tables, greedy charge state) — test isolation
    hook."""
    _plan_memo.clear()
    _solve_memo.clear()
    if _snapshot is not None:
        _snapshot.reset()
    from inferno_tpu_torch.parallel import incremental as _inc

    _inc.reset_state()


def build_fleet(
    system: System, only: set[str] | None = None,
    _known_version: int | None = None,
) -> FleetPlan | None:
    """Flatten all loaded aggregated (server, slice-shape) pairs into a
    FleetParams of host numpy columns. Padding happens per bucket in
    `_solve_all`, not here."""
    if _snapshot_enabled():
        return _snapshot_plan(system, only, "agg", _known_version)
    cols: dict[str, list] = {name: [] for name in FleetParams._fields}
    lanes: list[tuple[str, str]] = []

    for lane in _eligible_lanes(system, only):
        perf, load = lane.perf, lane.load
        if perf.disagg is not None:
            continue  # tandem lanes are batched by build_tandem_fleet
        # non-positive service time => the scalar analyzer raises and
        # the pair is rejected; keep the batched path consistent
        nd = load.avg_out_tokens - 1
        if load.avg_in_tokens == 0 and load.avg_out_tokens == 1:
            nd = 1
        t1 = nd * (perf.decode_parms.alpha + perf.decode_parms.beta)
        if load.avg_in_tokens > 0:
            t1 += (
                perf.prefill_parms.gamma
                + perf.prefill_parms.delta * load.avg_in_tokens
            )
        if t1 <= 0:
            continue
        _shared_cols(cols, lane)
        cols["max_batch"].append(lane.batch)
        cols["occupancy_cap"].append(lane.batch * (1 + MAX_QUEUE_TO_BATCH_RATIO))
        lanes.append((lane.server_name, lane.acc_name))

    if not lanes:
        return None
    key = (tuple(lanes), tuple(tuple(cols[name]) for name in FleetParams._fields))
    return _memoized_plan(
        "agg",
        key,
        lambda: FleetPlan(
            params=_pack(
                FleetParams,
                cols,
                frozenset(("max_batch", "occupancy_cap", "min_replicas")),
            ),
            lanes=lanes,
        ),
    )


def build_tandem_fleet(
    system: System, only: set[str] | None = None,
    _known_version: int | None = None,
) -> TandemPlan | None:
    """Flatten all loaded disaggregated (server, slice-shape) pairs into a
    TandemParams batch. Eligibility mirrors the scalar path
    (create_allocation + build_disagg_analyzer): lanes the scalar analyzer
    would reject (no prefill stage, invalid spec, non-positive stage
    times) produce no candidate here either."""
    if _snapshot_enabled():
        return _snapshot_plan(system, only, "tan", _known_version)
    cols: dict[str, list] = {name: [] for name in TandemParams._fields}
    lanes: list[tuple[str, str]] = []

    for lane in _eligible_lanes(system, only):
        perf, load = lane.perf, lane.load
        if perf.disagg is None:
            continue
        if load.avg_in_tokens <= 0:
            # the tandem model requires a prefill stage (disagg.py
            # validates avg_in_tokens > 0)
            continue
        dg = perf.disagg
        try:
            dg.validate()
        except ValueError:
            continue
        batch = lane.batch
        max_queue = batch * MAX_QUEUE_TO_BATCH_RATIO
        p_batch = dg.prefill_max_batch or batch
        # non-positive stage times => scalar analyzer raises; reject here
        nd = max(load.avg_out_tokens - 1, 1)
        pf = perf.prefill_parms
        dc = perf.decode_parms
        p_times = (
            pf.gamma + pf.delta * load.avg_in_tokens,
            pf.gamma + pf.delta * load.avg_in_tokens * p_batch,
        )
        d_times = (dc.alpha + dc.beta, dc.alpha + dc.beta * batch)
        if min(p_times) <= 0 or nd * min(d_times) <= 0:
            continue
        _shared_cols(cols, lane)
        cols["prefill_batch"].append(p_batch)
        cols["decode_batch"].append(batch)
        cols["prefill_cap"].append(p_batch + max_queue)
        cols["decode_cap"].append(batch + max_queue)
        cols["prefill_slices"].append(float(dg.prefill_slices))
        cols["decode_slices"].append(float(dg.decode_slices))
        lanes.append((lane.server_name, lane.acc_name))

    if not lanes:
        return None
    key = (tuple(lanes), tuple(tuple(cols[name]) for name in TandemParams._fields))
    return _memoized_plan(
        "tan",
        key,
        lambda: TandemPlan(
            params=_pack(
                TandemParams,
                cols,
                frozenset(
                    ("prefill_batch", "decode_batch", "prefill_cap",
                     "decode_cap", "min_replicas")
                ),
            ),
            lanes=lanes,
        ),
    )


def _bucket_k(batch: int) -> int:
    """Pad a lane's max batch to the next 4x-geometric grid size
    (>= _K_PAD). The grid only spans the head states k <= max_batch (the
    queue tail is folded in closed form), and coarse steps keep the
    number of buckets — each one a launch sequence — small."""
    k = _K_PAD
    while k < batch:
        k *= 4
    return k


def _pad_rows(arr: np.ndarray, width: int) -> np.ndarray:
    pad = width - len(arr)
    if pad <= 0:
        return arr
    return np.concatenate([arr, np.repeat(arr[:1], pad, axis=0)])


def pad_params_rows(params, total: int):
    """Pad every array of a params tuple to `total` rows by repeating row
    0 (dummy lanes) — the reference's one padding rule."""
    if len(np.asarray(params[0])) >= total:
        return params
    return type(params)(*(_pad_rows(np.asarray(a), total) for a in params))


def _pad_lanes(n: int, chunk: int = 1) -> int:
    """Pad a bucket's lane count to the next power of two (>= 8) up to
    2048, then to a multiple of 512, then to a multiple of the mesh
    `chunk` (its size; 1 without a mesh), so that every shard gets the
    same width: the reference's rule. Stable bucket shapes keep a later
    captured launch sequence (a CUDA graph) valid while a fleet grows or
    shrinks by a few variants; the dummy lanes cost under 1% above 2k
    lanes."""
    padded = 8
    while padded < n and padded < 2048:
        padded *= 2
    if padded < n:
        padded = -(-n // 512) * 512
    return padded + ((-padded) % chunk)


def _empty_result(n: int) -> FleetResult:
    return FleetResult(
        feasible=np.zeros(n, bool),
        lambda_star=np.zeros(n, np.float32),
        rate_star=np.zeros(n, np.float32),
        num_replicas=np.zeros(n, np.int32),
        cost=np.zeros(n, np.float32),
        itl=np.zeros(n, np.float32),
        ttft=np.zeros(n, np.float32),
        rho=np.zeros(n, np.float32),
    )


class BucketSlot(NamedTuple):
    """One bucket of a solve, in launch order: the lane kind ("agg" or
    "tan"), its grid width K, its host params padded to `width` rows,
    the lane indices it holds (into the caller's lane space: plan lanes
    on the full path, static snapshot rows on the incremental one), and
    for a refold bucket the cached rate-independent columns
    (lambda_star f32, rate_star f32, feasible bool), padded alike; None
    runs the full sizing program."""

    kind: str
    k: int
    sub: object
    idx: np.ndarray
    width: int
    cached: tuple | None = None


def add_bucketed(
    slots: list, kind: str, params_np, bucket_batches: np.ndarray,
    idx_map: np.ndarray | None = None, cached: tuple | None = None,
    chunk: int = 1,
) -> None:
    """Append the buckets of one lane set to `slots` — the one bucketing
    rule of both paths. Lanes are grouped into geometric max-batch
    buckets: per-lane batch varies by orders of magnitude across slice
    shapes, and a single global grid would make every small lane pay for
    the largest one. Within a bucket lanes run in order of max batch
    (stable), so that neighbouring lanes share the grid's empty states
    past their batch, which the kernels skip a warp at a time; every
    lane's result is independent of its place and of its neighbours.
    `idx_map` maps the lane set's positions to the indices a slot
    reports (identity when None); `cached` are the refold columns of the
    lane set, gathered per bucket. Padding rows repeat row 0, up to a
    multiple of the mesh `chunk` (`_pad_lanes`)."""
    cls = type(params_np)
    bucket_batches = np.asarray(bucket_batches)
    buckets: dict[int, list[int]] = {}
    for i, batch in enumerate(bucket_batches):
        buckets.setdefault(_bucket_k(int(batch)), []).append(i)
    for k_bucket, idx_list in sorted(buckets.items()):
        idx = np.asarray(idx_list)
        idx = idx[np.argsort(bucket_batches[idx], kind="stable")]
        width = _pad_lanes(len(idx), chunk)
        sub = pad_params_rows(cls(*(np.asarray(a)[idx] for a in params_np)), width)
        aux = None
        if cached is not None:
            aux = tuple(_pad_rows(np.asarray(c)[idx], width) for c in cached)
        out_idx = idx if idx_map is None else idx_map[idx]
        slots.append(BucketSlot(kind, k_bucket, sub, out_idx, width, aux))


def bucket_slots(
    plan: FleetPlan | None, tandem: TandemPlan | None, chunk: int = 1
) -> list[BucketSlot]:
    """The full path's buckets, in launch order (see `add_bucketed`),
    padded to a multiple of the mesh `chunk`."""
    slots: list[BucketSlot] = []
    if plan is not None and plan.num_lanes:
        add_bucketed(
            slots, "agg", plan.params, np.asarray(plan.params.max_batch), chunk=chunk
        )
    if tandem is not None and tandem.num_lanes:
        tp = tandem.params
        add_bucketed(
            slots, "tan", tp,
            np.maximum(np.asarray(tp.prefill_batch), np.asarray(tp.decode_batch)),
            chunk=chunk,
        )
    return slots


def _solve_slot(
    slot: BucketSlot, device: torch.device, n_iters: int, use_kernel: bool,
    real_lanes: int | None = None,
):
    """One bucket's program on `device`. `real_lanes` (default: the
    slot's lanes) tells the bisection kernel where the pad rows start."""
    agg = slot.kind == "agg"
    params = (fleet_params_from_numpy if agg else tandem_params_from_numpy)(
        slot.sub, device
    )
    if slot.cached is None:
        sizer = fleet_size if agg else tandem_fleet_size
        real = len(slot.idx) if real_lanes is None else real_lanes
        return sizer(params, slot.k, n_iters, use_kernel, real_lanes=real)
    lam, rate, feasible = (
        torch.as_tensor(np.ascontiguousarray(c), device=device) for c in slot.cached
    )
    refold = fleet_refold if agg else tandem_refold
    return refold(params, slot.k, lam, rate, feasible.to(torch.bool), use_kernel)


def _mesh_key(mesh: FleetMesh | None) -> FleetMesh | None:
    """The mesh a solve shards over: None for no mesh or a one-device mesh
    (both run the unsharded code)."""
    return mesh if mesh is not None and mesh.size > 1 else None


def _mesh_chunk(mesh: FleetMesh | None) -> int:
    key = _mesh_key(mesh)
    return 1 if key is None else key.size


def _shard_slots(slot: BucketSlot, mesh: FleetMesh) -> list[tuple[BucketSlot, int]]:
    """A bucket's contiguous shards, one per mesh device, each with its
    real lane count. A shard past the bucket's real lanes holds only pad
    rows (copies of the bucket's row 0, a valid lane): it runs as one
    real lane, so every shard launches the bucket's program. Its results,
    like every pad row's, are never read back."""
    subs = shard_fleet_params(slot.sub, mesh)
    cached = (
        [None] * mesh.size if slot.cached is None
        else shard_fleet_params(slot.cached, mesh)
    )
    width = slot.width // mesh.size
    out = []
    for j, (sub, aux) in enumerate(zip(subs, cached)):
        real = min(width, max(1, len(slot.idx) - j * width))
        out.append((slot._replace(sub=sub, width=width, cached=aux), real))
    return out


def _device_context(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _solve_sharded(
    slots: list[BucketSlot], mesh: FleetMesh, n_iters: int, use_kernel: bool
) -> np.ndarray:
    """Every bucket split over the mesh: each device's shards are queued
    (copies and launches, under that device's current stream) into one
    packed [8, total / size] tensor of its own before the first copy back,
    so distinct cards run at once; a repeated device runs its shards in
    turn. The host then gathers each bucket's shards in lane order."""
    size = mesh.size
    total = sum(s.width for s in slots)
    sharded = [_shard_slots(slot, mesh) for slot in slots]
    packed = []
    for j, device in enumerate(mesh.devices):
        with _device_context(device):
            out = torch.empty((8, total // size), dtype=torch.float32, device=device)
            offset = 0
            for shards in sharded:
                shard, real = shards[j]
                res = _solve_slot(shard, device, n_iters, use_kernel, real_lanes=real)
                pack_result(res, out=out[:, offset : offset + shard.width])
                offset += shard.width
        packed.append(out)
    host = [p.cpu().numpy() for p in packed]
    packed_all = np.empty((8, total), np.float32)
    offset = shard_offset = 0
    for slot in slots:
        width = slot.width // size
        for j in range(size):
            packed_all[:, offset + j * width : offset + (j + 1) * width] = (
                host[j][:, shard_offset : shard_offset + width]
            )
        offset += slot.width
        shard_offset += width
    return packed_all


def solve_slots(
    slots: list[BucketSlot], device: torch.device, n_iters: int, use_kernel: bool,
    mesh: FleetMesh | None = None,
) -> np.ndarray:
    """Solve every bucket on `device`: a full bucket runs the sizing
    program (`fleet_size`/`tandem_fleet_size`), a refold bucket the
    rate-dependent half (`fleet_refold`/`tandem_refold`) on its cached
    columns. Each bucket writes its packed [8, width] result into one
    preallocated [8, total] device tensor; one `.cpu()` copy then brings
    every bucket back (the reference's single device round trip of
    `_jitted_multi`). Returns that host array, buckets in slot order.

    With a `mesh` of more than one device the buckets (padded to a
    multiple of its size) are split over its devices instead
    (`_solve_sharded`), and the host array is the same."""
    mesh = _mesh_key(mesh)
    with _prof.span("dispatch"):
        if mesh is None:
            packed = torch.empty(
                (8, sum(s.width for s in slots)), dtype=torch.float32, device=device
            )
            offset = 0
            for slot in slots:
                res = _solve_slot(slot, device, n_iters, use_kernel)
                pack_result(res, out=packed[:, offset : offset + slot.width])
                offset += slot.width
            packed_all = packed.cpu().numpy()
        else:
            packed_all = _solve_sharded(slots, mesh, n_iters, use_kernel)
    _prof.count("dispatches")
    return packed_all


def iter_slot_results(slots: list[BucketSlot], packed_all: np.ndarray):
    """(slot, FleetResult of its real lanes) per bucket of a solve."""
    offset = 0
    for slot in slots:
        res = unpack_result(packed_all[:, offset : offset + slot.width])
        offset += slot.width
        n = len(slot.idx)
        yield slot, FleetResult(*(np.asarray(f)[:n] for f in res))


def _solve_all(
    plan: FleetPlan | None,
    tandem: TandemPlan | None,
    device: torch.device,
    n_iters: int,
    use_kernel: bool,
    mesh: FleetMesh | None = None,
) -> tuple[FleetResult | None, FleetResult | None]:
    """Solve aggregated and tandem lanes, bucket by bucket, on `device`
    or split over `mesh` (`solve_slots`), and scatter the buckets back
    into lane order."""
    agg_out = _empty_result(plan.num_lanes) if plan is not None and plan.num_lanes else None
    tan_out = (
        _empty_result(tandem.num_lanes) if tandem is not None and tandem.num_lanes else None
    )
    slots = bucket_slots(plan, tandem, _mesh_chunk(mesh))
    if not slots:
        return agg_out, tan_out
    packed_all = solve_slots(slots, device, n_iters, use_kernel, mesh)
    for slot, res in iter_slot_results(slots, packed_all):
        out = agg_out if slot.kind == "agg" else tan_out
        for field, dst in zip(res, out):
            dst[slot.idx] = field
    return agg_out, tan_out


def _solve_entry(
    plan: FleetPlan | None,
    tandem: TandemPlan | None,
    mesh: FleetMesh | None,
    n_iters: int,
    backend: str,
    device,
) -> tuple[FleetResult | None, FleetResult | None]:
    """`_solve_all` behind the public entries: `backend` "cuda" or "torch"
    on `device` (None = the CUDA card, raising without one), split over
    `mesh` where it has more than one device (no `SIZING_SHARDS`: the
    reference's entries shard only over the mesh they are given)."""
    if backend == "native":
        raise ValueError(
            "backend 'native' has no batched sizing program; use 'cuda' or 'torch' "
            "(calculate_fleet(backend='native') sizes on the C++ solver)"
        )
    device = _check_backend(backend, device)
    mesh = _resolve_mesh(mesh, False, backend, device, env=False)
    return _solve_all(plan, tandem, device, n_iters, backend == "cuda", mesh)


def solve_fleet(
    plan: FleetPlan | None,
    mesh: FleetMesh | None = None,
    n_iters: int = DEFAULT_BISECT_ITERS,
    backend: str = "cuda",
    device: str | torch.device | None = None,
) -> FleetResult:
    """Run the batched sizing for the aggregated lanes of a `build_fleet`
    plan, bucket by bucket, on `device`; optionally split lanes over a
    `mesh`. `backend` "cuda" launches the kernels, "torch" runs their
    plain versions (the reference's `use_pallas`). The result is the one
    `calculate_fleet` computes for the same plan, bit for bit. (Tandem
    lanes: see solve_tandem_fleet.)"""
    out, _ = _solve_entry(plan, None, mesh, n_iters, backend, device)
    return out if out is not None else _empty_result(0)


def solve_tandem_fleet(
    plan: TandemPlan | None,
    mesh: FleetMesh | None = None,
    n_iters: int = DEFAULT_BISECT_ITERS,
    backend: str = "cuda",
    device: str | torch.device | None = None,
) -> FleetResult:
    """Run the batched tandem sizing for the disaggregated lanes of a
    `build_tandem_fleet` plan (see solve_fleet)."""
    _, out = _solve_entry(None, plan, mesh, n_iters, backend, device)
    return out if out is not None else _empty_result(0)


# Solve memo: when both plans replay from the lane-set memo (identical
# object => identical content) under the same backend and device, the
# previous FleetResult is bit-identical too (the mesh is compared by
# identity, as the reference does) — skip the device round trip
# entirely. The memoized plans keep their ids alive, so identity is a
# sound content proxy here.
_solve_memo: dict = {}


def _solve_or_replay(
    plan: FleetPlan | None,
    tandem: TandemPlan | None,
    device: torch.device | None,
    backend: str,
    mesh: FleetMesh | None = None,
) -> tuple[FleetResult | None, FleetResult | None]:
    """Solve both plans through the selected backend (split over `mesh`
    where it has more than one device), replaying the
    previous results when the exact plan OBJECTS repeat (see _solve_memo).
    A repeated call on an unchanged fleet therefore measures nothing:
    timed repeats must change the loads in between."""
    mesh = None if backend == "native" else _mesh_key(mesh)
    memo = _solve_memo.get("last")
    if (
        memo is not None
        and memo["backend"] == backend
        and memo["device"] == device
        and memo["mesh"] is mesh
        and memo["plan"] is plan
        and memo["tandem"] is tandem
    ):
        _prof.count("solve_memo_hits")
        return memo["results"]
    _prof.count("solve_memo_misses")
    if backend == "native":
        # the C++ solver covers both lane kinds on the host, in f64 (its
        # own bisection depth): no device and no kernel on this path
        from inferno_tpu_torch.native import fleet_size_native, tandem_size_native

        result = fleet_size_native(plan.params) if plan is not None else None
        tresult = tandem_size_native(tandem.params) if tandem is not None else None
    else:
        result, tresult = _solve_all(
            plan, tandem, device, DEFAULT_BISECT_ITERS, backend == "cuda", mesh
        )
    _solve_memo["last"] = {
        "backend": backend, "device": device, "mesh": mesh, "plan": plan,
        "tandem": tandem, "results": (result, tresult),
    }
    return result, tresult


def _lane_orders(system: System, names: list[str], acc_order: dict, p):
    """(server_idx, acc_rank, chips_per_replica) per lane of a plan:
    snapshot-packed plans carry them; legacy-built plans (FLEET_SNAPSHOT=0)
    derive all three from the lane list."""
    if (
        p.server_idx is not None
        and p.acc_rank is not None
        and p.chips_per_replica is not None
    ):
        # snapshot-packed, version-safe
        return p.server_idx, p.acc_rank, p.chips_per_replica
    spos = {name: i for i, name in enumerate(names)}
    chips = np.empty(len(p.lanes), np.int64)
    for i, (s, a) in enumerate(p.lanes):
        model = system.models.get(system.servers[s].model_name)
        chips[i] = model.slices_per_replica(a) * system.accelerators[a].chips
    return (
        np.asarray([spos[s] for s, _ in p.lanes], np.int64),
        np.asarray([acc_order[a] for _, a in p.lanes], np.int64),
        chips,
    )


class _LaneSource:
    """Per-cycle context the lazy allocations materialize from: the solved
    plans/results plus the vectorized f64 transition-penalty values (bit
    identical to scalar `transition_penalty` on the same f32 results).

    `materialized` counts Allocation objects actually constructed (a
    constrained or unlimited solve must stay O(servers), never inflate
    O(lanes))."""

    __slots__ = ("plans", "results", "values", "batches", "spot", "materialized")

    def __init__(self):
        self.plans: dict[str, object] = {}
        self.results: dict[str, object] = {}
        self.values: dict[str, np.ndarray] = {}
        self.batches: dict[str, np.ndarray] = {}
        # per-kind spot columns when the System carries a spot tier:
        # (cost_adj f64, spot_reps i64, discount f64, premium f64,
        # trimmed bool); None keeps the pre-spot materialization (and
        # its f32 cost conversion) bit-identical
        self.spot: dict[str, tuple | None] = {}
        self.materialized = 0

    def add(self, kind, plan, result, values, batches, spot=None) -> None:
        self.plans[kind] = plan
        self.results[kind] = result
        self.values[kind] = values
        self.batches[kind] = batches
        self.spot[kind] = spot

    def materialize(self, kind: str, lane: int) -> Allocation:
        self.materialized += 1
        res = self.results[kind]
        _, acc = self.plans[kind].lanes[lane]
        spot = self.spot.get(kind)
        alloc = Allocation(
            accelerator=acc,
            num_replicas=int(res.num_replicas[lane]),
            batch_size=int(self.batches[kind][lane]),
            cost=(
                float(res.cost[lane]) if spot is None
                else float(spot[0][lane])
            ),
            itl=float(res.itl[lane]),
            ttft=float(res.ttft[lane]),
            rho=float(res.rho[lane]),
            max_arrv_rate_per_replica=float(res.rate_star[lane]) / 1000.0,
        )
        alloc.value = float(self.values[kind][lane])
        if spot is not None:
            alloc.spot_replicas = int(spot[1][lane])
            alloc.spot_discount = float(spot[2][lane])
            alloc.spot_premium = float(spot[3][lane])
            alloc.spot_trimmed = bool(spot[4][lane])
        return alloc


class LaneAllocations(dict):
    """`server.all_allocations` for a laned server: dict[acc, Allocation]
    whose entries materialize lazily from the vectorized fleet results.

    The unlimited solver consumes only `best()` — the per-server argmin
    precomputed vectorized in `calculate_fleet` — so the common cycle
    materializes exactly one Allocation per server instead of one per
    lane. Any ordinary dict access (`values()`, `in`, `len`, `==`, and
    `dict(...)`/`{**...}`, whose C fast path is disabled by the __iter__
    override) materializes the full candidate set first, so tests see
    plain-dict semantics. copy/pickle produce a PLAIN dict of the
    materialized entries.
    """

    __slots__ = ("_src", "_kinds", "_lanes", "_best")

    _KIND = ("agg", "tan")

    def __init__(self, src: _LaneSource, kinds, lanes, best: tuple | None):
        super().__init__()
        self._src = src
        self._kinds = kinds  # per-entry kind ids (0=agg, 1=tan), lane order
        self._lanes = lanes  # per-entry lane index into that kind's plan
        self._best = best  # (kind_id, lane) of the min-(value, cost, acc) lane

    def _ensure(self) -> None:
        if self._src is None:
            return
        src, self._src = self._src, None
        for kind_id, lane in zip(self._kinds, self._lanes):
            alloc = src.materialize(self._KIND[kind_id], int(lane))
            # best() may have landed this lane already; keep its identity
            if not dict.__contains__(self, alloc.accelerator):
                dict.__setitem__(self, alloc.accelerator, alloc)

    def best(self) -> Allocation | None:
        """The minimum-(value, cost, accelerator) candidate, materializing
        only that lane when the rest of the dict was never touched."""
        if self._best is None:
            return None
        if self._src is not None:
            return self.lane_alloc(*self._best)
        return min(
            dict.values(self),
            key=lambda a: (a.value, a.cost, a.accelerator),
            default=None,
        )

    def lane_alloc(self, kind_id: int, lane: int) -> Allocation:
        """Materialize ONE specific lane into the view's raw storage
        without inflating the rest, keeping object identity for later
        dict access. Only valid while the lazy source is still attached."""
        if self._src is None:
            raise RuntimeError("lane_alloc on a materialized LaneAllocations")
        kind = self._KIND[kind_id]
        acc = self._src.plans[kind].lanes[int(lane)][1]
        if not dict.__contains__(self, acc):  # raw check: stay lazy
            alloc = self._src.materialize(kind, int(lane))
            dict.__setitem__(self, alloc.accelerator, alloc)
            return alloc
        return dict.__getitem__(self, acc)

    def __reduce__(self):  # copy/pickle: materialize into a plain dict
        self._ensure()
        return (dict, (list(dict.items(self)),))


def _lazy(name):
    def method(self, *args, **kwargs):
        self._ensure()
        return getattr(dict, name)(self, *args, **kwargs)

    method.__name__ = name
    return method


for _name in (
    "__getitem__", "__iter__", "__len__", "__contains__", "__eq__", "__ne__",
    "__repr__", "__or__", "__ror__", "__setitem__", "__delitem__",
    "get", "keys", "values", "items", "copy", "pop", "popitem",
    "setdefault", "update", "clear",
):
    setattr(LaneAllocations, _name, _lazy(_name))
del _name


def candidate_order(
    sidx: np.ndarray, value: np.ndarray, cost: np.ndarray, rank: np.ndarray,
    materialization: bool = True,
):
    """THE deterministic candidate ordering: a global lexsort by (value,
    cost, accelerator rank) within per-server segments, plus (optionally)
    the stable by-server grouping that fixes the materialization/packing
    order. Returns (order, s_sorted, starts, bounds, order2) — order2 is
    None when `materialization` is False."""
    order = np.lexsort((rank, cost, value, sidx))
    s_sorted = sidx[order]
    starts = np.flatnonzero(np.r_[True, s_sorted[1:] != s_sorted[:-1]])
    bounds = np.append(starts, len(s_sorted))
    order2 = np.argsort(sidx, kind="stable") if materialization else None
    return order, s_sorted, starts, bounds, order2


@dataclasses.dataclass
class FleetCandidates:
    """Columnar per-server candidate table for the capacity-constrained
    solver: every FEASIBLE lane of this cycle's solve, sorted per server
    by the deterministic candidate key (value, cost, accelerator rank).
    Rows reference the lazy `_LaneSource`.

    Attached to `System.fleet_candidates` by `calculate_fleet`; arrays
    are only valid against the System they were built for."""

    src: _LaneSource
    server: np.ndarray  # server position (system order) per sorted row
    kind: np.ndarray  # 0=agg, 1=tan per sorted row
    lane: np.ndarray  # lane index into that kind's plan
    value: np.ndarray  # f64 transition penalty (the solver objective)
    cost: np.ndarray  # f64 (spot discount already applied)
    reps: np.ndarray  # int64 SLO-satisfying replica count
    chips: np.ndarray  # int64 chips per replica (slices x slice.chips)
    rank: np.ndarray  # int64 accelerator rank in the sorted catalog
    spot_reps: np.ndarray  # int64 replicas of `reps` on the spot tier
    bounds: np.ndarray  # per-server segment boundaries into the rows
    seg_server: np.ndarray  # server position per segment

    @property
    def num_rows(self) -> int:
        return len(self.server)


def _incremental_enabled() -> bool:
    return env_flag("INCREMENTAL_CYCLE", True)


def _zero_load_dict(system: System, server) -> dict[str, Allocation] | None:
    """Closed-form zero-load candidate set for one server (the scalar
    shortcut): None when the server has no model/class/target, else
    dict[acc, Allocation] with the scalar op order — spot discount first,
    transition penalty on the discounted price, plus the risk premium."""
    model = system.models.get(server.model_name)
    svc = system.service_classes.get(server.service_class_name)
    if model is None or svc is None or svc.target_for(server.model_name) is None:
        return None
    out: dict[str, Allocation] = {}
    for acc in server.candidate_accelerators(system).values():
        perf = model.perf_data.get(acc.name)
        if perf is None:
            continue
        alloc = _zero_load_allocation(server, model, acc, perf)
        _apply_spot(
            system, alloc, acc.cost * model.slices_per_replica(acc.name), 0,
        )
        alloc.value = (
            transition_penalty(server.cur_allocation, alloc)
            + alloc.spot_premium
        )
        out[acc.name] = alloc
    return out


def _check_backend(backend: str, device) -> torch.device | None:
    """Validate `backend` and resolve `device` (`fleet_device`): backend
    "cuda" needs a CUDA device; backend "native" runs on the host and
    resolves no device (None), whatever `device` says."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend == "native":
        return None
    device = fleet_device(device)
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(
            f"backend 'cuda' needs a CUDA device, got {device}; use backend "
            "'torch' on the CPU"
        )
    return device


def _env_mesh(device: torch.device) -> FleetMesh | None:
    """SIZING_SHARDS env -> a 1-D fleet mesh of that many shards; unset,
    unparsable, 0 or 1 = no mesh. On a CUDA device the mesh covers that
    many cards, capped at the cards visible (one card: no mesh); on the
    CPU (backend "torch", `device="cpu"`) the N shards run on the CPU, as
    the reference splits over its virtual devices. `fleet_mesh` hands out
    one object per device list, so the solve memo's and the incremental
    state's mesh identity holds across cycles."""
    raw = env_str("SIZING_SHARDS").strip()
    try:
        n = int(raw)
    except ValueError:
        return None
    if n <= 1:
        return None
    if device.type == "cuda":
        n = min(n, torch.cuda.device_count())
        return fleet_mesh(n) if n > 1 else None
    return fleet_mesh(devices=[device] * n)


def _resolve_mesh(
    mesh: FleetMesh | None, use_mesh: bool, backend: str, device: torch.device | None,
    env: bool = True,
) -> FleetMesh | None:
    """The mesh a call shards over (None: unsharded). `use_mesh` without a
    `mesh` is every visible CUDA device (`fleet_mesh()`, which raises with
    none); with neither, `SIZING_SHARDS` decides where `env` is set.
    Backend "native" ignores the mesh. A mesh must hold devices of the
    call's device type: the lanes never move to the CPU unless asked."""
    if backend == "native":
        return None
    if use_mesh and mesh is None:
        mesh = fleet_mesh()
    if mesh is None and env:
        mesh = _env_mesh(device)
    mesh = _mesh_key(mesh)
    if mesh is not None and any(d.type != device.type for d in mesh.devices):
        raise ValueError(
            f"mesh devices {[str(d) for d in mesh.devices]} do not match the "
            f"solve's device {device}"
        )
    return mesh


def calculate_fleet(
    system: System,
    backend: str = "cuda",
    device: str | torch.device | None = None,
    only: set[str] | None = None,
    lam_tolerance: float = 0.0,
    max_age_cycles: int = 0,
    event_dirty=None,
    mesh: FleetMesh | None = None,
    use_mesh: bool = False,
) -> int:
    """Replace System.calculate_all() with the batched fleet path.

    `backend` selects the stationary solve and the bisection: "cuda" (the
    hand-written kernels, the default; needs a CUDA device), "torch"
    (their plain torch versions, on any device) or "native" (the C++
    solver on the host, f64; `device` is ignored). `device=None` is the CUDA card and raises
    when there is none; the CPU is used only when asked for
    (`device="cpu"`, with backend "torch"). Returns the number of live
    lanes sized. Semantics match the scalar path: infeasible lanes
    produce no candidate; zero-load servers get the closed-form shortcut;
    every candidate's solver value is the transition penalty from the
    server's current allocation. `only` restricts sizing to a server
    subset; the others keep whatever candidates they carry.

    Candidates land as `LaneAllocations` — lazily materialized views of
    the result arrays with a vectorized per-server best pick — so the
    unlimited solver constructs O(servers) Allocation objects, not
    O(lanes).

    With INCREMENTAL_CYCLE on (the default) and no `only` subset, the
    "cuda" and "torch" backends route through the incremental dirty-set cycle
    (parallel/incremental.py): the snapshot's scan classifies every
    server, clean servers replay last cycle's results and allocations
    untouched, and only dirty lanes run a kernel — the full sizing
    program for structure changes, the refold for λ-only changes.
    `lam_tolerance`/`max_age_cycles` are the scan's λ anchoring knobs
    (0 = exact). `event_dirty` (an iterable of server names) runs the
    scan event-authoritative: only the named servers are re-read. It is
    ignored on the non-incremental path, where the full pass is a
    superset anyway.

    `mesh` (a `parallel.mesh.FleetMesh`) splits every bucket's lanes over
    its devices, on both paths; `use_mesh=True` without one takes every
    visible CUDA device (`fleet_mesh()`); with neither, the
    `SIZING_SHARDS` environment variable sets the shard count (unset, 0
    or 1: none). The decisions are the same bits as without a mesh.
    Backend "native" ignores the mesh.
    """
    with _prof.span("calculate_fleet", own=True):
        return _calculate_fleet(
            system, backend, device, only, lam_tolerance, max_age_cycles,
            event_dirty, mesh, use_mesh,
        )


def _calculate_fleet(
    system, backend, device, only, lam_tolerance, max_age_cycles, event_dirty,
    mesh, use_mesh,
) -> int:
    """The body of `calculate_fleet`, inside its span."""
    device = _check_backend(backend, device)
    mesh = _resolve_mesh(mesh, use_mesh, backend, device)

    # the candidate table is rebuilt (or cleared) every call — a stale
    # table must never describe lanes of a previous solve
    system.fleet_candidates = None
    system.fleet_candidates_builder = None
    system.fleet_dirty = None

    from inferno_tpu_torch.parallel import incremental

    if (
        _incremental_enabled()
        and _snapshot_enabled()
        and only is None
        and backend != "native"
    ):
        return incremental.incremental_cycle(
            system, device, backend, lam_tolerance, max_age_cycles,
            event_dirty=event_dirty, mesh=mesh,
        )
    # a non-incremental pass over the state's own System voids the
    # incremental state: its replay claims about these servers go stale
    # (a pass over a different System leaves it intact — the tables are
    # content-addressed through the snapshot)
    incremental.reset_state_for(system)

    for name, server in system.servers.items():
        if only is not None and name not in only:
            continue  # sizing-cache replay already populated these
        server.all_allocations = {}

    # zero-load shortcut (scalar, closed-form, no queue solve needed)
    for name, server in system.servers.items():
        if only is not None and name not in only:
            continue
        load = server.load
        if load is None or load.arrival_rate < 0:
            continue
        if not (load.arrival_rate == 0 or load.avg_out_tokens == 0):
            continue  # loaded servers go through the batched path
        allocs = _zero_load_dict(system, server)
        if allocs:
            server.all_allocations = allocs

    known = None
    if _snapshot_enabled():
        snap = _get_snapshot()
        with _prof.span("snapshot_update"):
            known = snap.update(system)
    plan = build_fleet(system, only, _known_version=known)
    tandem = build_tandem_fleet(system, only, _known_version=known)
    system.candidates_calculated = True
    if plan is None and tandem is None:
        return 0

    # the memo holds strong refs to the exact plan objects it solved, so
    # `is` identity (not id()) is the content check
    result, tresult = _solve_or_replay(plan, tandem, device, backend, mesh)

    # -- vectorized writeback (host numpy, f64): per-lane transition
    # penalties, per-server candidate argmin, lazy Allocation views ---------
    names = list(system.servers)
    acc_order = {a: i for i, a in enumerate(sorted(system.accelerators))}
    n_srv = len(names)
    cur_rank = np.full(n_srv, -1, np.int64)
    cur_cost = np.zeros(n_srv, np.float64)
    cur_reps = np.full(n_srv, -1, np.int64)
    for i, server in enumerate(system.servers.values()):
        cur = server.cur_allocation
        if cur.accelerator:  # "" (no allocation) never equals a lane acc
            cur_rank[i] = acc_order.get(cur.accelerator, -1)
        cur_cost[i] = cur.cost
        cur_reps[i] = cur.num_replicas

    # spot tier: per-rank economics columns, resolved once per cycle
    # (spot/market.py); None keeps every lane on the pre-spot path
    spot_cols = None
    if getattr(system, "spot", None):
        from inferno_tpu_torch.spot.market import rank_columns

        spot_cols = rank_columns(system, sorted(system.accelerators))

    n = 0
    src = _LaneSource()
    # (sidx, rank, value, cost, reps, chips, spot_k, kind, lane) per
    # feasible lane
    cat: list[tuple[np.ndarray, ...]] = []
    kinds = []
    if plan is not None and result is not None:
        kinds.append((0, plan, result, np.asarray(plan.params.max_batch)))
        n += plan.num_lanes
    if tandem is not None and tresult is not None:
        kinds.append((1, tandem, tresult, np.asarray(tandem.params.decode_batch)))
        n += tandem.num_lanes
    for kind_id, p, res, batches in kinds:
        sidx, rank, chips = _lane_orders(system, names, acc_order, p)
        cost64 = np.asarray(res.cost, np.float64)
        reps = np.asarray(res.num_replicas, np.int64)
        spot = None
        if spot_cols is not None:
            from inferno_tpu_torch.spot.market import spot_split

            # load-required replicas (min-replica floor excluded): the
            # same f32 fold the sizing ran, at min_replicas = 0 —
            # replicas above this are storm-safe SLO headroom
            total = offered_load(
                np.asarray(p.params.total_rate, np.float32),
                np.asarray(p.params.target_tps, np.float32),
                np.asarray(p.params.out_tokens, np.float32),
                np,
            )
            required = fold_replicas(
                total, np.asarray(res.rate_star, np.float32), np.int32(0), np
            )
            spot_k, disc, prem, trimmed = spot_split(
                reps, required,
                np.asarray(p.params.cost_per_replica, np.float64),
                spot_cols[0][rank], spot_cols[1][rank],
                spot_cols[2][rank], spot_cols[3][rank],
            )
            # discount lands on the cost BEFORE the transition penalty
            # (the scalar path's apply_spot -> Server.calculate order)
            cost64 = cost64 - disc
            spot = (cost64, spot_k, disc, prem, trimmed)
        same_acc = rank == cur_rank[sidx]
        ccost = cur_cost[sidx]
        # transition_penalty(), elementwise in f64 with the scalar
        # formula's exact operation order — the argmin below must agree
        # bit-for-bit with the per-lane Python path it replaces
        value = np.where(
            same_acc & (reps == cur_reps[sidx]),
            0.0,
            np.where(
                same_acc,
                cost64 - ccost,
                ACCEL_PENALTY_FACTOR * (ccost + cost64) + (cost64 - ccost),
            ),
        )
        if spot is not None:
            # risky-spot premium rides the objective, not the price
            value = value + spot[3]
        src.add(LaneAllocations._KIND[kind_id], p, res, value, batches, spot)
        fe = np.asarray(res.feasible, bool)
        if fe.any():
            spot_k_fe = (
                spot[1][fe] if spot is not None
                else np.zeros(int(fe.sum()), np.int64)
            )
            cat.append((
                sidx[fe], rank[fe], value[fe], cost64[fe],
                reps[fe], np.asarray(chips, np.int64)[fe], spot_k_fe,
                np.full(int(fe.sum()), kind_id, np.int64), np.flatnonzero(fe),
            ))
    if not cat:
        return n

    (
        sidx_all, rank_all, val_all, cost_all,
        reps_all, chips_all, spot_all, kind_all, lane_all,
    ) = (np.concatenate(parts) for parts in zip(*cat))
    # per-server segment-argmin with the deterministic tie-break
    # (value, cost, accelerator rank) — mirrors solve_unlimited's scalar key;
    # materialization order = one stable grouping by server
    order, s_sorted, starts, bounds, order2 = candidate_order(
        sidx_all, val_all, cost_all, rank_all
    )
    kinds_sorted = kind_all[order2]
    lanes_sorted = lane_all[order2]
    servers_list = list(system.servers.values())
    for a, b in zip(bounds[:-1], bounds[1:]):
        first = order[a]
        servers_list[s_sorted[a]].all_allocations = LaneAllocations(
            src, kinds_sorted[a:b], lanes_sorted[a:b],
            (int(kind_all[first]), int(lane_all[first])),
        )
    # the capacity-constrained solver's columnar input: the same sorted
    # segments the argmin above consumed, one row per feasible lane
    system.fleet_candidates = FleetCandidates(
        src=src,
        server=s_sorted,
        kind=kind_all[order],
        lane=lane_all[order],
        value=val_all[order],
        cost=cost_all[order],
        reps=reps_all[order],
        chips=chips_all[order],
        rank=rank_all[order],
        spot_reps=spot_all[order],
        bounds=bounds,
        seg_server=s_sorted[starts],
    )
    return n
# -- batched time-axis / seed-ensemble solve (the offline planner's core) -----


# the named output surfaces of a batched solve — the `needs` vocabulary
# of `FleetBatchPrep.solve` (spot columns ride along whenever the System
# carries a spot tier; they are not individually selectable)
BATCH_OUTPUTS = ("choice", "replicas", "chips", "cost", "value")


@dataclasses.dataclass
class FleetBatchResult:
    """Compact solve outputs of `calculate_fleet_batch`: arrays shaped
    like the `rates` input — ``[T, servers]`` for a single trace,
    ``[seeds, T, servers]`` for a seed-batched ensemble — with NO
    per-timestep Allocation/LaneAllocations materialization.
    ``choice[..., s]`` indexes `accelerators` (the sorted catalog, i.e.
    the tie-break rank axis); -1 means the server holds no slice at that
    timestep (no feasible candidate, or the zero-load shortcut with
    min_replicas == 0)."""

    servers: list[str]  # system server order (the S axis)
    accelerators: list[str]  # sorted catalog (choice indexes this)
    choice: np.ndarray  # i32[..., S]
    replicas: np.ndarray  # i32[..., S]
    chips: np.ndarray  # i64[..., S]: whole-slice chip demand
    cost: np.ndarray  # f32[..., S]: cents/hr (spot discount applied)
    value: np.ndarray  # f64[..., S]: winner transition penalty
    # spot columns, filled only when the System carries a spot tier
    # (None otherwise — the extra per-chunk fold is gated on the tier):
    # replicas of the winner on the spot market, and the load-required
    # replica count (min-replica floor excluded) the storm evaluator
    # scores violations against (spot/scenarios.py)
    spot_replicas: np.ndarray | None = None  # i32[..., S]
    required: np.ndarray | None = None  # i32[..., S]

    @property
    def num_steps(self) -> int:
        return len(self.choice)


@dataclasses.dataclass
class FleetBatchSlab:
    """One chunk of a streaming batched solve, handed to the `consume`
    callback of `FleetBatchPrep.solve`. Output arrays are REUSED buffers
    — valid only for the duration of the callback; copy what must
    outlive it. Fields not requested via `needs` are None. `row0` is the
    slab's first row on the flattened (seeds x steps) axis, so a
    seed-ensemble consumer can map rows back to (seed, timestep) as
    ``divmod(row0 + i, T)``."""

    row0: int
    rates: np.ndarray  # f64[rows, S] — the input slab
    choice: np.ndarray | None  # i32[rows, S]
    replicas: np.ndarray | None  # i32[rows, S]
    chips: np.ndarray | None  # i64[rows, S]
    cost: np.ndarray | None  # f32[rows, S]
    value: np.ndarray | None  # f64[rows, S]
    spot_replicas: np.ndarray | None  # i32[rows, S] (spot tier only)
    required: np.ndarray | None  # i32[rows, S] (spot tier only)
    # advanced (planner/montecarlo.py): the raw per-lane replica fold,
    # lane axis = the prep's lane_* columns, BEFORE the zero-load
    # overlay — combined with `zmask` a consumer can aggregate winner
    # chips without materializing the [rows, S] outputs
    lane_reps: np.ndarray | None  # i32[rows, n_lanes]
    zmask: np.ndarray | None  # bool[rows, S]; None = no zero-shortcut rows
    # the card's rows only (`FleetBatchPrep.rows_on_card`, with `buckets=`):
    # the winners' chips summed per row into the bucket columns of the
    # ledger given to `solve` (pools, then quotas). The card path leaves
    # `lane_reps` and `zmask` None.
    demand: np.ndarray | None = None  # f64[rows, B]

    @property
    def rows(self) -> int:
        return len(self.rates)


def _batch_chunk_steps(requested: int | None, n_lanes: int) -> int:
    """Chunk size on the FLATTENED (seeds x steps) row axis: how many
    rows' [rows, lanes] fold tensors are resident at once.
    PLANNER_CHUNK_STEPS (env) or the `chunk_steps` argument pin it; the
    default bounds the slab to ~2 M lane-rows — with the ~8 live
    fold/argmin temporaries (f64/i64/f32, ~50 bytes per row all told)
    that's a ~100 MB peak regardless of fleet size OR ensemble seed
    count (a 200-seed ensemble runs more chunks, never bigger ones)."""
    if requested is None:
        requested = env_int("PLANNER_CHUNK_STEPS", 0)
    if requested > 0:
        return requested
    return max(1, 2_000_000 // max(n_lanes, 1))


class _CardRows:
    """The card's side of a `FleetBatchPrep` whose rows run on the card:
    its lane and server columns, uploaded once; the zero-load table,
    uploaded once it is built; a ledger's bucket map, uploaded once per
    ledger; and a set of chunk buffers for each solve in flight
    (`staging`), reused from chunk to chunk and from call to call: a
    pinned host slab of rates and of each output asked for, their twins
    on the card, and the demand. A solve nested in a consumer (the Monte
    Carlo accumulator's binding flush re-solves through the same prep)
    takes a set of its own, so it never writes over the slab its caller
    still reads. It keeps no reference to its prep, so a prep and its
    buffers go as soon as the prep's last user lets it go."""

    def __init__(self, prep: "FleetBatchPrep"):
        from inferno_tpu_torch.ops import cuda_queueing as cq

        self.n_ranks = len(prep.accelerators)
        self.device = prep.device
        n_srv = prep.n_servers
        lane_lo = np.zeros(n_srv + 1, np.int32)
        if prep.n_lanes:
            lane_lo[:] = np.searchsorted(prep.lane_server, np.arange(n_srv + 1))
            cols = (prep._l_rate_star, prep._l_tps, prep._l_out, prep._l_min_reps,
                    prep._l_cpr, prep._l_same, prep._l_creps, prep._l_ccost,
                    prep.lane_rank, prep.lane_chips)
        else:
            cols = (np.zeros(0),) * 10
        flags = prep._has_load.astype(np.uint8) | (prep._out_zero.astype(np.uint8) << 1)
        dtypes = (np.float32, np.float32, np.float32, np.int32, np.float32, np.uint8,
                  np.int64, np.float64, np.int32, np.int64)
        self.lanes = cq.PlanLanes(
            self._up(lane_lo), self._up(flags),
            *(self._up(np.asarray(c, dt)) for c, dt in zip(cols, dtypes)),
        )
        self.zero = None
        self._ledger = self._buckets = None
        # idle buffer sets, each ({host name: pinned}, {card name: tensor})
        self._idle: list[tuple[dict, dict]] = []

    def _up(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _slab(self, pool: dict, name: str, rows: int, width: int, dtype, pin: bool):
        """The first `rows` rows of buffer `name` ([>= rows, width]), grown
        when a chunk outgrows it."""
        buf = pool.get(name)
        if buf is None or buf.shape[0] < rows or buf.shape[1] != width:
            buf = pool[name] = torch.empty(
                (rows, width), dtype=dtype,
                **({"pin_memory": True} if pin else {"device": self.device}),
            )
        return buf[:rows]

    @contextlib.contextmanager
    def staging(self):
        """A set of chunk buffers for one solve call, no other call's while
        it is held."""
        st = self._idle.pop() if self._idle else ({}, {})
        try:
            yield st
        finally:
            self._idle.append(st)

    def bucket_map(self, ledger):
        from inferno_tpu_torch.ops import cuda_queueing as cq

        if ledger is not self._ledger:
            if len(ledger.rank_pid) != self.n_ranks:
                raise ValueError("the bucket ledger's ranks are not the prep's accelerators")
            n_pools = len(ledger.pools)
            self._buckets = cq.PlanBuckets(
                *(self._up(np.asarray(m, np.int32))
                  for m in (ledger.rank_pid, ledger.rank_q1, ledger.rank_q2)),
                n_pools, n_pools + len(ledger.quota_keys),
            )
            self._ledger = ledger
        return self._buckets

    def solve_chunk(self, st, r: np.ndarray, keys, ledger, zero_table):
        """One [rows, S] slab on the card, in the buffers `st` (from
        `staging`): ({key: its [rows, S] output, a view of one of them},
        the f64[rows, B] demand or None).
        `zero_table()` builds the zero-load table on the host the first
        time a slab needs it. Returns once the results are on the host."""
        from inferno_tpu_torch.ops import cuda_queueing as cq

        rows, n_srv = r.shape
        stream = torch.cuda.current_stream(self.device)
        host_pool, card_pool = st
        host_r = self._slab(host_pool, "rates", rows, n_srv, torch.float64, True)
        np.copyto(host_r.numpy(), r)
        rates = self._slab(card_pool, "rates", rows, n_srv, torch.float64, False)
        rates.copy_(host_r, non_blocking=True)
        out = {k: self._slab(card_pool, k, rows, n_srv, cq.PLAN_ROW_DTYPES[k], False)
               for k in keys}
        buckets = self.bucket_map(ledger) if ledger is not None else None
        if buckets is not None and buckets.n == 0:
            buckets = None
        demand = (self._slab(card_pool, "demand", rows, buckets.n, torch.int64, False)
                  if buckets is not None else None)
        need_zero = self._slab(card_pool, "need_zero", 1, 1, torch.int32, False)[0]
        host = {k: self._slab(host_pool, k, rows, n_srv, cq.PLAN_ROW_DTYPES[k], True)
                for k in keys}
        host_demand = (self._slab(host_pool, "demand", rows, buckets.n, torch.int64, True)
                       if buckets is not None else None)
        host_need = self._slab(host_pool, "need_zero", 1, 1, torch.int32, True)[0]
        for _ in range(2):
            cq.plan_rows(rates, self.lanes, ACCEL_PENALTY_FACTOR, self.zero, out,
                         buckets, demand, need_zero)
            for k in keys:
                host[k].copy_(out[k], non_blocking=True)
            if demand is not None:
                host_demand.copy_(demand, non_blocking=True)
            host_need.copy_(need_zero, non_blocking=True)
            stream.synchronize()
            if self.zero is not None or not int(host_need[0]):
                break
            # a zero-load cell met the table before it was built: build it
            # on the host (the transition basis pinned at the prep's
            # __init__), upload it once, and solve the slab again
            table = zero_table()
            self.zero = cq.PlanZero(*(self._up(table[k]) for k in cq.PlanZero._fields))
        views = {k: host[k].numpy() for k in keys}
        if host_demand is None:
            dem = np.zeros((rows, 0), np.float64) if ledger is not None else None
        else:
            dem = host_demand.numpy().astype(np.float64)
        return views, dem


class FleetBatchPrep:
    """The rate-independent half of the batched time-axis solve,
    prepared ONCE and replayed over any number of [T, S] or
    [seeds, T, S] rate tensors.

    `prepare_fleet_batch` runs everything `calculate_fleet_batch` needs
    that does not depend on the rates: the snapshot/plan derivation and
    the grid solve on `device` (`solve_slots`: on backend "cuda" both
    hand-written kernels run, a full sizing of every bucket; the sizing bisection is rate-independent —
    lambda*, per-replica capacity, and feasibility depend only on
    profiles and SLO targets), the feasible-lane fold columns, the
    current-allocation transition basis, and the zero-load shortcut
    table. `solve` then runs only the per-row work — the f32 replica
    fold, transition penalties, and the per-server segment argmin — over
    [rows, lanes] slabs of the flattened (seeds x steps) axis: on the card
    where `rows_on_card` (backend "cuda", no spot tier; `_CardRows`),
    else in host numpy (`_solve_chunk`), with the same bits.

    The Monte Carlo driver (planner/montecarlo.py) prepares one context
    and streams hundreds of seeded traces through ``solve(...,
    consume=)``, so the whole ensemble pays lane derivation and the grid
    solve exactly once. A prep describes the System AS PREPARED — it is
    a per-fleet value like the System, not a live view.
    """

    def __init__(
        self,
        system: System,
        backend: str = "cuda",
        device: str | torch.device | None = None,
        mesh: FleetMesh | None = None,
        use_mesh: bool = False,
    ):
        device = _check_backend(backend, device)
        # as the reference's prep: `mesh`/`use_mesh` only, no SIZING_SHARDS
        mesh = _resolve_mesh(mesh, use_mesh, backend, device, env=False)
        self.system = system
        self.backend = backend
        self.device = device
        self.mesh = mesh
        names = list(system.servers)
        self.servers = names  # the S axis
        self.n_servers = len(names)
        servers_list = list(system.servers.values())
        acc_names = sorted(system.accelerators)
        self.accelerators = acc_names
        acc_order = {a: i for i, a in enumerate(acc_names)}
        n_srv = self.n_servers

        # current-allocation columns: the transition-penalty basis,
        # identical to the per-cycle writeback's
        cur_rank = np.full(n_srv, -1, np.int64)
        cur_cost = np.zeros(n_srv, np.float64)
        cur_reps = np.full(n_srv, -1, np.int64)
        for i, server in enumerate(servers_list):
            cur = server.cur_allocation
            if cur.accelerator:
                cur_rank[i] = acc_order.get(cur.accelerator, -1)
            cur_cost[i] = cur.cost
            cur_reps[i] = cur.num_replicas
        self._cur_rank, self._cur_cost, self._cur_reps = (
            cur_rank, cur_cost, cur_reps,
        )
        # the zero-load table is built lazily (below) but must share
        # THIS transition basis: pin the current-allocation objects now
        # so a prep reused across cycles — where a reconcile replaces
        # server.cur_allocation — never mixes an old sized basis with a
        # new zero-shortcut basis in one result
        self._cur_allocs = [s.cur_allocation for s in servers_list]

        self.spot_on = bool(getattr(system, "spot", None))
        # where the per-row work runs: on the card (plan_rows_kernel.cu)
        # for backend "cuda" (always a CUDA device) without a spot tier,
        # else host numpy (`_solve_chunk`); the two give the same bits
        self.rows_on_card = backend == "cuda" and not self.spot_on
        self._card_rows = None

        # zero-load shortcut basis: the per-timestep rate replaces the
        # arrival rate, so any server can hit rate == 0 at some row. The
        # O(servers x accelerators) closed-form table itself is built
        # LAZILY by `_ensure_zero_table` the first time a slab actually
        # contains a zero-rate (or out_tokens == 0) cell — an
        # all-positive replay never pays the scalar walk.
        has_load = np.zeros(n_srv, bool)
        out_zero = np.zeros(n_srv, bool)
        for i, server in enumerate(servers_list):
            load = server.load
            if load is None:
                continue
            has_load[i] = True
            out_zero[i] = load.avg_out_tokens == 0
        self._has_load, self._out_zero = has_load, out_zero
        self._any_out_zero = bool(out_zero.any())
        self._zero_table = None

        # lane structure under a positive placeholder rate: every
        # replayed server must contribute its token-eligible lanes
        # regardless of the System's own arrival (rates replace it row
        # by row). Token stats are untouched, so batch rescale / grids /
        # eligibility beyond the arrival>0 test are exactly the
        # per-cycle ones, and the plan + solve memos make re-preparation
        # on an unchanged fleet free.
        loaded = [s for s in servers_list if s.load is not None]
        saved = [s.load.arrival_rate for s in loaded]
        for s in loaded:
            s.load.arrival_rate = 60.0  # 1 req/s placeholder
        try:
            known = (
                _get_snapshot().update(system) if _snapshot_enabled() else None
            )
            plan = build_fleet(system, _known_version=known)
            tandem = build_tandem_fleet(system, _known_version=known)
            if plan is not None or tandem is not None:
                result, tresult = _solve_or_replay(plan, tandem, device, backend, mesh)
            else:
                result = tresult = None
        finally:
            for s, r in zip(loaded, saved):
                s.load.arrival_rate = r

        # feasible-lane columns (feasibility is rate-independent),
        # concatenated across kinds and grouped per server for the
        # segment argmin
        cols: list[tuple[np.ndarray, ...]] = []
        for p, res in ((plan, result), (tandem, tresult)):
            if p is None or res is None or not p.num_lanes:
                continue
            sidx, rank, chips = _lane_orders(system, names, acc_order, p)
            fe = np.asarray(res.feasible, bool)
            if not fe.any():
                continue
            cols.append((
                sidx[fe],
                np.asarray(rank, np.int64)[fe],
                np.asarray(chips, np.int64)[fe],
                np.asarray(res.rate_star, np.float32)[fe],
                np.asarray(p.params.target_tps, np.float32)[fe],
                np.asarray(p.params.out_tokens, np.float32)[fe],
                np.asarray(p.params.min_replicas, np.int32)[fe],
                np.asarray(p.params.cost_per_replica, np.float32)[fe],
            ))
        if cols:
            (
                l_sidx, l_rank, l_chips, l_rate_star,
                l_tps, l_out, l_min_reps, l_cpr,
            ) = (np.concatenate(parts) for parts in zip(*cols))
            order = np.argsort(l_sidx, kind="stable")
            l_sidx, l_rank, l_chips = l_sidx[order], l_rank[order], l_chips[order]
            l_rate_star, l_tps, l_out = (
                l_rate_star[order], l_tps[order], l_out[order],
            )
            l_min_reps, l_cpr = l_min_reps[order], l_cpr[order]
            self.n_lanes = len(l_sidx)
            starts = np.flatnonzero(np.r_[True, l_sidx[1:] != l_sidx[:-1]])
            self._starts = starts
            self._seg_len = np.diff(np.append(starts, self.n_lanes))
            self.seg_server = l_sidx[starts]
            self.lane_server = l_sidx
            self.lane_rank = l_rank
            self.lane_chips = l_chips
            self._l_rate_star, self._l_tps, self._l_out = (
                l_rate_star, l_tps, l_out,
            )
            self._l_min_reps, self._l_cpr = l_min_reps, l_cpr
            # offered_load's TPS override is a no-op when no lane carries
            # a TPS target (where(tps>0, ..., total) == total exactly) —
            # skip the pass entirely in that common case
            self._tps_bound = bool((l_tps > 0).any())
            self._l_same = l_rank == cur_rank[l_sidx]
            self._l_ccost = cur_cost[l_sidx]
            self._l_creps = cur_reps[l_sidx]
            self._lane_pos = np.arange(self.n_lanes, dtype=np.int64)
            self._lane_rank_i32 = l_rank.astype(np.int32)
            # every server segment holds exactly one feasible lane: the
            # (value, cost, rank) argmin is that lane — solve() skips
            # the whole reduceat machinery (a min over one element),
            # which is the common planner-fleet shape
            self.all_seg1 = bool(np.all(self._seg_len == 1))
            if self.spot_on:
                from inferno_tpu_torch.spot.market import rank_columns

                sc = rank_columns(system, acc_names)
                self._l_spot = tuple(col[l_rank] for col in sc)
                self._l_cpr64 = l_cpr.astype(np.float64)
        else:
            self.n_lanes = 0
            self.all_seg1 = False
            self.lane_server = self.lane_rank = self.lane_chips = None
            self.seg_server = None

    # -- zero-load shortcut table ---------------------------------------------

    def _ensure_zero_table(self):
        """Closed-form zero-load columns, built once on first need:
        mirrors calculate_fleet's shortcut loop + the solve_unlimited
        (value, cost, accelerator) scan — the live zero shortcut's op
        order (discount, penalty on the discounted price, premium)."""
        if self._zero_table is not None:
            return self._zero_table
        system = self.system
        n_srv = self.n_servers
        acc_order = {a: i for i, a in enumerate(self.accelerators)}
        zero_choice = np.full(n_srv, -1, np.int32)
        zero_reps = np.zeros(n_srv, np.int32)
        zero_chips = np.zeros(n_srv, np.int64)
        zero_cost = np.zeros(n_srv, np.float32)
        zero_value = np.zeros(n_srv, np.float64)
        zero_spot = np.zeros(n_srv, np.int32)
        for i, server in enumerate(system.servers.values()):
            if not self._has_load[i]:
                continue
            model = system.models.get(server.model_name)
            svc = system.service_classes.get(server.service_class_name)
            if (
                model is None
                or svc is None
                or svc.target_for(server.model_name) is None
            ):
                continue
            best = best_key = None
            for acc in server.candidate_accelerators(system).values():
                perf = model.perf_data.get(acc.name)
                if perf is None:
                    continue
                alloc = _zero_load_allocation(server, model, acc, perf)
                _apply_spot(
                    system, alloc,
                    acc.cost * model.slices_per_replica(acc.name), 0,
                )
                # transition basis = the allocation pinned at __init__,
                # the same snapshot the sized lanes' cur columns carry
                alloc.value = (
                    transition_penalty(self._cur_allocs[i], alloc)
                    + alloc.spot_premium
                )
                key = (alloc.value, alloc.cost, alloc.accelerator)
                if best is None or key < best_key:
                    best, best_key = alloc, key
            if best is not None and best.accelerator:
                zero_choice[i] = acc_order[best.accelerator]
                zero_reps[i] = best.num_replicas
                zero_chips[i] = best.num_replicas * model.slices_per_replica(
                    best.accelerator
                ) * system.accelerators[best.accelerator].chips
                zero_cost[i] = best.cost
                zero_value[i] = best.value
                zero_spot[i] = best.spot_replicas
        self._zero_table = {
            "choice": zero_choice, "replicas": zero_reps,
            "chips": zero_chips, "cost": zero_cost, "value": zero_value,
            "spot_replicas": zero_spot,
            "required": np.int32(0),
        }
        return self._zero_table

    def zero_columns(self) -> dict[str, np.ndarray]:
        """The per-server zero-load shortcut columns (building them on
        first call) — the values the overlay writes wherever a row's
        rate is 0 (or out_tokens == 0). Consumers correcting aggregated
        slabs (planner/montecarlo.py) read these."""
        return self._ensure_zero_table()

    # -- the per-slab kernel --------------------------------------------------

    def _solve_chunk(self, r: np.ndarray, out: dict, needs: frozenset):
        """Solve one [rows, S] rate slab on the host into the prefilled
        `out` views (only keys in `needs` — plus the spot columns when the
        tier is on — exist). Returns (lane_reps, zmask) for streaming
        consumers. The arithmetic and operation order are EXACTLY the
        per-cycle writeback's (tests/test_planner.py pins serial parity),
        and `plan_rows_kernel.cu`'s."""
        reps = None
        zmask = None
        if self.n_lanes:
            l_sidx = self.lane_server
            l_rank = self.lane_rank
            # the replica fold: the identical f32 arithmetic the sizing
            # programs (fleet_size/tandem_fleet_size) run per lane
            # (offered_load/fold_replicas shared with the kernels; lanes
            # in the table always have out_tokens > 0). The divide runs
            # the f64 loop and casts each quotient to f32 on the way out
            # — elementwise identical to (r / 60.0).astype(np.float32)
            # without materializing the f64 intermediate.
            r32 = np.divide(r, 60.0, out=np.empty(r.shape, np.float32),
                            casting="unsafe")
            total = r32[:, l_sidx]  # [rows, L]
            if self._tps_bound:
                total = offered_load(total, self._l_tps, self._l_out, np)
            spot_on = self.spot_on
            # `total` is a fresh gather; unless the spot pass still
            # needs it (the required-replica fold), lend it to the fold
            # as the quotient scratch buffer
            reps = fold_replicas(
                total, self._l_rate_star, self._l_min_reps, np,
                scratch=None if spot_on else total,
            )
            # the cost/value chains are skipped only when nothing that
            # needs them was requested AND the argmin is trivial (every
            # segment one lane); a multi-lane segment needs the value to
            # pick its winner no matter which outputs were asked for
            need_cost = (
                bool(needs & {"cost", "value"}) or spot_on or not self.all_seg1
            )
            need_value = "value" in needs or not self.all_seg1
            if need_cost:
                cost32 = reps.astype(np.float32)
                np.multiply(cost32, self._l_cpr, out=cost32)
                cost64 = cost32.astype(np.float64)
                if spot_on:
                    from inferno_tpu_torch.spot.market import spot_split

                    # the per-cycle writeback's spot pass, over the whole
                    # chunk: required replicas at min_replicas = 0, the
                    # split, discount off the cost BEFORE the penalty
                    required = fold_replicas(
                        total, self._l_rate_star, np.int32(0), np
                    )
                    spot_k, disc, prem, _ = spot_split(
                        reps, required, self._l_cpr64, *self._l_spot,
                    )
                    cost64 = cost64 - disc
                    cost32 = cost64.astype(np.float32)
            if need_value:
                # transition_penalty(), same f64 op order as the writeback
                value = np.where(
                    self._l_same & (reps == self._l_creps),
                    0.0,
                    np.where(
                        self._l_same,
                        cost64 - self._l_ccost,
                        ACCEL_PENALTY_FACTOR * (self._l_ccost + cost64)
                        + (cost64 - self._l_ccost),
                    ),
                )
                if spot_on:
                    value = value + prem
            seg = self.seg_server
            if self.all_seg1:
                # one lane per segment: the winner IS the lane (the
                # generic argmin below reduces over a single element) —
                # scatter lane columns straight into the outputs
                if "choice" in out:
                    out["choice"][:, seg] = self._lane_rank_i32
                if "replicas" in out:
                    out["replicas"][:, seg] = reps
                if "chips" in out:
                    out["chips"][:, seg] = (
                        reps.astype(np.int64) * self.lane_chips
                    )
                if "cost" in out:
                    out["cost"][:, seg] = cost32
                if "value" in out:
                    out["value"][:, seg] = value
                if spot_on:
                    out["spot_replicas"][:, seg] = spot_k.astype(np.int32)
                    out["required"][:, seg] = required.astype(np.int32)
            else:
                starts, seg_len = self._starts, self._seg_len
                # per-server lexicographic argmin on (value, cost, rank)
                # — the (value, cost, accelerator) key of solve_unlimited
                # and the per-cycle lexsort, over the whole chunk at once
                m = np.minimum.reduceat(value, starts, axis=1)
                tie = value == np.repeat(m, seg_len, axis=1)
                c_m = np.where(tie, cost64, np.inf)
                m2 = np.minimum.reduceat(c_m, starts, axis=1)
                tie &= c_m == np.repeat(m2, seg_len, axis=1)
                r_m = np.where(tie, l_rank, np.int64(2**62))
                m3 = np.minimum.reduceat(r_m, starts, axis=1)
                # rank is unique per server segment => exactly one winner
                win_lane = np.where(
                    r_m == np.repeat(m3, seg_len, axis=1),
                    self._lane_pos, np.int64(self.n_lanes),
                )
                win = np.minimum.reduceat(win_lane, starts, axis=1)
                reps_w = np.take_along_axis(reps, win, axis=1)
                if "choice" in out:
                    out["choice"][:, seg] = l_rank[win].astype(np.int32)
                if "replicas" in out:
                    out["replicas"][:, seg] = reps_w
                if "chips" in out:
                    out["chips"][:, seg] = (
                        reps_w.astype(np.int64) * self.lane_chips[win]
                    )
                if "cost" in out:
                    out["cost"][:, seg] = np.take_along_axis(
                        cost32, win, axis=1
                    )
                if "value" in out:
                    out["value"][:, seg] = np.take_along_axis(
                        value, win, axis=1
                    )
                if spot_on:
                    out["spot_replicas"][:, seg] = np.take_along_axis(
                        spot_k, win, axis=1
                    ).astype(np.int32)
                    out["required"][:, seg] = np.take_along_axis(
                        required, win, axis=1
                    ).astype(np.int32)
        # zero-load shortcut overlay: rate == 0 (or out_tokens == 0,
        # which shortcuts regardless of rate) replaces the sized pick
        if self._any_out_zero:
            zmask = (
                (r == 0.0) | self._out_zero[None, :]
            ) & self._has_load[None, :]
            if not zmask.any():
                zmask = None
        else:
            zmask = r == 0.0
            if zmask.any():
                zmask &= self._has_load[None, :]
                if not zmask.any():
                    zmask = None
            else:
                zmask = None
        if zmask is not None:
            table = self._ensure_zero_table()
            for key, view in out.items():
                zcol = table[key]
                np.copyto(
                    view, np.broadcast_to(zcol, view.shape), where=zmask
                )
        return reps, zmask

    # -- the driver loop ------------------------------------------------------

    def solve(
        self,
        rates,
        chunk_steps: int | None = None,
        consume=None,
        needs=None,
        validate: bool = True,
        buckets=None,
    ) -> FleetBatchResult | None:
        """Solve a rate tensor against the prepared fleet.

        `rates` is [T, S] or [seeds, T, S] in req/min, S = the system's
        server order; leading axes are flattened into one row axis and
        chunked by `chunk_steps` / PLANNER_CHUNK_STEPS (chunk placement
        never changes results — a seed boundary is just another row).

        Default (materializing) mode returns a `FleetBatchResult` whose
        arrays mirror the `rates` shape. With `consume`, nothing is
        materialized: the callback receives one `FleetBatchSlab` per
        chunk (reused buffers) and solve returns None — peak memory is
        the slab, regardless of seed count. `needs` (an iterable of
        BATCH_OUTPUTS names, consume mode only) trims which output
        surfaces are computed: a demand-envelope consumer that only
        needs `chips` + `cost` skips the f64 value chain entirely on
        single-lane fleets. `validate=False` skips the finiteness scan —
        for drivers whose generators already guarantee finite, >= 0
        rates (planner/scenarios.py clamps at build time).

        Where the rows run on the card (`rows_on_card`), each chunk is one
        launch of `ops/csrc/plan_rows_kernel.cu` and its outputs come back
        to the host before the chunk's span closes; `buckets` (consume
        mode: a `solver.greedy_vec.capacity_buckets` ledger) also has the
        kernel sum each row's winner chips into the ledger's columns,
        handed over as `slab.demand`. On the host path `slab.demand` is
        None."""
        rates = np.asarray(rates, np.float64)
        if rates.ndim not in (2, 3) or rates.shape[-1] != self.n_servers:
            raise ValueError(
                f"rates must be [T, {self.n_servers}] or "
                f"[seeds, T, {self.n_servers}] (system server order), "
                f"got {rates.shape}"
            )
        if validate and (
            not np.all(np.isfinite(rates)) or (rates < 0).any()
        ):
            raise ValueError("rates must be finite and >= 0")
        lead = rates.shape[:-1]
        flat = rates.reshape(-1, self.n_servers)
        n_rows = len(flat)
        if needs is not None and consume is None:
            # a materialized FleetBatchResult always carries every
            # surface; silently dropping the trim would hide both the
            # intent and any typo in the names
            raise ValueError("needs= trims streaming outputs; it requires "
                             "consume=")
        if buckets is not None and consume is None:
            raise ValueError("buckets= sums streaming demand; it requires "
                             "consume=")
        if needs is None:
            needs = frozenset(BATCH_OUTPUTS)
        else:
            needs = frozenset(needs)
            unknown = needs - set(BATCH_OUTPUTS)
            if unknown:
                raise ValueError(
                    f"unknown batch outputs {sorted(unknown)}; "
                    f"available: {BATCH_OUTPUTS}"
                )
        chunk = _batch_chunk_steps(chunk_steps, self.n_lanes)
        n_srv = self.n_servers
        spot_on = self.spot_on

        fills = {
            "choice": (np.int32, -1),
            "replicas": (np.int32, 0),
            "chips": (np.int64, 0),
            "cost": (np.float32, 0),
            "value": (np.float64, 0),
            "spot_replicas": (np.int32, 0),
            "required": (np.int32, 0),
        }
        keys = [k for k in BATCH_OUTPUTS if k in needs]
        if spot_on:
            keys += ["spot_replicas", "required"]

        card = None
        staging = contextlib.nullcontext()
        if self.rows_on_card:
            if self._card_rows is None:
                self._card_rows = _CardRows(self)
            card = self._card_rows
            staging = card.staging()
        rows_counter = "plan_card_rows" if card is not None else "plan_host_rows"

        with staging as st:
            if consume is None:
                full = {
                    key: np.full((n_rows, n_srv), fills[key][1], fills[key][0])
                    for key in keys
                }
                for t0 in range(0, n_rows, chunk):
                    r = flat[t0 : t0 + chunk]
                    views = {key: arr[t0 : t0 + len(r)] for key, arr in full.items()}
                    with _prof.span("plan_fold"):
                        if card is not None:
                            got, _ = card.solve_chunk(
                                st, r, keys, None, self._ensure_zero_table)
                            for key, view in views.items():
                                np.copyto(view, got[key])
                        else:
                            self._solve_chunk(r, views, needs)
                    _prof.count(rows_counter, len(r))

                def shaped(key):
                    arr = full.get(key)
                    return None if arr is None else arr.reshape(lead + (n_srv,))

                return FleetBatchResult(
                    servers=self.servers,
                    accelerators=self.accelerators,
                    choice=shaped("choice"),
                    replicas=shaped("replicas"),
                    chips=shaped("chips"),
                    cost=shaped("cost"),
                    value=shaped("value"),
                    spot_replicas=shaped("spot_replicas"),
                    required=shaped("required"),
                )

            bufs = {} if card is not None else {
                key: np.empty((min(chunk, max(n_rows, 1)), n_srv), fills[key][0])
                for key in keys
            }
            for t0 in range(0, n_rows, chunk):
                r = flat[t0 : t0 + chunk]
                rows = len(r)
                demand = lane_reps = zmask = None
                if card is not None:
                    with _prof.span("plan_fold"):
                        views, demand = card.solve_chunk(
                            st, r, keys, buckets, self._ensure_zero_table)
                else:
                    views = {}
                    for key, buf in bufs.items():
                        view = buf[:rows]
                        view.fill(fills[key][1])
                        views[key] = view
                    with _prof.span("plan_fold"):
                        lane_reps, zmask = self._solve_chunk(r, views, needs)
                _prof.count(rows_counter, rows)
                consume(FleetBatchSlab(
                    row0=t0,
                    rates=r,
                    choice=views.get("choice"),
                    replicas=views.get("replicas"),
                    chips=views.get("chips"),
                    cost=views.get("cost"),
                    value=views.get("value"),
                    spot_replicas=views.get("spot_replicas"),
                    required=views.get("required"),
                    lane_reps=lane_reps,
                    zmask=zmask,
                    demand=demand,
                ))
            return None


def prepare_fleet_batch(
    system: System,
    backend: str = "cuda",
    device: str | torch.device | None = None,
    mesh: FleetMesh | None = None,
    use_mesh: bool = False,
) -> FleetBatchPrep:
    """Prepare the rate-independent context of the batched solve ONCE —
    snapshot/plan derivation, the grid solve on `device`, fold columns, the
    zero-load table — for replay over many rate tensors (the Monte Carlo
    ensemble driver's entry point; `calculate_fleet_batch` is this plus
    one `solve`). `mesh`/`use_mesh` split the grid solve's lanes over
    devices, as in `calculate_fleet`."""
    return FleetBatchPrep(
        system, backend=backend, device=device, mesh=mesh, use_mesh=use_mesh
    )


def calculate_fleet_batch(
    system: System,
    rates,
    backend: str = "cuda",
    device: str | torch.device | None = None,
    chunk_steps: int | None = None,
    mesh: FleetMesh | None = None,
    use_mesh: bool = False,
) -> FleetBatchResult:
    """Solve T timesteps (or a whole [seeds, T, S] seeded ensemble) of
    per-server arrival rates in one pass: the batched equivalent of the
    serial loop

        for t in range(T):
            <set server.load.arrival_rate = rates[t]>; calculate_fleet(...)
            solve_unlimited(...)

    with bit-identical choices, replica counts, and chip demand
    (tests/test_planner.py pins T=1 and multi-T parity;
    tests/test_montecarlo.py pins the seed axis), at a fraction of the
    cost. `rates` is [T, S] — or [seeds, T, S], solved as one flattened
    row axis — in req/min, S = the system's server order; per-row rates
    REPLACE each server's arrival rate, token mix and everything
    structural stay as carried by the System.

    Why this is cheap: the snapshot's structure signatures are
    load-independent, so the replay pays lane derivation and plan
    packing exactly ONCE; and the sizing bisection itself is
    rate-independent (lambda*, per-replica capacity, and feasibility
    depend only on profiles and SLO targets), so the grid solve on the
    card is hoisted out of the time AND seed axes entirely
    (`prepare_fleet_batch` exposes the prepared context for drivers that
    replay many tensors). Per row only the replica fold (the exact f32
    arithmetic of the sizing program), the f64 transition penalties, and
    the per-server (value, cost, rank) argmin run — one kernel launch a
    slab on backend "cuda" without a spot tier, else vectorized numpy
    (`ops.queueing.fold_replicas` with `xp=np`) over [rows, lanes] slabs
    (`chunk_steps` / PLANNER_CHUNK_STEPS bounds the resident slab on the
    flattened axis; chunk placement never changes results). Zero-rate
    rows take the closed-form zero-load shortcut, built lazily once per
    prep.

    `backend`/`device` are `calculate_fleet`'s: "cuda" (the default) on
    the card, or "torch" on any device (`device="cpu"` on a machine
    without one); `device=None` without CUDA raises. `mesh`/`use_mesh`
    split the prep's grid solve over devices (same bits).
    """
    prep = prepare_fleet_batch(
        system, backend=backend, device=device, mesh=mesh, use_mesh=use_mesh
    )
    return prep.solve(rates, chunk_steps=chunk_steps)
