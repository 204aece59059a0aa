// The capacity planner's per-row work on Hopper (sm_90a): for every row of a
// [rows, S] rate slab and every server, the replica fold of each of the
// server's feasible lanes, the cost and transition-penalty value, the
// lexicographic (value, cost, rank) argmin over the server's lanes, the
// zero-load overlay, and the winner's chips summed into the row's capacity
// buckets. One launch a slab.
//
// Replaces no TPU kernel: the reference runs this in host numpy
// (inferno_tpu/parallel/fleet.py::FleetBatchPrep._solve_chunk, and the
// bucket demand of planner/montecarlo.py::_EnvelopeAccumulator._feed), and so
// does the port on the CPU, for backend "torch" and for fleets with a spot
// tier. The Python wrapper is inferno_tpu_torch/ops/cuda_queueing.py::plan_rows;
// the numpy path is its plain version, and the card tests hold the two to the
// same bits (tests/test_torch_plan_rows_kernel.py).
//
// Per (row, server s) with lanes [lo, hi) (lanes sorted by server):
//   r32    = (float)(rate / 60.0)                f64 divide, one rounding to f32
//   total  = tps > 0 ? tps / out_tokens : r32    offered_load
//   reps   = max(int32(ceil(total / rate_star)), max(min_reps, 1))
//            where the int32 cast of a NaN or out-of-range quotient gives
//            INT_MIN, as numpy's cast on the host does (not CUDA's saturation)
//   cost32 = float(reps) * cost_per_replica;  cost64 = (double)cost32
//   value  = same && reps == cur_reps ? 0 : same ? cost64 - cur_cost
//            : penalty * (cur_cost + cost64) + (cost64 - cur_cost)
//   winner = the argmin of (value, cost64, rank) with numpy's minimum.reduceat
//            semantics: a NaN value (or a NaN cost among the value's ties)
//            makes the server's first lane the winner
// then, where the server has load and its rate is 0 or its output tokens are
// 0, the zero-load table's columns replace the pick. Servers without a lane
// write the fills (choice -1, everything else 0). Built with --fmad=false and
// no fast math, every divide, multiply and add rounds as numpy's does.
//
// Bucket demand: each winner's chips go to its rank's pool column and, where
// they exist, its two quota columns. A warp sums equal buckets with shuffles
// (exact 64-bit integers), a block into shared memory, and one atomic a
// bucket a block lands it in the [rows, B] output, which the launch zeroes.
// Integer sums are exact in any order, so the host's f64 bincount of the same
// winners equals them bit for bit below 2^53.
//
// What bounds it on this card: the bytes. A row of S servers reads 8 S bytes
// of rates and writes 4 S bytes of cost (more where other outputs are asked
// for); the lane columns (about 50 bytes a lane) and the server columns stay
// in L2 across rows. At the planner's chunk of 155 rows by 10,000 servers
// that is about 18.6 MB, some 5.6 us at 3.35 TB/s; the arithmetic is a few
// divides a lane. Design: one thread a (row, server), so the rate is read
// once and coalesced, and the lanes of a server (one or two in practice) are
// each evaluated once, the argmin kept in registers as they pass.

#include <cuda_runtime.h>
#include <math.h>

#include <climits>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
// the widest bucket vector a block sums in shared memory (8 bytes a bucket);
// a wider one is summed straight into the output
constexpr int SMEM_BUCKETS = 4096;
constexpr unsigned char HAS_LOAD = 1;
constexpr unsigned char OUT_ZERO = 2;

struct Lanes {
    const int* lane_lo;  // [S + 1]: server s owns lanes [lane_lo[s], lane_lo[s + 1])
    const unsigned char* flags;  // [S]: HAS_LOAD | OUT_ZERO
    const float* rate_star;
    const float* tps;
    const float* out_tokens;
    const int* min_reps;
    const float* cpr;
    const unsigned char* same;  // the lane's rank is the server's current one
    const long long* cur_reps;
    const double* cur_cost;
    const int* rank;
    const long long* chips;  // chips a replica
    double penalty;  // ACCEL_PENALTY_FACTOR
};

struct Zero {  // the zero-load table, per server; choice == nullptr: not built
    const int* choice;
    const int* reps;
    const long long* chips;
    const float* cost;
    const double* value;
};

struct Buckets {
    const int* pid;  // rank -> pool column
    const int* q1;  // rank -> quota column (-1: none)
    const int* q2;
    int n_pools;
    int n;  // pools + quotas
};

struct Out {  // [rows, S] each; nullptr: not asked for
    int* choice;
    int* reps;
    long long* chips;
    float* cost;
    double* value;
    unsigned long long* demand;  // [rows, B]
    int* need_zero;  // set where a zero-load cell met an unbuilt table
};

struct Pick {
    int reps;
    float cost;
    double cost64;
    double value;
};

// numpy's float32 -> int32 cast on the host: INT_MIN for NaN and anything
// outside [-2^31, 2^31)
__device__ __forceinline__ int host_int32(float c) {
    return (c >= -2147483648.0f && c < 2147483648.0f) ? static_cast<int>(c) : INT_MIN;
}

__device__ __forceinline__ Pick eval_lane(const Lanes& L, int j, float r32) {
    const float tps = L.tps[j];
    const float total = tps > 0.0f ? __fdiv_rn(tps, L.out_tokens[j]) : r32;
    const float q = ceilf(__fdiv_rn(total, L.rate_star[j]));
    const int reps = max(host_int32(q), max(L.min_reps[j], 1));
    Pick p;
    p.reps = reps;
    p.cost = __fmul_rn(__int2float_rn(reps), L.cpr[j]);
    p.cost64 = static_cast<double>(p.cost);
    const double cc = L.cur_cost[j];
    if (L.same[j]) {
        p.value = static_cast<long long>(reps) == L.cur_reps[j] ? 0.0 : __dsub_rn(p.cost64, cc);
    } else {
        p.value = __dadd_rn(__dmul_rn(L.penalty, __dadd_rn(cc, p.cost64)),
                            __dsub_rn(p.cost64, cc));
    }
    return p;
}

// the winning lane of [lo, hi) at r32 and its pick, as the host's three
// minimum.reduceat passes choose it, in one pass: the least value, then the
// least cost among the lanes of that value, then the least rank (the first
// lane where ranks tie). A NaN value anywhere, or a NaN cost among the lanes
// of the least value, makes the first lane the winner, as NaN does there.
__device__ __forceinline__ int argmin_lane(const Lanes& L, int lo, int hi, float r32,
                                           Pick& win) {
    int best = lo;
    bool nan_cost = false;
    for (int j = lo; j < hi; ++j) {
        const Pick p = eval_lane(L, j, r32);
        if (isnan(p.value)) {
            win = eval_lane(L, lo, r32);
            return lo;
        }
        if (j == lo || p.value < win.value) {  // a new least value
            best = j;
            win = p;
            nan_cost = isnan(p.cost64);
        } else if (p.value == win.value) {  // a tie on the value
            if (isnan(p.cost64)) {
                nan_cost = true;
            } else if (p.cost64 < win.cost64 ||
                       (p.cost64 == win.cost64 && L.rank[j] < L.rank[best])) {
                best = j;
                win = p;
            }
        }
    }
    if (nan_cost) {
        win = eval_lane(L, lo, r32);
        return lo;
    }
    return best;
}

// add v to target[key] for every lane of the warp with key >= 0: equal keys
// are summed with shuffles first, so one atomic a distinct key a warp.
// Every lane of the warp calls it.
__device__ __forceinline__ void warp_add(unsigned long long* target, int key,
                                         unsigned long long v) {
    const int lane = threadIdx.x & 31;
    unsigned pending = __ballot_sync(FULL, key >= 0);
    while (pending) {
        const int leader = __ffs(pending) - 1;
        const int k = __shfl_sync(FULL, key, leader);
        unsigned long long part = key == k ? v : 0ull;
        for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(FULL, part, off);
        if (lane == leader) atomicAdd(target + k, part);
        pending &= ~__ballot_sync(FULL, key == k);
    }
}

__global__ void __launch_bounds__(THREADS)
plan_rows_kernel(const double* __restrict__ rates, int rows, int S, Lanes L, Zero Z,
                 Buckets B, Out O) {
    extern __shared__ unsigned long long block_demand[];
    const bool smem = O.demand != nullptr && B.n <= SMEM_BUCKETS;
    const int s = blockIdx.x * THREADS + threadIdx.x;
    const bool live = s < S;
    for (int row = blockIdx.y; row < rows; row += gridDim.y) {
        int choice = -1, reps = 0;
        long long chips = 0;
        float cost = 0.0f;
        double value = 0.0;
        const size_t cell = static_cast<size_t>(row) * S + s;
        if (live) {
            const double r = rates[cell];
            const int lo = L.lane_lo[s], hi = L.lane_lo[s + 1];
            if (hi > lo) {
                const float r32 = __double2float_rn(__ddiv_rn(r, 60.0));
                Pick p;
                const int w = argmin_lane(L, lo, hi, r32, p);
                choice = L.rank[w];
                reps = p.reps;
                chips = static_cast<long long>(p.reps) * L.chips[w];
                cost = p.cost;
                value = p.value;
            }
            const unsigned char f = L.flags[s];
            if ((f & HAS_LOAD) && (r == 0.0 || (f & OUT_ZERO))) {
                if (Z.choice != nullptr) {
                    choice = Z.choice[s];
                    reps = Z.reps[s];
                    chips = Z.chips[s];
                    cost = Z.cost[s];
                    value = Z.value[s];
                } else {
                    *O.need_zero = 1;
                }
            }
            if (O.choice) O.choice[cell] = choice;
            if (O.reps) O.reps[cell] = reps;
            if (O.chips) O.chips[cell] = chips;
            if (O.cost) O.cost[cell] = cost;
            if (O.value) O.value[cell] = value;
        }
        if (O.demand == nullptr) continue;  // uniform across the block
        unsigned long long* row_demand = O.demand + static_cast<size_t>(row) * B.n;
        unsigned long long* target = smem ? block_demand : row_demand;
        if (smem) {
            for (int b = threadIdx.x; b < B.n; b += THREADS) block_demand[b] = 0ull;
            __syncthreads();
        }
        const bool won = live && choice >= 0;
        const unsigned long long v = won ? static_cast<unsigned long long>(chips) : 0ull;
        warp_add(target, won ? B.pid[choice] : -1, v);
        const int q1 = won ? B.q1[choice] : -1;
        warp_add(target, q1 >= 0 ? B.n_pools + q1 : -1, v);
        const int q2 = won ? B.q2[choice] : -1;
        warp_add(target, q2 >= 0 ? B.n_pools + q2 : -1, v);
        if (smem) {
            __syncthreads();
            for (int b = threadIdx.x; b < B.n; b += THREADS) {
                if (block_demand[b]) atomicAdd(row_demand + b, block_demand[b]);
            }
            __syncthreads();
        }
    }
}

}  // namespace

// Launch on `stream`. Zeroes the demand and the need-zero flag first (both
// optional). Returns the first CUDA error of the memsets and the launch: 0
// when all were accepted.
extern "C" int inferno_plan_rows_launch(
    const double* rates, int rows, int S, const int* lane_lo, const unsigned char* flags,
    const float* rate_star, const float* tps, const float* out_tokens, const int* min_reps,
    const float* cpr, const unsigned char* same, const long long* cur_reps,
    const double* cur_cost, const int* rank, const long long* chips, double penalty,
    const int* z_choice, const int* z_reps, const long long* z_chips, const float* z_cost,
    const double* z_value, const int* b_pid, const int* b_q1, const int* b_q2, int n_pools,
    int n_buckets, int* o_choice, int* o_reps, long long* o_chips, float* o_cost,
    double* o_value, unsigned long long* o_demand, int* need_zero, void* stream) {
    const auto st = static_cast<cudaStream_t>(stream);
    if (o_demand != nullptr) {
        const cudaError_t e = cudaMemsetAsync(
            o_demand, 0, sizeof(unsigned long long) * static_cast<size_t>(rows) * n_buckets, st);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const cudaError_t e = cudaMemsetAsync(need_zero, 0, sizeof(int), st);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (rows <= 0 || S <= 0) return 0;
    const Lanes L{lane_lo, flags, rate_star, tps, out_tokens, min_reps, cpr, same,
                  cur_reps, cur_cost, rank, chips, penalty};
    const Zero Z{z_choice, z_reps, z_chips, z_cost, z_value};
    const Buckets B{b_pid, b_q1, b_q2, n_pools, n_buckets};
    const Out O{o_choice, o_reps, o_chips, o_cost, o_value, o_demand, need_zero};
    const dim3 grid((S + THREADS - 1) / THREADS, rows < 65535 ? rows : 65535);
    const size_t smem = (o_demand != nullptr && n_buckets <= SMEM_BUCKETS)
                            ? sizeof(unsigned long long) * n_buckets : 0;
    plan_rows_kernel<<<grid, THREADS, smem, st>>>(rates, rows, S, L, Z, B, O);
    return static_cast<int>(cudaGetLastError());
}
