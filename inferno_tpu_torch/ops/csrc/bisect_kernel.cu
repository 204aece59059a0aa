// The rate bisection of the sizing programs, for every lane of a bucket, in
// one launch on Hopper (sm_90a).
//
// Replaces, with stats_kernel.cu, the TPU kernel `_stats_kernel` of
// inferno_tpu/ops/pallas_queueing.py: on the TPU the bisection is one
// `lax.fori_loop` of a jitted program with the pallas_call in its body
// (inferno_tpu/ops/queueing.py `_bisect_increasing`); here the whole loop is
// this kernel. Its plain torch version is `_bisect_plain` in
// inferno_tpu_torch/ops/queueing.py (`_bisect_increasing` composed with the
// metric and one stationary solve a step), and `_bisect_speculative_plain`
// there is this kernel's schedule (rounds, paths, exits) in torch; the Python
// wrapper is inferno_tpu_torch/ops/cuda_queueing.py::bisect.
//
// Per lane: feasible = target >= y_lo * (1 - 1e-6); clamp_hi = target >= y_hi;
// then n_iters steps of
//   mid = 0.5 * (lo + hi); too_high = y(mid) > target;
//   lo = too_high ? lo : mid; hi = too_high ? mid : hi;
// and lam = feasible ? (clamp_hi ? lam_max : 0.5 * (lo + hi)) : lam_min.
// y is one of four metrics (enum Metric), each one or two stationary solves
// (lane_solve.cuh) followed by the concurrency inversion, in the plain
// version's op order:
//   AGG_TTFT  margin * wait + (in_tokens > 0 ? gamma + delta*in * conc : 0)
//   AGG_ITL   alpha + beta * conc
//   TAN_TTFT  prefill solve at mid / prefill_slices; margin * wait + gamma + slope * conc
//   TAN_ITL   prefill solve, then the decode solve at its throughput
//             * prefill_slices / decode_slices; alpha + beta * conc(serv / nd)
// The per-lane constants come in as rows of a [C, P] tensor, computed in torch
// by the plain version's own expressions (queueing.py `_agg_bisect_consts`,
// `_tandem_bisect_consts`); the row indices below must match them.
//
// What bounds it on this card. The work is operations: a step touches each
// element of the row (both rows for TAN_ITL) about 11 times, one expf each;
// the row is read once, into registers, and stays there for all the steps.
// But a lane's steps are sequential, and a step is one or two solves whose
// reductions are a chain of shuffles (barriers too at K = 2048), expf and
// IEEE divisions: about 1 us of latency on an H100. The buckets of the
// 10k-variant sizing pass split two ways (measured, PERF.md):
//   issue:   agg K = 128 (16,917 lanes) and agg K = 512 (2,249 lanes) fill
//            the SMs' issue slots; a deeper round only adds work there;
//   latency: agg K = 2048 and every tandem bucket (50-4,183 lanes, most of
//            the tandem lanes clamped or infeasible) wait on their slowest
//            lanes' serial steps, with issue slots to spare.
// Three things address that:
//
// 1. Speculative levels (the latency-bound buckets). A round runs DEPTH steps
//    at once: the lane's 2^DEPTH - 1 thread groups each evaluate one midpoint
//    of the binary tree those steps could visit, each from the round's
//    (lo, hi) by the sequential expression 0.5f * (lo + hi) down its path, so
//    every midpoint is bit for bit the one the sequential bisection would
//    compute there. The groups swap their too_high bits through shared
//    memory (one barrier), and every group walks the same path down the tree:
//    the (lo, hi) it lands on is the sequential one. A last round takes the
//    steps left (n_iters need not be a multiple of DEPTH). Where a lane's
//    groups exceed MAX_BLOCK threads (K = 2048 at DEPTH >= 3) the lane spans
//    a thread-block cluster, and the bits cross blocks through distributed
//    shared memory. The wrapper picks the largest DEPTH whose lanes still fit
//    on the card in one wave (cuda_queueing.choose_depth).
// 2. One wave for agg K = 128. The kernel solves the bucket's real lanes only;
//    the pad lanes (copies of lane 0, parallel/fleet.py `_pad_rows`) get lane
//    0's result. The blocks are small (Layout::THREADS) and the register
//    count is held under __launch_bounds__ so that an SM holds enough of them
//    for the real lanes to run in one wave.
// 3. An exact early exit (every bucket: fewer steps where lanes loop, none
//    where their result does not read the loop). A step that
//    leaves (lo, hi) unchanged in every bit is a fixed point: every later
//    step computes the same mid and the same decision. A lane whose result
//    does not read the loop (infeasible, or clamped at lam_max) has one from
//    the start. So a lane is done after a round whose last step left (lo, hi)
//    unchanged, and its result is the one n_iters steps would give. Shuffles
//    and barriers need every thread of their warp or block: a warp leaves
//    when all its lanes are done (DEPTH 1, T <= 32), otherwise the block does
//    (__syncthreads_and), and a cluster's blocks all decide alike.
//
// Build: as stats_kernel.cu (--fmad=false, no fast math), once per metric
// (-DINFERNO_BISECT_METRIC=0..3, one nvcc process each). The per-step scalar
// arithmetic is the plain version's op for op, so every schedule reproduces
// the per-step composition on stats_kernel bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lane_solve.cuh"

#ifndef INFERNO_BISECT_METRIC
#error "compile once per metric with -DINFERNO_BISECT_METRIC=0..3"
#endif

namespace {

namespace cg = cooperative_groups;
using namespace inferno;

enum Metric : int { AGG_TTFT = 0, AGG_ITL = 1, TAN_TTFT = 2, TAN_ITL = 3 };

// rows of the aggregated lanes' constants (queueing.py `_agg_bisect_consts`)
enum AggRow : int { A_BASE, A_SLOPE, A_NMAX, A_GAMMA, A_DIN, A_IN, A_ALPHA, A_BETA };
// rows of the tandem lanes' constants (queueing.py `_tandem_bisect_consts`)
enum TanRow : int { T_PS, T_DS, T_ND, T_GAMMA, T_SLOPE, T_ALPHA, T_BETA };

// 1 - 1e-6 as torch rounds the Python scalar: the double, rounded to f32
constexpr float FEASIBLE_SLACK = static_cast<float>(1.0 - 1e-6);

constexpr int MAX_DEPTH = 4;     // cuda_queueing.BISECT_MAX_DEPTH
constexpr int MAX_BLOCK = 512;   // a block's threads at most; a larger lane spans a cluster
// what a block of small lanes aims at: small blocks spread a bucket's
// lanes evenly over the SMs
constexpr int SMALL_BLOCK = 64;
// registers a thread of the one-row metrics may use at DEPTH 1: what lets
// an SM hold 18 blocks of 64 threads (144 lanes at K = 128), so that agg
// K = 128's 16,917 lanes fit on 132 SMs in one wave
constexpr int ONE_ROW_REGS = 56;
constexpr int SM_REGS = 65536;

constexpr int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// How the lanes of a <K_FIXED, DEPTH> instantiation map onto blocks
template <int K_FIXED, int DEPTH>
struct Layout {
    static constexpr int T = threads_per_lane<K_FIXED>();
    static constexpr int NODES = (1 << DEPTH) - 1;  // midpoints of a round: a group each
    static constexpr int UNIT = NODES * T;          // a lane's threads
    static constexpr int CLUSTER = (UNIT + MAX_BLOCK - 1) / MAX_BLOCK;  // blocks a lane spans
    // lanes a block holds come in multiples of ALIGN, so that a block is whole warps
    static constexpr int ALIGN = 32 / gcd(UNIT, 32);
    static constexpr int FIT = SMALL_BLOCK / UNIT / ALIGN * ALIGN;
    static constexpr int LANES = CLUSTER > 1 ? 1 : (FIT > ALIGN ? FIT : ALIGN);
    static constexpr int THREADS = CLUSTER > 1 ? MAX_BLOCK : LANES * UNIT;
    static constexpr int GROUPS = THREADS / T;  // groups a block holds
    static_assert(CLUSTER == 1 || MAX_BLOCK % T == 0, "a cluster's blocks hold whole groups");
    static_assert(THREADS % 32 == 0 && THREADS <= 1024, "blocks are whole warps");
};

// the blocks an SM must hold at once (__launch_bounds__): at DEPTH 1, for
// the one-row metrics, those of ONE_ROW_REGS registers a thread; deeper
// rounds and TAN_ITL's two rows are left what they need
template <int METRIC, int DEPTH, int THREADS>
struct MinBlocks {
    static constexpr int FIT = SM_REGS / (ONE_ROW_REGS * THREADS);
    static constexpr int VALUE = METRIC == TAN_ITL || DEPTH > 1 || FIT < 1 ? 1 : FIT;
};

struct Stage {
    const float* cml;
    const float* nmax;
    const float* log_mu_full;
    const float* tail_len;
};

struct BisectArgs {
    Stage gp;  // the lane's grid (the prefill stage's for tandem lanes)
    Stage gd;  // the decode stage's grid (TAN_ITL only)
    const float* consts;
    const float* lam_min;
    const float* lam_max;
    const float* target;
    const float* y_lo;
    const float* y_hi;
    float* lam_out;
    unsigned char* ok_out;
    int* steps_out;  // steps each lane ran, or null
    int P;           // lanes, pad lanes included
    int real;        // the lanes [0, real) are solved; [real, P) copy lane 0
    int K;
    int n_iters;
    float wait_margin;
    bool early_exit;
};

// min with torch.minimum semantics: a NaN in either operand propagates
__device__ __forceinline__ float nan_min(float a, float b) {
    return (a < b || a != a) ? a : b;
}

// _stage_concurrency: invert t(n) = base + slope * n to the concurrency
// giving `serv`, clipped to [0, nmax]
__device__ __forceinline__ float stage_concurrency(float serv, float base, float slope,
                                                   float nmax) {
    const float numer = serv - base;
    const float safe = nan_min(nan_max(numer / (slope > 0.0f ? slope : 1.0f), 0.0f), nmax);
    return slope > 0.0f ? safe : (numer > 0.0f ? nmax : 0.0f);
}

__device__ __forceinline__ bool same_bits(float a, float b) {
    return __float_as_uint(a) == __float_as_uint(b);
}

template <int METRIC, int K_FIXED, int DEPTH>
__global__ void __launch_bounds__(Layout<K_FIXED, DEPTH>::THREADS,
                                  MinBlocks<METRIC, DEPTH, Layout<K_FIXED, DEPTH>::THREADS>::VALUE)
    bisect_kernel(const BisectArgs a) {
    using L = Layout<K_FIXED, DEPTH>;
    constexpr int T = L::T;
    constexpr bool TANDEM = METRIC == TAN_TTFT || METRIC == TAN_ITL;
    // a warp leaves the loop on its own only where nothing in it waits on
    // other warps: no exchange (DEPTH 1) and no barrier in the reductions
    constexpr bool WARP_EXIT = DEPTH == 1 && T <= 32;
    __shared__ float scratch[2 * (L::THREADS / 32)];
    // too_high of every node of the lane's tree (a cluster's whole tree in
    // each of its blocks), by round parity
    __shared__ unsigned char bits[2][L::CLUSTER * L::GROUPS];
    // what the result needs besides (lo, hi), a thread's own, parked over
    // the loop so that no register holds it there (volatile: read back)
    volatile __shared__ float park_lam[L::THREADS];
    volatile __shared__ unsigned char park_ok[L::THREADS];

    // this thread's lane, its group's node in the round's tree (heap order
    // from 0; nodes past the tree's last level compute and are never read),
    // and its rank in the group
    const int tid = threadIdx.x;
    const int t = tid % T;
    const int group = tid / T;  // in the block
    int lane, node;
    int first;  // where the bit of node 0 of this lane sits in `bits`
    if constexpr (L::NODES == 1) {
        lane = blockIdx.x * L::LANES + group;
        node = 0;
        first = group;
    } else if constexpr (L::CLUSTER == 1) {
        lane = blockIdx.x * L::LANES + tid / L::UNIT;
        node = (tid % L::UNIT) / T;
        first = (tid / L::UNIT) * L::NODES;
    } else {
        lane = blockIdx.x / L::CLUSTER;
        node = (blockIdx.x % L::CLUSTER) * L::GROUPS + group;
        first = 0;
    }
    // a group past the last real lane solves that lane again and writes nothing
    const int r = lane < a.real ? lane : a.real - 1;
    auto cst = [&](int i) { return a.consts[static_cast<size_t>(i) * a.P + r]; };

    // the rows, read once and held for every step
    RowOf<K_FIXED> rp;
    rp.load(a.gp.cml + static_cast<size_t>(r) * a.K, a.K, t, a.gp.nmax[r]);
    const float p_lmf = a.gp.log_mu_full[r];
    const float p_tail = a.gp.tail_len[r];
    RowOf<K_FIXED> rd;
    float d_lmf = 0.0f;
    float d_tail = 0.0f;
    if constexpr (METRIC == TAN_ITL) {
        rd.load(a.gd.cml + static_cast<size_t>(r) * a.K, a.K, t, a.gd.nmax[r]);
        d_lmf = a.gd.log_mu_full[r];
        d_tail = a.gd.tail_len[r];
    }

    // the metric's constants, in registers for the whole loop
    float c0, c1, c2, c3, c4;
    if constexpr (METRIC == AGG_TTFT) {
        c0 = cst(A_GAMMA);
        c1 = cst(A_DIN);
        c2 = cst(A_IN);
        c3 = 0.0f;
        c4 = 0.0f;
    } else if constexpr (METRIC == AGG_ITL) {
        c0 = cst(A_ALPHA);
        c1 = cst(A_BETA);
        c2 = c3 = c4 = 0.0f;
    } else if constexpr (METRIC == TAN_TTFT) {
        c0 = cst(T_PS);
        c1 = cst(T_GAMMA);
        c2 = cst(T_SLOPE);
        c3 = c4 = 0.0f;
    } else {
        c0 = cst(T_PS);
        c1 = cst(T_DS);
        c2 = cst(T_ND);
        c3 = cst(T_ALPHA);
        c4 = cst(T_BETA);
    }
    const float base = TANDEM ? 0.0f : cst(A_BASE);
    const float slope = TANDEM ? 0.0f : cst(A_SLOPE);
    const float nmax_b = TANDEM ? 0.0f : cst(A_NMAX);
    const float margin = a.wait_margin;

    auto y_at = [&](float lam) -> float {
        if constexpr (!TANDEM) {
            const Stats s = lane_solve<T>(rp, lam, p_lmf, p_tail, scratch);
            const float conc = stage_concurrency(s.serv, base, slope, nmax_b);
            if constexpr (METRIC == AGG_TTFT) {
                const float prefill = c2 > 0.0f ? c0 + c1 * conc : 0.0f;
                return margin * s.wait + prefill;
            } else {
                return c0 + c1 * conc;
            }
        } else {
            const Stats sp = lane_solve<T>(rp, lam / c0, p_lmf, p_tail, scratch);
            if constexpr (METRIC == TAN_TTFT) {
                const float pconc = stage_concurrency(sp.serv, c1, c2, rp.nmax);
                return margin * sp.wait + c1 + c2 * pconc;
            } else {
                // the decode stage sees the prefill stage's departures
                const float through_unit = sp.tput * c0;
                const Stats sd =
                    lane_solve<T>(rd, through_unit / c1, d_lmf, d_tail, scratch);
                const float dconc = stage_concurrency(sd.serv / c2, c3, c4, rd.nmax);
                return c3 + c4 * dconc;
            }
        }
    };

    const float target = a.target[r];
    const bool feasible = target >= a.y_lo[r] * FEASIBLE_SLACK;
    const bool clamp_hi = target >= a.y_hi[r];
    float lo = a.lam_min[r];
    float hi = a.lam_max[r];
    // the result of a lane that does not read the loop (infeasible: lam_min;
    // clamped: lam_max), chosen now so that only one value outlives the loop
    const bool from_loop = feasible && !clamp_hi;
    park_lam[tid] = feasible ? hi : lo;
    park_ok[tid] = (feasible ? 1 : 0) | (from_loop ? 2 : 0);
    bool done = !from_loop;
    int steps = 0;
    int parity = 0;
#pragma unroll 1
    while (steps < a.n_iters) {
        if (a.early_exit) {
            const bool all_done = WARP_EXIT ? __all_sync(FULL_MASK, done) != 0
                                            : __syncthreads_and(done) != 0;
            if (all_done) break;
        }
        const int depth = a.n_iters - steps < DEPTH ? a.n_iters - steps : DEPTH;
        // this group's midpoint: down the tree from (lo, hi) along the path
        // of node + 1 (its bits below the leading one, the first step first;
        // 0 = too high, the left half)
        const int h = node + 1;
        float x_lo = lo;
        float x_hi = hi;
#pragma unroll 1
        for (int i = 30 - __clz(h); i >= 0; --i) {
            const float mid = 0.5f * (x_lo + x_hi);
            if ((h >> i) & 1) {
                x_lo = mid;
            } else {
                x_hi = mid;
            }
        }
        const bool too_high = y_at(0.5f * (x_lo + x_hi)) > target;

        // the path the decisions pick, from the root: the sequential steps;
        // `still`: the last of them left (lo, hi) as it was (the bound it
        // moved already held mid)
        bool still;
        if constexpr (DEPTH == 1) {
            const float mid = 0.5f * (lo + hi);
            still = same_bits(mid, too_high ? hi : lo);
            lo = too_high ? lo : mid;
            hi = too_high ? mid : hi;
        } else {
            if constexpr (L::CLUSTER == 1) {
                if (t == 0) bits[parity][group] = too_high ? 1 : 0;
                __syncthreads();
            } else {
                // pushed into every block of the cluster, so that the walk
                // below reads its own shared memory
                cg::cluster_group cluster = cg::this_cluster();
                if (t == 0) {
                    for (int b = 0; b < L::CLUSTER; ++b) {
                        *cluster.map_shared_rank(&bits[parity][node], b) = too_high ? 1 : 0;
                    }
                }
                cluster.sync();
            }
            int n = 0;
#pragma unroll 1
            for (int level = 0; level < depth; ++level) {
                const bool th = bits[parity][first + n] != 0;
                const float mid = 0.5f * (lo + hi);
                still = same_bits(mid, th ? hi : lo);
                lo = th ? lo : mid;
                hi = th ? mid : hi;
                n = 2 * n + (th ? 1 : 2);
            }
            parity ^= 1;
        }
        steps += depth;
        done = done || still;
    }
    if constexpr (L::CLUSTER > 1) {
        // no block of the cluster leaves while another may read its bits
        cg::this_cluster().sync();
    }

    const int parked = park_ok[tid];
    const unsigned char ok = parked & 1;
    const float lam = parked & 2 ? 0.5f * (lo + hi) : park_lam[tid];
    if (lane < a.real && node == 0 && t == 0) {
        a.lam_out[r] = lam;
        a.ok_out[r] = ok;
        if (a.steps_out != nullptr) a.steps_out[r] = steps;
    }
    if (lane == 0) {
        // the pad lanes repeat lane 0's inputs: they take its result, written
        // by every thread of lane 0
        const int rank = L::CLUSTER == 1 ? tid : (blockIdx.x * L::THREADS + tid);
        constexpr int STRIDE = L::CLUSTER == 1 ? L::UNIT : L::CLUSTER * L::THREADS;
        for (int i = a.real + rank; i < a.P; i += STRIDE) {
            a.lam_out[i] = lam;
            a.ok_out[i] = ok;
            if (a.steps_out != nullptr) a.steps_out[i] = steps;
        }
    }
}

template <int K_FIXED, int DEPTH>
struct Shape {
    static constexpr int K = K_FIXED;
    static constexpr int D = DEPTH;
};

// Call f(Shape<K_FIXED, DEPTH>{}) for the instantiation of (K, depth);
// cudaErrorInvalidValue for a depth outside 1..MAX_DEPTH
static_assert(MAX_DEPTH == 4, "with_depth instantiates depths 1..4");
template <int K_FIXED, class F>
int with_depth(int depth, F&& f) {
    switch (depth) {
        case 1: return f(Shape<K_FIXED, 1>{});
        case 2: return f(Shape<K_FIXED, 2>{});
        case 3: return f(Shape<K_FIXED, 3>{});
        case 4: return f(Shape<K_FIXED, 4>{});
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

template <class F>
int with_shape(int K, int depth, F&& f) {
    switch (K) {
        case 128: return with_depth<128>(depth, f);
        case 512: return with_depth<512>(depth, f);
        case 2048: return with_depth<2048>(depth, f);
        default: return with_depth<0>(depth, f);
    }
}

template <int K_FIXED, int DEPTH>
cudaLaunchConfig_t launch_config(int real, cudaStream_t stream, cudaLaunchAttribute* attr) {
    using L = Layout<K_FIXED, DEPTH>;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(L::CLUSTER == 1 ? (real + L::LANES - 1) / L::LANES : real * L::CLUSTER);
    cfg.blockDim = dim3(L::THREADS);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = L::CLUSTER;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = L::CLUSTER > 1 ? 1 : 0;
    return cfg;
}

constexpr int METRIC = INFERNO_BISECT_METRIC;

}  // namespace

#define INFERNO_CAT2(a, b) a##b
#define INFERNO_CAT(a, b) INFERNO_CAT2(a, b)

// Launch the bisection of metric INFERNO_BISECT_METRIC (this object's) on
// `stream` (a cudaStream_t) at `depth` steps a round. The decode-stage
// pointers are read by TAN_ITL only; `steps_out` may be null. Returns
// cudaGetLastError() after the launch (0 when it was accepted), or
// cudaErrorInvalidValue for a depth outside 1..MAX_DEPTH.
extern "C" int INFERNO_CAT(inferno_bisect_launch_, INFERNO_BISECT_METRIC)(
    const float* cml_p, const float* nmax_p, const float* log_mu_full_p,
    const float* tail_len_p, const float* cml_d, const float* nmax_d,
    const float* log_mu_full_d, const float* tail_len_d, const float* consts,
    const float* lam_min, const float* lam_max, const float* target, const float* y_lo,
    const float* y_hi, float* lam_out, unsigned char* ok_out, int* steps_out, int P, int real,
    int K, int n_iters, float wait_margin, int depth, int early_exit, void* stream) {
    const BisectArgs a{
        Stage{cml_p, nmax_p, log_mu_full_p, tail_len_p},
        Stage{cml_d, nmax_d, log_mu_full_d, tail_len_d},
        consts, lam_min, lam_max, target, y_lo, y_hi, lam_out, ok_out, steps_out,
        P, real, K, n_iters, wait_margin, early_exit != 0,
    };
    const auto s = static_cast<cudaStream_t>(stream);
    return with_shape(K, depth, [&](auto shape) {
        using S = decltype(shape);
        cudaLaunchAttribute attr;
        const cudaLaunchConfig_t cfg = launch_config<S::K, S::D>(real, s, &attr);
        const cudaError_t rc = cudaLaunchKernelEx(&cfg, bisect_kernel<METRIC, S::K, S::D>, a);
        const cudaError_t last = cudaGetLastError();  // read, and cleared, either way
        return static_cast<int>(rc != cudaSuccess ? rc : last);
    });
}

// The launch shape of (K, depth) for this object's metric on the current
// device: out[0] a block's threads, out[1] the lanes a block holds (1 where
// a lane spans a cluster), out[2] the blocks a lane spans (1: no cluster),
// out[3] the blocks an SM holds at once, out[4] the clusters the card holds
// at once (0 without a cluster), out[5] registers a thread, out[6] local
// memory bytes a thread (spills). Returns a cudaError_t, 0 on success.
extern "C" int INFERNO_CAT(inferno_bisect_shape_, INFERNO_BISECT_METRIC)(int K, int depth,
                                                                        int* out) {
    return with_shape(K, depth, [&](auto shape) {
        using S = decltype(shape);
        using L = Layout<S::K, S::D>;
        const auto kernel = bisect_kernel<METRIC, S::K, S::D>;
        cudaFuncAttributes attrs;
        cudaError_t rc = cudaFuncGetAttributes(&attrs, kernel);
        if (rc != cudaSuccess) return static_cast<int>(rc);
        int per_sm = 0;
        rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, L::THREADS, 0);
        if (rc != cudaSuccess) return static_cast<int>(rc);
        int clusters = 0;
        if (L::CLUSTER > 1) {
            cudaLaunchAttribute attr;
            const cudaLaunchConfig_t cfg = launch_config<S::K, S::D>(1, nullptr, &attr);
            rc = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
            if (rc != cudaSuccess) return static_cast<int>(rc);
        }
        out[0] = L::THREADS;
        out[1] = L::LANES;
        out[2] = L::CLUSTER;
        out[3] = per_sm;
        out[4] = clusters;
        out[5] = attrs.numRegs;
        out[6] = static_cast<int>(attrs.localSizeBytes);
        return 0;
    });
}
