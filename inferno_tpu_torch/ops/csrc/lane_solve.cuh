// The stationary solve of one lane of a sizing bucket, as device functions
// shared by the CUDA kernels of inferno_tpu_torch.ops: stats_kernel.cu (one
// solve per launch) and bisect_kernel.cu (a whole bisection per launch). Both
// kernels run this code on the same thread mapping, so the fused bisection
// reproduces the per-step composition on stats_kernel bit for bit.
//
// Per lane (one row of cml, K head states, k = 1..K):
//   body[k]  = k * log(lam) - cml[k]         (-inf beyond the lane's nmax)
//   m_head   = max(max_k body, 0)            (the k = 0 state has weight 0)
//   logp_N   = max over k == nmax of body    (the tail's anchor: body[nmax])
//   tail     = fold_tail(...)                (fold_tail.cuh)
//   Z        = exp(-M) + sum_k exp(body - M) + z_tail
//   in_serv  = (sum_k k * exp(body - M) + nmax * z_tail) / Z
//   tput     = lam * (1 - p_block / Z); serv = in_serv / tput;
//   wait     = (jsum_tail / Z) / tput
// The arithmetic is that of `_solve_stats` in inferno_tpu_torch/ops/queueing.py,
// op for op; only the order of the two sums differs. Built with --fmad=false
// and no fast math, so every multiply and add rounds as in the plain version.
//
// Thread mapping. A lane belongs to a group of T threads. At the bucket widths
// the sizing path produces (K = 128, 512, 2048) T = K / 16: each thread holds
// 16 elements of the row in registers, read once as four 16-byte loads
// (RegRow), and both passes run over registers. A warp holds four lanes at
// K = 128 and one at 512; at 2048 a lane spans four warps. Any other K takes
// the strided body: one warp a lane, the row read from memory on each pass
// (StridedRow). The maximum and the sums reduce over the group with warp
// shuffles and, for T > 32, a shared-memory step across the group's warps. A
// block of BLOCK_THREADS threads holds BLOCK_THREADS / T lanes; a group past
// the last lane solves the last lane again and writes nothing, so every thread
// of a block reaches every shuffle, vote and barrier.
//
// What the passes leave out, exactly: logp_N is cml[nmax] read once, not a
// masked max; and a register block whose values are all +inf across the warp
// (states beyond every nmax of the warp's lanes) is skipped while log(lam) is
// below +inf, since its terms are then -inf in the max and exact zeros in the
// sums. Lanes sorted by max batch within a bucket (parallel/fleet.py) make
// such blocks common.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "fold_tail.cuh"

namespace inferno {

constexpr int BLOCK_THREADS = 256;
constexpr unsigned FULL_MASK = 0xffffffffu;

// max with torch.amax's NaN propagation in one instruction (sm_80 and up):
// NaN when either operand is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
    float d;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
    return d;
}

struct MaxOp {
    __device__ __forceinline__ float operator()(float a, float b) const {
        return max_nan(a, b);
    }
};

struct SumOp {
    __device__ __forceinline__ float operator()(float a, float b) const { return a + b; }
};

// Threads a lane of a kernel instantiated at K_FIXED (0: any K, strided body)
template <int K_FIXED>
__host__ __device__ constexpr int threads_per_lane() {
    return K_FIXED ? K_FIXED / 16 : 32;
}

// Reduce N (1 or 2) values over the T threads of a lane group; every thread
// of the group ends with the same values (the xor butterfly combines each
// pair in both orders, and IEEE addition commutes). `scratch` holds two
// floats per warp of the block.
template <int T, int N, class Op>
__device__ __forceinline__ void group_reduce(float (&v)[N], float* scratch, Op op) {
    constexpr int WIDTH = T < 32 ? T : 32;
#pragma unroll
    for (int o = WIDTH / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int n = 0; n < N; ++n) v[n] = op(v[n], __shfl_xor_sync(FULL_MASK, v[n], o));
    }
    if constexpr (T > 32) {
        constexpr int WARPS = T / 32;
        const int warp = threadIdx.x >> 5;
        if ((threadIdx.x & 31) == 0) {
#pragma unroll
            for (int n = 0; n < N; ++n) scratch[2 * warp + n] = v[n];
        }
        __syncthreads();
        const float* g = scratch + 2 * (warp - warp % WARPS);
#pragma unroll
        for (int n = 0; n < N; ++n) {
            float x = g[n];
#pragma unroll
            for (int w = 1; w < WARPS; ++w) x = op(x, g[2 * w + n]);
            v[n] = x;
        }
        __syncthreads();  // scratch is free for the next reduction
    }
}

// The tail's anchor: cml at state nmax, read once. The plain version takes
// logp_N as the max of body over k == nmax, which is body[nmax] when nmax is
// a state of the grid (an integer in 1..K) and -inf otherwise.
struct Anchor {
    float nmax;
    float c_n;
    bool has_n;

    __device__ __forceinline__ void set(const float* crow, int K, float nmax_) {
        nmax = nmax_;
        has_n = nmax >= 1.0f && nmax <= static_cast<float>(K) && nmax == floorf(nmax);
        c_n = has_n ? __ldg(crow + static_cast<int>(nmax) - 1) : 0.0f;
    }

    __device__ __forceinline__ float logp_n(float log_lam) const {
        return has_n ? nmax * log_lam - c_n : -INFINITY;
    }
};

// A lane's row in registers: thread t of the group holds the float4s
// j * T + t (j = 0..3) of the row, so neighbouring threads read neighbouring
// 16 bytes, and the j-th float4s of a warp cover one run of 4 * T (or 128)
// states. The row must be 16-byte aligned (K a multiple of 4).
template <int T>
struct RegRow : Anchor {
    float4 c[4];
    float kb;       // state index (1-based) of c[0].x, as a float
    unsigned live;  // bit j: a thread of this warp holds a value below +inf in c[j]

    __device__ __forceinline__ void load(const float* crow, int K, int t, float nmax_) {
        set(crow, K, nmax_);
        kb = static_cast<float>(4 * t + 1);
        live = 0;
        const float4* r4 = reinterpret_cast<const float4*>(crow);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            c[j] = __ldg(r4 + j * T + t);
            const bool dead = c[j].x == INFINITY && c[j].y == INFINITY &&
                              c[j].z == INFINITY && c[j].w == INFINITY;
            live |= static_cast<unsigned>(__any_sync(FULL_MASK, !dead)) << j;
        }
    }

    // f(k as float, cml[k]) over this thread's elements, k 1-based; with
    // `skip_dead`, the float4s that hold only +inf across the warp are left
    // out (the indices are small integers, so every k is exact)
    template <class F>
    __device__ __forceinline__ void visit(bool skip_dead, F&& f) const {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (skip_dead && !((live >> j) & 1u)) continue;
            const float k = kb + static_cast<float>(4 * j * T);
            f(k, c[j].x);
            f(k + 1.0f, c[j].y);
            f(k + 2.0f, c[j].z);
            f(k + 3.0f, c[j].w);
        }
    }
};

// A lane's row left in memory, one warp a lane, read on every pass
struct StridedRow : Anchor {
    const float* crow;
    int K;
    int t;

    __device__ __forceinline__ void load(const float* crow_, int K_, int t_, float nmax_) {
        set(crow_, K_, nmax_);
        crow = crow_;
        K = K_;
        t = t_;
    }

    template <class F>
    __device__ __forceinline__ void visit(bool /*skip_dead*/, F&& f) const {
        for (int k = t; k < K; k += 32) f(static_cast<float>(k + 1), __ldg(crow + k));
    }
};

template <int K_FIXED>
using RowOf = std::conditional_t<K_FIXED != 0, RegRow<K_FIXED / 16>, StridedRow>;

// Which lane this thread works on, and its rank in the lane's group
template <int T>
struct LaneGroup {
    int row;
    int t;
    bool active;

    __device__ __forceinline__ explicit LaneGroup(int P) {
        const int r = blockIdx.x * (BLOCK_THREADS / T) + static_cast<int>(threadIdx.x) / T;
        t = threadIdx.x % T;
        active = r < P;
        row = active ? r : P - 1;
    }
};

template <int K_FIXED>
__host__ __device__ constexpr int blocks_for(int P) {
    return (P + BLOCK_THREADS / threads_per_lane<K_FIXED>() - 1) /
           (BLOCK_THREADS / threads_per_lane<K_FIXED>());
}

struct Stats {
    float wait;
    float serv;
    float in_servers;
    float tput;
};

// Stationary statistics of one lane at arrival rate lam (req/msec), for a
// row loaded with the lane's nmax. Every thread of the group calls it with
// the same scalars and gets the same result.
template <int T, class Row>
__device__ __forceinline__ Stats lane_solve(const Row& row, float lam, float log_mu_full,
                                            float tail_len, float* scratch) {
    const float log_lam = logf(lam);
    // beyond nmax cml is +inf: while log(lam) < +inf (not +inf, not NaN) those
    // states' body is -inf and their weight an exact 0, so the blocks that
    // hold nothing else change neither the maximum nor the sums
    const bool skip_dead = __all_sync(FULL_MASK, log_lam < INFINITY);

    // pass 1: the head maximum
    float mx[1] = {-INFINITY};
    row.visit(skip_dead, [&](float kf, float c) { mx[0] = max_nan(mx[0], kf * log_lam - c); });
    group_reduce<T>(mx, scratch, MaxOp{});
    const TailFold tf = fold_tail(nan_max(mx[0], 0.0f), row.logp_n(log_lam),
                                  log_lam - log_mu_full, tail_len);

    // pass 2: normalised head mass and its k-weighted sum (when tf.m is NaN
    // every statistic is NaN whatever the sums hold)
    float s[2] = {0.0f, 0.0f};
    row.visit(skip_dead, [&](float kf, float c) {
        const float e = expf(kf * log_lam - c - tf.m);
        s[0] += e;
        s[1] += kf * e;
    });
    group_reduce<T>(s, scratch, SumOp{});

    const float z = expf(-tf.m) + s[0] + tf.z_tail;
    // every tail state holds exactly nmax in service; the queue length comes
    // directly from the tail sum
    const float in_servers = (s[1] + row.nmax * tf.z_tail) / z;
    const float q_len = tf.jsum_tail / z;
    const float p_block = tf.p_block / z;
    const float tput = lam * (1.0f - p_block);
    return Stats{q_len / tput, in_servers / tput, in_servers, tput};
}

}  // namespace inferno
