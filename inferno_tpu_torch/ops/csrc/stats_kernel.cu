// Stationary statistics of the state-dependent birth-death chain, for every
// lane of a sizing bucket, on Hopper (sm_90a).
//
// Replaces the TPU kernel `_stats_kernel` of inferno_tpu/ops/pallas_queueing.py
// (launched by `_solve` through pl.pallas_call). Its plain torch version is
// `_solve_stats` in inferno_tpu_torch/ops/queueing.py; the Python wrapper is
// inferno_tpu_torch/ops/cuda_queueing.py::solve_stats.
//
// Per lane (one row of cml, K head states, k = 1..K):
//   body[k]  = k * log(lam) - cml[k]         (-inf beyond the lane's nmax)
//   m_head   = max(max_k body, 0)            (the k = 0 state has weight 0)
//   logp_N   = max over k == nmax of body    (the tail's anchor)
//   tail     = fold_tail(...)                (fold_tail.cuh)
//   Z        = exp(-M) + sum_k exp(body - M) + z_tail
//   in_serv  = (sum_k k * exp(body - M) + nmax * z_tail) / Z
//   tput     = lam * (1 - p_block / Z); serv = in_serv / tput;
//   wait     = (jsum_tail / Z) / tput
// Output out[4][P] = (wait, serv, in_servers, tput), row-major by statistic.
//
// What bounds it on this card: the bytes of cml, P * K * 4 per launch (the
// per-lane vectors and the output are 32 bytes a lane). The work is a few
// flops and one expf per element, far under the f32 rate, so the launch is
// memory-bound; at the sizing path's shapes (tens of thousands of lanes,
// K = 128 or 512) a whole bucket's cml is a few MB to ~15 MB and stays in the
// 50 MB L2 across the ~68 launches of one bucket, which makes L2 bandwidth and
// launch latency the real limits.
//
// Design (simple first; the fused bisection is later work): one warp per
// lane, WARPS_PER_BLOCK lanes per block, the ragged edge masked (no lane
// padding needed). Pass 1 strides over k with coalesced loads and reduces
// max(body) and the masked logp_N with warp shuffles -- the masked max rather
// than an index read, so that nmax at the grid edge means what it means in
// the reference. Every lane then evaluates fold_tail (warp-uniform, no
// broadcast needed). Pass 2 re-reads the row (from L2) and sums exp(body - M)
// and k * exp(body - M). Lane 0 writes the four statistics.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC (no fast math; --fmad=false keeps
// every multiply and add separately rounded, as in the plain torch version).

#include <cuda_runtime.h>
#include <math.h>

#include "fold_tail.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(FULL_MASK, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
    return v;
}

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
stats_kernel(const float* __restrict__ cml, const float* __restrict__ lam,
             const float* __restrict__ nmax, const float* __restrict__ log_mu_full,
             const float* __restrict__ tail_len, float* __restrict__ out, int P,
             int K) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
    if (row >= P) return;  // warp-uniform: the whole warp leaves together

    const float* crow = cml + static_cast<size_t>(row) * K;
    const float lam_r = lam[row];
    const float log_lam = logf(lam_r);
    const float n_r = nmax[row];

    // pass 1: head maximum and the log-weight of the full-batch state
    float bmax = -INFINITY;
    float bn = -INFINITY;
    for (int k = lane; k < K; k += 32) {
        const float kf = static_cast<float>(k + 1);
        const float body = kf * log_lam - crow[k];
        bmax = nan_max(bmax, body);
        bn = nan_max(bn, kf == n_r ? body : -INFINITY);
    }
    const float m_head = nan_max(warp_max(bmax), 0.0f);
    const float logp_n = warp_max(bn);
    const TailFold t = fold_tail(m_head, logp_n, log_lam - log_mu_full[row], tail_len[row]);

    // pass 2: normalised head mass and its k-weighted sum
    float se = 0.0f;
    float ske = 0.0f;
    for (int k = lane; k < K; k += 32) {
        const float kf = static_cast<float>(k + 1);
        const float e = expf(kf * log_lam - crow[k] - t.m);
        se += e;
        ske += kf * e;
    }
    se = warp_sum(se);
    ske = warp_sum(ske);

    if (lane == 0) {
        const float z = expf(-t.m) + se + t.z_tail;
        // every tail state holds exactly nmax in service; the queue length
        // comes directly from the tail sum
        const float in_servers = (ske + n_r * t.z_tail) / z;
        const float q_len = t.jsum_tail / z;
        const float p_block = t.p_block / z;
        const float tput = lam_r * (1.0f - p_block);
        out[row] = q_len / tput;                 // wait
        out[P + row] = in_servers / tput;        // serv
        out[2 * static_cast<size_t>(P) + row] = in_servers;
        out[3 * static_cast<size_t>(P) + row] = tput;
    }
}

}  // namespace

// Launch on `stream` (a cudaStream_t; 0 is the legacy default stream).
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int inferno_stats_launch(const float* cml, const float* lam,
                                    const float* nmax, const float* log_mu_full,
                                    const float* tail_len, float* out, int P, int K,
                                    void* stream) {
    const int blocks = (P + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    stats_kernel<<<blocks, WARPS_PER_BLOCK * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        cml, lam, nmax, log_mu_full, tail_len, out, P, K);
    return static_cast<int>(cudaGetLastError());
}

// The library links its own (static) CUDA runtime, whose current device is
// not torch's: the wrapper selects the tensors' device before each launch.
extern "C" int inferno_set_device(int device) {
    return static_cast<int>(cudaSetDevice(device));
}

extern "C" const char* inferno_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
