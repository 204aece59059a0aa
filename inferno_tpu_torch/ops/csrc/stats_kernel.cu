// Stationary statistics of the state-dependent birth-death chain, for every
// lane of a sizing bucket, on Hopper (sm_90a): one solve per launch.
//
// Replaces the TPU kernel `_stats_kernel` of inferno_tpu/ops/pallas_queueing.py
// (launched by `_solve` through pl.pallas_call). Its plain torch version is
// `_solve_stats` in inferno_tpu_torch/ops/queueing.py; the Python wrapper is
// inferno_tpu_torch/ops/cuda_queueing.py::solve_stats. The solve itself, and
// the thread mapping, are lane_solve.cuh's, shared with bisect_kernel.cu.
// Output out[4][P] = (wait, serv, in_servers, tput), row-major by statistic.
//
// What bounds it on this card: the bytes of cml, P * K * 4 per launch (the
// per-lane vectors and the output are 32 bytes a lane). The work is a few
// flops and one expf per element, far under the f32 rate. At the sizing
// path's shapes a bucket's cml is at most ~9 MB, so the bound is a few
// microseconds and launch latency weighs as much as the bytes.
//
// Design: each lane's row is read from memory once, as 16-byte loads, into
// the registers of a thread group sized by K (lane_solve.cuh); the two passes
// (the maximum, then the sums) run over registers. K is a template parameter
// for the bucket widths of the sizing path (128, 512, 2048); any other K runs
// the strided one-warp-a-lane body, which is still this kernel.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false (no fast math; --fmad=false keeps every multiply and add
// separately rounded, as in the plain torch version).

#include <cuda_runtime.h>

#include "lane_solve.cuh"

namespace {

using namespace inferno;

template <int K_FIXED>
__global__ void __launch_bounds__(BLOCK_THREADS)
stats_kernel(const float* __restrict__ cml, const float* __restrict__ lam,
             const float* __restrict__ nmax, const float* __restrict__ log_mu_full,
             const float* __restrict__ tail_len, float* __restrict__ out, int P, int K) {
    constexpr int T = threads_per_lane<K_FIXED>();
    __shared__ float scratch[2 * (BLOCK_THREADS / 32)];
    const LaneGroup<T> g(P);
    RowOf<K_FIXED> row;
    row.load(cml + static_cast<size_t>(g.row) * K, K, g.t, nmax[g.row]);
    const Stats s =
        lane_solve<T>(row, lam[g.row], log_mu_full[g.row], tail_len[g.row], scratch);
    if (g.active && g.t == 0) {
        out[g.row] = s.wait;
        out[P + g.row] = s.serv;
        out[2 * static_cast<size_t>(P) + g.row] = s.in_servers;
        out[3 * static_cast<size_t>(P) + g.row] = s.tput;
    }
}

template <int K_FIXED>
int launch(const float* cml, const float* lam, const float* nmax, const float* log_mu_full,
           const float* tail_len, float* out, int P, int K, cudaStream_t stream) {
    stats_kernel<K_FIXED><<<blocks_for<K_FIXED>(P), BLOCK_THREADS, 0, stream>>>(
        cml, lam, nmax, log_mu_full, tail_len, out, P, K);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (a cudaStream_t; 0 is the legacy default stream).
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int inferno_stats_launch(const float* cml, const float* lam,
                                    const float* nmax, const float* log_mu_full,
                                    const float* tail_len, float* out, int P, int K,
                                    void* stream) {
    const auto s = static_cast<cudaStream_t>(stream);
    switch (K) {
        case 128: return launch<128>(cml, lam, nmax, log_mu_full, tail_len, out, P, K, s);
        case 512: return launch<512>(cml, lam, nmax, log_mu_full, tail_len, out, P, K, s);
        case 2048: return launch<2048>(cml, lam, nmax, log_mu_full, tail_len, out, P, K, s);
        default: return launch<0>(cml, lam, nmax, log_mu_full, tail_len, out, P, K, s);
    }
}

// The library links its own (static) CUDA runtime, whose current device is
// not torch's: the wrapper selects the tensors' device before each launch.
extern "C" int inferno_set_device(int device) {
    return static_cast<int>(cudaSetDevice(device));
}

extern "C" const char* inferno_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
