// Closed-form geometric queue tail of the birth-death chain, shared by the
// CUDA kernels of inferno_tpu_torch.ops (stats_kernel.cu today; the fused
// bisection kernels later), so the tail semantics cannot diverge between
// them. Same arithmetic, in the same order, as `_fold_tail` in
// inferno_tpu_torch/ops/queueing.py and its reference,
// inferno_tpu/ops/queueing.py::_fold_tail.
//
// The tail is p[N+j] = p[N] * q^j for j = 1..L, q = lam / mu(N), L = tail_len.
// Below saturation (q < 1) the sums anchor at p[N]; at or above it they
// anchor at the blocking state p[N+L], so nothing overflows. Near q = 1 the
// shared ratio r = exp(-|log q|), with |log q| clamped to >= 1e-6, keeps
// 1 - r cancellation-free through expm1f. Built without fast math: expf,
// expm1f and the clamp keep their f32 meaning.
#pragma once

#include <math.h>

// max with jnp.maximum / torch.maximum semantics: a NaN in either operand
// propagates (fmaxf would drop it)
__device__ __forceinline__ float nan_max(float a, float b) {
    return (a > b || a != a) ? a : b;
}

struct TailFold {
    float m;          // global log-normalisation shift M
    float z_tail;     // tail probability mass / exp(M)
    float jsum_tail;  // tail queue-length mass / exp(M)
    float p_block;    // blocking-state weight / exp(M)
};

__device__ __forceinline__ TailFold fold_tail(float m_head, float logp_n,
                                              float logq, float tail_len) {
    const bool neg = logq < 0.0f;  // below saturation: tail decays from p[N]
    const float alogq = nan_max(fabsf(logq), 1e-6f);
    const float logr = -alogq;
    const float r = expf(logr);
    const float r_l = expf(tail_len * logr);            // r^L
    const float r_lm1 = expf((tail_len - 1.0f) * logr);  // r^(L-1)
    const float one_m_r = -expm1f(logr);
    // partial geometric sums over i = 0..L-1: g0 = sum r^i, g1 = sum i r^i
    const float g0 = (1.0f - r_l) / one_m_r;
    const float g1 = r * (1.0f - tail_len * r_lm1 + (tail_len - 1.0f) * r_l) /
                     (one_m_r * one_m_r);

    // log-weight of the tail's largest term: p[N] for q < 1, p[N+L] for q >= 1
    const float tail_peak = logp_n + nan_max(tail_len * logq, 0.0f);
    TailFold t;
    t.m = nan_max(m_head, tail_len > 0.0f ? tail_peak : -INFINITY);
    const float a = expf(logp_n - t.m);                    // p[N] / exp(M)
    const float b = expf(logp_n + tail_len * logq - t.m);  // p[N+L] / exp(M)

    if (tail_len <= 0.0f) {
        // an empty tail (cap == max_batch) blocks at state N itself
        t.z_tail = 0.0f;
        t.jsum_tail = 0.0f;
        t.p_block = a;
    } else if (neg) {
        // q < 1 (r = q): sum q^j = g0 + r^L - 1, sum j q^j = g1 + L r^L
        t.z_tail = a * (g0 + r_l - 1.0f);
        t.jsum_tail = a * (g1 + tail_len * r_l);
        t.p_block = a * r_l;
    } else {
        // q >= 1 (r = 1/q), relative to the blocking state b:
        // sum q^(j-L) = g0, sum j q^(j-L) = L g0 - g1
        t.z_tail = b * g0;
        t.jsum_tail = b * (tail_len * g0 - g1);
        t.p_block = b;
    }
    return t;
}
