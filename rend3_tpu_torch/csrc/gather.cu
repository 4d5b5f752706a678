// K5: static-tap grid gather for Hopper (the Hi-Z occlusion test's reads).
//
// Replaces: rend3_tpu/ops/mxu_gather.py sample_grid (mxu_gather.py:279,
// pallas_call at :411), as hi_z.occlusion_test calls it with the four 2x2
// taps over the edge-padded mip atlas.
//
// What it computes. Per query i and static offset k: img[by + dy_k,
// bx + dx_k], written to out (n_off, q) f32. A query that is invalid or
// whose base texel lies outside img reads 0 at every tap, and a tap outside
// img reads 0 (the JAX zero padding). The values are copied, so kernel,
// plain version (ops/samplers.py sample_grid_plain) and the JAX kernel's
// one-hot f32 matmul agree bit for bit (-0 reads +0, as the JAX kernel's
// sum into a zeroed block gives).
//
// The JAX sampler drops the queries of a (screen tile, cell) pair past its
// pair cap (pair_cap=64 in hi_z.py:102-105), which reads 0 and so "not
// occluded"; there is no cap here, so every query reads its texels.
//
// What bounds it on the H100: memory latency. At 1080p the Hi-Z test has
// one query per candidate triangle (about 10^5), 13 bytes in and 16 out
// each: about 1 us of bytes, under what one launch in a CUDA graph takes
// (launch_floor below measures that). So the design cuts the dependent
// round trips a thread waits for to two: the kernel is instantiated per tap
// count (1..12) and fully unrolled, a thread loads its query's base texel
// and flag, then issues every tap's load before any store (each a
// predicated load, 0 where the tap is off), then stores the taps, each a
// coalesced row of out. One query a thread, 128-thread CTAs: 10^5 queries
// are about 800 CTAs, all resident at once on 132 SMs. The taps arrive by
// value as kernel parameters.
//
// launch_floor is an empty kernel: its time in a CUDA graph is the least a
// launch of a given grid takes, the floor under K5's byte bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_info.cuh"

namespace {

constexpr int kMaxTaps = 12;  // samplers.MAX_TAPS
constexpr int kThreads = 128;

struct Taps {
    int dx[kMaxTaps];
    int dy[kMaxTaps];
};

template <int N>
__global__ void __launch_bounds__(kThreads) gather_kernel(
    const float* __restrict__ img, const int* __restrict__ bx, const int* __restrict__ by,
    const bool* __restrict__ valid, float* __restrict__ out, int hs, int ws, int q, Taps taps)
{
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= q) return;
    const int x = __ldg(bx + i), y = __ldg(by + i);
    const bool own = valid[i] && x >= 0 && x < ws && y >= 0 && y < hs;
    float v[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
        const int xx = x + taps.dx[k], yy = y + taps.dy[k];
        v[k] = 0.0f;
        if (own && xx >= 0 && xx < ws && yy >= 0 && yy < hs) v[k] = __ldg(img + (size_t)yy * ws + xx);
    }
#pragma unroll
    for (int k = 0; k < N; ++k) out[(size_t)k * q + i] = __fadd_rn(v[k], 0.0f);
}

// The instance of gather_kernel for n taps, through f(instance).
template <typename F>
int by_taps(int n, F f)
{
    switch (n) {
        case 1: return f(gather_kernel<1>);
        case 2: return f(gather_kernel<2>);
        case 3: return f(gather_kernel<3>);
        case 4: return f(gather_kernel<4>);
        case 5: return f(gather_kernel<5>);
        case 6: return f(gather_kernel<6>);
        case 7: return f(gather_kernel<7>);
        case 8: return f(gather_kernel<8>);
        case 9: return f(gather_kernel<9>);
        case 10: return f(gather_kernel<10>);
        case 11: return f(gather_kernel<11>);
        case 12: return f(gather_kernel<12>);
        default: return (int)cudaErrorInvalidValue;
    }
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// K5: out (n_off, q) f32 over q queries; img (hs, ws) f32; bx, by int32;
// valid bool (1 byte); the n_off taps as (dx_k, dy_k) pairs in d[0..23]
// (pairs past n_off ignored). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for n_off outside 1..12).
int k5_gather(const void* img, const void* bx, const void* by, const void* valid, void* out,
              int hs, int ws, int q, int n_off,
              int d0, int d1, int d2, int d3, int d4, int d5, int d6, int d7, int d8, int d9, int d10, int d11,
              int d12, int d13, int d14, int d15, int d16, int d17, int d18, int d19, int d20, int d21, int d22,
              int d23, void* stream)
{
    const int d[2 * kMaxTaps] = {d0, d1, d2, d3, d4, d5, d6, d7, d8, d9, d10, d11,
                                 d12, d13, d14, d15, d16, d17, d18, d19, d20, d21, d22, d23};
    if (n_off < 1 || n_off > kMaxTaps) return (int)cudaErrorInvalidValue;
    Taps taps;
    for (int k = 0; k < kMaxTaps; ++k) {
        taps.dx[k] = d[2 * k];
        taps.dy[k] = d[2 * k + 1];
    }
    if (q <= 0) return (int)cudaGetLastError();
    return by_taps(n_off, [&](auto kernel) {
        kernel<<<(q + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
            (const float*)img, (const int*)bx, (const int*)by, (const bool*)valid, (float*)out, hs, ws, q, taps);
        return (int)cudaGetLastError();
    });
}

// Registers, spills, shared memory and resident CTAs per SM of the K5
// instance for n_off taps (kernel_info.cuh). info: 5 ints.
int k5_kernel_info(int n_off, void* info)
{
    return by_taps(n_off, [&](auto kernel) { return kernel_info(kernel, kThreads, 0, (int*)info); });
}

// An empty kernel over `blocks` CTAs of `threads` threads.
int launch_floor(int blocks, int threads, void* stream)
{
    empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

}  // extern "C"
