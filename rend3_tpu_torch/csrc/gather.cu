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
// What bounds it on the H100: memory latency, a few bytes per query; at
// 1080p the Hi-Z test has one query per candidate triangle (about 10^5).
// One thread per query with direct loads; the offsets arrive by value.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 12;  // samplers.MAX_TAPS

struct Taps {
    int n;
    int dx[kMaxTaps];
    int dy[kMaxTaps];
};

__global__ void __launch_bounds__(256) gather_kernel(
    const float* __restrict__ img, const int* __restrict__ bx, const int* __restrict__ by,
    const bool* __restrict__ valid, float* __restrict__ out, int hs, int ws, int q, Taps taps)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= q) return;
    const int x = bx[i], y = by[i];
    const bool own = valid[i] && x >= 0 && x < ws && y >= 0 && y < hs;
    for (int k = 0; k < taps.n; ++k) {
        const int xx = x + taps.dx[k], yy = y + taps.dy[k];
        float v = 0.0f;
        if (own && xx >= 0 && xx < ws && yy >= 0 && yy < hs) {
            v = __fadd_rn(__ldg(img + (size_t)yy * ws + xx), 0.0f);
        }
        out[(size_t)k * q + i] = v;
    }
}

}  // namespace

extern "C" {

// K5: out (n_off, q) f32 over q queries; img (hs, ws) f32; bx, by int32;
// valid bool (1 byte); offs points to HOST memory, n_off (dx, dy) int32
// pairs, copied into the launch's parameters. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for n_off outside 1..12).
int k5_gather(const void* img, const void* bx, const void* by, const void* valid, void* out,
              const void* offs, int hs, int ws, int q, int n_off, void* stream)
{
    if (n_off < 1 || n_off > kMaxTaps) return (int)cudaErrorInvalidValue;
    Taps taps;
    taps.n = n_off;
    const int* o = (const int*)offs;
    for (int k = 0; k < n_off; ++k) {
        taps.dx[k] = o[2 * k];
        taps.dy[k] = o[2 * k + 1];
    }
    if (q > 0) {
        gather_kernel<<<(q + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
            (const float*)img, (const int*)bx, (const int*)by, (const bool*)valid, (float*)out,
            hs, ws, q, taps);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
