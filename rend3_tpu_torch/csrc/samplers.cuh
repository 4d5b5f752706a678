// The per-query arithmetic of K3 (PCF5) and K4 (weighted bilinear), shared
// by their kernels (pcf5.cu, bilinear.cu) and by D1 (deferred_shade.cu),
// which takes the same taps inside its per-pixel shading. One copy of each,
// so D1's taps equal the kernels' taps by construction.
//
// Numerics: separate IEEE multiplies and adds (_rn intrinsics, which nvcc
// never contracts) in the order of the plain versions (ops/samplers.py
// sample_grid_pcf5_plain, sample_grid_bilinear_plain); see pcf5.cu and
// bilinear.cu for what each order matches.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// K3's value at a query whose base texel (x, y) = floor(s - 0.5) lies inside
// the (hs, ws) image: the 12 texels around it compared GreaterEqual against
// r (a texel outside the image reads 0.0), the five bilinear taps of PCF5
// blended with (fx, fy) and scaled by 0.2.
__device__ __forceinline__ float pcf5_value(const float* __restrict__ img, int hs, int ws, int x, int y, float fx,
                                            float fy, float r)
{
    // c[dy + 1][dx + 1]: the GE compare of texel (x + dx, y + dy); the four
    // window corners are never read.
    float c[4][4];
#pragma unroll
    for (int dy = -1; dy <= 2; ++dy) {
#pragma unroll
        for (int dx = -1; dx <= 2; ++dx) {
            if ((dx == -1 || dx == 2) && (dy == -1 || dy == 2)) continue;
            const int xx = x + dx, yy = y + dy;
            const float v = (xx >= 0 && xx < ws && yy >= 0 && yy < hs) ? __ldg(img + (size_t)yy * ws + xx) : 0.0f;
            c[dy + 1][dx + 1] = (r >= v) ? 1.0f : 0.0f;
        }
    }
    const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
    auto tap = [&](int ox, int oy) {
        const float top = __fadd_rn(__fmul_rn(c[oy + 1][ox + 1], gx), __fmul_rn(c[oy + 1][ox + 2], fx));
        const float bot = __fadd_rn(__fmul_rn(c[oy + 2][ox + 1], gx), __fmul_rn(c[oy + 2][ox + 2], fx));
        return __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
    };
    float total = tap(0, 0);
    total = __fadd_rn(total, tap(0, 1));
    total = __fadd_rn(total, tap(0, -1));
    total = __fadd_rn(total, tap(1, 0));
    total = __fadd_rn(total, tap(-1, 0));
    return __fmul_rn(total, 0.2f);
}

// K3 at one query: 0 where it is invalid or its base texel lies outside the
// image (the caller substitutes 1.0).
__device__ __forceinline__ float pcf5_query(const float* __restrict__ img, int hs, int ws, int x, int y, float fx,
                                            float fy, float r, bool valid)
{
    if (!(valid && x >= 0 && x < ws && y >= 0 && y < hs)) return 0.0f;
    return pcf5_value(img, hs, ws, x, y, fx, fy, r);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// Round a finite f32 to the nearest bf16, ties to even, returned as f32.
__device__ __forceinline__ float round_bf16(float v)
{
    uint32_t u = __float_as_uint(v);
    u += 0x7FFFu + ((u >> 16) & 1u);
    return __uint_as_float(u & 0xFFFF0000u);
}

__device__ __forceinline__ void bf16_texel(const uint2* __restrict__ atlas, size_t at, float t[4])
{
    const uint2 p = __ldg(atlas + at);
    t[0] = bf16_lo(p.x);
    t[1] = bf16_hi(p.x);
    t[2] = bf16_lo(p.y);
    t[3] = bf16_hi(p.y);
}

// K4 at one query: v = wt * bilerp(atlas, y + fy, x + fx) for the 4
// interleaved channels of a bf16 (ah, aw, 4) atlas; 0 where the query is
// invalid or its 2x2 footprint leaves the atlas.
__device__ __forceinline__ void bilinear_query(const uint2* __restrict__ atlas, int ah, int aw, int x, int y,
                                               float fx, float fy, float w, bool valid, float v[4])
{
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = 0.0f;
    if (!(valid && x >= 0 && x + 1 < aw && y >= 0 && y + 1 < ah)) return;
    const float wy0 = round_bf16(__fmul_rn(w, __fsub_rn(1.0f, fy)));
    const float wy1 = round_bf16(__fmul_rn(w, fy));
    const float gx = __fsub_rn(1.0f, fx);
    const size_t row0 = (size_t)y * aw + x, row1 = row0 + aw;
    float t00[4], t01[4], t10[4], t11[4];
    bf16_texel(atlas, row0, t00);
    bf16_texel(atlas, row0 + 1, t01);
    bf16_texel(atlas, row1, t10);
    bf16_texel(atlas, row1 + 1, t11);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const float left = __fadd_rn(__fmul_rn(t00[c], wy0), __fmul_rn(t10[c], wy1));
        const float right = __fadd_rn(__fmul_rn(t01[c], wy0), __fmul_rn(t11[c], wy1));
        // + 0: the JAX kernel sums into a zeroed block, so -0 reads +0.
        v[c] = __fadd_rn(__fadd_rn(__fmul_rn(gx, left), __fmul_rn(fx, right)), 0.0f);
    }
}
