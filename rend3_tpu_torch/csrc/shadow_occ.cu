// K7 and K8 (map-free shadow occlusion) for Hopper.
//
// Replace: rend3_tpu/ops/shadow.py shadow_occlusion (K7, kernel
// shadow.py:221-267) and shadow_occlusion_lt (K8, kernel shadow.py:497-552).
//
// What they compute. For every screen pixel with light-space coordinates
// (sx, sy), the base texel centre bx = floor(sx - 0.5) + 0.5 (by alike),
// and at each of the 12 PCF offsets (dx, dy) the max over the pixel's
// 32x128 screen tile's caster list of z where all three edge values are
// strictly positive and z >= 0, else 0: the occluder depth a shadow map
// would hold at that texel, straight from the caster triangles. Output
// (12, H, W) f32. The two TPU kernels differ in their lists (K7: casters
// whose bbox meets the tile's padded footprint rect; K8: casters near the
// light cells the tile occupies; both built by ops/shadow.py as CSR) and in
// their expression order, which the template flag LT selects:
//
//   K7: p = (e + a*dx) + b*dy, z likewise (shadow.py:255-258), except the
//       depth plane's base at offsets with dx == 1 and dy != 1, which is
//       fma(zb, by, za*bx) + zc (what XLA:CPU compiles there);
//   K8: p = e + (a*dx + b*dy) (shadow.py:521-541);
//
// with e = fma(a, bx, b*by) + c at the base texel. The products by dx, dy
// are exact. Built with --fmad=false and explicit __fmaf_rn / __fmul_rn /
// __fadd_rn, as the plain versions (ops/shadow.py) evaluate them.
//
// Design. One thread per pixel with its 12 running maxima in registers; a
// CTA of 128 x 8 threads covers one 8-row quarter of a tile, so the four
// CTAs of a tile each stage the tile's list through shared memory (the 12
// plane coefficients and the bbox of STAGE casters at a time). Each warp
// (32 pixels of one row) skips a caster whose bbox misses the light-space
// footprint of the warp's hit pixels padded by (-2, +3): the taps of a
// pixel lie in (sx - 2, sx + 2], so no skipped caster can cover one. This
// is the CUDA form of K8's per-row cull bits and changes no value at a hit
// pixel; a warp with no hit pixel skips every caster (values at non-hit
// pixels are not defined, as on the TPU, where the lists decide them).
//
// What bounds it on the H100: the 12 x 4 bytes per pixel it writes (100 MB
// at 1088x1920) against the (pixel, nearby caster) evaluations, about 130
// f32 operations each; the lists make a tile evaluate every listed caster
// for every warp whose footprint it meets.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int CTA_ROWS = 8;                       // pixel rows per CTA
constexpr int CTAS_PER_TILE = TILE_H / CTA_ROWS;
constexpr int STAGE = 256;                        // casters staged per pass
constexpr int N_OFF = 12;
constexpr int SETUP_W = 16;
constexpr int COEF = 12;                          // a0..2, b0..2, c0..2, za, zb, zc
constexpr float BIG = 1e9f;

// PCF_OFFSETS (shadow.py:57-62).
__constant__ float DX[N_OFF] = {-1, -1, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2};
__constant__ float DY[N_OFF] = {0, 1, -1, 0, 1, 2, -1, 0, 1, 2, 0, 1};

__device__ __forceinline__ float plane(float a, float b, float c, float x, float y) {
    return __fadd_rn(__fmaf_rn(a, x, __fmul_rn(b, y)), c);
}

__device__ __forceinline__ float warp_min(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

template <bool LT>
__global__ void __launch_bounds__(TILE_W * CTA_ROWS) occ_kernel(
    const float* __restrict__ setup, const float4* __restrict__ bbox,
    const int* __restrict__ offs, const int* __restrict__ ids,
    const float* __restrict__ sx, const float* __restrict__ sy, const uint8_t* __restrict__ hit,
    float* __restrict__ out, int width, int height)
{
    __shared__ float s_coef[STAGE][COEF];
    __shared__ float4 s_bb[STAGE];
    const int n_cols = width / TILE_W;
    const int tile = blockIdx.x / CTAS_PER_TILE;
    const int quarter = blockIdx.x - tile * CTAS_PER_TILE;
    const int trow = tile / n_cols, tcol = tile - trow * n_cols;
    const int x = tcol * TILE_W + threadIdx.x;
    const int y = trow * TILE_H + quarter * CTA_ROWS + threadIdx.y;
    const size_t pix = (size_t)y * width + x;
    const float fx = sx[pix], fy = sy[pix];
    const bool h = hit[pix] != 0;
    const float bx = __fadd_rn(floorf(__fsub_rn(fx, 0.5f)), 0.5f);
    const float by = __fadd_rn(floorf(__fsub_rn(fy, 0.5f)), 0.5f);
    // The warp's hit footprint, padded as the lists are.
    const float wx0 = __fsub_rn(warp_min(h ? fx : BIG), 2.0f);
    const float wy0 = __fsub_rn(warp_min(h ? fy : BIG), 2.0f);
    const float wx1 = __fadd_rn(warp_max(h ? fx : -BIG), 3.0f);
    const float wy1 = __fadd_rn(warp_max(h ? fy : -BIG), 3.0f);
    const bool any = __any_sync(0xffffffffu, h);

    float occ[N_OFF];
#pragma unroll
    for (int o = 0; o < N_OFF; ++o) occ[o] = 0.0f;

    const int tid = threadIdx.y * TILE_W + threadIdx.x;
    const int nthreads = TILE_W * CTA_ROWS;
    const int beg = offs[tile], end = offs[tile + 1];
    for (int base = beg; base < end; base += STAGE) {
        const int n = min(STAGE, end - base);
        __syncthreads();
        for (int i = tid; i < n * COEF; i += nthreads) {
            const int j = i / COEF, k = i - j * COEF;
            s_coef[j][k] = setup[(size_t)ids[base + j] * SETUP_W + k];
        }
        for (int i = tid; i < n; i += nthreads) s_bb[i] = bbox[ids[base + i]];
        __syncthreads();
        if (!any) continue;
        for (int j = 0; j < n; ++j) {
            const float4 bb = s_bb[j];  // xmin, ymin, xmax, ymax
            if (!(bb.z > wx0 && bb.x < wx1 && bb.w > wy0 && bb.y < wy1)) continue;  // warp-uniform
            const float* c = s_coef[j];
            float e[4], a[4], b[4];
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                a[k] = c[k];
                b[k] = c[3 + k];
                e[k] = plane(c[k], c[3 + k], c[6 + k], bx, by);
            }
            a[3] = c[9];
            b[3] = c[10];
            e[3] = plane(c[9], c[10], c[11], bx, by);
            const float ez_swapped = __fadd_rn(__fmaf_rn(c[10], by, __fmul_rn(c[9], bx)), c[11]);
#pragma unroll
            for (int o = 0; o < N_OFF; ++o) {
                const float dx = DX[o], dy = DY[o];
                float p[4];
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    if (LT) {
                        p[k] = __fadd_rn(e[k], __fadd_rn(__fmul_rn(a[k], dx), __fmul_rn(b[k], dy)));
                    } else {
                        const float ek = (k == 3 && dx == 1.0f && dy != 1.0f) ? ez_swapped : e[k];
                        p[k] = __fadd_rn(__fadd_rn(ek, __fmul_rn(a[k], dx)), __fmul_rn(b[k], dy));
                    }
                }
                if (p[0] > 0.0f && p[1] > 0.0f && p[2] > 0.0f && p[3] >= 0.0f) occ[o] = fmaxf(occ[o], p[3]);
            }
        }
    }
    const size_t hw = (size_t)width * height;
#pragma unroll
    for (int o = 0; o < N_OFF; ++o) out[o * hw + pix] = occ[o];
}

}  // namespace

extern "C" {

// K7 (lt == 0) and K8 (lt != 0): out (12, height, width) f32. setup (V, 16)
// and bbox (V, 4) f32 of the casters in light pixel space; offs
// (n_tiles + 1) and ids int32: CSR caster lists per 32x128 screen tile;
// sx, sy (height, width) f32; hit (height, width) uint8 (torch.bool).
// width % 128 == 0, height % 32 == 0. Returns cudaGetLastError().
int k7_shadow_occ(const void* setup, const void* bbox, const void* offs, const void* ids,
                  const void* sx, const void* sy, const void* hit, void* out,
                  int width, int height, int lt, void* stream)
{
    const int n_ctas = (width / TILE_W) * (height / TILE_H) * CTAS_PER_TILE;
    if (n_ctas > 0) {
        const dim3 block(TILE_W, CTA_ROWS);
        if (lt)
            occ_kernel<true><<<n_ctas, block, 0, (cudaStream_t)stream>>>(
                (const float*)setup, (const float4*)bbox, (const int*)offs, (const int*)ids,
                (const float*)sx, (const float*)sy, (const uint8_t*)hit, (float*)out, width, height);
        else
            occ_kernel<false><<<n_ctas, block, 0, (cudaStream_t)stream>>>(
                (const float*)setup, (const float4*)bbox, (const int*)offs, (const int*)ids,
                (const float*)sx, (const float*)sy, (const uint8_t*)hit, (float*)out, width, height);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
