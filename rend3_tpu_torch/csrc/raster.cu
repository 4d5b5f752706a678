// K1 (fused raster + G-buffer resolve), K2 (depth-only raster) and K6
// (visibility raster) for Hopper.
//
// Replace: rend3_tpu/ops/deferred.py raster_resolve_packed (K1, kernel
// deferred.py:555-721, in every mode, at any sample offset `sofs`),
// _depth_launch (K2, deferred.py:382-469) and rend3_tpu/ops/raster_pallas.py
// rasterize_binned (K6, kernel raster_pallas.py:77-113).
//
// What they compute. For each 32x128 pixel tile, walk the tile's triangle
// list (CSR, ascending setup-row id) and per pixel keep the covering
// triangle of greatest reverse-Z depth; on equal depth the later entry wins
// (deferred.py:621-629), which the update `z >= d` in list order gives
// without atomics. Coverage is the three top-left edge tests and the depth
// plane clipped to [0, 1] (deferred.py:601-610). K1's finalize evaluates the
// winner's 64-float plane row into the 25 G-buffer channels in the order of
// deferred.py:676-711, including the analytic uv derivatives; a pixel that
// no triangle covers gets the cleared (all-zero) channels. K2 keeps only
// the depth (0 where nothing covers).
//
// K1's peel modes (deferred.py:548-553, 611-618, 739-764, 780-790), for the
// cutout and blend depth peels. `bound` (H, W): a fragment also needs
// z < bound, a strict test, read once per pixel row into a register.
// `count_floor` (H, W): every covered fragment at z >= floor (z > floor
// when strict) is counted over the whole tile list, before the bound and
// whatever the depth test decides; the count stays in an int register and
// is written as f32 (H, W) at the end (exact below 2^24). The per-warp bbox
// skip stays valid for both: a skipped triangle covers no pixel of the
// warp, so it neither wins nor counts anywhere there.
//
// Numerics. Every plane a*px + b*py + c is fma(a, px, b*py) + c, written
// with explicit __fmaf_rn / __fmul_rn / __fadd_rn and built with
// --fmad=false, so the compiler contracts nothing else. That is the form
// the JAX kernels take under XLA:CPU, and it keeps the watertight edge
// scheme (geometry.py:226-239): negating (a, b, c) negates the result
// exactly. 1/x is the IEEE quotient (__fdiv_rn). The plain PyTorch
// versions (ops/deferred.py) evaluate the same expressions.
//
// What bounds it on the H100. Arithmetic per (pixel, listed triangle): the
// TPU kernel evaluates every pixel of a tile against every triangle of its
// list (in 8-row bands with a band mask). Here one CTA of 1024 threads owns
// a tile, each thread 4 pixels of one column with their depth and winner in
// registers; the list is staged through shared memory 128 setup rows at a
// time, and each warp skips a triangle whose bbox (grown by one pixel) misses
// the warp's 32x4 pixels, so the work follows the triangles' real extent.
// The finalize reads one 256-byte plane row per covered pixel from global
// memory (L2-resident for the frame's few hundred thousand rows) and writes
// 25 channels, coalesced along the tile's columns. A tile is one CTA, so
// the 510 tiles of a 1088x1920 target are about two waves of 264 resident
// CTAs; making it faster (binning in the kernel, coarse hierarchical tests,
// TMA staging) is later work. In the peel modes the cutout and blend sets
// are a few hundred triangles, so a launch is bound by the G-buffer write
// plus one read of the bound or floor image and one write of the counts;
// the extra per-row registers cost the 1024-thread CTA (64 registers a
// thread) a few bytes of spill.
//
// K6 is the same walk over 8x128 tiles (the visibility raster's binning),
// for 1 or 4 sample offsets at once: one staging of the list's setup rows
// serves every offset, each thread keeping the depth and winner of 4 pixel
// rows per offset in registers (a 256-thread CTA per tile, so up to 32
// pairs fit). It writes depth (S, H, W) f32 and the winner's S_ID (its
// clipped-table row) as id (S, H, W) int32, -1 where nothing covers; the
// S_ID is read from the winner's setup row once per covered pixel. Bound:
// the 8 bytes per pixel and sample it writes, and the per-(pixel, listed
// triangle, sample) tests; 2,040 CTAs for a 1088x1920 target.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int ROWS = 4;                    // pixel rows per thread
constexpr int GROUPS = TILE_H / ROWS;      // threadIdx.y extent
constexpr int SETUP_W = 16;
constexpr int PLANES_W = 64;
constexpr int GB_CH = 25;
constexpr int STAGE = 128;                 // setup rows staged per pass
constexpr int VTILE_H = 8;                 // K6's tile height
constexpr int VGROUPS = VTILE_H / ROWS;    // K6's threadIdx.y extent
constexpr int MAX_SAMPLES = 4;

// Setup row layout (geometry.py:28-35).
constexpr int S_EA = 0, S_EB = 3, S_EC = 6, S_ZA = 9, S_ZB = 10, S_ZC = 11;
constexpr int S_TL = 12, S_ID = 13, S_TL1 = 14, S_TL2 = 15;
// Plane row layout (deferred.py:52-62).
constexpr int P_DEN = 0, P_VP = 3, P_NRM = 12, P_TAN = 21, P_UV0 = 30, P_UV1 = 36, P_COL = 42, P_MAT = 54;

__device__ __forceinline__ float plane(float a, float b, float c, float px, float py) {
    return __fadd_rn(__fmaf_rn(a, px, __fmul_rn(b, py)), c);
}

struct Staged {
    float setup[STAGE][SETUP_W];
    float4 bbox[STAGE];
    int id[STAGE];
};

// Walk the tile's list; per sample offset s and pixel row r of this
// thread: greatest covered depth d[s][r] and (WINNER) the setup row
// win[s][r] that reached it last. With BOUND a fragment also needs
// z < bnd[r]; with COUNT, cnt[r] counts the covered fragments above flr[r]
// before the bound is applied (both with one offset only).
template <int NS, bool WINNER, bool BOUND, bool COUNT>
__device__ __forceinline__ void walk(
    const float* __restrict__ setup, const float4* __restrict__ bbox,
    const int* __restrict__ offs, const int* __restrict__ ids,
    int tile, const float (&px)[NS], const float (&py)[NS][ROWS], float wx0, float wy0,
    const float (&bnd)[ROWS], const float (&flr)[ROWS], bool strict,
    float (&d)[NS][ROWS], int (&win)[NS][ROWS], int (&cnt)[ROWS], Staged& sm)
{
    static_assert(NS == 1 || !(BOUND || COUNT), "peel modes take one sample offset");
    const int tid = threadIdx.y * TILE_W + threadIdx.x;
    const int nthreads = TILE_W * blockDim.y;
    const float wx1 = wx0 + 32.0f, wy1 = wy0 + float(ROWS);
    const int beg = offs[tile], end = offs[tile + 1];
    for (int base = beg; base < end; base += STAGE) {
        const int n = min(STAGE, end - base);
        __syncthreads();
        for (int i = tid; i < n * SETUP_W; i += nthreads) {
            const int j = i / SETUP_W, k = i - j * SETUP_W;
            sm.setup[j][k] = setup[(size_t)ids[base + j] * SETUP_W + k];
        }
        for (int i = tid; i < n; i += nthreads) {
            const int v = ids[base + i];
            sm.id[i] = v;
            sm.bbox[i] = bbox[v];
        }
        __syncthreads();
        for (int j = 0; j < n; ++j) {
            const float4 bb = sm.bbox[j];  // xmin, ymin, xmax, ymax
            // Warp-uniform skip: no pixel of the warp's 32x4 block lies in
            // the bbox grown by one pixel (so no pixel can be covered).
            if (bb.z + 1.0f < wx0 || bb.x - 1.0f > wx1 || bb.w + 1.0f < wy0 || bb.y - 1.0f > wy1) continue;
            const float* s = sm.setup[j];
#pragma unroll
            for (int si = 0; si < NS; ++si) {
#pragma unroll
                for (int r = 0; r < ROWS; ++r) {
                    const float x = px[si], y = py[si][r];
                    const float e0 = plane(s[S_EA + 0], s[S_EB + 0], s[S_EC + 0], x, y);
                    const float e1 = plane(s[S_EA + 1], s[S_EB + 1], s[S_EC + 1], x, y);
                    const float e2 = plane(s[S_EA + 2], s[S_EB + 2], s[S_EC + 2], x, y);
                    const bool c0 = (e0 > 0.0f) || ((e0 == 0.0f) && (s[S_TL] > 0.0f));
                    const bool c1 = (e1 > 0.0f) || ((e1 == 0.0f) && (s[S_TL1] > 0.0f));
                    const bool c2 = (e2 > 0.0f) || ((e2 == 0.0f) && (s[S_TL2] > 0.0f));
                    const float z = plane(s[S_ZA], s[S_ZB], s[S_ZC], x, y);
                    bool cov = c0 && c1 && c2 && (z >= 0.0f) && (z <= 1.0f);
                    if (COUNT && cov && (strict ? (z > flr[r]) : (z >= flr[r]))) ++cnt[r];
                    if (BOUND) cov = cov && (z < bnd[r]);
                    if (WINNER) {
                        if (cov && z >= d[si][r]) {
                            d[si][r] = z;
                            win[si][r] = sm.id[j];
                        }
                    } else if (cov) {
                        d[si][r] = fmaxf(d[si][r], z);
                    }
                }
            }
        }
    }
}

template <bool WINNER, bool BOUND, bool COUNT>
__global__ void __launch_bounds__(TILE_W * GROUPS) raster_kernel(
    const float* __restrict__ setup, const float4* __restrict__ bbox,
    const float* __restrict__ planes, const int* __restrict__ offs,
    const int* __restrict__ ids, float* __restrict__ out,
    const float* __restrict__ bound, const float* __restrict__ cfloor,
    float* __restrict__ counts, int strict,
    int width, int height, float sofs_x, float sofs_y)
{
    __shared__ Staged sm;
    const int n_cols = width / TILE_W;
    const int tile = blockIdx.x;
    const int trow = tile / n_cols, tcol = tile - trow * n_cols;
    const int x = tcol * TILE_W + threadIdx.x;
    const int y0 = trow * TILE_H + threadIdx.y * ROWS;
    const float px[1] = {__fadd_rn(float(x), sofs_x)};
    float py[1][ROWS], d[1][ROWS], bnd[ROWS], flr[ROWS];
    int win[1][ROWS], cnt[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const size_t pix = (size_t)(y0 + r) * width + x;
        py[0][r] = __fadd_rn(float(y0 + r), sofs_y);
        d[0][r] = 0.0f;
        win[0][r] = -1;
        bnd[r] = BOUND ? bound[pix] : 0.0f;
        flr[r] = COUNT ? cfloor[pix] : 0.0f;
        cnt[r] = 0;
    }
    const float wx0 = float(tcol * TILE_W + (threadIdx.x & ~31));
    walk<1, WINNER, BOUND, COUNT>(setup, bbox, offs, ids, tile, px, py, wx0, float(y0), bnd, flr, strict != 0,
                                  d, win, cnt, sm);

    const size_t hw = (size_t)width * height;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const size_t pix = (size_t)(y0 + r) * width + x;
        if (COUNT) counts[pix] = float(cnt[r]);
        if (!WINNER) {
            out[pix] = d[0][r];
            continue;
        }
        float* o = out + pix;
        if (win[0][r] < 0) {
            for (int c = 0; c < GB_CH; ++c) o[c * hw] = 0.0f;
            continue;
        }
        const float* p = planes + (size_t)win[0][r] * PLANES_W;
        const float pxr = px[0], pyr = py[0][r];
        auto pl = [&](int off) { return plane(p[off], p[off + 1], p[off + 2], pxr, pyr); };
        int c = 0;
        o[(c++) * hw] = d[0][r];
        const float dn = pl(P_DEN);
        o[(c++) * hw] = dn;
        for (int k = 0; k < 3; ++k) o[(c++) * hw] = pl(P_VP + 3 * k);
        for (int k = 0; k < 3; ++k) o[(c++) * hw] = pl(P_NRM + 3 * k);
        for (int k = 0; k < 3; ++k) o[(c++) * hw] = pl(P_TAN + 3 * k);
        for (int k = 0; k < 2; ++k) o[(c++) * hw] = pl(P_UV0 + 3 * k);
        for (int k = 0; k < 2; ++k) o[(c++) * hw] = pl(P_UV1 + 3 * k);
        for (int k = 0; k < 4; ++k) o[(c++) * hw] = pl(P_COL + 3 * k);
        o[(c++) * hw] = p[P_MAT];
        o[(c++) * hw] = 1.0f;
        // Analytic uv screen derivatives: du/dx = (a_u - u a_d) / Dn.
        const float invd = (fabsf(dn) < 1e-30f) ? 1.0f : __fdiv_rn(1.0f, dn);
        for (int axis = 0; axis < 2; ++axis) {
            for (int k = 0; k < 2; ++k) {
                const int off = P_UV0 + 3 * k;
                const float uvv = __fmul_rn(pl(off), invd);
                o[(c++) * hw] = __fmul_rn(__fmaf_rn(-uvv, p[P_DEN + axis], p[off + axis]), invd);
            }
        }
    }
}

template <bool WINNER, bool BOUND, bool COUNT>
int launch(const void* setup, const void* bbox, const void* planes, const void* offs, const void* ids,
           void* out, const void* bound, const void* cfloor, void* counts, int strict,
           int width, int height, float sofs_x, float sofs_y, void* stream)
{
    const int n_tiles = (width / TILE_W) * (height / TILE_H);
    if (n_tiles > 0) {
        raster_kernel<WINNER, BOUND, COUNT><<<n_tiles, dim3(TILE_W, GROUPS), 0, (cudaStream_t)stream>>>(
            (const float*)setup, (const float4*)bbox, (const float*)planes, (const int*)offs,
            (const int*)ids, (float*)out, (const float*)bound, (const float*)cfloor, (float*)counts,
            strict, width, height, sofs_x, sofs_y);
    }
    return (int)cudaGetLastError();
}

struct SampleOffsets {
    float x[MAX_SAMPLES], y[MAX_SAMPLES];
};

// K6: one CTA of 128 x VGROUPS threads per 8x128 tile, NS sample offsets.
template <int NS>
__global__ void __launch_bounds__(TILE_W * VGROUPS) vis_kernel(
    const float* __restrict__ setup, const float4* __restrict__ bbox,
    const int* __restrict__ offs, const int* __restrict__ ids,
    float* __restrict__ depth, int* __restrict__ tri, int width, int height, SampleOffsets so)
{
    __shared__ Staged sm;
    const int n_cols = width / TILE_W;
    const int tile = blockIdx.x;
    const int trow = tile / n_cols, tcol = tile - trow * n_cols;
    const int x = tcol * TILE_W + threadIdx.x;
    const int y0 = trow * VTILE_H + threadIdx.y * ROWS;
    float px[NS], py[NS][ROWS], d[NS][ROWS], bnd[ROWS] = {}, flr[ROWS] = {};
    int win[NS][ROWS], cnt[ROWS] = {};
#pragma unroll
    for (int si = 0; si < NS; ++si) {
        px[si] = __fadd_rn(float(x), so.x[si]);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            py[si][r] = __fadd_rn(float(y0 + r), so.y[si]);
            d[si][r] = 0.0f;
            win[si][r] = -1;
        }
    }
    const float wx0 = float(tcol * TILE_W + (threadIdx.x & ~31));
    walk<NS, true, false, false>(setup, bbox, offs, ids, tile, px, py, wx0, float(y0), bnd, flr, false,
                                 d, win, cnt, sm);
    const size_t hw = (size_t)width * height;
#pragma unroll
    for (int si = 0; si < NS; ++si) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            const size_t pix = si * hw + (size_t)(y0 + r) * width + x;
            depth[pix] = d[si][r];
            tri[pix] = win[si][r] < 0 ? -1 : int(setup[(size_t)win[si][r] * SETUP_W + S_ID]);
        }
    }
}

template <int NS>
int launch_vis(const void* setup, const void* bbox, const void* offs, const void* ids, void* depth, void* tri,
               int width, int height, const SampleOffsets& so, void* stream)
{
    const int n_tiles = (width / TILE_W) * (height / VTILE_H);
    if (n_tiles > 0) {
        vis_kernel<NS><<<n_tiles, dim3(TILE_W, VGROUPS), 0, (cudaStream_t)stream>>>(
            (const float*)setup, (const float4*)bbox, (const int*)offs, (const int*)ids,
            (float*)depth, (int*)tri, width, height, so);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1: out (25, height, width) f32. setup (V, 16), bbox (V, 4), planes
// (V, 64) f32; offs (n_tiles + 1) and ids (P) int32; width % 128 == 0,
// height % 32 == 0. Peel modes: an optional (height, width) f32 exclusive
// upper bound, and an optional (height, width) f32 count floor whose
// per-pixel counts go to `counts` (height, width) f32; a null pointer leaves
// a mode off. strict != 0 counts z > floor, else z >= floor. Returns
// cudaGetLastError() after the launch.
int k1_raster_resolve(const void* setup, const void* bbox, const void* planes,
                      const void* offs, const void* ids, void* out,
                      const void* bound, const void* cfloor, void* counts,
                      int width, int height, int strict, float sofs_x, float sofs_y, void* stream)
{
    if (bound && cfloor)
        return launch<true, true, true>(setup, bbox, planes, offs, ids, out, bound, cfloor, counts, strict,
                                        width, height, sofs_x, sofs_y, stream);
    if (bound)
        return launch<true, true, false>(setup, bbox, planes, offs, ids, out, bound, nullptr, nullptr, 0,
                                         width, height, sofs_x, sofs_y, stream);
    if (cfloor)
        return launch<true, false, true>(setup, bbox, planes, offs, ids, out, nullptr, cfloor, counts, strict,
                                         width, height, sofs_x, sofs_y, stream);
    return launch<true, false, false>(setup, bbox, planes, offs, ids, out, nullptr, nullptr, nullptr, 0,
                                      width, height, sofs_x, sofs_y, stream);
}

// K2: out (height, width) f32; inputs as K1 without the planes.
int k2_raster_depth(const void* setup, const void* bbox, const void* offs, const void* ids,
                    void* out, int width, int height, float sofs_x, float sofs_y, void* stream)
{
    return launch<false, false, false>(setup, bbox, nullptr, offs, ids, out, nullptr, nullptr, nullptr, 0,
                                       width, height, sofs_x, sofs_y, stream);
}

// K6: depth (nsamp, height, width) f32 and tri (nsamp, height, width)
// int32; inputs as K2 over 8x128 tiles (width % 128 == 0, height % 8 == 0);
// nsamp is 1 or 4 sample offsets (ox_i, oy_i), unused pairs ignored.
int k6_raster_vis(const void* setup, const void* bbox, const void* offs, const void* ids,
                  void* depth, void* tri, int width, int height, int nsamp,
                  float ox0, float oy0, float ox1, float oy1, float ox2, float oy2, float ox3, float oy3,
                  void* stream)
{
    const SampleOffsets so = {{ox0, ox1, ox2, ox3}, {oy0, oy1, oy2, oy3}};
    switch (nsamp) {
        case 1: return launch_vis<1>(setup, bbox, offs, ids, depth, tri, width, height, so, stream);
        case 4: return launch_vis<4>(setup, bbox, offs, ids, depth, tri, width, height, so, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* rend3_cuda_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
