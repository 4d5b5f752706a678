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
// Row bands (parallel/tiles.py). K1 and K2 take `row0`, the target row of
// the output's row 0: a pixel's row is row0 + its local row, added as
// integers before the float conversion (deferred.py:573, :402), and the
// warp block's rows that the bbox and edge rejects read are the target's
// too, so a band's pixels are the whole frame's bit for bit. The output,
// bound, floor and count images are the band's (local rows); the setup
// rows and bboxes are in target coordinates. The shadow maps take row0 = 0.
//
// Numerics. Every plane a*px + b*py + c is fma(a, px, b*py) + c, written
// with explicit __fmaf_rn / __fmul_rn / __fadd_rn and built with
// --fmad=false, so the compiler contracts nothing else. That is the form
// the JAX kernels take under XLA:CPU, and it keeps the watertight edge
// scheme (geometry.py:226-239): negating (a, b, c) negates the result
// exactly. 1/x is the IEEE quotient (__fdiv_rn). The plain PyTorch
// versions (ops/deferred.py) evaluate the same expressions.
//
// What bounds K1 and K2 on the H100, and the design. K1 writes 25 f32
// channels per pixel (209 MB at 1088x1920, 0.062 ms at 3.35 TB/s): it is
// bound by that write where its lists are short (the peel modes), and by
// its tests where they are long: one per (pixel of a warp block, listed
// triangle whose bbox meets the block), about 130 instructions a warp for
// 128 pixels. K2 writes 4 bytes per texel (16.8 MB for a 2048^2 map, 5 us)
// and is bound by the same tests. One kernel, tiles_kernel, serves both:
//   - a CTA of 256 threads owns one 32x32 quarter of a tile per work item,
//     each warp a 32x4 block (one column and 4 rows a thread, depth and
//     winner in registers); __launch_bounds__ holds K1 to 64 registers a
//     thread (4 resident CTAs an SM) and K2 to 48 (5 an SM; at 6 an SM, 40
//     registers, it spilled and ran 3% slower), without spills, so one
//     CTA's finalize stores overlap the others' walks (a 1024-thread CTA a
//     whole tile would fill an SM alone);
//   - the list is staged through shared memory 128 entries at a time (the
//     setup row and bbox of each, gathered by id with 16-byte cp.async, in
//     80-byte rows so that 32 lanes reading 32 rows hit distinct banks) into
//     two buffers, so chunk k+1 loads while chunk k is tested; the id of
//     each thread's entry is loaded a chunk ahead;
//   - each warp tests 32 staged entries at once, a lane each: the bbox
//     grown by one pixel, then the three edges at the block's corners
//     (edge_rejects, conservative by a rounding margin); it walks the set
//     bits of the ballot in ascending order (__ffs): list order, so the
//     later-entry tie-break needs no atomics;
//   - the top-left rule is one compare an edge (e > t, below), cheaper
//     than the two-compare form (e > 0, or e == 0 on a top-left edge); K2
//     also skips the rows of a block that the entry's bbox misses (K1's
//     larger triangles run faster without);
//   - one CTA a work item, the grid in item order; the hardware hands the
//     next item to whichever SM frees a slot first, which balances the
//     tiles. K1's items are the quarters of the tiles, in tile order, in
//     every mode: one scheduler. (Persistent CTAs that took the tiles with
//     lists over 256 entries first ran opaque K1 about 6% faster on the
//     flat city and 10% on the feature city; in tile order they were no
//     faster than this grid, PERF.md §6: the gain was the order's.) An
//     empty list reads neither the bound nor the floor image, so the peel
//     modes' near-empty lists leave the G-buffer write alone;
//   - K2's items are the quarters of segments of at most 128 list entries,
//     so a long list spreads over many CTAs: a one-CTA kernel (plan_kernel,
//     tile_lists.cuh) writes each segment's tile and first entry to global
//     memory first.
//     The grid counts the most segments there can be (n_tiles + entries /
//     128); the CTAs past the plan's count return at once. A tile with one
//     segment stores its depths; the segments of a longer list combine with
//     atomicMax on the int bits of their maxima (non-negative floats order
//     as their bits) into the output, zeroed first (an empty tile has no
//     segment and keeps the zeros). A max has no order, so the atomics
//     change no result. -0.0: `z >= 0` admits a fragment at -0.0, as the
//     plain version's test does, but K2 raises a depth only on z > d from
//     d = +0.0, so -0.0 never replaces +0.0 and no negative bits reach
//     atomicMax; the plain version's max may keep -0.0 there, which equals
//     +0.0 (torch.equal);
//   - the finalize stores each channel as 32 consecutive floats a warp
//     (128 bytes, coalesced along x) with streaming stores (__stcs).
// raster_kernel_info reports each instance's registers, spills, shared
// memory and resident CTAs per SM (cudaOccupancyMaxActiveBlocksPer-
// Multiprocessor), which chip_smoke.py prints beside ptxas -v.
//
// K6 (the visibility raster) walks its 8x128 tile lists with the same
// device function, for 1 or 4 sample offsets at once: a 256-thread CTA a
// tile, each warp a 32x4 block (4 across, 2 down), each thread one column
// and 4 rows, with the depth and winner of every (sample, row) in
// registers (16 + 16 at 4 samples). One staging of an entry serves every
// offset; the ballot's edge test runs at the corner samples of the block
// over all offsets, so it rejects an entry only where it covers no sample.
// At 4 samples it also takes K2's per-(sample, row) bbox skip and runs 3
// CTAs an SM (80 registers); at 1 sample neither paid (PERF.md §6).
// It writes depth (S, H, W) f32 and the winner's S_ID (its clipped-table
// row, read from the setup row once per covered sample) as id (S, H, W)
// int32, -1 where nothing covers. What bounds it on the H100: the
// per-(sample, pixel, listed triangle) tests, as K1's, times the samples
// (so the ballot cull, which drops an entry for all samples at once, and
// the one-compare top-left test pay most at 4 samples); the 8 bytes a
// sample it writes are 66 MB at 1088x1920 and 4 samples (0.020 ms at
// 3.35 TB/s).

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_info.cuh"
#include "tile_lists.cuh"

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
using tile_lists::CHUNK;
using tile_lists::Chunk;
using tile_lists::NT;                      // 256 threads a CTA, 8 warps
using tile_lists::ROW4;
using tile_lists::SETUP_W;

constexpr int ROWS = 4;                    // pixel rows per thread
constexpr int PLANES_W = 64;
constexpr int GB_CH = 25;
constexpr int MAX_SAMPLES = 4;

// K1 / K2 (tiles_kernel).
constexpr int QW = 32;                     // quarter-tile width: a warp's columns
constexpr int QUARTERS = TILE_W / QW;      // work items per tile (per segment)
constexpr int SEG = CHUNK;                 // K2: list entries a work item walks
constexpr int K1_MIN_CTAS = 4;             // resident CTAs an SM: 64 registers a thread
constexpr int K2_MIN_CTAS = 5;             // 48 registers a thread
static_assert(TILE_H / ROWS == NT / 32, "a K1 / K2 CTA is one warp a 32x4 block of a 32x32 quarter");

// K6 (vis_kernel).
constexpr int VTILE_H = 8;                 // K6's tile height: a CTA, 4 x 2 warp blocks
constexpr int K6_MIN_CTAS_1 = 4;           // resident CTAs an SM at 1 sample
constexpr int K6_MIN_CTAS_4 = 3;           // at 4 samples (16 depths and 16 winners a thread)
static_assert(QUARTERS * (VTILE_H / ROWS) == NT / 32, "a K6 CTA is one warp a 32x4 block of an 8x128 tile");

// Setup row layout (geometry.py:28-35).
constexpr int S_EA = 0, S_EB = 3, S_EC = 6, S_ZA = 9, S_ZB = 10, S_ZC = 11;
constexpr int S_TL = 12, S_ID = 13, S_TL1 = 14, S_TL2 = 15;
// Plane row layout (deferred.py:52-62).
constexpr int P_DEN = 0, P_VP = 3, P_NRM = 12, P_TAN = 21, P_UV0 = 30, P_UV1 = 36, P_COL = 42, P_MAT = 54;

__device__ __forceinline__ float plane(float a, float b, float c, float px, float py) {
    return __fadd_rn(__fmaf_rn(a, px, __fmul_rn(b, py)), c);
}

// Whether the bbox (xmin, ymin, xmax, ymax), grown by one pixel, meets the
// block [wx0, wx0 + 32] x [wy0, wy0 + ROWS]: a triangle that misses it
// covers no sample of the block.
__device__ __forceinline__ bool meets(float4 bb, float wx0, float wy0) {
    return !(bb.z + 1.0f < wx0 || bb.x - 1.0f > wx0 + 32.0f || bb.w + 1.0f < wy0 || bb.y - 1.0f > wy0 + float(ROWS));
}

// Whether edge (a, b, c) is negative at every sample of a block whose
// samples span [x0, x1] x [y0, y1] (corner samples, exact floats), so that
// plane() rejects every sample there. The edge's largest value over the
// block is at the corner its signs pick; the margin covers the rounding of
// plane() at that corner and at any other sample (each within
// 2^-22 (|a| X + |b| Y + |c|) of the exact value, X and Y the largest
// |coordinates|), twice over, so no sample that plane() finds >= 0 is
// rejected. A NaN coefficient rejects nothing.
__device__ __forceinline__ bool edge_rejects(float a, float b, float c, float x0, float x1, float y0, float y1) {
    const float e = plane(a, b, c, a > 0.0f ? x1 : x0, b > 0.0f ? y1 : y0);
    const float size = fabsf(a) * fmaxf(fabsf(x0), fabsf(x1)) + fabsf(b) * fmaxf(fabsf(y0), fabsf(y1)) + fabsf(c);
    return e < -(size * 0x1p-20f + 1e-37f);
}

// ---------------------------------------------------------------------------
// K1 and K2: the quarter-tile walk
// ---------------------------------------------------------------------------

struct Params {
    const float* setup;
    const float4* bbox;
    const float* planes;
    const int* offs;
    const int* ids;
    float* out;       // K1's G-buffer, K2's depth, K6's depth
    int* tri;         // K6's ids
    const float* bound;
    const float* cfloor;
    float* counts;
    const int* plan;  // K2's segments (tile_lists::plan_kernel)
    int width, height, n_tiles, strict;
    int row0;         // K1 / K2: the target row of the output's row 0 (a row band's first row)
    float ox[MAX_SAMPLES], oy[MAX_SAMPLES];  // sample offsets (K1 and K2 take the first)
};

// Walk list entries [beg, end) for this thread's pixel column at NS sample
// offsets, sample positions px[s] and py[s][r] of rows r: per (sample, row)
// the greatest covered depth d and (WINNER) the setup row win that reached
// it last; with BOUND a fragment also needs z < bnd[r]; with COUNT, cnt[r]
// counts the covered fragments above flr[r] before the bound (the peel
// modes take one sample). ROWSKIP skips the (sample, row)s outside the
// entry's bbox grown by one pixel. wx0, wy0: the warp's 32 x ROWS block.
// Every thread of the CTA calls it with the same range.
template <bool WINNER, bool BOUND, bool COUNT, bool ROWSKIP, int NS>
__device__ __forceinline__ void walk_chunks(
    const Params& p, int beg, int end, const float (&px)[NS], const float (&py)[NS][ROWS], float wx0, float wy0,
    const float (&bnd)[ROWS], const float (&flr)[ROWS], float (&d)[NS][ROWS], int (&win)[NS][ROWS],
    int (&cnt)[ROWS], Chunk* sm)
{
    static_assert(NS == 1 || !(BOUND || COUNT), "the peel modes take one sample");
    const int lane = threadIdx.x & 31;
    const bool strict = p.strict != 0;
    // The block's corner samples (lanes 0 and 31, rows 0 and ROWS - 1, at
    // the smallest and largest offsets): every sample lies between them.
    float ox0 = p.ox[0], ox1 = p.ox[0], oy0 = p.oy[0], oy1 = p.oy[0];
#pragma unroll
    for (int s = 1; s < NS; ++s) {
        ox0 = fminf(ox0, p.ox[s]);
        ox1 = fmaxf(ox1, p.ox[s]);
        oy0 = fminf(oy0, p.oy[s]);
        oy1 = fmaxf(oy1, p.oy[s]);
    }
    const float cx0 = __fadd_rn(wx0, ox0), cx1 = __fadd_rn(wx0 + float(QW - 1), ox1);
    const float cy0 = __fadd_rn(wy0, oy0), cy1 = __fadd_rn(wy0 + float(ROWS - 1), oy1);
    tile_lists::walk_staged(p.ids, p.setup, p.bbox, beg, end, sm, [&](const Chunk& c, int n) {
        for (int g = 0; g < n; g += 32) {
            // Lane l tests entry g + l against the warp's block: its bbox,
            // grown by one pixel, then its three edges at the block's corners.
            bool hit = false;
            if (g + lane < n) {
                const float4* r = c.row[g + lane];
                hit = meets(r[ROW4 - 1], wx0, wy0);
                if (hit) {
                    const float4 s0 = r[0], s1 = r[1], s2 = r[2];  // ea0-2 eb0 | eb1 eb2 ec0 ec1 | ec2 ...
                    hit = !(edge_rejects(s0.x, s0.w, s1.z, cx0, cx1, cy0, cy1)
                            || edge_rejects(s0.y, s1.x, s1.w, cx0, cx1, cy0, cy1)
                            || edge_rejects(s0.z, s1.y, s2.x, cx0, cx1, cy0, cy1));
                }
            }
            unsigned m = __ballot_sync(0xffffffffu, hit);
            while (m) {
                const int j = g + __ffs(m) - 1;
                m &= m - 1;
                float s[SETUP_W];
#pragma unroll
                for (int i = 0; i < SETUP_W / 4; ++i) {
                    const float4 v = c.row[j][i];
                    s[4 * i] = v.x;
                    s[4 * i + 1] = v.y;
                    s[4 * i + 2] = v.z;
                    s[4 * i + 3] = v.w;
                }
                const int id = WINNER ? c.id[j] : 0;
                // The top-left rule as one compare an edge: e > 0, or e >= 0
                // on a top-left edge, is e > t with t = -2^-149 (no float
                // lies between it and -0) or t = 0.
                const float t0 = s[S_TL] > 0.0f ? -0x1p-149f : 0.0f;
                const float t1 = s[S_TL1] > 0.0f ? -0x1p-149f : 0.0f;
                const float t2 = s[S_TL2] > 0.0f ? -0x1p-149f : 0.0f;
                const float4 bb = c.row[j][ROW4 - 1];
#pragma unroll
                for (int si = 0; si < NS; ++si) {
#pragma unroll
                    for (int r = 0; r < ROWS; ++r) {
                        const float y = py[si][r];
                        if (ROWSKIP && (y < bb.y - 1.0f || y > bb.w + 1.0f)) continue;
                        const float x = px[si];
                        const float z = plane(s[S_ZA], s[S_ZB], s[S_ZC], x, y);
                        bool cov = plane(s[S_EA + 0], s[S_EB + 0], s[S_EC + 0], x, y) > t0
                                   && plane(s[S_EA + 1], s[S_EB + 1], s[S_EC + 1], x, y) > t1
                                   && plane(s[S_EA + 2], s[S_EB + 2], s[S_EC + 2], x, y) > t2
                                   && (z >= 0.0f) && (z <= 1.0f);
                        if (COUNT && cov && (strict ? (z > flr[r]) : (z >= flr[r]))) ++cnt[r];
                        if (BOUND) cov = cov && (z < bnd[r]);
                        if (WINNER) {
                            if (cov && z >= d[si][r]) {
                                d[si][r] = z;
                                win[si][r] = id;
                            }
                        } else if (cov && z > d[si][r]) {
                            d[si][r] = z;
                        }
                    }
                }
            }
        }
    });
}

// K1's finalize at one pixel: the winner's plane row evaluated into the 25
// channels (deferred.py:676-711), or zeros where nothing covers.
__device__ __forceinline__ void resolve_pixel(const Params& p, size_t pix, size_t hw, float z, int win, float x,
                                              float y) {
    float* o = p.out + pix;
    if (win < 0) {
#pragma unroll
        for (int c = 0; c < GB_CH; ++c) __stcs(o + c * hw, 0.0f);
        return;
    }
    const float* w = p.planes + (size_t)win * PLANES_W;
    auto pl = [&](int off) { return plane(__ldg(w + off), __ldg(w + off + 1), __ldg(w + off + 2), x, y); };
    int c = 0;
    __stcs(o + (c++) * hw, z);
    const float dn = pl(P_DEN);
    __stcs(o + (c++) * hw, dn);
#pragma unroll
    for (int k = 0; k < 3; ++k) __stcs(o + (c++) * hw, pl(P_VP + 3 * k));
#pragma unroll
    for (int k = 0; k < 3; ++k) __stcs(o + (c++) * hw, pl(P_NRM + 3 * k));
#pragma unroll
    for (int k = 0; k < 3; ++k) __stcs(o + (c++) * hw, pl(P_TAN + 3 * k));
#pragma unroll
    for (int k = 0; k < 2; ++k) __stcs(o + (c++) * hw, pl(P_UV0 + 3 * k));
#pragma unroll
    for (int k = 0; k < 2; ++k) __stcs(o + (c++) * hw, pl(P_UV1 + 3 * k));
#pragma unroll
    for (int k = 0; k < 4; ++k) __stcs(o + (c++) * hw, pl(P_COL + 3 * k));
    __stcs(o + (c++) * hw, __ldg(w + P_MAT));
    __stcs(o + (c++) * hw, 1.0f);
    // Analytic uv screen derivatives: du/dx = (a_u - u a_d) / Dn.
    const float invd = (fabsf(dn) < 1e-30f) ? 1.0f : __fdiv_rn(1.0f, dn);
#pragma unroll
    for (int axis = 0; axis < 2; ++axis) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            const int off = P_UV0 + 3 * k;
            const float uvv = __fmul_rn(pl(off), invd);
            __stcs(o + (c++) * hw, __fmul_rn(__fmaf_rn(-uvv, __ldg(w + P_DEN + axis), __ldg(w + off + axis)), invd));
        }
    }
}

// WINNER: K1 (G-buffer, peel modes by BOUND / COUNT); else K2 (depth).
// Block b walks quarter b % QUARTERS of K1's tile b / QUARTERS, or of K2's
// segment b / QUARTERS.
template <bool WINNER, bool BOUND, bool COUNT>
__global__ void __launch_bounds__(NT, WINNER ? K1_MIN_CTAS : K2_MIN_CTAS) tiles_kernel(const Params p)
{
    __shared__ Chunk sm[2];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int q = blockIdx.x % QUARTERS, item = blockIdx.x / QUARTERS;
    int tile, beg, end;
    bool shared_tile = false;
    if (WINNER) {
        tile = item;
        beg = p.offs[tile];
        end = p.offs[tile + 1];
    } else {
        if (item >= p.plan[0]) return;  // past the last segment: the whole CTA
        tile = p.plan[1 + 2 * item];
        beg = p.plan[2 + 2 * item];
        const int tile_end = p.offs[tile + 1];
        end = min(tile_end, beg + SEG);
        shared_tile = tile_end - p.offs[tile] > SEG;
    }
    const int n_cols = p.width / TILE_W;
    const int trow = tile / n_cols, tcol = tile - trow * n_cols;
    const int x0 = tcol * TILE_W + q * QW;
    const int y0 = trow * TILE_H + warp * ROWS;  // the output's row
    // The target's row: a band's first row added as an integer before any
    // float math, so a band's pixels are the whole frame's bit for bit.
    const int ya = p.row0 + y0;
    const int x = x0 + lane;
    const float px[1] = {__fadd_rn(float(x), p.ox[0])};
    float py[1][ROWS], d[1][ROWS], bnd[ROWS], flr[ROWS];
    int win[1][ROWS], cnt[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const size_t pix = (size_t)(y0 + r) * p.width + x;
        py[0][r] = __fadd_rn(float(ya + r), p.oy[0]);
        d[0][r] = 0.0f;
        win[0][r] = -1;
        // An empty list reads neither image: its pixels win nothing and count nothing.
        bnd[r] = BOUND && beg < end ? p.bound[pix] : 0.0f;
        flr[r] = COUNT && beg < end ? p.cfloor[pix] : 0.0f;
        cnt[r] = 0;
    }
    walk_chunks<WINNER, BOUND, COUNT, !WINNER, 1>(p, beg, end, px, py, float(x0), float(ya), bnd, flr, d, win, cnt,
                                                  sm);
    const size_t hw = (size_t)p.width * p.height;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const size_t pix = (size_t)(y0 + r) * p.width + x;
        if (WINNER) {
            if (COUNT) __stcs(p.counts + pix, float(cnt[r]));
            resolve_pixel(p, pix, hw, d[0][r], win[0][r], px[0], py[0][r]);
        } else if (!shared_tile) {
            __stcs(p.out + pix, d[0][r]);
        } else if (d[0][r] > 0.0f) {
            atomicMax(reinterpret_cast<int*>(p.out) + pix, __float_as_int(d[0][r]));
        }
    }
}

// One CTA a quarter of n_items items; a grid of more than INT_MAX CTAs is
// refused as the runtime refuses it.
template <bool WINNER, bool BOUND, bool COUNT>
int launch_tiles(const Params& p, size_t n_items, cudaStream_t s)
{
    const size_t n_ctas = QUARTERS * n_items;
    if (n_ctas > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    if (n_ctas > 0) tiles_kernel<WINNER, BOUND, COUNT><<<(unsigned)n_ctas, NT, 0, s>>>(p);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K6: the same walk over 8x128 tiles, at NS sample offsets
// ---------------------------------------------------------------------------

// One CTA a tile, warps 4 across and 2 down.
template <int NS>
__global__ void __launch_bounds__(NT, NS == 1 ? K6_MIN_CTAS_1 : K6_MIN_CTAS_4) vis_kernel(const Params p)
{
    __shared__ Chunk sm[2];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int tile = blockIdx.x;
    const int n_cols = p.width / TILE_W;
    const int trow = tile / n_cols, tcol = tile - trow * n_cols;
    const int x0 = tcol * TILE_W + (warp % QUARTERS) * QW;
    const int y0 = trow * VTILE_H + (warp / QUARTERS) * ROWS;
    const int x = x0 + lane;
    float px[NS], py[NS][ROWS], d[NS][ROWS], none[ROWS] = {};
    int win[NS][ROWS], cnt[ROWS] = {};
#pragma unroll
    for (int si = 0; si < NS; ++si) {
        px[si] = __fadd_rn(float(x), p.ox[si]);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            py[si][r] = __fadd_rn(float(y0 + r), p.oy[si]);
            d[si][r] = 0.0f;
            win[si][r] = -1;
        }
    }
    // K2's per-(sample, row) bbox skip pays at 4 samples only.
    walk_chunks<true, false, false, (NS > 1), NS>(p, p.offs[tile], p.offs[tile + 1], px, py, float(x0), float(y0),
                                                    none, none, d, win, cnt, sm);
    const size_t hw = (size_t)p.width * p.height;
#pragma unroll
    for (int si = 0; si < NS; ++si) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            const size_t pix = si * hw + (size_t)(y0 + r) * p.width + x;
            __stcs(p.out + pix, d[si][r]);
            __stcs(p.tri + pix, win[si][r] < 0 ? -1 : int(__ldg(p.setup + (size_t)win[si][r] * SETUP_W + S_ID)));
        }
    }
}

Params make_params(const void* setup, const void* bbox, const void* planes, const void* offs, const void* ids,
                   void* out, const void* bound, const void* cfloor, void* counts, const void* plan,
                   int width, int height, int strict, int row0, float sofs_x, float sofs_y)
{
    Params p = {};
    p.setup = (const float*)setup;
    p.bbox = (const float4*)bbox;
    p.planes = (const float*)planes;
    p.offs = (const int*)offs;
    p.ids = (const int*)ids;
    p.out = (float*)out;
    p.bound = (const float*)bound;
    p.cfloor = (const float*)cfloor;
    p.counts = (float*)counts;
    p.plan = (const int*)plan;
    p.width = width;
    p.height = height;
    p.n_tiles = (width / TILE_W) * (height / TILE_H);
    p.strict = strict;
    p.row0 = row0;
    p.ox[0] = sofs_x;
    p.oy[0] = sofs_y;
    return p;
}

}  // namespace

extern "C" {

// K1: out (25, height, width) f32. setup (V, 16), bbox (V, 4), planes
// (V, 64) f32, each row 16-byte aligned; offs (n_tiles + 1) and ids (P)
// int32; width % 128 == 0, height % 32 == 0. Peel modes: an optional
// (height, width) f32 exclusive upper bound, and an optional (height,
// width) f32 count floor whose per-pixel counts go to `counts` (height,
// width) f32; a null pointer leaves a mode off. strict != 0 counts
// z > floor, else z >= floor. row0: the target row of out's row 0 (a row
// band's first row; setup rows and bboxes are in target coordinates, the
// bound, floor, counts and out are the band's). Returns the first CUDA
// error of the launch.
int k1_raster_resolve(const void* setup, const void* bbox, const void* planes,
                      const void* offs, const void* ids, void* out,
                      const void* bound, const void* cfloor, void* counts,
                      int width, int height, int strict, int row0, float sofs_x, float sofs_y, void* stream)
{
    const Params p = make_params(setup, bbox, planes, offs, ids, out, bound, cfloor, counts, nullptr,
                                 width, height, strict, row0, sofs_x, sofs_y);
    const cudaStream_t s = (cudaStream_t)stream;
    if (bound && cfloor) return launch_tiles<true, true, true>(p, p.n_tiles, s);
    if (bound) return launch_tiles<true, true, false>(p, p.n_tiles, s);
    if (cfloor) return launch_tiles<true, false, true>(p, p.n_tiles, s);
    return launch_tiles<true, false, false>(p, p.n_tiles, s);
}

// K2: out (height, width) f32 (zeroed here, then written); inputs as K1
// without the planes, n_entries = P, row0 as K1's; plan: 1 + 2 (n_tiles +
// P / 128) int32 of scratch (the segments, written here).
int k2_raster_depth(const void* setup, const void* bbox, const void* offs, const void* ids,
                    void* out, void* plan, int width, int height, int n_entries, int row0, float sofs_x,
                    float sofs_y, void* stream)
{
    const Params p = make_params(setup, bbox, nullptr, offs, ids, out, nullptr, nullptr, nullptr, plan,
                                 width, height, 0, row0, sofs_x, sofs_y);
    const cudaStream_t s = (cudaStream_t)stream;
    if (p.n_tiles <= 0) return (int)cudaGetLastError();
    const cudaError_t e = cudaMemsetAsync(out, 0, (size_t)width * height * sizeof(float), s);
    if (e != cudaSuccess) return (int)e;
    tile_lists::plan_kernel<SEG><<<1, NT, 0, s>>>(p.offs, p.n_tiles, (int*)plan);
    // At most one partial segment a tile: n_tiles + P / SEG segments.
    return launch_tiles<false, false, false>(p, (size_t)p.n_tiles + n_entries / SEG, s);
}

// Registers, local (spill) bytes, static shared bytes and resident CTAs per
// SM of kernel instance `which` (tiles_kernel: 0 K1, 1 K1 bound, 2 K1
// count, 3 K1 bound + count, 4 K2; vis_kernel: 5 K6 at 1 sample, 6 K6 at 4
// samples), and the SM count. info: 5 ints.
int raster_kernel_info(int which, void* info)
{
    int* i = (int*)info;
    switch (which) {
        case 0: return kernel_info(tiles_kernel<true, false, false>, NT, 0, i);
        case 1: return kernel_info(tiles_kernel<true, true, false>, NT, 0, i);
        case 2: return kernel_info(tiles_kernel<true, false, true>, NT, 0, i);
        case 3: return kernel_info(tiles_kernel<true, true, true>, NT, 0, i);
        case 4: return kernel_info(tiles_kernel<false, false, false>, NT, 0, i);
        case 5: return kernel_info(vis_kernel<1>, NT, 0, i);
        case 6: return kernel_info(vis_kernel<4>, NT, 0, i);
        default: return (int)cudaErrorInvalidValue;
    }
}

// K6: depth (nsamp, height, width) f32 and tri (nsamp, height, width)
// int32; inputs as K2 over 8x128 tiles (width % 128 == 0, height % 8 == 0);
// nsamp is 1 or 4 sample offsets (ox_i, oy_i) in [0, 1), unused pairs
// ignored.
int k6_raster_vis(const void* setup, const void* bbox, const void* offs, const void* ids,
                  void* depth, void* tri, int width, int height, int nsamp,
                  float ox0, float oy0, float ox1, float oy1, float ox2, float oy2, float ox3, float oy3,
                  void* stream)
{
    Params p = make_params(setup, bbox, nullptr, offs, ids, depth, nullptr, nullptr, nullptr, nullptr,
                           width, height, 0, 0, ox0, oy0);
    p.tri = (int*)tri;
    const float ox[MAX_SAMPLES] = {ox0, ox1, ox2, ox3}, oy[MAX_SAMPLES] = {oy0, oy1, oy2, oy3};
    for (int s = 0; s < MAX_SAMPLES; ++s) {
        p.ox[s] = ox[s];
        p.oy[s] = oy[s];
    }
    const int n_tiles = (width / TILE_W) * (height / VTILE_H);
    const cudaStream_t s = (cudaStream_t)stream;
    if (nsamp != 1 && nsamp != 4) return (int)cudaErrorInvalidValue;
    if (n_tiles > 0) {
        if (nsamp == 1)
            vis_kernel<1><<<n_tiles, NT, 0, s>>>(p);
        else
            vis_kernel<4><<<n_tiles, NT, 0, s>>>(p);
    }
    return (int)cudaGetLastError();
}

const char* rend3_cuda_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
