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
//     than the two-compare form (covers, which K6 keeps); K2 also skips the
//     rows of a block that the entry's bbox misses (K1's larger triangles
//     run faster without);
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
//     so a long list spreads over many CTAs: a one-CTA kernel (plan_kernel)
//     writes each segment's tile and first entry to global memory first.
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
// K6 is the earlier walk (walk_vis) over 8x128 tiles (the visibility raster's
// binning), for 1 or 4 sample offsets at once: one staging of the list's
// setup rows serves every offset, each thread keeping the depth and winner
// of 4 pixel rows per offset in registers (a 256-thread CTA per tile, so up
// to 32 pairs fit). It writes depth (S, H, W) f32 and the winner's S_ID
// (its clipped-table row) as id (S, H, W) int32, -1 where nothing covers;
// the S_ID is read from the winner's setup row once per covered pixel.
// Bound: the 8 bytes per pixel and sample it writes, and the per-(pixel,
// listed triangle, sample) tests; 2,040 CTAs for a 1088x1920 target.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_info.cuh"

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int ROWS = 4;                    // pixel rows per thread
constexpr int SETUP_W = 16;
constexpr int PLANES_W = 64;
constexpr int GB_CH = 25;
constexpr int STAGE = 128;                 // K6: setup rows staged per pass
constexpr int VTILE_H = 8;                 // K6's tile height
constexpr int VGROUPS = VTILE_H / ROWS;    // K6's threadIdx.y extent
constexpr int MAX_SAMPLES = 4;

// K1 / K2 (tiles_kernel).
constexpr int QW = 32;                     // quarter-tile width: a warp's columns
constexpr int QUARTERS = TILE_W / QW;      // work items per tile (per segment)
constexpr int WARPS = TILE_H / ROWS;       // 8 warps, one 32x4 block each
constexpr int NT = 32 * WARPS;             // 256 threads a CTA
constexpr int CHUNK = 128;                 // list entries a staged buffer holds
constexpr int SEG = CHUNK;                 // K2: list entries a work item walks
constexpr int K1_MIN_CTAS = 4;             // resident CTAs an SM: 64 registers a thread
constexpr int K2_MIN_CTAS = 5;             // 48 registers a thread

// Setup row layout (geometry.py:28-35).
constexpr int S_EA = 0, S_EB = 3, S_EC = 6, S_ZA = 9, S_ZB = 10, S_ZC = 11;
constexpr int S_TL = 12, S_ID = 13, S_TL1 = 14, S_TL2 = 15;
// Plane row layout (deferred.py:52-62).
constexpr int P_DEN = 0, P_VP = 3, P_NRM = 12, P_TAN = 21, P_UV0 = 30, P_UV1 = 36, P_COL = 42, P_MAT = 54;

__device__ __forceinline__ float plane(float a, float b, float c, float px, float py) {
    return __fadd_rn(__fmaf_rn(a, px, __fmul_rn(b, py)), c);
}

// The coverage and depth of one setup row s at (x, y), as K6 tests them.
__device__ __forceinline__ bool covers(const float* s, float x, float y, float& z) {
    const float e0 = plane(s[S_EA + 0], s[S_EB + 0], s[S_EC + 0], x, y);
    const float e1 = plane(s[S_EA + 1], s[S_EB + 1], s[S_EC + 1], x, y);
    const float e2 = plane(s[S_EA + 2], s[S_EB + 2], s[S_EC + 2], x, y);
    const bool c0 = (e0 > 0.0f) || ((e0 == 0.0f) && (s[S_TL] > 0.0f));
    const bool c1 = (e1 > 0.0f) || ((e1 == 0.0f) && (s[S_TL1] > 0.0f));
    const bool c2 = (e2 > 0.0f) || ((e2 == 0.0f) && (s[S_TL2] > 0.0f));
    z = plane(s[S_ZA], s[S_ZB], s[S_ZC], x, y);
    return c0 && c1 && c2 && (z >= 0.0f) && (z <= 1.0f);
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

// A staged entry's row: its setup row (4 float4) and bbox (the 5th). The
// 80-byte stride keeps the lanes of a warp that read 32 rows at once on
// distinct banks.
constexpr int ROW4 = SETUP_W / 4 + 1;

struct Chunk {
    float4 row[CHUNK][ROW4];
    int id[CHUNK];
};

struct Params {
    const float* setup;
    const float4* bbox;
    const float* planes;
    const int* offs;
    const int* ids;
    float* out;
    const float* bound;
    const float* cfloor;
    float* counts;
    const int* plan;  // K2's segments (plan_kernel)
    int width, height, n_tiles, strict;
    float sofs_x, sofs_y;
};

// Exclusive prefix sum of one int a thread over the CTA; `total` gets the sum.
__device__ __forceinline__ int cta_exclusive_scan(int v, int& total, int* warp_sums) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int inc = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += t;
    }
    if (lane == 31) warp_sums[warp] = inc;
    __syncthreads();
    int base = 0;
    total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        const int s = warp_sums[w];
        base += (w < warp) ? s : 0;
        total += s;
    }
    __syncthreads();
    return base + inc - v;
}

__device__ __forceinline__ int n_segments(int len) { return (len + SEG - 1) / SEG; }

// K2's segments, one CTA: tile t's list of len entries splits into
// n_segments(len) segments of SEG entries (none for an empty list), in tile
// order. plan[0] gets their number; segment s's tile and first list entry
// go to plan[1 + 2s] and plan[2 + 2s]. Thread i owns a contiguous run of
// tiles.
__global__ void __launch_bounds__(NT) plan_kernel(const int* __restrict__ offs, int n_tiles, int* __restrict__ plan)
{
    __shared__ int warp_sums[WARPS];
    const int per = (n_tiles + NT - 1) / NT;
    const int lo = min(n_tiles, (int)threadIdx.x * per), hi = min(n_tiles, lo + per);
    int n = 0;
    for (int t = lo; t < hi; ++t) n += n_segments(offs[t + 1] - offs[t]);
    int total;
    int s = cta_exclusive_scan(n, total, warp_sums);
    for (int t = lo; t < hi; ++t) {
        for (int b = offs[t]; b < offs[t + 1]; b += SEG, ++s) {
            plan[1 + 2 * s] = t;
            plan[2 + 2 * s] = b;
        }
    }
    if (threadIdx.x == 0) plan[0] = total;
}

// Stage list entry e of a chunk (setup row id `id`, -1 past the list's end)
// into `c`: thread half h copies setup floats 8h..8h+7, half 0 also the bbox.
__device__ __forceinline__ void stage(Chunk& c, int e, int h, int id, const Params& p) {
    if (id < 0) return;
    const float4* src = reinterpret_cast<const float4*>(p.setup + (size_t)id * SETUP_W) + 2 * h;
    __pipeline_memcpy_async(&c.row[e][2 * h], src, 16);
    __pipeline_memcpy_async(&c.row[e][2 * h + 1], src + 1, 16);
    if (h == 0) {
        __pipeline_memcpy_async(&c.row[e][ROW4 - 1], p.bbox + id, 16);
        c.id[e] = id;
    }
}

// Walk list entries [beg, end) for this thread's pixel column px and rows
// py: greatest covered depth d[r] and (WINNER) the setup row win[r] that
// reached it last; with BOUND a fragment also needs z < bnd[r]; with COUNT,
// cnt[r] counts the covered fragments above flr[r] before the bound. wx0,
// wy0: the warp's block. Every thread of the CTA calls it with the same
// range.
template <bool WINNER, bool BOUND, bool COUNT>
__device__ __forceinline__ void walk_chunks(
    const Params& p, int beg, int end, float px, const float (&py)[ROWS], float wx0, float wy0,
    const float (&bnd)[ROWS], const float (&flr)[ROWS], float (&d)[ROWS], int (&win)[ROWS], int (&cnt)[ROWS],
    Chunk* sm)
{
    const int n_chunks = (end - beg + CHUNK - 1) / CHUNK;
    if (n_chunks <= 0) return;
    const int lane = threadIdx.x & 31, e = threadIdx.x >> 1, h = threadIdx.x & 1;
    const bool strict = p.strict != 0;
    // The warp's corner samples (lanes 0 and 31, rows 0 and ROWS - 1).
    const float cx0 = __fadd_rn(wx0, p.sofs_x), cx1 = __fadd_rn(wx0 + float(QW - 1), p.sofs_x);
    const float cy0 = py[0], cy1 = py[ROWS - 1];
    stage(sm[0], e, h, beg + e < end ? __ldg(p.ids + beg + e) : -1, p);
    __pipeline_commit();
    int id_next = beg + CHUNK + e < end ? __ldg(p.ids + beg + CHUNK + e) : -1;
    for (int k = 0; k < n_chunks; ++k) {
        const int base = beg + k * CHUNK;
        if (k + 1 < n_chunks) {
            stage(sm[(k + 1) & 1], e, h, id_next, p);
            __pipeline_commit();
            id_next = base + 2 * CHUNK + e < end ? __ldg(p.ids + base + 2 * CHUNK + e) : -1;
            __pipeline_wait_prior(1);
        } else {
            __pipeline_wait_prior(0);
        }
        __syncthreads();
        const Chunk& c = sm[k & 1];
        const int n = min(CHUNK, end - base);
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
                // K2 skips the rows outside the bbox grown by one pixel (K1,
                // whose triangles are larger, runs faster without the test).
                const float4 bb = c.row[j][ROW4 - 1];
#pragma unroll
                for (int r = 0; r < ROWS; ++r) {
                    const float y = py[r];
                    if (!WINNER && (y < bb.y - 1.0f || y > bb.w + 1.0f)) continue;
                    const float z = plane(s[S_ZA], s[S_ZB], s[S_ZC], px, y);
                    bool cov = plane(s[S_EA + 0], s[S_EB + 0], s[S_EC + 0], px, y) > t0
                               && plane(s[S_EA + 1], s[S_EB + 1], s[S_EC + 1], px, y) > t1
                               && plane(s[S_EA + 2], s[S_EB + 2], s[S_EC + 2], px, y) > t2
                               && (z >= 0.0f) && (z <= 1.0f);
                    if (COUNT && cov && (strict ? (z > flr[r]) : (z >= flr[r]))) ++cnt[r];
                    if (BOUND) cov = cov && (z < bnd[r]);
                    if (WINNER) {
                        if (cov && z >= d[r]) {
                            d[r] = z;
                            win[r] = id;
                        }
                    } else if (cov && z > d[r]) {
                        d[r] = z;
                    }
                }
            }
        }
        __syncthreads();  // buffer k & 1 is staged again for chunk k + 2
    }
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
    const int y0 = trow * TILE_H + warp * ROWS;
    const int x = x0 + lane;
    const float px = __fadd_rn(float(x), p.sofs_x);
    float py[ROWS], d[ROWS], bnd[ROWS], flr[ROWS];
    int win[ROWS], cnt[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const size_t pix = (size_t)(y0 + r) * p.width + x;
        py[r] = __fadd_rn(float(y0 + r), p.sofs_y);
        d[r] = 0.0f;
        win[r] = -1;
        // An empty list reads neither image: its pixels win nothing and count nothing.
        bnd[r] = BOUND && beg < end ? p.bound[pix] : 0.0f;
        flr[r] = COUNT && beg < end ? p.cfloor[pix] : 0.0f;
        cnt[r] = 0;
    }
    walk_chunks<WINNER, BOUND, COUNT>(p, beg, end, px, py, float(x0), float(y0), bnd, flr, d, win, cnt, sm);
    const size_t hw = (size_t)p.width * p.height;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const size_t pix = (size_t)(y0 + r) * p.width + x;
        if (WINNER) {
            if (COUNT) __stcs(p.counts + pix, float(cnt[r]));
            resolve_pixel(p, pix, hw, d[r], win[r], px, py[r]);
        } else if (!shared_tile) {
            __stcs(p.out + pix, d[r]);
        } else if (d[r] > 0.0f) {
            atomicMax(reinterpret_cast<int*>(p.out) + pix, __float_as_int(d[r]));
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
// K6: the earlier walk over 8x128 tiles
// ---------------------------------------------------------------------------

struct Staged {
    float setup[STAGE][SETUP_W];
    float4 bbox[STAGE];
    int id[STAGE];
};

// Walk the tile's list; per sample offset s and pixel row r of this
// thread: greatest covered depth d[s][r] and the setup row win[s][r] that
// reached it last.
template <int NS>
__device__ __forceinline__ void walk_vis(
    const float* __restrict__ setup, const float4* __restrict__ bbox,
    const int* __restrict__ offs, const int* __restrict__ ids,
    int tile, const float (&px)[NS], const float (&py)[NS][ROWS], float wx0, float wy0,
    float (&d)[NS][ROWS], int (&win)[NS][ROWS], Staged& sm)
{
    const int tid = threadIdx.y * TILE_W + threadIdx.x;
    const int nthreads = TILE_W * blockDim.y;
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
            // Warp-uniform skip: no pixel of the warp's 32x4 block lies in
            // the bbox grown by one pixel (so no pixel can be covered).
            if (!meets(sm.bbox[j], wx0, wy0)) continue;
            const float* s = sm.setup[j];
#pragma unroll
            for (int si = 0; si < NS; ++si) {
#pragma unroll
                for (int r = 0; r < ROWS; ++r) {
                    float z;
                    if (covers(s, px[si], py[si][r], z) && z >= d[si][r]) {
                        d[si][r] = z;
                        win[si][r] = sm.id[j];
                    }
                }
            }
        }
    }
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
    float px[NS], py[NS][ROWS], d[NS][ROWS];
    int win[NS][ROWS];
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
    walk_vis<NS>(setup, bbox, offs, ids, tile, px, py, wx0, float(y0), d, win, sm);
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

Params make_params(const void* setup, const void* bbox, const void* planes, const void* offs, const void* ids,
                   void* out, const void* bound, const void* cfloor, void* counts, const void* plan,
                   int width, int height, int strict, float sofs_x, float sofs_y)
{
    Params p;
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
    p.sofs_x = sofs_x;
    p.sofs_y = sofs_y;
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
// z > floor, else z >= floor. Returns the first CUDA error of the launch.
int k1_raster_resolve(const void* setup, const void* bbox, const void* planes,
                      const void* offs, const void* ids, void* out,
                      const void* bound, const void* cfloor, void* counts,
                      int width, int height, int strict, float sofs_x, float sofs_y, void* stream)
{
    const Params p = make_params(setup, bbox, planes, offs, ids, out, bound, cfloor, counts, nullptr,
                                 width, height, strict, sofs_x, sofs_y);
    const cudaStream_t s = (cudaStream_t)stream;
    if (bound && cfloor) return launch_tiles<true, true, true>(p, p.n_tiles, s);
    if (bound) return launch_tiles<true, true, false>(p, p.n_tiles, s);
    if (cfloor) return launch_tiles<true, false, true>(p, p.n_tiles, s);
    return launch_tiles<true, false, false>(p, p.n_tiles, s);
}

// K2: out (height, width) f32 (zeroed here, then written); inputs as K1
// without the planes, n_entries = P; plan: 1 + 2 (n_tiles + P / 128) int32
// of scratch (the segments, written here).
int k2_raster_depth(const void* setup, const void* bbox, const void* offs, const void* ids,
                    void* out, void* plan, int width, int height, int n_entries, float sofs_x, float sofs_y,
                    void* stream)
{
    const Params p = make_params(setup, bbox, nullptr, offs, ids, out, nullptr, nullptr, nullptr, plan,
                                 width, height, 0, sofs_x, sofs_y);
    const cudaStream_t s = (cudaStream_t)stream;
    if (p.n_tiles <= 0) return (int)cudaGetLastError();
    const cudaError_t e = cudaMemsetAsync(out, 0, (size_t)width * height * sizeof(float), s);
    if (e != cudaSuccess) return (int)e;
    plan_kernel<<<1, NT, 0, s>>>(p.offs, p.n_tiles, (int*)plan);
    // At most one partial segment a tile: n_tiles + P / SEG segments.
    return launch_tiles<false, false, false>(p, (size_t)p.n_tiles + n_entries / SEG, s);
}

// Registers, local (spill) bytes, static shared bytes and resident CTAs per
// SM of tiles_kernel instance `which` (0 K1, 1 K1 bound, 2 K1 count, 3 K1
// bound + count, 4 K2), and the SM count. info: 5 ints.
int raster_kernel_info(int which, void* info)
{
    int* i = (int*)info;
    switch (which) {
        case 0: return kernel_info(tiles_kernel<true, false, false>, NT, 0, i);
        case 1: return kernel_info(tiles_kernel<true, true, false>, NT, 0, i);
        case 2: return kernel_info(tiles_kernel<true, false, true>, NT, 0, i);
        case 3: return kernel_info(tiles_kernel<true, true, true>, NT, 0, i);
        case 4: return kernel_info(tiles_kernel<false, false, false>, NT, 0, i);
        default: return (int)cudaErrorInvalidValue;
    }
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
