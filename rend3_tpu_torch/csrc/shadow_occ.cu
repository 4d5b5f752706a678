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
// What bounds them on the H100. The output, 12 x 4 bytes a pixel (100 MB
// at 1088x1920, 0.030 ms at 3.35 TB/s), and the (pixel, nearby caster)
// evaluations, about 130 f32 operations each (four planes at the base
// texel, then four planes, three edge tests, a depth test and a max at
// each of the 12 offsets). The rect lists make the work uneven: a tile
// whose hit pixels span a depth discontinuity has a footprint rect that
// holds thousands of casters (17,884 in one tile of the bench frame's
// light 0), nearly all of them far from any one warp's pixels; given only
// to the tile's own CTAs, such a list keeps a few SMs busy long after the
// others have finished. What remains is evaluation: a warp evaluates a
// caster for all its 32 pixels, while neighbouring pixels share base
// texels (26 hit pixels a distinct texel on that light), so it evaluates
// many times the (texel, caster) pairs the plain version does.
//
// Design:
//   - work items are segments of at most SEG list entries, planned by
//     tile_lists::plan_kernel (as K2's), so a long list spreads over as
//     many CTAs as it has segments; the grid counts the most segments there
//     can be (n_tiles + entries / SEG) and CTAs past the plan's count
//     return at once;
//   - each segment is cut into BLOCKS pixel blocks of 8 x 32, one 256-
//     thread CTA each, one pixel a thread with its 12 running maxima in
//     registers; a warp holds a 4 x 8 block, whose light-space footprint
//     is more compact than a 32-pixel row's (the shapes tried, PERF.md §6:
//     4 x 8 in 8 x 32 was the fastest of 8 x 4, 4 x 8 and 2 x 16 warps in
//     32 x 8, 16 x 16 and 8 x 32 CTAs);
//   - the CTA stages the segment through shared memory with 16-byte
//     cp.async, double-buffered (tile_lists::walk_staged: the 12 plane
//     coefficients with the rest of the setup row, and the bbox); a CTA
//     with no hit pixel stages nothing and stores nothing;
//   - each warp culls 32 staged casters at once: lane l tests caster l's
//     bbox against the warp's window, the union over its hit pixels of
//     pixel_window (the casters within half a texel of a pixel's taps, the
//     plain version's candidate test: a caster that covers a tap passes
//     it, and the lists hold every such caster, since they pad the
//     footprint by (-2, +3) and a pixel's taps lie in (sx - 2, sx + 2]);
//     it walks the set bits of the ballot, skips a caster
//     that misses every hit lane's own window (which more than halves the
//     evaluations), and evaluates the rest; a warp with no hit pixel skips
//     the walk. No value at a hit pixel changes;
//   - a tile with one segment stores its maxima; the segments of a longer
//     list combine with atomicMax on the int bits of their maxima into the
//     output, zeroed first (non-negative floats order as their bits; the
//     atomic is issued only for a maximum > 0 at a hit pixel, so no -0.0
//     bits reach it). A max has no order, so the values do not change.
//     Tiles with an empty list keep the zeros. Values at non-hit pixels are
//     not defined, as on the TPU, where the lists decide them. SEG = 2048
//     was the fastest of 256 to 4096: shorter segments spread the long
//     lists wider but add atomics and per-CTA set-up.
// occ_kernel_info reports each instance's registers, spills, shared memory
// and resident CTAs per SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_info.cuh"
#include "tile_lists.cuh"

namespace {

using tile_lists::Chunk;
using tile_lists::NT;
using tile_lists::ROW4;

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int SEG = 2048;                         // list entries a work item walks
constexpr int BW = 4, BH = 8;                     // a warp's pixel block
constexpr int CW = 8, CH = 32;                    // a CTA's pixel block: 2 x 4 warp blocks
constexpr int BLOCKS = (TILE_W / CW) * (TILE_H / CH);  // CTAs a segment
constexpr int MIN_CTAS = 4;                       // resident CTAs an SM: 64 registers a thread
constexpr int N_OFF = 12;
constexpr int COEF = 12;                          // a0..2, b0..2, c0..2, za, zb, zc
constexpr float BIG = 1e9f;
static_assert((CW / BW) * (CH / BH) == NT / 32 && BW * BH == 32, "one warp a BW x BH block of the CTA's");

// PCF_OFFSETS (shadow.py:57-62).
__constant__ float DX[N_OFF] = {-1, -1, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2};
__constant__ float DY[N_OFF] = {0, 1, -1, 0, 1, 2, -1, 0, 1, 2, 0, 1};

struct Params {
    const float* setup;
    const float4* bbox;
    const int* offs;
    const int* ids;
    const float* sx;
    const float* sy;
    const uint8_t* hit;
    float* out;
    const int* plan;
    int width, height;
};

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

// Whether bbox bb (xmin, ymin, xmax, ymax) overlaps the open window
// (x0, x1) x (y0, y1).
__device__ __forceinline__ bool overlaps(float4 bb, float x0, float y0, float x1, float y1) {
    return bb.z > x0 && bb.x < x1 && bb.w > y0 && bb.y < y1;
}

// Whether bbox bb comes within half a texel of the taps of base texel
// centre (bx, by), which lie in [bx - 1, bx + 2] x [by - 1, by + 2]: the
// plain version's candidate test. A caster that covers a tap passes it.
// The window is recomputed at each use, which keeps the kernel under its
// 64 registers.
__device__ __forceinline__ bool pixel_window(float4 bb, float bx, float by) {
    return overlaps(bb, __fsub_rn(bx, 1.5f), __fsub_rn(by, 1.5f), __fadd_rn(bx, 2.5f), __fadd_rn(by, 2.5f));
}

// One caster's coefficients c at the base texel (bx, by) into the 12
// running maxima.
template <bool LT>
__device__ __forceinline__ void accumulate(const float (&c)[COEF], float bx, float by, float (&occ)[N_OFF]) {
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
        float q[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            if (LT) {
                q[k] = __fadd_rn(e[k], __fadd_rn(__fmul_rn(a[k], dx), __fmul_rn(b[k], dy)));
            } else {
                const float ek = (k == 3 && dx == 1.0f && dy != 1.0f) ? ez_swapped : e[k];
                q[k] = __fadd_rn(__fadd_rn(ek, __fmul_rn(a[k], dx)), __fmul_rn(b[k], dy));
            }
        }
        if (q[0] > 0.0f && q[1] > 0.0f && q[2] > 0.0f && q[3] >= 0.0f) occ[o] = fmaxf(occ[o], q[3]);
    }
}

// Block b walks pixel block b % BLOCKS of segment b / BLOCKS.
template <bool LT>
__global__ void __launch_bounds__(NT, MIN_CTAS) occ_kernel(const Params p)
{
    __shared__ Chunk sm[2];
    const int item = blockIdx.x / BLOCKS, blk = blockIdx.x - item * BLOCKS;
    if (item >= p.plan[0]) return;  // past the last segment: the whole CTA
    const int tile = p.plan[1 + 2 * item];
    const int beg = p.plan[2 + 2 * item];
    const int tile_end = p.offs[tile + 1];
    const int end = min(tile_end, beg + SEG);
    const bool shared_tile = tile_end - p.offs[tile] > SEG;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_cols = p.width / TILE_W;
    const int trow = tile / n_cols, tcol = tile - trow * n_cols;
    const int x = tcol * TILE_W + (blk % (TILE_W / CW)) * CW + (warp % (CW / BW)) * BW + lane % BW;
    const int y = trow * TILE_H + (blk / (TILE_W / CW)) * CH + (warp / (CW / BW)) * BH + lane / BW;
    const size_t pix = (size_t)y * p.width + x;
    const bool h = p.hit[pix] != 0;
    // The output is zeroed: a CTA with no hit pixel has nothing to do.
    if (!__syncthreads_or(h)) return;
    const float fx = p.sx[pix], fy = p.sy[pix];
    const float bx = __fadd_rn(floorf(__fsub_rn(fx, 0.5f)), 0.5f);
    const float by = __fadd_rn(floorf(__fsub_rn(fy, 0.5f)), 0.5f);
    // The warp's window: the union over its hit pixels of the casters that
    // can cover one of a pixel's taps (see pixel_window).
    const float wx0 = warp_min(h ? __fsub_rn(bx, 1.5f) : BIG), wy0 = warp_min(h ? __fsub_rn(by, 1.5f) : BIG);
    const float wx1 = warp_max(h ? __fadd_rn(bx, 2.5f) : -BIG), wy1 = warp_max(h ? __fadd_rn(by, 2.5f) : -BIG);
    const bool any = __any_sync(0xffffffffu, h);

    float occ[N_OFF];
#pragma unroll
    for (int o = 0; o < N_OFF; ++o) occ[o] = 0.0f;
    tile_lists::walk_staged(p.ids, p.setup, p.bbox, beg, end, sm, [&](const Chunk& c, int n) {
        if (!any) return;
        for (int g = 0; g < n; g += 32) {
            const bool cand = g + lane < n && overlaps(c.row[g + lane][ROW4 - 1], wx0, wy0, wx1, wy1);
            unsigned m = __ballot_sync(0xffffffffu, cand);
            while (m) {
                const int j = g + __ffs(m) - 1;
                m &= m - 1;
                if (!__any_sync(0xffffffffu, h && pixel_window(c.row[j][ROW4 - 1], bx, by))) continue;
                const float4 r0 = c.row[j][0], r1 = c.row[j][1], r2 = c.row[j][2];
                const float cf[COEF] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w, r2.x, r2.y, r2.z, r2.w};
                accumulate<LT>(cf, bx, by, occ);
            }
        }
    });
    const size_t hw = (size_t)p.width * p.height;
#pragma unroll
    for (int o = 0; o < N_OFF; ++o) {
        if (!shared_tile)
            __stcs(p.out + o * hw + pix, occ[o]);
        else if (h && occ[o] > 0.0f)
            atomicMax(reinterpret_cast<int*>(p.out) + o * hw + pix, __float_as_int(occ[o]));
    }
}

}  // namespace

extern "C" {

// K7 (lt == 0) and K8 (lt != 0): out (12, height, width) f32 (zeroed here,
// then written; defined at hit pixels). setup (V, 16) and bbox (V, 4) f32
// of the casters in light pixel space, each row 16-byte aligned; offs
// (n_tiles + 1) and ids (n_entries) int32: CSR caster lists per 32x128
// screen tile; sx, sy (height, width) f32; hit (height, width) uint8
// (torch.bool); plan: plan_len int32 of scratch for the segments (at least
// 1 + 2 (n_tiles + n_entries / 2048)). width % 128 == 0, height % 32 == 0.
// Returns the first CUDA error.
int k7_shadow_occ(const void* setup, const void* bbox, const void* offs, const void* ids,
                  const void* sx, const void* sy, const void* hit, void* out, void* plan,
                  int width, int height, int lt, int n_entries, int plan_len, void* stream)
{
    const int n_tiles = (width / TILE_W) * (height / TILE_H);
    const cudaStream_t s = (cudaStream_t)stream;
    if (n_tiles <= 0) return (int)cudaGetLastError();
    if (n_entries < 0 || (size_t)plan_len < tile_lists::plan_ints<SEG>(n_tiles, n_entries))
        return (int)cudaErrorInvalidValue;
    const size_t n_ctas = BLOCKS * ((size_t)n_tiles + n_entries / SEG);
    if (n_ctas > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    const cudaError_t e = cudaMemsetAsync(out, 0, (size_t)N_OFF * width * height * sizeof(float), s);
    if (e != cudaSuccess) return (int)e;
    tile_lists::plan_kernel<SEG><<<1, NT, 0, s>>>((const int*)offs, n_tiles, (int*)plan);
    const Params p = {(const float*)setup, (const float4*)bbox, (const int*)offs, (const int*)ids,
                      (const float*)sx, (const float*)sy, (const uint8_t*)hit, (float*)out, (const int*)plan,
                      width, height};
    if (lt)
        occ_kernel<true><<<(unsigned)n_ctas, NT, 0, s>>>(p);
    else
        occ_kernel<false><<<(unsigned)n_ctas, NT, 0, s>>>(p);
    return (int)cudaGetLastError();
}

// Registers, local (spill) bytes, static shared bytes and resident CTAs per
// SM of occ_kernel's instance `which` (0 K7, 1 K8), and the SM count.
// info: 5 ints.
int occ_kernel_info(int which, void* info)
{
    int* i = (int*)info;
    switch (which) {
        case 0: return kernel_info(occ_kernel<false>, NT, 0, i);
        case 1: return kernel_info(occ_kernel<true>, NT, 0, i);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
